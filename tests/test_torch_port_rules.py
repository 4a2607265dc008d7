"""Rules the port keeps: no JAX at run time, CUDA unless asked otherwise,
plain versions only for CPU tensors."""
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.models import (DCNv2Model, FeatureConfig,
                                      MultiTaskModel, XDeepFMModel)
from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops import cin_kernel as ck
from rec_now_tpu_torch.ops import listwise_kernel as lk
from rec_now_tpu_torch.ops import multi_dense_kernel as mk
from rec_now_tpu_torch.ops import pairwise_kernel as pk
from rec_now_tpu_torch.ops import table_update_kernel as tk
from rec_now_tpu_torch.serving import WireScorer, build_scorer
from rec_now_tpu_torch.training import Trainer, TrainerConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Every module of the package imports with jax, flax, optax and
    rec_now_tpu blocked."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax",
                     "rec_now_tpu"):
            sys.modules[name] = None
        import rec_now_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            rec_now_tpu_torch.__path__, "rec_now_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "optax", "rec_now_tpu")
                     and sys.modules[m] is not None)
        assert not bad, bad
        assert "rec_now_tpu_torch.parallel.multihost" in mods
        print(len(mods))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def _library_modules(**kw):
    """A constructor of each module of the layer and loss library, with
    ``kw`` (e.g. ``device="cpu"``) passed on."""
    from rec_now_tpu_torch import layers as L
    from rec_now_tpu_torch.rec_block import DNNAttention
    gen = torch.Generator()
    return (lambda: L.MultiHashLayer(16, 4, generator=gen, **kw),
            lambda: L.FastMultiHashLayer(16, 4, generator=gen, **kw),
            lambda: L.CartesianProductLayer(**kw),
            lambda: L.StarDenseLayer(4, 3, gen, **kw),
            lambda: L.StackedDenseLayer(4, 3, gen, **kw),
            lambda: L.ParasiticStackedDenseLayer(4, 3, 2, gen, **kw),
            lambda: L.DCNLayer(4, 2, gen, **kw),
            lambda: L.SparseGNNLayer(["a", "b"], [("a", "b")], **kw),
            lambda: L.FixLengthLayer(4, **kw),
            lambda: DNNAttention(4, (8,), gen, **kw))


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device= on a host without CUDA, entry points raise
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fc = FeatureConfig(rows_per_field=16, embedding_dim=4)
    cpu_model = XDeepFMModel(fc, (4,), deep_dims=(8,), device="cpu")
    cpu_table = EmbeddingTable(fc.total_rows, 4, device="cpu")
    mt = dict(mmoe_dims=(8, 4), ple_dims=(4,), tower_dim=2)
    cpu_mt = MultiTaskModel(fc, **mt, device="cpu")
    cfg4 = TrainerConfig(listwise_weight=0.5, num_tasks=2)
    cfg2 = TrainerConfig(pairwise_weight=0.5, sparse_optimizer="adam")
    cpu_dcn = DCNv2Model(fc, deep_dims=(8,), dcn_sub_dim=2, device="cpu")
    for make in (lambda: EmbeddingTable(fc.total_rows, 4),
                 lambda: DCNv2Model(fc, deep_dims=(8,), dcn_sub_dim=2),
                 lambda: ShardedEmbeddingTable(fc.total_rows, 4,
                                               optimizer="adam"),
                 lambda: Trainer(cpu_dcn, fc, cfg2),
                 lambda: build_scorer(cpu_dcn, fc, cpu_table),
                 lambda: XDeepFMModel(fc, (4,), deep_dims=(8,)),
                 lambda: MultiTaskModel(fc, **mt),
                 lambda: build_scorer(cpu_model, fc, cpu_table),
                 lambda: WireScorer(cpu_model, fc, cpu_table),
                 lambda: ShardedEmbeddingTable(fc.total_rows, 4),
                 lambda: Trainer(cpu_model, fc, TrainerConfig()),
                 lambda: Trainer(cpu_mt, fc, cfg4)) + _library_modules():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # asked for the CPU, they run there
    assert ShardedEmbeddingTable(fc.total_rows, 4, device="cpu").device == \
        torch.device("cpu")
    assert Trainer(cpu_model, fc, TrainerConfig(),
                   device="cpu").device == torch.device("cpu")
    assert Trainer(cpu_mt, fc, cfg4, device="cpu").device == \
        torch.device("cpu")
    assert Trainer(cpu_dcn, fc, cfg2, device="cpu").table.optimizer == "adam"
    for make in _library_modules(device="cpu"):
        for t in make().state_dict().values():
            assert t.device == torch.device("cpu")


def test_no_module_refuses_a_ported_option():
    """No source of the package raises ``NotImplementedError`` or says
    that something is "not ported": the custom pair losses, the label-pair
    weights, extra keywords and SENET's list path all run."""
    offenders = [str(p.relative_to(REPO))
                 for p in sorted((REPO / "rec_now_tpu_torch").rglob("*.py"))
                 if "NotImplementedError" in p.read_text()
                 or "not ported" in p.read_text().lower()]
    assert not offenders, offenders


def test_wrappers_take_plain_version_on_cpu_only():
    rng = np.random.RandomState(0)
    x0 = torch.from_numpy(rng.randn(37, 5).astype(np.float32))
    prev = torch.from_numpy(rng.randn(37, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 5, 3).astype(np.float32))
    ws = [torch.from_numpy(rng.randn(3, 5, 5).astype(np.float32)), w]
    before = (ck.cin_flat.launches, ck.cin_stack_sum.launches)
    torch.testing.assert_close(ck.cin_flat(x0, prev, w),
                               ck.cin_flat_plain(x0, prev, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(ck.cin_stack_sum(x0, ws, False),
                               ck.cin_stack_sum_plain(x0, ws, False),
                               rtol=0, atol=0)
    assert (ck.cin_flat.launches, ck.cin_stack_sum.launches) == before == (
        0, 0)
    # neither CPU nor CUDA: no silent plain path either
    meta = x0.to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ck.cin_flat(meta, prev.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ck.cin_stack_sum(meta, [t.to("meta") for t in ws])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("cin")
    lib = _build.library_path("cin")
    assert lib.parent == tmp_path and lib.suffix == ".so"
    assert not lib.exists() and "cin" not in _build._loaded


def test_library_path_hashes_the_headers(monkeypatch, tmp_path):
    """A library's path changes with the bytes of any ``csrc/*.cuh`` (a
    source may include it), so an edited header never loads a stale
    build; files of other kinds do not move it."""
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (src / "k.cu").write_text('#include "shared.cuh"\n')
    alone = _build.library_path("k")
    (src / "shared.cuh").write_text("// one\n")
    one = _build.library_path("k")
    (src / "shared.cuh").write_text("// two\n")
    two = _build.library_path("k")
    (src / "notes.txt").write_text("not a header\n")
    assert len({alone, one, two}) == 3
    assert _build.library_path("k") == two
    (src / "shared.cuh").write_text("// one\n")
    assert _build.library_path("k") == one
    assert one.parent == tmp_path / "_build" and one.name.startswith("k-")


def test_cuda_sources_share_one_runtime():
    """Each piece of launch plumbing that the CUDA sources share is
    defined once under ``csrc/``, and every source of kernels includes
    the host runtime (``wire.cu`` is host C++, built without CUDA's
    headers, with error codes of its own)."""
    csrc = REPO / "rec_now_tpu_torch" / "csrc"
    texts = {p.name: p.read_text() for p in sorted(csrc.glob("*.cu*"))}
    definitions = {
        "use_device": r"\bcudaError_t\s+use_device\s*\(",
        "sm_count": r"\bint\s+sm_count\s*\(",
        "optin_smem": r"\bint\s+optin_smem\s*\(",
        "kMaxDevices": r"\bconstexpr\s+int\s+kMaxDevices\b",
        "mma_tf32": r"\bvoid\s+mma_tf32\s*\(",
        "cp_async16": r"\bvoid\s+cp_async16\s*\(",
        "error_string": r"\berror_string\s*\(\s*int\s+\w+\s*\)\s*\{\s*"
                        r"return\s+cudaGetErrorString\b",
    }
    for name, pattern in definitions.items():
        homes = {f: len(re.findall(pattern, t)) for f, t in texts.items()}
        homes = {f: n for f, n in homes.items() if n}
        assert sum(homes.values()) == 1, (name, homes)
    sources = sorted(f for f in texts if f.endswith(".cu") and f != "wire.cu")
    assert len(sources) == len(_build.SOURCES) - 1
    for f in sources:
        assert '#include "runtime.cuh"' in texts[f], f
    assert "runtime.cuh" not in texts["wire.cu"]


def _counts():
    return (ck.cin_flat.launches, ck.cin_stack_sum.launches,
            ck.cin_flat_bwd.launches, ck.cin_stack_sum_bwd.launches,
            pk.pair_loss_sum.launches, tk.adagrad_dense_pass.launches)


def test_new_wrappers_take_plain_version_on_cpu_only():
    """The backwards, the pair loss and the Adagrad pass: plain on CPU
    tensors (no launch counted), an error on any other non-CUDA device."""
    rng = np.random.RandomState(1)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    x0, prev, w, g = t(29, 5), t(29, 3), t(4, 5, 3), t(29, 4)
    ws = [t(3, 5, 5), w]
    for got, want in zip(ck.cin_flat_bwd(x0, prev, w, g),
                         ck.cin_flat_bwd_plain(x0, prev, w, g)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    gs = t(29)
    got, want = (ck.cin_stack_sum_bwd(x0, ws, gs),
                 ck.cin_stack_sum_bwd_plain(x0, ws, gs))
    for a, b in zip([got[0]] + got[1], [want[0]] + want[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x, lab = t(33), torch.from_numpy((rng.rand(33) > 0.5).astype(np.float32))
    grp = torch.from_numpy(rng.randint(0, 4, 33))
    for a, b in zip(pk.pair_loss_fused(x, lab, grp, 1.0, -0.5),
                    pk.pair_loss_fused_plain(x, lab, grp, 1.0, -0.5)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    table, acc, dg = t(16, 8), t(16).abs(), t(16, 8)
    t2, a2 = table.clone(), acc.clone()
    tk.adagrad_dense_pass(table, acc, dg, 0.05)
    tk.adagrad_dense_pass_plain(t2, a2, dg, 0.05)
    torch.testing.assert_close((table, acc), (t2, a2), rtol=0, atol=0)
    assert _counts() == (0,) * 6

    def meta(*ts):
        return [a.to("meta") for a in ts]

    for call in (lambda: ck.cin_flat_bwd(*meta(x0, prev, w, g)),
                 lambda: ck.cin_stack_sum_bwd(meta(x0)[0], meta(*ws),
                                              meta(gs)[0]),
                 lambda: pk.pair_loss_sum(*meta(x, lab, grp)),
                 lambda: tk.adagrad_dense_pass(*meta(table, acc, dg), 0.05)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


def test_slice3_wrappers_take_plain_version_on_cpu_only():
    """B8 and B6: plain on CPU tensors (no launch counted), an error on
    any other non-CUDA device."""
    rng = np.random.RandomState(2)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    x, w, b = t(1, 9, 7), t(3, 7, 4), t(3, 1, 4)
    before = (mk.multi_dense_fused.launches, lk.listwise_loss_sum.launches)
    torch.testing.assert_close(mk.multi_dense_fused(x, w, b, True),
                               mk.multi_dense_xla(x, w, b, "relu"),
                               rtol=0, atol=0)
    lg, lab = t(21), torch.from_numpy((rng.rand(21) > 0.5).astype(np.float32))
    grp = torch.from_numpy(rng.randint(0, 3, 21))
    for a, c in zip(lk.listwise_loss_fused(lg, lab, grp),
                    lk.listwise_loss_fused_plain(lg, lab, grp)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    lk.listwise_loss_sum(lg, lab, grp)
    mk.multi_dense(x, w, b, False)
    assert (mk.multi_dense_fused.launches,
            lk.listwise_loss_sum.launches) == before == (0, 0)

    def meta(*ts):
        return [a.to("meta") for a in ts]

    for call in (lambda: mk.multi_dense_fused(*meta(x, w, b), True),
                 lambda: mk.multi_dense(*meta(x, w, b), False),
                 lambda: lk.listwise_loss_fused(*meta(lg, lab, grp)),
                 lambda: lk.listwise_loss_sum(*meta(lg, lab, grp))):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


def test_slice4_wrappers_take_plain_version_on_cpu_only():
    """B10 and B7a/b/c: plain on CPU tensors (no launch counted), an error
    on any other non-CUDA device."""
    rng = np.random.RandomState(3)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    table, m, v, g = t(12, 4), t(12, 4), t(12, 4).abs(), t(12, 4)
    touched = torch.from_numpy(rng.rand(12) > 0.5)
    count = torch.tensor(3, dtype=torch.int32)
    want = [x.clone() for x in (table, m, v)]
    tk.adam_dense_pass(table, m, v, g, touched, count, 1e-3)
    tk.adam_dense_pass_plain(*want, g, touched, count, 1e-3, 0.9, 0.999,
                             1e-7)
    torch.testing.assert_close((table, m, v), tuple(want), rtol=0, atol=0)
    x, lab = t(19), torch.from_numpy(rng.randint(0, 3, 19).astype(np.float32))
    grp = [torch.from_numpy(rng.randint(0, 3, 19)) for _ in range(2)]
    mask = torch.from_numpy((rng.rand(19) > 0.3).astype(np.float32))
    torch.testing.assert_close(
        pk.pair_row_counts(x, lab, grp, mask, True),
        pk.pair_row_counts_plain(x, lab, grp, mask, True), rtol=0, atol=0)
    torch.testing.assert_close(pk.same_group_matvec(grp[0], x),
                               pk.same_group_matvec_plain(grp[0], x),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        pk.group_pair_counts_binary(grp[0], lab, mask),
        pk.group_pair_counts_binary_plain(grp[0], lab, mask), rtol=0, atol=0)
    assert (tk.adam_dense_pass.launches, pk.pair_row_counts.launches,
            pk.same_group_matvec.launches,
            pk.group_pair_counts_binary.launches) == (0, 0, 0, 0)

    def meta(*ts):
        return [a.to("meta") for a in ts]

    for call in (lambda: tk.adam_dense_pass(*meta(table, m, v, g, touched,
                                                  count), 1e-3),
                 lambda: pk.pair_row_counts(*meta(x, lab), grp),
                 lambda: pk.same_group_matvec(*meta(grp[0], x)),
                 lambda: pk.group_pair_counts_binary(*meta(grp[0], lab))):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


def test_slice5_wrappers_take_plain_version_on_cpu_only():
    """B11 and B12: plain on CPU tensors (no launch counted), an error on
    any other non-CUDA device; B11 refuses a table that requires grad
    rather than hand back rows without a gradient, and B12 tensors that
    require grad."""
    from rec_now_tpu_torch.ops import expand_kernel as ek
    from rec_now_tpu_torch.ops import gather_kernel as gk
    rng = np.random.RandomState(4)
    table = torch.from_numpy(rng.randn(20, 4).astype(np.float32))
    ids = torch.from_numpy(rng.randint(-3, 25, (6, 5)))
    torch.testing.assert_close(gk.gather_rows(table, ids),
                               gk.gather_rows_plain(table, ids),
                               rtol=0, atol=0)
    out, want = torch.zeros(20, 4), torch.zeros(20, 4)
    flat, vals = ids.reshape(-1), torch.randn(30, 4)
    ek.scatter_add_rows(out, flat, vals)
    ek.scatter_add_rows_plain(want, flat, vals)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert (gk.gather_rows.launches, ek.scatter_add_rows.launches) == (0, 0)
    with pytest.raises(ValueError, match="forward only"):
        gk.gather_rows(table.clone().requires_grad_(), ids)
    with pytest.raises(ValueError, match="no gradient"):
        ek.scatter_add_rows(out, flat, vals.requires_grad_())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gk.gather_rows(table.to("meta"), ids.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ek.scatter_add_rows(out.to("meta"), flat.to("meta"),
                            vals.detach().to("meta"))


def test_slice5_entry_points_default_to_cuda(monkeypatch):
    """The FM model, the device metrics and the training CLI raise on a
    host without CUDA unless asked for the CPU."""
    from rec_now_tpu_torch import train as cli
    from rec_now_tpu_torch.models import FMModel
    from rec_now_tpu_torch.training.metrics import (DeviceGroupedAUC,
                                                    DeviceStreamingAUC)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fc = FeatureConfig(rows_per_field=16, embedding_dim=4)
    for make in (lambda: FMModel(fc),
                 lambda: DeviceStreamingAUC(64),
                 lambda: DeviceGroupedAUC.init(8, 16),
                 lambda: cli.main(["--model", "fm", "--steps", "1",
                                   "--rows-per-field", "16"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert FMModel(fc, device="cpu").bias.device == torch.device("cpu")
    assert DeviceStreamingAUC(64, device="cpu").hist.shape == (2, 64)
