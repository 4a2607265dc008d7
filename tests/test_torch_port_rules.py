"""Rules the port keeps: no JAX at run time, CUDA unless asked otherwise,
plain versions only for CPU tensors."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.models import (FeatureConfig, MultiTaskModel,
                                      XDeepFMModel)
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
        print(len(mods))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


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
    for make in (lambda: EmbeddingTable(fc.total_rows, 4),
                 lambda: XDeepFMModel(fc, (4,), deep_dims=(8,)),
                 lambda: MultiTaskModel(fc, **mt),
                 lambda: build_scorer(cpu_model, fc, cpu_table),
                 lambda: WireScorer(cpu_model, fc, cpu_table),
                 lambda: ShardedEmbeddingTable(fc.total_rows, 4),
                 lambda: Trainer(cpu_model, fc, TrainerConfig()),
                 lambda: Trainer(cpu_mt, fc, cfg4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # asked for the CPU, they run there
    assert ShardedEmbeddingTable(fc.total_rows, 4, device="cpu").device == \
        torch.device("cpu")
    assert Trainer(cpu_model, fc, TrainerConfig(),
                   device="cpu").device == torch.device("cpu")
    assert Trainer(cpu_mt, fc, cfg4, device="cpu").device == \
        torch.device("cpu")


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
