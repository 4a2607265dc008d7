"""Rules the port keeps: no JAX at run time, CUDA unless asked otherwise,
plain versions only for CPU tensors."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.models import FeatureConfig, XDeepFMModel
from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops import cin_kernel as ck
from rec_now_tpu_torch.serving import WireScorer, build_scorer

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
    assert int(out.stdout.strip()) >= 15


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device= on a host without CUDA, entry points raise
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fc = FeatureConfig(rows_per_field=16, embedding_dim=4)
    cpu_model = XDeepFMModel(fc, (4,), deep_dims=(8,), device="cpu")
    cpu_table = EmbeddingTable(fc.total_rows, 4, device="cpu")
    for make in (lambda: EmbeddingTable(fc.total_rows, 4),
                 lambda: XDeepFMModel(fc, (4,), deep_dims=(8,)),
                 lambda: build_scorer(cpu_model, fc, cpu_table),
                 lambda: WireScorer(cpu_model, fc, cpu_table)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


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
