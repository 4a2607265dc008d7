"""Dense-apply Adagrad pass over the embedding table
(``csrc/table_update.cu``), its wrapper and plain version.

Counterpart of ``rec_now_tpu/ops/pallas/table_update_kernel.py``
``adagrad_dense_pass`` on the logical (V, D) table and a (V,)
accumulator, without the TPU's lane packing:

    acc   += mean_d g ** 2
    table -= lr / sqrt(max(acc, eps)) * g

Both versions update ``table`` and ``acc`` in place (the port keeps one
copy of the table; JAX returns new arrays and donates the old ones).
The wrapper takes :func:`adagrad_dense_pass_plain` for CPU tensors and
the kernel for CUDA tensors; ``adagrad_dense_pass.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu


def adagrad_dense_pass_plain(table: torch.Tensor, acc: torch.Tensor,
                             dense_g: torch.Tensor, lr: float,
                             eps: float = 1e-12) -> None:
    """In place: ``sharded.py:708-715`` on a (V, D) table."""
    acc.add_(dense_g.square().mean(dim=1))
    table.sub_((lr / acc.clamp_min(eps).sqrt())[:, None] * dense_g)


def _lib() -> ctypes.CDLL:
    lib = _build.load("table_update")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.adagrad_dense_f32.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                          i32, ctypes.c_float, ctypes.c_float,
                                          i32, ptr]
        lib.adagrad_dense_f32.restype = i32
        lib._typed = True
    return lib


def adagrad_dense_pass(table: torch.Tensor, acc: torch.Tensor,
                       dense_g: torch.Tensor, lr: float,
                       eps: float = 1e-12) -> None:
    """Row-wise Adagrad over the whole table, in place: table (V, D),
    acc (V,), dense_g (V, D), all float32.  On CUDA, D must be a
    multiple of 4 with D / 4 dividing 32 (4, 8, 16, 32, 64 or 128)."""
    if is_cpu(table, "adagrad_dense_pass"):
        adagrad_dense_pass_plain(table, acc, dense_g, lr, eps)
        return
    dev = table.device
    check_input("table", table, 2, dev)
    check_input("acc", acc, 1, dev)
    check_input("dense_g", dense_g, 2, dev)
    v, d = table.shape
    if tuple(dense_g.shape) != (v, d) or acc.shape[0] != v:
        raise ValueError(f"table {tuple(table.shape)}, acc "
                         f"{tuple(acc.shape)} and dense_g "
                         f"{tuple(dense_g.shape)} disagree")
    if d not in (4, 8, 16, 32, 64, 128):
        raise ValueError(f"embedding dim {d} is not one of 4, 8, 16, 32, "
                         f"64, 128")
    lib = _lib()
    rc = lib.adagrad_dense_f32(table.data_ptr(), acc.data_ptr(),
                               dense_g.data_ptr(), v, d, lr, eps, dev.index,
                               _build.stream_of(table))
    check_rc(lib, rc, "adagrad_dense_pass")
    adagrad_dense_pass.launches += 1


adagrad_dense_pass.launches = 0
