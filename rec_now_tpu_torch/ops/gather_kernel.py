"""Row gather from the embedding table (kernel B11, ``csrc/gather.cu``)
and the pooled multi-hot lookup beside it, their wrappers and plain
versions.

Counterpart of ``rec_now_tpu/ops/pallas/gather_kernel.py``
``packed_gather`` on the logical (R, D) table: the TPU's lane packing is
not kept, so its line DMA plus lane select becomes a row gather::

    out[k] = table[clamp(ids[k], 0, R - 1)]

Ids outside [0, R) clamp into it, as the JAX kernel clamps the physical
row (at one row per line the same thing).  Forward only, as in JAX: the
wrapper raises for a table that requires grad rather than hand back rows
with no ``grad_fn`` (the trainer makes the looked-up rows a leaf of their
own and passes their gradient to the table explicitly).

:func:`gather_pool_rows` (no TPU counterpart: the JAX package has one id
a field) sums each field's rows of a multi-hot request::

    out[b, f] = sum of table[clamp(ids[b, j], 0, R - 1)]
                over field f's columns j

without the (B, sum(hotness), D) gathered rows in between.

Each wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``gather_rows.launches`` and
``gather_pool_rows.launches`` count launches.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Sequence, Tuple

import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[clamp(ids, 0, R - 1)]``: ids.shape + (D,)."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gather_rows_f32.argtypes = [ptr, i64, i32, ptr, i32, i64, ptr,
                                        i32, ptr]
        lib.gather_rows_f32.restype = i32
        lib.scatter_add_rows_f32.argtypes = [ptr, i64, i32, ptr, i32, i64,
                                             ptr, i32, ptr]
        lib.scatter_add_rows_f32.restype = i32
        lib.gather_pool_rows_f32.argtypes = [ptr, i64, i32, ptr, i32, i64,
                                             i32, ptr, i32, ptr, i32, ptr]
        lib.gather_pool_rows_f32.restype = i32
        lib._typed = True
    return lib


def check_ids(ids: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``ids`` flattened and contiguous (itself when it already is); raise
    unless int32 or int64 on the CUDA ``device``."""
    if ids.get_device() != device.index:
        raise ValueError(f"ids are on {ids.device}, expected {device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if ids.dim() == 1 and ids.is_contiguous():
        return ids
    return ids.reshape(-1).contiguous()


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of a (R, D) float32 table at int32 / int64 ``ids`` of any
    shape -> ids.shape + (D,); ids outside [0, R) clamp into it."""
    if table.requires_grad:
        raise ValueError("gather_rows is forward only (as packed_gather): "
                         "pass a table that does not require grad")
    if is_cpu(table, "gather_rows"):
        return gather_rows_plain(table, ids)
    dev = table.device
    check_input("table", table, 2, dev)
    flat = check_ids(ids, dev)
    rows, d = table.shape
    if rows == 0:
        raise ValueError("gather_rows needs a table with at least one row")
    out = table.new_empty((flat.numel(), d))    # f32 on the table's device
    if out.numel():                    # a grid of 0 blocks is a launch error
        lib = _lib()
        rc = lib.gather_rows_f32(table.data_ptr(), rows, d, flat.data_ptr(),
                                 int(flat.dtype == torch.int64), flat.numel(),
                                 out.data_ptr(), dev.index,
                                 _build.stream_of(table))
        check_rc(lib, rc, "gather_rows")
        gather_rows.launches += 1
    return out if ids.dim() == 1 else out.reshape(tuple(ids.shape) + (d,))


gather_rows.launches = 0


def _check_hotness(ids: torch.Tensor, hotness: Sequence[int]
                   ) -> Tuple[int, ...]:
    hotness = tuple(int(h) for h in hotness)
    if not hotness or min(hotness) < 0:
        raise ValueError(f"hotness needs a count >= 0 a field, got {hotness}")
    if ids.dim() != 2 or ids.shape[1] != sum(hotness):
        raise ValueError(f"ids must be (B, sum(hotness) = {sum(hotness)}), "
                         f"got {tuple(ids.shape)}")
    return hotness


def gather_pool_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                           hotness: Sequence[int]) -> torch.Tensor:
    """Index and sum: each field's rows of ``table[clamp(ids, 0, R - 1)]``
    added in column order, on any device -> (B, F, D).  Step j adds the
    j-th id's row of every field that has one."""
    hotness = _check_hotness(ids, hotness)
    rows = table[ids.clamp(0, table.shape[0] - 1)]          # (B, N, D)
    out = rows.new_zeros((ids.shape[0], len(hotness), table.shape[1]))
    starts = [sum(hotness[:f]) for f in range(len(hotness))]
    for j in range(max(hotness)):
        fields = [f for f, h in enumerate(hotness) if h > j]
        out[:, fields] += rows[:, [starts[f] + j for f in fields]]
    return out


@functools.lru_cache(maxsize=64)
def _field_starts(hotness: Tuple[int, ...], device: torch.device
                  ) -> torch.Tensor:
    """(F + 1,) int32 first column of each field and the end, on
    ``device``, made once a hotness and device."""
    with torch.inference_mode(False):
        return torch.tensor([0, *itertools.accumulate(hotness)],
                            dtype=torch.int32, device=device)


def gather_pool_rows(table: torch.Tensor, ids: torch.Tensor,
                     hotness: Sequence[int]) -> torch.Tensor:
    """Sum-pooled rows of a (R, D) float32 table: ``ids`` (B, sum(hotness))
    int32 / int64, field f's ``hotness[f]`` ids side by side in field
    order -> (B, F, D), each field's rows added in column order; ids
    outside [0, R) clamp into it."""
    if table.requires_grad:
        raise ValueError("gather_pool_rows is forward only: pass a table "
                         "that does not require grad")
    if is_cpu(table, "gather_pool_rows"):
        return gather_pool_rows_plain(table, ids, hotness)
    hotness = _check_hotness(ids, hotness)
    dev = table.device
    check_input("table", table, 2, dev)
    flat = check_ids(ids, dev)          # row-major: row b at b * sum(hot)
    rows, d = table.shape
    if rows == 0:
        raise ValueError("gather_pool_rows needs a table with at least one "
                         "row")
    out = table.new_empty((ids.shape[0], len(hotness), d))
    if out.numel():                    # a grid of 0 blocks is a launch error
        lib = _lib()
        starts = _field_starts(hotness, dev)
        rc = lib.gather_pool_rows_f32(
            table.data_ptr(), rows, d, flat.data_ptr(),
            int(flat.dtype == torch.int64), ids.shape[0], ids.shape[1],
            starts.data_ptr(), len(hotness), out.data_ptr(), dev.index,
            _build.stream_of(table))
        check_rc(lib, rc, "gather_pool_rows")
        gather_pool_rows.launches += 1
    return out


gather_pool_rows.launches = 0
