"""Row scatter-add into the embedding table or its gradient buffer (kernel
B12, ``csrc/gather.cu``), its wrapper and plain version.

Counterpart of ``rec_now_tpu/ops/pallas/expand_kernel.py``
``expand_lines`` together with the scatter it exists to feed: the
one-hot (N, P * D) lines and their ``.at[pr].add`` into the dense-gradient
buffer (``ShardedEmbeddingTable._scatter_dense_grads``,
``rec_now_tpu/embedding/sharded.py:661-674``) and the sparse path's
write-backs.  On the logical (R, D) table that is, in place::

    out[ids[k]] += vals[k]     for every k with 0 <= ids[k] < R

Duplicate ids sum; ids outside [0, R) are dropped, as JAX's scatter drops
the out-of-range sentinel rows.  The lines are a lane-packing artifact and
the port's buffer stays f32, so ``expand_lines``' ``out_dtype=bf16``
option is not carried over.  The kernel sums duplicates with atomics, in
no fixed order: against the plain version it agrees up to f32 rounding of
each sum.

:func:`scatter_add_rows` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; ``scatter_add_rows.launches`` counts
launches.
"""
from __future__ import annotations

import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu
from rec_now_tpu_torch.ops.gather_kernel import _lib, check_ids


def scatter_add_rows_plain(out: torch.Tensor, ids: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    """In place: the in-range ids' rows of ``vals`` added to ``out`` by
    ``index_add_``; returns ``out``."""
    keep = (ids >= 0) & (ids < out.shape[0])
    return out.index_add_(0, ids[keep], vals[keep])


def scatter_add_rows(out: torch.Tensor, ids: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """``out[ids[k]] += vals[k]`` in place for (R, D) float32 ``out``, (N,)
    int32 / int64 ``ids`` and (N, D) float32 ``vals``; out-of-range ids are
    dropped.  Returns ``out``."""
    if out.requires_grad or vals.requires_grad:
        raise ValueError("scatter_add_rows has no gradient: pass tensors "
                         "that do not require grad")
    if is_cpu(out, "scatter_add_rows"):
        return scatter_add_rows_plain(out, ids, vals)
    dev = out.device
    check_input("out", out, 2, dev)
    check_input("vals", vals, 2, dev)
    flat = check_ids(ids, dev)
    rows, d = out.shape
    if vals.shape != (flat.numel(), d):
        raise ValueError(f"vals {tuple(vals.shape)} must be "
                         f"({flat.numel()}, {d}) for {flat.numel()} ids "
                         f"into {tuple(out.shape)}")
    if vals.numel():                   # a grid of 0 blocks is a launch error
        lib = _lib()
        rc = lib.scatter_add_rows_f32(out.data_ptr(), rows, d,
                                      flat.data_ptr(),
                                      int(flat.dtype == torch.int64),
                                      flat.numel(), vals.data_ptr(),
                                      dev.index, _build.stream_of(out))
        check_rc(lib, rc, "scatter_add_rows")
        scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
