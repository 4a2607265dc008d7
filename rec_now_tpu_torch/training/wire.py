"""Compressed request wire, serving subset.

Counterpart of the serving half of ``rec_now_tpu/training/wire.py`` in
its ``packed`` id mode: host-side numpy packing (bit-packed ids in
uint32 words; f16 dense or per-feature-affine u8 dense) and device-side
decoding on tensors.  The host packing is a copy of the JAX package's
numpy code.  Torch has little uint32 arithmetic, so the decode moves the
words as int32 (same bytes), widens them to int64 on the device and
masks to 32 bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def id_bits(rows_per_field: int) -> int:
    """Bits per id: ceil(log2(rows_per_field)), min 1, max 32."""
    return max(1, min(32, math.ceil(math.log2(max(2, rows_per_field)))))


def num_words(num_sparse: int, bits: int) -> int:
    """uint32 words per example: the exact count packing touches."""
    return (num_sparse * bits - 1) // 32 + 1


def pack_ids(ids: np.ndarray, bits: int) -> np.ndarray:
    """Bit-pack (..., F) ids (< 2**bits) into (..., W) uint32 words."""
    f = ids.shape[-1]
    w = num_words(f, bits)
    out = np.zeros(ids.shape[:-1] + (w,), np.uint32)
    vals = ids.astype(np.uint32)
    for i in range(f):
        start = i * bits
        wi, sh = start // 32, start % 32
        out[..., wi] |= vals[..., i] << np.uint32(sh)
        if sh + bits > 32:
            out[..., wi + 1] |= vals[..., i] >> np.uint32(32 - sh)
    return out


def unpack_ids(words: torch.Tensor, num_sparse: int,
               bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_ids` on a tensor of 32-bit words (int32 or
    int64 holding the uint32 bit patterns) -> (..., F) int64.

    All fields at once (a gather and a few shifts) rather than a loop over
    fields: run eagerly, the loop would launch several kernels per field.
    """
    w = words.to(torch.int64) & 0xFFFFFFFF
    start = torch.arange(num_sparse, device=w.device) * bits
    wi, sh = start // 32, start % 32
    # a field spans into the next word when its bits cross a word end
    spans = (sh > 0) & (sh + bits > 32)
    nxt = torch.clamp(wi + 1, max=w.shape[-1] - 1)
    lo = w[..., wi] >> sh
    hi = torch.where(spans, w[..., nxt] << (32 - sh), 0)
    return (lo | hi) & ((1 << bits) - 1)


class WireFormat:
    """Pack/decode pair bound to a feature layout (``packed`` ids).

    Args:
        num_sparse: sparse fields per example.
        rows_per_field: id space per field (sets bits/id).
        dense_mode: 'f16' or 'u8' (per-feature affine over the request).

    The dense scale keeps the JAX wire's (..., shards, 2, F) layout with
    one shard, so a packed request is the same bytes on both sides.
    """

    def __init__(self, num_sparse: int, rows_per_field: int,
                 dense_mode: str = "f16"):
        if dense_mode not in ("f16", "u8"):
            raise ValueError(f"unknown dense_mode {dense_mode!r}")
        self.num_sparse = num_sparse
        self.bits = id_bits(rows_per_field)
        self.words = num_words(num_sparse, self.bits)
        self.dense_mode = dense_mode

    def _pack_dense(self, dense: np.ndarray):
        """-> (packed dense, (..., 1, 2, F) f32 scale)."""
        f = dense.shape[-1]
        if self.dense_mode == "f16":
            scale = np.zeros(dense.shape[:-2] + (1, 2, f), np.float32)
            return dense.astype(np.float16), scale
        lo = dense.min(axis=-2, keepdims=True)       # (..., 1, F)
        hi = dense.max(axis=-2, keepdims=True)
        step = (hi - lo) / 255.0
        q = np.rint((dense - lo) / np.where(step > 0, step, 1.0))
        scale = np.stack([lo, step], axis=-2).astype(np.float32)
        return q.astype(np.uint8), scale

    def pack_request(self, dense: np.ndarray, sparse_ids: np.ndarray):
        """Pack a label-free scoring request -> (qdense, scale, words)."""
        q, scale = self._pack_dense(np.asarray(dense))
        return q, scale, pack_ids(np.asarray(sparse_ids), self.bits)

    def decode_dense(self, dense: torch.Tensor,
                     dense_scale: torch.Tensor) -> torch.Tensor:
        """Dense decode on the device (f16 widen / u8 affine)."""
        if self.dense_mode != "u8":
            return dense.to(torch.float32)
        lo = dense_scale[..., 0, :]                  # (..., 1, F)
        step = dense_scale[..., 1, :]
        return dense.to(torch.float32) * step + lo
