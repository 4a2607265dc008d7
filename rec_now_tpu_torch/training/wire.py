"""Compressed host->device wire for training batches and serving requests.

Counterpart of ``rec_now_tpu/training/wire.py`` in its ``packed`` id
mode: host-side numpy packing (the JAX package's numpy code, with its
loops laid out to run over contiguous memory: the same bytes) and
device-side decoding on tensors.

* sparse ids: bit-packed to ``ceil(log2(rows_per_field))`` bits each in
  uint32 words;
* dense: float16, or uint8 with a per-batch-shard per-feature affine
  (``dense_mode='u8'``; ``num_shards`` contiguous chunks of the batch each
  get their own (offset, step));
* flags: label (bit 0), cvr label (bit 1) and domain (bits 2-7, < 64)
  in one uint8;
* group ids: remapped per batch to their sorted-unique rank (< B, so they
  fit uint16), or passed through unremapped (``raw_groups``, the corpus
  GAUC eval path, ids pre-mapped to slots < 65536).

Torch has little uint16 and uint32 arithmetic, so the words travel as
int32 and the groups as int16 (the same bytes), widened on the device and
masked.  The ``hot8`` id mode is not ported yet (ROADMAP A17).  Unlike the
JAX ``_pack_sparse`` (``wire.py:377``), ``pack``'s ``num_shards`` override
reaches every field, the escape placeholder included.

Example:
    wire = WireFormat(26, 100_000, dense_mode="u8")
    packed = wire.pack_window(batches)              # host numpy
    on_card = PackedBatch(*[t.to("cuda") for t in to_tensors(packed)])
    dense, ids, labels, groups, cvr, domain = wire.decode(
        PackedBatch(*[t[0] for t in on_card]))      # the window's step 0
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.training.data import Batch

# rows of ids that pack_ids packs at a time: one B = 8,192 batch, whose
# 26 fields (852 KB as int32) stay in cache through the field loop
PACK_BLOCK_ROWS = 8192

class PackedBatch(NamedTuple):
    """A packed batch (numpy on the host, tensors on the device); leading
    axes preserved.  ``dense_scale`` is (..., num_shards, 2, num_dense)
    f32 (offset, step) under u8 and zeros under f16; ``esc`` is the
    (..., num_shards, 1) placeholder of the ``packed`` id mode."""
    dense: np.ndarray       # (..., B, num_dense) float16 | uint8
    dense_scale: np.ndarray  # (..., shards, 2, num_dense) f32 affine
    id_words: np.ndarray    # (..., B, W) uint32 bit-packed ids
    group_ids: np.ndarray   # (..., B) uint16 in-batch remapped groups
    flags: np.ndarray       # (..., B) uint8: label | cvr<<1 | domain<<2
    esc: np.ndarray = np.zeros((), np.uint8)  # (..., shards, 1) u8


def id_bits(rows_per_field: int) -> int:
    """Bits per id: ceil(log2(rows_per_field)), min 1, max 32."""
    return max(1, min(32, math.ceil(math.log2(max(2, rows_per_field)))))


def num_words(num_sparse: int, bits: int) -> int:
    """uint32 words per example: the exact count packing touches."""
    return (num_sparse * bits - 1) // 32 + 1


def pack_ids(ids: np.ndarray, bits: int) -> np.ndarray:
    """Bit-pack (..., F) ids (< 2**bits) into (..., W) uint32 words.

    Field-major, a block of rows at a time: each shift and OR runs over
    one field's contiguous ids, and a block's fields stay in cache (a
    column loop over the (N, F) layout runs ~3x slower at N = 40,960,
    time a window's pack takes from the loop thread).
    """
    f = ids.shape[-1]
    w = num_words(f, bits)
    flat = ids.reshape(-1, f)
    out = np.empty((flat.shape[0], w), np.uint32)
    for lo in range(0, flat.shape[0], PACK_BLOCK_ROWS):
        vals = flat[lo:lo + PACK_BLOCK_ROWS].T.astype(np.uint32, order="C")
        words = np.zeros((w, vals.shape[1]), np.uint32)
        for i in range(f):
            start = i * bits
            wi, sh = start // 32, start % 32
            words[wi] |= vals[i] << np.uint32(sh)
            if sh + bits > 32:
                words[wi + 1] |= vals[i] >> np.uint32(32 - sh)
        out[lo:lo + PACK_BLOCK_ROWS] = words.T
    return out.reshape(ids.shape[:-1] + (w,))


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


def raw_groups_u16(group_ids: np.ndarray) -> np.ndarray:
    """Group ids through the u16 field unremapped (pre-mapped corpus
    slots, < 65536)."""
    g = np.asarray(group_ids)
    if g.size and (int(g.max()) > 0xFFFF or int(g.min()) < 0):
        raise ValueError(
            "raw group wire needs ids in [0, 65536); got "
            f"[{int(g.min())}, {int(g.max())}] — pre-map ids into a "
            "dense corpus slot space first")
    return g.astype(np.uint16)


def remap_groups(group_ids: np.ndarray) -> np.ndarray:
    """Per-batch bijective remap of (..., B) group ids to their
    sorted-unique rank, uint16: within-batch equality is kept."""
    if group_ids.shape[-1] > 0xFFFF:
        raise ValueError("in-batch group remap needs batch <= 65535; "
                         f"got {group_ids.shape[-1]}")
    flat = group_ids.reshape(-1, group_ids.shape[-1])
    out = np.empty(flat.shape, np.uint16)
    for r in range(flat.shape[0]):
        _, inv = np.unique(flat[r], return_inverse=True)
        out[r] = inv.astype(np.uint16)
    return out.reshape(group_ids.shape)


def _pack_flags(labels, cvr, domain) -> np.ndarray:
    dom = domain.astype(np.uint8)
    if dom.size and int(dom.max()) >= 64:
        raise ValueError(
            "wire flags byte holds the domain index in 6 bits; "
            f"got domain {int(dom.max())} >= 64")
    return ((labels > 0).astype(np.uint8)
            | ((cvr > 0).astype(np.uint8) << np.uint8(1))
            | (dom << np.uint8(2)))


def _native() -> ctypes.CDLL:
    """The C++ pack (``csrc/wire.cu``), built at first use."""
    lib = _build.load("wire")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wire_pack_ids.argtypes = [ptr, i32, i64, i32, i32, ptr]
        lib.wire_pack_dense_u8.argtypes = [ptr, i64, i64, i32, i32, ptr, ptr]
        lib.wire_remap_groups.argtypes = [ptr, i32, i64, i64, ptr]
        lib.wire_pack_flags.argtypes = [ptr, ptr, ptr, i32, i64, ptr]
        for fn in (lib.wire_pack_ids, lib.wire_pack_dense_u8,
                   lib.wire_remap_groups, lib.wire_pack_flags):
            fn.restype = i32
        lib._typed = True
    return lib


def _of(name: str, a: np.ndarray, *dtypes) -> np.ndarray:
    """``a`` contiguous; raise unless its dtype is one of ``dtypes``."""
    if a.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))} "
                        f"for the native pack, got {a.dtype}")
    return np.ascontiguousarray(a)


def to_tensors(packed: PackedBatch) -> PackedBatch:
    """A host PackedBatch as CPU tensors, the uint32 words and uint16
    groups reinterpreted as int32 and int16 (no copy)."""
    return PackedBatch(
        torch.from_numpy(np.ascontiguousarray(packed.dense)),
        torch.from_numpy(np.ascontiguousarray(packed.dense_scale)),
        torch.from_numpy(np.ascontiguousarray(packed.id_words).view(
            np.int32)),
        torch.from_numpy(np.ascontiguousarray(packed.group_ids).view(
            np.int16)),
        torch.from_numpy(np.ascontiguousarray(packed.flags)),
        torch.from_numpy(np.ascontiguousarray(packed.esc)))


class WireFormat:
    """Pack/decode pair bound to a feature layout (``packed`` ids).

    Args:
        num_sparse: sparse fields per example.
        rows_per_field: id space per field (sets bits/id).
        dense_mode: 'f16' or 'u8' (per-batch-shard per-feature affine).
        num_shards: batch shards the u8 affine is computed over.
        id_mode: 'packed'; 'hot8' is not ported yet and raises.
    """

    def __init__(self, num_sparse: int, rows_per_field: int,
                 dense_mode: str = "f16", num_shards: int = 1,
                 id_mode: str = "packed"):
        if dense_mode not in ("f16", "u8"):
            raise ValueError(f"unknown dense_mode {dense_mode!r}")
        if id_mode == "hot8":
            raise NotImplementedError(
                "wire id_mode='hot8' is not ported yet (ROADMAP A17)")
        if id_mode != "packed":
            raise ValueError(f"unknown id_mode {id_mode!r}")
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_sparse = num_sparse
        self.rows_per_field = rows_per_field
        self.bits = id_bits(rows_per_field)
        self.words = num_words(num_sparse, self.bits)
        self.dense_mode = dense_mode
        self.num_shards = num_shards
        self.id_mode = id_mode

    def _pack_dense(self, dense: np.ndarray, shards: int):
        """-> (packed dense, (..., shards, 2, F) f32 scale)."""
        b, f = dense.shape[-2], dense.shape[-1]
        if b % shards:
            raise ValueError(
                f"batch {b} must divide by num_shards {shards}")
        if self.dense_mode == "f16":
            scale = np.zeros(dense.shape[:-2] + (shards, 2, f), np.float32)
            return dense.astype(np.float16), scale
        chunked = dense.reshape(dense.shape[:-2] + (shards, b // shards, f))
        # feature-major: each feature's values contiguous, so the min, max
        # and affine run along rows (over the (B, F) layout numpy's inner
        # loops are F = 13 long, ~3x slower)
        cols = np.swapaxes(chunked, -1, -2).copy()   # (..., shards, F, b)
        lo = cols.min(axis=-1, keepdims=True)
        hi = cols.max(axis=-1, keepdims=True)
        step = (hi - lo) / 255.0
        q = (cols - lo) / np.where(step > 0, step, 1.0)
        np.rint(q, out=q)
        scale = np.concatenate([lo, step], axis=-1).astype(np.float32)
        return (np.swapaxes(q.astype(np.uint8), -1, -2).reshape(dense.shape),
                np.ascontiguousarray(np.swapaxes(scale, -1, -2)))

    def _pack_sparse(self, ids: np.ndarray, shards: int):
        """(..., B, F) ids -> (id_words, (..., shards, 1) esc placeholder)."""
        lead = ids.shape[:-2]
        return (pack_ids(ids, self.bits),
                np.zeros(lead + (shards, 1), np.uint8))

    def pack_request(self, dense: np.ndarray, sparse_ids: np.ndarray,
                     num_shards: int = 1):
        """Pack a label-free scoring request -> (qdense, scale, words)."""
        q, scale = self._pack_dense(np.asarray(dense), num_shards)
        return q, scale, pack_ids(np.asarray(sparse_ids), self.bits)

    def pack(self, batch: Batch,
             num_shards: Optional[int] = None) -> PackedBatch:
        """Compress one host batch (any leading axes); ``num_shards``
        overrides the affine's shard count in every field."""
        shards = self.num_shards if num_shards is None else num_shards
        d, scale = self._pack_dense(batch.dense, shards)
        idw, esc = self._pack_sparse(np.asarray(batch.sparse_ids), shards)
        return PackedBatch(
            dense=d, dense_scale=scale, id_words=idw,
            group_ids=remap_groups(batch.group_ids),
            flags=_pack_flags(batch.labels, batch.cvr_labels,
                              batch.domain_idx),
            esc=esc)

    def pack_window(self, batches: Sequence[Batch],
                    num_shards: Optional[int] = None,
                    raw_groups: bool = False) -> PackedBatch:
        """Stack and compress a window of identically-shaped batches;
        ``raw_groups`` ships group ids unremapped (:func:`raw_groups_u16`)."""
        shards = self.num_shards if num_shards is None else num_shards
        group_fn = raw_groups_u16 if raw_groups else remap_groups
        d, scale = self._pack_dense(np.stack([b.dense for b in batches]),
                                    shards)
        # each batch's ids packed alone: no stacked copy of the raw ids
        idw = np.stack([pack_ids(np.asarray(b.sparse_ids), self.bits)
                        for b in batches])
        esc = np.zeros((len(batches), shards, 1), np.uint8)
        return PackedBatch(
            dense=d, dense_scale=scale, id_words=idw,
            group_ids=group_fn(np.stack([b.group_ids for b in batches])),
            flags=_pack_flags(
                np.stack([b.labels for b in batches]),
                np.stack([b.cvr_labels for b in batches]),
                np.stack([b.domain_idx for b in batches])),
            esc=esc)

    def pack_window_native(self, batches: Sequence[Batch],
                           raw_groups: bool = False) -> PackedBatch:
        """:meth:`pack_window`'s bytes (at ``num_shards``) from the C++
        pack in ``csrc/wire.cu``, built at first use with the CUDA sources
        (it needs nvcc).  The ids, the u8 dense, the group ranks and the
        flags are one call each that releases the interpreter lock, so a
        prefetch thread packing the next window holds up the thread that
        dispatches the steps for little more than the stacking.  Takes
        :class:`Batch`'s dtypes: dense, labels and cvr float32; ids,
        groups and domains int32 or int64."""
        lib, i32, i64 = _native(), np.int32, np.int64
        f32 = np.float32
        stack = [np.stack(x) for x in zip(*[
            (b.dense, b.sparse_ids, b.group_ids, b.labels, b.cvr_labels,
             b.domain_idx) for b in batches])]
        dense = _of("dense", stack[0], f32)
        ids = _of("sparse_ids", stack[1], i32, i64)
        groups = _of("group_ids", stack[2], i32, i64)
        labels, cvr = _of("labels", stack[3], f32), _of("cvr", stack[4], f32)
        domain = _of("domain_idx", stack[5], i32, i64)
        (s, b, f), shards = ids.shape, self.num_shards

        def call(fn, *args):
            rc = fn(*[a.ctypes.data if isinstance(a, np.ndarray) else a
                      for a in args])
            if rc != 0:
                raise RuntimeError(
                    f"wire pack: {lib.error_string(rc).decode()}")

        words = np.empty((s, b, num_words(f, self.bits)), np.uint32)
        call(lib.wire_pack_ids, ids, int(ids.dtype == i64), s * b, f,
             self.bits, words)
        if b % shards:
            raise ValueError(f"batch {b} must divide by num_shards {shards}")
        if self.dense_mode == "u8":
            q = np.empty(dense.shape, np.uint8)
            scale = np.empty((s, shards, 2, dense.shape[-1]), np.float32)
            call(lib.wire_pack_dense_u8, dense, s, b, dense.shape[-1],
                 shards, q, scale)
        else:
            q = dense.astype(np.float16)
            scale = np.zeros((s, shards, 2, dense.shape[-1]), np.float32)
        if raw_groups:
            g = raw_groups_u16(groups)
        else:
            if b > 0xFFFF:
                raise ValueError("in-batch group remap needs batch <= "
                                 f"65535; got {b}")
            g = np.empty((s, b), np.uint16)
            call(lib.wire_remap_groups, groups, int(groups.dtype == i64), s,
                 b, g)
        flags = np.empty((s, b), np.uint8)
        if lib.wire_pack_flags(labels.ctypes.data, cvr.ctypes.data,
                               domain.ctypes.data,
                               int(domain.dtype == i64), s * b,
                               flags.ctypes.data):
            raise ValueError(
                "wire flags byte holds the domain index in 6 bits; got "
                f"domain {int(domain.astype(np.uint8).max())} >= 64")
        return PackedBatch(dense=q, dense_scale=scale, id_words=words,
                           group_ids=g, flags=flags,
                           esc=np.zeros((s, shards, 1), np.uint8))

    def decode_dense(self, dense: torch.Tensor,
                     dense_scale: torch.Tensor) -> torch.Tensor:
        """Dense decode on the device: f16 widened, or u8 through its
        shard's affine as one multiply-add (``addcmul``, the fused form
        XLA gives the JAX decode)."""
        if self.dense_mode != "u8":
            return dense.to(torch.float32)
        n = dense_scale.shape[-3]
        b, f = dense.shape[-2], dense.shape[-1]
        q = dense.reshape(dense.shape[:-2] + (n, b // n, f))
        lo = dense_scale[..., 0, :].unsqueeze(-2)        # (..., n, 1, F)
        step = dense_scale[..., 1, :].unsqueeze(-2)
        return torch.addcmul(lo, q.to(torch.float32), step).reshape(
            dense.shape)

    def decode(self, packed: PackedBatch) -> Tuple[torch.Tensor, ...]:
        """Device-side decode of a PackedBatch of tensors (as
        :func:`to_tensors` lays them out) -> (dense f32, ids int64,
        labels f32, groups int32, cvr f32, domain int32)."""
        dense = self.decode_dense(packed.dense, packed.dense_scale)
        ids = unpack_ids(packed.id_words, self.num_sparse, self.bits)
        flags = packed.flags.to(torch.int32)
        labels = (flags & 1).to(torch.float32)
        cvr = ((flags >> 1) & 1).to(torch.float32)
        domain = flags >> 2
        groups = packed.group_ids.to(torch.int32) & 0xFFFF
        return dense, ids, labels, groups, cvr, domain

    @staticmethod
    def wire_cost(num_dense: int, num_sparse: int, rows_per_field: int,
                  dense_mode: str = "f16") -> Tuple[int, int]:
        """(packed, raw) bytes per example in the ``packed`` id mode (the
        scale metadata amortizes to ~0 over a window and is excluded)."""
        bits = id_bits(rows_per_field)
        per_dense = 2 if dense_mode == "f16" else 1
        packed = (num_dense * per_dense
                  + num_words(num_sparse, bits) * 4
                  + 2     # group ids u16 (in-batch remap)
                  + 1)    # flags byte: label | cvr | domain
        raw = num_dense * 4 + num_sparse * 4 + 4 + 4 + 4 + 4
        return packed, raw
