"""Compressed host->device wire for training batches and serving requests.

Counterpart of ``rec_now_tpu/training/wire.py``: host-side numpy packing
(the JAX package's numpy code, with its loops laid out to run over
contiguous memory: the same bytes) and device-side decoding on tensors.

* sparse ids (``id_mode='packed'``): bit-packed to
  ``ceil(log2(rows_per_field))`` bits each in uint32 words;
* sparse ids (``id_mode='hot8'``, lossless, for skewed ids): each
  field's 255 hottest ids, learned from the first window and relearned
  from a window that overflows the escape cap, travel as one byte code
  (0..254); every other id travels as code 255 plus its value in a
  per-batch-shard stream of 3-byte triples, C-order within the shard,
  padded to a fixed cap (``esc_cap_frac`` of the shard's ids).  The
  device decode takes each escape's rank by a cumulative sum over its
  shard's escape mask;
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
masked.  Unlike the JAX ``_pack_sparse`` (``wire.py:377``), ``pack``'s
``num_shards`` override reaches every field, the escape stream and its
placeholder included.

Unlike the JAX wire, whose decode reads the table the wire holds when it
runs (``wire.py:312``), each hot8 window carries the (F, 255) table it
was encoded with (``PackedBatch.hot_table``) and the decode reads that
one: a window packed before a relearn, still queued in a prefetcher or
packed for an eval, decodes to its own ids.  Learning the table and
encoding with it hold one lock, so two threads may pack through one wire.

Example:
    wire = WireFormat(26, 100_000, dense_mode="u8")
    packed = wire.pack_window(batches)              # host numpy
    on_card = PackedBatch(*[t.to("cuda") for t in to_tensors(packed)])
    dense, ids, labels, groups, cvr, domain = wire.decode(on_card)
    step0_ids = ids[0]                              # the window's step 0
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.training.data import Batch

# rows of ids that pack_ids packs at a time: one B = 8,192 batch, whose
# 26 fields (852 KB as int32) stay in cache through the field loop
PACK_BLOCK_ROWS = 8192
# the hot8 table's placeholder in the packed id mode
NO_HOT_TABLE = np.zeros((0, 255), np.int32)
_FLAT_IDS = ("hot8 escape stream overflowed its cap even with a table "
             "learned from the current window — the id distribution is too "
             "flat for hot8; raise esc_cap_frac or use id_mode='packed'")


class PackedBatch(NamedTuple):
    """A packed batch (numpy on the host, tensors on the device); leading
    axes preserved.  ``dense_scale`` is (..., num_shards, 2, num_dense)
    f32 (offset, step) under u8 and zeros under f16.  Under the ``packed``
    id mode ``esc`` is a (..., num_shards, 1) placeholder and
    ``hot_table`` the empty :data:`NO_HOT_TABLE`; under ``hot8``
    ``id_words`` holds (..., B, F) uint8 codes, ``esc`` the escaped ids
    (..., num_shards, cap * 3) and ``hot_table`` the (F, 255) int32 table
    the whole window was encoded with."""
    dense: np.ndarray       # (..., B, num_dense) float16 | uint8
    dense_scale: np.ndarray  # (..., shards, 2, num_dense) f32 affine
    id_words: np.ndarray    # (..., B, W) uint32 bit-packed | (..., B, F) u8
    group_ids: np.ndarray   # (..., B) uint16 in-batch remapped groups
    flags: np.ndarray       # (..., B) uint8: label | cvr<<1 | domain<<2
    esc: np.ndarray = np.zeros((), np.uint8)  # (..., shards, 1 | cap*3) u8
    hot_table: np.ndarray = NO_HOT_TABLE      # (F, 255) int32 | (0, 255)


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


# csrc/wire.cu's wire_encode_hot: a shard's escapes past the cap; an id
# outside [0, rows_per_field)
_ESC_OVERFLOW, _ID_RANGE = 3, 4


def _native() -> ctypes.CDLL:
    """The C++ pack (``csrc/wire.cu``), built at first use."""
    lib = _build.load("wire")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wire_pack_ids.argtypes = [ptr, i32, i64, i32, i32, ptr]
        lib.wire_pack_dense_u8.argtypes = [ptr, i64, i64, i32, i32, ptr, ptr]
        lib.wire_remap_groups.argtypes = [ptr, i32, i64, i64, ptr]
        lib.wire_pack_flags.argtypes = [ptr, ptr, ptr, i32, i64, ptr]
        lib.wire_encode_hot.argtypes = [ptr, i32, i64, i64, i32, i32, i64,
                                        ptr, i64, ptr, ptr]
        for fn in (lib.wire_pack_ids, lib.wire_pack_dense_u8,
                   lib.wire_remap_groups, lib.wire_pack_flags,
                   lib.wire_encode_hot):
            fn.restype = i32
        lib._typed = True
    return lib


def _of(name: str, a: np.ndarray, *dtypes) -> np.ndarray:
    """``a`` contiguous; raise unless its dtype is one of ``dtypes``."""
    if a.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))} "
                        f"for the native pack, got {a.dtype}")
    return np.ascontiguousarray(a)


def to_tensors(packed) -> PackedBatch:
    """A host PackedBatch (the port's, or the JAX wire's, which has no
    ``hot_table``) as CPU tensors, the uint32 words and uint16 groups
    reinterpreted as int32 and int16 (no copy); hot8 codes stay uint8."""
    words = np.ascontiguousarray(packed.id_words)
    if words.dtype == np.uint32:
        words = words.view(np.int32)
    return PackedBatch(
        torch.from_numpy(np.ascontiguousarray(packed.dense)),
        torch.from_numpy(np.ascontiguousarray(packed.dense_scale)),
        torch.from_numpy(words),
        torch.from_numpy(np.ascontiguousarray(packed.group_ids).view(
            np.int16)),
        torch.from_numpy(np.ascontiguousarray(packed.flags)),
        torch.from_numpy(np.ascontiguousarray(packed.esc)),
        torch.from_numpy(np.ascontiguousarray(
            getattr(packed, "hot_table", NO_HOT_TABLE))))


class WireFormat:
    """Pack/decode pair bound to a feature layout.

    Args:
        num_sparse: sparse fields per example.
        rows_per_field: id space per field (sets bits/id).
        dense_mode: 'f16' or 'u8' (per-batch-shard per-feature affine).
        num_shards: batch shards the u8 affine and the hot8 escape
            streams are computed over.
        id_mode: 'packed' (bit-packed words) or 'hot8' (byte codes of
            each field's 255 hottest ids and an escape stream; needs
            ``rows_per_field`` < 2^24 for the 3-byte escapes).
        esc_cap_frac: hot8 escape capacity as a fraction of each shard's
            ids per step.
    """

    def __init__(self, num_sparse: int, rows_per_field: int,
                 dense_mode: str = "f16", num_shards: int = 1,
                 id_mode: str = "packed", esc_cap_frac: float = 0.25):
        if dense_mode not in ("f16", "u8"):
            raise ValueError(f"unknown dense_mode {dense_mode!r}")
        if id_mode not in ("packed", "hot8"):
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
        if id_mode == "hot8" and self.bits > 24:
            raise ValueError("hot8 escapes are 3-byte: needs "
                             f"rows_per_field < 2^24, got bits={self.bits}")
        self.esc_cap_frac = esc_cap_frac
        # hot8: the (F, 255) hot ids and the (F, rows) inverse code map,
        # learned from the first window; a relearn makes new arrays (a
        # packed window keeps the table it was encoded with) and bumps
        # hot_version.  _hot_lock holds learning and encoding together.
        self.hot_table: Optional[np.ndarray] = None
        self._hot_inv: Optional[np.ndarray] = None
        self.hot_version = 0
        self._hot_lock = threading.Lock()

    # -- hot8 codec ---------------------------------------------------------
    def _esc_cap(self, b: int, shards: int) -> int:
        per_shard = b // shards * self.num_sparse
        return max(8, int(math.ceil(per_shard * self.esc_cap_frac)))

    def _build_hot_table(self, ids: np.ndarray) -> None:
        """Learn the per-field top-255 ids from a window of (..., F) ids
        (ties in the order of ``np.argpartition``, as JAX's)."""
        flat = ids.reshape(-1, self.num_sparse)
        table = np.zeros((self.num_sparse, 255), np.int32)
        inv = np.full((self.num_sparse, self.rows_per_field), 255, np.uint8)
        for f in range(self.num_sparse):
            counts = np.bincount(flat[:, f], minlength=self.rows_per_field)
            k = min(255, int((counts > 0).sum()))
            if k:
                top = np.argpartition(counts, -k)[-k:]
                top = top[np.argsort(-counts[top], kind="stable")]
                table[f, :k] = top
                inv[f, top] = np.arange(k, dtype=np.uint8)
        self.hot_table, self._hot_inv = table, inv
        self.hot_version += 1

    def _encode_hot_once(self, ids: np.ndarray, shards: int):
        """(codes, esc) of (..., B, F) ids under the current table, or
        None when a shard's escapes overflow the cap (numpy)."""
        codes = self._hot_inv[
            np.arange(self.num_sparse)[None, :],
            ids.reshape(-1, self.num_sparse)].reshape(ids.shape)
        b = ids.shape[-2]
        cap = self._esc_cap(b, shards)
        ids4 = ids.reshape((-1, shards, b // shards, self.num_sparse))
        codes4 = codes.reshape(ids4.shape)
        esc = np.zeros((ids4.shape[0], shards, cap, 3), np.uint8)
        for s in range(ids4.shape[0]):
            for sh in range(shards):
                vals = ids4[s, sh][codes4[s, sh] == 255]
                if len(vals) > cap:
                    return None
                v = vals.astype(np.uint32)
                esc[s, sh, :len(v), 0] = v & 0xFF
                esc[s, sh, :len(v), 1] = (v >> 8) & 0xFF
                esc[s, sh, :len(v), 2] = (v >> 16) & 0xFF
        return (codes.astype(np.uint8),
                esc.reshape(ids.shape[:-2] + (shards, cap * 3)))

    def _encode_hot(self, ids: np.ndarray, shards: int, encode=None):
        """(..., B, F) ids -> ((..., B, F) u8 codes, (..., shards, cap*3)
        u8 escapes, the (F, 255) table used).  The table is learned from
        the first window; a window that overflows the cap relearns it
        from itself once, then raises.  ``encode(ids, shards)`` gives
        (codes, esc) or None on overflow (default: numpy)."""
        if ids.shape[-2] % shards:
            raise ValueError(
                f"batch {ids.shape[-2]} must divide by num_shards {shards}")
        encode = encode or self._encode_hot_once
        with self._hot_lock:
            for attempt in (0, 1):
                if self.hot_table is None:
                    self._build_hot_table(ids)
                out = encode(ids, shards)
                if out is not None:
                    return out + (self.hot_table,)
                if attempt == 0:
                    # the distribution drifted: relearn from this window
                    self._build_hot_table(ids)
        raise ValueError(_FLAT_IDS)

    def _decode_hot(self, codes: torch.Tensor, esc: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
        """Device-side hot8 decode -> (..., B, F) int64 ids: a code < 255
        reads the window's table; the k-th escape of a shard, counted in
        its (B / shards, F) row-major order, reads the shard's k-th
        triple (JAX's order, ``wire.py:305-324``)."""
        f = self.num_sparse
        if tuple(table.shape) != (f, 255):
            raise ValueError(f"a hot8 window carries its (F={f}, 255) "
                             f"table; got {tuple(table.shape)}")
        n = esc.shape[-2]
        lead, b = codes.shape[:-2], codes.shape[-2]
        c = codes.to(torch.int64)
        hot = table.to(torch.int64)[torch.arange(f, device=c.device),
                                    c.clamp(max=254)]
        is_esc = c == 255
        rank = torch.cumsum(is_esc.reshape(lead + (n, b // n * f)), -1) - 1
        e3 = esc.reshape(lead + (n, -1, 3)).to(torch.int64)
        vals = e3[..., 0] | (e3[..., 1] << 8) | (e3[..., 2] << 16)
        sel = torch.gather(vals, -1, rank.clamp(0, vals.shape[-1] - 1))
        return torch.where(is_esc, sel.reshape(codes.shape), hot)

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
        """(..., B, F) ids -> (id_words, esc, hot_table) per ``id_mode``."""
        if self.id_mode == "hot8":
            return self._encode_hot(ids, shards)
        lead = ids.shape[:-2]
        return (pack_ids(ids, self.bits),
                np.zeros(lead + (shards, 1), np.uint8), NO_HOT_TABLE)

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
        idw, esc, table = self._pack_sparse(np.asarray(batch.sparse_ids),
                                            shards)
        return PackedBatch(
            dense=d, dense_scale=scale, id_words=idw,
            group_ids=remap_groups(batch.group_ids),
            flags=_pack_flags(batch.labels, batch.cvr_labels,
                              batch.domain_idx),
            esc=esc, hot_table=table)

    def pack_window(self, batches: Sequence[Batch],
                    num_shards: Optional[int] = None,
                    raw_groups: bool = False) -> PackedBatch:
        """Stack and compress a window of identically-shaped batches;
        ``raw_groups`` ships group ids unremapped (:func:`raw_groups_u16`)."""
        shards = self.num_shards if num_shards is None else num_shards
        group_fn = raw_groups_u16 if raw_groups else remap_groups
        d, scale = self._pack_dense(np.stack([b.dense for b in batches]),
                                    shards)
        if self.id_mode == "hot8":
            idw, esc, table = self._encode_hot(
                np.stack([b.sparse_ids for b in batches]), shards)
        else:
            # each batch's ids packed alone: no stacked copy of the raw ids
            idw = np.stack([pack_ids(np.asarray(b.sparse_ids), self.bits)
                            for b in batches])
            esc = np.zeros((len(batches), shards, 1), np.uint8)
            table = NO_HOT_TABLE
        return PackedBatch(
            dense=d, dense_scale=scale, id_words=idw,
            group_ids=group_fn(np.stack([b.group_ids for b in batches])),
            flags=_pack_flags(
                np.stack([b.labels for b in batches]),
                np.stack([b.cvr_labels for b in batches]),
                np.stack([b.domain_idx for b in batches])),
            esc=esc, hot_table=table)

    def pack_window_native(self, batches: Sequence[Batch],
                           raw_groups: bool = False) -> PackedBatch:
        """:meth:`pack_window`'s bytes (at ``num_shards``) from the C++
        pack in ``csrc/wire.cu``, built at first use with the CUDA sources
        (it needs nvcc).  The ids, the u8 dense, the group ranks and the
        flags are one call each that releases the interpreter lock, so a
        prefetch thread packing the next window holds up the thread that
        dispatches the steps for little more than the stacking.  Under
        hot8 the C++ call encodes with the current table and reports an
        escape overflow; learning and relearning the table stay in numpy
        (:meth:`_encode_hot`), as in :meth:`pack_window`.  Takes
        :class:`Batch`'s dtypes: dense, labels and cvr float32; ids,
        groups and domains int32 or int64 (hot8: ids in [0,
        rows_per_field), else ValueError)."""
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

        if b % shards:
            raise ValueError(f"batch {b} must divide by num_shards {shards}")
        if self.id_mode == "hot8":
            def encode(ids, shards):
                cap = self._esc_cap(b, shards)
                codes = np.empty((s, b, f), np.uint8)
                esc = np.empty((s, shards, cap * 3), np.uint8)
                rc = lib.wire_encode_hot(
                    ids.ctypes.data, int(ids.dtype == i64), s, b, f, shards,
                    cap, self._hot_inv.ctypes.data, self.rows_per_field,
                    codes.ctypes.data, esc.ctypes.data)
                if rc == _ESC_OVERFLOW:
                    return None
                if rc == _ID_RANGE:
                    raise ValueError("hot8 ids must lie in [0, "
                                     f"{self.rows_per_field})")
                if rc != 0:
                    raise RuntimeError(
                        f"wire pack: {lib.error_string(rc).decode()}")
                return codes, esc

            words, esc, table = self._encode_hot(ids, shards, encode)
        else:
            words = np.empty((s, b, num_words(f, self.bits)), np.uint32)
            call(lib.wire_pack_ids, ids, int(ids.dtype == i64), s * b, f,
                 self.bits, words)
            esc = np.zeros((s, shards, 1), np.uint8)
            table = NO_HOT_TABLE
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
                           group_ids=g, flags=flags, esc=esc, hot_table=table)

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
        labels f32, groups int32, cvr f32, domain int32); hot8 windows
        decode with the table they carry."""
        dense = self.decode_dense(packed.dense, packed.dense_scale)
        if self.id_mode == "hot8":
            ids = self._decode_hot(packed.id_words, packed.esc,
                                   packed.hot_table)
        else:
            ids = unpack_ids(packed.id_words, self.num_sparse, self.bits)
        flags = packed.flags.to(torch.int32)
        labels = (flags & 1).to(torch.float32)
        cvr = ((flags >> 1) & 1).to(torch.float32)
        domain = flags >> 2
        groups = packed.group_ids.to(torch.int32) & 0xFFFF
        return dense, ids, labels, groups, cvr, domain

    @staticmethod
    def wire_cost(num_dense: int, num_sparse: int, rows_per_field: int,
                  dense_mode: str = "f16", id_mode: str = "packed",
                  esc_cap_frac: float = 0.25) -> Tuple[int, int]:
        """(packed, raw) bytes per example (the scale metadata and the
        hot8 table amortize to ~0 over a window and are excluded; hot8
        counts the escape stream at its cap)."""
        bits = id_bits(rows_per_field)
        per_dense = 2 if dense_mode == "f16" else 1
        if id_mode == "hot8":
            id_bytes = num_sparse + math.ceil(num_sparse * esc_cap_frac * 3)
        else:
            id_bytes = num_words(num_sparse, bits) * 4
        packed = (num_dense * per_dense
                  + id_bytes
                  + 2     # group ids u16 (in-batch remap)
                  + 1)    # flags byte: label | cvr | domain
        raw = num_dense * 4 + num_sparse * 4 + 4 + 4 + 4 + 4
        return packed, raw
