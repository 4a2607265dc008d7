"""Criteo-TSV streaming dataset on the native parser.

Counterpart of ``rec_now_tpu/io/criteo.py``.  It turns Criteo
Kaggle/Terabyte format files

    label \\t I1..I13 \\t C1..C26 \\n     (fields may be empty)

into the port's :class:`rec_now_tpu_torch.training.data.Batch`:
``dense`` = ``log1p`` of positive ints, ``sparse_ids`` = FNV-1a hashed
categorical tokens mod ``rows_per_field`` (raw per-field ids: the
trainer offsets them into the table's id space), ``group_ids`` = the
hash of a chosen categorical column (default C0, a user-like key) mod
``num_groups``, for the in-batch pairwise and listwise losses.

Parsing runs in the multi-threaded C++ parser
(``io/native/criteo_parser.cpp``, built by ``io/build.py`` at first use;
a failed build raises).  The pure-Python parser is its plain version,
with the same results, and runs only with ``force_python=True``.  A file
is read in large chunks; a trailing partial line is carried into the
next chunk, so a file of any size streams in O(chunk) memory.

Example:
    ds = CriteoTSV("train.tsv", rows_per_field=100_000)
    for batch in ds.batches(8192, num_batches=100):
        state, metrics = trainer.train_step(state, *trainer.put(batch))
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from rec_now_tpu_torch.io import build as _build
from rec_now_tpu_torch.training.data import Batch, SyntheticCriteo

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def fnv1a_mod(token: bytes, mod: int) -> int:
    """FNV-1a 64-bit of ``token`` mod ``mod`` (Python reference)."""
    h = _FNV_OFFSET
    for b in token:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h % mod


def fnv1a_mod_many(tokens, mod: int) -> np.ndarray:
    """:func:`fnv1a_mod` of each of a sequence of str tokens (ASCII),
    vectorized over the tokens: one pass a byte position, uint64 wrapping
    as the 64-bit hash does."""
    raw = np.array([t.encode() for t in tokens], dtype=bytes)
    width = raw.dtype.itemsize
    n = raw.shape[0]
    lens = np.char.str_len(raw)
    mat = raw.view(np.uint8).reshape(n, width).astype(np.uint64)
    h = np.full(n, _FNV_OFFSET, np.uint64)
    prime = np.uint64(_FNV_PRIME)
    for j in range(width):
        step = (h ^ mat[:, j]) * prime
        h = np.where(j < lens, step, h)
    return (h % np.uint64(mod)).astype(np.int64)


def _parse_chunk_py(buf: bytes, num_dense: int, num_sparse: int,
                    rows_per_field: int, group_field: int,
                    num_groups: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, int]:
    """The plain version: one line at a time, the C++ parser's results."""
    lines = buf.split(b"\n")
    lines = lines[:-1]  # last element is the partial tail (or empty)
    n = len(lines)
    dense = np.zeros((n, num_dense), np.float32)
    ids = np.zeros((n, num_sparse), np.int32)
    labels = np.zeros(n, np.float32)
    groups = np.zeros(n, np.int32)
    for r, line in enumerate(lines):
        parts = line.split(b"\t")
        try:
            labels[r] = 1.0 if int(parts[0]) else 0.0
        except (ValueError, IndexError):
            labels[r] = 0.0
        for d in range(num_dense):
            tok = parts[1 + d] if 1 + d < len(parts) else b""
            try:
                v = int(tok)
            except ValueError:
                continue
            if v > 0:
                dense[r, d] = np.log1p(np.float32(v))
        for c in range(num_sparse):
            tok = (parts[1 + num_dense + c]
                   if 1 + num_dense + c < len(parts) else b"")
            if tok:
                ids[r, c] = fnv1a_mod(tok, rows_per_field)
                if c == group_field:
                    groups[r] = fnv1a_mod(tok, num_groups)
    return dense, ids, labels, groups, n


def parse_chunk(buf: bytes, num_dense: int = 13, num_sparse: int = 26,
                rows_per_field: int = 100_000, group_field: int = 0,
                num_groups: int = 50_000,
                num_threads: Optional[int] = None,
                force_python: bool = False
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                           np.ndarray, int]:
    """Parse every complete line of ``buf``.

    Returns (dense, ids, labels, group_ids, rows); arrays are sized to
    the rows actually parsed.  Bytes after the final newline are NOT
    consumed: the caller carries them into the next chunk.  The native
    parser runs on ``num_threads`` threads (default: the host's cores, at
    most 16); ``force_python`` runs the plain version instead.
    """
    if force_python:
        return _parse_chunk_py(buf, num_dense, num_sparse,
                               rows_per_field, group_field, num_groups)
    lib = _build.load()
    max_rows = buf.count(b"\n")
    dense = np.zeros((max_rows, num_dense), np.float32)
    ids = np.zeros((max_rows, num_sparse), np.int32)
    labels = np.zeros(max_rows, np.float32)
    groups = np.zeros(max_rows, np.int32)
    if max_rows == 0:
        return dense, ids, labels, groups, 0
    if num_threads is None:
        num_threads = min(os.cpu_count() or 1, 16)
    n = lib.rn_parse_criteo(
        buf, len(buf), num_dense, num_sparse, rows_per_field,
        group_field, num_groups, num_threads, max_rows,
        dense.ctypes.data_as(ctypes.c_void_p),
        ids.ctypes.data_as(ctypes.c_void_p),
        labels.ctypes.data_as(ctypes.c_void_p),
        groups.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        raise ValueError(f"native parser error {n}")
    return dense[:n], ids[:n], labels[:n], groups[:n], int(n)


class CriteoTSV:
    """Streaming batches from a Criteo-format TSV file.

    Yields :class:`Batch` namedtuples for ``Trainer.put`` /
    ``put_packed_window``.  ``cvr_labels`` and ``domain_idx`` are zeros
    (the Criteo format has neither).
    """

    def __init__(self, path: str, num_dense: int = 13,
                 num_sparse: int = 26, rows_per_field: int = 100_000,
                 group_field: int = 0, num_groups: int = 50_000,
                 chunk_bytes: int = 8 << 20,
                 num_threads: Optional[int] = None,
                 force_python: bool = False):
        self.path = path
        self.num_dense = num_dense
        self.num_sparse = num_sparse
        self.rows_per_field = rows_per_field
        self.group_field = group_field
        self.num_groups = num_groups
        self.chunk_bytes = chunk_bytes
        self.num_threads = num_threads
        self.force_python = force_python

    def _parse(self, buf: bytes):
        return parse_chunk(buf, self.num_dense, self.num_sparse,
                           self.rows_per_field, self.group_field,
                           self.num_groups, self.num_threads,
                           self.force_python)

    def _rows(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                      np.ndarray, np.ndarray]]:
        """Yield parsed (dense, ids, labels, groups) array blocks."""
        carry = b""
        with open(self.path, "rb") as f:
            while True:
                chunk = f.read(self.chunk_bytes)
                if not chunk:
                    break
                buf = carry + chunk
                nl = buf.rfind(b"\n")
                if nl < 0:
                    carry = buf
                    continue
                carry = buf[nl + 1:]
                d, i, l, g, n = self._parse(buf[:nl + 1])
                if n:
                    yield d, i, l, g
        if carry.strip():
            d, i, l, g, n = self._parse(carry + b"\n")
            if n:
                yield d, i, l, g

    def batches(self, batch_size: int,
                num_batches: Optional[int] = None,
                drop_remainder: bool = True,
                skip: int = 0) -> Iterator[Batch]:
        """Yield fixed-size batches.

        The final partial batch is dropped by default; pass
        ``drop_remainder=False`` to get it zero-padded instead.  ``skip``
        drops that many leading batches first: the train / eval holdout
        split when one file serves both (train reads batches [0, steps),
        eval reads with ``skip=steps``).
        """
        pend: list = []
        have = 0
        emitted = 0
        skipped = 0
        for block in self._rows():
            pend.append(block)
            have += block[0].shape[0]
            while have >= batch_size:
                d, i, l, g = (np.concatenate([b[k] for b in pend])
                              for k in range(4))
                pend = [(d[batch_size:], i[batch_size:],
                         l[batch_size:], g[batch_size:])]
                have -= batch_size
                if skipped < skip:
                    skipped += 1
                    continue
                if num_batches is not None and emitted >= num_batches:
                    return
                yield self._make_batch(d[:batch_size], i[:batch_size],
                                       l[:batch_size], g[:batch_size])
                emitted += 1
        if (not drop_remainder and have and skipped >= skip
                and (num_batches is None or emitted < num_batches)):
            d, i, l, g = (np.concatenate([b[k] for b in pend])[:have]
                          for k in range(4))
            pad = batch_size - have
            yield self._make_batch(
                np.pad(d, ((0, pad), (0, 0))),
                np.pad(i, ((0, pad), (0, 0))),
                np.pad(l, (0, pad)), np.pad(g, (0, pad)))

    def _make_batch(self, dense, ids, labels, groups) -> Batch:
        b = dense.shape[0]
        return Batch(dense=dense, sparse_ids=ids, labels=labels,
                     group_ids=groups,
                     cvr_labels=np.zeros(b, np.float32),
                     domain_idx=np.zeros(b, np.int32))


def write_synthetic_tsv(path: str, num_rows: int, num_dense: int = 13,
                        num_sparse: int = 26,
                        rows_per_field: int = 100_000,
                        num_users: int = 5_000, seed: int = 0,
                        missing_rate: float = 0.05,
                        sample_seed: Optional[int] = None) -> None:
    """Write a Criteo-format TSV whose labels follow the planted model.

    The bytes of ``rec_now_tpu``'s ``write_synthetic_tsv`` with the same
    arguments.  Tokens are hex strings; the label is drawn from
    :class:`SyntheticCriteo`'s planted logit evaluated at the tokens'
    *hashed* ids, so AUC learned from the file through the parser is
    comparable with the synthetic stream.  C0 carries the user id (the
    pairwise group key).  ``sample_seed`` (default ``seed + 1``) seeds
    only the row sampler, so shards generated in parallel can share one
    planted model (same ``seed``) while drawing disjoint samples.  The
    hashes and the lines are built a column at a time (the reference
    hashes and joins token by token, in Python).
    """
    syn = SyntheticCriteo(num_dense=num_dense, num_sparse=num_sparse,
                          rows_per_field=rows_per_field,
                          num_users=num_users, seed=seed)
    rng = np.random.RandomState(
        seed + 1 if sample_seed is None else sample_seed)
    with open(path, "w") as f:
        # vector-generate in blocks to keep memory flat
        block = 65536
        for start in range(0, num_rows, block):
            b = min(block, num_rows - start)
            raw = rng.zipf(syn.zipf_a, size=(b, num_sparse)).astype(
                np.int64)
            users = (rng.zipf(syn.zipf_a, size=b)
                     % num_users).astype(np.int64)
            dense_i = rng.poisson(3.0, size=(b, num_dense)).astype(
                np.int64)
            miss_d = rng.rand(b, num_dense) < missing_rate
            miss_c = rng.rand(b, num_sparse) < missing_rate
            miss_c[:, 0] = False  # group key always present
            cols = []
            hashed = np.zeros((b, num_sparse), np.int64)
            for c in range(num_sparse):
                if c == 0:
                    col = [f"u{u:07x}" for u in users.tolist()]
                else:
                    col = [f"{c:02d}{v:08x}" for v in raw[:, c].tolist()]
                cols.append(col)
                hashed[:, c] = fnv1a_mod_many(col, rows_per_field)
            hashed[miss_c] = 0
            # planted logit at the hashed ids (mirrors
            # SyntheticCriteo.sample)
            lat = syn.latent[np.arange(num_sparse)[None, :], hashed]
            first = (lat.sum(-1) * syn.field_w[None, :]).sum(-1)
            summed = lat.sum(1)
            inter = 0.5 * ((summed ** 2).sum(-1)
                           - (lat ** 2).sum(-1).sum(-1))
            dlog = np.where(dense_i > 0, np.log1p(dense_i), 0.0
                            ).astype(np.float32)
            dlog = np.where(miss_d, 0.0, dlog)
            logit = (dlog @ syn.dense_w + first + 0.3 * inter
                     + syn.user_bias[users % num_users])
            logit = (logit - logit.mean()) / (logit.std() + 1e-6)
            p = 1.0 / (1.0 + np.exp(-1.5 * logit + 1.0))
            labels = (rng.rand(b) < p).astype(np.int32)
            fields = [[str(v) for v in labels.tolist()]]
            for d in range(num_dense):
                fields.append(["" if m else str(v) for v, m in zip(
                    dense_i[:, d].tolist(), miss_d[:, d].tolist())])
            for c in range(num_sparse):
                fields.append(["" if m else t for t, m in zip(
                    cols[c], miss_c[:, c].tolist())])
            f.write("".join("\t".join(row) + "\n" for row in zip(*fields)))
