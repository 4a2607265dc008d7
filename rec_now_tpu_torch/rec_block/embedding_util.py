"""Slot / segment embedding utilities: features in a parameter-server
style ragged format, pooled or padded for the dense towers.

Counterpart of ``rec_now_tpu/rec_block/embedding_util.py``, with its
names.  Features arrive as aligned (B, C) tensors ``(slots, ids,
weights)``: each row holds up to C (slot, id, weight) triples.  An
``embedding_func`` maps an int id vector to (N, D) rows:
``EmbeddingTable.embedding_func(state)`` gives one that looks them up
(kernel B11, one launch a call).

The computation is JAX's, in plain PyTorch (JAX's is XLA, no Pallas):

* slot -> target index: a sorted table of the (static) target slots and
  ``torch.searchsorted``, in place of JAX's T compares; with a slot
  listed twice the last index wins, as in JAX;
* pooling: a segment sum with a *drop bucket* -- invalid positions get
  segment id ``num_segments`` and are dropped (spread over
  ``DROP_ROWS`` rows past the segments, which are cut off: on the card
  every atomic add into one row waits for the one before, and ~700,000
  dropped places of a B = 8,192 batch in one row took over a
  millisecond);
* per-slot padding (ragged -> (B, ncols, ...)): the position of each hit
  in its row is its masked cumsum, and the hits land there; those past
  ``ncols`` are cut off, as ``RaggedTensor.to_tensor(shape=(B, ncols))``
  does.

Every segment sum and scatter is ``Tensor.index_add`` or
``scatter_reduce`` out of place, so autograd carries the gradients to
the looked-up rows and the weights.  (B12, ``scatter_add_rows``, writes
in place through a raw pointer and has no backward: it would drop them.)

One difference from JAX: :func:`fetch_single_slot` keeps ids in their own
dtype, where JAX sends them through float32 and back
(``embedding_util.py:418-421``), which rounds an id past 2^24 (16,777,217
comes back as 16,777,216).  Below 2^24 the two agree.

Symbols: B batch, C columns per row, T target slots, D embedding dim.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------
# membership / dedup helpers
# --------------------------------------------------------------------------

def _target_index(values: torch.Tensor, target_values: Sequence
                  ) -> torch.Tensor:
    """The index in ``target_values`` of each of ``values`` (its last, for
    a value listed twice; int64), -1 where it is none of them.  On integer
    values a target that is not an integer in the dtype's range matches
    nothing, as JAX's compare after promotion finds no equal."""
    last = {}
    for i, t in enumerate(target_values):
        if values.is_floating_point():
            t = torch.tensor(t, dtype=values.dtype).item()
        else:
            info = torch.iinfo(values.dtype)
            if not (float(t).is_integer() and info.min <= t <= info.max):
                continue
            t = int(t)
        if t == t:                        # NaN matches nothing
            last[t] = i
    if not last:
        return torch.full(values.shape, -1, dtype=torch.int64,
                          device=values.device)
    keys = sorted(last)
    table = torch.tensor(keys, dtype=values.dtype, device=values.device)
    index = torch.tensor([last[k] for k in keys], device=values.device)
    pos = torch.searchsorted(table, values.contiguous()).clamp_max(
        len(keys) - 1)
    return torch.where(table[pos] == values, index[pos], -1)


def isin(values: torch.Tensor, target_values: Sequence) -> torch.Tensor:
    """Like ``np.isin``: True where ``values`` is one of the static
    ``target_values`` (``embedding_util.py:46-61``).

    Example:
        isin([[0, 1, 2]], [1, 2]) -> [[False, True, True]]
    """
    targets = np.asarray(target_values).reshape(-1).tolist()
    return _target_index(values, targets) >= 0


def mask_values(values: torch.Tensor, target_values: Sequence,
                padding_value=0) -> torch.Tensor:
    """Keep values in ``target_values``; replace the others with
    ``padding_value`` (``embedding_util.py:64-72``)."""
    return torch.where(isin(values, target_values), values,
                       torch.tensor(padding_value, dtype=values.dtype,
                                    device=values.device))


def first_occurance_in_row(mat: torch.Tensor, need_sort: bool = False,
                           padding_value=0) -> torch.Tensor:
    """Keep only the first of each run of equal adjacent values in a row
    (``embedding_util.py:75-94``).

    Example:
        first_occurance_in_row([[0, 1, 1, 2]], padding_value=-1)
            -> [[0, 1, -1, 2]]
    """
    if mat.dim() != 2:
        raise ValueError(f"mat must be 2D tensor, get {mat.dim()}D tensor")
    if need_sort:
        mat = torch.sort(mat, dim=-1).values
    keep = mat[:, :-1] != mat[:, 1:]
    right = torch.where(keep, mat[:, 1:],
                        torch.tensor(padding_value, dtype=mat.dtype,
                                     device=mat.device))
    return torch.cat([mat[:, 0:1], right], dim=-1)


# --------------------------------------------------------------------------
# slot -> segment-id mapping
# --------------------------------------------------------------------------

def batch_segment_ids_of_targets(slots: torch.Tensor,
                                 target_slots: Sequence
                                 ) -> Tuple[torch.Tensor, int, int, int]:
    """Per-element batch segment ids of the target slots, -1 for the
    others (``embedding_util.py:101-136``): a hit of target ``t`` in row
    ``b`` gets ``b * T + t``.

    Example:
        slots = [[0, 1, 1, 2, 3, 3], [1, 3, 3, 2, 5, 5]],
        target_slots = [1, 3, 5] ->
            [[-1, 0, 0, -1, 1, 1], [3, 4, 4, -1, 5, 5]]

    Returns:
        (batch_segment_ids (B, C) int64, num_rows, num_ids, num_segments).
    """
    target_slots = list(target_slots)
    segment_ids = _target_index(slots, target_slots)
    num_rows, num_ids = slots.shape[0], len(target_slots)
    row_shift = num_ids * torch.arange(num_rows, device=slots.device)[:, None]
    seg = torch.where(segment_ids >= 0, segment_ids + row_shift, -1)
    return seg, num_rows, num_ids, num_rows * num_ids


def sparse_batch_segment_ids_of_targets(slots: torch.Tensor,
                                        target_slots: Sequence):
    """Mask and flat segment ids of the target slots
    (``embedding_util.py:139-158``): the invalid places go to the drop
    bucket ``num_segments``, which the segment sums drop.

    Returns:
        (mask (B, C) bool, flat_segment_ids (B*C,) with the drop bucket,
         num_rows, num_ids, num_segments).
    """
    batch_ids, num_rows, num_ids, num_segments = \
        batch_segment_ids_of_targets(slots, target_slots)
    mask = batch_ids >= 0
    flat = torch.where(mask, batch_ids, num_segments).reshape(-1)
    return mask, flat, num_rows, num_ids, num_segments


# the rows past the segments that dropped places are spread over
DROP_ROWS = 4096


def _spread_drops(segment_ids: torch.Tensor, num_segments: int
                  ) -> torch.Tensor:
    """Segment ids with each id of ``num_segments`` or more replaced by
    ``num_segments`` plus its place modulo ``DROP_ROWS``."""
    place = torch.arange(segment_ids.numel(), device=segment_ids.device)
    return torch.where(segment_ids < num_segments, segment_ids,
                       num_segments + place % DROP_ROWS)


def _segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` out of place: (N, ...) -> (num_segments,
    ...); ids of ``num_segments`` or more (the drop bucket) are
    dropped."""
    out = values.new_zeros((num_segments + DROP_ROWS,)
                           + tuple(values.shape[1:]))
    return out.index_add(0, _spread_drops(segment_ids, num_segments),
                         values)[:num_segments]


# --------------------------------------------------------------------------
# pooled embedding of target slots
# --------------------------------------------------------------------------

def embedding_using_batch_segment_ids(
        embedding_func: Callable[[torch.Tensor], torch.Tensor],
        slots: torch.Tensor,
        target_slots: Sequence,
        ids: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        method: str = "sum") -> torch.Tensor:
    """Embed ids and pool each (row, target slot) -> (B, T, D)
    (``embedding_util.py:165-211``): the ids of other slots set to 0,
    every id embedded by one ``embedding_func`` call, weighted, summed
    into B * T + 1 segments (the last, the drop bucket, cut off).

    Args:
        embedding_func: an int id vector -> (N, D) rows.
        slots: (B, C) slot of each id.
        target_slots: the static list of T slots to pool.
        ids: (B, C) ids.
        weights: optional (B, C) weight of each id.
        method: ``"sum"`` or ``"mean"`` (divides by the count of hits,
            not by the weights).

    Returns:
        (B, T, D) pooled rows; an empty (row, slot) group is zero.
    """
    mask, flat_seg, num_rows, num_ids, num_segments = \
        sparse_batch_segment_ids_of_targets(slots, target_slots)
    flat_mask = mask.reshape(-1)
    flat_ids = torch.where(flat_mask, ids.reshape(-1), 0)

    embeddings = embedding_func(flat_ids)                 # (B*C, D)
    embeddings = embeddings * flat_mask[:, None].to(embeddings.dtype)
    if weights is not None:
        embeddings = embeddings * weights.reshape(-1)[:, None]

    summed = _segment_sum(embeddings, flat_seg, num_segments)
    if method == "mean":
        counts = _segment_sum(flat_mask.to(embeddings.dtype), flat_seg,
                              num_segments)
        summed = summed / counts.clamp_min(1.0)[:, None]
    elif method != "sum":
        raise ValueError(f"not support {method!r}")
    return summed.reshape(num_rows, num_ids, -1)


# the reference's three names for this computation (JAX's aliases,
# embedding_util.py:216-217)
embedding_using_sparse_batch_segment_ids = embedding_using_batch_segment_ids
embedding_using_sparse_batch_segment_ids_v1 = embedding_using_batch_segment_ids


# --------------------------------------------------------------------------
# non-pooled (padded) single-slot extraction
# --------------------------------------------------------------------------

def _scatter_to_padded(values: torch.Tensor, mask: torch.Tensor,
                       ncols: int, default_value=0) -> torch.Tensor:
    """Row-wise hits of (B, C, ...) ``values`` where (B, C) ``mask`` is
    True -> (B, ncols, ...), each row's hits in order, those past
    ``ncols`` cut off, ``default_value`` in the places no hit reached
    (``embedding_util.py:224-256``).  Each place takes at most one hit,
    so the values keep their dtype exactly."""
    b, c = mask.shape
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1   # (B, C)
    valid = mask & (pos < ncols)
    rows = torch.arange(b, device=mask.device)[:, None]
    dest = torch.where(valid, rows * ncols + pos, b * ncols).reshape(-1)
    flat = values.reshape((b * c,) + tuple(values.shape[2:]))
    keep = valid.reshape((-1,) + (1,) * (flat.dim() - 1))
    flat = flat * keep.to(flat.dtype)
    out = _segment_sum(flat, dest, b * ncols)
    out = out.reshape((b, ncols) + tuple(values.shape[2:]))
    if default_value != 0:
        hit = _segment_sum(valid.reshape(-1).to(torch.int64), dest,
                           b * ncols)
        miss = (1 - hit).reshape((b, ncols) + (1,) * (values.dim() - 2))
        out = out + miss.to(out.dtype) * default_value
    return out


def embedding_single_slot(
        embedding_func: Callable[[torch.Tensor], torch.Tensor],
        slots: torch.Tensor,
        target_slot,
        ids: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        default_weight: float = 0.0,
        ncols: Optional[int] = None):
    """One slot's rows without pooling -> padded (B, ncols, D)
    (``embedding_util.py:259-301``).

    Args:
        embedding_func: an int id vector -> (N, D) rows.
        slots, ids, weights: (B, C) feature triples.
        target_slot: the slot to extract.
        default_weight: the weight of a padded place.
        ncols: the padded length (required: a row's hits past it are cut
            off).

    Returns:
        (embedding (B, ncols, D), weights (B, ncols, 1) or None,
         mask (B, ncols, 1) bool).
    """
    if ncols is None:
        raise ValueError("ncols must be set (static shape required)")
    mask = slots == target_slot                           # (B, C)
    flat_ids = torch.where(mask.reshape(-1), ids.reshape(-1), 0)
    emb = embedding_func(flat_ids)                        # (B*C, D)
    emb = emb.reshape(ids.shape[0], ids.shape[1], -1)     # (B, C, D)
    embedding_tensor = _scatter_to_padded(emb, mask, ncols)

    weights_tensor = None
    if weights is not None:
        weights_tensor = _scatter_to_padded(weights[..., None], mask, ncols,
                                            default_value=default_weight)
    hits = _scatter_to_padded(mask[..., None].to(torch.int64), mask, ncols)
    return embedding_tensor, weights_tensor, hits > 0


# --------------------------------------------------------------------------
# id / weight pooling without embedding
# --------------------------------------------------------------------------

def _pool(values: Optional[torch.Tensor], how: str, flat_seg: torch.Tensor,
          flat_mask: torch.Tensor, num_rows: int, num_ids: int,
          num_segments: int) -> Optional[torch.Tensor]:
    """``pool_slots``' reduction of (B, C) ``values`` over the segments:
    ``"min0"`` (the least, 0 for an empty group), ``"mean"`` or
    ``"sum"`` -> (B, T)."""
    if values is None:
        return None
    flat = values.reshape(-1)
    if how == "min0":
        big = (torch.iinfo(flat.dtype).max if not flat.is_floating_point()
               else math.inf)
        flat = torch.where(flat_mask, flat,
                           torch.tensor(big, dtype=flat.dtype,
                                        device=flat.device))
        result = torch.full((num_segments + DROP_ROWS,), big,
                            dtype=flat.dtype, device=flat.device)
        result = result.scatter_reduce(
            0, _spread_drops(flat_seg, num_segments), flat,
            "amin")[:num_segments]
        result = torch.where(result == big, torch.zeros_like(result),
                             result)
    elif how in ("mean", "sum"):
        result = _segment_sum(flat * flat_mask.to(flat.dtype), flat_seg,
                              num_segments)
        if how == "mean":
            counts = _segment_sum(flat_mask.to(flat.dtype), flat_seg,
                                  num_segments)
            result = result / counts.clamp_min(1)
    else:
        raise ValueError(f"not support '{how}'")
    return result.reshape(num_rows, num_ids)


def pool_slots(slots: torch.Tensor,
               target_slots: Sequence,
               ids: Optional[torch.Tensor] = None,
               weights: Optional[torch.Tensor] = None,
               method: str = "sum",
               drop_duplicate_slot: bool = False):
    """Pool each target slot's ids (the least, 0 if absent) and weights
    (``method``: ``"sum"`` or ``"mean"``) (``embedding_util.py:308-369``).
    ``drop_duplicate_slot`` drops only adjacent repeats of a slot in a
    row, as the reference does.  1-D slots are one row.

    Returns:
        (pooled_ids (B, T) or None, pooled_weights (B, T) or None).
    """
    if slots.dim() == 1:
        slots = slots.reshape(1, -1)
    if slots.dim() != 2:
        raise ValueError(
            f"only support 2 (or 1) dimentional slots, get {slots.dim()}")
    batch_ids, num_rows, num_ids, num_segments = \
        batch_segment_ids_of_targets(slots, target_slots)
    if drop_duplicate_slot:
        batch_ids = first_occurance_in_row(batch_ids, need_sort=False,
                                           padding_value=-1)
    flat_mask = (batch_ids >= 0).reshape(-1)
    flat_seg = torch.where(flat_mask, batch_ids.reshape(-1), num_segments)
    shape = (flat_seg, flat_mask, num_rows, num_ids, num_segments)
    return _pool(ids, "min0", *shape), _pool(weights, method, *shape)


def pool_single_slot(slots: torch.Tensor, target_slot,
                     ids: Optional[torch.Tensor] = None,
                     weights: Optional[torch.Tensor] = None):
    """Pool a slot that occurs exactly once a sample -> (B, 1) values: the
    sum of the row's values in that slot (``embedding_util.py:372-393``;
    deprecated there in favour of :func:`fetch_single_slot`)."""
    warnings.warn("pool_single_slot only work for slot that occur exactly "
                  "once a sample, use fetch_single_slot instead")
    mask = slots == target_slot

    def fetch(values):
        if values is None:
            return None
        return torch.sum(values * mask.to(values.dtype), dim=-1,
                         keepdim=True)
    return fetch(ids), fetch(weights)


def fetch_single_slot(slots: torch.Tensor, target_slot,
                      ids: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None,
                      default_id=0, default_weight: float = 0,
                      ncols: Optional[int] = None):
    """A slot's ids and weights, padded or cut to (B, ncols), the missing
    places ``default_id`` / ``default_weight``
    (``embedding_util.py:396-422``); ids stay exact in their own dtype.

    Example:
        slots=[[0, 1], [1, 2]], target_slot=1, ncols=2 ->
        ids rows: [id01, default], [id10, default].
    """
    if ncols is None:
        raise ValueError("ncols must be set (static shape required)")
    mask = slots == target_slot

    def fetch(values, default_value):
        if values is None:
            return None
        return _scatter_to_padded(values, mask, ncols,
                                  default_value=default_value)
    return fetch(ids, default_id), fetch(weights, default_weight)
