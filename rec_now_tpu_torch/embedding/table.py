"""A logical (V, D) embedding table: lookups, the reference's
``embedding_func`` closure, and row-wise Adagrad on the touched rows.

Counterpart of ``rec_now_tpu/embedding/table.py`` and of the one-shard
``ShardedEmbeddingTable.lookup`` (``rec_now_tpu/embedding/sharded.py``).
The table is a plain row-major (V, D) float32 tensor; the TPU's lane
packing of ``128 // D`` rows per line is not kept (``convert.
table_from_packed`` reads a packed JAX table into this layout).  Rows
start uniform in +-``initializer_scale`` (``INIT_SCALE`` unless set; the
trainer's CAN table takes 0.05), as the JAX table does.

``init`` gives the bare (V, D) tensor, which serving and ``lookup`` take;
``state_from`` wraps it with a (V,) Adagrad accumulator at
``initial_accumulator`` into an :class:`EmbeddingTableState` for
:meth:`EmbeddingTable.apply_grads` (``table.py:80-130``): the gradients
masked by ``valid_mask``, duplicate ids summed after a sort
(:func:`dedup_rows`), then :func:`adagrad_rows`.  The sharded table's
sparse Adagrad runs the same two functions.

Kernel launches: a lookup, and each call of an ``embedding_func``
closure, 1 x B11 (``gather_rows``); a pooled lookup of multi-hot ids
(``lookup_pooled``) 1 x ``gather_pool_rows``; ``apply_grads`` 2 x B12
(``scatter_add_rows``: the segment sums and the write-back).

One difference from JAX: ``adagrad_rows`` clamps the accumulator at
1e-12 before the square root, as JAX's sharded update does
(``sharded.py:646``) and its one-table update does not (``table.py:128``).
With ``initial_accumulator=0``, a row reached only by masked occurrences
gets ``lr / sqrt(0) * 0``, NaN, in JAX; here it does not move.  At the
default 0.1 the clamp changes no bit.
"""
from __future__ import annotations

from typing import (Callable, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from rec_now_tpu_torch.core.config import resolve_device, uniform
from rec_now_tpu_torch.ops.expand_kernel import scatter_add_rows
from rec_now_tpu_torch.ops.gather_kernel import (gather_pool_rows,
                                                 gather_rows)

# rows start in U(-1e-3, 1e-3) (rec_now_tpu/embedding/sharded.py:291-293)
INIT_SCALE = 1e-3
# Adagrad's initial accumulator (table.py:53, sharded.py:121)
INITIAL_ACCUMULATOR = 0.1


class EmbeddingTableState(NamedTuple):
    """What :meth:`EmbeddingTable.apply_grads` changes."""
    table: torch.Tensor          # (V, D) float32
    accumulator: torch.Tensor    # (V,) row-wise Adagrad accumulator


def dedup_rows(ids: torch.Tensor, grads: torch.Tensor, sentinel: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape dedup (``table.py:107-124``, ``sharded.py:553-573``):
    (N,) ids and (N, D) gradients -> (rows (N,), the distinct ids first
    and then ``sentinel``, an id past the table, for each unused segment;
    row_grad (N, D) their summed gradients (B12; zeros for the unused);
    valid (N, 1) float 1 for a distinct id below ``sentinel``, else 0).
    An id of ``sentinel`` or more (a foreign id's sentinel) is not
    valid."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    # each occurrence's segment, in the ids' order: B12 reads the
    # gradients where they are (no (N, D) gather into sorted order), and
    # a duplicate's adds keep the stable sort's order
    row_grad = scatter_add_rows(torch.zeros_like(grads),
                                torch.empty_like(seg).scatter_(0, order, seg),
                                grads)
    rep = torch.full((n,), sentinel, dtype=sid.dtype,
                     device=ids.device).scatter_(0, seg, sid)
    valid = (rep < sentinel).to(grads.dtype)[:, None]
    return rep, row_grad, valid


def adagrad_rows(table: torch.Tensor, accumulator: torch.Tensor,
                 rows: torch.Tensor, row_grad: torch.Tensor,
                 valid: torch.Tensor, lr: float) -> None:
    """Row-wise Adagrad in place on (N,) ``rows`` (out-of-range ones with
    ``valid`` 0): each adds the mean of its squared (N, D) ``row_grad`` to
    its accumulator, then moves by ``lr / sqrt(max(acc, 1e-12))`` times
    its gradient (``sharded.py:641-650``).  The accumulator's scatter and
    gather are plain, as JAX's ``_expand_scalar`` / ``_fetch_scalars``
    are not Pallas: an out-of-range row (valid 0) adds exactly 0 to the
    row of its place modulo V, so that the unused dedup segments, most of
    a batch with hot ids, do not all wait on one row's atomic adds.  The
    table's write-back is B12, which sums duplicate rows and drops the
    out-of-range ones."""
    sq = row_grad.square().mean(dim=1) * valid[:, 0]
    v = table.shape[0]
    place = torch.arange(rows.shape[0], device=rows.device)
    in_range = torch.where(rows < v, rows, place % v)
    accumulator.index_add_(0, in_range, sq)
    acc_rows = accumulator[in_range]
    scale = lr / acc_rows.clamp_min(1e-12).sqrt()[:, None] * valid
    scatter_add_rows(table, rows, -scale * row_grad)


class EmbeddingTable:
    """(V, D) table: ``init`` makes the tensor, ``lookup`` gathers rows,
    ``apply_grads`` takes a row-wise Adagrad step.

    Example:
        table = EmbeddingTable(vocab_size=2_600_000, dim=16)
        weights = table.init(torch.Generator().manual_seed(0))
        emb = table.lookup(weights, ids)        # ids.shape + (D,)

        state = table.state_from(weights)
        f = table.embedding_func(state)         # ids (N,) -> (N, D)
        state = table.apply_grads(state, ids, grad_emb, lr=0.05)
    """

    def __init__(self, vocab_size: int, dim: int,
                 device: Union[str, torch.device] = "cuda",
                 initializer_scale: float = INIT_SCALE,
                 initial_accumulator: float = INITIAL_ACCUMULATOR):
        self.vocab_size = vocab_size
        self.dim = dim
        self.device = resolve_device(device)
        self.initializer_scale = initializer_scale
        self.initial_accumulator = initial_accumulator

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """Rows ~ U(-initializer_scale, initializer_scale), drawn on the
        CPU, placed on the device."""
        t = uniform((self.vocab_size, self.dim), self.initializer_scale,
                    generator)
        return t.to(self.device)

    def state_from(self, table: torch.Tensor) -> EmbeddingTableState:
        """``table`` with a fresh accumulator at ``initial_accumulator``
        (``table.py:61-68``)."""
        acc = torch.full((table.shape[0],), self.initial_accumulator,
                         dtype=torch.float32, device=table.device)
        return EmbeddingTableState(table, acc)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows: int ids of any shape -> ids.shape + (D,)."""
        return gather_rows(table, ids)

    def lookup_pooled(self, table: torch.Tensor, ids: torch.Tensor,
                      hotness: Sequence[int]) -> torch.Tensor:
        """Sum-pool each field's rows: ids (B, sum(hotness)), field f's
        ``hotness[f]`` ids side by side -> (B, F, D)."""
        return gather_pool_rows(table, ids, hotness)

    def embedding_func(self, state: Union[EmbeddingTableState, torch.Tensor]
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
        """The reference's ``embedding_func`` contract
        (``embedding_util.py:292``) on a state or a bare table: an int id
        vector -> (N, D), one :meth:`lookup` a call."""
        table = state if isinstance(state, torch.Tensor) else state.table
        return lambda ids: self.lookup(table, ids)

    def apply_grads(self, state: EmbeddingTableState, ids: torch.Tensor,
                    grads: torch.Tensor, lr: float,
                    valid_mask: Optional[torch.Tensor] = None
                    ) -> EmbeddingTableState:
        """Row-wise Adagrad on the rows of ``ids`` (any shape, duplicates
        summed first) from gradients w.r.t. the looked-up rows
        (``ids.shape + (D,)``); where ``valid_mask`` (ids' shape) is
        False the gradient is 0.  Updates ``state`` in place and returns
        it."""
        ids = ids.reshape(-1).to(torch.int64)
        grads = grads.reshape(ids.shape[0], -1).to(torch.float32)
        if valid_mask is not None:
            grads = grads * valid_mask.reshape(-1, 1).to(grads.dtype)
        rows, row_grad, valid = dedup_rows(ids, grads, state.table.shape[0])
        adagrad_rows(state.table, state.accumulator, rows, row_grad, valid,
                     lr)
        return state
