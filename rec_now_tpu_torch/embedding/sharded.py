"""The trainer's embedding table on one device, with row-wise Adagrad.

Counterpart of ``rec_now_tpu/embedding/sharded.py``
``ShardedEmbeddingTable`` in its one-shard, dense-apply, exact-dedup
Adagrad form (``sharded.py:105-715``; with one shard every row is owned,
``_owned_grad_candidates`` at :393-399).  The state is the logical
(V, D) table and a (V,) accumulator; the TPU's lane packing is not kept
(``convert.table_from_packed`` / ``acc_from_packed`` read a packed JAX
state).

An update scatter-adds the batch's (N, D) row gradients into a zeroed
f32 (V, D) buffer (``index_add_``: duplicate ids sum, which is the exact
dedup), then runs one Adagrad pass over the whole table
(``ops/table_update_kernel.py``), in place.  The buffer stays f32: the
TPU's bf16 buffer (:672-673) is a TPU layout choice.

Example:
    table = ShardedEmbeddingTable(vocab_size=2_600_000, dim=16)
    state = table.init(torch.Generator().manual_seed(0))
    emb = table.lookup(state, ids)                  # ids.shape + (D,)
    state = table.apply_grads(state, ids, emb_grads, lr=0.05)
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.ops import table_update_kernel

# Adagrad's initial accumulator (sharded.py:122, the JAX default)
INITIAL_ACCUMULATOR = 0.1


class ShardedTableState(NamedTuple):
    """What an update changes: the rows and their Adagrad accumulators."""
    table: torch.Tensor          # (V, D) float32
    accumulator: torch.Tensor    # (V,) float32


class ShardedEmbeddingTable:
    """(V, D) table on one device: ``init``, ``lookup``, ``apply_grads``;
    the rows are the serving :class:`EmbeddingTable`'s."""

    def __init__(self, vocab_size: int, dim: int,
                 device: Union[str, torch.device] = "cuda"):
        self.rows = EmbeddingTable(vocab_size, dim, device)
        self.vocab_size, self.dim = vocab_size, dim
        self.device = self.rows.device

    def init(self, generator: torch.Generator) -> ShardedTableState:
        """Rows ~ U(-1e-3, 1e-3) drawn on the CPU, accumulators at 0.1,
        both on the device (``sharded.py:283-295``)."""
        acc = torch.full((self.vocab_size,), INITIAL_ACCUMULATOR,
                         dtype=torch.float32, device=self.device)
        return ShardedTableState(self.rows.init(generator), acc)

    def lookup(self, state: ShardedTableState,
               ids: torch.Tensor) -> torch.Tensor:
        """Gather rows: int ids of any shape -> ids.shape + (D,)."""
        return self.rows.lookup(state.table, ids)

    def apply_grads(self, state: ShardedTableState, ids: torch.Tensor,
                    grads: torch.Tensor, lr: float) -> ShardedTableState:
        """Row-wise Adagrad from gradients w.r.t. the looked-up rows
        (``ids.shape + (D,)``), duplicates summed first.  Updates
        ``state`` in place and returns it."""
        dense_g = torch.zeros_like(state.table)
        dense_g.index_add_(0, ids.reshape(-1),
                           grads.reshape(-1, self.dim).to(torch.float32))
        table_update_kernel.adagrad_dense_pass(state.table, state.accumulator,
                                               dense_g, lr)
        return state
