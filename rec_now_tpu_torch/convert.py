"""Carry JAX (Flax) serving weights into the port.

Inputs are numpy arrays (a caller holding JAX arrays passes
``jax.device_get(...)``); nothing here imports JAX.

* :func:`from_jax_params` -- a Flax param tree -> a ``state_dict``,
  by these rules:

  - names join the tree path with dots, and a ``/`` inside a Flax
    module name (``MMOELayer`` names its banks ``experts/MultiDenseLayer_0``,
    ``PLELayer`` ``ple_layer_0/task_shared_0/MultiDenseLayer_0``) becomes
    a dot too: the port nests a module for each part
    (``mmoe/experts/MultiDenseLayer_0/kernel`` ->
    ``mmoe.experts.MultiDenseLayer_0.kernel``);
  - only a 2-D leaf named ``kernel`` (a ``Dense``, (in, out)) becomes
    ``nn.Linear.weight`` (out, in): ``deep/dense_0/kernel`` ->
    ``deep.dense_0.weight``;
    ``StarDenseLayer``'s and ``StackedDenseLayer``'s trunk ``kernel``
    (D, U) too: the port holds it as ``weight`` (U, D); so does
    ``DNNAttention``'s ``layer{i}/kernel``;
  - every other leaf keeps its name and shape: a 3-D ``kernel`` (a
    ``MultiDenseLayer`` bank, (N, D, U)), ``bias``, the CIN's
    (K, F, H) weights, DCN's stacked ``kernels`` (L, D, 1) and
    ``biases`` (L, 1, D), the sparse GNN's ``weights_{i}`` (E,), the
    multi-hash tables ``embedding_{i}`` / ``embedding``, and the STAR
    tower's 2-D ``trunk_kernel`` (D, U), which the port holds as a plain
    parameter in the JAX layout because it multiplies the (G, D, U)
    ``parasitic_kernel`` elementwise (the parasitic stacked layer's too).
* :func:`table_from_packed` -- the lane-packed, mod-sharded JAX table
  -> the logical (V, D) table.
* :func:`acc_from_packed` -- the (V/P, P) packed, mod-sharded Adagrad
  accumulator -> (V,), by the same id map.
* :func:`table_state_from_jax` -- a whole JAX ``ShardedTableState``
  (table, accumulator and, under lazy Adam, the moments ``m`` / ``v``,
  which share the table's packed layout, and the step ``count``) -> the
  port's ``ShardedTableState``.
* :func:`table_state_for_rank` -- that logical state -> the rows one
  process of a mesh owns (ids ``rank``, ``rank + P``, ...), so a JAX
  state of any shard count starts a P-process port run.

A JAX ``TrainState`` at init carries over as ``Trainer.init(gen,
params=from_jax_params(params), table=table_state_from_jax(
jax.device_get(state.table), 1, dim))``; its dense Adam state is all
zeros, as a new ``torch.optim.Adam``'s is.  A config-5 state's CAN table
(``state.can_table``, ``rows_per_field`` rows of the CAN layer's
parameter count, 272 wide at full width and 72 in the JAX CAN tests:
widths that divide no 128-lane line, so the TPU packs one row a line)
carries over the same way, at its own width:
``can_table=table_state_from_jax(jax.device_get(state.can_table), 1,
can_dim)``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from rec_now_tpu_torch.embedding.sharded import ShardedTableState, shard_rows


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (with or without the top-level 'params') -> state_dict."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, leaf in tree.items():
            name = name.replace("/", ".")
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.")
                continue
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel" and arr.ndim == 2:
                name, arr = "weight", arr.T
            out[prefix + name] = torch.from_numpy(np.array(arr, order="C"))

    walk(params, "")
    return out


def _packed_rows(vocab: int, pack: int, num_shards: int) -> tuple:
    """(physical row, lane slot) of every global id 0..V-1.

    Global row r lives on shard r % n at local row l = r // n, which is
    physical row (r % n) * (V/n/P) + l // P, lane slot l % P
    (``ShardedEmbeddingTable.debug_read``).
    """
    n = num_shards
    if vocab % (n * pack):
        raise ValueError(f"{vocab} rows do not split over {n} shards of "
                         f"{pack}-row lines")
    ids = np.arange(vocab)
    local = ids // n
    return (ids % n) * (vocab // n // pack) + local // pack, local % pack


def table_from_packed(packed: np.ndarray, num_shards: int,
                      dim: int) -> torch.Tensor:
    """(V/P, P*D) packed table over ``num_shards`` shards -> (V, D)."""
    arr = np.asarray(packed, dtype=np.float32)
    pack = arr.shape[1] // dim
    phys, slot = _packed_rows(arr.shape[0] * pack, pack, num_shards)
    rows = arr.reshape(-1, pack, dim)[phys, slot]
    return torch.from_numpy(np.ascontiguousarray(rows))


def acc_from_packed(packed: np.ndarray, num_shards: int) -> torch.Tensor:
    """(V/P, P) packed accumulator over ``num_shards`` shards -> (V,)."""
    arr = np.asarray(packed, dtype=np.float32)
    pack = arr.shape[1]
    phys, slot = _packed_rows(arr.shape[0] * pack, pack, num_shards)
    return torch.from_numpy(np.ascontiguousarray(arr[phys, slot]))


def table_state_from_jax(state, num_shards: int,
                         dim: int) -> ShardedTableState:
    """A JAX ``ShardedTableState`` of numpy arrays (``jax.device_get``)
    -> the port's: logical (V, D) table, (V,) accumulator and, where the
    JAX state has them, (V, D) ``m`` and ``v`` and an int32 ``count``."""
    table = table_from_packed(state.table, num_shards, dim)
    acc = acc_from_packed(state.accumulator, num_shards)
    if state.m is None:
        return ShardedTableState(table, acc)
    return ShardedTableState(
        table, acc, table_from_packed(state.m, num_shards, dim),
        table_from_packed(state.v, num_shards, dim),
        torch.tensor(int(np.asarray(state.count)), dtype=torch.int32))


def table_state_for_rank(state: ShardedTableState, rank: int,
                         num_ranks: int,
                         vocab_size: int) -> ShardedTableState:
    """The logical ``state`` (:func:`table_state_from_jax`'s, whose rows
    may run past the table's ``vocab_size`` rows into JAX's padding) ->
    the rows process ``rank`` of ``num_ranks`` holds in the port's
    mod-sharded table of ``vocab_size`` rows (``ShardedEmbeddingTable(...,
    mesh=...)``: ``vocab_size`` padded with zero rows to a multiple of
    ``num_ranks``); the count is copied (an update adds to it in place,
    so two states made from one must not share it)."""
    def mine(x):
        return None if x is None else shard_rows(x[:vocab_size], rank,
                                                  num_ranks)
    count = None if state.count is None else state.count.clone()
    return ShardedTableState(mine(state.table), mine(state.accumulator),
                             mine(state.m), mine(state.v), count)
