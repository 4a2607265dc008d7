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
  - every other leaf keeps its name and shape: a 3-D ``kernel`` (a
    ``MultiDenseLayer`` bank, (N, D, U)), ``bias``, the CIN's
    (K, F, H) weights, and the STAR tower's 2-D ``trunk_kernel`` (D, U),
    which the port holds as a plain parameter in the JAX layout because
    it multiplies the (G, D, U) ``parasitic_kernel`` elementwise.
* :func:`table_from_packed` -- the lane-packed, mod-sharded JAX table
  -> the logical (V, D) table.
* :func:`acc_from_packed` -- the (V/P, P) packed, mod-sharded Adagrad
  accumulator -> (V,), by the same id map.

A JAX ``TrainState`` at init carries over as ``Trainer.init(gen,
params=from_jax_params(params), table=ShardedTableState(
table_from_packed(...), acc_from_packed(...)))``; its Adam state is
all zeros, as a new ``torch.optim.Adam``'s is.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
