"""Carry JAX (Flax) serving weights into the port.

Inputs are numpy arrays (a caller holding JAX arrays passes
``jax.device_get(...)``); nothing here imports JAX.

* :func:`from_jax_params` -- a Flax param tree -> a ``state_dict``:
  ``Dense.kernel`` (in, out) becomes ``nn.Linear.weight`` (out, in),
  ``bias`` stays, every other leaf (the CIN's (K, F, H) weights) keeps
  its shape; names join the tree path with dots
  (``cin/weight_of_layer1`` -> ``cin.weight_of_layer1``,
  ``deep/dense_0/kernel`` -> ``deep.dense_0.weight``).
* :func:`table_from_packed` -- the lane-packed, mod-sharded JAX table
  -> the logical (V, D) table.
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
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.")
                continue
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                name, arr = "weight", arr.T
            out[prefix + name] = torch.from_numpy(np.array(arr, order="C"))

    walk(params, "")
    return out


def table_from_packed(packed: np.ndarray, num_shards: int,
                      dim: int) -> torch.Tensor:
    """(V/P, P*D) packed table over ``num_shards`` shards -> (V, D).

    Global row r lives on shard r % n at local row l = r // n, which is
    physical row (r % n) * (V/n/P) + l // P, lane slot l % P
    (``ShardedEmbeddingTable.debug_read``).
    """
    arr = np.asarray(packed, dtype=np.float32)
    pack = arr.shape[1] // dim
    vocab = arr.shape[0] * pack
    n = num_shards
    if vocab % (n * pack):
        raise ValueError(f"{arr.shape} rows do not split over {n} shards")
    ids = np.arange(vocab)
    local = ids // n
    phys = (ids % n) * (vocab // n // pack) + local // pack
    rows = arr.reshape(-1, pack, dim)[phys, local % pack]
    return torch.from_numpy(np.ascontiguousarray(rows))
