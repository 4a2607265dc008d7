"""Multi-hash embedding layers (the hash trick with collision mitigation).

Counterpart of ``rec_now_tpu/layers/multi_hash_layer.py``: ``num_hash``
independently salted hashes (``ops/hashing.py``, bit-exact with JAX's)
map ids into [0, num_bins); each hash has its own table
(:class:`MultiHashLayer`, parameters ``embedding_{i}``) or all share one
offset-indexed table (:class:`FastMultiHashLayer`, ``embedding``, hash i
on rows [i * num_bins, (i + 1) * num_bins)); outputs combine by sum,
mean or concat.  Tables start U(-1e-4, 1e-4) from the layer's
generator, as JAX's default.

The tables are dense parameters with gradients, so a lookup is
``torch.nn.functional.embedding`` (JAX's is ``jnp.take``, outside
Pallas); the table's row-gather kernel serves frozen tables only.

Symbols: B batch, L ids per sample, D embedding dim, Nh num hash.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from rec_now_tpu_torch.core.config import as_input, resolve_device, uniform
from rec_now_tpu_torch.ops.hashing import salted_hash

# the tables' default init: U(-1e-4, 1e-4)
INIT_SCALE = 1e-4


def _resolve_salts(salts: Union[int, Sequence[int]],
                   num_hash: int) -> List[int]:
    """An int s gives s, s + 1, ...; a list is extended by + 1 steps."""
    out = ([salts + i for i in range(num_hash)] if isinstance(salts, int)
           else list(salts))
    while len(out) < num_hash:
        out.append(out[-1] + 1)
    return out


def _table(shape: tuple, generator: Optional[torch.Generator],
           device: torch.device) -> nn.Parameter:
    if generator is None:
        raise ValueError("an embedding table needs a generator")
    return nn.Parameter(uniform(shape, INIT_SCALE, generator).to(device))


def _pool(emb: torch.Tensor, weights: Optional[torch.Tensor]
          ) -> torch.Tensor:
    """Weighted sum over every axis between the batch and D."""
    if weights is not None:
        emb = weights[..., None] * emb
    if emb.dim() > 2:
        return emb.sum(dim=tuple(range(1, emb.dim() - 1)))
    return emb


class MultiHashLayer(nn.Module):
    """Per-hash embedding tables, combined by sum / mean / concat."""

    def __init__(self, num_bins: int, embedding_dim: int = -1,
                 num_hash: int = 2, salts: Union[int, Sequence[int]] = 1,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.num_bins, self.embedding_dim = num_bins, embedding_dim
        self.num_hash = num_hash
        self.salts = _resolve_salts(salts, num_hash)
        if embedding_dim > 0:
            for i in range(num_hash):
                setattr(self, f"embedding_{i}", _table(
                    (num_bins, embedding_dim), generator, self.device))

    def forward(self, inputs: torch.Tensor, combiner: Optional[str] = "sum"):
        """Hash (and embed) ids (B,) or (B, L).

        Returns, with embedding: (B[, L], D) for sum / mean, (B[, L],
        Nh * D) for concat, else a list of Nh; without: the bins (B[, L])
        of one hash, (B[, L], Nh) for concat, else a list."""
        inputs = as_input(inputs, self.device)
        outputs = []
        for i in range(self.num_hash):
            hashed = salted_hash(inputs, self.salts[i], self.num_bins)
            if self.embedding_dim > 0:
                outputs.append(F.embedding(hashed,
                                           getattr(self, f"embedding_{i}")))
            else:
                outputs.append(hashed)
        if len(outputs) == 1:
            return outputs[-1]
        if combiner == "concat":
            if self.embedding_dim > 0:
                return torch.cat(outputs, dim=-1)
            return torch.stack(outputs, dim=-1)
        if combiner == "sum" and self.embedding_dim > 0:
            return sum(outputs[1:], outputs[0])
        if combiner == "mean" and self.embedding_dim > 0:
            return sum(outputs[1:], outputs[0]) * (1.0 / len(outputs))
        return outputs

    def get(self, inputs: torch.Tensor) -> torch.Tensor:
        """The sum-combined embedding of ids."""
        return self(inputs, combiner="sum")

    def get_pooling(self, keys: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) ids (and optional (B, L) weights) -> the weighted sum of
        their embeddings, (B, D)."""
        return _pool(self.get(keys), weights)


class FastMultiHashLayer(nn.Module):
    """One shared (num_bins * num_hash, D) table with offset ids: one
    lookup fetches all Nh embeddings."""

    def __init__(self, num_bins: int, embedding_dim: int = -1,
                 num_hash: int = 2, salts: Union[int, Sequence[int]] = 1,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.num_bins, self.embedding_dim = num_bins, embedding_dim
        self.num_hash = num_hash
        self.salts = _resolve_salts(salts, num_hash)
        if embedding_dim > 0:
            self.embedding = _table((num_bins * num_hash, embedding_dim),
                                    generator, self.device)

    def forward(self, inputs: torch.Tensor, combiner: Optional[str] = "sum"):
        """As :class:`MultiHashLayer`; with ``combiner=None`` and a table,
        the (B[, L], Nh, D) stack; without a table, the offset bins
        (B[, L], Nh) for any combiner."""
        inputs = as_input(inputs, self.device)
        stacked = torch.stack(
            [salted_hash(inputs, self.salts[i], self.num_bins)
             + i * self.num_bins for i in range(self.num_hash)], dim=-1)
        if self.embedding_dim <= 0:
            return stacked
        emb = F.embedding(stacked, self.embedding)        # (B[,L], Nh, D)
        if combiner == "concat":
            return emb.reshape(*emb.shape[:-2],
                               emb.shape[-2] * emb.shape[-1])
        if combiner == "sum":
            return emb.sum(dim=-2)
        if combiner == "mean":
            return emb.mean(dim=-2)
        return emb

    def get(self, inputs: torch.Tensor) -> torch.Tensor:
        """The sum-combined embedding of ids."""
        return self(inputs, combiner="sum")

    def get_pooling(self, keys: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L) ids (and optional weights) -> (B, D)."""
        return _pool(self.get(keys), weights)
