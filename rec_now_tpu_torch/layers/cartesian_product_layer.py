"""Cartesian-product feature crossing on integer ids.

Counterpart of ``rec_now_tpu/layers/cartesian_product_layer.py``: n id
tensors (B, Li) -- or (B,) as (B, 1), a scalar as (1, 1); a batch-1
input broadcasts over the batch -- are tiled to the full cross (B, L1 *
... * Ln) in the reference's order (the last input varies fastest), and
each tuple is fused into one 32-bit id: ``mix32`` of the first member's
low 32 bits, then ``combine_hash`` with each next member
(``ops/hashing.py``, bit-exact with JAX's).  ``invalid_value_list[i]``
marks input i's invalid id (None: none); a tuple with an invalid member
becomes ``default_result_id``.

JAX returns uint32; the port returns int64 holding [0, 2^32), whose
:func:`~rec_now_tpu_torch.ops.hashing.salted_hash` folds to the same word
(its high half is 0), so a hash-trick layer downstream gives JAX's bins.

Symbols: B batch, Li per-input lengths, P = prod(Li).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import as_input, resolve_device
from rec_now_tpu_torch.ops.hashing import _MASK, combine_hash, mix32


class CartesianProductLayer(nn.Module):
    """Cross n integer id tensors into (B, prod(Li)) combined ids.  Inputs
    given as lists or arrays are placed on the layer's device."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = resolve_device(device)

    def forward(self, inputs: List[torch.Tensor],
                invalid_value_list: Optional[Sequence[Optional[int]]] = None,
                default_result_id: int = 0) -> torch.Tensor:
        if invalid_value_list is not None and \
                len(invalid_value_list) != len(inputs):
            raise ValueError("length not equal:%s v.s %s"
                             % (len(invalid_value_list), len(inputs)))
        arrays = []
        batch = 1
        for x in inputs:
            x = as_input(x, self.device)
            if x.dim() == 0:
                x = x.reshape(1, 1)
            elif x.dim() == 1:
                x = x[:, None]
            elif x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            arrays.append(x)
            batch = max(batch, x.shape[0])
        arrays = [x.expand(batch, x.shape[1]) for x in arrays]
        dims = [x.shape[1] for x in arrays]
        n = len(arrays)
        tiled = []                                          # n x (B, P)
        for idx, x in enumerate(arrays):
            shape = [batch] + [1] * n
            shape[1 + idx] = dims[idx]
            tiled.append(x.reshape(shape).expand([batch] + dims)
                         .reshape(batch, -1))
        # the first member as JAX's astype(uint32): its low 32 bits
        result = mix32(tiled[0].to(torch.int64) & _MASK)
        for x in tiled[1:]:
            result = combine_hash(result, x)
        if invalid_value_list is not None:
            invalid = torch.zeros(tiled[0].shape, dtype=torch.bool,
                                  device=result.device)
            for x, bad in zip(tiled, invalid_value_list):
                if bad is not None:
                    invalid |= x == bad
            result = torch.where(
                invalid, torch.full((), default_result_id & _MASK,
                                    dtype=torch.int64,
                                    device=result.device), result)
        return result
