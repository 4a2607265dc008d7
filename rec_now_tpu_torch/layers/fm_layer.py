"""Factorization-machine second-order interaction layer.

Counterpart of ``rec_now_tpu/layers/fm_layer.py`` (``FMLayer``): the
sum-square minus square-sum trick, ``0.5 * sum_d((sum_f e_f)^2 -
sum_f e_f^2)``.  No parameters, no kernel (elementwise math and
reductions, as XLA fuses them in JAX).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn


class FMLayer(nn.Module):
    """FM second-order cross of F field embeddings -> (B, 1)."""

    def forward(self, inputs: Union[torch.Tensor, Sequence[torch.Tensor]]
                ) -> torch.Tensor:
        """inputs: a stacked (B, F, D) tensor or F tensors of (B, D)."""
        stacked = (torch.stack(list(inputs), dim=1)
                   if isinstance(inputs, (list, tuple)) else inputs)
        summed = stacked.sum(dim=1)                         # (B, D)
        square_sum = stacked.square().sum(dim=1)            # (B, D)
        return 0.5 * (summed.square() - square_sum).sum(dim=1, keepdim=True)
