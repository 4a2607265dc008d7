"""Deep & Cross Network (DCN) cross layer.

Counterpart of ``rec_now_tpu/layers/dcn_layer.py``:
``x_{l+1} = act(x0 * (x_l . w_l) + b_l)`` for ``degree_of_cross``
iterations, without the ``+ x_l`` residual of the paper, as the
reference has it.  The kernels are stacked as ``kernels`` (L, D, 1),
glorot-uniform with Flax's n-D fans (fan_in D * L, fan_out L), and the
biases as ``biases`` (L, 1, D), zeros: the JAX names and layout.

Symbols: B batch, D in-dim, L degree_of_cross.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (get_activation,
                                           glorot_uniform_nd, resolve_device,
                                           zeros)


class DCNLayer(nn.Module):
    """The DCN cross stack: (B, D) -> (B, D)."""

    def __init__(self, in_dim: int, degree_of_cross: int,
                 generator: torch.Generator, use_bias: bool = True,
                 activation: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.degree_of_cross = degree_of_cross
        self.activation = get_activation(activation)
        self.kernels = nn.Parameter(glorot_uniform_nd(
            (degree_of_cross, in_dim, 1), generator).to(device))
        self.biases = (nn.Parameter(zeros((degree_of_cross, 1, in_dim))
                                    .to(device)) if use_bias else None)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = inputs
        for i in range(self.degree_of_cross):
            out = inputs * (x @ self.kernels[i])           # (B, D)
            if self.biases is not None:
                out = out + self.biases[i]
            x = self.activation(out)
        return x
