"""N same-shape Dense layers in one batched contraction.

Counterpart of ``rec_now_tpu/layers/multi_dense_layer.py``
(``MultiDenseLayer``, :24-63): the expert-bank primitive behind MMoE and
PLE.  Parameters keep the JAX names and layout, ``kernel`` (N, D, U)
glorot-uniform with the fans of one expert (D, U), and ``bias``
(N, 1, U) zeros; the contraction is :func:`multi_dense_apply` (kernel
B8 on CUDA tensors).

Symbols: B batch, D in-dim, N experts, U out-dim.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (glorot_uniform_nd, resolve_device,
                                           zeros)
from rec_now_tpu_torch.ops.multi_dense_op import multi_dense_apply


class MultiDenseLayer(nn.Module):
    """Batched multi-expert dense: (B, D) | (1|N, B, D) -> (N, B, U)."""

    def __init__(self, in_dim: int, units: int, num_dnn: int,
                 generator: torch.Generator,
                 activation: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.activation = activation
        shape = (num_dnn, in_dim, units)
        self.kernel = nn.Parameter(
            glorot_uniform_nd(shape, generator).to(device))
        self.bias = nn.Parameter(zeros((num_dnn, 1, units)).to(device))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if inputs.dim() not in (2, 3):
            raise ValueError(f"MultiDenseLayer expects rank-2 or rank-3 "
                             f"input, got rank {inputs.dim()}")
        return multi_dense_apply(inputs, self.kernel, self.bias,
                                 self.activation)
