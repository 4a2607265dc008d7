"""DCN-V2's low-rank cross layer (Wang et al., WWW 2021, arXiv:2008.13535,
eq. 2 with the low-rank W = U V^T of section 5), as TorchRec's
``LowRankCrossNet`` computes it for MLPerf's DLRM-DCNv2::

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

for ``num_layers`` layers, with V_l (D -> r, no bias), W_l (r -> D) and
b_l.  No counterpart in the JAX package: its ``DCNLayer`` is rank 1
without the ``+ x_l`` residual, and ``DCNMixLayer`` is rec_now's
DCN-mix (experts, a gate, tanh).

Parameters in the port's (in, out) layout, stacked by layer:
``v_kernels`` (L, D, r) and ``w_kernels`` (L, r, D), each layer
glorot-uniform on its own fans, and ``biases`` (L, D), zeros.  A layer
is two float32 products and one fused multiply-add (``addmm`` with the
bias, then ``addcmul``).

Symbols: B batch, D in-dim, r low rank, L num_layers.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (glorot_uniform, resolve_device,
                                           zeros)


class LowRankCrossLayer(nn.Module):
    """The low-rank cross stack: (B, D) -> (B, D)."""

    def __init__(self, in_dim: int, low_rank: int, num_layers: int,
                 generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = num_layers
        self.v_kernels = nn.Parameter(glorot_uniform(
            (num_layers, in_dim, low_rank), in_dim, low_rank,
            generator).to(device))
        self.w_kernels = nn.Parameter(glorot_uniform(
            (num_layers, low_rank, in_dim), low_rank, in_dim,
            generator).to(device))
        self.biases = nn.Parameter(zeros((num_layers, in_dim)).to(device))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            xw = torch.addmm(self.biases[i], x @ self.v_kernels[i],
                             self.w_kernels[i])
            x = torch.addcmul(x, x0, xw)
        return x
