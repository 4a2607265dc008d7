"""DCN-mix (DCN-V2): a stack of low-rank mixture-of-experts cross layers.

Counterpart of ``rec_now_tpu/layers/dcn_mix_layer.py`` (``DCNMixLayer``,
:26-90).  Per layer, each of N experts projects x (B, D) into an S-dim
subspace, applies tanh, an (S, S) map and tanh again, projects back to D
and adds its bias; the experts' outputs times x0 are mixed by a softmax
gate over the experts computed from x.  The parameters keep the Flax
names and layouts, stacked over the L layers:
``origin_to_sub_kernels`` (L, N, D, S), ``sub_to_sub_kernels``
(L, N, S, S), ``sub_to_origin_kernels`` (L, N, S, D) (glorot with the
fans ``glorot_uniform_nd(2, 3)`` gives them), ``biases`` (L, 1, N, D)
zeros and ``gate_kernels`` (L, D, N) (Flax's glorot: fans D * L and
N * L).  The expert contractions are batched products (``torch.einsum``):
the JAX layer leaves them to XLA, outside any Pallas kernel.

Symbols: B batch, D in-dim, S subspace dim, N experts, L layers.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (glorot_uniform_nd, resolve_device,
                                           zeros)


class DCNMixLayer(nn.Module):
    """DCN-V2 mixture-of-low-rank-experts cross network: (B, D) -> (B, D)."""

    def __init__(self, in_dim: int, dim_sub_space: int, num_layer: int,
                 num_expert: int, generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        d, s, n, layers = in_dim, dim_sub_space, num_expert, num_layer

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(device))

        self.origin_to_sub_kernels = param(
            glorot_uniform_nd((layers, n, d, s), generator))
        self.sub_to_sub_kernels = param(
            glorot_uniform_nd((layers, n, s, s), generator))
        self.sub_to_origin_kernels = param(
            glorot_uniform_nd((layers, n, s, d), generator))
        self.biases = param(zeros((layers, 1, n, d)))
        self.gate_kernels = param(glorot_uniform_nd((layers, d, n),
                                                    generator))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x0 = inputs[:, None, :]                                 # (B, 1, D)
        x = inputs
        for li in range(self.gate_kernels.shape[0]):
            sub = torch.tanh(torch.einsum(
                "bd,nds->bns", x, self.origin_to_sub_kernels[li]))
            sub = torch.tanh(torch.einsum(
                "bns,nst->bnt", sub, self.sub_to_sub_kernels[li]))
            origin = torch.einsum("bns,nsd->bnd", sub,
                                  self.sub_to_origin_kernels[li])
            origin = x0 * (origin + self.biases[li])            # (B, N, D)
            gates = torch.softmax(x @ self.gate_kernels[li], dim=-1)
            x = torch.einsum("bnd,bn->bd", origin, gates)       # (B, D)
        return x
