"""Multi-gate Mixture-of-Experts (MMoE) layer.

Counterpart of ``rec_now_tpu/layers/mmoe_layer.py`` (``MMOELayer``,
:23-71): N experts run as :class:`MultiDenseLayer` banks (ReLU between
layers, the last linear); the T per-task gates as one more (D in,
N out) bank and a softmax; the combine is one einsum
``(N, B, U) x (T, B, N) -> (T, B, U)``.  Submodules carry the Flax names
with ``/`` as nesting (``experts.MultiDenseLayer_0``,
``gates.MultiDenseLayer``), so converted weights land by name.

Symbols: B batch, D in-dim, N experts, T tasks, U expert out-dim.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import resolve_device
from rec_now_tpu_torch.layers.multi_dense_layer import MultiDenseLayer


class MMOELayer(nn.Module):
    """MMoE: shared expert bank + per-task softmax gates."""

    def __init__(self, in_dim: int, num_task: int, num_experts: int,
                 dnn_dims: Sequence[int], generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.experts = nn.ModuleDict()
        d = in_dim
        for i, dim in enumerate(dnn_dims):
            is_last = i == len(dnn_dims) - 1
            self.experts[f"MultiDenseLayer_{i}"] = MultiDenseLayer(
                d, dim, num_experts, generator,
                activation=None if is_last else "relu", device=device)
            d = dim
        self.gates = nn.ModuleDict({"MultiDenseLayer": MultiDenseLayer(
            in_dim, num_experts, num_task, generator, device=device)})

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs (B, D) -> (T, B, U)."""
        x = inputs
        for layer in self.experts.values():
            x = layer(x)                                    # (N, B, U)
        gates = torch.softmax(self.gates["MultiDenseLayer"](inputs),
                              dim=-1)                       # (T, B, N)
        return torch.einsum("nbu,tbn->tbu", x, gates)       # (T, B, U)
