"""STAR topology dense layer with per-domain parasitic kernels.

Counterpart of ``rec_now_tpu/layers/star_dense_layer.py``
``ParasiticStarDenseLayer`` (:115-204): a trunk dense layer whose kernel
is multiplied elementwise by one of ``num_groups`` parasitic kernels
(ones at init) and whose bias gets that group's parasitic bias, then
ReLU (the activation ``MultiTaskModel``'s towers set).
Parameters keep the JAX names and layout: ``trunk_kernel`` (D, U)
glorot-uniform, ``trunk_bias`` (U,), ``parasitic_kernel`` (G, D, U) ones,
``parasitic_bias`` (G, U) zeros.  ``StarDenseLayer`` is not ported yet.

Symbols: B batch, D in-dim, U out-dim, G groups (domains).
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (glorot_uniform, ones,
                                           resolve_device, zeros)


class ParasiticStarDenseLayer(nn.Module):
    """Trunk dense layer + ``num_groups`` parasitic kernels (multiplied)."""

    def __init__(self, in_dim: int, units: int, num_groups: int,
                 generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_groups = num_groups
        self.trunk_kernel = nn.Parameter(glorot_uniform(
            (in_dim, units), in_dim, units, generator).to(device))
        self.trunk_bias = nn.Parameter(zeros((units,)).to(device))
        self.parasitic_kernel = nn.Parameter(
            ones((num_groups, in_dim, units)).to(device))
        self.parasitic_bias = nn.Parameter(
            zeros((num_groups, units)).to(device))

    def forward(self, inputs: torch.Tensor,
                group_idx: Union[int, torch.Tensor, None] = 0
                ) -> torch.Tensor:
        """inputs (B, D) -> (B, U).

        ``group_idx``: an int array (B,) routes each sample to its own
        group (G batched products, then a one-hot select; an id outside
        [0, G) selects nothing, as ``jax.nn.one_hot`` gives); an int (or
        a 0-d tensor) picks one group for the batch; None or a negative
        int uses the trunk alone.
        """
        kernel, bias = self.trunk_kernel, self.trunk_bias
        only_trunk = group_idx is None or (
            isinstance(group_idx, int) and group_idx < 0)
        per_sample = (not only_trunk and isinstance(group_idx, torch.Tensor)
                      and group_idx.dim() >= 1)
        if per_sample:
            kernels = kernel[None] * self.parasitic_kernel       # (G, D, U)
            outs = torch.einsum("bd,gdu->gbu", inputs, kernels)  # (G, B, U)
            groups = torch.arange(self.num_groups, device=inputs.device)
            oh = (group_idx.reshape(-1, 1) == groups).to(outs.dtype)  # (B, G)
            outputs = torch.einsum("gbu,bg->bu", outs, oh)
            outputs = outputs + oh @ (bias[None] + self.parasitic_bias)
            return torch.relu(outputs)
        if not only_trunk:
            kernel = kernel * self.parasitic_kernel[group_idx]
            bias = bias + self.parasitic_bias[group_idx]
        return torch.relu(inputs @ kernel + bias)
