"""Plain DNN tower (Dense stack), counterpart of
``rec_now_tpu/models/tower.py`` as the xDeepFM model uses it: ReLU
between layers, none after the last, glorot-uniform weights and zero
biases.  Layers are named ``dense_{i}`` as in the Flax module, so
converted weights land by name."""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device


class DNNTower(nn.Module):
    """MLP: Linear stack with ReLU on all but the last layer."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = len(dims)
        for i, dim in enumerate(dims):
            setattr(self, f"dense_{i}",
                    make_linear(in_dim, dim, device, generator))
            in_dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x
