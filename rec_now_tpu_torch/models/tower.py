"""Plain DNN tower (Dense stack), counterpart of
``rec_now_tpu/models/tower.py`` as the xDeepFM model uses it: ReLU
between layers, none after the last unless the caller asks for it,
glorot-uniform weights and zero biases.  Layers are named ``dense_{i}``
as in the Flax module, so converted weights land by name.

Where no gradient is recorded (``torch.inference_mode`` or
``torch.no_grad``), each layer runs on B8's ``wgmma`` kernel where
``ops/multi_dense_kernel.py``'s ``linear_wg`` takes it (a CUDA float32
input of a shape its plan takes), on the ``nn.Linear``'s own weight and
bias, its ReLU in the kernel's epilogue; every other layer, and every
layer while a gradient is recorded, runs ``nn.Linear`` and
``torch.relu``.  The choice rests on the input's device, type, grad mode
and shapes alone."""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.ops import multi_dense_kernel as mk


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

    def forward(self, x: torch.Tensor,
                relu_last: bool = False) -> torch.Tensor:
        """x (B, in_dim) -> (B, dims[-1]); ``relu_last`` applies ReLU after
        the last layer too (in the kernel's epilogue where it runs)."""
        wgmma = not torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"dense_{i}")
            relu = relu_last or i < self.num_layers - 1
            y = (mk.linear_wg(x, layer.weight, layer.bias, relu) if wgmma
                 else None)
            if y is None:
                y = layer(x)
                if relu:
                    y = torch.relu(y)
            x = y
        return x
