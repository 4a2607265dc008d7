"""Stacked (additive-personalized) dense layers.

Counterpart of ``rec_now_tpu/layers/stacked_dense_layer.py``: the shapes
of the STAR layers, but the personalized kernel is *added* to the trunk
kernel, scaled by ``resnet_weight``, so per-scene parameters start at
zero.

* :class:`StackedDenseLayer` -- one or more (B, D * U + U) per-sample
  vectors: ``act(x @ (trunk + w * sum(kernels)) + w * sum(biases) +
  bias)``, the trunk ``kernel`` (D, U) held as ``weight`` (U, D), as
  ``convert.from_jax_params`` maps it.
* :class:`ParasiticStackedDenseLayer` -- :class:`ParasiticStarDenseLayer`
  whose group kernels add (zeros at init).

Symbols: B batch, D in-dim, U out-dim.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (get_activation, get_initializer,
                                           resolve_device, zeros)
from rec_now_tpu_torch.core.shapes import wrap_as_list
from rec_now_tpu_torch.layers.star_dense_layer import (
    ParasiticStarDenseLayer, _trunk_weight, split_net_param)


class StackedDenseLayer(nn.Module):
    """Dense layer with additive per-sample parameters: (B, D) -> (B, U)."""

    def __init__(self, in_dim: int, units: int,
                 generator: torch.Generator, use_bias: bool = True,
                 activation: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.in_dim, self.units = in_dim, units
        self.activation = get_activation(activation)
        self.weight = _trunk_weight(in_dim, units, generator, device)
        self.bias = (nn.Parameter(zeros((units,)).to(device)) if use_bias
                     else None)

    @classmethod
    def get_resnet_param_size(cls, units_in: int, units_out: int) -> int:
        """The width of one personalized (kernel, bias) vector."""
        return units_in * units_out + units_out

    @classmethod
    def get_resnet_kernel_initializer(cls) -> Callable:
        """Personalized kernels add to the trunk: zeros."""
        return get_initializer("zeros")

    @classmethod
    def get_resnet_bias_initializer(cls) -> Callable:
        return get_initializer("zeros")

    def forward(self, inputs: torch.Tensor,
                resnet_param_list: Union[torch.Tensor, List[torch.Tensor]],
                resnet_weight: float = 1.0) -> torch.Tensor:
        """inputs (B, D), one or a list of (B, D * U + U) vectors ->
        (B, U)."""
        nets = [split_net_param(p, self.in_dim, self.units)
                for p in wrap_as_list(resnet_param_list)]
        kernel = sum((k for k, _ in nets[1:]), nets[0][0])    # (B, D, U)
        bias = sum((b for _, b in nets[1:]), nets[0][1])      # (B, U)
        if resnet_weight != 1.0:
            kernel = resnet_weight * kernel
            bias = resnet_weight * bias
        kernel = kernel + self.weight.t()[None]
        if self.bias is not None:
            bias = bias + self.bias
        out = torch.einsum("bd,bdu->bu", inputs, kernel)
        return self.activation(out + bias)


class ParasiticStackedDenseLayer(ParasiticStarDenseLayer):
    """The additive parasitic variant: group kernels add to the trunk and
    start at zero (``stacked_dense_layer.py:100-109``)."""

    parasitic_default = "zeros"

    def _combine_kernel(self, trunk: torch.Tensor,
                        parasitic: torch.Tensor) -> torch.Tensor:
        return trunk + parasitic
