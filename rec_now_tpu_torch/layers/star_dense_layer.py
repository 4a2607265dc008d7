"""STAR topology dense layers (per-sample and per-domain personalization).

Counterpart of ``rec_now_tpu/layers/star_dense_layer.py``:

* :class:`StarDenseLayer` (:31-112) -- per-sample kernels: one or more
  (B, D * U + U) parameter vectors (usually looked up by scene id) are
  cut into a (B, D, U) kernel, which multiplies the trunk kernel, and a
  (B, U) bias, which adds; kernels of several star nets multiply, their
  biases add, and the number of star nets is subtracted from the bias
  (kernel and bias share a ones-initialized row).  The product is
  ``einsum("bd,du,bdu->bu")``.
* :class:`ParasiticStarDenseLayer` (:115-204) -- a trunk dense layer
  whose kernel is multiplied elementwise by one of ``num_groups``
  parasitic kernels (ones at init) and whose bias gets that group's
  parasitic bias.

Parameters keep the JAX names.  ``StarDenseLayer``'s trunk ``kernel`` (D,
U) is held as ``weight`` (U, D), the layout ``convert.from_jax_params``
gives every 2-D ``kernel``; the parasitic layer's ``trunk_kernel`` (D, U),
``trunk_bias`` (U,), ``parasitic_kernel`` (G, D, U) and ``parasitic_bias``
(G, U) keep JAX's layout.  Trunk kernels are glorot-uniform and biases
zero, the only init JAX's callers use.

Symbols: B batch, D in-dim, U out-dim, G groups (domains).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import (get_activation, get_initializer,
                                           glorot_uniform, resolve_device,
                                           zeros)
from rec_now_tpu_torch.core.shapes import wrap_as_list


def _trunk_weight(in_dim: int, units: int, generator: torch.Generator,
                  device: torch.device) -> nn.Parameter:
    """A glorot-uniform (D, U) kernel held as (U, D)."""
    w = glorot_uniform((in_dim, units), in_dim, units, generator)
    return nn.Parameter(w.t().contiguous().to(device))


def split_net_param(net_param: torch.Tensor, dim_in: int, units: int):
    """(B, D * U + U) -> kernel (B, D, U), bias (B, U)."""
    kernel = net_param[:, :dim_in * units].reshape(-1, dim_in, units)
    return kernel, net_param[:, dim_in * units:].reshape(-1, units)


class StarDenseLayer(nn.Module):
    """Dense layer whose kernel is the trunk kernel times per-sample star
    kernels: (B, D) -> (B, U)."""

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
    def get_starnet_param_size(cls, units_in: int, units_out: int) -> int:
        """The width of one star net's (kernel, bias) vector."""
        return units_in * units_out + units_out

    @classmethod
    def get_starnet_kernel_initializer(cls) -> Callable:
        """Star kernels multiply the trunk: ones."""
        return get_initializer("ones")

    @classmethod
    def get_starnet_bias_initializer(cls) -> Callable:
        return get_initializer("zeros")

    def forward(self, inputs: torch.Tensor,
                starnet_param_list: Union[torch.Tensor, List[torch.Tensor]]
                ) -> torch.Tensor:
        """inputs (B, D), one or a list of (B, D * U + U) star nets ->
        (B, U)."""
        nets = wrap_as_list(starnet_param_list)
        kernel, bias = split_net_param(nets[0], self.in_dim, self.units)
        for p in nets[1:]:
            k, b = split_net_param(p, self.in_dim, self.units)
            kernel, bias = kernel * k, bias + b
        if self.bias is not None:
            bias = bias + self.bias
        # kernel and bias live in one ones-initialized table row: the
        # bias's init offset is taken out
        bias = bias - float(len(nets))
        out = torch.einsum("bd,ud,bdu->bu", inputs, self.weight, kernel)
        return self.activation(out + bias)


class ParasiticStarDenseLayer(nn.Module):
    """Trunk dense layer + ``num_groups`` parasitic kernels (multiplied).

    ``activation`` defaults to ReLU, what ``MultiTaskModel``'s towers set
    (JAX's default is None)."""

    parasitic_default = "ones"

    def __init__(self, in_dim: int, units: int, num_groups: int,
                 generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda",
                 use_bias: bool = True,
                 activation: Optional[str] = "relu",
                 parasitic_kernel_initializer: Optional[str] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_groups = num_groups
        self.activation = get_activation(activation)
        init = get_initializer(parasitic_kernel_initializer
                               or self.parasitic_default)
        w = glorot_uniform((in_dim, units), in_dim, units, generator)
        self.trunk_kernel = nn.Parameter(w.to(device))
        self.trunk_bias = (nn.Parameter(zeros((units,)).to(device))
                           if use_bias else None)
        self.parasitic_kernel = nn.Parameter(
            init((num_groups, in_dim, units), generator).to(device))
        self.parasitic_bias = (
            nn.Parameter(zeros((num_groups, units)).to(device)) if use_bias
            else None)

    def _combine_kernel(self, trunk: torch.Tensor,
                        parasitic: torch.Tensor) -> torch.Tensor:
        return trunk * parasitic

    def forward(self, inputs: torch.Tensor,
                group_idx: Union[int, torch.Tensor, None] = 0,
                stop_trunk_grad: bool = False) -> torch.Tensor:
        """inputs (B, D) -> (B, U).

        ``group_idx``: an int array (B,) routes each sample to its own
        group (G batched products, then a one-hot select; an id outside
        [0, G) selects nothing, as ``jax.nn.one_hot`` gives); an int (or
        a 0-d tensor) picks one group for the batch; None or a negative
        int uses the trunk alone.  ``stop_trunk_grad`` keeps gradients
        out of the trunk kernel and bias.
        """
        kernel, bias = self.trunk_kernel, self.trunk_bias
        if stop_trunk_grad:
            kernel = kernel.detach()
            bias = None if bias is None else bias.detach()
        only_trunk = group_idx is None or (
            isinstance(group_idx, int) and group_idx < 0)
        per_sample = (not only_trunk and isinstance(group_idx, torch.Tensor)
                      and group_idx.dim() >= 1)
        if per_sample:
            kernels = self._combine_kernel(kernel[None],
                                           self.parasitic_kernel)  # (G, D, U)
            outs = torch.einsum("bd,gdu->gbu", inputs, kernels)  # (G, B, U)
            groups = torch.arange(self.num_groups, device=inputs.device)
            oh = (group_idx.reshape(-1, 1) == groups).to(outs.dtype)  # (B, G)
            outputs = torch.einsum("gbu,bg->bu", outs, oh)
            if bias is not None:
                outputs = outputs + oh @ (bias[None] + self.parasitic_bias)
            return self.activation(outputs)
        if not only_trunk:
            kernel = self._combine_kernel(kernel,
                                          self.parasitic_kernel[group_idx])
            if bias is not None:
                bias = bias + self.parasitic_bias[group_idx]
        outputs = inputs @ kernel
        if bias is not None:
            outputs = outputs + bias
        return self.activation(outputs)
