"""Co-Action Network (CAN) layer.

Counterpart of ``rec_now_tpu/layers/can_layer.py`` (``CANLayer``,
:36-142).  A second input ``dnn_params`` (B, size) holds *per-sample MLP
weights*: each layer's (Din, Dout) kernel and (Dout,) bias are sliced
from it in order and applied to ``inputs`` (B, L, D0) (or (B, D0)); tanh
follows every layer but the last (all of them with
``output_layer_use_activation``), ``use_res_net`` adds each layer's
input; rows of ``inputs`` that are all zero (padding) are masked out of
the output, and the L axis is pooled by ``output_combiner``.  The layer
has no parameters of its own.  The options JAX's callers set are ported
(``dnn_dims``, ``use_res_net``, ``output_layer_use_activation``,
``output_combiner``, ``mask_all_zero_embedding``); the activation (tanh)
and the biases, which no caller changes, are constants.

The per-sample product (B, L, Din) x (B, Din, Dout) is one ``torch.bmm``
a layer, in f32 (TF32 off on the card): the JAX layer leaves it to XLA
(``jnp.matmul``, :113-117), outside any Pallas kernel.  The padding mask
is a comparison of the inputs, so no gradient flows through it: the
parameters' gradient comes through the products alone, as in JAX.

Symbols: B batch, L co-action inputs per sample, D0 input dim, D1..Dn
layer dims.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from rec_now_tpu_torch.layers.pooling_layer import pool


def _layer_param_size(dim_in: int, dim_out: int, use_bias: bool) -> int:
    return dim_in * dim_out + (dim_out if use_bias else 0)


class CANLayer(nn.Module):
    """Apply a per-sample-parameterized DNN to co-action inputs:
    (B, L, D0) or (B, D0) inputs and (B, size) params -> (B, Dn), or
    (B, L, Dn) for 3-D inputs without a combiner."""

    def __init__(self, dnn_dims: Optional[Sequence[int]] = None,
                 use_res_net: bool = False,
                 output_layer_use_activation: bool = False,
                 output_combiner: Optional[str] = "sum",
                 mask_all_zero_embedding: bool = True):
        super().__init__()
        self.dnn_dims = None if dnn_dims is None else list(dnn_dims)
        self.use_res_net = use_res_net
        self.output_layer_use_activation = output_layer_use_activation
        self.output_combiner = output_combiner
        self.mask_all_zero_embedding = mask_all_zero_embedding

    @staticmethod
    def get_dnn_param_size(input_dim: int, dnn_dims: Sequence[int],
                           use_bias: bool = True) -> int:
        """Total parameter count of the per-sample DNN (the width of the
        co-action parameter table)."""
        dims = [input_dim] + list(dnn_dims)
        return sum(_layer_param_size(dims[i - 1], dims[i], use_bias)
                   for i in range(1, len(dims)))

    def _auto_decide_dnn_dims(self, input_dim: int,
                              total_param_size: int) -> List[int]:
        """The layer count if every layer keeps the input dim."""
        one_layer = _layer_param_size(input_dim, input_dim, True)
        n_layer = float(total_param_size) / one_layer
        if math.floor(n_layer) != n_layer:
            raise ValueError(
                f"dnn_param_size not match! input_dim: {input_dim}, "
                f"total_param_size: {total_param_size}, use_bias:True, "
                f"one_layer_param_size(auto decide): {one_layer}")
        return [input_dim] * int(n_layer)

    def forward(self, inputs: torch.Tensor,
                dnn_params: torch.Tensor) -> torch.Tensor:
        dim_in = int(inputs.shape[-1])
        input_was_2d = inputs.dim() == 2
        x = inputs[:, None] if input_was_2d else inputs     # (B, L, D0)
        size = int(dnn_params.shape[-1])
        dnn_dims = (self.dnn_dims if self.dnn_dims is not None
                    else self._auto_decide_dnn_dims(dim_in, size))
        expected = self.get_dnn_param_size(dim_in, dnn_dims)
        if expected != size:
            raise ValueError(
                f"dnn_param_size not match! input_dim: {dim_in}, expected "
                f"total_param_size: {size},\nuse_bias:True, dnn_dims: "
                f"{dnn_dims}, calculated total_param_size: {expected}")
        b = dnn_params.shape[0]
        offset, cur_in, h = 0, dim_in, x
        for i, dim_out in enumerate(dnn_dims):
            kernel = dnn_params[:, offset:offset + cur_in * dim_out]
            offset += cur_in * dim_out
            out = torch.bmm(h, kernel.reshape(b, cur_in, dim_out))
            out = out + dnn_params[:, None, offset:offset + dim_out]
            offset += dim_out
            if self.output_layer_use_activation or i < len(dnn_dims) - 1:
                out = torch.tanh(out)
            if self.use_res_net:
                out = h + out
            cur_in, h = dim_out, out
        if self.mask_all_zero_embedding:
            h = h * (x != 0).any(dim=-1, keepdim=True).to(h.dtype)
        if input_was_2d:
            return h[:, 0]                                  # (B, Dn)
        if self.output_combiner is not None:
            return pool(h, self.output_combiner, axis=1)    # (B, Dn)
        return h                                            # (B, L, Dn)
