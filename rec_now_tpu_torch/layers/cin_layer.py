"""Compressed Interaction Network (CIN) layer -- xDeepFM.

Counterpart of ``rec_now_tpu/layers/cin_layer.py``.  Weights keep the
JAX layout ``(H_k, F, H_{k-1})`` under the names
``weight_of_layer{k}``, initialized glorot-uniform with the fan of
their flattened ``(F * H_{k-1}, H_k)`` view.  With ``sum_channel`` the
whole stack runs in one kernel (:func:`cin_stack_sum`); otherwise each
layer is :func:`cin_contract`.  Both take the plain PyTorch path for
CPU tensors.

Symbols: B batch, D embedding dim, F fields, Hs hidden channel sizes.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.core.config import glorot_uniform, resolve_device
from rec_now_tpu_torch.ops.cin_kernel import cin_stack_sum
from rec_now_tpu_torch.ops.cin_op import cin_contract


class CINLayer(nn.Module):
    """CIN with per-layer weights (H_k, F, H_{k-1})."""

    def __init__(self, num_field: int, hidden_sizes: Sequence[int],
                 generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_layers = len(hidden_sizes)
        extended = [num_field] + list(hidden_sizes)
        for i in range(1, len(extended)):
            k, h = extended[i], extended[i - 1]
            flat = glorot_uniform((num_field * h, k), num_field * h, k,
                                  generator)
            w = flat.t().reshape(k, num_field, h).contiguous()
            setattr(self, f"weight_of_layer{i}", nn.Parameter(w.to(device)))

    def weights(self):
        return [getattr(self, f"weight_of_layer{i}")
                for i in range(1, self.num_layers + 1)]

    def forward(self, emb: torch.Tensor, output_input: bool = True,
                sum_channel: bool = True) -> torch.Tensor:
        """emb (B, F, D) ->
        sum_channel=True: (B, D);
        sum_channel=False: (B, sum(Hs) * D), plus F * D with
        ``output_input``.  The call is the span ``cin`` while tracing is
        on, with the stream's time across it on CUDA
        (``core/profiling.py``)."""
        with profiling.span("cin", device=emb.is_cuda):
            b, f, d = emb.shape
            x0 = emb.transpose(1, 2).contiguous()           # (B, D, F)
            weights = self.weights()
            if sum_channel and weights:
                out = cin_stack_sum(x0.reshape(b * d, f), weights,
                                    output_input=output_input)
                return out.reshape(b, d)
            layers = [x0]
            for w in weights:
                layers.append(cin_contract(x0, layers[-1], w))  # (B, D, Hk)
            if not output_input:
                layers = layers[1:]
            output = torch.cat(layers, dim=-1)              # (B, D, sum(Hs))
            if sum_channel:
                return output.sum(dim=-1)
            return output.transpose(1, 2).reshape(b, -1)    # (B, sum(Hs)*D)
