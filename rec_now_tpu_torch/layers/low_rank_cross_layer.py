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
glorot-uniform on its own fans, and ``biases`` (L, D), zeros.

Where no gradient is recorded (``torch.inference_mode`` or
``torch.no_grad``), each layer runs on B8's ``wgmma`` kernel where
``ops/multi_dense_kernel.py``'s ``cross_wg`` takes it (CUDA float32
inputs of a shape its plan takes): two launches, the weights read in
their (in, out) storage, ``x0 * (. + b_l) + x_l`` in the second one's
epilogue, each layer past the first written over its x_l, so the stack
allocates one (B, D) output.  Every other layer, and every layer while a
gradient is recorded, is two float32 products and one fused
multiply-add (``addmm`` with the bias, then ``addcmul``), counted in
``cross.torch``.  The choice rests on the inputs' device, type, grad
mode, shapes and alignment alone.

Symbols: B batch, D in-dim, r low rank, L num_layers.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.core.config import (glorot_uniform, resolve_device,
                                           zeros)
from rec_now_tpu_torch.ops import multi_dense_kernel as mk


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
        wgmma = not torch.is_grad_enabled()
        x = x0
        for i in range(self.num_layers):
            # past layer 0, x_l is this call's own: x_{l+1} goes over it
            y = (mk.cross_wg(x, x0, self.v_kernels[i], self.w_kernels[i],
                             self.biases[i], None if i == 0 else x)
                 if wgmma else None)
            if y is None:
                profiling.count("cross.torch")
                xw = torch.addmm(self.biases[i], x @ self.v_kernels[i],
                                 self.w_kernels[i])
                y = torch.addcmul(x, x0, xw)
            x = y
        return x
