"""One CIN hidden layer on (B, D, ·) tensors.

Counterpart of ``rec_now_tpu/ops/cin_op.py``.  The layer is the triple
contraction

    out[b, d, k] = sum_{f, h} W[k, f, h] * x0[b, d, f] * prev[b, d, h]

:func:`cin_contract_plain` is the einsum (prev x W first, then x0, the
order of the JAX ``cin_contract_xla``); :func:`cin_contract` runs the
CUDA kernel for CUDA tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from rec_now_tpu_torch.ops.cin_kernel import cin_flat, cin_flat_plain


def _flat(fn, x0, prev, weight):
    b, d, f = x0.shape
    out = fn(x0.reshape(b * d, f), prev.reshape(b * d, prev.shape[2]),
             weight)
    return out.reshape(b, d, -1)


def cin_contract_plain(x0: torch.Tensor, prev: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """x0 (B, D, F), prev (B, D, H), weight (K, F, H) -> (B, D, K)."""
    return _flat(cin_flat_plain, x0, prev, weight)


def cin_contract(x0: torch.Tensor, prev: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """One CIN layer; the kernel on CUDA tensors, the einsum on CPU ones."""
    return _flat(cin_flat, x0.contiguous(), prev.contiguous(), weight)
