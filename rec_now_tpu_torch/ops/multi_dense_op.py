"""Batched multi-expert dense: N same-shape Dense layers in one call.

Counterpart of ``rec_now_tpu/ops/multi_dense_op.py``: the hot loop of
MMoE and PLE, ``(1|N, B, D) x (N, D, U) [+ (N, 1, U)] -> (N, B, U)`` with
the activation fused.

:func:`multi_dense_apply` is the entry point: a CUDA tensor goes to the
kernel (``ops/multi_dense_kernel.py`` ``multi_dense``, with its
hand-written plain backward), a CPU tensor to that module's plain
version, ``multi_dense_xla`` (the JAX module's formula, :21-39),
differentiated by autograd.  A training step on the CPU, held against
the card's, thus checks the kernel's backward against autograd.

The activation is a name: None, ``"linear"`` / ``"none"`` or ``"relu"``,
the ones the JAX models set on a MultiDenseLayer.
"""
from __future__ import annotations

from typing import Optional

import torch

from rec_now_tpu_torch.core.config import get_activation
from rec_now_tpu_torch.ops import multi_dense_kernel
from rec_now_tpu_torch.ops.multi_dense_kernel import multi_dense_xla
from rec_now_tpu_torch.ops._build import is_cpu


def multi_dense_apply(inputs: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None) -> torch.Tensor:
    """Apply N experts in one contraction.

    Args:
        inputs: (B, D) shared input or (1|N, B, D).
        kernel: (N, D, U).
        bias: optional (N, 1, U).
        activation: None, "linear"/"none" or "relu".

    Returns:
        (N, B, U).
    """
    if inputs.dim() == 2:
        inputs = inputs[None]
    if is_cpu(inputs, "multi_dense_apply"):
        return multi_dense_xla(inputs, kernel, bias, activation)
    get_activation(activation)                     # raises on unknown names
    relu = activation is not None and activation.lower() == "relu"
    return multi_dense_kernel.multi_dense(inputs.contiguous(), kernel, bias,
                                          relu)
