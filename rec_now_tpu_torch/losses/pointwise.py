"""Pointwise losses: counterpart of ``rec_now_tpu/losses/pointwise.py``
(the one the trainer calls)."""
from __future__ import annotations

import torch


def sigmoid_cross_entropy_with_logits(labels: torch.Tensor,
                                      logits: torch.Tensor) -> torch.Tensor:
    """Elementwise numerically-stable sigmoid cross-entropy:
    ``max(x, 0) - x * z + log1p(exp(-|x|))``.

    Written so that autograd gives JAX's gradient of the same formula at
    x = 0 too (``jnp.maximum`` splits a tie 0.5 / 0.5, ``jnp.abs`` has
    slope 1 there: -z in all).  Exact zero logits are common: a head
    behind a ReLU tower gives its zero-initialized bias for every sample
    whose tower output is all zero.
    """
    labels = labels.to(logits.dtype)
    abs_x = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_x)))
