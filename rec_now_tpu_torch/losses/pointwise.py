"""Pointwise losses: counterpart of ``rec_now_tpu/losses/pointwise.py``
(the sigmoid cross-entropy the trainer calls, and ``bce_loss``)."""
from __future__ import annotations

from typing import Optional

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


def bce_loss(labels: torch.Tensor, logits: torch.Tensor,
             weights: Optional[torch.Tensor] = None,
             reduce_mean: bool = True) -> torch.Tensor:
    """Binary cross-entropy with logits, optionally weighted and reduced
    (``pointwise.py:19-31``): weighted and reduced, the weighted sum over
    ``sum(weights) + 1e-10``; else the mean, or the elementwise losses."""
    losses = sigmoid_cross_entropy_with_logits(labels, logits)
    if weights is not None:
        losses = losses * weights
        if reduce_mean:
            return losses.sum() / (weights.sum() + 1e-10)
    return losses.mean() if reduce_mean else losses
