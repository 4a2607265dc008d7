"""Pointwise losses: counterpart of ``rec_now_tpu/losses/pointwise.py``
(the one the trainer calls)."""
from __future__ import annotations

import torch


def sigmoid_cross_entropy_with_logits(labels: torch.Tensor,
                                      logits: torch.Tensor) -> torch.Tensor:
    """Elementwise numerically-stable sigmoid cross-entropy:
    ``max(x, 0) - x * z + log1p(exp(-|x|))``."""
    labels = labels.to(logits.dtype)
    return (torch.clamp_min(logits, 0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
