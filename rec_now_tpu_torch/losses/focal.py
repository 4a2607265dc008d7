"""Focal loss: counterpart of ``rec_now_tpu/losses/focal.py``
(reference: rec_now/rec_block/focal_loss.py:12-66)."""
from __future__ import annotations

from typing import Optional

import torch

from rec_now_tpu_torch.losses.pointwise import \
    sigmoid_cross_entropy_with_logits


def focal_crossentropy_loss(labels: torch.Tensor, logits: torch.Tensor,
                            alpha: Optional[float] = 0.25,
                            gamma: Optional[float] = 2.0,
                            stop_weight_gradient: bool = False,
                            return_mean: bool = True) -> torch.Tensor:
    """Focal loss for class-imbalanced binary classification:
    ``alpha_factor * (1 - p_t) ** gamma * sigmoid_CE(labels, logits)``.

    Args:
        labels: (B,) 0/1 labels.
        logits: (B,) logits.
        alpha: the positives' weight in (0, 1); negatives get 1 - alpha.
            None or 0 drops the factor (JAX tests its truthiness).
        gamma: focusing exponent >= 0; None or 0 drops the modulation.
        stop_weight_gradient: no gradient through the modulating factor.
        return_mean: reduce to the mean.

    Returns:
        The mean, or the (B,) per-sample losses.
    """
    if alpha and (alpha <= 0.0 or alpha >= 1.0):
        raise ValueError(
            "Value of alpha should be greater than zero and less than one.")
    if gamma and gamma < 0:
        raise ValueError(
            "Value of gamma should be greater than or equal to zero.")
    labels = labels.to(logits.dtype)
    loss = sigmoid_cross_entropy_with_logits(labels, logits)
    if alpha:
        loss = (labels * alpha + (1 - labels) * (1 - alpha)) * loss
    if gamma:
        p = torch.sigmoid(logits)
        pred_sim = labels * p + (1 - labels) * (1 - p)
        modulating = (1.0 - pred_sim) ** gamma
        if stop_weight_gradient:
            modulating = modulating.detach()
        loss = modulating * loss
    if return_mean:
        loss = loss.mean()
    return loss
