"""In-batch pairwise BPR loss: the subset of ``rec_now_tpu/losses/
pairwise.py`` ``pairwise_loss`` that the trainer calls
(``rec_now_tpu/training/trainer.py:277-283``): BPR with a ``factor`` on
the logit gap, one group condition, the pair count returned beside an
unreduced loss sum, and the occurrence weight
``(valid pairs in the row's group) ** click_occurance_power``.

A CUDA tensor goes to the fused kernel (``ops/pairwise_kernel.py``
``pair_loss_sum``); a CPU tensor to the (B, B) math of the JAX module
(:func:`generate_pair_mask`, :func:`bpr_loss_func`,
:func:`_pair_occurance_weights`), differentiated by autograd.  Labels
are clicks in {0, 1}: the kernel's occurrence weight is the binary
closed form ``pos(g) * neg(g)``.

The CPU path is kept apart from the kernel's plain version
(``pairwise_kernel.pair_loss_fused_plain``), which derives ``dlogits`` by
hand as the kernel does: a training step on the CPU, held against the
same step on the card, thus checks the kernel's hand-derived gradient
against autograd of the loss itself.

Symbols: B = batch size.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rec_now_tpu_torch.ops import pairwise_kernel
from rec_now_tpu_torch.ops._build import is_cpu


def generate_pair_mask(group: torch.Tensor) -> torch.Tensor:
    """(B, B) bool mask of same-group, off-diagonal sample pairs."""
    g = group.reshape(-1)
    eye = torch.eye(g.shape[0], dtype=torch.bool, device=g.device)
    return (g[:, None] == g[None, :]) & ~eye


def bpr_loss_func(outputs_pos: torch.Tensor, outputs_neg: torch.Tensor,
                  weights: Optional[torch.Tensor], factor: float,
                  pair_mask: torch.Tensor) -> torch.Tensor:
    """Unreduced BPR loss ``sum mask * w * softplus(-(pos - neg) * f)``."""
    logits = (outputs_pos - outputs_neg) * factor
    # softplus(-x) in the stable form of the JAX module's jax.nn.softplus
    losses = torch.clamp_min(-logits, 0.0) + torch.log1p(
        torch.exp(-logits.abs()))
    if weights is not None:
        losses = losses * weights
    return (losses * pair_mask.to(losses.dtype)).sum()


def _pair_occurance_weights(group: torch.Tensor, click_occurance_power: float,
                            pair_mask: torch.Tensor) -> torch.Tensor:
    """(B, B) per-pair weights ``count[i] ** power``, where ``count[i]``
    is the number of valid pairs whose row shares row i's group; 0 for a
    group with none."""
    g = group.reshape(-1)
    row_count = pair_mask.float().sum(dim=1)
    same = (g[:, None] == g[None, :]).float()
    count = same @ row_count
    w = torch.where(count > 0,
                    count.clamp_min(1e-30) ** click_occurance_power,
                    torch.zeros_like(count))
    return w[:, None].expand(pair_mask.shape)


def pairwise_loss(outputs: torch.Tensor, labels: torch.Tensor,
                  groups: torch.Tensor, factor: float = 1.0,
                  click_occurance_power: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unreduced loss sum, pair count) over pairs of one group with
    ``label_i > label_j``; the count carries no gradient."""
    outputs = outputs.reshape(-1)
    labels = labels.reshape(-1).to(outputs.dtype)
    groups = groups.reshape(-1)
    if not is_cpu(outputs, "pairwise_loss"):
        return pairwise_kernel.pair_loss_sum(outputs, labels, groups, factor,
                                             click_occurance_power)
    pair_mask = generate_pair_mask(groups) & (labels[:, None]
                                              > labels[None, :])
    weights = None
    if click_occurance_power != 0.0:
        weights = _pair_occurance_weights(groups, click_occurance_power,
                                          pair_mask)
    loss = bpr_loss_func(outputs[:, None], outputs[None, :], weights, factor,
                         pair_mask)
    return loss, pair_mask.float().sum()
