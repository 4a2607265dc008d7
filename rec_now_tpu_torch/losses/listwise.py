"""In-batch listwise softmax-CE loss: the subset of
``rec_now_tpu/losses/listwise.py`` that the trainer calls
(``rec_now_tpu/training/trainer.py:288-301``).

Every sample is a candidate anchor of its group's row; only the first
occurrence of each group value is a valid anchor, and only when the group
has a label above and a label below ``POS_NEG_TH`` (0.5).  The listwise
matrices are (B, B):

    member[i, j] = group[j] == group[i]
    labels[i, j] = labels[j] * member[i, j], normalized per row
    logits[i, j] = logits[j] if member[i, j] else -1e9

:func:`listwise_loss_sum` gives ``(loss sum over valid rows, valid-row
count)``.  A CUDA tensor goes to kernel B6 (``ops/listwise_kernel.py``
``listwise_loss_sum``); a CPU tensor to the JAX module's (B, B) math
(:func:`to_listwise_sample`,
:func:`listwise_loss_via_softmax_cross_entropy_with_logits`),
differentiated by autograd.  The CPU path is kept apart from the kernel's
plain version (``listwise_kernel.listwise_loss_fused_plain``), which
derives ``dlogits`` by hand as the kernel does: a training step on the
CPU, held against the same step on the card, thus checks the kernel's
gradient against autograd of the loss itself.

Symbols: B = batch size.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rec_now_tpu_torch.ops import listwise_kernel
from rec_now_tpu_torch.ops._build import is_cpu
from rec_now_tpu_torch.ops.listwise_kernel import MASKED_LOGIT, POS_NEG_TH


def row_has_value_greater_than(x: torch.Tensor, threshold) -> torch.Tensor:
    """Per row: does the row hold a value > threshold?"""
    return (x.float() > threshold).any(dim=-1)


def row_has_value_less_than(x: torch.Tensor, threshold) -> torch.Tensor:
    """Per row: does the row hold a value < threshold?"""
    return (x.float() < threshold).any(dim=-1)


def first_occurrence_mask(group_ids: torch.Tensor) -> torch.Tensor:
    """(B,) bool: True where sample i is the first with its group value."""
    g = group_ids.reshape(-1)
    idx = torch.arange(g.shape[0], device=g.device)
    same = g[:, None] == g[None, :]
    earlier = idx[None, :] < idx[:, None]
    return ~(same & earlier).any(dim=1)


class ListwiseBatch(NamedTuple):
    """Static-shape listwise view of a batch: (B, B) fields and a (B,)
    row mask; row i is the group anchored at sample i."""
    labels: torch.Tensor      # float -- row-normalized label distribution
    logits: torch.Tensor      # float -- member logits, others masked
    row_valid: torch.Tensor   # bool (B,)


def to_listwise_sample(group_ids: torch.Tensor, labels: torch.Tensor,
                       logits: torch.Tensor) -> ListwiseBatch:
    """Extract the (B, B) listwise view of a batch (``listwise.py:246``,
    logits masked)."""
    g = group_ids.reshape(-1)
    labels = labels.reshape(-1).float()
    logits = logits.reshape(-1)
    member = g[:, None] == g[None, :]
    member_f = member.float()
    dense_labels = labels[None, :] * member_f
    dense_logits = torch.where(
        member, logits[None, :],
        torch.full((), MASKED_LOGIT, dtype=logits.dtype,
                   device=logits.device))
    has_pos = row_has_value_greater_than(dense_labels, POS_NEG_TH)
    # has-neg on the (labels - th) matrix whose non-members are 0, as the
    # reference (listwise.py:286-290)
    has_neg = row_has_value_less_than((labels[None, :] - POS_NEG_TH)
                                      * member_f, 0.0)
    row_valid = first_occurrence_mask(g) & has_pos & has_neg
    label_sum = dense_labels.sum(dim=-1, keepdim=True)
    norm_labels = dense_labels / torch.where(
        label_sum == 0.0, torch.ones_like(label_sum), label_sum)
    return ListwiseBatch(labels=norm_labels.detach(), logits=dense_logits,
                         row_valid=row_valid)


def listwise_loss_via_softmax_cross_entropy_with_logits(
        labels_for_softmax: torch.Tensor, logits_for_softmax: torch.Tensor,
        row_valid: torch.Tensor) -> torch.Tensor:
    """Per-row softmax-CE (G,) over (G, B) group rows, 0 for an invalid
    row (``listwise.py:302-340`` with ``do_reduce=False``)."""
    log_probs = torch.log_softmax(logits_for_softmax, dim=-1)
    losses = -(labels_for_softmax.detach() * log_probs).sum(dim=-1)
    return losses * row_valid.to(losses.dtype)


def listwise_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                      groups: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss sum over valid rows, valid-row count); the count carries no
    gradient."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    groups = groups.reshape(-1)
    if not is_cpu(logits, "listwise_loss_sum"):
        return listwise_kernel.listwise_loss_sum(logits, labels, groups)
    lw = to_listwise_sample(groups, labels, logits)
    row_losses = listwise_loss_via_softmax_cross_entropy_with_logits(
        lw.labels, lw.logits, lw.row_valid)
    return row_losses.sum(), lw.row_valid.float().sum()
