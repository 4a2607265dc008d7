"""In-batch listwise softmax-CE loss: ``rec_now_tpu/losses/listwise.py``.

Every sample is a candidate anchor of its group's row; only the first
occurrence of each group value is a valid anchor, and only when the group
has a label above and a label below ``pos_neg_th`` (0.5).  The listwise
matrices are (B, B):

    member[i, j] = group[j] == group[i]
    labels[i, j] = labels[j] * member[i, j], normalized per row
    logits[i, j] = logits[j] if member[i, j] else value_of_masked_logit

* :func:`listwise_loss_sum` -- ``(loss sum over valid rows, valid-row
  count)``, what the trainer calls.  A CUDA tensor goes to kernel B6
  (``ops/listwise_kernel.py`` ``listwise_loss_sum``); a CPU tensor to the
  JAX module's (B, B) math (:func:`to_listwise_sample`,
  :func:`listwise_loss_via_softmax_cross_entropy_with_logits`),
  differentiated by autograd.  The CPU path is kept apart from the
  kernel's plain version (``listwise_kernel.listwise_loss_fused_plain``),
  which derives ``dlogits`` by hand as the kernel does: a training step
  on the CPU, held against the same step on the card, thus checks the
  kernel's gradient against autograd of the loss itself.
* :func:`listwise_loss` -- the public mean over valid rows (0 when none
  is valid, ``listwise.py:185-224``): B6 on a CUDA tensor at the
  kernel's mask value (-1e9; any threshold), else the blocked form
  (``losses/listwise_blocked.py``) at B >= ``BLOCKED_MIN_BATCH`` and the
  (B, B) form below it.

Symbols: B = batch size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rec_now_tpu_torch.losses import listwise_blocked
from rec_now_tpu_torch.losses import pairwise as _pairwise
from rec_now_tpu_torch.ops import listwise_kernel
from rec_now_tpu_torch.ops._build import is_cpu
from rec_now_tpu_torch.ops.listwise_kernel import MASKED_LOGIT, POS_NEG_TH


def row_not_all_zero(x: torch.Tensor) -> torch.Tensor:
    """Per row: does the row hold a non-zero value?"""
    return (x.float() != 0.0).any(dim=-1)


def row_has_value_greater_than(x: torch.Tensor, threshold) -> torch.Tensor:
    """Per row: does the row hold a value > threshold?"""
    return (x.float() > threshold).any(dim=-1)


def row_has_value_less_than(x: torch.Tensor, threshold) -> torch.Tensor:
    """Per row: does the row hold a value < threshold?"""
    return (x.float() < threshold).any(dim=-1)


def nan_to_zero(val: torch.Tensor) -> torch.Tensor:
    """NaN -> 0.0."""
    return torch.where(torch.isnan(val), torch.zeros_like(val), val)


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
    mask: torch.Tensor        # bool -- group membership
    labels: torch.Tensor      # float -- row-normalized label distribution
    logits: torch.Tensor      # float -- member logits, others masked
    row_valid: torch.Tensor   # bool (B,)


def to_listwise_sample(group_ids: torch.Tensor, labels: torch.Tensor,
                       logits: torch.Tensor, do_mask_logits: bool = True,
                       value_of_masked_logit: float = MASKED_LOGIT,
                       pos_neg_th: float = POS_NEG_TH) -> ListwiseBatch:
    """Extract the (B, B) listwise view of a batch (``listwise.py:88-141``):
    a group is valid with a label > ``pos_neg_th`` and one below it; with
    ``do_mask_logits`` non-members' logits become
    ``value_of_masked_logit``.  The blocked form's block of all B rows
    (``listwise_blocked.listwise_block``)."""
    g = group_ids.reshape(-1)
    labels = labels.reshape(-1).float()
    logits = logits.reshape(-1)
    valid, member, norm_labels, dense_logits = listwise_blocked.listwise_block(
        g, labels, logits, 0, g.shape[0], pos_neg_th, value_of_masked_logit,
        do_mask_logits)
    return ListwiseBatch(mask=member, labels=norm_labels.detach(),
                         logits=dense_logits, row_valid=valid)


def listwise_loss_via_softmax_cross_entropy_with_logits(
        labels_for_softmax: torch.Tensor, logits_for_softmax: torch.Tensor,
        weights: Optional[torch.Tensor] = None, do_reduce: bool = True,
        row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax-CE over (G, B) group rows (``listwise.py:144-182``).

    Each row's loss is ``-sum(labels * log_softmax(logits))``, times its
    ``weights`` entry (G,) if given.  With ``row_valid`` an invalid row
    adds to neither the sum nor the count: ``do_reduce`` gives the mean
    over valid rows (0 with none), else the per-row losses (0 for an
    invalid row).  Without it, the mean over all rows (NaN -> 0), or the
    per-row losses.  The labels take no gradient."""
    log_probs = torch.log_softmax(logits_for_softmax, dim=-1)
    losses = -(labels_for_softmax.detach() * log_probs).sum(dim=-1)
    if weights is not None:
        losses = losses * weights
    if row_valid is not None:
        valid_f = row_valid.to(losses.dtype)
        losses = losses * valid_f
        if not do_reduce:
            return losses
        denom = valid_f.sum()
        loss = losses.sum() / torch.where(denom == 0.0,
                                          torch.ones_like(denom), denom)
        return torch.where(denom == 0.0, torch.zeros_like(loss), loss)
    if do_reduce:
        return nan_to_zero(losses.mean())
    return losses


def listwise_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                      groups: torch.Tensor, pos_neg_th: float = POS_NEG_TH
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss sum over valid rows, valid-row count); the count carries no
    gradient."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    groups = groups.reshape(-1)
    if not is_cpu(logits, "listwise_loss_sum"):
        return listwise_kernel.listwise_loss_sum(logits, labels, groups,
                                                 pos_neg_th)
    lw = to_listwise_sample(groups, labels, logits, pos_neg_th=pos_neg_th)
    row_losses = listwise_loss_via_softmax_cross_entropy_with_logits(
        lw.labels, lw.logits, do_reduce=False, row_valid=lw.row_valid)
    return row_losses.sum(), lw.row_valid.float().sum()


def listwise_loss(group_ids: torch.Tensor, labels: torch.Tensor,
                  logits: torch.Tensor, pos_neg_th: float = POS_NEG_TH,
                  value_of_masked_logit: float = MASKED_LOGIT
                  ) -> torch.Tensor:
    """The in-batch listwise loss: the mean softmax-CE over valid groups,
    0.0 when none is valid (``listwise.py:185-224``; module docstring for
    the dispatch).  B6 takes a CUDA tensor when the mask value is the
    kernel's (-1e9), whatever the threshold, as JAX's kernel path."""
    g = group_ids.reshape(-1)
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    if (not is_cpu(logits, "listwise_loss")
            and value_of_masked_logit == MASKED_LOGIT):
        total, count = listwise_kernel.listwise_loss_sum(logits, labels, g,
                                                         pos_neg_th)
        loss = total / torch.where(count == 0.0, torch.ones_like(count),
                                   count)
        return torch.where(count == 0.0, torch.zeros_like(loss), loss)
    if g.shape[0] >= _pairwise.BLOCKED_MIN_BATCH:
        return listwise_blocked.listwise_loss_blocked(
            g, labels, logits, pos_neg_th=pos_neg_th,
            value_of_masked_logit=value_of_masked_logit)
    lw = to_listwise_sample(g, labels, logits, do_mask_logits=True,
                            value_of_masked_logit=value_of_masked_logit,
                            pos_neg_th=pos_neg_th)
    return listwise_loss_via_softmax_cross_entropy_with_logits(
        lw.labels, lw.logits, row_valid=lw.row_valid)
