"""In-batch pairwise loss: ``rec_now_tpu/losses/pairwise.py``
``pairwise_loss`` (:284-346) with the options of its kernel path.

Group a batch by one or more ids (``groups``: a (B,) tensor or a list,
AND-combined; the first is the main group), take every pair (i, j) of one
group with ``label_i > label_j`` (any float labels), both samples valid
under ``mask`` (a sample counts where ``mask > 0.5``, the JAX kernel's
test, on both devices) and, with ``only_use_wrong_order_pair``, the
negative scored above the positive, and average the BPR loss
``softplus(-(x_i - x_j) * factor)`` over the pairs, each weighted by
``(valid pairs in its main group) ** click_occurance_power`` when that
power is not 0 (0 for a group without pairs).

* **CUDA tensors** follow ``pairwise_loss_pallas``'s dispatch
  (``ops/pallas/pairwise_kernel.py:416-468``): with ``binary_labels`` (the
  caller's promise that labels are in {0, 1}, unchecked as in JAX), one
  group condition and no wrong-order filter, the loss kernel computes the
  occurrence weight itself (one launch of ``pair_loss_sum``); otherwise
  ``pair_loss_general_sum`` computes JAX's ``pair_row_counts`` ->
  ``same_group_matvec`` -> weights -> loss in one call (one launch of
  ``pair_loss_sum``, no launch of B7a or B7b): each row's group pair count
  ``gpc`` and its weight ``gpc ** power`` (0 where gpc is 0), with no
  gradient, on the one sort by main group that the loss takes (at B <=
  8,192).
* **CPU tensors** take the (B, B) math of the JAX module
  (:func:`generate_pair_mask`, :func:`_apply_sample_mask`,
  :func:`_calc_label_cond_and_weights`, :func:`_pair_occurance_weights`,
  :func:`bpr_loss_func`), differentiated by autograd.  It is kept apart
  from the kernel's plain version (``pairwise_kernel.pair_loss_fused_plain``,
  which derives dlogits by hand as the kernel does), so a training step on
  the CPU, held against the same step on the card, checks the kernel's
  gradient against autograd of the loss itself.

Options without a kernel path in JAX (``label_pair_to_weight_func``, a
custom ``pairloss_func``, extra keyword arguments) are not ported yet and
raise; the JAX module's blocked O(block * B) form serves only those.

Symbols: B = batch size.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from rec_now_tpu_torch.ops import pairwise_kernel
from rec_now_tpu_torch.ops._build import is_cpu
from rec_now_tpu_torch.ops.pairwise_kernel import GroupLike

SMALL_POSITIVE_FLOAT = 1.0e-10


def _group_list(groups: GroupLike) -> list:
    if isinstance(groups, torch.Tensor):
        return [groups.reshape(-1)]
    return [g.reshape(-1) for g in groups]


def generate_pair_mask(groups: GroupLike) -> torch.Tensor:
    """(B, B) bool mask of off-diagonal pairs that share every group
    (``pairwise.py:104-141``)."""
    mask = None
    for g in _group_list(groups):
        eye = torch.eye(g.shape[0], dtype=torch.bool, device=g.device)
        one = (g[:, None] == g[None, :]) & ~eye
        mask = one if mask is None else mask & one
    return mask


def _apply_sample_mask(pair_mask: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """AND the pair mask with both samples' validity (non-zero,
    ``pairwise.py:225-235``; :func:`pairwise_loss` hands it a 0/1 mask)."""
    if mask is None:
        return pair_mask
    m = mask.reshape(-1) != 0
    return pair_mask & m[:, None] & m[None, :]


def _calc_label_cond_and_weights(labels: torch.Tensor) -> torch.Tensor:
    """``label_i > label_j`` as a (B, B) bool (``pairwise.py:238-252``
    without a label-pair weight function)."""
    return labels[:, None] > labels[None, :]


def _pair_occurance_weights(groups: GroupLike, click_occurance_power: float,
                            pair_mask: torch.Tensor) -> torch.Tensor:
    """(B, B) per-pair weights ``count[i] ** power``, where ``count[i]``
    is the number of valid pairs whose row shares row i's main group; 0
    for a group with none (``pairwise.py:255-281``)."""
    g = _group_list(groups)[0]
    row_count = pair_mask.float().sum(dim=1)
    count = (g[:, None] == g[None, :]).float() @ row_count
    w = torch.where(count > 0,
                    count.clamp_min(1e-30) ** click_occurance_power,
                    torch.zeros_like(count))
    return w[:, None].expand(pair_mask.shape)


def bpr_loss_func(outputs_pos: torch.Tensor, outputs_neg: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  factor: float = 1.0, reduce_mean: bool = True,
                  pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BPR loss ``sum mask * w * softplus(-(pos - neg) * factor)``, over
    the pair count with ``reduce_mean`` (``pairwise.py:156-197``)."""
    logits = (outputs_pos - outputs_neg) * factor
    # softplus(-x) in the stable form of the JAX module's jax.nn.softplus
    losses = torch.clamp_min(-logits, 0.0) + torch.log1p(
        torch.exp(-logits.abs()))
    if weights is not None:
        losses = losses * weights
    m = pair_mask.to(losses.dtype)
    loss = (losses * m).sum()
    if reduce_mean:
        loss = loss / (m.sum() + SMALL_POSITIVE_FLOAT)
    return loss


def pairwise_loss(outputs: torch.Tensor, labels: torch.Tensor,
                  groups: GroupLike,
                  pairloss_func: Callable = bpr_loss_func,
                  only_use_wrong_order_pair: bool = False,
                  return_num_pair: bool = False,
                  click_occurance_power: float = 0.0,
                  mask: Optional[torch.Tensor] = None,
                  label_pair_to_weight_func: Optional[Callable] = None,
                  binary_labels: bool = False, factor: float = 1.0,
                  reduce_mean: bool = True, **kwargs
                  ) -> Union[torch.Tensor, tuple]:
    """In-batch pairwise BPR loss (module docstring).

    Args:
        outputs: per-sample logits, (B,) or (B, 1).
        labels: per-sample labels, same size.
        groups: a (B,) group-id tensor or a list of them (AND-combined;
            the first is the main group of the occurrence weight).
        only_use_wrong_order_pair: keep only pairs with x_neg > x_pos.
        return_num_pair: also return the pair count (no gradient).
        click_occurance_power: weight each pair by (#valid pairs in its
            main group) ** power.
        mask: optional (B,) per-sample validity; a sample counts where
            ``mask > 0.5`` on both devices.
        binary_labels: the caller's promise that labels are in {0, 1};
            lets the card compute the occurrence weight inside the loss
            kernel.  Ignored on the CPU.
        factor: inverse temperature on the logit gap.
        reduce_mean: divide by the pair count (JAX's default); False
            gives the sum, as the trainer takes it.

    Returns:
        The loss (and the pair count with ``return_num_pair``).
    """
    if (pairloss_func is not bpr_loss_func
            or label_pair_to_weight_func is not None or kwargs):
        raise NotImplementedError(
            "pairwise_loss: a custom pairloss_func, a "
            "label_pair_to_weight_func and extra keyword arguments are not "
            "ported yet; the port has the BPR loss of the JAX kernel path")
    outputs = outputs.reshape(-1)
    labels = labels.reshape(-1).to(outputs.dtype)
    glist = _group_list(groups)
    if mask is not None:
        # one 0/1 mask for both paths: the CPU math tests non-zero, the
        # kernels > 0.5
        mask = (mask.reshape(-1) > 0.5).to(outputs.dtype)
    if is_cpu(outputs, "pairwise_loss"):
        pair_mask = _apply_sample_mask(generate_pair_mask(glist), mask)
        pair_mask = pair_mask & _calc_label_cond_and_weights(labels)
        if only_use_wrong_order_pair:
            x = outputs.detach()
            pair_mask = pair_mask & (x[:, None] < x[None, :])
        weights = None
        if click_occurance_power != 0.0:
            weights = _pair_occurance_weights(glist, click_occurance_power,
                                              pair_mask)
        loss = bpr_loss_func(outputs[:, None], outputs[None, :], weights,
                             factor, reduce_mean, pair_mask)
        n_pair = pair_mask.float().sum()
    else:
        loss, n_pair = _pairwise_loss_kernels(
            outputs, labels, glist, factor, only_use_wrong_order_pair,
            click_occurance_power, mask, binary_labels)
        if reduce_mean:
            loss = loss / (n_pair + SMALL_POSITIVE_FLOAT)
    return (loss, n_pair) if return_num_pair else loss


def _pairwise_loss_kernels(outputs, labels, glist, factor, wrong_order,
                           power, mask, binary_labels):
    """(loss sum, pair count) on the card (``pairwise_kernel.py:437-464``):
    the in-kernel binary weight where the caller promised binary labels
    (one group, no wrong-order filter), else, with a power, the general
    loss, whose counts and weights take no gradient."""
    if power != 0.0 and not (binary_labels and len(glist) == 1
                             and not wrong_order):
        return pairwise_kernel.pair_loss_general_sum(
            outputs, labels, glist, factor, power, sample_mask=mask,
            wrong_order=wrong_order)
    return pairwise_kernel.pair_loss_sum(
        outputs, labels, glist, factor, power, sample_mask=mask,
        wrong_order=wrong_order)
