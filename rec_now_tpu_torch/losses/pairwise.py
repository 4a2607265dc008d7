"""In-batch pairwise loss: ``rec_now_tpu/losses/pairwise.py``
``pairwise_loss`` (:284-420) with every option.

Group a batch by one or more ids (``groups``: a (B,) tensor or a list,
AND-combined; the first is the main group), take every pair (i, j) of one
group with ``label_i > label_j`` (any float labels; with a
``label_pair_to_weight_func``, every pair whose weight is > 0), both
samples valid under ``mask`` (a sample counts where ``mask > 0.5``, the
JAX kernel's test, on both devices) and, with
``only_use_wrong_order_pair``, the negative scored above the positive,
and average the pair loss (BPR, ``softplus(-(x_i - x_j) * factor)``, by
default) over the pairs, each weighted by ``(valid pairs in its main
group) ** click_occurance_power`` when that power is not 0 (0 for a group
without pairs) and by its label-pair weight.

The dispatch follows JAX's (:330-393):

* **The kernel path**, on CUDA tensors only: the BPR loss, the default
  label order and no extra keyword -- the configuration the kernels
  cover.  It follows ``pairwise_loss_pallas``'s dispatch
  (``ops/pallas/pairwise_kernel.py:416-468``): with ``binary_labels``
  (the caller's promise that labels are in {0, 1}, unchecked as in JAX),
  one group condition and no wrong-order filter, the loss kernel
  computes the occurrence weight itself (one launch of
  ``pair_loss_sum``); otherwise ``pair_loss_general_sum`` computes JAX's
  ``pair_row_counts`` -> ``same_group_matvec`` -> weights -> loss in one
  call (one launch of ``pair_loss_sum``).
* **The blocked form** (:mod:`~rec_now_tpu_torch.losses.pairwise_blocked`,
  O(block * B) memory forward and backward): every other call with B >=
  :data:`BLOCKED_MIN_BATCH` whose pair loss is blocked-capable
  (:func:`_blocked_capable`; BPR always is) -- on the CPU the default
  configuration too, as JAX's CPU path.
* **The dense form**, everything else: the (B, B) math of the JAX module
  (the pair mask and label-pair weights as the blocked form's block of
  all B rows, :func:`_pair_occurance_weights`, the pair loss),
  differentiated by autograd.  It is kept apart from the kernel's plain
  version (``pairwise_kernel.pair_loss_fused_plain``, which derives
  dlogits by hand as the kernel does), so a CPU step below
  :data:`BLOCKED_MIN_BATCH`, held against the same step on the card,
  checks the kernel's gradient against autograd of the loss itself.  At
  B >= :data:`BLOCKED_MIN_BATCH` the CPU takes the blocked form, whose
  BPR gradient is derived by hand too; a check of the card there also
  runs the dense form (``BLOCKED_MIN_BATCH`` raised) for autograd's.

Symbols: B = batch size.
"""
from __future__ import annotations

import functools
import inspect
import warnings
from typing import Callable, Optional, Union

import torch

from rec_now_tpu_torch.losses import pairwise_blocked
from rec_now_tpu_torch.losses.pairwise_blocked import (SMALL_POSITIVE_FLOAT,
                                                       group_list,
                                                       softplus_neg)
from rec_now_tpu_torch.ops import pairwise_kernel
from rec_now_tpu_torch.ops._build import is_cpu
from rec_now_tpu_torch.ops.pairwise_kernel import GroupLike

# Past this batch size the dense form's (B, B) f32 slabs (several live at
# once in forward and backward; 268 MB each at B = 8192) give way to the
# blocked form.
BLOCKED_MIN_BATCH = 4096


def _blocked_capable(fn: Callable) -> Optional[bool]:
    """Whether a pair-loss callable keeps the blocked form's tile contract
    (``pairwise.py:57-85``): it is called once a tile as ``fn(pos, neg, w,
    pair_mask=m, reduce_mean=False)`` and its tile sums are added, so it
    must take those keywords and be elementwise per pair with a sum over
    pairs.  ``fn.blocked_capable`` (on a ``functools.partial``, on its
    function) is authoritative; without it, a signature with named
    ``pair_mask`` and ``reduce_mean`` parameters gives None (capable by
    signature only: the caller warns once), any other False."""
    declared = getattr(fn, "blocked_capable", None)
    if isinstance(fn, functools.partial) and declared is None:
        declared = getattr(fn.func, "blocked_capable", None)
    if declared is not None:
        return bool(declared)
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    if "pair_mask" in params and "reduce_mean" in params:
        return None
    return False


def _callable_reduces(fn: Callable) -> bool:
    """The ``reduce_mean`` a bare ``fn(pos, neg, w, pair_mask=m)`` call
    uses: a partial's binding, else the signature's default, else True
    (``pairwise.py:88-101``)."""
    while isinstance(fn, functools.partial):
        if "reduce_mean" in fn.keywords:
            return bool(fn.keywords["reduce_mean"])
        fn = fn.func
    try:
        p = inspect.signature(fn).parameters.get("reduce_mean")
    except (TypeError, ValueError):
        return True
    if p is None or p.default is inspect.Parameter.empty:
        return True
    return bool(p.default)


def generate_pair_mask(groups: GroupLike,
                       only_upper_band: bool = False) -> torch.Tensor:
    """(B, B) bool mask of off-diagonal pairs that share every group
    (``pairwise.py:104-141``)."""
    glist = group_list(groups)
    b = glist[0].shape[0]
    mask = pairwise_blocked.block_group_mask(0, b, glist)
    if only_upper_band:
        # the diagonal band and one superdiagonal, as the reference's
        # tf.linalg.band_part(mask, 0, 1): with the diagonal gone, the
        # superdiagonal alone
        idx = torch.arange(b, device=mask.device)
        off = idx[None, :] - idx[:, None]
        mask &= (off >= 0) & (off <= 1)
    return mask


def vec_to_matrix_pair(vec: torch.Tensor):
    """A (B,) vector as the (B, B) ``mat[i, j] = vec[i]`` and its
    transpose, both broadcast views (``pairwise.py:144-153``)."""
    v = vec.reshape(-1)
    b = v.shape[0]
    mat = v[:, None].expand(b, b)
    return mat, mat.t()


def occurance_power_weight(group_id: torch.Tensor,
                           power: float = 0.0) -> torch.Tensor:
    """(B,) weight = (samples sharing the group value) ** power
    (``pairwise.py:206-222``)."""
    g = group_id.reshape(-1)
    counts = (g[:, None] == g[None, :]).float().sum(dim=1)
    if power != 1.0:
        counts = counts ** power
    return counts


def _pair_occurance_weights(groups: GroupLike, click_occurance_power: float,
                            pair_mask: torch.Tensor) -> torch.Tensor:
    """(B, B) per-pair weights ``count[i] ** power``, where ``count[i]``
    is the number of valid pairs whose row shares row i's main group; 0
    for a group with none (``pairwise.py:255-281``)."""
    g = group_list(groups)[0]
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
    the pair count with ``reduce_mean`` (``pairwise.py:156-197``); without
    a mask every entry of the broadcast shape counts."""
    losses = softplus_neg((outputs_pos - outputs_neg) * factor)
    if weights is not None:
        losses = losses * weights
    if pair_mask is not None:
        m = pair_mask.to(losses.dtype)
        losses = losses * m
        num = m.sum()
    else:
        num = torch.tensor(float(losses.numel()), dtype=losses.dtype,
                           device=losses.device)
    loss = losses.sum()
    if reduce_mean:
        loss = loss / (num + SMALL_POSITIVE_FLOAT)
    return loss


# elementwise per pair with a sum over pairs: safe to evaluate a tile at a
# time in the blocked form (the opt-in a custom callable copies)
bpr_loss_func.blocked_capable = True


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
    """In-batch pairwise loss (module docstring).

    The port consumes two keywords of its own, ``factor`` and
    ``reduce_mean``, which configure the default BPR loss (the trainer
    passes both); JAX's ``pairwise_loss`` has neither.  Every other extra
    keyword goes to ``label_pair_to_weight_func``, as in JAX, and takes
    the call off the kernel path.  A custom ``pairloss_func`` carries its
    own temperature and reduction (bind them, as JAX's trainer does with
    ``functools.partial(bpr_loss_func, factor=f, reduce_mean=False)``):
    with one, ``factor`` must stay 1 and ``reduce_mean`` True.

    Args:
        outputs: per-sample logits, (B,) or (B, 1).
        labels: per-sample labels, same size.
        groups: a (B,) group-id tensor or a list of them (AND-combined;
            the first is the main group of the occurrence weight).
        pairloss_func: ``fn(pos, neg, weights, pair_mask=m)`` over (B, B)
            tensors (dense form), or a tile of them with
            ``reduce_mean=False`` (blocked form, when capable).
        only_use_wrong_order_pair: keep only pairs with x_neg > x_pos.
        return_num_pair: also return the pair count (no gradient).
        click_occurance_power: weight each pair by (#valid pairs in its
            main group) ** power.
        mask: optional (B,) per-sample validity; a sample counts where
            ``mask > 0.5`` on both devices.
        label_pair_to_weight_func: ``fn(label_i, label_j, **kwargs)`` over
            (B, B) (or (R, B)) label tensors -> per-pair weights; pairs
            with weight <= 0 are dropped.
        binary_labels: the caller's promise that labels are in {0, 1};
            lets the card compute the occurrence weight inside the loss
            kernel.  Ignored off the kernel path.
        factor: inverse temperature on the logit gap of the BPR loss.
        reduce_mean: divide the BPR loss by the pair count (JAX's
            default); False gives the sum, as the trainer takes it.

    Returns:
        The loss (and the pair count with ``return_num_pair``).
    """
    custom = pairloss_func is not bpr_loss_func
    if custom and (factor != 1.0 or not reduce_mean):
        raise ValueError(
            "pairwise_loss: factor and reduce_mean configure the default "
            "BPR loss; bind them into a custom pairloss_func")
    outputs = outputs.reshape(-1)
    labels = labels.reshape(-1).to(outputs.dtype)
    glist = group_list(groups)
    if mask is not None:
        # one 0/1 mask for every path: the CPU math tests non-zero, the
        # kernels > 0.5
        mask = (mask.reshape(-1) > 0.5).to(outputs.dtype)
    kernel_ok = (not custom and label_pair_to_weight_func is None
                 and not kwargs)
    if kernel_ok and not is_cpu(outputs, "pairwise_loss"):
        loss, n_pair = _pairwise_loss_kernels(
            outputs, labels, glist, factor, only_use_wrong_order_pair,
            click_occurance_power, mask, binary_labels)
        if reduce_mean:
            loss = loss / (n_pair + SMALL_POSITIVE_FLOAT)
        return (loss, n_pair) if return_num_pair else loss

    weight_fn = label_pair_to_weight_func
    if weight_fn is not None and kwargs:
        weight_fn = functools.partial(weight_fn, **kwargs)
    capable = True if not custom else _blocked_capable(pairloss_func)
    if outputs.shape[0] >= BLOCKED_MIN_BATCH and capable is not False:
        if capable is None:
            warnings.warn(
                "pairwise_loss: routing custom pairloss_func "
                f"{getattr(pairloss_func, '__name__', pairloss_func)!r} "
                "through the blocked O(block*B) path because it declares "
                "pair_mask/reduce_mean keywords; if its reduction is not a "
                "sum over pairs (e.g. row-normalized or max-based), set "
                "fn.blocked_capable = False to keep the dense path, or "
                "True to silence this warning.", stacklevel=2)
        return pairwise_blocked.pairwise_loss_blocked(
            outputs, labels, glist, factor=factor,
            only_use_wrong_order_pair=only_use_wrong_order_pair,
            return_num_pair=return_num_pair,
            click_occurance_power=click_occurance_power, mask=mask,
            label_pair_to_weight_func=weight_fn,
            pairloss_func=pairloss_func if custom else None,
            reduce_mean=(_callable_reduces(pairloss_func) if custom
                         else reduce_mean))

    pair_mask, weights = pairwise_blocked.block_pair_mask(
        0, outputs.shape[0], glist, labels,
        None if mask is None else mask != 0, outputs.detach(),
        only_use_wrong_order_pair, weight_fn)
    if click_occurance_power != 0.0:
        occ = _pair_occurance_weights(glist, click_occurance_power,
                                      pair_mask)
        weights = occ if weights is None else weights * occ
    if custom:
        pos, neg = vec_to_matrix_pair(outputs)
        loss = pairloss_func(pos, neg, weights, pair_mask=pair_mask)
    else:
        loss = bpr_loss_func(outputs[:, None], outputs[None, :], weights,
                             factor, reduce_mean, pair_mask)
    n_pair = pair_mask.float().sum()
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
