"""Row-blocked in-batch pairwise loss, O(block * B) memory.

Counterpart of ``rec_now_tpu/losses/pairwise_blocked.py``: the semantics
of :func:`rec_now_tpu_torch.losses.pairwise.pairwise_loss`, but the (B, B)
pair structure is never formed.  A loop walks row blocks of
``block_rows`` rows, each forming only a (R, B) slab; the last block may
be shorter (the JAX module pads the batch to a multiple of ``block_rows``,
a TPU layout the port does not copy).

With occurrence weighting there are two passes:

  pass 1: row_count[k] = valid pairs anchored at row k, block by block;
          gpc[i] = the sum of row_count over row i's main group (exact
          integer sums);
  pass 2: the per-pair losses, row i's weighted by gpc[i] ** power (0
          where gpc[i] is 0), summed.

Backward memory stays O(R * B) too.  The BPR fast path is one
``torch.autograd.Function`` that keeps only the logits: its backward
forms each block again and adds d(loss)/d(outputs) from the row side and
from the column side.  A custom ``pairloss_func`` runs each block under
``torch.utils.checkpoint``, which recomputes the block in backward.  The
masks, the label-pair weights and the occurrence counts take no gradient
(``stop_gradient`` in JAX).

Symbols: B batch, R = block_rows.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

SMALL_POSITIVE_FLOAT = 1.0e-10


def group_list(groups) -> List[torch.Tensor]:
    """One (B,) group tensor or a list of them -> a list of (B,)."""
    if isinstance(groups, torch.Tensor):
        return [groups.reshape(-1)]
    return [g.reshape(-1) for g in groups]


def block_group_mask(i0: int, r: int,
                     glist: List[torch.Tensor]) -> torch.Tensor:
    """(R, B) bool: the rows i0 .. i0 + r - 1's pairs (i, j), j != i,
    that share every group."""
    rows = slice(i0, i0 + r)
    pm = None
    for g in glist:
        one = g[rows, None] == g[None, :]
        pm = one if pm is None else pm & one
    b = glist[0].shape[0]
    row_idx = torch.arange(i0, i0 + r, device=pm.device)
    return pm & (torch.arange(b, device=pm.device)[None, :]
                 != row_idx[:, None])


def block_pair_mask(i0: int, r: int, glist: List[torch.Tensor],
                    labels: torch.Tensor, mask: Optional[torch.Tensor],
                    x: torch.Tensor, wrong_order: bool,
                    weight_fn: Optional[Callable]
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(R, B) bool pair mask (and the label-pair weights, or None) of the
    rows i0 .. i0 + r - 1; ``x`` is the detached logits and ``mask`` a
    (B,) bool or None (``pairwise_blocked.py:40-76``).  The dense form's
    mask is the block of all B rows."""
    b = labels.shape[0]
    rows = slice(i0, i0 + r)
    pm = block_group_mask(i0, r, glist)
    if mask is not None:
        pm &= mask[rows, None] & mask[None, :]
    weights = None
    if weight_fn is None:
        pm &= labels[rows, None] > labels[None, :]
    else:
        weights = weight_fn(labels[rows, None].expand(r, b),
                            labels[None, :].expand(r, b)).detach()
        pm &= weights > 0
    if wrong_order:
        pm &= x[rows, None] < x[None, :]
    return pm, weights


def row_blocks(b: int, block_rows: int) -> Iterator[Tuple[int, int]]:
    """(first row, rows) of each block; the last may be shorter."""
    for i0 in range(0, b, block_rows):
        yield i0, min(block_rows, b - i0)


def softplus_neg(logits: torch.Tensor) -> torch.Tensor:
    """softplus(-x) in the stable form of ``jax.nn.softplus``."""
    return torch.clamp_min(-logits, 0.0) + torch.log1p(
        torch.exp(-logits.abs()))


class _BlockedBPR(torch.autograd.Function):
    """Sum over the blocks of ``coef * softplus(-(x_i - x_j) * factor)``;
    ``coef(x_detached, i0, r)`` gives a block's (R, B) pair mask times its
    weights.  Only ``x`` is kept for backward."""

    @staticmethod
    def forward(ctx, x, coef, block_rows, factor):
        total = x.new_zeros(())
        for i0, r in row_blocks(x.shape[0], block_rows):
            logits = (x[i0:i0 + r, None] - x[None, :]) * factor
            total += (softplus_neg(logits) * coef(x, i0, r)).sum()
        ctx.save_for_backward(x)
        ctx.coef, ctx.block_rows, ctx.factor = coef, block_rows, factor
        return total

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        gx = torch.zeros_like(x)
        for i0, r in row_blocks(x.shape[0], ctx.block_rows):
            logits = (x[i0:i0 + r, None] - x[None, :]) * ctx.factor
            # d softplus(-l) / dl = -sigmoid(-l); l moves with x_i and -x_j
            s = torch.sigmoid(-logits) * ctx.coef(x, i0, r) * ctx.factor
            gx[i0:i0 + r] -= s.sum(dim=1)
            gx += s.sum(dim=0)
        return gx * grad, None, None, None


def pairwise_loss_blocked(outputs: torch.Tensor, labels: torch.Tensor,
                          groups, block_rows: int = 1024,
                          factor: float = 1.0,
                          only_use_wrong_order_pair: bool = False,
                          return_num_pair: bool = False,
                          click_occurance_power: float = 0.0,
                          mask: Optional[torch.Tensor] = None,
                          label_pair_to_weight_func: Optional[Callable]
                          = None,
                          reduce_mean: bool = True,
                          pairloss_func: Optional[Callable] = None):
    """Blocked pairwise loss; the semantics of ``pairwise_loss`` (BPR by
    default).

    Args:
        outputs, labels, groups, mask, label_pair_to_weight_func,
        only_use_wrong_order_pair, click_occurance_power,
        return_num_pair: as in ``pairwise_loss`` (a sample counts where
            ``mask`` is non-zero, as JAX's ``astype(bool)``).
        block_rows: rows a block; the last block takes what is left.
        factor: BPR inverse temperature (not used with a
            ``pairloss_func``: bind a temperature into the callable).
        reduce_mean: divide by the pair count (+1e-10).
        pairloss_func: an optional custom pair loss, called once a block
            as ``fn(pos, neg, weights, pair_mask=m, reduce_mean=False)``
            on (R, B) tensors (``m`` a float 0/1 mask, ``weights`` None
            or (R, B)), which must return the SUM of its per-pair losses
            over the valid entries: losses elementwise in (pos, neg, w),
            as :func:`~rec_now_tpu_torch.losses.pairwise.bpr_loss_func`.
            None = the BPR fast path.

    Returns:
        The loss (and the pair count, no gradient, with
        ``return_num_pair``).
    """
    outputs = outputs.reshape(-1)
    labels = labels.reshape(-1).to(outputs.dtype)
    glist = group_list(groups)
    if mask is not None:
        mask = mask.reshape(-1) != 0
    b = outputs.shape[0]

    def pair_mask(x, i0, r):
        return block_pair_mask(i0, r, glist, labels, mask, x.detach(),
                               only_use_wrong_order_pair,
                               label_pair_to_weight_func)

    occ_w = None
    with torch.no_grad():
        n = torch.zeros((), dtype=torch.int64, device=outputs.device)
        row_count = []
        for i0, r in row_blocks(b, block_rows):
            count = pair_mask(outputs, i0, r)[0].sum(dim=1)
            row_count.append(count)
            n += count.sum()
        if click_occurance_power != 0.0:
            _, inv = torch.unique(glist[0], return_inverse=True)
            per_group = torch.zeros(b, dtype=torch.int64,
                                    device=outputs.device)
            per_group.index_add_(0, inv, torch.cat(row_count))
            gpc = per_group[inv].to(outputs.dtype)
            occ_w = torch.where(
                gpc > 0, gpc.clamp_min(1.0) ** click_occurance_power,
                torch.zeros_like(gpc))
        n = n.to(outputs.dtype)

    def coef(x, i0, r):
        """A block's (R, B) mask * weights * occurrence weights, or the
        weights alone as ``pairloss_func`` takes them (None when none)."""
        pm, w = pair_mask(x, i0, r)
        if occ_w is not None:
            occ = occ_w[i0:i0 + r, None]
            w = occ.expand(r, b) if w is None else w * occ
        return pm, w

    if pairloss_func is None:
        def bpr_coef(x, i0, r):
            pm, w = coef(x, i0, r)
            c = pm.to(x.dtype)
            return c if w is None else c * w
        total = _BlockedBPR.apply(outputs, bpr_coef, block_rows, factor)
    else:
        def tile(x, i0, r):
            pm, w = coef(x, i0, r)
            pos = x[i0:i0 + r, None].expand(r, b)
            neg = x[None, :].expand(r, b)
            return pairloss_func(pos, neg, w, pair_mask=pm.to(x.dtype),
                                 reduce_mean=False)
        total = outputs.new_zeros(())
        for i0, r in row_blocks(b, block_rows):
            total = total + checkpoint(tile, outputs, i0, r,
                                       use_reentrant=False)
    loss = total / (n + SMALL_POSITIVE_FLOAT) if reduce_mean else total
    return (loss, n) if return_num_pair else loss
