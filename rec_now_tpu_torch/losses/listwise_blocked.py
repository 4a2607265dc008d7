"""Row-blocked in-batch listwise loss, O(block * B) memory.

Counterpart of ``rec_now_tpu/losses/listwise_blocked.py``: the semantics
of :func:`rec_now_tpu_torch.losses.listwise.listwise_loss` (the anchor-row
form of the reference's group extraction), but a loop walks anchor-row
blocks, each forming only a (R, B) membership slab: normalized labels,
masked logits and the softmax-CE of each valid row.  The last block may
be shorter (JAX pads with anchors of an impossible group).

Backward memory stays O(R * B): one ``torch.autograd.Function`` keeps only
the logits, and its backward forms each block again and adds
``valid * member * (softmax * sum(labels) - labels)`` over the rows.  The
labels take no gradient (``stop_gradient`` in JAX).

Symbols: B batch, R = block_rows.
"""
from __future__ import annotations

import torch

from rec_now_tpu_torch.losses.pairwise_blocked import row_blocks
from rec_now_tpu_torch.ops.listwise_kernel import MASKED_LOGIT, POS_NEG_TH


def listwise_block(g: torch.Tensor, labels: torch.Tensor,
                   logits: torch.Tensor, i0: int, r: int, pos_neg_th: float,
                   masked: float, mask_logits: bool = True):
    """Rows i0 .. i0 + r - 1 of the listwise view: (valid (R,), member
    (R, B), normalized labels (R, B), logits (R, B), the non-members'
    set to ``masked`` where ``mask_logits``); the whole view is
    ``i0 = 0, r = B``."""
    b = g.shape[0]
    member = g[i0:i0 + r, None] == g[None, :]
    member_f = member.to(labels.dtype)
    # first-occurrence anchors only: no member column before the anchor
    col = torch.arange(b, device=g.device)
    row = torch.arange(i0, i0 + r, device=g.device)
    first = ~(member & (col[None, :] < row[:, None])).any(dim=1)
    dense_labels = labels[None, :] * member_f
    has_pos = (dense_labels > pos_neg_th).any(dim=1)
    has_neg = ((labels[None, :] - pos_neg_th) * member_f < 0.0).any(dim=1)
    valid = first & has_pos & has_neg
    label_sum = dense_labels.sum(dim=1, keepdim=True)
    y = dense_labels / torch.where(label_sum == 0.0,
                                   torch.ones_like(label_sum), label_sum)
    if not mask_logits:
        return valid, member, y, logits[None, :].expand(r, b)
    z = torch.where(member, logits[None, :],
                    torch.full((), masked, dtype=logits.dtype,
                               device=logits.device))
    return valid, member, y, z


class _BlockedListwise(torch.autograd.Function):
    """(sum of the valid rows' softmax-CE, valid-row count)."""

    @staticmethod
    def forward(ctx, logits, g, labels, block_rows, pos_neg_th, masked):
        total = logits.new_zeros(())
        count = logits.new_zeros(())
        for i0, r in row_blocks(g.shape[0], block_rows):
            valid, _, y, z = listwise_block(g, labels, logits, i0, r,
                                            pos_neg_th, masked)
            rows = -(y * torch.log_softmax(z, dim=1)).sum(dim=1)
            vf = valid.to(logits.dtype)
            total += (rows * vf).sum()
            count += vf.sum()
        ctx.save_for_backward(logits, g, labels)
        ctx.args = (block_rows, pos_neg_th, masked)
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, grad, _):
        logits, g, labels = ctx.saved_tensors
        block_rows, pos_neg_th, masked = ctx.args
        gx = torch.zeros_like(logits)
        for i0, r in row_blocks(g.shape[0], block_rows):
            valid, member, y, z = listwise_block(g, labels, logits, i0, r,
                                                 pos_neg_th, masked)
            # d(-sum y log_softmax(z)) / dz = softmax(z) sum(y) - y; only
            # member entries are the logits (the rest are constants)
            dz = torch.softmax(z, dim=1) * y.sum(dim=1, keepdim=True) - y
            keep = member & valid[:, None]
            gx += torch.where(keep, dz, torch.zeros_like(dz)).sum(dim=0)
        return gx * grad, None, None, None, None, None


def listwise_loss_blocked(group_ids: torch.Tensor, labels: torch.Tensor,
                          logits: torch.Tensor, block_rows: int = 1024,
                          pos_neg_th: float = POS_NEG_TH,
                          value_of_masked_logit: float = MASKED_LOGIT
                          ) -> torch.Tensor:
    """Blocked listwise softmax-CE loss: the mean over valid groups, 0.0
    when no group has both a label above and one below ``pos_neg_th``
    (``listwise_blocked.py:18-93``)."""
    g = group_ids.reshape(-1)
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    total, count = _BlockedListwise.apply(logits, g, labels, block_rows,
                                          pos_neg_th, value_of_masked_logit)
    loss = total / torch.where(count == 0.0, torch.ones_like(count), count)
    return torch.where(count == 0.0, torch.zeros_like(loss), loss)
