"""In-batch listwise softmax-CE kernel (``csrc/listwise.cu``), its wrapper
and plain version.

Counterpart of ``rec_now_tpu/ops/pallas/listwise_kernel.py``
``listwise_loss_sum`` / ``_lw_fused_impl`` (:29-124): each sample anchors
its group's row; the row is valid when the sample is the group's first
occurrence and the group has a label above ``pos_neg_th`` and one below
it (:data:`POS_NEG_TH`, JAX's default, unless the caller gives another).
As in the reference, "above" is tested on the row's labels with the
non-members' set to 0: with a threshold below 0, every group of a batch
that holds another group has a label above it.

* :func:`listwise_loss_fused` -- ``(loss_sum, count, dlogits)`` in one
  call, ``dlogits[j] = sum_i valid_i (softmax_ij - p_ij)``: the kernel
  for a CUDA tensor (a sort by group in one block where B <=
  :data:`SORT_MAX`, else the O(B^2) sweep), :func:`listwise_loss_fused_plain`
  (the (B, B) formulas, the gradient derived by hand) for a CPU tensor.
  ``listwise_loss_sum.launches`` counts the kernel's calls.
* :func:`listwise_by_segments` -- the same function in the sort kernel's
  order (a stable sort by group, per-segment statistics, dx by segment),
  plain PyTorch, for the tests.
* :func:`listwise_loss_sum` -- ``(loss_sum, count)`` as a
  ``torch.autograd.Function``: the forward stashes dlogits (f32, one
  rounding), the backward only scales it; ``count`` is not
  differentiable.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu

POS_NEG_TH = 0.5
MASKED_LOGIT = -1e9     # non-members' logit in the (B, B) formulas
SORT_MAX = 8192         # the largest batch the one-block sort takes
# listwise_f32's paths: the sort where B <= SORT_MAX, else the sweep; or
# either one forced (the sort only where B <= SORT_MAX)
PATHS = {"auto": 0, "sort": 1, "sweep": 2}


def listwise_loss_fused_plain(logits: torch.Tensor, labels: torch.Tensor,
                              groups: torch.Tensor,
                              pos_neg_th: float = POS_NEG_TH
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(loss_sum, count, dlogits) from (B, B) tensors, written out
    (``listwise_kernel.py:29-55``, 81-97)."""
    x = logits.float()
    lab = labels.float()
    b = x.shape[0]
    member = groups[:, None] == groups[None, :]
    memberf = member.float()
    idx = torch.arange(b, device=x.device)
    earlier = member & (idx[None, :] < idx[:, None])
    lab_row = lab[None, :] * memberf
    has_pos = (lab_row > pos_neg_th).any(dim=1)
    has_neg = ((lab[None, :] - pos_neg_th) * memberf < 0.0).any(dim=1)
    valid = (~earlier.any(dim=1) & has_pos & has_neg).float()      # (B,)
    lsum = lab_row.sum(dim=1, keepdim=True)
    p = lab_row / torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
    z = torch.where(member, x[None, :], torch.full_like(memberf,
                                                        MASKED_LOGIT))
    zmax = z.max(dim=1, keepdim=True).values
    ez = torch.exp(z - zmax)
    sez = ez.sum(dim=1, keepdim=True)
    ce = (torch.log(sez) + zmax - (p * z).sum(dim=1, keepdim=True))[:, 0]
    dlogits = ((ez / sez - p) * valid[:, None]).sum(dim=0)
    return (ce * valid).sum(), valid.sum(), dlogits


def listwise_by_segments(logits: torch.Tensor, labels: torch.Tensor,
                         groups: torch.Tensor,
                         pos_neg_th: float = POS_NEG_TH
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(loss_sum, count, dlogits) in the sort kernel's order: a stable
    sort by group (a segment's first position is the group's first
    occurrence), each segment's max logit, sum of exp(x - max), label
    sum, sum of label * logit and label tests, then dx by segment, written
    back to the original index.  The loss is summed in float64."""
    x = logits.float()
    lab = labels.float()
    b = x.shape[0]
    order = torch.sort(groups.to(torch.int64), stable=True).indices
    xs, ls = x[order], lab[order]
    _, sizes = torch.unique_consecutive(groups.to(torch.int64)[order],
                                        return_counts=True)
    nseg = len(sizes)
    seg = torch.repeat_interleave(torch.arange(nseg, device=x.device),
                                  sizes)

    def seg_sum(v):
        return torch.zeros(nseg, dtype=v.dtype,
                           device=x.device).index_add_(0, seg, v)

    m = torch.full((nseg,), -torch.inf, device=x.device).scatter_reduce(
        0, seg, xs, "amax")
    e = torch.exp(xs - m[seg])
    s, lsum, lx = seg_sum(e), seg_sum(ls), seg_sum(ls * xs)
    # a non-member's 0 is above a negative threshold (module docstring)
    has_pos = (seg_sum((ls > pos_neg_th).float()) > 0) | (
        nseg > 1 and 0.0 > pos_neg_th)
    has_neg = seg_sum((ls < pos_neg_th).float()) > 0
    valid = has_pos & has_neg
    den = torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
    loss = (m + torch.log(s) - lx / den)[valid].double().sum()
    d_sorted = torch.where(valid[seg], e / s[seg] - ls / den[seg], 0.0)
    dx = torch.zeros(b, dtype=torch.float32,
                     device=x.device).index_copy_(0, order, d_sorted)
    return loss.float(), valid.sum().float(), dx


def _lib() -> ctypes.CDLL:
    lib = _build.load("listwise")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.listwise_scratch_words.argtypes = [i32, i32]
        lib.listwise_scratch_words.restype = ctypes.c_longlong
        lib.listwise_f32.argtypes = [ptr, ptr, ptr, i32, f32, i32, ptr, ptr,
                                     ptr, i32, ptr]
        lib.listwise_f32.restype = i32
        lib._typed = True
    return lib


def listwise_loss_fused(logits: torch.Tensor, labels: torch.Tensor,
                        groups: torch.Tensor, pos_neg_th: float = POS_NEG_TH
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits, labels (B,) float32, groups (B,) int -> (loss_sum, count,
    dlogits); f32 on the logits' device."""
    return _listwise_fused(logits, labels, groups, "auto", pos_neg_th)


def _listwise_fused(logits: torch.Tensor, labels: torch.Tensor,
                    groups: torch.Tensor, path: str,
                    pos_neg_th: float = POS_NEG_TH
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`listwise_loss_fused` on the kernel's ``path`` (a key of
    :data:`PATHS`; a CPU tensor takes the plain version whatever it is)."""
    if is_cpu(logits, "listwise_loss_sum"):
        return listwise_loss_fused_plain(logits, labels, groups, pos_neg_th)
    dev = logits.device
    check_input("logits", logits, 1, dev)
    check_input("labels", labels, 1, dev)
    groups = groups.to(torch.int32)
    check_input("groups", groups, 1, dev, torch.int32)
    b = logits.shape[0]
    if labels.shape[0] != b or groups.shape[0] != b:
        raise ValueError(f"logits {tuple(logits.shape)}, labels "
                         f"{tuple(labels.shape)} and groups "
                         f"{tuple(groups.shape)} must have one length")
    if path == "sort" and b > SORT_MAX:
        raise ValueError(f"the sort path takes B <= {SORT_MAX}, got {b}")
    if b == 0:
        out = torch.zeros(2, dtype=torch.float32, device=dev)
        return out[0], out[1], torch.zeros(0, dtype=torch.float32, device=dev)
    # both paths write every element of out and dx
    out = torch.empty(2, dtype=torch.float32, device=dev)
    dx = torch.empty(b, dtype=torch.float32, device=dev)
    lib = _lib()
    words = lib.listwise_scratch_words(b, PATHS[path])
    scratch = (torch.empty(words, dtype=torch.float32, device=dev)
               if words else None)
    rc = lib.listwise_f32(logits.data_ptr(), labels.data_ptr(),
                          groups.data_ptr(), b, pos_neg_th, PATHS[path],
                          None if scratch is None else scratch.data_ptr(),
                          out.data_ptr(), dx.data_ptr(), dev.index,
                          _build.stream_of(logits))
    check_rc(lib, rc, "listwise_loss_sum")
    listwise_loss_sum.launches += 1
    return out[0], out[1], dx


class _ListwiseLossSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, groups, pos_neg_th):
        loss, cnt, dx = listwise_loss_fused(logits, labels, groups,
                                            pos_neg_th)
        ctx.save_for_backward(dx)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, g_cnt):
        (dx,) = ctx.saved_tensors
        return dx * g_loss, None, None, None


def listwise_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                      groups: torch.Tensor, pos_neg_th: float = POS_NEG_TH
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of valid rows' softmax-CE, valid-row count); gradients flow
    to ``logits`` only, through the dlogits the forward computed."""
    return _ListwiseLossSum.apply(logits, labels, groups, float(pos_neg_th))


listwise_loss_sum.launches = 0
