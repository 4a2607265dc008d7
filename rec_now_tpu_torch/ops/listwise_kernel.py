"""In-batch listwise softmax-CE kernel (``csrc/listwise.cu``), its wrapper
and plain version.

Counterpart of ``rec_now_tpu/ops/pallas/listwise_kernel.py``
``listwise_loss_sum`` / ``_lw_fused_impl`` (:29-124): each sample anchors
its group's row; the row is valid when the sample is the group's first
occurrence and the group has a label above :data:`POS_NEG_TH` and one
below it (the JAX default, the one value its trainer uses).

* :func:`listwise_loss_fused` -- ``(loss_sum, count, dlogits)`` in one
  launch, ``dlogits[j] = sum_i valid_i (softmax_ij - p_ij)``: the kernel
  for a CUDA tensor, :func:`listwise_loss_fused_plain` (the (B, B)
  formulas, the gradient derived by hand as the kernel does) for a CPU
  tensor.  ``listwise_loss_sum.launches`` counts the kernel's launches.
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


def listwise_loss_fused_plain(logits: torch.Tensor, labels: torch.Tensor,
                              groups: torch.Tensor
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
    has_pos = (lab_row > POS_NEG_TH).any(dim=1)
    has_neg = ((lab[None, :] - POS_NEG_TH) * memberf < 0.0).any(dim=1)
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("listwise")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.listwise_splits.argtypes = [i32]
        lib.listwise_splits.restype = i32
        lib.listwise_f32.argtypes = [ptr, ptr, ptr, i32, f32, ptr, ptr, ptr,
                                     i32, ptr]
        lib.listwise_f32.restype = i32
        lib._typed = True
    return lib


def listwise_loss_fused(logits: torch.Tensor, labels: torch.Tensor,
                        groups: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits, labels (B,) float32, groups (B,) int -> (loss_sum, count,
    dlogits); f32 on the logits' device."""
    if is_cpu(logits, "listwise_loss_sum"):
        return listwise_loss_fused_plain(logits, labels, groups)
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
    out = torch.zeros(2, dtype=torch.float32, device=dev)
    dx = torch.zeros(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out[0], out[1], dx
    lib = _lib()
    scratch = torch.empty(6 * lib.listwise_splits(b) * b,
                          dtype=torch.float32, device=dev)
    rc = lib.listwise_f32(logits.data_ptr(), labels.data_ptr(),
                          groups.data_ptr(), b, POS_NEG_TH,
                          scratch.data_ptr(), out.data_ptr(), dx.data_ptr(),
                          dev.index, _build.stream_of(logits))
    check_rc(lib, rc, "listwise_loss_sum")
    listwise_loss_sum.launches += 1
    return out[0], out[1], dx


class _ListwiseLossSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, groups):
        loss, cnt, dx = listwise_loss_fused(logits, labels, groups)
        ctx.save_for_backward(dx)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, g_cnt):
        (dx,) = ctx.saved_tensors
        return dx * g_loss, None, None


def listwise_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                      groups: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of valid rows' softmax-CE, valid-row count); gradients flow
    to ``logits`` only, through the dlogits the forward computed."""
    return _ListwiseLossSum.apply(logits, labels, groups)


listwise_loss_sum.launches = 0
