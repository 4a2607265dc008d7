"""In-batch pairwise BPR loss kernel (``csrc/pairwise.cu``), its wrapper
and plain version.

Counterpart of ``rec_now_tpu/ops/pallas/pairwise_kernel.py``
``pair_loss_sum`` / ``_pair_loss_fused_impl`` for the subset the trainer
calls (``rec_now_tpu/training/trainer.py:264-275``): one group
condition, binary labels, every sample valid, the default
``label_i > label_j`` order, no wrong-order filter, and the occurrence
weight ``w_i = (pos(g_i) * neg(g_i)) ** occurrence_power`` computed in
the kernel (0 for a group without pairs; 1 when the power is 0).

* :func:`pair_loss_fused` -- ``(loss_sum, n_pair, dlogits)`` in one
  launch: the kernel for a CUDA tensor, :func:`pair_loss_fused_plain`
  (the (B, B) formulas) for a CPU tensor.  ``pair_loss_sum.launches``
  counts the kernel's launches.
* :func:`pair_loss_sum` -- ``(loss_sum, n_pair)`` as a
  ``torch.autograd.Function``: the forward stashes dlogits, the backward
  only scales it; ``n_pair`` is not differentiable.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu


def pair_loss_fused_plain(logits: torch.Tensor, labels: torch.Tensor,
                          groups: torch.Tensor, factor: float = 1.0,
                          occurrence_power: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(loss_sum, n_pair, dlogits) from (B, B) tensors, written out
    (``pairwise_kernel.py:302-346``)."""
    x = logits.float()
    lab = labels.float()
    same = groups[:, None] == groups[None, :]
    valid = (same & (lab[:, None] > lab[None, :])).float()
    if occurrence_power != 0.0:
        samef = same.float()
        pos = samef @ lab
        gpc = pos * (samef.sum(1) - pos)
        w = torch.where(gpc > 0, gpc.clamp_min(1e-30) ** occurrence_power,
                        torch.zeros_like(gpc))
    else:
        w = torch.ones_like(x)
    d = (x[:, None] - x[None, :]) * factor
    wm = valid * w[:, None]
    softplus = torch.clamp_min(-d, 0.0) + torch.log1p(torch.exp(-d.abs()))
    loss = (softplus * wm).sum()
    s = -torch.sigmoid(-d) * factor * wm
    return loss, valid.sum(), s.sum(1) - s.sum(0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("pairwise")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pair_loss_splits.argtypes = [i32]
        lib.pair_loss_splits.restype = i32
        lib.pair_loss_f32.argtypes = [ptr, ptr, ptr, i32, f32, f32, ptr, ptr,
                                      ptr, i32, ptr]
        lib.pair_loss_f32.restype = i32
        lib._typed = True
    return lib


def pair_loss_fused(logits: torch.Tensor, labels: torch.Tensor,
                    groups: torch.Tensor, factor: float = 1.0,
                    occurrence_power: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits, labels (B,) float32, groups (B,) int -> (loss_sum, n_pair,
    dlogits); f32 scalars on the logits' device."""
    if is_cpu(logits, "pair_loss_sum"):
        return pair_loss_fused_plain(logits, labels, groups, factor,
                                     occurrence_power)
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
    scratch = torch.empty((1 + 3 * lib.pair_loss_splits(b)) * b,
                          dtype=torch.float32, device=dev)
    rc = lib.pair_loss_f32(logits.data_ptr(), labels.data_ptr(),
                           groups.data_ptr(), b, factor, occurrence_power,
                           scratch.data_ptr(), out.data_ptr(), dx.data_ptr(),
                           dev.index, _build.stream_of(logits))
    check_rc(lib, rc, "pair_loss_sum")
    pair_loss_sum.launches += 1
    return out[0], out[1], dx


class _PairLossSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, groups, factor, occurrence_power):
        loss, cnt, dx = pair_loss_fused(logits, labels, groups, factor,
                                        occurrence_power)
        ctx.save_for_backward(dx)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, g_cnt):
        (dx,) = ctx.saved_tensors
        return dx * g_loss, None, None, None, None


def pair_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                  groups: torch.Tensor, factor: float = 1.0,
                  occurrence_power: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of weighted BPR pair losses, pair count); gradients flow to
    ``logits`` only, through the dlogits the forward computed."""
    return _PairLossSum.apply(logits, labels, groups, factor,
                              occurrence_power)


pair_loss_sum.launches = 0
