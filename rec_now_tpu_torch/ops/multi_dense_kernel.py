"""Batched multi-expert dense kernel (``csrc/multi_dense.cu``), its
wrapper, plain version and autograd.

Counterpart of ``rec_now_tpu/ops/pallas/multi_dense_kernel.py``
``multi_dense_pallas``: ``(1|N, B, D) x (N, D, U) + (N, 1, U)`` with ReLU
or no activation fused, f32.

* :func:`multi_dense_xla` -- the plain version, the JAX module's formula
  (``rec_now_tpu/ops/multi_dense_op.py:21-39``): a batched product, or
  for a shared input one ``(B, D) x (D, N*U)`` einsum.  It is also the
  CPU path of ``ops/multi_dense_op.py``, differentiated there by
  autograd: it sums in the reference's order, and five Adam steps
  normalize each gradient element, so a weight whose gradient nearly
  cancels over the batch shows any change of order at lr scale.
* :func:`multi_dense_fused` -- the forward alone: the kernel for a CUDA
  tensor, :func:`multi_dense_xla` for a CPU tensor.
  ``multi_dense_fused.launches`` counts the kernel's launches.
* :func:`multi_dense` -- the same as a ``torch.autograd.Function`` (the
  CUDA path of ``ops/multi_dense_op.py``).  Its backward is
  :func:`multi_dense_bwd_plain`, plain PyTorch matmuls, as the JAX
  package differentiates the XLA formula
  (``rec_now_tpu/ops/multi_dense_op.py:67-72``): the JAX package has no
  backward kernel.

The activation of :func:`multi_dense_xla` is a name: None,
``"linear"`` / ``"none"`` or ``"relu"``, the ones the JAX models set on a
MultiDenseLayer; the kernel takes ``relu`` as a flag.

Symbols: B batch, D in-dim, N experts, U out-dim.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rec_now_tpu_torch.core.config import get_activation
from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu


def multi_dense_xla(inputs: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    activation: Optional[str]) -> torch.Tensor:
    """(1|N, B, D) x (N, D, U) [+ (N, 1, U)] with the activation."""
    if inputs.shape[0] == kernel.shape[0]:
        outputs = torch.bmm(inputs, kernel)
    else:  # shared (1, B, D) input, read once for the N experts
        outputs = torch.einsum("bd,ndu->nbu", inputs[0], kernel)
    if bias is not None:
        outputs = outputs + bias
    return get_activation(activation)(outputs)


def multi_dense_bwd_plain(inputs: torch.Tensor, kernel: torch.Tensor,
                          out: Optional[torch.Tensor], has_bias: bool,
                          g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """(d inputs, d kernel, d bias) for the output gradient g (N, B, U).

    ``out`` is the forward's output when ReLU was fused (its mask is
    ``out > 0``, ReLU's gradient at 0 being 0 as in JAX), else None.
    dW sums over B; a shared (1, B, D) input's gradient sums over the N
    experts; the bias's over B.
    """
    if out is not None:
        g = g * (out > 0).to(g.dtype)
    dk = torch.matmul(inputs.transpose(1, 2), g)               # (N, D, U)
    dx = torch.matmul(g, kernel.transpose(1, 2))               # (N, B, D)
    if inputs.shape[0] == 1:
        dx = dx.sum(dim=0, keepdim=True)
    db = g.sum(dim=1, keepdim=True) if has_bias else None
    return dx, dk, db


def _lib() -> ctypes.CDLL:
    lib = _build.load("multi_dense")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.multi_dense_f32.argtypes = ([ptr, i32, ptr, ptr, ptr]
                                        + [i32] * 6 + [ptr])
        lib.multi_dense_f32.restype = i32
        lib.multi_dense_gate_columns.argtypes = [i32] * 4
        lib.multi_dense_gate_columns.restype = i32
        lib._typed = True
    return lib


def takes_gate_kernel(nx: int, n: int, d: int, u: int) -> bool:
    """True where the card runs a (nx, B, d) x (n, d, u) call on the f32
    gate kernel, False where on the split-TF32 tile (builds the library)."""
    return _lib().multi_dense_gate_columns(nx, n, d, u) > 0


def _check(inputs, kernel, bias, dev) -> Tuple[int, int, int, int]:
    check_input("inputs", inputs, 3, dev)
    check_input("kernel", kernel, 3, dev)
    n, d, u = kernel.shape
    if inputs.shape[0] not in (1, n) or inputs.shape[2] != d:
        raise ValueError(f"inputs {tuple(inputs.shape)} do not fit kernel "
                         f"{tuple(kernel.shape)}: expected (1|{n}, B, {d})")
    if bias is not None:
        check_input("bias", bias, 3, dev)
        if tuple(bias.shape) != (n, 1, u):
            raise ValueError(f"bias {tuple(bias.shape)} is not ({n}, 1, {u})")
    return n, inputs.shape[1], d, u


def multi_dense_fused(inputs: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      relu: bool) -> torch.Tensor:
    """inputs (1|N, B, D), kernel (N, D, U), bias (N, 1, U) or None, all
    float32 -> (N, B, U), ReLU fused when ``relu``."""
    if is_cpu(inputs, "multi_dense"):
        return multi_dense_xla(inputs, kernel, bias,
                               "relu" if relu else None)
    dev = inputs.device
    n, b, d, u = _check(inputs, kernel, bias, dev)
    out = inputs.new_empty((n, b, u))           # f32 on inputs' device
    if b == 0:
        return out
    lib = _lib()
    rc = lib.multi_dense_f32(inputs.data_ptr(), inputs.shape[0],
                             kernel.data_ptr(),
                             None if bias is None else bias.data_ptr(),
                             out.data_ptr(), n, b, d, u, int(relu),
                             dev.index, _build.stream_of(inputs))
    check_rc(lib, rc, "multi_dense")
    multi_dense_fused.launches += 1
    return out


multi_dense_fused.launches = 0


class _MultiDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, kernel, bias, relu):
        out = multi_dense_fused(inputs, kernel, bias, relu)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(inputs, kernel, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        inputs, kernel, out = ctx.saved_tensors
        dx, dk, db = multi_dense_bwd_plain(inputs, kernel, out, ctx.has_bias,
                                           g)
        return dx, dk, db, None


def multi_dense(inputs: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """The kernel's forward (plain on CPU tensors) with the hand-written
    plain-PyTorch backward."""
    return _MultiDense.apply(inputs, kernel, bias, relu)
