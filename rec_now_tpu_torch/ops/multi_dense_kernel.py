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
  tensor, :func:`multi_dense_xla` for a CPU tensor.  A CUDA call runs one
  of three kernels (``csrc/multi_dense.cu``): the f32 gate kernel for a
  shared input with N * U <= 16 (:func:`takes_gate_kernel`); a ``wgmma``
  kernel fed by TMA, W split into TF32 planes once a call inside the
  launch, for a shared input that :func:`takes_wgmma_bank` takes (D % 4
  == 0, x 16-byte aligned, N * U > 16, D and B * N * U past the
  crossover; its passes the widest of 200, 128 or 64 units that divides
  U); the split-TF32 ``mma.sync`` tile for everything else (per-expert
  inputs, config 4's banks, shallow or small calls).
  The two tensor-core designs share the kernel name ``multi_dense_tc``.
  ``multi_dense_fused.launches`` counts the launches, each also counted
  in ``multi_dense.mma`` (``core/profiling.count``) and in
  ``multi_dense.tc`` (either tensor-core design) or ``multi_dense.gate``;
  a ``wgmma`` launch also in ``multi_dense.tc_wgmma``.
* :func:`linear_wg` -- one ``nn.Linear`` layer, ``x (B, D) W^T + b``
  with ReLU or none, on B8's ``wgmma`` kernel (``csrc/multi_dense.cu``
  (c)), the weight read in ``nn.Linear``'s own (U, D) storage; None where
  :func:`wgmma_plan` refuses the call, which the caller then runs its
  own way.  ``linear_wg.launches`` counts its launches, each also counted
  in ``multi_dense.wgmma``.  ``models/tower.py``'s ``DNNTower`` asks it
  for each layer when no gradient is recorded.
* :func:`cross_wg` -- one layer of DCN-V2's low-rank cross,
  ``x0 * ((x V) W + b) + x``, as two launches of the same kernel through
  one C call: ``u = x V``, then ``u W`` with ``x0 * (. + b) + x`` in the
  epilogue, V and W read in their (in, out) storage; None where
  :func:`cross_plan` refuses the call.  ``cross_wg.launches`` counts its
  launches (two a layer), each layer also counted once in
  ``cross.wgmma``.  ``layers/low_rank_cross_layer.py`` asks it for each
  layer when no gradient is recorded.
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
import functools
from typing import Dict, Optional, Tuple

import torch

from rec_now_tpu_torch.core import profiling
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
                                        + [i32] * 5 + [ptr, i32, ptr])
        lib.multi_dense_f32.restype = i32
        lib.multi_dense_bank_scratch.argtypes = [i32] * 5
        lib.multi_dense_bank_scratch.restype = ctypes.c_longlong
        lib.multi_dense_gate_columns.argtypes = [i32] * 4
        lib.multi_dense_gate_columns.restype = i32
        lib.multi_dense_wg_f32.argtypes = ([ptr] * 4 + [i32] * 4
                                           + [ptr, i32, ptr])
        lib.multi_dense_wg_f32.restype = i32
        lib.multi_dense_wg_scratch.argtypes = [i32] * 4
        lib.multi_dense_wg_scratch.restype = ctypes.c_longlong
        lib.cross_wg_f32.argtypes = [ptr] * 6 + [i32] * 3 + [ptr, i32, ptr]
        lib.cross_wg_f32.restype = i32
        lib.cross_wg_scratch.argtypes = [i32] * 4
        lib.cross_wg_scratch.restype = ctypes.c_longlong
        lib._typed = True
    return lib


# the least output (B * U) that wgmma_plan gives the wgmma kernel: a unit
# of its work is a 128 x 128-to-200 tile walking all of D, and each call
# splits the whole weight first, so with few tiles it loses to the
# library's smaller ones.  Device ms on an H100 (torch.profiler), the
# kernel against F.linear + ReLU: 400 -> 400 at B = 1,024, 2,048, 4,096,
# 8,192: 0.0282 / 0.0174, 0.0287 / 0.0246, 0.0294 / 0.0428, 0.0301 /
# 0.0771; 512 -> 256: 0.0215 / 0.0157, 0.0218 / 0.0207, 0.0222 / 0.0327,
# 0.0226 / 0.0541 (``chip_smoke.py`` phase 3 prints these)
WGMMA_MIN_OUTPUTS = 2 ** 20


def wgmma_plan(b: int, d: int, u: int, aligned: bool) -> bool:
    """True where the card runs a (b, d) x (u, d)^T layer on B8's
    ``wgmma`` kernel: x's rows on the 16-byte grid that TMA reads
    (d % 4 == 0 and x ``aligned`` to 16 bytes) and at least
    :data:`WGMMA_MIN_OUTPUTS` outputs.  Shapes and alignment alone
    decide."""
    return aligned and d % 4 == 0 and b * u >= WGMMA_MIN_OUTPUTS


# the least b * min(d, r) that cross_plan gives the wgmma kernel for a
# (b, d) cross layer of rank r: each of its two products' units is a
# 128-row tile walking all of its depth, so the narrower one sets how many
# units fill the card.  Device ms on an H100 (torch.profiler), the two
# launches against x @ V, addmm and addcmul in float32, 3,456 wide at rank
# 512, B = 1,024, 2,048, 4,096, 8,192: 0.2065 / 0.1962, 0.2507 / 0.3776,
# 0.3452 / 0.7351, 0.6590 / 1.3455 (``chip_smoke.py`` phase 3 prints
# these): the library wins at 1,024 x 512 = 2^19, the kernel from 2^20
CROSS_MIN_OUTPUTS = 2 ** 20


def cross_plan(b: int, d: int, r: int, aligned: bool) -> bool:
    """True where the card runs a (b, d) low-rank cross layer of rank r
    on B8's ``wgmma`` kernel: both products' inputs on the 16-byte grid
    that TMA reads (d % 4 == 0 and r % 4 == 0, x and x0 ``aligned`` to
    16 bytes) and b * min(d, r) at least :data:`CROSS_MIN_OUTPUTS`.
    Shapes and alignment alone decide."""
    return (aligned and d % 4 == 0 and r % 4 == 0
            and b * min(d, r) >= CROSS_MIN_OUTPUTS)


@functools.lru_cache(maxsize=None)
def takes_gate_kernel(nx: int, n: int, d: int, u: int) -> bool:
    """True where the card runs a (nx, B, d) x (n, d, u) call on the f32
    gate kernel, False where on a tensor-core design (builds the library;
    the shape alone decides, so each shape asks the library once)."""
    return _lib().multi_dense_gate_columns(nx, n, d, u) > 0


# where takes_wgmma_bank gives a shared-input bank the wgmma design: its
# depth D and its outputs B * N * U.  Each call splits all of W behind a
# grid barrier and then walks D in 128-row units, ~1 us more than the
# tile's launch, while the tile runs its products at a third of the rate.
# Device ms on an H100 (torch.profiler), wgmma / tile (chip_smoke.py
# phase 3 prints the sweep): every bank of D >= 192 measured, from 16,384
# outputs up, ran faster on wgmma, e.g. (1, 64, 2,176) x (4, 2,176, 512) 0.0866 / 0.3463, (1, 8,192,
# 512) x (4, 512, 256) 0.0972 / 0.1782, (1, 2,048, 192) x (2, 192, 64)
# 0.0128 / 0.0147; shallower ones lose at some size: D = 128 at 2^18-2^21
# outputs for N * U = 128 (0.0127 / 0.0112 at B = 8,192, config 4's PLE
# experts), D = 64 up to 2^24 (0.0843 / 0.0723), D = 24 everywhere
BANK_WGMMA_MIN_DEPTH = 192
BANK_WGMMA_MIN_OUTPUTS = 2 ** 14


def takes_wgmma_bank(nx: int, n: int, b: int, d: int, u: int,
                     aligned: bool) -> bool:
    """True where :func:`multi_dense_fused` runs a (nx, b, d) x (n, d, u)
    call on the banks' ``wgmma`` design (counted ``multi_dense.tc_wgmma``
    besides ``multi_dense.tc``): a shared input (nx == 1) whose rows TMA
    reads (d % 4 == 0 and x ``aligned`` to 16 bytes), more than 16
    columns (fewer go to the gate kernel), at least
    :data:`BANK_WGMMA_MIN_DEPTH` deep and with at least
    :data:`BANK_WGMMA_MIN_OUTPUTS` outputs.  Shapes and alignment alone
    decide; ``csrc/multi_dense.cu``'s ``multi_dense_f32`` refuses the
    design for an input that is not shared or not on the 16-byte grid."""
    return (nx == 1 and n * u > 16 and d % 4 == 0 and aligned
            and d >= BANK_WGMMA_MIN_DEPTH
            and b * n * u >= BANK_WGMMA_MIN_OUTPUTS)


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
    return _multi_dense_fused(inputs, kernel, bias, relu)


multi_dense_fused.launches = 0

# floats of scratch the banks' wgmma design takes (W's split planes), by
# (n, d, u, device); 0 where the device cannot run it (the tile then runs)
_bank_scratch: Dict[Tuple[int, int, int, int], int] = {}


def _multi_dense_fused(inputs: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor], relu: bool,
                       wgmma: Optional[bool] = None) -> torch.Tensor:
    """:func:`multi_dense_fused`'s launch on a CUDA tensor: on the banks'
    ``wgmma`` design where :func:`takes_wgmma_bank` takes the call, or
    where ``wgmma`` is True at any size (the tests' seam; it raises
    unless the input is shared with its rows on the 16-byte grid), and
    the device runs it; else on the gate kernel or the tile."""
    dev = inputs.device
    n, b, d, u = _check(inputs, kernel, bias, dev)
    nx, aligned = inputs.shape[0], inputs.data_ptr() % 16 == 0
    if wgmma is None:
        wgmma = takes_wgmma_bank(nx, n, b, d, u, aligned)
    elif wgmma and (nx != 1 or d % 4 or not aligned):
        raise ValueError("the banks' wgmma design reads a shared x's rows "
                         "by TMA: (1, B, D) with D % 4 == 0, x 16-byte "
                         "aligned")
    if b == 0:
        return inputs.new_empty((n, b, u))
    lib = _lib()
    floats = 0
    if wgmma:
        key = (n, d, u, dev.index)
        floats = _bank_scratch.get(key)
        if floats is None:
            floats = _bank_scratch[key] = lib.multi_dense_bank_scratch(
                n, b, d, u, dev.index)
    if floats:
        # one allocation: W's planes (a multiple of 64 floats, so that out
        # stays on the 16-byte grid), then out
        buf = inputs.new_empty(floats + n * b * u)
        out = buf[floats:].view(n, b, u)
    else:
        out = inputs.new_empty((n, b, u))       # f32 on inputs' device
    rc = lib.multi_dense_f32(inputs.data_ptr(), nx, kernel.data_ptr(),
                             None if bias is None else bias.data_ptr(),
                             out.data_ptr(), n, b, d, u, int(relu),
                             buf.data_ptr() if floats else None, dev.index,
                             _build.stream_of(inputs))
    check_rc(lib, rc, "multi_dense")
    multi_dense_fused.launches += 1
    profiling.count("multi_dense.mma")
    if floats:
        profiling.count("multi_dense.tc")
        profiling.count("multi_dense.tc_wgmma")
    else:
        profiling.count("multi_dense.gate" if takes_gate_kernel(nx, n, d, u)
                        else "multi_dense.tc")
    return out


def linear_wg(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor],
              relu: bool) -> Optional[torch.Tensor]:
    """x (B, D) @ weight (U, D)^T + bias (U,) or None, ReLU fused when
    ``relu``, on B8's ``wgmma`` kernel -> (B, U); None unless x is a
    contiguous float32 CUDA matrix, the weight contiguous and
    :func:`wgmma_plan` takes the call.  ``weight`` and ``bias`` are
    ``nn.Linear``'s, float32 on x's device."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 2
            and x.is_contiguous() and weight.is_contiguous()
            and wgmma_plan(x.shape[0], x.shape[1], weight.shape[0],
                           x.data_ptr() % 16 == 0)):
        return None
    return _linear_wg(x, weight, bias, relu)


# floats of scratch the wgmma kernel takes (its weight's split planes), by
# (d, u, device); 0 where the device cannot run it (the launch then raises)
_wg_scratch: Dict[Tuple[int, int, int], int] = {}


def _linear_wg(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """:func:`linear_wg`'s launch at any size the kernel takes (x's rows
    on the 16-byte grid); raises on anything else."""
    dev = x.device
    check_input("x", x, 2, dev)
    check_input("weight", weight, 2, dev)
    (b, d), u = x.shape, weight.shape[0]
    if weight.shape[1] != d:
        raise ValueError(f"x {tuple(x.shape)} does not fit weight "
                         f"{tuple(weight.shape)}: expected (U, {d})")
    if bias is not None:
        check_input("bias", bias, 1, dev)
        if bias.shape[0] != u:
            raise ValueError(f"bias {tuple(bias.shape)} is not ({u},)")
    if d % 4 or x.data_ptr() % 16:
        raise ValueError("the wgmma kernel reads x's rows by TMA: D % 4 "
                         "== 0 and x 16-byte aligned")
    out = x.new_empty((b, u))
    if b == 0:
        return out
    lib = _lib()
    key = (d, u, dev.index)
    floats = _wg_scratch.get(key)
    if floats is None:
        floats = _wg_scratch[key] = lib.multi_dense_wg_scratch(
            b, d, u, dev.index)
    scratch = x.new_empty(floats)
    rc = lib.multi_dense_wg_f32(x.data_ptr(), weight.data_ptr(),
                                None if bias is None else bias.data_ptr(),
                                out.data_ptr(), b, d, u, int(relu),
                                scratch.data_ptr(), dev.index,
                                _build.stream_of(x))
    check_rc(lib, rc, "multi_dense")
    linear_wg.launches += 1
    profiling.count("multi_dense.wgmma")
    return out


linear_wg.launches = 0


def cross_wg(x: torch.Tensor, x0: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, b: Optional[torch.Tensor],
             out: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """One low-rank cross layer, ``x0 * ((x @ v) @ w + b) + x`` with x and
    x0 (B, D), v (D, r), w (r, D) and b (D,) or None, on B8's ``wgmma``
    kernel -> (B, D), written into ``out`` where given: a contiguous
    float32 (B, D) on x's device, x itself allowed (each element of x is
    read before the same thread writes that element of out), never x0
    unless x is x0.  None unless x and x0 are contiguous float32 CUDA
    matrices of one shape, v and w contiguous and :func:`cross_plan` takes
    the call.  v, w and b are ``LowRankCrossLayer``'s, float32 on x's
    device."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 2
            and x.is_contiguous() and x0.is_contiguous()
            and x0.dtype == torch.float32 and x0.shape == x.shape
            and v.is_contiguous() and w.is_contiguous()
            and cross_plan(x.shape[0], x.shape[1], v.shape[-1],
                           (x.data_ptr() | x0.data_ptr()) % 16 == 0)):
        return None
    return _cross_wg(x, x0, v, w, b, out)


# floats of scratch the cross's two launches share for their weight planes,
# by (d, r, device); 0 where the device cannot run them (the launch then
# raises)
_cross_scratch: Dict[Tuple[int, int, int], int] = {}


def _cross_wg(x: torch.Tensor, x0: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, b: Optional[torch.Tensor],
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`cross_wg`'s two launches at any size the kernel takes (x's
    and x0's rows on the 16-byte grid, r % 4 == 0); raises on anything
    else."""
    dev = x.device
    for name, t, ndim in (("x", x, 2), ("x0", x0, 2), ("v", v, 2),
                          ("w", w, 2)):
        check_input(name, t, ndim, dev)
    (bs, d), r = x.shape, v.shape[1]
    if (x0.shape != x.shape or v.shape[0] != d
            or tuple(w.shape) != (r, d)):
        raise ValueError(f"x {tuple(x.shape)}, x0 {tuple(x0.shape)}, v "
                         f"{tuple(v.shape)} and w {tuple(w.shape)} do not "
                         f"fit: expected x0 as x, v ({d}, r), w (r, {d})")
    if b is not None:
        check_input("b", b, 1, dev)
        if b.shape[0] != d:
            raise ValueError(f"b {tuple(b.shape)} is not ({d},)")
    if d % 4 or r % 4 or (x.data_ptr() | x0.data_ptr()) % 16:
        raise ValueError("the wgmma kernel reads x's and u's rows by TMA: "
                         "D % 4 == 0, r % 4 == 0 and x, x0 16-byte aligned")
    if out is not None:
        check_input("out", out, 2, dev)
        if out.shape != x.shape or (out.data_ptr() == x0.data_ptr()
                                    and x0.data_ptr() != x.data_ptr()):
            raise ValueError(f"out {tuple(out.shape)} is not x's shape, or "
                             f"is x0 while x is not")
    if bs == 0:
        return x.new_empty((bs, d)) if out is None else out
    lib = _lib()
    key = (d, r, dev.index)
    floats = _cross_scratch.get(key)
    if floats is None:
        floats = _cross_scratch[key] = lib.cross_wg_scratch(bs, d, r,
                                                            dev.index)
    if out is None:                  # one allocation: out, then scratch
        buf = x.new_empty(bs * d + floats + bs * r)
        out, scratch = buf[:bs * d].view(bs, d), buf[bs * d:]
    else:
        scratch = x.new_empty(floats + bs * r)
    rc = lib.cross_wg_f32(x.data_ptr(), x0.data_ptr(), v.data_ptr(),
                          w.data_ptr(), None if b is None else b.data_ptr(),
                          out.data_ptr(), bs, d, r, scratch.data_ptr(),
                          dev.index, _build.stream_of(x))
    check_rc(lib, rc, "multi_dense")
    cross_wg.launches += 2
    profiling.count("cross.wgmma")
    return out


cross_wg.launches = 0


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
