"""CIN forward kernels (``csrc/cin.cu``), their wrappers and plain versions.

Counterpart of ``rec_now_tpu/ops/pallas/cin_kernel.py`` (forward only):

* :func:`cin_flat` -- one CIN layer over flattened positions,
  ``out[m, k] = sum_{f,h} W[k, f, h] * x0[m, f] * prev[m, h]``; replaces
  ``_cin_flat_fwd_impl``.
* :func:`cin_stack_sum` -- the whole CIN stack plus the channel sum, the
  hidden layers kept on chip and the last layer collapsed to
  ``Wc = sum_k W_n``; replaces ``_cin_stack_fwd_impl``.

Each wrapper takes the plain PyTorch version (:func:`cin_flat_plain`,
:func:`cin_stack_sum_plain`) for tensors on the CPU.  For a CUDA tensor
it launches the kernel or raises; it never falls back.  ``launches`` on
each wrapper counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from rec_now_tpu_torch.ops import _build


def cin_flat_plain(x0: torch.Tensor, prev: torch.Tensor,
                   weight: torch.Tensor) -> torch.Tensor:
    """(M, F), (M, H), (K, F, H) -> (M, K): prev x W first, then x0."""
    t = torch.einsum("mh,kfh->mkf", prev, weight)
    return torch.einsum("mkf,mf->mk", t, x0)


def cin_stack_sum_plain(x0: torch.Tensor, weights: Sequence[torch.Tensor],
                        output_input: bool = True) -> torch.Tensor:
    """(M, F), per-layer (K_i, F, H_{i-1}) -> (M,): every layer, concat,
    sum over channels (``rec_now_tpu/layers/cin_layer.py:89-99``)."""
    layers = [x0]
    for w in weights:
        layers.append(cin_flat_plain(x0, layers[-1], w))
    if not output_input:
        layers = layers[1:]
    return torch.cat(layers, dim=-1).sum(dim=-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("cin")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cin_error_string.argtypes = [i32]
        lib.cin_error_string.restype = ctypes.c_char_p
        lib.cin_flat_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     i32, i32, ptr]
        lib.cin_flat_f32.restype = i32
        lib.cin_stack_sum_f32.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32,
                                          i32, i32, i32, ptr]
        lib.cin_stack_sum_f32.restype = i32
        lib._typed = True
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.cin_error_string(rc).decode()} ({rc})")


def _check_input(name: str, t: torch.Tensor, ndim: int,
                 device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _is_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"CIN kernels run on CUDA or CPU, not {x.device}")
    return False


def cin_flat(x0: torch.Tensor, prev: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """One CIN layer: x0 (M, F), prev (M, H), weight (K, F, H) -> (M, K)."""
    if _is_cpu(x0):
        return cin_flat_plain(x0, prev, weight)
    _check_input("x0", x0, 2, x0.device)
    _check_input("prev", prev, 2, x0.device)
    _check_input("weight", weight, 3, x0.device)
    m, f = x0.shape
    h = prev.shape[1]
    k = weight.shape[0]
    if prev.shape[0] != m or tuple(weight.shape[1:]) != (f, h):
        raise ValueError(f"shape mismatch: x0 {tuple(x0.shape)}, prev "
                         f"{tuple(prev.shape)}, weight {tuple(weight.shape)}")
    out = torch.empty((m, k), dtype=torch.float32, device=x0.device)
    if m == 0:
        return out
    # the kernel streams the weight as (F, H, K); it writes that copy here
    scratch = torch.empty((k * f * h,), dtype=torch.float32, device=x0.device)
    lib = _lib()
    rc = lib.cin_flat_f32(x0.data_ptr(), prev.data_ptr(), weight.data_ptr(),
                          scratch.data_ptr(), out.data_ptr(), m, f, h, k,
                          x0.device.index,
                          torch.cuda.current_stream(x0.device).cuda_stream)
    _check(lib, rc, "cin_flat")
    cin_flat.launches += 1
    return out


cin_flat.launches = 0


def cin_stack_sum(x0: torch.Tensor, weights: Sequence[torch.Tensor],
                  output_input: bool = True) -> torch.Tensor:
    """Whole CIN stack + channel sum: x0 (M, F), weights[i]
    (K_i, F, H_{i-1}) with H_0 = F -> (M,)."""
    weights = tuple(weights)
    if _is_cpu(x0):
        return cin_stack_sum_plain(x0, weights, output_input)
    if not weights:
        raise ValueError("cin_stack_sum needs at least one layer")
    _check_input("x0", x0, 2, x0.device)
    m, f = x0.shape
    h = f
    for i, w in enumerate(weights):
        _check_input(f"weights[{i}]", w, 3, x0.device)
        if tuple(w.shape[1:]) != (f, h):
            raise ValueError(f"weights[{i}] has shape {tuple(w.shape)}, "
                             f"expected (K, {f}, {h})")
        h = w.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=x0.device)
    if m == 0:
        return out
    # non-last weights re-laid as (F, H, K), then Wc (F, H_{n-1})
    n_scratch = (sum(w.numel() for w in weights[:-1])
                 + f * weights[-1].shape[2])
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=x0.device)
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    ks = (ctypes.c_int * len(weights))(*[w.shape[0] for w in weights])
    lib = _lib()
    rc = lib.cin_stack_sum_f32(
        x0.data_ptr(), ptrs, ks, len(weights), scratch.data_ptr(),
        out.data_ptr(), m, f, int(output_input), x0.device.index,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _check(lib, rc, "cin_stack_sum")
    cin_stack_sum.launches += 1
    return out


cin_stack_sum.launches = 0
