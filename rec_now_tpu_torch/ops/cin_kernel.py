"""CIN kernels (``csrc/cin.cu``), their wrappers and plain versions.

Counterpart of ``rec_now_tpu/ops/pallas/cin_kernel.py``:

* :func:`cin_flat` -- one CIN layer over flattened positions,
  ``out[m, k] = sum_{f,h} W[k, f, h] * x0[m, f] * prev[m, h]``; replaces
  ``_cin_flat_fwd_impl``.  Its backward :func:`cin_flat_bwd` (dx0, dprev
  and dW summed over rows) replaces ``_cin_flat_bwd``.
* :func:`cin_stack_sum` -- the whole CIN stack plus the channel sum, the
  hidden layers kept on chip and the last layer collapsed to
  ``Wc = sum_k W_n``; replaces ``_cin_stack_fwd_impl``.  Its backward
  :func:`cin_stack_sum_bwd` (dx0, dW of every non-last layer and the one
  (F, H_{n-1}) ``dWc`` every channel of the last layer shares) replaces
  ``_cin_stack_bwd``.  Its layer 1, whose prev is x0, runs over the
  F(F+1)/2 symmetric pairs with the weight folded once a call
  (:func:`symmetric_pairs`, :func:`fold_symmetric`,
  :func:`cin_pairs_plain` are that math in plain PyTorch).

On CUDA tensors :func:`cin_flat` and :func:`cin_stack_sum` are
``torch.autograd.Function``\\ s whose backward is the backward kernel, as
the JAX functions are ``jax.custom_vjp``\\ s.  Each wrapper takes the plain
PyTorch version (``*_plain``) for tensors on the CPU, where autograd goes
through the plain forward; for a CUDA tensor it launches the kernel or
raises, and never falls back.  ``launches`` on each of the four wrappers
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.ops._build import check_input, check_rc, is_cpu


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


def symmetric_pairs(f: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f_p, h_p) of the F(F+1)/2 pairs f <= h of ``f`` fields, f-major:
    the order in which the stack kernel's layer 1 takes them (its pair
    table, ``stack_prep_kernel`` in ``csrc/cin.cu``)."""
    fs, hs = torch.triu_indices(f, f)
    return fs, hs


def fold_symmetric(weight: torch.Tensor) -> torch.Tensor:
    """(K, F, F) -> (K, F(F+1)/2): a layer whose prev is x0 on its
    symmetric pairs, ``W[k,f,h] + W[k,h,f]`` for f < h and ``W[k,f,f]``,
    so that ``sum_p fold[k,p] x0[f_p] x0[h_p]`` is the layer (what
    ``stack_prep_kernel`` writes before padding the pairs to a multiple
    of 8)."""
    fs, hs = symmetric_pairs(weight.shape[1])
    both = weight + weight.transpose(1, 2)
    return torch.where(fs == hs, weight[:, fs, hs], both[:, fs, hs])


def cin_pairs_plain(x0: torch.Tensor, folded: torch.Tensor) -> torch.Tensor:
    """(M, F), (K, F(F+1)/2) -> (M, K): layer 1 over its symmetric pairs,
    ``a[m, p] = x0[m, f_p] x0[m, h_p]`` times the folded weight."""
    fs, hs = symmetric_pairs(x0.shape[1])
    return (x0[:, fs] * x0[:, hs]) @ folded.t()


def cin_flat_bwd_plain(x0: torch.Tensor, prev: torch.Tensor,
                       weight: torch.Tensor, g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer's gradients for the output gradient g (M, K), in the
    kernel's order: ``A[m,f,h] = sum_k g W``, then ``dx0 = sum_h A
    prev``, ``dprev = sum_f A x0``, and ``dW[k, n] = sum_m g[m,k]
    u[m,n]`` over the flattened products ``u[m, f*H + h] = x0[m,f]
    prev[m,h]``."""
    m, f = x0.shape
    k, _, h = weight.shape
    a = torch.einsum("mk,kfh->mfh", g, weight)
    dx0 = torch.einsum("mfh,mh->mf", a, prev)
    dprev = torch.einsum("mfh,mf->mh", a, x0)
    u = (x0[:, :, None] * prev[:, None, :]).reshape(m, f * h)
    return dx0, dprev, (g.t() @ u).reshape(k, f, h)


def cin_stack_sum_bwd_plain(x0: torch.Tensor,
                            weights: Sequence[torch.Tensor],
                            g: torch.Tensor, output_input: bool = True
                            ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The stack's gradients for g (M,), in the kernel's order: the
    hidden layers recomputed, the collapsed last layer (``out += sum_f x0
    (Wc h_{n-1})``, so ``dWc = (g x0)^T h_{n-1}``, the same for every
    channel), then each layer's gradients from the top through
    :func:`cin_flat_bwd_plain`'s ``A = g W``, each hidden layer's
    gradient also taking g from the channel sum; layer 1's prev is x0, so
    both its input gradients go to dx0.  Each layer's gradients are taken
    in float64 and cast back: in f32 the A-first order rounds away from
    autograd's through the plain forward by up to an ulp of the summed
    terms, which a cancelling element shows.  Returns (dx0 (M, F), [dW per
    layer])."""
    hs = [x0]
    for w in weights[:-1]:
        hs.append(cin_flat_plain(x0, hs[-1], w))
    wc = weights[-1].sum(0)                                 # (F, H_{n-1})
    gc = g[:, None]
    dx0 = gc * (hs[-1] @ wc.t())
    if output_input:
        dx0 = dx0 + gc
    dwc = (x0 * gc).t() @ hs[-1]
    dh = gc * (x0 @ wc)                                     # into h_{n-1}
    dws = []
    for i in range(len(weights) - 2, -1, -1):
        ddx0, dh, dw = (t.to(x0.dtype) for t in cin_flat_bwd_plain(
            x0.double(), hs[i].double(), weights[i].double(),
            (dh + gc).double()))
        dx0 = dx0 + ddx0
        dws.insert(0, dw)
    dx0 = dx0 + dh                                          # h_0 is x0
    return dx0, dws + [dwc.expand(weights[-1].shape)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("cin")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cin_flat_scratch.argtypes = [i32] * 6
        lib.cin_flat_scratch.restype = i64
        lib.cin_flat_f32.argtypes = [ptr] * 4 + [i32] * 4 + [ptr] * 2 + [
            i32, ptr]
        lib.cin_flat_f32.restype = i32
        lib.cin_stack_fwd_scratch.argtypes = [ptr] + [i32] * 5
        lib.cin_stack_fwd_scratch.restype = i64
        lib.cin_stack_sum_f32.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32,
                                          i32, i32, i32, i32, ptr]
        lib.cin_stack_sum_f32.restype = i32
        lib.cin_dw_scratch.argtypes = [i32] * 4
        lib.cin_dw_scratch.restype = i64
        lib.cin_flat_bwd_f32.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.cin_flat_bwd_f32.restype = i32
        lib.cin_stack_bwd_scratch.argtypes = [ptr] + [i32] * 4
        lib.cin_stack_bwd_scratch.restype = i64
        lib.cin_stack_sum_bwd_f32.argtypes = ([ptr] * 4 + [i32] + [ptr] * 4
                                              + [i32] * 4 + [ptr])
        lib.cin_stack_sum_bwd_f32.restype = i32
        lib._typed = True
    return lib


def _empty(x: torch.Tensor, *shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=x.device)


def _scratch_size(n: int) -> int:
    if n < 0:
        raise RuntimeError("the CIN backward could not read the device's "
                           "SM count or occupancy")
    return n


def _check_flat(x0, prev, weight) -> Tuple[int, int, int, int]:
    check_input("x0", x0, 2, x0.device)
    check_input("prev", prev, 2, x0.device)
    check_input("weight", weight, 3, x0.device)
    m, f = x0.shape
    h = prev.shape[1]
    k = weight.shape[0]
    if prev.shape[0] != m or tuple(weight.shape[1:]) != (f, h):
        raise ValueError(f"shape mismatch: x0 {tuple(x0.shape)}, prev "
                         f"{tuple(prev.shape)}, weight {tuple(weight.shape)}")
    return m, f, h, k


def _check_stack(x0, weights) -> None:
    if not weights:
        raise ValueError("cin_stack_sum needs at least one layer")
    check_input("x0", x0, 2, x0.device)
    f = h = x0.shape[1]
    for i, w in enumerate(weights):
        check_input(f"weights[{i}]", w, 3, x0.device)
        if tuple(w.shape[1:]) != (f, h):
            raise ValueError(f"weights[{i}] has shape {tuple(w.shape)}, "
                             f"expected (K, {f}, {h})")
        h = w.shape[0]


# floats of scratch B2 takes, by (m, f, h, k, prev is x0, device): 0 where
# the layer runs on the mma.sync kernel (csrc/cin.cu, wg_plan)
_flat_scratch: Dict[Tuple[int, ...], int] = {}
# the kernel layer() ran, as cin_flat_f32 reports it -> its counter
_FLAT_PATHS = {1: "cin.layer_mma", 2: "cin.layer_wgmma"}
_path = ctypes.c_int(0)
_path_ref = ctypes.byref(_path)


def _flat_fwd_cuda(x0, prev, weight) -> torch.Tensor:
    """B2 on CUDA tensors; each launch counts in ``cin.layer_wgmma`` or
    ``cin.layer_mma`` (``core/profiling.count``) by the kernel that ran."""
    m, f, h, k = _check_flat(x0, prev, weight)
    out = _empty(x0, m, k)
    if m == 0:
        return out
    lib = _lib()
    dev = x0.device.index
    same = int(prev.data_ptr() == x0.data_ptr() and h == f)
    key = (m, f, h, k, same, dev)
    words = _flat_scratch.get(key)
    if words is None:
        words = lib.cin_flat_scratch(m, f, h, k, same, dev)
        if words < 0:
            raise RuntimeError("cin_flat could not read the device")
        _flat_scratch[key] = words
    scratch = _empty(x0, words) if words else None
    rc = lib.cin_flat_f32(x0.data_ptr(), prev.data_ptr(), weight.data_ptr(),
                          out.data_ptr(), m, f, h, k,
                          scratch.data_ptr() if words else None, _path_ref,
                          dev, _build.stream_of(x0))
    check_rc(lib, rc, "cin_flat")
    cin_flat.launches += 1
    profiling.count(_FLAT_PATHS[_path.value])
    return out


# rows a block of the stack kernel takes: the largest whose tiles fit the
# card's shared memory (csrc/cin.cu, stack_rows), or 64 or 128 as asked, or
# the layer-by-layer launches
STACK_ROWS_AUTO, STACK_BY_LAYERS = 0, -1


def _stack_fwd_cuda(x0, weights, output_input,
                    rows: int = STACK_ROWS_AUTO) -> torch.Tensor:
    """The stack kernel on CUDA tensors; ``rows`` picks its path (the
    default is the wrappers'; the others are for measuring the paths)."""
    _check_stack(x0, weights)
    m, f = x0.shape
    out = _empty(x0, m)
    if m == 0:
        return out
    n = len(weights)
    ks = (ctypes.c_int * n)(*[w.shape[0] for w in weights])
    lib = _lib()
    dev = x0.device.index
    words = lib.cin_stack_fwd_scratch(ks, n, m, f, rows, dev)
    if words < 0:
        raise RuntimeError(f"cin_stack_sum cannot run {rows} rows a block "
                           f"here, or could not read the device")
    # Wc, then layer 1 folded and its pair table, or the hidden layers
    scratch = _empty(x0, words)
    ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    rc = lib.cin_stack_sum_f32(
        x0.data_ptr(), ptrs, ks, n, scratch.data_ptr(), out.data_ptr(), m, f,
        int(output_input), rows, dev, _build.stream_of(x0))
    check_rc(lib, rc, "cin_stack_sum")
    cin_stack_sum.launches += 1
    return out


class _CinFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, prev, weight):
        ctx.save_for_backward(x0, prev, weight)
        return _flat_fwd_cuda(x0, prev, weight)

    @staticmethod
    def backward(ctx, g):
        return cin_flat_bwd(*ctx.saved_tensors, g.contiguous())


class _CinStackSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, output_input, *weights):
        ctx.output_input = output_input
        ctx.save_for_backward(x0, *weights)
        return _stack_fwd_cuda(x0, weights, output_input)

    @staticmethod
    def backward(ctx, g):
        x0, *weights = ctx.saved_tensors
        dx0, dws = cin_stack_sum_bwd(x0, weights, g.contiguous(),
                                     ctx.output_input)
        return (dx0, None, *dws)


def cin_flat(x0: torch.Tensor, prev: torch.Tensor,
             weight: torch.Tensor) -> torch.Tensor:
    """One CIN layer: x0 (M, F), prev (M, H), weight (K, F, H) -> (M, K);
    differentiable (the backward is :func:`cin_flat_bwd`)."""
    if is_cpu(x0, "cin_flat"):
        return cin_flat_plain(x0, prev, weight)
    return _CinFlat.apply(x0, prev, weight)


cin_flat.launches = 0


def cin_stack_sum(x0: torch.Tensor, weights: Sequence[torch.Tensor],
                  output_input: bool = True) -> torch.Tensor:
    """Whole CIN stack + channel sum: x0 (M, F), weights[i]
    (K_i, F, H_{i-1}) with H_0 = F -> (M,); differentiable (the backward
    is :func:`cin_stack_sum_bwd`)."""
    weights = tuple(weights)
    if is_cpu(x0, "cin_stack_sum"):
        return cin_stack_sum_plain(x0, weights, output_input)
    return _CinStackSum.apply(x0, output_input, *weights)


cin_stack_sum.launches = 0


def cin_flat_bwd(x0: torch.Tensor, prev: torch.Tensor, weight: torch.Tensor,
                 g: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`cin_flat`'s gradients for g (M, K): (dx0, dprev, dW)."""
    if is_cpu(x0, "cin_flat_bwd"):
        return cin_flat_bwd_plain(x0, prev, weight, g)
    m, f, h, k = _check_flat(x0, prev, weight)
    check_input("g", g, 2, x0.device)
    if tuple(g.shape) != (m, k):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {(m, k)}")
    lib = _lib()
    dev = x0.device.index
    dx0, dprev, dw = _empty(x0, m, f), _empty(x0, m, h), _empty(x0, k, f, h)
    # the weight gradient's partial sums, one per row slice
    scratch = _empty(x0, _scratch_size(lib.cin_dw_scratch(m, k, f * h, dev)))
    rc = lib.cin_flat_bwd_f32(
        x0.data_ptr(), prev.data_ptr(), weight.data_ptr(), g.data_ptr(),
        scratch.data_ptr(), dx0.data_ptr(), dprev.data_ptr(), dw.data_ptr(),
        m, f, h, k, dev, _build.stream_of(x0))
    check_rc(lib, rc, "cin_flat_bwd")
    cin_flat_bwd.launches += 1
    return dx0, dprev, dw


cin_flat_bwd.launches = 0


def cin_stack_sum_bwd(x0: torch.Tensor, weights: Sequence[torch.Tensor],
                      g: torch.Tensor, output_input: bool = True
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """:func:`cin_stack_sum`'s gradients for g (M,): (dx0, [dW per
    layer]); the last layer's dW is ``dWc`` broadcast over its
    channels."""
    weights = tuple(weights)
    if is_cpu(x0, "cin_stack_sum_bwd"):
        return cin_stack_sum_bwd_plain(x0, weights, g, output_input)
    _check_stack(x0, weights)
    m, f = x0.shape
    check_input("g", g, 1, x0.device)
    if g.shape[0] != m:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected ({m},)")
    n = len(weights)
    ks = (ctypes.c_int * n)(*[w.shape[0] for w in weights])
    lib = _lib()
    scratch = _empty(x0, _scratch_size(
        lib.cin_stack_bwd_scratch(ks, n, m, f, x0.device.index)))
    dx0 = _empty(x0, m, f)
    dws = [torch.empty_like(w) for w in weights[:-1]]
    dwc = _empty(x0, f, weights[-1].shape[2])
    ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    dptrs = (ctypes.c_void_p * max(n - 1, 1))(*[d.data_ptr() for d in dws])
    rc = lib.cin_stack_sum_bwd_f32(
        x0.data_ptr(), g.data_ptr(), ptrs, ks, n, scratch.data_ptr(),
        dx0.data_ptr(), dptrs, dwc.data_ptr(), m, f, int(output_input),
        x0.device.index, _build.stream_of(x0))
    check_rc(lib, rc, "cin_stack_sum_bwd")
    cin_stack_sum_bwd.launches += 1
    return dx0, dws + [dwc.expand(weights[-1].shape)]


cin_stack_sum_bwd.launches = 0
