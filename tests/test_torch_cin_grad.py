"""Port vs JAX: the CIN backwards.

The port's plain backwards (explicit formulas, not autograd) against
``jax.grad`` through the JAX Pallas kernels ``cin_stack_sum`` and
``cin_flat`` (interpreted off the TPU, as their own tests run them), and
autograd through the port's CPU path against the same plain backwards.
Inputs are numpy arrays from a seed.  f32 on both sides with other
summation orders: rtol 1e-4 / atol 1e-6 against JAX for the stack (the
JAX kernels contract through 0/1 matmuls), atol 1e-5 for one layer,
whose shapes reach config 3's (F * H = 1,664 products a channel, K up
to 130); rtol 1e-5 / atol 1e-7 within the port (1e-5 at config 3's
first layer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.ops.pallas import cin_kernel as jck
from rec_now_tpu_torch.ops import cin_kernel as ck

torch.set_num_threads(1)


def _inputs(m, f, hidden, seed):
    """x0 ~ N(0, 0.5^2), weights at the glorot scale of the flattened
    (F*H, K) view, a cotangent ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    x0 = (0.5 * rng.randn(m, f)).astype(np.float32)
    hs = (f,) + tuple(hidden[:-1])
    ws = [(rng.randn(k, f, h) * np.sqrt(2.0 / (f * h + k))
           ).astype(np.float32) for k, h in zip(hidden, hs)]
    return rng, x0, ws


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hidden", [(4,), (8, 8), (5, 3, 7)])
@pytest.mark.parametrize("output_input", [True, False])
def test_stack_bwd_plain_matches_jax_grad(hidden, output_input):
    m, f = 15, 5
    rng, x0, ws = _inputs(m, f, hidden, seed=len(hidden))
    g = rng.randn(m).astype(np.float32)

    def fwd(x, wts):
        return jnp.vdot(jck.cin_stack_sum(x, tuple(wts), output_input),
                        jnp.asarray(g))

    jdx0, jdws = jax.grad(fwd, argnums=(0, 1))(
        jnp.asarray(x0), [jnp.asarray(w) for w in ws])
    dx0, dws = ck.cin_stack_sum_bwd_plain(_t(x0), [_t(w) for w in ws],
                                          _t(g), output_input)
    np.testing.assert_allclose(dx0.numpy(), np.asarray(jdx0), rtol=1e-4,
                               atol=1e-6)
    assert len(dws) == len(ws)
    for got, want in zip(dws, jdws):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


# (m, f, h, k, prev is x0): small odd shapes, then config 3's layers at
# a narrow M (layer 1's prev is x0), F * H % 4 != 0 with one channel,
# and H past one 64-wide pass with K past two 64-channel chunks
FLAT_BWD_SHAPES = [(15, 5, 5, 4, False), (37, 6, 9, 11, False),
                   (40, 26, 26, 64, True), (33, 26, 64, 64, False),
                   (17, 5, 7, 1, False), (9, 3, 70, 130, False)]


@pytest.mark.parametrize("m,f,h,k,same", FLAT_BWD_SHAPES)
def test_flat_bwd_plain_matches_jax_grad(m, f, h, k, same):
    """The A-first plain backward against jax.grad through the Pallas
    layer; where prev is x0 the two input gradients meet in one."""
    rng = np.random.RandomState(m + k)
    x0 = rng.randn(m, f).astype(np.float32)
    prev = x0 if same else rng.randn(m, h).astype(np.float32)
    w = (rng.randn(k, f, h) / np.sqrt(f * h)).astype(np.float32)
    g = rng.randn(m, k).astype(np.float32)

    def fwd(a, b, c):
        return jnp.vdot(jck.cin_flat(a, a if same else b, c),
                        jnp.asarray(g))

    want = jax.grad(fwd, argnums=(0, 1, 2))(
        jnp.asarray(x0), jnp.asarray(prev), jnp.asarray(w))
    dx0, dprev, dw = ck.cin_flat_bwd_plain(_t(x0), _t(prev), _t(w), _t(g))
    got = (dx0 + dprev, dw) if same else (dx0, dprev, dw)
    want = (want[0], want[2]) if same else want
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("hidden", [(4,), (8, 8), (5, 3, 7)])
@pytest.mark.parametrize("output_input", [True, False])
def test_cpu_autograd_matches_plain_bwd(hidden, output_input):
    """On the CPU the wrappers run the plain forward, and autograd
    through it gives what the explicit plain backward (the wrapper's CPU
    path) gives."""
    m, f = 21, 6
    rng, x0, ws = _inputs(m, f, hidden, seed=7 + len(hidden))
    g = _t(rng.randn(m).astype(np.float32))
    x = _t(x0).requires_grad_()
    wts = [_t(w).requires_grad_() for w in ws]
    out = ck.cin_stack_sum(x, wts, output_input)
    auto = torch.autograd.grad(out, [x] + wts, g)
    dx0, dws = ck.cin_stack_sum_bwd(_t(x0), [_t(w) for w in ws], g,
                                    output_input)
    for a, b in zip([dx0] + dws, auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)

    prev = _t(rng.randn(m, 3).astype(np.float32)).requires_grad_()
    w = _t(rng.randn(4, f, 3).astype(np.float32)).requires_grad_()
    gk = _t(rng.randn(m, 4).astype(np.float32))
    auto = torch.autograd.grad(ck.cin_flat(x, prev, w), [x, prev, w], gk)
    plain = ck.cin_flat_bwd(x.detach(), prev.detach(), w.detach(), gk)
    for a, b in zip(plain, auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_cpu_autograd_matches_flat_bwd_with_prev_x0():
    """Config 3's first layer (prev is x0, K = 64) at a narrow M: autograd
    through the CPU ``cin_flat`` gives what ``cin_flat_bwd`` gives, x0's
    gradient being the sum of its two input gradients."""
    m, f, k = 24, 26, 64
    rng = np.random.RandomState(11)
    x = _t(rng.randn(m, f).astype(np.float32)).requires_grad_()
    w = _t((rng.randn(k, f, f) / f).astype(np.float32)).requires_grad_()
    gk = _t(rng.randn(m, k).astype(np.float32))
    auto = torch.autograd.grad(ck.cin_flat(x, x, w), [x, w], gk)
    dx0, dprev, dw = ck.cin_flat_bwd(x.detach(), x.detach(), w.detach(), gk)
    torch.testing.assert_close(dx0 + dprev, auto[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, auto[1], rtol=1e-5, atol=1e-5)
