"""Port vs JAX: the CIN contraction and the fused stack's plain versions.

Inputs are numpy arrays from a seed, fed to both packages.  Both sides
compute in f32 on the CPU with the same contraction order, so the
tolerance is rtol 1e-5 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.ops.cin_op import cin_contract_xla
from rec_now_tpu_torch.ops import cin_kernel as ck
from rec_now_tpu_torch.ops.cin_op import cin_contract, cin_contract_plain

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(b, d, f, hidden, seed=0):
    """x0 ~ N(0, 0.5^2) and weights at the glorot scale of the layer's
    flattened (F*H, K) view, so hidden values stay O(1) at every depth
    (each layer multiplies by x0 again) and atol 1e-6 is above the f32
    rounding of the channel sums."""
    rng = np.random.RandomState(seed)
    x0 = (0.5 * rng.randn(b, d, f)).astype(np.float32)
    hs = (f,) + tuple(hidden[:-1])
    ws = [(rng.randn(k, f, h) * np.sqrt(2.0 / (f * h + k))
           ).astype(np.float32) for k, h in zip(hidden, hs)]
    return x0, ws


def _jax_stack(x0, ws, output_input):
    """Per-layer JAX reference (tests/layers/test_pallas_kernels.py)."""
    x = jnp.asarray(x0)
    layers = [x]
    for w in ws:
        layers.append(cin_contract_xla(x, layers[-1], jnp.asarray(w)))
    if not output_input:
        layers = layers[1:]
    return np.asarray(jnp.sum(jnp.concatenate(layers, axis=-1), axis=-1))


@pytest.mark.parametrize("b,d,f,h,k", [(4, 8, 5, 6, 7), (3, 5, 4, 4, 4),
                                       (7, 3, 26, 26, 8)])
def test_cin_contract_plain_matches_jax(b, d, f, h, k):
    rng = np.random.RandomState(b * 100 + k)
    x0 = rng.randn(b, d, f).astype(np.float32)
    prev = rng.randn(b, d, h).astype(np.float32)
    w = rng.randn(k, f, h).astype(np.float32)
    want = np.asarray(cin_contract_xla(jnp.asarray(x0), jnp.asarray(prev),
                                       jnp.asarray(w)))
    t = [torch.from_numpy(a) for a in (x0, prev, w)]
    np.testing.assert_allclose(cin_contract_plain(*t).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    # on CPU tensors the dispatching entry point is the plain version
    np.testing.assert_array_equal(cin_contract(*t).numpy(),
                                  cin_contract_plain(*t).numpy())


@pytest.mark.parametrize("hidden", [(5,), (5, 4), (5, 4, 6)])
@pytest.mark.parametrize("output_input", [True, False])
@pytest.mark.parametrize("b,d", [(3, 5), (1000, 1)])
def test_cin_stack_sum_plain_matches_jax(hidden, output_input, b, d):
    f = 4
    x0, ws = _inputs(b, d, f, hidden, seed=len(hidden))
    want = _jax_stack(x0, ws, output_input)
    got = ck.cin_stack_sum_plain(torch.from_numpy(x0.reshape(b * d, f)),
                                 [torch.from_numpy(w) for w in ws],
                                 output_input)
    np.testing.assert_allclose(got.numpy().reshape(b, d), want,
                               rtol=RTOL, atol=ATOL)


def test_cin_flat_plain_matches_jax_flat():
    rng = np.random.RandomState(5)
    m, f, h, k = 37, 6, 9, 11            # ragged M
    x0 = rng.randn(m, f).astype(np.float32)
    prev = rng.randn(m, h).astype(np.float32)
    w = rng.randn(k, f, h).astype(np.float32)
    want = np.asarray(jnp.einsum("mf,mh,kfh->mk", x0, prev, w))
    got = ck.cin_flat_plain(*[torch.from_numpy(a) for a in (x0, prev, w)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_versions_match_jax_pallas_interpret():
    """The JAX Pallas kernels run interpreted off the TPU; the port's
    plain versions must agree with them too."""
    from rec_now_tpu.ops.pallas.cin_kernel import (cin_pallas,
                                                   cin_stack_sum_pallas)
    b, d, f = 2, 3, 4
    x0, ws = _inputs(b, d, f, (5, 4), seed=11)
    want = np.asarray(cin_stack_sum_pallas(
        jnp.asarray(x0), tuple(jnp.asarray(w) for w in ws)))
    got = ck.cin_stack_sum_plain(torch.from_numpy(x0.reshape(b * d, f)),
                                 [torch.from_numpy(w) for w in ws])
    np.testing.assert_allclose(got.numpy().reshape(b, d), want,
                               rtol=1e-4, atol=1e-5)
    prev = np.random.RandomState(12).randn(b, d, f).astype(np.float32)
    want = np.asarray(cin_pallas(jnp.asarray(x0), jnp.asarray(prev),
                                 jnp.asarray(ws[0])))
    got = cin_contract_plain(torch.from_numpy(x0), torch.from_numpy(prev),
                             torch.from_numpy(ws[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("f", [1, 2, 5, 26])
def test_symmetric_pairs_are_the_upper_triangle_f_major(f):
    """The stack kernel's layer-1 pair order: (0, 0), (0, 1), .., (0, F-1),
    (1, 1), ..; pair p of row f starts at f F - f (f - 1) / 2, as
    stack_prep_kernel inverts it."""
    fs, hs = ck.symmetric_pairs(f)
    want = [(a, b) for a in range(f) for b in range(a, f)]
    assert list(zip(fs.tolist(), hs.tolist())) == want
    for p, (a, b) in enumerate(want):
        assert a * f - a * (a - 1) // 2 + (b - a) == p


@pytest.mark.parametrize("m,f,k", [(37, 5, 7), (64, 26, 64), (9, 1, 3),
                                   (100, 13, 1)])
def test_layer1_over_folded_pairs_matches_jax(m, f, k):
    """Layer 1 (prev = x0) over the F(F+1)/2 pairs with the folded weight
    is the JAX layer (f32; the fold adds W[k,f,h] and W[k,h,f] first, so
    the sum rounds in another order)."""
    rng = np.random.RandomState(m + f)
    x0 = rng.randn(m, f).astype(np.float32)
    w = (rng.randn(k, f, f) / f).astype(np.float32)
    want = np.asarray(jnp.einsum("mf,mh,kfh->mk", x0, x0, w))
    x0t, wt = torch.from_numpy(x0), torch.from_numpy(w)
    folded = ck.fold_symmetric(wt)
    assert folded.shape == (k, f * (f + 1) // 2)
    np.testing.assert_allclose(ck.cin_pairs_plain(x0t, folded).numpy(), want,
                               rtol=1e-5, atol=1e-5)
