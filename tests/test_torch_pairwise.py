"""Port vs JAX: the in-batch pairwise BPR loss.

The port's plain ``pair_loss_fused`` ((B, B) formulas, explicit
dlogits) against JAX ``pair_loss_sum`` (the Pallas kernel, interpreted
off the TPU) and against JAX ``pairwise_loss`` (XLA), for occurrence
power 0 and -0.5: loss sum, pair count and dlogits; then the port's
``pairwise_loss`` (the CPU (B, B) math under autograd) and
``pair_loss_sum`` (the autograd.Function on the plain version) against
the same.  Binary labels and one group, as the trainer calls it.  f32 on
both sides: rtol 1e-5 on the sums, atol 1e-6 on dlogits (terms of order
1, summed in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.losses.pairwise import bpr_loss_func
from rec_now_tpu.losses.pairwise import pairwise_loss as jax_pairwise_loss
from rec_now_tpu.ops.pallas import pairwise_kernel as jpk
from rec_now_tpu_torch.losses.pairwise import pairwise_loss
from rec_now_tpu_torch.losses.pointwise import \
    sigmoid_cross_entropy_with_logits
from rec_now_tpu_torch.ops import pairwise_kernel as pk

torch.set_num_threads(1)


def _batch(b, seed, n_groups=6):
    rng = np.random.RandomState(seed)
    return (rng.randn(b).astype(np.float32),
            (rng.rand(b) > 0.5).astype(np.float32),
            rng.randint(0, n_groups, b).astype(np.int32))


def _jax_xla(x, lab, grp, power):
    """The trainer's off-TPU call (trainer.py:277-283) and its grad."""
    def f(xx):
        return jax_pairwise_loss(
            xx, jnp.asarray(lab), jnp.asarray(grp),
            pairloss_func=functools.partial(bpr_loss_func, factor=1.0,
                                            reduce_mean=False),
            click_occurance_power=power, return_num_pair=True)
    loss, cnt = f(jnp.asarray(x))
    dx = jax.grad(lambda xx: f(xx)[0])(jnp.asarray(x))
    return float(loss), float(cnt), np.asarray(dx)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("power", [0.0, -0.5])
@pytest.mark.parametrize("b,factor", [(64, 1.0), (48, 0.7)])
def test_plain_matches_jax_pallas_interpret(power, b, factor):
    x, lab, grp = _batch(b, seed=b)
    ones = jnp.ones((b,), jnp.float32)
    loss, cnt, dx = jpk._pair_loss_fused_impl(
        jnp.asarray(x), jnp.asarray(lab), jnp.asarray(grp), ones, ones,
        factor, False, power)
    got = pk.pair_loss_fused_plain(*_torch(x, lab, grp), factor, power)
    np.testing.assert_allclose(float(got[0]), float(loss), rtol=1e-5)
    assert float(got[1]) == float(cnt)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dx), atol=1e-6)


@pytest.mark.parametrize("power", [0.0, -0.5])
@pytest.mark.parametrize("b", [64, 37])
def test_plain_and_losses_match_jax_xla(power, b):
    """B = 37 is not a multiple of 8 (the JAX kernel path pads it; the
    port takes any B)."""
    x, lab, grp = _batch(b, seed=100 + b)
    want_loss, want_cnt, want_dx = _jax_xla(x, lab, grp, power)
    loss, cnt, dx = pk.pair_loss_fused_plain(*_torch(x, lab, grp),
                                             occurrence_power=power)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert float(cnt) == want_cnt
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-6)
    for fn in (pairwise_loss, pk.pair_loss_sum):
        xt = torch.from_numpy(x).requires_grad_()
        loss, cnt = fn(xt, torch.from_numpy(lab), torch.from_numpy(grp),
                       1.0, power)
        (dx,) = torch.autograd.grad(loss, xt)
        np.testing.assert_allclose(float(loss.detach()), want_loss,
                                   rtol=1e-5)
        assert float(cnt) == want_cnt and not cnt.requires_grad
        np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-6)


@pytest.mark.parametrize("fn", [pairwise_loss, pk.pair_loss_sum])
def test_no_pairs_gives_zero_loss_and_zero_finite_grads(fn):
    """Every sample in its own group, or all labels equal: no valid
    pair, loss 0, count 0, grads all zero and finite (power -0.5 would
    give 0 ** -0.5 = inf if an empty group were not weighted 0)."""
    b = 16
    x = torch.from_numpy(np.random.RandomState(0).randn(b).astype(
        np.float32)).requires_grad_()
    for lab, grp in ((np.ones(b, np.float32) * (np.arange(b) % 2),
                      np.arange(b, dtype=np.int32)),
                     (np.ones(b, np.float32), np.zeros(b, np.int32))):
        loss, cnt = fn(x, torch.from_numpy(lab), torch.from_numpy(grp), 1.0,
                       -0.5)
        (dx,) = torch.autograd.grad(loss, x)
        assert float(loss.detach()) == 0.0 and float(cnt) == 0.0
        assert torch.isfinite(dx).all() and not dx.any()


def test_sigmoid_cross_entropy_matches_jax():
    from rec_now_tpu.losses.pointwise import \
        sigmoid_cross_entropy_with_logits as jax_sce
    rng = np.random.RandomState(3)
    x = (rng.randn(257) * 30).astype(np.float32)       # far tails too
    lab = (rng.rand(257) > 0.5).astype(np.float32)
    want = np.asarray(jax_sce(jnp.asarray(lab), jnp.asarray(x)))
    got = sigmoid_cross_entropy_with_logits(torch.from_numpy(lab),
                                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
