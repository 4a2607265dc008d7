"""Port vs JAX: the in-batch listwise softmax-CE loss (kernel B6's
function).

The port's CPU path (``losses.listwise.listwise_loss_sum``: the (B, B)
math differentiated by autograd), the kernel's plain version
(``listwise_loss_fused_plain``, its gradient derived by hand) and its
``autograd.Function`` on the CPU, each against the JAX package's
``listwise_loss_pallas(..., reduce_mean=False)`` (interpreted on the CPU)
and its (B, B) XLA path with ``jax.grad``: loss sum, valid-row count and
dlogits.  Batches: no valid group, one group holding the whole batch,
singleton groups, a ragged B, a zipf-grouped click batch, B = 1.  f32 on
the CPU, summed in other orders over at most B = 64 terms: rtol 1e-5,
atol 1e-6; counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.losses.listwise import (
    listwise_loss_via_softmax_cross_entropy_with_logits as jax_ce,
    to_listwise_sample as jax_to_listwise)
from rec_now_tpu.ops.pallas.listwise_kernel import listwise_loss_pallas
from rec_now_tpu_torch.losses import listwise as lw
from rec_now_tpu_torch.ops import listwise_kernel as lk
from rec_now_tpu_torch.training.data import SyntheticCriteo

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(kind):
    rng = np.random.RandomState(len(kind))
    if kind == "no_valid_group":          # every group all-positive
        b = 24
        g = rng.randint(0, 5, b)
        lab = np.ones(b)
    elif kind == "one_group":
        b = 48
        g = np.full(b, 7)
        lab = rng.rand(b) > 0.6
    elif kind == "singletons":            # no group has two members
        b = 40
        g = np.arange(b) * 3
        lab = rng.rand(b) > 0.5
    elif kind == "ragged":
        b = 37
        g = rng.randint(0, 6, b)
        lab = rng.rand(b) > 0.5
    elif kind == "clicks":
        batch = next(SyntheticCriteo(rows_per_field=16, num_users=40)
                     .batches(64, 1, seed=3))
        g, lab = batch.group_ids, batch.labels
        b = len(g)
    else:                                 # "one"
        b, g, lab = 1, np.zeros(1), np.ones(1)
    return (rng.randn(b).astype(np.float32) * 2,
            np.asarray(lab, np.float32), np.asarray(g, np.int32))


def _jax_xla(x, lab, g):
    def f(x):
        v = jax_to_listwise(g, lab, x)
        rows = jax_ce(v.labels, v.logits, do_reduce=False,
                      row_valid=v.row_valid)
        return jnp.sum(rows), jnp.sum(v.row_valid.astype(jnp.float32))
    loss, cnt = f(x)
    return float(loss), float(cnt), np.asarray(
        jax.grad(lambda x: f(x)[0])(jnp.asarray(x)))


KINDS = ["no_valid_group", "one_group", "singletons", "ragged", "clicks",
         "one"]


@pytest.mark.parametrize("kind", KINDS)
def test_pallas_and_xla_agree(kind):
    """The two JAX references the port is held against agree here."""
    x, lab, g = _batch(kind)
    loss, cnt, dx = _jax_xla(x, lab, g)
    ploss, pcnt = listwise_loss_pallas(g, lab, x, reduce_mean=False)
    np.testing.assert_allclose(float(ploss), loss, **TOL)
    assert float(pcnt) == cnt
    pdx = jax.grad(lambda x: listwise_loss_pallas(
        g, lab, x, reduce_mean=False)[0])(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(pdx)[:len(x)], dx, **TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["cpu_autograd", "plain", "function"])
def test_port_matches_jax(kind, path):
    x, lab, g = _batch(kind)
    loss, cnt, dx = _jax_xla(x, lab, g)
    xt = torch.from_numpy(x).requires_grad_()
    args = (torch.from_numpy(lab), torch.from_numpy(g))
    if path == "plain":
        got_loss, got_cnt, got_dx = lk.listwise_loss_fused_plain(
            xt.detach(), *args)
    else:
        fn = (lw.listwise_loss_sum if path == "cpu_autograd"
              else lk.listwise_loss_sum)
        got_loss, got_cnt = fn(xt, *args)
        assert not got_cnt.requires_grad
        # a cotangent of 3 reaches the logits scaled
        got_dx = (torch.autograd.grad(3.0 * got_loss, xt)[0] / 3.0
                  if got_loss.requires_grad else torch.zeros_like(xt))
    np.testing.assert_allclose(float(got_loss.detach()), loss, **TOL)
    assert float(got_cnt) == cnt
    np.testing.assert_allclose(got_dx.detach().numpy(), dx, **TOL)
    assert np.isfinite(got_dx.detach().numpy()).all()
    if cnt == 0:
        assert float(got_loss.detach()) == 0.0 and not got_dx.any()
    elif kind == "one_group":
        assert cnt == 1


def test_first_occurrence_and_row_helpers():
    g = torch.tensor([3, 1, 3, 2, 1, 9])
    assert lw.first_occurrence_mask(g).tolist() == [True, True, False, True,
                                                    False, True]
    rows = torch.tensor([[0.0, 0.7], [0.2, 0.3]])
    assert lw.row_has_value_greater_than(rows, 0.5).tolist() == [True, False]
    assert lw.row_has_value_less_than(rows, 0.1).tolist() == [True, False]
    x, lab, gg = _batch("ragged")
    want = jax_to_listwise(gg, lab, x)
    got = lw.to_listwise_sample(torch.from_numpy(gg), torch.from_numpy(lab),
                                torch.from_numpy(x))
    for name in ("labels", "logits", "row_valid"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)
    rows = lw.listwise_loss_via_softmax_cross_entropy_with_logits(
        got.labels, got.logits, got.row_valid)
    np.testing.assert_allclose(rows.numpy(), np.asarray(jax_ce(
        want.labels, want.logits, do_reduce=False,
        row_valid=want.row_valid)), **TOL)
    assert (rows[~got.row_valid] == 0).all() and (rows[got.row_valid]
                                                  > 0).all()
