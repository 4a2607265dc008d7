"""Port vs JAX: the batched multi-expert dense (kernel B8's op).

The port's ``multi_dense_apply`` on the CPU (autograd through its XLA
formula), the kernel's plain version, and the kernel's
``autograd.Function`` with its hand-written backward (what runs on the
card, here with the plain forward) against the JAX package's
``multi_dense_pallas`` (interpreted on the CPU), ``multi_dense_xla`` and
``jax.vjp`` of ``_multi_dense_fused``; then ``MultiDenseLayer`` from
converted Flax weights.  Shapes cover a shared and a per-expert input,
ReLU and none, with and without bias, U = 4 (the gate bank), odd D and a
B that is not a multiple of the TPU's 8-row tiling.  f32 on the CPU on
both sides, summed in other orders over at most D = 45 terms (outputs)
and B = 37 rows (weight gradients): rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers.multi_dense_layer import \
    MultiDenseLayer as JaxMultiDenseLayer
from rec_now_tpu.ops.multi_dense_op import _multi_dense_fused, multi_dense_xla
from rec_now_tpu.ops.pallas.multi_dense_kernel import multi_dense_pallas
from rec_now_tpu_torch.convert import from_jax_params
from rec_now_tpu_torch.layers.multi_dense_layer import MultiDenseLayer
from rec_now_tpu_torch.ops import multi_dense_kernel as mk
from rec_now_tpu_torch.ops.multi_dense_op import multi_dense_apply

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
# (N, B, D, U): the gate bank's U = 4 on an odd D, an expert bank, a
# ragged B, one expert of one row
SHAPES = [(2, 37, 45, 4), (4, 24, 16, 12), (3, 13, 7, 9), (1, 1, 5, 3)]


def _inputs(n, b, d, u, shared, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(1 if shared else n, b, d).astype(np.float32)
    w = (rng.randn(n, d, u) / np.sqrt(d)).astype(np.float32)
    bias = rng.randn(n, 1, u).astype(np.float32)
    return x, w, bias


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("use_bias", [True, False])
def test_forward_matches_jax(shape, shared, act, use_bias):
    x, w, bias = _inputs(*shape, shared, seed=sum(shape))
    bias = bias if use_bias else None
    jact = jax.nn.relu if act else None
    want = np.asarray(multi_dense_pallas(x, w, bias, jact))
    np.testing.assert_allclose(
        want, np.asarray(multi_dense_xla(x, w, bias, jact)), **TOL)
    tb = None if bias is None else _t(bias)
    got = multi_dense_apply(_t(x), _t(w), tb, act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = mk.multi_dense_fused(_t(x), _t(w), tb, act == "relu")
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    assert got.shape == (shape[0], shape[1], shape[3])


def test_two_dim_input_is_shared():
    x, w, bias = _inputs(3, 11, 6, 5, True, seed=3)
    got = multi_dense_apply(_t(x[0]), _t(w), _t(bias), "relu")
    want = multi_dense_apply(_t(x), _t(w), _t(bias), "relu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown activation"):
        multi_dense_apply(_t(x), _t(w), _t(bias), "tanh")


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("act", ["relu", None])
def test_gradients_match_jax_vjp(shape, shared, act):
    x, w, bias = _inputs(*shape, shared, seed=7 + sum(shape))
    rng = np.random.RandomState(1)
    n, b, _, u = shape
    g = rng.randn(n, b, u).astype(np.float32)
    jact = jax.nn.relu if act else None
    out, vjp = jax.vjp(lambda i, k, c: _multi_dense_fused(i, k, c, jact),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    # ReLU's mask must cut some outputs, or the check cannot see it
    if act:
        assert (np.asarray(out) == 0).any() and (np.asarray(out) > 0).any()
    # the CPU path (autograd through the XLA formula) and the kernel's
    # autograd.Function (plain forward, hand-written backward)
    for fn in (lambda i, k, c: multi_dense_apply(i, k, c, act),
               lambda i, k, c: mk.multi_dense(i, k, c, act == "relu")):
        leaves = [_t(a).requires_grad_() for a in (x, w, bias)]
        got = torch.autograd.grad(fn(*leaves), leaves, _t(g))
        for name, a, e in zip(("dx", "dkernel", "dbias"), got, want):
            assert a.shape == e.shape, name
            np.testing.assert_allclose(a.numpy(), e, err_msg=name, **TOL)


def test_gradients_without_bias():
    x, w, _ = _inputs(2, 37, 45, 4, True, seed=11)
    g = np.random.RandomState(2).randn(2, 37, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda i, k: multi_dense_xla(i, k, None, None),
                     jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in (x, w)]
    got = torch.autograd.grad(mk.multi_dense(*leaves, None, False), leaves,
                              _t(g))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("act", ["relu", None])
def test_layer_from_converted_weights(shared, act):
    n, b, d, u = 3, 21, 13, 6
    rng = np.random.RandomState(5)
    x = rng.randn(b, d) if shared else rng.randn(n, b, d)
    x = x.astype(np.float32)
    layer = JaxMultiDenseLayer(units=u, num_dnn=n, activation=act)
    params = layer.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape), jnp.float32) * 0.1,
        params)
    want = np.asarray(layer.apply(params, x))
    port = MultiDenseLayer(d, u, n, torch.Generator().manual_seed(0),
                           activation=act, device="cpu")
    sd = from_jax_params(jax.device_get(params))
    assert set(sd) == set(dict(port.named_parameters())) == {"kernel",
                                                             "bias"}
    port.load_state_dict(sd)
    got = port(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the port's own init: per-expert glorot fans (D, U), zero bias
    fresh = MultiDenseLayer(d, u, n, torch.Generator().manual_seed(0),
                            device="cpu")
    limit = np.sqrt(6.0 / (d + u))
    k = fresh.kernel.detach()
    assert k.shape == (n, d, u)
    assert limit >= float(k.abs().max()) > 0.8 * limit
    assert not fresh.bias.any()
