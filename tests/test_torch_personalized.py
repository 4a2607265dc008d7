"""Port vs JAX: the personalized dense layers.

``StarDenseLayer`` (one and two star nets, with and without a bias, tanh),
``StackedDenseLayer`` (one and two nets, ``resnet_weight``),
``ParasiticStarDenseLayer`` with the options JAX's callers set (no bias,
no activation, ``stop_trunk_grad``, a ``"zeros"`` parasitic init) and
``ParasiticStackedDenseLayer``, on every routing (per sample, one group,
the trunk alone).  D = 7 != U = 5, so a transposed trunk kernel cannot
pass.  Flax-initialised weights, jittered, carried by
``convert.from_jax_params`` and loaded strictly; outputs and the
gradients of every parameter and input against ``jax.grad``.  f32 on
both sides: outputs rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers import ParasiticStackedDenseLayer as JaxPStacked
from rec_now_tpu.layers import ParasiticStarDenseLayer as JaxPStar
from rec_now_tpu.layers import StackedDenseLayer as JaxStacked
from rec_now_tpu.layers import StarDenseLayer as JaxStar
from rec_now_tpu_torch.convert import from_jax_params
from rec_now_tpu_torch.layers import (ParasiticStackedDenseLayer,
                                      ParasiticStarDenseLayer,
                                      StackedDenseLayer, StarDenseLayer)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-5)
GEN = torch.Generator().manual_seed(0)
B, D, U = 19, 7, 5


def _rand(*shape, seed=0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) + shift).astype(
        np.float32)


def _jitter(params, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape) * scale, jnp.float32),
        params)


def _check(jfn, params, jinputs, port, tinputs, call):
    """Outputs, and the gradients of sum(out * w) in every parameter and
    in each float input, port vs JAX."""
    sd = from_jax_params(jax.device_get(params))
    port.load_state_dict(sd, strict=True)
    want = np.asarray(jfn(params, *jinputs))
    xs = [t.clone().requires_grad_() for t in tinputs]
    out = call(port, *xs)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    w = _rand(*want.shape, seed=99)
    gp, *gx = jax.grad(lambda p, *a: jnp.sum(jfn(p, *a) * w),
                       argnums=tuple(range(len(jinputs) + 1)))(
        params, *jinputs)
    gwant = from_jax_params(jax.device_get(gp))
    own = dict(port.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                list(own.values()) + xs, allow_unused=True)
    assert set(own) == set(gwant)
    for name, g in zip(own, grads):
        g = torch.zeros_like(own[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), gwant[name].numpy(),
                                   err_msg=name, **GTOL)
    for got, ref in zip(grads[len(own):], gx):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GTOL)
    return gwant


@pytest.mark.parametrize("nets,use_bias,act", [(1, True, None),
                                               (2, True, "tanh"),
                                               (3, False, "relu")])
def test_star_dense_matches_flax(nets, use_bias, act):
    x = _rand(B, D, seed=1)
    size = StarDenseLayer.get_starnet_param_size(D, U)
    assert size == D * U + U
    stars = [_rand(B, size, seed=2 + i, shift=1.0) for i in range(nets)]
    jm = JaxStar(units=U, use_bias=use_bias, activation=act)
    jstars = [jnp.asarray(s) for s in stars]
    jarg = jstars if nets > 1 else jstars[0]
    params = _jitter(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jarg), 3)
    port = StarDenseLayer(D, U, GEN, use_bias=use_bias, activation=act,
                          device="cpu")
    assert port.weight.shape == (U, D)

    def jfn(p, xx, *ss):
        return jm.apply(p, xx, list(ss) if nets > 1 else ss[0])

    def call(m, xx, *ss):
        return m(xx, list(ss) if nets > 1 else ss[0])

    _check(jfn, params, [jnp.asarray(x)] + jstars, port,
           [torch.from_numpy(x)] + [torch.from_numpy(s) for s in stars],
           call)


def test_star_helpers_and_ones_rows():
    assert torch.equal(StarDenseLayer.get_starnet_kernel_initializer()(
        (2, 3), None), torch.ones(2, 3))
    assert torch.equal(StarDenseLayer.get_starnet_bias_initializer()(
        (3,), None), torch.zeros(3))
    port = StarDenseLayer(D, U, GEN, device="cpu")
    x = torch.from_numpy(_rand(B, D, seed=4))
    ones = torch.ones(B, D * U + U)
    # star rows of ones reproduce the trunk dense layer, also for two nets
    plain = x @ port.weight.t() + port.bias
    for arg in (ones, [ones, ones]):
        torch.testing.assert_close(port(x, arg), plain)


@pytest.mark.parametrize("nets,weight", [(1, 1.0), (2, 0.3)])
def test_stacked_dense_matches_flax(nets, weight):
    x = _rand(B, D, seed=5)
    size = StackedDenseLayer.get_resnet_param_size(D, U)
    res = [_rand(B, size, seed=6 + i) * 0.2 for i in range(nets)]
    jm = JaxStacked(units=U, activation="tanh")
    jres = [jnp.asarray(r) for r in res]
    params = _jitter(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                             jres), 7)
    port = StackedDenseLayer(D, U, GEN, activation="tanh", device="cpu")

    def jfn(p, xx, *rs):
        return jm.apply(p, xx, list(rs) if nets > 1 else rs[0], weight)

    def call(m, xx, *rs):
        return m(xx, list(rs) if nets > 1 else rs[0], weight)

    _check(jfn, params, [jnp.asarray(x)] + jres, port,
           [torch.from_numpy(x)] + [torch.from_numpy(r) for r in res], call)
    assert torch.equal(StackedDenseLayer.get_resnet_kernel_initializer()(
        (2, 2), None), torch.zeros(2, 2))


ROUTINGS = ["per_sample", "int", "none", "negative"]
P_OPTS = [dict(), dict(use_bias=False), dict(activation=None),
          dict(parasitic_kernel_initializer="zeros")]


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("opts", range(len(P_OPTS)))
def test_parasitic_layers_match_flax(stacked, routing, opts):
    kw = dict(P_OPTS[opts])
    x = _rand(B, D, seed=8)
    dom = np.random.RandomState(9).randint(0, 3, B).astype(np.int32)
    group = {"per_sample": dom, "int": 2, "none": None,
             "negative": -1}[routing]
    jcls, tcls = ((JaxPStacked, ParasiticStackedDenseLayer) if stacked
                  else (JaxPStar, ParasiticStarDenseLayer))
    jkw = dict(kw)
    jkw.setdefault("activation", "relu")       # the port's default
    jm = jcls(units=U, num_groups=3, **jkw)
    params = _jitter(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), 0), 10)
    port = tcls(D, U, 3, GEN, device="cpu", **kw)
    jg = jnp.asarray(group) if routing == "per_sample" else group
    tg = torch.from_numpy(group) if routing == "per_sample" else group
    for stop in (False, True):
        gw = _check(lambda p, xx: jm.apply(p, xx, jg, stop), params,
                    [jnp.asarray(x)], port, [torch.from_numpy(x)],
                    lambda m, xx: m(xx, tg, stop))
        if stop:
            assert not gw["trunk_kernel"].any()


def test_parasitic_inits():
    star = ParasiticStarDenseLayer(D, U, 2, GEN, device="cpu")
    stacked = ParasiticStackedDenseLayer(D, U, 2, GEN, device="cpu")
    assert torch.equal(star.parasitic_kernel.detach(), torch.ones(2, D, U))
    assert torch.equal(stacked.parasitic_kernel.detach(),
                       torch.zeros(2, D, U))
    x = torch.from_numpy(_rand(B, D, seed=11))
    # at init both give the trunk for any group
    for layer in (star, stacked):
        torch.testing.assert_close(layer(x, 1), layer(x, None))
    nb = ParasiticStarDenseLayer(D, U, 2, GEN, device="cpu", use_bias=False)
    assert nb.trunk_bias is None and nb.parasitic_bias is None
    assert set(dict(nb.named_parameters())) == {"trunk_kernel",
                                                "parasitic_kernel"}
