"""Port vs JAX: the hashes and the hash-trick layers.

* ``mix32``, ``salted_hash`` and ``combine_hash`` bit-exact: int32 ids
  (the int32 ends among them) against JAX in its default mode (x64 off);
  int64 ids past 2^31 and negative against JAX under ``jax.enable_x64``,
  where JAX folds them as the port does; in the default mode JAX wraps
  int64 ids to int32, so there only ids in [0, 2^32) agree (shown);
* ``MultiHashLayer`` and ``FastMultiHashLayer`` on Flax-initialised
  tables (jittered, carried by ``convert.from_jax_params``, loaded
  strictly): every combiner, ``get``, ``get_pooling`` with and without
  weights, salts as an int and as a short list, the bins without a
  table, and the tables' gradients against ``jax.grad``; the default
  init's U(-1e-4, 1e-4);
* ``CartesianProductLayer`` bit-exact: (B, L), (B,) and batch-1 inputs,
  invalid values with a default id, the length check; its ids through a
  downstream ``salted_hash`` give JAX's bins.

Hashes exact; embeddings and their gradients rtol 1e-5 / atol 1e-7 (f32,
summed in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers import CartesianProductLayer as JaxCross
from rec_now_tpu.layers import FastMultiHashLayer as JaxFast
from rec_now_tpu.layers import MultiHashLayer as JaxMulti
from rec_now_tpu.ops import hashing as jh
from rec_now_tpu_torch.convert import from_jax_params
from rec_now_tpu_torch.layers import (CartesianProductLayer,
                                      FastMultiHashLayer, MultiHashLayer)
from rec_now_tpu_torch.ops import hashing as th

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)
GEN = torch.Generator().manual_seed(0)
I32 = np.array([0, 1, 5, 7, -1, -3, 2**31 - 1, -2**31, 123456789,
                -987654321, 2**16, 65535], np.int32)
I64 = np.array([2**40 + 5, 5, -3, 2**31 + 7, -2**63, 2**63 - 1, 0,
                2**32, -2**32 - 1, 2**31 - 1], np.int64)


def _u32(a):
    """JAX's uint32 words as int64, the port's form."""
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("salt", [0, 1, 7, 2**32 + 5, -3])
@pytest.mark.parametrize("bins", [1, 17, 1000, 2**20])
def test_salted_hash_int32_bit_exact(salt, bins):
    want = np.asarray(jh.salted_hash(jnp.asarray(I32), salt, bins))
    got = th.salted_hash(torch.from_numpy(I32), salt, bins)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_mix32_and_combine_int32_bit_exact():
    np.testing.assert_array_equal(
        th.mix32(torch.from_numpy(I32)).numpy(),
        _u32(jh.mix32(jnp.asarray(I32))))
    assert th.splitmix64 is th.mix32
    b = I32[::-1].copy()
    np.testing.assert_array_equal(
        th.combine_hash(torch.from_numpy(I32), torch.from_numpy(b)).numpy(),
        _u32(jh.combine_hash(jnp.asarray(I32), jnp.asarray(b))))
    # a wider random draw, other integer dtypes cast as JAX casts them
    ids = np.random.RandomState(0).randint(-2**31, 2**31 - 1, 4096,
                                           dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        th.salted_hash(torch.from_numpy(ids), 3, 997).numpy(),
        np.asarray(jh.salted_hash(jnp.asarray(ids), 3, 997)))
    small = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(
        th.salted_hash(torch.from_numpy(small), 2, 50).numpy(),
        np.asarray(jh.salted_hash(jnp.asarray(small), 2, 50)))
    with pytest.raises(TypeError, match="integer"):
        th.salted_hash(torch.zeros(3), 1, 10)


def test_int64_ids_fold_as_jax_x64():
    with jax.enable_x64():
        want = np.asarray(jh.salted_hash(jnp.asarray(I64), 1, 1000))
        want_c = _u32(jh.combine_hash(jnp.asarray(I64),
                                      jnp.asarray(I64[::-1].copy())))
        want_b = np.asarray(jh.salted_hash(jnp.asarray(I64), 9, 2**20))
    t = torch.from_numpy(I64)
    np.testing.assert_array_equal(th.salted_hash(t, 1, 1000).numpy(), want)
    np.testing.assert_array_equal(th.salted_hash(t, 9, 2**20).numpy(),
                                  want_b)
    np.testing.assert_array_equal(
        th.combine_hash(t, torch.from_numpy(I64[::-1].copy())).numpy(),
        want_c)
    # JAX's default mode wraps int64 ids to int32 before hashing: ids in
    # [0, 2^32) agree with the port's int64 fold (their hi word is 0 and
    # mix32(0) = 0), the others do not
    default = np.asarray(jh.salted_hash(jnp.asarray(I64), 1, 1000))
    small = (I64 >= 0) & (I64 < 2**32)
    np.testing.assert_array_equal(
        th.salted_hash(t, 1, 1000).numpy()[small], default[small])
    assert (th.salted_hash(t, 1, 1000).numpy()[~small]
            != default[~small]).any()


def _jitter(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape) * scale, jnp.float32),
        params)


def _load(module, params):
    module.load_state_dict(from_jax_params(jax.device_get(params)),
                           strict=True)
    return module


MH_CASES = [("multi", 2, 1), ("multi", 3, [5, 11]), ("multi", 1, 4),
            ("fast", 2, 1), ("fast", 3, [5, 11])]


@pytest.mark.parametrize("kind,num_hash,salts", MH_CASES)
def test_multi_hash_layers_match_flax(kind, num_hash, salts):
    ids = np.random.RandomState(1).randint(-50, 10**6, (13, 4)).astype(
        np.int32)
    w = np.random.RandomState(2).rand(13, 4).astype(np.float32)
    jcls, tcls = ((JaxMulti, MultiHashLayer) if kind == "multi"
                  else (JaxFast, FastMultiHashLayer))
    kw = dict(num_bins=37, embedding_dim=6, num_hash=num_hash, salts=salts)
    jm = jcls(**kw)
    params = _jitter(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids)), 3)
    port = _load(tcls(**kw, generator=GEN, device="cpu"), params)
    tids = torch.from_numpy(ids)
    for combiner in ("sum", "mean", "concat", None):
        want = jm.apply(params, jnp.asarray(ids), combiner=combiner)
        got = port(tids, combiner=combiner)
        if isinstance(want, list):
            assert isinstance(got, list) and len(got) == len(want)
        else:
            want, got = [want], [got]
        for a, c in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(c),
                                       **TOL)
    np.testing.assert_allclose(
        port.get(tids[:, 0]).detach().numpy(),
        np.asarray(jm.apply(params, jnp.asarray(ids[:, 0]),
                            method=jm.get)), **TOL)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        want = jm.apply(params, jnp.asarray(ids), jw, method=jm.get_pooling)
        np.testing.assert_allclose(
            port.get_pooling(tids, tw).detach().numpy(), np.asarray(want),
            **TOL)
    # the tables' gradients through the weighted pooling
    ct = np.random.RandomState(4).randn(13, 6).astype(np.float32)
    gp = jax.grad(lambda p: jnp.sum(jm.apply(
        p, jnp.asarray(ids), jnp.asarray(w), method=jm.get_pooling) * ct))(
        params)
    want = from_jax_params(jax.device_get(gp))
    loss = (port.get_pooling(tids, torch.from_numpy(w))
            * torch.from_numpy(ct)).sum()
    own = dict(port.named_parameters())
    grads = torch.autograd.grad(loss, list(own.values()))
    assert set(own) == set(want)
    for name, g in zip(own, grads):
        assert float(want[name].abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("kind", ["multi", "fast"])
def test_hash_bins_without_a_table(kind):
    ids = np.array([[5, 6, 7], [1, 2**31 - 1, 0]], np.int32)
    jcls, tcls = ((JaxMulti, MultiHashLayer) if kind == "multi"
                  else (JaxFast, FastMultiHashLayer))
    jm = jcls(num_bins=10, num_hash=3)
    port = tcls(num_bins=10, num_hash=3, device="cpu")
    assert not list(port.parameters())
    for combiner in ("concat", "sum", None):
        want = jm.apply({}, jnp.asarray(ids), combiner=combiner)
        got = port(ids.tolist(), combiner=combiner)       # a list is placed
        if isinstance(want, list):
            for a, c in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multi_hash_default_init_and_generator():
    layer = FastMultiHashLayer(num_bins=500, embedding_dim=8, num_hash=2,
                               generator=torch.Generator().manual_seed(3),
                               device="cpu")
    t = layer.embedding.detach()
    assert t.shape == (1000, 8)
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 3e-5
    again = FastMultiHashLayer(num_bins=500, embedding_dim=8, num_hash=2,
                               generator=torch.Generator().manual_seed(3),
                               device="cpu")
    assert torch.equal(t, again.embedding.detach())
    with pytest.raises(ValueError, match="generator"):
        MultiHashLayer(num_bins=4, embedding_dim=2, device="cpu")


CROSS_CASES = [
    ("2-D x 2-D", [np.array([[1, 2], [3, 4]]),
                   np.array([[10, 20, 30], [40, 50, 60]])], None, 0),
    ("batch-1 broadcast", [np.array([[1, 2]]), np.array([[10], [20], [30]])],
     None, 0),
    ("1-D x 2-D x batch-1", [np.arange(5), np.arange(10).reshape(5, 2),
                             np.array([[-7, 2**31 - 1, -2**31]])], None, 0),
    ("invalid values", [np.array([[0, 1], [2, 0]]), np.array([[5], [0]]),
                        np.array([3])], [0, None, 3], 99),
    ("invalid, default 0", [np.array([[0, 1]]), np.array([[5]])],
     [0, None], 0),
]


@pytest.mark.parametrize("name,inputs,invalid,default", CROSS_CASES,
                         ids=[c[0] for c in CROSS_CASES])
def test_cartesian_product_bit_exact(name, inputs, invalid, default):
    inputs = [x.astype(np.int32) for x in inputs]
    want = JaxCross().apply({}, [jnp.asarray(x) for x in inputs],
                            invalid_value_list=invalid,
                            default_result_id=default)
    layer = CartesianProductLayer(device="cpu")
    got = layer([torch.from_numpy(x) for x in inputs],
                invalid_value_list=invalid, default_result_id=default)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), _u32(want))
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    # int64 inputs in [0, 2^32) cross the same (a negative int64 id is
    # folded, as JAX does under x64)
    if all((x >= 0).all() for x in inputs):
        np.testing.assert_array_equal(
            layer([torch.from_numpy(x.astype(np.int64)) for x in inputs],
                  invalid_value_list=invalid,
                  default_result_id=default).numpy(), _u32(want))
    # downstream: the crossed ids hash to JAX's bins
    np.testing.assert_array_equal(
        th.salted_hash(got, 3, 2**20).numpy(),
        np.asarray(jh.salted_hash(want, 3, 2**20)))


def test_cartesian_length_mismatch_raises():
    with pytest.raises(ValueError, match="length not equal"):
        CartesianProductLayer(device="cpu")(
            [torch.ones(1, 1, dtype=torch.int32)], invalid_value_list=[1, 2])
