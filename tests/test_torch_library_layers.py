"""Port vs JAX: DCN, the sparse field GNN, fix-length, SENET's list path,
the element-wise weights and target attention.

* ``DCNLayer`` (degrees 1 and 3, with and without a bias, an
  activation): outputs and every gradient against ``jax.grad``; its
  init's glorot bound from Flax's n-D fans;
* ``SparseGNNLayer`` over its layout grid: (B, F, D), (B, D, F), (B,
  F * D), a list of fields, and D == F (taken as (B, F, D)); the graph as
  a dict, an edge list or an undirected edge list; shared and per-layer
  weights; ``return_all_layers``, ``transpose_outputs``,
  ``flattern_outputs``; the edge weights' gradients (the dense matrix is
  a non-accumulating ``index_put``); the validation errors;
* ``FixLengthLayer`` padding and truncating on several axes;
* ``SENETLayer`` on a list of fields of unequal dims, and one (B, D)
  tensor as one field;
* ``gather_embedding_element_wise_weight``;
* ``attention_by_dot_product`` (``filter_neg`` off and on),
  ``DNNAttention`` (dims ending in 1 and not, a mask) and
  ``attention_by_dnn``.

Flax-initialised weights, jittered, carried by ``convert.from_jax_params``
and loaded strictly.  f32 on both sides: outputs rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers import DCNLayer as JaxDCN
from rec_now_tpu.layers import FixLengthLayer as JaxFix
from rec_now_tpu.layers import SENETLayer as JaxSENET
from rec_now_tpu.layers import SparseGNNLayer as JaxGNN
from rec_now_tpu.rec_block import attention as jatt
from rec_now_tpu.rec_block.embedding_wise_weight import \
    gather_embedding_element_wise_weight as jax_gather
from rec_now_tpu_torch.convert import from_jax_params
from rec_now_tpu_torch.layers import (DCNLayer, FixLengthLayer, SENETLayer,
                                      SparseGNNLayer)
from rec_now_tpu_torch.layers.sparse_gnn_layer import \
    list_of_edge_to_neighbors
from rec_now_tpu_torch.rec_block import (DNNAttention, attention_by_dnn,
                                         attention_by_dot_product,
                                         gather_embedding_element_wise_weight)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-5)
GEN = torch.Generator().manual_seed(0)
B = 23


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jitter(params, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape) * scale, jnp.float32),
        params)


def _grads(jfn, params, jinputs, port, outs, xs, ct):
    """Every parameter's and each input's gradient of sum(out * ct)."""
    gp, *gx = jax.grad(lambda p, *a: jnp.sum(jfn(p, *a) * ct),
                       argnums=tuple(range(len(jinputs) + 1)))(
        params, *jinputs)
    want = from_jax_params(jax.device_get(gp))
    own = dict(port.named_parameters())
    grads = torch.autograd.grad((outs * torch.from_numpy(ct)).sum(),
                                list(own.values()) + xs)
    assert set(own) == set(want)
    for name, g in zip(own, grads):
        assert float(want[name].abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GTOL)
    for got, ref in zip(grads[len(own):], gx):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GTOL)


def _load(module, params):
    module.load_state_dict(from_jax_params(jax.device_get(params)),
                           strict=True)
    return module


@pytest.mark.parametrize("degree,use_bias,act", [(1, True, None),
                                                 (3, True, "tanh"),
                                                 (2, False, None)])
def test_dcn_matches_flax(degree, use_bias, act):
    x = _rand(B, 11, seed=1) * 0.5
    jm = JaxDCN(degree_of_cross=degree, use_bias=use_bias, activation=act)
    params = _jitter(jm.init(jax.random.PRNGKey(0), x), 2, scale=0.2)
    port = _load(DCNLayer(11, degree, GEN, use_bias=use_bias,
                          activation=act, device="cpu"), params)
    want = np.asarray(jm.apply(params, x))
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    _grads(jm.apply, params, [jnp.asarray(x)], port, out, [xt],
           _rand(B, 11, seed=3))


def test_dcn_init_has_flax_fans():
    layer = DCNLayer(429, 3, torch.Generator().manual_seed(1), device="cpu")
    assert layer.kernels.shape == (3, 429, 1)
    assert layer.biases.shape == (3, 1, 429) and not layer.biases.any()
    limit = math.sqrt(6.0 / (429 * 3 + 3))
    k = layer.kernels.detach()
    assert float(k.abs().max()) <= limit and float(k.abs().max()) > 0.9 * \
        limit
    flax = JaxDCN(degree_of_cross=3).init(jax.random.PRNGKey(0),
                                          jnp.ones((2, 429)))
    assert float(jnp.abs(flax["params"]["kernels"]).max()) <= limit


FIELDS = ["user_id", "user_age", "doc_id", "doc_subject"]
F2N = {"user_id": ["doc_id", "doc_subject"], "user_age": ["doc_subject"],
       "doc_subject": ["user_age"]}
EDGES = [("user_id", "doc_id"), ("user_id", "doc_subject"),
         ("user_age", "doc_subject"), ("doc_subject", "user_age")]
GNN_GRAPHS = {"dict": F2N, "edges": EDGES,
              "undirected": [("user_id", "doc_id"), ("doc_id", "user_age")]}


def _gnn_input(layout, d, seed):
    x = _rand(B, len(FIELDS), d, seed=seed)
    if layout == "BFD":
        return x
    if layout == "BDF":
        return np.ascontiguousarray(np.transpose(x, (0, 2, 1)))
    if layout == "flat":
        return x.reshape(B, -1)
    return [np.ascontiguousarray(x[:, i]) for i in range(len(FIELDS))]


GNN_CASES = [
    ("BFD", 3, "dict", 1, True, {}),
    ("BDF", 3, "dict", 2, True, {}),
    ("flat", 5, "edges", 2, False, {}),
    ("list", 3, "dict", 3, False, {"return_all_layers": True}),
    ("BFD", 4, "dict", 2, False, {"transpose_outputs": False}),
    ("BFD", 3, "undirected", 2, True, {"flattern_outputs": False}),
    ("BDF", 6, "edges", 1, True, {"transpose_outputs": False,
                                  "flattern_outputs": False}),
]


@pytest.mark.parametrize("layout,d,graph,layers,share,kw", GNN_CASES)
def test_sparse_gnn_matches_flax(layout, d, graph, layers, share, kw):
    """D == F (d = 4) takes the middle axis as F, as JAX does."""
    f2n = GNN_GRAPHS[graph]
    jf2n = (list_of_edge_to_neighbors(f2n, directed=False)
            if graph == "undirected" else f2n)
    x = _gnn_input(layout, d, seed=len(kw) + d)
    jx = [jnp.asarray(a) for a in x] if layout == "list" else jnp.asarray(x)
    jm = JaxGNN(fields=FIELDS, field2neighbors=jf2n, num_layers=layers,
                share_weights_between_layers=share)
    params = _jitter(jm.init(jax.random.PRNGKey(0), jx), 4)
    port = _load(SparseGNNLayer(FIELDS, jf2n, num_layers=layers,
                                share_weights_between_layers=share,
                                device="cpu"), params)
    assert len(params["params"]) == (1 if share else layers)
    want = jm.apply(params, jx, **kw)
    xs = ([torch.from_numpy(a).requires_grad_() for a in x]
          if layout == "list" else [torch.from_numpy(x).requires_grad_()])
    got = port(xs if layout == "list" else xs[0], **kw)
    if kw.get("return_all_layers"):
        assert len(got) == len(want) == layers
    else:
        got, want = [got], [want]
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(c), **TOL)
    ct = _rand(*np.shape(want[-1]), seed=5)

    def jfn(p, *a):
        out = jm.apply(p, list(a) if layout == "list" else a[0], **kw)
        return out[-1] if kw.get("return_all_layers") else out

    _grads(jfn, params, jx if layout == "list" else [jx], port, got[-1], xs,
           ct)


def test_sparse_gnn_init_and_validation():
    layer = SparseGNNLayer(FIELDS, F2N, num_layers=2,
                           share_weights_between_layers=False, device="cpu")
    assert torch.equal(layer.weights_1.detach(), torch.full((4,), 0.1))
    assert layer.edge_index.tolist() == [[1, 3], [2, 0], [3, 0], [3, 1]]
    assert "edge_index" not in layer.state_dict()
    assert list_of_edge_to_neighbors([("a", "b")], directed=False) == {
        "a": {"b"}, "b": {"a"}}
    with pytest.raises(ValueError, match="duplicated"):
        SparseGNNLayer(["a", "a"], {}, device="cpu")
    with pytest.raises(ValueError, match="not in fields"):
        SparseGNNLayer(["a"], {"b": ["a"]}, device="cpu")
    with pytest.raises(ValueError, match="not in fields"):
        SparseGNNLayer(["a"], {"a": ["c"]}, device="cpu")
    with pytest.raises(TypeError, match="field2neighbors"):
        SparseGNNLayer(["a"], "a:b", device="cpu")
    with pytest.raises(ValueError, match="embedding_dim"):
        layer(torch.zeros(2, 7))


FIX_CASES = [((3, 5), 8, -1, 0), ((3, 5), 2, -1, 0), ((3, 5, 4), 7, 1, -1.5),
             ((3, 5, 4), 2, 0, 0), ((3, 5), 5, -1, 0)]


@pytest.mark.parametrize("shape,length,axis,value", FIX_CASES)
def test_fix_length_matches_jax(shape, length, axis, value):
    x = _rand(*shape, seed=6)
    want = JaxFix(length=length, axis=axis, constant_values=value).apply(
        {}, jnp.asarray(x))
    layer = FixLengthLayer(length, axis, value, device="cpu")
    got = layer(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = np.arange(12).reshape(3, 4)
    np.testing.assert_array_equal(
        FixLengthLayer(6, device="cpu")(ids.tolist()).numpy(),
        np.asarray(JaxFix(length=6).apply({}, jnp.asarray(ids))))


def test_senet_list_path_matches_flax():
    dims = [3, 8, 1, 5, 8]
    fields = [_rand(B, d, seed=10 + i) for i, d in enumerate(dims)]
    jm = JaxSENET(reduction_ratio=0.5)
    jf = [jnp.asarray(f) for f in fields]
    params = _jitter(jm.init(jax.random.PRNGKey(0), jf), 11, scale=0.3)
    port = _load(SENETLayer(len(dims), 0.5, GEN, device="cpu"), params)
    want = np.asarray(jm.apply(params, jf))
    xs = [torch.from_numpy(f).requires_grad_() for f in fields]
    got = port(xs)
    assert got.shape == (B, sum(dims))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    _grads(lambda p, *a: jm.apply(p, list(a)), params, jf, port, got, xs,
           _rand(B, sum(dims), seed=12))
    # one (B, D) tensor is one field
    one = _rand(B, 6, seed=13)
    jm1 = JaxSENET(reduction_ratio=0.5)
    p1 = _jitter(jm1.init(jax.random.PRNGKey(1), jnp.asarray(one)), 14)
    port1 = _load(SENETLayer(1, 0.5, GEN, device="cpu"), p1)
    np.testing.assert_allclose(
        port1(torch.from_numpy(one)).detach().numpy(),
        np.asarray(jm1.apply(p1, jnp.asarray(one))), **TOL)


def test_element_wise_weight_matches_jax():
    w = _rand(B, 4, seed=15)
    pos = [0, 0, 1, 3, 3, 3, 2]
    want = np.asarray(jax_gather(jnp.asarray(w), pos))
    for idx in (pos, np.asarray(pos), torch.tensor(pos)):
        np.testing.assert_array_equal(
            gather_embedding_element_wise_weight(torch.from_numpy(w),
                                                 idx).numpy(), want)


@pytest.mark.parametrize("filter_neg", [False, True])
def test_dot_product_attention_matches_jax(filter_neg):
    user, doc = _rand(B, 9, 6, seed=16), _rand(B, 6, seed=17)
    ct = (_rand(B, 6, seed=18), _rand(B, 1, seed=19))

    def jfn(u, d):
        return jatt.attention_by_dot_product(u, d, filter_neg)

    want, vjp = jax.vjp(jfn, jnp.asarray(user), jnp.asarray(doc))
    u = torch.from_numpy(user).requires_grad_()
    d = torch.from_numpy(doc).requires_grad_()
    got = attention_by_dot_product(u, d, filter_neg)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(c), **TOL)
    gu, gd = torch.autograd.grad(got, (u, d), [torch.from_numpy(c)
                                               for c in ct])
    wu, wd = vjp(tuple(jnp.asarray(c) for c in ct))
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), **GTOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **GTOL)


@pytest.mark.parametrize("dims,masked", [((8, 1), False), ((8,), True),
                                         ((16, 8), True)])
def test_dnn_attention_matches_flax(dims, masked):
    user, doc = _rand(B, 9, 6, seed=20), _rand(B, 6, seed=21)
    mask = np.random.RandomState(22).rand(B, 9) > 0.3
    jm = jatt.DNNAttention(dnn_dims=list(dims))
    params = _jitter(jm.init(jax.random.PRNGKey(0), jnp.asarray(user),
                             jnp.asarray(doc)), 23)
    port = _load(DNNAttention(6, dims, GEN, device="cpu"), params)
    assert port.num_layers == len(dims) + (dims[-1] != 1)
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    want = jm.apply(params, jnp.asarray(user), jnp.asarray(doc), jmask)
    u = torch.from_numpy(user).requires_grad_()
    d = torch.from_numpy(doc).requires_grad_()
    got = port(u, d, tmask)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(c), **TOL)
    _grads(lambda p, uu, dd: jm.apply(p, uu, dd, jmask)[0], params,
           [jnp.asarray(user), jnp.asarray(doc)], port, got[0], [u, d],
           _rand(B, 6, seed=24))


def test_attention_by_dnn():
    user, doc = _rand(B, 5, 4, seed=25), _rand(B, 4, seed=26)
    tu, td = torch.from_numpy(user), torch.from_numpy(doc)
    attn, ssum, module = attention_by_dnn(tu, td, [8])
    assert attn.shape == (B, 4) and ssum.shape == (B, 1)
    assert isinstance(module, DNNAttention) and module.num_layers == 2
    again = attention_by_dnn(tu, td, [8], module=module)
    torch.testing.assert_close(again[0], attn, rtol=0, atol=0)
    assert again[2] is module
    # the module's parameters are JAX's params: loaded into Flax, the same
    jparams = {"params": {
        name: {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
               "bias": jnp.asarray(lin.bias.detach().numpy())}
        for name, lin in module.named_children()}}
    want = jatt.attention_by_dnn(jnp.asarray(user), jnp.asarray(doc), [8],
                                 params=jparams)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want[0]),
                               **TOL)
    np.testing.assert_allclose(ssum.detach().numpy(), np.asarray(want[1]),
                               **TOL)
