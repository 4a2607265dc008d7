"""Port vs JAX: the batched multi-expert dense (kernel B8's op).

The port's ``multi_dense_apply`` on the CPU (autograd through its XLA
formula), the kernel's plain version, and the kernel's
``autograd.Function`` with its hand-written backward (what runs on the
card, here with the plain forward) against the JAX package's
``multi_dense_pallas`` (interpreted on the CPU), ``multi_dense_xla`` and
``jax.vjp`` of ``_multi_dense_fused``; then ``MultiDenseLayer`` from
converted Flax weights; and the split-TF32 arithmetic of the card's
kernel, emulated in torch, against f64.  Shapes cover a shared and a
per-expert input, ReLU and none, with and without bias, U = 4 (the gate
bank), odd D and a B that is not a multiple of the TPU's 8-row tiling.
f32 on the CPU on both sides, summed in other orders over at most D = 45
terms (outputs) and B = 37 rows (weight gradients): rtol 1e-5, atol
1e-6.
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
        multi_dense_apply(_t(x), _t(w), _t(bias), "swish")


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


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: 0x1000 added to the bit pattern, then
    the low 13 bits cleared."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


# config 4's four banks (inputs' leading dim, experts, D, U)
CONFIG4_BANKS = [(1, 4, 429, 128), (4, 4, 128, 64), (1, 2, 429, 4),
                 (1, 2, 128, 64)]


@pytest.mark.parametrize("nx,n,d,u", CONFIG4_BANKS)
def test_split_tf32_is_as_close_to_f64_as_f32(nx, n, d, u):
    """The card's expert-bank kernel takes its products on the tensor
    cores in split TF32: v = hi + lo, hi = rna(v), lo = rna(v - hi), and
    the sum lo*hi + hi*lo + hi*hi.  Emulated here (each product of two
    TF32 values is exact in f32), it lands within 1e-5 of max|out| of the
    f64 product on config 4's banks at B = 256, as plain f32 does; one
    TF32 pass (hi*hi) lands above 1e-4, the tolerance the port holds the
    kernel to, which is why the kernel splits."""
    rng = np.random.RandomState(d + u)
    x = torch.from_numpy(rng.randn(nx, 256, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(n, d, u) / np.sqrt(d)).astype(np.float32))
    want = torch.matmul(x.double(), w.double())
    xh, wh = _tf32_rna(x), _tf32_rna(w)
    xl, wl = _tf32_rna(x - xh), _tf32_rna(w - wh)
    # hi + lo keeps 22 of the 24 bits of each operand
    assert bool(((xh + xl - x).abs() <= x.abs() * 2.0 ** -21).all())
    split = (torch.matmul(xl, wh) + torch.matmul(xh, wl)
             + torch.matmul(xh, wh))
    scale = float(want.abs().max())

    def err(got):
        return float((got.double() - want).abs().max()) / scale

    assert err(split) <= 1e-5
    assert err(torch.matmul(x, w)) <= 1e-5
    assert err(torch.matmul(xh, wh)) > 1e-4
    # the rounding keeps 10 mantissa bits and is ties-away
    assert not (xh.view(torch.int32) & 0x1FFF).any()
    half = torch.tensor([1.0 + 2.0 ** -11], dtype=torch.float32)
    assert float(_tf32_rna(half)) == 1.0 + 2.0 ** -10


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
    # the port's own init: Flax's glorot fans, where the expert axis is
    # receptive field (D * N, U * N), as Flax's own init shows; zero bias
    fresh = MultiDenseLayer(d, u, n, torch.Generator().manual_seed(0),
                            device="cpu")
    limit = np.sqrt(6.0 / ((d + u) * n))
    flax_k = np.asarray(layer.init(jax.random.PRNGKey(1), x)["params"]
                        ["kernel"])
    assert limit >= np.abs(flax_k).max() > 0.8 * limit
    k = fresh.kernel.detach()
    assert k.shape == (n, d, u)
    assert limit >= float(k.abs().max()) > 0.8 * limit
    assert not fresh.bias.any()


# -- the wgmma path's plan (csrc/multi_dense.cu (c)) -------------------------
# (b, d, u, aligned, taken): DLRM-DCNv2's over arch and its dense arch's
# last two layers at B = 8,192 (256 -> 128 at exactly WGMMA_MIN_OUTPUTS);
# its dense arch's 13-wide rows (TMA reads rows of 16-byte multiples);
# xDeepFM's 390-wide rows and 400 -> 400 at B = 8,192 and 1,024 (too
# small); rows off the 16-byte grid; one row; a one-unit head; an empty
# batch; the 256 -> 128 layer of configs 2, 3 and 5 at B = 1,000; each
# side of the measured crossover (400 -> 400 and 512 -> 256 by B)
PLAN_CASES = [
    (8192, 3456, 1024, True, True),
    (8192, 1024, 1024, True, True),
    (8192, 1024, 512, True, True),
    (8192, 512, 256, True, True),
    (8192, 256, 128, True, True),
    (8192, 13, 512, True, False),
    (8192, 390, 400, True, False),
    (8192, 400, 400, True, True),
    (1024, 400, 400, True, False),
    (8192, 3456, 1024, False, False),
    (1, 3456, 1024, True, False),
    (8192, 400, 1, True, False),
    (0, 512, 256, True, False),
    (1000, 256, 128, True, False),
    (2048, 400, 400, True, False),
    (4096, 400, 400, True, True),
    (4096, 512, 256, True, True)]


@pytest.mark.parametrize("b,d,u,aligned,taken", PLAN_CASES)
def test_wgmma_plan_decides_by_shape_and_alignment(b, d, u, aligned, taken):
    assert mk.wgmma_plan(b, d, u, aligned) is taken
    assert b * u >= mk.WGMMA_MIN_OUTPUTS or not taken


def test_linear_wg_leaves_cpu_tensors_to_the_caller():
    """linear_wg runs only on the card: a CPU input of a shape the plan
    takes gives None and launches nothing."""
    x = torch.zeros(8192, 512)
    w, b = torch.zeros(256, 512), torch.zeros(256)
    assert mk.wgmma_plan(8192, 512, 256, x.data_ptr() % 16 == 0)
    before = mk.linear_wg.launches
    assert mk.linear_wg(x, w, b, True) is None
    assert mk.linear_wg.launches == before


@pytest.mark.parametrize("relu_last", [True, False])
def test_tower_asks_linear_wg_only_without_grad(monkeypatch, relu_last):
    """DNNTower asks linear_wg for every layer (with the layer's own
    weight and bias and its ReLU flag) where no gradient is recorded,
    never where one is, and runs nn.Linear (+ ReLU) where it gives
    None."""
    from rec_now_tpu_torch.models.tower import DNNTower
    asked = []

    def refuse(x, weight, bias, relu):
        asked.append((tuple(x.shape), weight, bias, relu))
        return None

    monkeypatch.setattr(mk, "linear_wg", refuse)
    gen = torch.Generator().manual_seed(5)
    tower = DNNTower(12, (16, 8, 4), gen, device="cpu")
    x = torch.randn(9, 12, generator=gen)
    with_grad = tower(x, relu_last=relu_last)
    assert asked == []
    layers = [tower.dense_0, tower.dense_1, tower.dense_2]
    for mode in (torch.no_grad, torch.inference_mode):
        asked.clear()
        with mode():
            got = tower(x, relu_last=relu_last)
        assert [(s, w, b, r) for s, w, b, r in asked] == [
            ((9, 12), layers[0].weight, layers[0].bias, True),
            ((9, 16), layers[1].weight, layers[1].bias, True),
            ((9, 8), layers[2].weight, layers[2].bias, relu_last)]
        assert torch.equal(got, with_grad.detach())
