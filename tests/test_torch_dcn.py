"""Port vs JAX: DCN-v2 + SENET (benchmark config 2) and its layers.

``SENETLayer`` (the stacked (B, F, D) path), ``DCNMixLayer`` and
``DCNv2Model`` at the ``__graft_entry__.entry`` shape (B = 256, F = 26,
D = 16, 13 dense, the model's default widths): outputs and every
parameter's and the inputs' gradients against Flax (``jax.grad``), on
Flax-initialised weights jittered so that biases are not zero, carried
over by ``convert.from_jax_params``; a real full-width DCN-v2 tree loads
with ``strict=True``; the port's own init has Flax's shapes and glorot
bounds; config-2 serving on the CPU (raw, u8, f16 wire) against the JAX
scorers.  f32 on the CPU on both sides, summed in other orders: outputs
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5 (sums over the
batch of 256); wire scorers port vs JAX atol 1e-5 and within the JAX
serving test's wire-vs-raw tolerances (f16 2e-3, u8 3e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers.dcn_mix_layer import DCNMixLayer as JaxDCNMix
from rec_now_tpu.layers.senet_layer import SENETLayer as JaxSENET
from rec_now_tpu.models import DCNv2Model as JaxDCN
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.serving import WireScorer as JaxWireScorer
from rec_now_tpu.serving import build_scorer as jax_build_scorer
from rec_now_tpu.training import SyntheticCriteo, Trainer, TrainerConfig
from rec_now_tpu_torch.convert import from_jax_params, table_from_packed
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.layers.dcn_mix_layer import DCNMixLayer
from rec_now_tpu_torch.layers.senet_layer import SENETLayer
from rec_now_tpu_torch.models import DCNv2Model, FeatureConfig
from rec_now_tpu_torch.serving import ServingState, WireScorer, build_scorer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-5)
GEN = torch.Generator()
B, F, D, ND = 256, 26, 16, 13


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jitter(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape) * scale, jnp.float32),
        params)


def _load(module, params):
    sd = from_jax_params(jax.device_get(params))
    module.load_state_dict(sd, strict=True)
    return module


def _grads_match(jfn, params, jinputs, port, inputs, w):
    """Every parameter's and each input's gradient of sum(out * w)."""
    gp, *gx = jax.grad(lambda p, *xs: jnp.sum(jfn(p, *xs) * w),
                       argnums=tuple(range(len(jinputs) + 1)))(
        params, *jinputs)
    want = from_jax_params(jax.device_get(gp))
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    own = dict(port.named_parameters())
    loss = (port(*xs) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, list(own.values()) + xs)
    assert set(want) == set(own)
    for name, g in zip(own, grads):
        assert float(want[name].abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GTOL)
    for got, ref in zip(grads[len(own):], gx):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GTOL)


def test_senet_matches_flax():
    emb = _rand(B, F, D, seed=1)
    jm = JaxSENET(reduction_ratio=0.5)
    params = _jitter(jm.init(jax.random.PRNGKey(0), emb), 2, scale=0.2)
    port = _load(SENETLayer(F, 0.5, GEN, device="cpu"), params)
    assert port.senet.dense_0.weight.shape == (13, F)    # mid = round(F/2)
    want = np.asarray(jm.apply(params, emb))
    got = port(torch.from_numpy(emb)).detach().numpy()
    assert got.shape == (B, F * D)
    np.testing.assert_allclose(got, want, **TOL)
    _grads_match(jm.apply, params, [jnp.asarray(emb)], port, [emb],
                 _rand(B, F * D, seed=3))
    # the same fields as a list (the path for unequal dims) give the
    # stacked path's numbers; a list of another length raises
    fields = [torch.from_numpy(emb[:, f]) for f in range(F)]
    np.testing.assert_allclose(port(fields).detach().numpy(), want, **TOL)
    with pytest.raises(ValueError, match="fields"):
        port([torch.from_numpy(emb[:, 0])])


@pytest.mark.parametrize("layers,experts,sub", [(2, 2, 16), (1, 3, 5)])
def test_dcn_mix_matches_flax(layers, experts, sub):
    x = _rand(B, F * D + ND, seed=4)
    jm = JaxDCNMix(dim_sub_space=sub, num_layer=layers, num_expert=experts)
    params = _jitter(jm.init(jax.random.PRNGKey(1), x), 5)
    port = _load(DCNMixLayer(x.shape[1], sub, layers, experts, GEN,
                             device="cpu"), params)
    want = np.asarray(jm.apply(params, x))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               want, **TOL)
    _grads_match(jm.apply, params, [jnp.asarray(x)], port, [x],
                 _rand(B, x.shape[1], seed=6))


def test_dcnv2_model_matches_flax():
    dense, emb = _rand(B, ND, seed=7), _rand(B, F, D, seed=8)
    jm = JaxDCN()
    params = _jitter(jm.init(jax.random.PRNGKey(2), dense, emb), 9)
    port = _load(DCNv2Model(FeatureConfig(), device="cpu"), params)
    want = np.asarray(jm.apply(params, dense, emb))
    got = port(torch.from_numpy(dense), torch.from_numpy(emb))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    _grads_match(jm.apply, params, [jnp.asarray(dense), jnp.asarray(emb)],
                 port, [dense, emb], _rand(B, seed=10))


def test_real_tree_loads_strict_and_port_init_matches_flax_fans():
    """A full-width Flax tree: every leaf lands by name (senet/dense_0 ->
    senet.senet.dense_0); the port's own init has each parameter's shape
    and Flax's glorot bound (the DCN-mix kernels' and gates' fans count
    their leading axes, the biases start at zero)."""
    fc = FeatureConfig()
    tree = jax.device_get(JaxDCN().init(
        jax.random.PRNGKey(0), np.zeros((2, ND), np.float32),
        np.zeros((2, F, D), np.float32)))
    sd = from_jax_params(tree)
    fresh = DCNv2Model(fc, device="cpu", seed=3)
    assert "senet.senet.dense_0.weight" in sd
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in fresh.state_dict().items()}
    DCNv2Model(fc, device="cpu").load_state_dict(sd, strict=True)
    for name, p in fresh.state_dict().items():
        flax_max = float(sd[name].abs().max())
        if flax_max == 0:
            assert not p.any(), name
        else:
            # both drew U(-l, l) with the same l: maxima within 15%
            assert 0.85 < float(p.abs().max()) / flax_max < 1.15, name


ROWS, DIM = 64, 16


def test_serving_matches_jax():
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    trainer = Trainer(JaxDCN(), jfc, TrainerConfig(), mesh=make_mesh(1))
    batch = next(SyntheticCriteo(rows_per_field=ROWS, num_users=50)
                 .batches(48, 1))
    jstate = trainer.init(jax.random.PRNGKey(0), batch)
    jstate = jstate._replace(params=_jitter(jstate.params, 11))
    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    model = DCNv2Model(fc, device="cpu")
    table = EmbeddingTable(fc.total_rows, DIM, device="cpu")
    state = ServingState(
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_from_packed(jax.device_get(jstate.table.table), 1, DIM))
    raw_j = np.asarray(jax_build_scorer(trainer)(jstate, batch.dense,
                                                 batch.sparse_ids))
    raw = build_scorer(model, fc, table, device="cpu")(
        state, batch.dense, batch.sparse_ids)
    assert raw.shape == raw_j.shape == (48,)
    np.testing.assert_allclose(raw.numpy(), raw_j, **TOL)
    for mode, tol in (("f16", 2e-3), ("u8", 3e-2)):
        want = np.asarray(JaxWireScorer(trainer, dense_mode=mode)(
            jstate, batch.dense, batch.sparse_ids))
        got = WireScorer(model, fc, table, dense_mode=mode, device="cpu")(
            state, batch.dense, batch.sparse_ids)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=mode)
        np.testing.assert_allclose(got.numpy(), raw.numpy(), atol=tol,
                                   err_msg=mode)
