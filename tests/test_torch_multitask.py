"""Port vs JAX: the multitask model of benchmark config 4 and its layers.

``MMOELayer``, ``PLELayer`` (config 4's single layer and a 2-layer PLE
with 2 shared tasks, which runs the concatenations of later layers),
``ParasiticStarDenseLayer`` on all three routings, ``MultiTaskModel``
(logits and every parameter's gradient), serving through the raw and
wire scorers and export/load, and the conversion of a real config-4
Flax tree.  Flax inits the weights, which are then jittered (so the
parasitic kernels, ones at init, differ by domain) and carried over by
``convert.from_jax_params``.  f32 on the CPU on both sides, summed in
other orders: outputs rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-6 (sums over the batch); wire scorers as in the xDeepFM serving
test (port vs JAX wire atol 1e-5) and within the JAX serving test's
wire-vs-raw tolerances (f16 2e-3, u8 3e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers.mmoe_layer import MMOELayer as JaxMMOE
from rec_now_tpu.layers.ple_layer import PLELayer as JaxPLE
from rec_now_tpu.layers.star_dense_layer import \
    ParasiticStarDenseLayer as JaxStar
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.models import MultiTaskModel as JaxMultiTask
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.serving import WireScorer as JaxWireScorer
from rec_now_tpu.serving import build_scorer as jax_build_scorer
from rec_now_tpu.training import SyntheticCriteo, Trainer, TrainerConfig
from rec_now_tpu_torch.convert import from_jax_params, table_from_packed
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.layers.mmoe_layer import MMOELayer
from rec_now_tpu_torch.layers.ple_layer import PLELayer, _extend_int_list
from rec_now_tpu_torch.layers.star_dense_layer import ParasiticStarDenseLayer
from rec_now_tpu_torch.models import FeatureConfig, MultiTaskModel
from rec_now_tpu_torch.serving import (ServingState, WireScorer,
                                       build_scorer, export_serving,
                                       load_serving)
from rec_now_tpu_torch.training import Trainer as PortTrainer
from rec_now_tpu_torch.training import TrainerConfig as PortConfig

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-6)
GEN = torch.Generator()
NARROW = dict(mmoe_dims=(16, 8), ple_dims=(8,), tower_dim=4)


def _jitter(params, seed, scale=0.2):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape) * scale, jnp.float32),
        params)


def _load(module, params):
    sd = from_jax_params(jax.device_get(params))
    assert set(sd) == set(dict(module.named_parameters()))
    module.load_state_dict(sd)
    return module


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dims", [(12, 6), (5,)])
def test_mmoe_matches_flax(dims):
    x = _rand(19, 11)
    jm = JaxMMOE(num_task=3, num_experts=4, dnn_dims=dims)
    params = _jitter(jm.init(jax.random.PRNGKey(0), x), 1)
    want = np.asarray(jm.apply(params, x))
    port = _load(MMOELayer(11, 3, 4, dims, GEN, device="cpu"), params)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (3, 19, dims[-1])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dims,experts,tasks,shared", [
    ([[8]], 2, 2, 1),                       # config 4's shape, narrow
    ([[8, 6], [5]], [[2, 3, 2, 1], 2], 2, 2),   # two layers, two shared
    ([7, [4]], 1, 3, 1),                    # int dims, three tasks
])
def test_ple_matches_flax(dims, experts, tasks, shared):
    x = _rand(23, 10, seed=2)
    jp = JaxPLE(num_task=tasks, list_of_dnn_dims=dims,
                list_of_num_experts_per_task=experts, num_shared_task=shared)
    params = _jitter(jp.init(jax.random.PRNGKey(1), x), 3)
    want = jp.apply(params, x)
    port = _load(PLELayer(10, tasks, dims, experts, GEN,
                          num_shared_task=shared, device="cpu"), params)
    got = port(torch.from_numpy(x))
    assert len(got) == len(want) == tasks
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_extend_int_list():
    assert _extend_int_list(3, 2) == [3, 3]
    assert _extend_int_list([1, 2], 4) == [1, 2, 2, 2]
    assert _extend_int_list((5,), 1) == [5]
    with pytest.raises(ValueError):
        _extend_int_list([], 2)
    with pytest.raises(TypeError):
        _extend_int_list("2", 2)


@pytest.mark.parametrize("routing", ["per_sample", "int", "none", "negative"])
def test_parasitic_star_matches_flax(routing):
    x = _rand(17, 9, seed=4)
    dom = np.random.RandomState(5).randint(0, 4, 17).astype(np.int32)
    group = {"per_sample": dom, "int": 2, "none": None,
             "negative": -1}[routing]
    js = JaxStar(units=5, num_groups=4, activation="relu")
    params = _jitter(js.init(jax.random.PRNGKey(2), x, 0), 6)
    want = np.asarray(js.apply(params, x, group))
    port = _load(ParasiticStarDenseLayer(9, 5, 4, GEN, device="cpu"),
                 params)
    tg = torch.from_numpy(group) if routing == "per_sample" else group
    got = port(torch.from_numpy(x), tg).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the routings differ once the parasitic parameters do
    trunk = np.asarray(js.apply(params, x, None))
    assert (routing in ("none", "negative")) == np.allclose(want, trunk)


def _multitask(fc_kw, seed=0):
    jm = JaxMultiTask(num_task=2, **NARROW)
    fc = FeatureConfig(**fc_kw)
    dense = _rand(29, fc.num_dense, seed=seed)
    emb = _rand(29, fc.num_sparse, fc.embedding_dim, seed=seed + 1)
    params = _jitter(jm.init(jax.random.PRNGKey(seed), dense, emb), seed + 2,
                     scale=0.1)
    port = _load(MultiTaskModel(fc, **NARROW, device="cpu"), params)
    return jm, params, port, dense, emb


def test_multitask_logits_and_grads_match_flax():
    jm, params, port, dense, emb = _multitask(dict(rows_per_field=8,
                                                   embedding_dim=4))
    dom = np.random.RandomState(9).randint(0, 4, 29).astype(np.int32)
    w = _rand(2, 29, seed=10)
    for domain in (0, 3, dom):
        jd = jnp.asarray(domain) if isinstance(domain, np.ndarray) else domain
        td = (torch.from_numpy(domain) if isinstance(domain, np.ndarray)
              else domain)
        want = np.asarray(jm.apply(params, dense, emb, jd))
        got = port(torch.from_numpy(dense), torch.from_numpy(emb), td)
        assert got.shape == (2, 29)
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)

    def jloss(p, e):
        return jnp.sum(jm.apply(p, dense, e, jnp.asarray(dom)) * w)
    gp, ge = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(emb))
    want = from_jax_params(jax.device_get(gp))
    e = torch.from_numpy(emb).requires_grad_()
    own = dict(port.named_parameters())
    loss = (port(torch.from_numpy(dense), e, torch.from_numpy(dom))
            * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, list(own.values()) + [e])
    assert set(want) == set(own)
    for name, g in zip(own, grads):
        assert float(want[name].abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GTOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(ge), **GTOL)


ROWS, DIM = 64, 4


def _serving_setup():
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    trainer = Trainer(JaxMultiTask(num_task=2, **NARROW), jfc,
                      TrainerConfig(num_tasks=2), mesh=make_mesh(1))
    batch = next(SyntheticCriteo(rows_per_field=ROWS, num_users=50)
                 .batches(48, 1))
    jstate = trainer.init(jax.random.PRNGKey(0), batch)
    jstate = jstate._replace(params=_jitter(jstate.params, 11, scale=0.1))
    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    model = MultiTaskModel(fc, **NARROW, device="cpu")
    table = EmbeddingTable(fc.total_rows, DIM, device="cpu")
    state = ServingState(
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_from_packed(jax.device_get(jstate.table.table), 1, DIM))
    assert set(state.params) == set(dict(model.named_parameters()))
    return trainer, jstate, model, fc, table, state, batch


def test_serving_matches_jax(tmp_path):
    trainer, jstate, model, fc, table, state, batch = _serving_setup()
    raw_j = np.asarray(jax_build_scorer(trainer)(jstate, batch.dense,
                                                 batch.sparse_ids))
    scorer = build_scorer(model, fc, table, device="cpu")
    raw = scorer(state, batch.dense, batch.sparse_ids)
    assert raw.shape == raw_j.shape == (2, 48)
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
    export_serving(str(tmp_path / "s"), state)
    restored = load_serving(str(tmp_path / "s"), device="cpu")
    torch.testing.assert_close(
        scorer(restored, batch.dense, batch.sparse_ids), raw, rtol=0, atol=0)


def test_convert_carries_a_real_config4_tree():
    """The repair: a full-width config-4 tree converts to exactly the
    model's names and shapes; 3-D kernels and the 2-D trunk_kernel keep
    the JAX layout, only Dense kernels are transposed; the trainer loads
    it."""
    jm = JaxMultiTask(num_task=2)
    fc = FeatureConfig(rows_per_field=8)
    tree = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((2, fc.num_dense)),
                                  jnp.zeros((2, fc.num_sparse,
                                             fc.embedding_dim))))
    sd = from_jax_params(tree)
    model = MultiTaskModel(fc, device="cpu")
    own = dict(model.named_parameters())
    assert set(sd) == set(own)
    assert sum(v.numel() for v in sd.values()) == 328_058
    for name, p in own.items():
        assert tuple(sd[name].shape) == tuple(p.shape), name
    p = tree["params"]
    k0 = p["mmoe"]["experts/MultiDenseLayer_0"]["kernel"]
    assert k0.shape == (4, 429, 128)
    np.testing.assert_array_equal(
        sd["mmoe.experts.MultiDenseLayer_0.kernel"].numpy(), k0)
    np.testing.assert_array_equal(
        sd["ple.ple_layer_0.task_shared_0.MultiDenseLayer_0.kernel"].numpy(),
        p["ple"]["ple_layer_0/task_shared_0/MultiDenseLayer_0"]["kernel"])
    np.testing.assert_array_equal(sd["star_tower_1.trunk_kernel"].numpy(),
                                  p["star_tower_1"]["trunk_kernel"])
    np.testing.assert_array_equal(
        sd["ple.ple_gate_0.task_special_0.dense.weight"].numpy(),
        p["ple"]["ple_gate_0/task_special_0/dense"]["kernel"].T)
    np.testing.assert_array_equal(sd["head_0.weight"].numpy(),
                                  p["head_0"]["kernel"].T)
    trainer = PortTrainer(model, fc, PortConfig(num_tasks=2), device="cpu")
    state = trainer.init(GEN, params=sd)
    np.testing.assert_array_equal(
        state.params["mmoe.gates.MultiDenseLayer.kernel"].detach().numpy(),
        p["mmoe"]["gates/MultiDenseLayer"]["kernel"])
