"""Port vs JAX: the FM layer and ``FMModel`` (benchmark config 1).

``FMLayer`` on stacked and listed field embeddings, and ``FMModel`` at
B = 256, F = 26, D = 16, 13 dense (embeddings ~ N(0, 0.1^2): the
second-order term is a difference of two sums of squares, and at unit
scale its cancellation leaves the f32 rounding of terms ~400 in outputs
~20): outputs and every parameter's and the
inputs' gradients against Flax (``jax.grad``), on Flax-initialised
weights jittered so that the biases are not zero, carried over by
``convert.from_jax_params`` (``strict=True``); the port's own init has
Flax's shapes and glorot bounds; a few FM training steps on the CPU
against the JAX ``Trainer``.  f32 on the CPU on both sides, summed in
other orders: outputs rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-5 (sums over the batch of 256), five steps' losses rtol 2e-6, params
atol 1e-6, rows atol 1e-7 (the tolerances of ``test_torch_trainer.py``;
1e-6 under lazy Adam, whose step is ~lr * g / (|g| + eps) for a summed
gradient that nearly cancels).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers.fm_layer import FMLayer as JaxFMLayer
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.models.fm_model import FMModel as JaxFM
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.training import SyntheticCriteo as JaxData
from rec_now_tpu.training import Trainer as JaxTrainer
from rec_now_tpu.training import TrainerConfig as JaxConfig
from rec_now_tpu_torch.convert import from_jax_params, table_state_from_jax
from rec_now_tpu_torch.layers.fm_layer import FMLayer
from rec_now_tpu_torch.models import FeatureConfig, FMModel
from rec_now_tpu_torch.training import (SyntheticCriteo, Trainer,
                                        TrainerConfig)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-5)
B, F, D, ND = 256, 26, 16, 13


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_fm_layer_matches_flax():
    emb = _rand(B, F, D, seed=1) * 0.1
    want = np.asarray(JaxFMLayer().apply({}, jnp.asarray(emb)))
    got = FMLayer()(torch.from_numpy(emb))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    listed = FMLayer()([torch.from_numpy(emb[:, f]) for f in range(F)])
    np.testing.assert_allclose(listed.numpy(), want, **TOL)


def test_fm_model_logits_and_grads_match_flax():
    dense, emb = _rand(B, ND, seed=2), _rand(B, F, D, seed=3) * 0.1
    jm = JaxFM()
    params = jm.init(jax.random.PRNGKey(0), dense, emb)
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape) * 0.05, jnp.float32),
        params)
    port = FMModel(FeatureConfig(), device="cpu")
    port.load_state_dict(from_jax_params(jax.device_get(params)),
                         strict=True)
    want = np.asarray(jm.apply(params, dense, emb))
    got = port(torch.from_numpy(dense), torch.from_numpy(emb))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)

    w = _rand(B, seed=5)
    gp, gd, ge = jax.grad(
        lambda p, d, e: jnp.sum(jm.apply(p, d, e) * w), argnums=(0, 1, 2))(
        params, jnp.asarray(dense), jnp.asarray(emb))
    want_g = from_jax_params(jax.device_get(gp))
    own = dict(port.named_parameters())
    assert set(want_g) == set(own)
    xs = [torch.from_numpy(dense).requires_grad_(),
          torch.from_numpy(emb).requires_grad_()]
    grads = torch.autograd.grad((port(*xs) * torch.from_numpy(w)).sum(),
                                list(own.values()) + xs)
    for name, g in zip(own, grads):
        assert float(want_g[name].abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   err_msg=name, **GTOL)
    np.testing.assert_allclose(grads[-2].numpy(), np.asarray(gd), **GTOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(ge), **GTOL)


def test_fm_model_own_init_has_flax_shapes_and_bounds():
    jparams = from_jax_params(jax.device_get(JaxFM().init(
        jax.random.PRNGKey(0), _rand(2, ND), _rand(2, F, D))))
    port = {k: v.detach() for k, v in FMModel(
        FeatureConfig(), device="cpu", seed=3).named_parameters()}
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    for name, fan_in in (("linear_sparse.weight", F * D),
                         ("linear_dense.weight", ND)):
        limit = math.sqrt(6.0 / (fan_in + 1))
        assert float(port[name].abs().max()) <= limit
        assert float(port[name].abs().max()) > 0.5 * limit
    assert float(port["bias"].abs().max()) == 0.0


@pytest.mark.parametrize("sparse_optimizer", ["adagrad", "adam"])
def test_fm_training_steps_match_jax_trainer(sparse_optimizer):
    rows, dim, b, steps = 64, 4, 128, 5
    cfg = dict(sparse_optimizer=sparse_optimizer,
               sparse_lr=0.05 if sparse_optimizer == "adagrad" else 1e-3)
    jtrainer = JaxTrainer(JaxFM(), JaxFC(rows_per_field=rows,
                                         embedding_dim=dim),
                          JaxConfig(**cfg), mesh=make_mesh(1))
    batches = list(JaxData(rows_per_field=rows, num_users=30).batches(
        b, steps, seed=2))
    jstate = jtrainer.init(jax.random.PRNGKey(1), batches[0])
    fc = FeatureConfig(rows_per_field=rows, embedding_dim=dim)
    trainer = Trainer(FMModel(fc, device="cpu"), fc, TrainerConfig(**cfg),
                      device="cpu")
    state = trainer.init(
        torch.Generator(),
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_state_from_jax(jax.device_get(jstate.table), 1, dim))
    port_batches = SyntheticCriteo(rows_per_field=rows,
                                   num_users=30).batches(b, steps, seed=2)
    for jb, pb in zip(batches, port_batches):
        jstate, jm = jtrainer.train_step(jstate, *jtrainer.put(jb))
        state, m = trainer.train_step(state, *trainer.put(pb))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-6)
    want = from_jax_params(jax.device_get(jstate.params))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)
    rows_want = jtrainer.table.debug_read(
        jax.device_get(jstate.table.table), np.arange(fc.total_rows))
    # lazy Adam moves a touched element by ~lr * g / (|g| + eps): an
    # element whose summed gradient nearly cancels moves by a different
    # share of lr = 1e-3 when summed in another order
    np.testing.assert_allclose(state.table.table.numpy(), rows_want,
                               atol=1e-7 if sparse_optimizer == "adagrad"
                               else 1e-6)
