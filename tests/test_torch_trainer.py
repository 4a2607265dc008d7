"""Port vs JAX: five training steps of benchmark configs 2, 3 and 4 at
small width.

Config 3: xDeepFM (CIN (8, 8), deep (16,)) over 26 fields x 64 rows x
D = 8, B = 256, pointwise + in-batch pairwise loss with occurrence power
-0.5 (``bench_all.py:124-127``).  Config 4: a narrow ``MultiTaskModel``
(MMoE (16, 8), PLE (8,), towers of 4 over 4 domains) with pointwise,
listwise at 0.5 and the CVR head's loss (``bench_all.py:128-131``), the
batch's domains routed to the STAR towers.  Both with Adam on the dense
params and dense-apply Adagrad on the rows.  Config 2: a narrow
``DCNv2Model`` (SENET, DCN-mix of 2 layers x 2 experts on a 4-wide
subspace, deep (32, 16), the ``__graft_entry__`` "2:dcnv2+adam" widths)
with pointwise + pairwise at 0.5 (power -0.5) and lazy sparse Adam at lr
1e-3 on the rows (dense-apply on both sides, as ``auto`` picks at this
size).  The JAX ``Trainer`` on ``make_mesh(1)`` initializes
both packages (``convert`` carries the params, the table and the
optimizer state across); then both train on the same numpy batches.  f32 on
the CPU on both sides, summed in other orders and through five Adam
steps (lr 1e-3, each moving a weight by up to ~1e-3; measured: losses
within 2e-7 relative, params within 8e-8, rows within 3e-9): losses rtol
2e-6, params atol 1e-6, rows atol 1e-7, accumulators rtol 1e-6.  Under
lazy Adam each touched row moves by up to lr = 1e-3 a step whatever its
gradient's size: rows atol 1e-7 still; m and v (of order |g| and g^2,
at most 3.0e-6 and 3.5e-13 here) within 1e-4 of their largest value
(measured 7e-6 and 1.3e-5 of it: tiny gradients summed in another order);
the count exact.
"""
import jax
import numpy as np
import pytest
import torch

from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.models import XDeepFMModel as JaxXDeepFM
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.training import SyntheticCriteo as JaxData
from rec_now_tpu.training import Trainer as JaxTrainer
from rec_now_tpu.training import TrainerConfig as JaxConfig
from rec_now_tpu_torch.convert import from_jax_params, table_state_from_jax
from rec_now_tpu.models import DCNv2Model as JaxDCN
from rec_now_tpu.models import MultiTaskModel as JaxMultiTask
from rec_now_tpu_torch.models import (DCNv2Model, FeatureConfig,
                                      MultiTaskModel, XDeepFMModel)
from rec_now_tpu_torch.training import (SyntheticCriteo, Trainer,
                                        TrainerConfig)

torch.set_num_threads(1)

ROWS, DIM, HIDDEN, DEEP, B, STEPS = 64, 8, (8, 8), (16,), 256, 5
LOSS = dict(pointwise_weight=1.0, pairwise_weight=1.0,
            click_occurance_power=-0.5)


MT = dict(mmoe_dims=(16, 8), ple_dims=(8,), tower_dim=4)
LOSS4 = dict(pointwise_weight=1.0, listwise_weight=0.5, num_tasks=2)
DCN = dict(deep_dims=(32, 16), dcn_sub_dim=4)
LOSS2 = dict(pointwise_weight=1.0, pairwise_weight=0.5,
             click_occurance_power=-0.5, sparse_optimizer="adam",
             sparse_lr=1e-3)


def _models(kind):
    """(JAX model, port model, loss config, metric keys) of a run."""
    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    if kind == "config2":
        return (JaxDCN(**DCN), DCNv2Model(fc, **DCN, device="cpu"), LOSS2,
                ("loss", "pointwise", "pairwise"))
    if kind == "config4":
        return (JaxMultiTask(num_task=2, **MT),
                MultiTaskModel(fc, **MT, device="cpu"), LOSS4,
                ("loss", "pointwise", "listwise", "cvr_loss"))
    sum_channel = kind == "sum_channel"
    return (JaxXDeepFM(cin_hidden_sizes=HIDDEN, cin_sum_channel=sum_channel,
                       deep_dims=DEEP),
            XDeepFMModel(fc, HIDDEN, sum_channel, DEEP, device="cpu"), LOSS,
            ("loss", "pointwise", "pairwise"))


@pytest.mark.parametrize("kind", ["sum_channel", "flat", "config4",
                                  "config2"])
def test_five_steps_match_jax_trainer(kind):
    jmodel, model, loss_cfg, keys = _models(kind)
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    jtrainer = JaxTrainer(jmodel, jfc, JaxConfig(**loss_cfg),
                          mesh=make_mesh(1))
    batches = list(JaxData(rows_per_field=ROWS, num_users=60).batches(
        B, STEPS, seed=4))
    jstate = jtrainer.init(jax.random.PRNGKey(0), batches[0])

    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    trainer = Trainer(model, fc, TrainerConfig(**loss_cfg), device="cpu")
    state = trainer.init(
        torch.Generator(),
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_state_from_jax(jax.device_get(jstate.table), 1, DIM))
    # the port's data is a copy of the JAX module's: same batches
    port_batches = list(SyntheticCriteo(rows_per_field=ROWS,
                                        num_users=60).batches(B, STEPS,
                                                              seed=4))
    for jb, pb in zip(batches, port_batches):
        np.testing.assert_array_equal(jb.sparse_ids, pb.sparse_ids)
        jstate, jm = jtrainer.train_step(jstate, *jtrainer.put(jb))
        state, m = trainer.train_step(state, *trainer.put(pb))
        assert set(keys) <= set(jm) and set(m) == set(keys) | {
            "sparse_dropped"}
        # one device: no exchange, so no dropped id
        assert int(m["sparse_dropped"]) == int(jm["sparse_dropped"]) == 0
        for key in keys:
            assert float(jm[key]) > 0, key
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=2e-6, err_msg=key)
    assert int(state.step) == STEPS
    # eval: the domains default to zeros (B,) on both sides
    jd, ji = jtrainer.put(batches[0])[:2]
    np.testing.assert_allclose(
        trainer.eval_step(state, *trainer.put(port_batches[0])[:2]).numpy(),
        np.asarray(jtrainer.eval_step(jstate, jd, ji)), rtol=1e-5,
        atol=1e-6)

    want = from_jax_params(jax.device_get(jstate.params))
    assert set(want) == set(state.params)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)
    every = np.arange(fc.total_rows)
    rows = jtrainer.table.debug_read(jax.device_get(jstate.table.table),
                                     every)
    acc = jtrainer.table.debug_read(
        jax.device_get(jstate.table.accumulator), every)
    np.testing.assert_allclose(state.table.table.numpy(), rows, atol=1e-7)
    np.testing.assert_allclose(state.table.accumulator.numpy(), acc,
                               rtol=1e-6)
    # the steps moved the rows and every param (a gradient reached them)
    if kind == "config2":
        for name in ("m", "v"):
            want = jtrainer.table.debug_read(
                jax.device_get(getattr(jstate.table, name)), every)
            np.testing.assert_allclose(getattr(state.table, name).numpy(),
                                       want, atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)
        assert int(state.table.count) == int(jstate.table.count) == STEPS
        assert (np.abs(want).sum(1) > 0).sum() > 100
    else:
        assert (acc > 0.1).sum() > 100
    before = from_jax_params(jax.device_get(
        jtrainer.init(jax.random.PRNGKey(0), batches[0]).params))
    for name, p in state.params.items():
        assert float((p.detach() - before[name]).abs().max()) > 1e-5, name
