"""Port vs JAX: five training steps of benchmark config 3 at small width.

xDeepFM (CIN (8, 8), deep (16,)) over 26 fields x 64 rows x D = 8, B =
256, pointwise + in-batch pairwise loss with occurrence power -0.5
(``bench_all.py:124-127``), Adam on the dense params and dense-apply
Adagrad on the rows.  The JAX ``Trainer`` on ``make_mesh(1)`` initializes
both packages (``convert`` carries the params, the table and the
accumulator across); then both train on the same numpy batches.  f32 on
the CPU on both sides, summed in other orders and through five Adam
steps (lr 1e-3, each moving a weight by up to ~1e-3; measured: losses
within 2e-7 relative, params within 8e-8, rows within 3e-9): losses rtol
2e-6, params atol 1e-6, rows atol 1e-7, accumulators rtol 1e-6.
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
from rec_now_tpu_torch.convert import (acc_from_packed, from_jax_params,
                                       table_from_packed)
from rec_now_tpu_torch.embedding.sharded import ShardedTableState
from rec_now_tpu_torch.models import FeatureConfig, XDeepFMModel
from rec_now_tpu_torch.training import (SyntheticCriteo, Trainer,
                                        TrainerConfig)

torch.set_num_threads(1)

ROWS, DIM, HIDDEN, DEEP, B, STEPS = 64, 8, (8, 8), (16,), 256, 5
LOSS = dict(pointwise_weight=1.0, pairwise_weight=1.0,
            click_occurance_power=-0.5)


@pytest.mark.parametrize("sum_channel", [True, False])
def test_five_steps_match_jax_trainer(sum_channel):
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    jtrainer = JaxTrainer(JaxXDeepFM(cin_hidden_sizes=HIDDEN,
                                     cin_sum_channel=sum_channel,
                                     deep_dims=DEEP),
                          jfc, JaxConfig(**LOSS), mesh=make_mesh(1))
    batches = list(JaxData(rows_per_field=ROWS, num_users=60).batches(
        B, STEPS, seed=4))
    jstate = jtrainer.init(jax.random.PRNGKey(0), batches[0])

    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    trainer = Trainer(XDeepFMModel(fc, HIDDEN, sum_channel, DEEP,
                                   device="cpu"),
                      fc, TrainerConfig(**LOSS), device="cpu")
    state = trainer.init(
        torch.Generator(),
        params=from_jax_params(jax.device_get(jstate.params)),
        table=ShardedTableState(
            table_from_packed(jax.device_get(jstate.table.table), 1, DIM),
            acc_from_packed(jax.device_get(jstate.table.accumulator), 1)))
    # the port's data is a copy of the JAX module's: same batches
    port_batches = list(SyntheticCriteo(rows_per_field=ROWS,
                                        num_users=60).batches(B, STEPS,
                                                              seed=4))
    for jb, pb in zip(batches, port_batches):
        np.testing.assert_array_equal(jb.sparse_ids, pb.sparse_ids)
        jstate, jm = jtrainer.train_step(jstate, *jtrainer.put(jb))
        state, m = trainer.train_step(state, *trainer.put(pb))
        for key in ("loss", "pointwise", "pairwise"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=2e-6, err_msg=key)
    assert int(state.step) == STEPS

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
    # the steps moved the rows and the CIN weights (a gradient reached them)
    assert (acc > 0.1).sum() > 100
    before = from_jax_params(jax.device_get(
        jtrainer.init(jax.random.PRNGKey(0), batches[0]).params))
    assert float((state.params["cin.weight_of_layer1"].detach()
                  - before["cin.weight_of_layer1"]).abs().max()) > 1e-4
