"""Port vs JAX: xDeepFM serving as a whole.

A JAX ``Trainer`` initializes the model and the sharded table;
``convert`` carries both into the port; raw and wire-fed scorers of both
packages score the same numpy requests.  f32 on the CPU on both sides.
"""
import jax
import numpy as np
import pytest
import torch

from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.models import XDeepFMModel as JaxXDeepFM
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.serving import WireScorer as JaxWireScorer
from rec_now_tpu.serving import build_scorer as jax_build_scorer
from rec_now_tpu.training import SyntheticCriteo, Trainer, TrainerConfig
from rec_now_tpu_torch.convert import from_jax_params, table_from_packed
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.models import FeatureConfig, XDeepFMModel
from rec_now_tpu_torch.serving import (ServingState, WireScorer,
                                       build_scorer, export_serving,
                                       load_serving)

torch.set_num_threads(1)

ROWS, DIM, HIDDEN, DEEP = 512, 4, (8, 8), (32,)


def _setup(sum_channel, num_shards=1, dim=DIM):
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=dim)
    trainer = Trainer(JaxXDeepFM(cin_hidden_sizes=HIDDEN,
                                 cin_sum_channel=sum_channel,
                                 deep_dims=DEEP),
                      jfc, TrainerConfig(), mesh=make_mesh(num_shards))
    data = SyntheticCriteo(rows_per_field=ROWS, num_users=50)
    batch = next(data.batches(64, 1))
    jstate = trainer.init(jax.random.PRNGKey(0), batch)
    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=dim)
    model = XDeepFMModel(fc, HIDDEN, sum_channel, DEEP, device="cpu")
    table = EmbeddingTable(fc.total_rows, dim, device="cpu")
    state = ServingState(
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_from_packed(jax.device_get(jstate.table.table),
                                num_shards, dim))
    return trainer, jstate, model, fc, table, state, batch


@pytest.mark.parametrize("sum_channel", [True, False])
@pytest.mark.parametrize("dim", [4, 8])
def test_raw_scorer_matches_jax(sum_channel, dim):
    trainer, jstate, model, fc, table, state, batch = _setup(sum_channel,
                                                             dim=dim)
    assert set(state.params) == set(dict(model.named_parameters()))
    want = np.asarray(jax_build_scorer(trainer)(
        jstate, batch.dense, batch.sparse_ids))
    got = build_scorer(model, fc, table, device="cpu")(
        state, batch.dense, batch.sparse_ids)
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["f16", "u8"])
def test_wire_scorer_matches_jax(mode):
    trainer, jstate, model, fc, table, state, batch = _setup(True)
    want = np.asarray(JaxWireScorer(trainer, dense_mode=mode)(
        jstate, batch.dense, batch.sparse_ids))
    got = WireScorer(model, fc, table, dense_mode=mode, device="cpu")(
        state, batch.dense, batch.sparse_ids)
    # the same quantization on both sides; only f32 rounding differs
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_export_load_serving_roundtrip(tmp_path):
    _, _, model, fc, table, state, batch = _setup(True)
    scorer = build_scorer(model, fc, table, device="cpu")
    want = scorer(state, batch.dense, batch.sparse_ids)
    export_serving(str(tmp_path / "s"), state)
    restored = load_serving(str(tmp_path / "s"), device="cpu")
    assert restored.table.shape == (fc.total_rows, fc.embedding_dim)
    got = scorer(restored, batch.dense, batch.sparse_ids)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_eight_shard_table_and_scores():
    """A table mod-sharded over 8 devices converts to the same logical
    rows that ShardedEmbeddingTable.debug_read gives, and scores match."""
    trainer, jstate, model, fc, table, state, batch = _setup(True, 8)
    packed = jax.device_get(jstate.table.table)
    ids = np.arange(fc.total_rows)
    want_rows = trainer.table.debug_read(packed, ids)
    np.testing.assert_array_equal(state.table.numpy(), want_rows)
    want = np.asarray(jax_build_scorer(trainer)(
        jstate, batch.dense, batch.sparse_ids))
    got = build_scorer(model, fc, table, device="cpu")(
        state, batch.dense, batch.sparse_ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
