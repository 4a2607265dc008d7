"""Port vs JAX: CAN with DCN-v2 (benchmark config 5) and its second table.

* ``pool`` / ``PoolingLayer`` against the JAX functions on every combiner
  (mean, sum, max, min, None, a callable), each axis and keepdims, and
  the error on an unknown combiner.
* ``CANLayer`` against Flax's on the option grid JAX's tests use: 2-D and
  3-D inputs, all-zero padding rows, ``output_combiner`` sum, mean and
  None, auto-decided dims, ``use_res_net``, two layers, the output
  layer's activation; outputs and the gradients of the inputs and
  the per-sample params (``jax.grad``); the size-mismatch errors.
* ``CANDCNModel`` forward and every gradient (params, dense, embeddings,
  CAN params) against Flax, weights carried over by ``from_jax_params``
  (strict), on a run of history fields and on scattered ones.
* Five ``Trainer`` steps of config 5 at small width (26 fields x 64 rows
  x D = 8, CAN dims (8,): a CAN table of 64 x 72; B = 256; pointwise +
  pairwise 0.5) against the JAX ``Trainer`` on ``make_mesh(1)``, for
  Adagrad and lazy Adam on both tables: losses, params, both tables'
  rows and accumulators (m, v and the count under Adam), eval; then the
  windowed loop and both evals against JAX's.
* Serving: raw and wire scorers against JAX's, f16 wire on f16-exact
  dense bit-equal to raw, ``export_serving`` / ``load_serving`` and a
  checkpoint round trip scoring bit-equal, and the CAN-mismatch error
  both ways (state or file vs scorer, checkpoint vs target).
* B9's and B10's plain versions at widths 72 (config 5's CAN table at
  D = 8) and 45 against the JAX Pallas kernels interpreted at pack 1.

f32 on the CPU on both sides, summed in other orders: layer and model
outputs rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5; the
trainer as ``tests/test_torch_trainer.py`` holds it (losses rtol 2e-6,
params atol 1e-6, rows atol 1e-7, accumulators rtol 1e-6, m and v 1e-4
of their largest value, the count exact); scorers rtol 1e-5 / atol
1e-6, the wire's port vs JAX atol 1e-5; the table passes as
``tests/test_torch_table_update.py`` and ``tests/test_torch_adam.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers.can_layer import CANLayer as JaxCAN
from rec_now_tpu.layers.pooling_layer import PoolingLayer as JaxPooling
from rec_now_tpu.layers.pooling_layer import pool as jax_pool
from rec_now_tpu.models import CANDCNModel as JaxCANDCN
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.ops.pallas import table_update_kernel as jtk
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.serving import WireScorer as JaxWireScorer
from rec_now_tpu.serving import _check_can_match as jax_check_can_match
from rec_now_tpu.serving import build_scorer as jax_build_scorer
from rec_now_tpu.training import SyntheticCriteo as JaxData
from rec_now_tpu.training import Trainer as JaxTrainer
from rec_now_tpu.training import TrainerConfig as JaxConfig
from rec_now_tpu_torch.convert import from_jax_params, table_state_from_jax
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.layers import CANLayer, PoolingLayer, pool
from rec_now_tpu_torch.models import CANDCNModel, FeatureConfig
from rec_now_tpu_torch.ops import table_update_kernel as tk
from rec_now_tpu_torch.serving import (ServingState, WireScorer,
                                       build_scorer, export_serving,
                                       load_serving)
from rec_now_tpu_torch.training import SyntheticCriteo, Trainer, \
    TrainerConfig
from rec_now_tpu_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jitter(params, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rng.randn(*p.shape) * scale, jnp.float32),
        params)


# -- pooling ----------------------------------------------------------------
@pytest.mark.parametrize("combiner", ["mean", "sum", "max", "min", None])
@pytest.mark.parametrize("axis,keepdims", [(1, False), (0, True),
                                           (None, False), (None, True)])
def test_pool_matches_jax(combiner, axis, keepdims):
    x = _rand(5, 7, 3, seed=1)
    want = np.asarray(jax_pool(jnp.asarray(x), combiner, axis, keepdims))
    got = pool(torch.from_numpy(x), combiner, axis, keepdims)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pool_callable_layer_and_error_match_jax():
    x = _rand(4, 6, seed=2)
    np.testing.assert_allclose(
        pool(torch.from_numpy(x), lambda t: t * 2).numpy(),
        np.asarray(jax_pool(jnp.asarray(x), lambda t: t * 2)), **TOL)
    rows = [[1, 2, 3], [10, 11, 12]]
    want = JaxPooling(axis=0, keepdims=True, combiner="sum").apply({}, rows)
    got = PoolingLayer(axis=0, keepdims=True, combiner="sum")(rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[11, 13, 15]])
    for fn, arr in ((pool, torch.from_numpy(x)), (jax_pool, jnp.asarray(x))):
        with pytest.raises(ValueError, match="combiner must be one of"):
            fn(arr, "median", 0)


# -- the CAN layer ----------------------------------------------------------
# (input shape, options, dnn_dims or None for auto): JAX's test grid
CAN_CASES = {
    "2d, two layers": ((64, 4), {}, [4, 4]),
    "3d, padding, sum": ((64, 3, 4), {"output_combiner": "sum"}, [4]),
    "3d, padding, none": ((64, 3, 4), {"output_combiner": None}, [4]),
    "3d, padding, mean": ((64, 3, 4), {"output_combiner": "mean"}, [4]),
    "auto dims": ((64, 4), {}, None),
    "res net": ((64, 3), {"use_res_net": True,
                          "mask_all_zero_embedding": False}, [3]),
    "res net, two layers, masked": ((32, 5, 3), {"use_res_net": True},
                                    [3, 3]),
    "reference parity dims": ((32, 6, 4), {"output_combiner": "sum"},
                              [5, 5]),
    "output activation": ((32, 4, 4), {"output_layer_use_activation": True},
                          [6, 2]),
}


@pytest.mark.parametrize("case", list(CAN_CASES))
def test_can_layer_matches_flax(case):
    shape, opts, dims = CAN_CASES[case]
    d = shape[-1]
    size = JaxCAN.get_dnn_param_size(d, dims if dims is not None else [d, d])
    assert CANLayer.get_dnn_param_size(
        d, dims if dims is not None else [d, d]) == size
    x = _rand(*shape, seed=3)
    if len(shape) == 3:
        x[0, -1] = 0.0          # padding rows: masked out
        x[5, 0] = 0.0
    p = _rand(shape[0], size, seed=4) * 0.5
    jl = JaxCAN(dnn_dims=dims, **opts)
    port = CANLayer(dnn_dims=dims, **opts)
    assert not list(port.parameters())
    want = np.asarray(jl.apply({}, jnp.asarray(x), jnp.asarray(p)))
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    got = port(xt, pt)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    if len(shape) == 3 and opts.get("output_combiner", "sum") is None:
        assert not got[0, -1].any()
    w = _rand(*want.shape, seed=5)
    gx, gp = jax.grad(lambda a, b: jnp.sum(jl.apply({}, a, b) * w),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(p))
    dx, dp = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                 [xt, pt])
    assert float(np.abs(np.asarray(gp)).max()) > 0
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), **GTOL)
    np.testing.assert_allclose(dp.numpy(), np.asarray(gp), **GTOL)


def test_can_layer_size_mismatch_raises_as_jax():
    assert CANLayer.get_dnn_param_size(4, [4, 4], use_bias=True) == 40
    assert CANLayer.get_dnn_param_size(3, [5], use_bias=False) == 15
    x, p = np.ones((2, 4), np.float32), np.ones((2, 7), np.float32)
    for dims in ([4], None):       # explicit dims; auto (7 / 20 layers)
        with pytest.raises(ValueError, match="dnn_param_size not match"):
            JaxCAN(dnn_dims=dims).apply({}, jnp.asarray(x), jnp.asarray(p))
        with pytest.raises(ValueError, match="dnn_param_size not match"):
            CANLayer(dnn_dims=dims)(torch.from_numpy(x), torch.from_numpy(p))


# -- the model --------------------------------------------------------------
ROWS, DIM, B = 64, 8, 256
CAN_DIMS = (8,)
FC = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
CAN_DIM = 8 * 8 + 8                                  # 72: pack 1 on the TPU
NARROW = dict(can_dnn_dims=CAN_DIMS, deep_dims=(32, 16), dcn_sub_dim=4)


@pytest.mark.parametrize("history", [tuple(range(8)), (0, 3, 5, 11)])
def test_can_dcn_model_matches_flax(history):
    dense, emb = _rand(B, 13, seed=7), _rand(B, 26, DIM, seed=8) * 0.5
    emb[3, history[0]] = 0.0                           # a padding row
    can = _rand(B, CAN_DIM, seed=9) * 0.3
    jm = JaxCANDCN(history_fields=history, **NARROW)
    params = _jitter(jm.init(jax.random.PRNGKey(2), dense, emb, can), 10)
    port = CANDCNModel(FC, history_fields=history, **NARROW, device="cpu")
    assert CANDCNModel.can_param_size(DIM, CAN_DIMS) == CAN_DIM == \
        JaxCANDCN.can_param_size(DIM, CAN_DIMS)
    assert CANDCNModel.can_param_size(16, (16,)) == 272
    port.load_state_dict(from_jax_params(jax.device_get(params)),
                         strict=True)
    want = np.asarray(jm.apply(params, dense, emb, can))
    ins = [torch.from_numpy(a).requires_grad_() for a in (dense, emb, can)]
    got = port(*ins)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    w = _rand(B, seed=11)
    gp, *gx = jax.grad(lambda p, *xs: jnp.sum(jm.apply(p, *xs) * w),
                       argnums=(0, 1, 2, 3))(params, dense, emb, can)
    wanted = from_jax_params(jax.device_get(gp))
    own = dict(port.named_parameters())
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                list(own.values()) + ins)
    assert set(wanted) == set(own)
    for name, g in zip(own, grads):
        assert float(wanted[name].abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), wanted[name].numpy(),
                                   err_msg=name, **GTOL)
    for g, ref in zip(grads[len(own):], gx):
        assert float(np.abs(np.asarray(ref)).max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **GTOL)


# -- the trainer ------------------------------------------------------------
LOSS5 = dict(pointwise_weight=1.0, pairwise_weight=0.5, can_param_field=8,
             can_dnn_dims=CAN_DIMS)
OPTIMIZERS = {"adagrad": {}, "adam": dict(sparse_optimizer="adam",
                                          sparse_lr=1e-3)}


def _pair(optimizer="adagrad", b=B):
    """A config-5 JAX trainer and state, the port's carried over from it,
    and the first batch."""
    loss = dict(LOSS5, **OPTIMIZERS[optimizer])
    jtrainer = JaxTrainer(JaxCANDCN(**NARROW),
                          JaxFC(rows_per_field=ROWS, embedding_dim=DIM),
                          JaxConfig(**loss), mesh=make_mesh(1))
    first = next(JaxData(rows_per_field=ROWS, num_users=60).batches(b, 1))
    jstate = jtrainer.init(jax.random.PRNGKey(0), first)
    assert jtrainer.can_table.dim == CAN_DIM
    trainer = Trainer(CANDCNModel(FC, **NARROW, device="cpu"), FC,
                      TrainerConfig(**loss), device="cpu")
    assert (trainer.can_table.vocab_size, trainer.can_table.dim) == (
        ROWS, CAN_DIM)
    assert trainer.can_table.update_mode == "dense"
    state = trainer.init(
        torch.Generator(),
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_state_from_jax(jax.device_get(jstate.table), 1, DIM),
        can_table=table_state_from_jax(jax.device_get(jstate.can_table), 1,
                                       CAN_DIM))
    return jtrainer, jstate, trainer, state


def _assert_tables_match(jtrainer, jstate, state, optimizer, steps, before):
    """Both tables' state against JAX's; ``before``: their rows at init."""
    for name, jt, jst, st, rows, old in (
            ("table", jtrainer.table, jstate.table, state.table,
             FC.total_rows, before[0]),
            ("can_table", jtrainer.can_table, jstate.can_table,
             state.can_table, ROWS, before[1])):
        every = np.arange(rows)

        def read(a):
            return jt.debug_read(jax.device_get(a), every)

        want = read(jst.table)
        np.testing.assert_allclose(st.table.numpy(), want, atol=1e-7,
                                   err_msg=name)
        if optimizer == "adam":
            for part in ("m", "v"):
                ref = read(getattr(jst, part))
                np.testing.assert_allclose(
                    getattr(st, part).numpy(), ref,
                    atol=1e-4 * np.abs(ref).max(), err_msg=f"{name} {part}")
            assert int(st.count) == int(jst.count) == steps
        else:
            np.testing.assert_allclose(st.accumulator.numpy(),
                                       read(jst.accumulator), rtol=1e-6,
                                       err_msg=name)
        # the steps moved many rows of each table
        moved = int((st.table != old).any(1).sum())
        assert moved > (100 if name == "table" else 20), (name, moved)


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_five_steps_match_jax_trainer(optimizer):
    jtrainer, jstate, trainer, state = _pair(optimizer)
    before = (state.table.table.clone(), state.can_table.table.clone())
    batches = list(JaxData(rows_per_field=ROWS, num_users=60).batches(
        B, 5, seed=4))
    port_batches = list(SyntheticCriteo(rows_per_field=ROWS,
                                        num_users=60).batches(B, 5, seed=4))
    keys = ("loss", "pointwise", "pairwise")
    for jb, pb in zip(batches, port_batches):
        np.testing.assert_array_equal(jb.sparse_ids, pb.sparse_ids)
        jstate, jm = jtrainer.train_step(jstate, *jtrainer.put(jb))
        state, m = trainer.train_step(state, *trainer.put(pb))
        assert set(m) == set(keys) | {"sparse_dropped"}
        assert int(m["sparse_dropped"]) == int(jm["sparse_dropped"]) == 0
        for key in keys:
            assert float(jm[key]) > 0, key
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=2e-6, err_msg=key)
    assert int(state.step) == 5
    jd, ji = jtrainer.put(batches[0])[:2]
    np.testing.assert_allclose(
        trainer.eval_step(state, *trainer.put(port_batches[0])[:2]).numpy(),
        np.asarray(jtrainer.eval_step(jstate, jd, ji)), rtol=1e-5,
        atol=1e-6)
    want = from_jax_params(jax.device_get(jstate.params))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)
    _assert_tables_match(jtrainer, jstate, state, optimizer, 5, before)
    # the CAN table moved only at the looked-up rows
    looked = np.unique(np.concatenate([b.sparse_ids[:, 8] % ROWS
                                       for b in batches]))
    moved = (state.can_table.table != before[1]).any(1).numpy()
    assert moved[looked].all() and moved.sum() == len(looked)


def test_windowed_loop_and_evals_match_jax():
    jtrainer, jstate, trainer, state = _pair(b=128)
    before = (state.table.table.clone(), state.can_table.table.clone())
    batches = list(SyntheticCriteo(rows_per_field=ROWS, num_users=40)
                   .batches(128, 3, seed=4))
    jstate, jm = jtrainer.train_many_packed(
        jstate, jtrainer.put_packed_window(batches))
    state, m = trainer.train_many_packed(state,
                                         trainer.put_packed_window(batches))
    for key in m:
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=2e-6, err_msg=key)
    _assert_tables_match(jtrainer, jstate, state, "adagrad", 3, before)
    evals = list(SyntheticCriteo(rows_per_field=ROWS, num_users=40)
                 .batches(128, 3, seed=9))
    want = jtrainer.evaluate(jstate, evals)
    got = trainer.evaluate(state, evals)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    kw = dict(window=2, num_buckets=1024, num_group_slots=64,
              group_buckets=128)
    want = jtrainer.evaluate_device(jstate, evals, **kw)
    got = trainer.evaluate_device(state, evals, **kw)
    assert got == want


# -- serving and checkpoints ------------------------------------------------
def test_serving_and_checkpoints_match_jax(tmp_path):
    jtrainer, jstate, trainer, state = _pair()
    jstate = jstate._replace(params=_jitter(jstate.params, 11))
    batch = next(SyntheticCriteo(rows_per_field=ROWS, num_users=50)
                 .batches(48, 1, seed=2))
    model = trainer.model
    table = EmbeddingTable(FC.total_rows, DIM, device="cpu")
    can_table = EmbeddingTable(ROWS, CAN_DIM, device="cpu")
    can = dict(can_table=can_table, can_param_field=8)
    sstate = ServingState(
        params=from_jax_params(jax.device_get(jstate.params)),
        table=state.table.table, can_table=state.can_table.table)
    scorer = build_scorer(model, FC, table, device="cpu", **can)
    raw_j = np.asarray(jax_build_scorer(jtrainer)(jstate, batch.dense,
                                                  batch.sparse_ids))
    raw = scorer(sstate, batch.dense, batch.sparse_ids)
    assert raw.shape == raw_j.shape == (48,)
    np.testing.assert_allclose(raw.numpy(), raw_j, **TOL)
    # the CAN rows reach the logits
    other = sstate._replace(can_table=sstate.can_table * 2)
    assert not torch.equal(scorer(other, batch.dense, batch.sparse_ids), raw)
    for mode, tol in (("f16", 2e-3), ("u8", 3e-2)):
        want = np.asarray(JaxWireScorer(jtrainer, dense_mode=mode)(
            jstate, batch.dense, batch.sparse_ids))
        got = WireScorer(model, FC, table, dense_mode=mode, device="cpu",
                         **can)(sstate, batch.dense, batch.sparse_ids)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   err_msg=mode)
        np.testing.assert_allclose(got.numpy(), raw.numpy(), atol=tol,
                                   err_msg=mode)
    # ids travel exactly: f16 wire on f16-exact dense equals raw
    exact = batch.dense.astype(np.float16).astype(np.float32)
    torch.testing.assert_close(
        WireScorer(model, FC, table, device="cpu", **can)(
            sstate, exact, batch.sparse_ids),
        scorer(sstate, exact, batch.sparse_ids), rtol=0, atol=0)

    export_serving(str(tmp_path / "s"), sstate, scorer)
    restored = load_serving(str(tmp_path / "s"), device="cpu", scorer=scorer)
    assert restored.can_table.shape == (ROWS, CAN_DIM)
    torch.testing.assert_close(
        scorer(restored, batch.dense, batch.sparse_ids), raw, rtol=0, atol=0)

    # a training checkpoint: every tensor of both tables restored
    state = state._replace(params=dict(state.params))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(1, state)
    fresh = trainer.init(torch.Generator().manual_seed(5))
    assert not torch.equal(fresh.can_table.table, state.can_table.table)
    back = ckpt.restore(target=fresh)
    for a, b in ((back.table, state.table), (back.can_table,
                                             state.can_table)):
        for name, t in a._asdict().items():
            if t is not None:
                assert torch.equal(t, getattr(b, name)), name
    restored = ServingState(sstate.params, back.table.table,
                            back.can_table.table)
    torch.testing.assert_close(
        scorer(restored, batch.dense, batch.sparse_ids), raw, rtol=0, atol=0)


def test_can_mismatch_raises_both_ways(tmp_path):
    jtrainer, jstate, trainer, state = _pair()
    batch = next(SyntheticCriteo(rows_per_field=ROWS, num_users=50)
                 .batches(16, 1, seed=2))
    model, table = trainer.model, EmbeddingTable(FC.total_rows, DIM,
                                                 device="cpu")
    can = dict(can_table=EmbeddingTable(ROWS, CAN_DIM, device="cpu"),
               can_param_field=8)
    with_can = ServingState(dict(state.params), state.table.table,
                            state.can_table.table)
    without = with_can._replace(can_table=None)
    plain = build_scorer(model, FC, table, device="cpu")
    can_scorer = build_scorer(model, FC, table, device="cpu", **can)
    # JAX's message, with the scorer in place of the trainer
    with pytest.raises(ValueError) as jerr:
        jax_check_can_match(JaxTrainer(
            JaxCANDCN(**NARROW), JaxFC(rows_per_field=ROWS,
                                       embedding_dim=DIM),
            JaxConfig(), mesh=make_mesh(1)), True, "checkpoint payload")
    export_serving(str(tmp_path / "can"), with_can)
    with pytest.raises(ValueError) as err:
        load_serving(str(tmp_path / "can"), device="cpu", scorer=plain)
    assert str(err.value) == str(jerr.value).replace("trainer", "scorer") \
        .replace("TrainerConfig.can_param_field", "can_param_field")
    export_serving(str(tmp_path / "plain"), without)
    with pytest.raises(ValueError, match="CAN-table mismatch: checkpoint "
                       "payload lacks a co-action table"):
        load_serving(str(tmp_path / "plain"), device="cpu",
                     scorer=can_scorer)
    for scorer, st in ((plain, with_can), (can_scorer, without)):
        with pytest.raises(ValueError, match="CAN-table mismatch"):
            export_serving(str(tmp_path / "x"), st, scorer)
        with pytest.raises(ValueError, match="CAN-table mismatch"):
            scorer(st, batch.dense, batch.sparse_ids)
        with pytest.raises(ValueError, match="CAN-table mismatch"):
            WireScorer(model, FC, table, device="cpu",
                       **({} if scorer is plain else can))(
                st, batch.dense, batch.sparse_ids)
    with pytest.raises(ValueError, match="both can_table"):
        build_scorer(model, FC, table, device="cpu", can_param_field=8)
    # a CAN checkpoint into a state without one, and the reverse
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(1, state)
    with pytest.raises(ValueError, match="has a CAN table"):
        ckpt.restore(target=state._replace(can_table=None))
    ckpt.save(2, state._replace(can_table=None))
    with pytest.raises(ValueError, match="lacks a CAN table"):
        ckpt.restore(2, target=state)


# -- B9 and B10 at widths that pack one row a line ---------------------------
@pytest.mark.parametrize("v,dim", [(40, 72), (33, 45)])
def test_adagrad_plain_matches_jax_pallas_interpret_pack1(v, dim):
    rng = np.random.RandomState(v + dim)
    table = rng.randn(v, dim).astype(np.float32)
    acc = (np.abs(rng.randn(v)) * 0.1).astype(np.float32)
    g = (rng.randn(v, dim) * (np.arange(v)[:, None] % 3 == 0)
         ).astype(np.float32)
    jt, ja = jtk.adagrad_dense_pass(
        jnp.asarray(table), jnp.asarray(acc[:, None]), jnp.asarray(g),
        lr=0.05, pack=1, dim=dim)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    tk.adagrad_dense_pass(t, a, torch.from_numpy(g), 0.05)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-7)
    untouched = np.arange(v) % 3 != 0
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])
    assert not np.array_equal(t.numpy()[~untouched], table[~untouched])


@pytest.mark.parametrize("v,dim", [(40, 72), (33, 45)])
@pytest.mark.parametrize("t", [1, 1000])
def test_adam_plain_matches_jax_pallas_interpret_pack1(v, dim, t):
    rng = np.random.RandomState(v + dim + t)
    table = rng.randn(v, dim).astype(np.float32)
    m = (rng.randn(v, dim) * 1e-2).astype(np.float32)
    vv = (rng.randn(v, dim) ** 2 * 1e-4).astype(np.float32)
    touched = np.arange(v) % 3 != 0
    g = (rng.randn(v, dim) * touched[:, None]).astype(np.float32)
    g[::5] = 0.0
    hp = dict(b1=0.9, b2=0.999, eps=1e-7)
    jt, jm, jv = jtk.adam_dense_pass(
        *[jnp.asarray(a) for a in (table, m, vv, g)],
        jnp.asarray(touched.astype(np.float32)[:, None]),
        jnp.asarray(t, jnp.int32), lr=0.01, pack=1, dim=dim, **hp)
    got = [torch.from_numpy(a.copy()) for a in (table, m, vv)]
    tk.adam_dense_pass(*got, torch.from_numpy(g), torch.from_numpy(touched),
                       torch.tensor(t, dtype=torch.int32), 0.01, **hp)
    for name, a, b, before in zip("tmv", got, (jt, jm, jv), (table, m, vv)):
        want = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
        np.testing.assert_array_equal(a.numpy()[~touched], before[~touched])
        assert not np.array_equal(a.numpy()[touched], before[touched])
