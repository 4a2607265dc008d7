"""Port vs JAX: the windowed training loop, eval, checkpoints, the
prefetchers and the training CLI, on the CPU at small width.

* ``train_many_packed`` over two packed windows of 3 steps (config 2 at
  the ``test_torch_trainer.py`` widths, Adagrad, u8 dense wire) against
  the JAX ``Trainer`` on ``make_mesh(1)`` (its ``lax.scan`` over the same
  packed bytes): losses rtol 2e-6, params atol 1e-6, rows atol 1e-7,
  accumulators rtol 1e-6, the tolerances of ``test_torch_trainer.py``.
* ``train_pipelined`` (a ragged last window) equal to the same steps one
  by one, bit for bit.
* ``evaluate`` and ``evaluate_device`` (corpus and in-batch GAUC) on the
  converted state against JAX's: the logits agree to f32 rounding, so the
  rank AUC to 1e-6 and the bucketed ones exactly.
* A checkpoint after 3 of 5 steps, restored into a fresh state, gives
  the 5-step state exactly.
* ``python -m rec_now_tpu_torch.train`` at tiny width with ``--device
  cpu`` in both loops and both eval modes prints the JAX CLI's JSON keys;
  the routed exchange's flags reach ``TrainerConfig`` and both tables.
* The prefetchers keep order, close early and hand a worker's exception
  to the loop.
"""
import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from rec_now_tpu.models import DCNv2Model as JaxDCN
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.training import SyntheticCriteo as JaxData
from rec_now_tpu.training import Trainer as JaxTrainer
from rec_now_tpu.training import TrainerConfig as JaxConfig
from rec_now_tpu_torch import train as cli
from rec_now_tpu_torch.convert import from_jax_params, table_state_from_jax
from rec_now_tpu_torch.models import CANDCNModel, DCNv2Model, FeatureConfig
from rec_now_tpu_torch.training import (SyntheticCriteo, Trainer,
                                        TrainerConfig)
from rec_now_tpu_torch.training.checkpoint import CheckpointManager
from rec_now_tpu_torch.training.prefetch import (DevicePrefetcher,
                                                 WindowPrefetcher)

torch.set_num_threads(1)

ROWS, DIM, B = 64, 8, 128
DCN = dict(deep_dims=(32, 16), dcn_sub_dim=4)
LOSS = dict(pointwise_weight=1.0, pairwise_weight=0.5,
            click_occurance_power=-0.5, wire_dense_mode="u8")


def _pair(loss=LOSS, seed=0):
    """A JAX trainer and state, and the port's trainer and state carried
    over from it."""
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    jtrainer = JaxTrainer(JaxDCN(**DCN), jfc, JaxConfig(**loss),
                          mesh=make_mesh(1))
    first = next(JaxData(rows_per_field=ROWS, num_users=40).batches(B, 1))
    jstate = jtrainer.init(jax.random.PRNGKey(seed), first)
    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    trainer = Trainer(DCNv2Model(fc, **DCN, device="cpu"), fc,
                      TrainerConfig(**loss), device="cpu")
    state = trainer.init(
        torch.Generator(),
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_state_from_jax(jax.device_get(jstate.table), 1, DIM))
    return jtrainer, jstate, trainer, state


def _batches(n, b=B, seed=4):
    return list(SyntheticCriteo(rows_per_field=ROWS, num_users=40)
                .batches(b, n, seed=seed))


def test_train_many_packed_matches_jax_scan():
    jtrainer, jstate, trainer, state = _pair()
    batches = _batches(6)
    for lo in (0, 3):
        window = batches[lo:lo + 3]
        jstate, jm = jtrainer.train_many_packed(
            jstate, jtrainer.put_packed_window(window))
        state, m = trainer.train_many_packed(
            state, trainer.put_packed_window(window))
        assert set(m) == {"loss", "pointwise", "pairwise", "sparse_dropped"}
        for key in m:
            assert m[key].shape == (3,)
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                       rtol=2e-6, err_msg=key)
    assert int(state.step) == int(jstate.step) == 6
    want = from_jax_params(jax.device_get(jstate.params))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, err_msg=name)
    every = np.arange(trainer.fc.total_rows)
    np.testing.assert_allclose(
        state.table.table.numpy(),
        jtrainer.table.debug_read(jax.device_get(jstate.table.table),
                                  every), atol=1e-7)
    np.testing.assert_allclose(
        state.table.accumulator.numpy(),
        jtrainer.table.debug_read(jax.device_get(jstate.table.accumulator),
                                  every), rtol=1e-6)


def _fresh(loss=LOSS):
    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    trainer = Trainer(DCNv2Model(fc, **DCN, device="cpu", seed=2), fc,
                      TrainerConfig(**loss), device="cpu")
    return trainer, trainer.init(torch.Generator().manual_seed(3))


def _assert_same_state(a, b):
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
    for name, t in a.table._asdict().items():
        if t is not None:
            assert torch.equal(t, getattr(b.table, name)), name
    assert int(a.step) == int(b.step)


def test_train_pipelined_equals_the_steps_one_by_one():
    batches = _batches(7)
    trainer, piped = _fresh()
    piped, last = trainer.train_pipelined(piped, iter(batches), window=4)
    assert last["loss"].shape == (3,)                 # the ragged window
    trainer2, stepped = _fresh()
    losses = []
    for lo in (0, 4):
        packed = trainer2.wire.pack_window(batches[lo:lo + 4])
        dev = trainer2.put_packed_window(batches[lo:lo + 4])
        for s, decoded in enumerate(trainer2._steps_of(dev)):
            # the decode is the wire's: the u8 dense as packed
            np.testing.assert_array_equal(decoded[1].numpy(),
                                          batches[lo + s].sparse_ids)
            assert decoded[0].shape == packed.dense.shape[1:]
            stepped, m = trainer2.train_step(stepped, *decoded)
            losses.append(m["loss"])
    _assert_same_state(piped, stepped)
    assert torch.equal(last["loss"], torch.stack(losses[4:]))


@pytest.mark.parametrize("gauc", ["corpus", "inbatch"])
def test_evaluate_and_evaluate_device_match_jax(gauc):
    jtrainer, jstate, trainer, state = _pair()
    train = _batches(2)
    for b in train:                   # scores with some signal
        jstate, _ = jtrainer.train_step(jstate, *jtrainer.put(b))
        state, _ = trainer.train_step(state, *trainer.put(b))
    evals = _batches(5, seed=9)
    want = jtrainer.evaluate(jstate, evals)
    got = trainer.evaluate(state, evals)
    assert set(got) == set(want) == {"auc", "gauc", "num_groups"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    # 64 slots map the eval set's 37 groups exactly; 16 overflow
    for slots in (64, 16):
        kw = dict(window=2, num_buckets=1024, gauc=gauc,
                  num_group_slots=slots, group_buckets=128)
        want = jtrainer.evaluate_device(jstate, evals, **kw)
        got = trainer.evaluate_device(state, evals, **kw)
        assert list(got) == list(want)
        for key in want:
            if gauc == "inbatch" and key == "gauc":
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
            else:
                assert got[key] == want[key], key
        assert got["gauc_mode"] == gauc
        assert ("gauc_overflow" in got) == (gauc == "corpus" and slots == 16)
    with pytest.raises(ValueError, match="65536"):
        trainer.evaluate_device(state, evals, num_group_slots=70000)


def test_checkpoint_resume_equals_an_unbroken_run(tmp_path):
    loss = dict(LOSS, sparse_optimizer="adam", sparse_lr=1e-3)
    batches = _batches(5)
    trainer, whole = _fresh(loss)
    for b in batches:
        whole, _ = trainer.train_step(whole, *trainer.put(b))
    trainer, part = _fresh(loss)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for i, b in enumerate(batches[:3]):
        part, _ = trainer.train_step(part, *trainer.put(b))
        ckpt.save(i + 1, part)
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    other, fresh = _fresh(loss)
    fresh = ckpt.restore(target=fresh)
    _assert_same_state(fresh, part)
    for b in batches[3:]:
        fresh, _ = other.train_step(fresh, *other.put(b))
    _assert_same_state(fresh, whole)
    assert int(fresh.table.count) == 5
    saved = ckpt.restore(2)
    assert int(saved["step"]) == 2 and "m" in saved["table"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


TINY = ["--device", "cpu", "--batch-size", "32", "--rows-per-field", "128",
        "--embedding-dim", "4", "--eval-batches", "2"]
# the keys of the JAX CLI's lines (rec_now_tpu/train.py:245-317)
FINAL_KEYS = {"final_eval", "steps", "model", "eval_mode"}
EXACT_KEYS = {"auc", "gauc", "num_groups"}
DEVICE_KEYS = {"auc", "gauc_mode", "num_pos", "num_neg", "gauc",
               "gauc_groups"}


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("eval_mode", ["exact", "device"])
def test_cli_runs_both_loops_with_the_jax_keys(capsys, tmp_path, window,
                                               eval_mode):
    rc = cli.main(TINY + [
        "--model", "dcnv2", "--steps", "6", "--scan-window", str(window),
        "--log-every", "3", "--eval-every", "6", "--eval-mode", eval_mode,
        "--eval-group-slots", "256", "--eval-group-buckets", "64",
        "--pairwise-weight", "0.5", "--occurance-power", "-0.5",
        "--wire-dense-mode", "u8", "--checkpoint-dir", str(tmp_path),
        "--checkpoint-every", "3", "--route-strict"])
    assert rc == 0
    lines = _lines(capsys)
    logs = [ln for ln in lines if "examples_per_sec" in ln]
    assert [ln["step"] for ln in logs] == [3, 6]
    for ln in logs:
        assert set(ln) == {"loss", "pointwise", "pairwise", "sparse_dropped",
                           "step", "examples_per_sec"}
        assert np.isfinite(ln["loss"]) and ln["loss"] > 0
    keys = EXACT_KEYS if eval_mode == "exact" else DEVICE_KEYS
    evals = [ln for ln in lines if "eval" in ln]
    assert [ln["step"] for ln in evals] == [6]
    assert set(evals[0]) == {"step", "eval", "eval_mode"}
    (final,) = [ln for ln in lines if "final_eval" in ln]
    assert set(final) == FINAL_KEYS and set(final["final_eval"]) == keys
    assert final["final_eval"] == evals[0]["eval"]
    assert 0.0 <= final["final_eval"]["auc"] <= 1.0
    assert CheckpointManager(str(tmp_path)).steps() == [3, 6]


@pytest.mark.parametrize("model,keys", [
    ("fm", {"loss", "pointwise"}),
    ("xdeepfm", {"loss", "pointwise"}),
    ("multitask", {"loss", "pointwise", "cvr_loss"})])
def test_cli_runs_every_model(capsys, model, keys):
    assert cli.main(TINY + ["--model", model, "--steps", "2",
                            "--log-every", "1", "--scan-window", "2"]) == 0
    lines = _lines(capsys)
    logs = [ln for ln in lines if "examples_per_sec" in ln]
    assert set(logs[0]) == keys | {"sparse_dropped", "step",
                                   "examples_per_sec"}
    (final,) = [ln for ln in lines if "final_eval" in ln]
    extra = {"cvr_auc", "cvr_gauc"} if model == "multitask" else set()
    assert set(final["final_eval"]) == EXACT_KEYS | extra


@pytest.mark.parametrize("flags,want", [
    (["--sparse-route-mode", "routed"], dict(sparse_route_mode="routed")),
    (["--route-cap-factor", "3.0"], dict(route_cap_factor=3.0)),
    (["--route-ov-cap", "64"], dict(route_ov_cap=64)),
    (["--route-ov-cap", "0"], dict(route_ov_cap=None)),
    (["--route-strict", "--sparse-route-mode", "allgather"],
     dict(route_strict=True, sparse_route_mode="allgather"))],
    ids=["routed", "cap", "ov_cap", "ov_cap_0", "strict"])
def test_cli_route_flags_reach_the_trainer_and_both_tables(flags, want):
    """The routed exchange's flags reach ``TrainerConfig`` and, on one
    device, both tables, where any mode resolves to allgather (no
    exchange); ``--route-ov-cap 0`` is None, the b // 16 lane."""
    args = cli.parse_args(TINY + flags)
    cfg = cli.trainer_config(args)
    defaults = dict(sparse_route_mode="auto", route_strict=False,
                    route_cap_factor=2.0, route_ov_cap=None)
    for key, value in dict(defaults, **want).items():
        assert getattr(cfg, key) == value, key
    trainer = cli.make_trainer(args)
    assert trainer.cfg == cfg
    fc = FeatureConfig(rows_per_field=128, embedding_dim=4)
    can = Trainer(CANDCNModel(fc, deep_dims=(8,), dcn_sub_dim=4,
                              device="cpu"), fc,
                  dataclasses.replace(cfg, can_param_field=8), device="cpu")
    for table in (trainer.table, can.table, can.can_table):
        assert table.route_mode == "allgather"
        assert (table.route_cap_factor, table.route_ov_cap) == (
            cfg.route_cap_factor, cfg.route_ov_cap)


def test_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--steps", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.make_trainer(args)


def test_prefetchers_keep_order_and_close():
    got = list(DevicePrefetcher(iter(range(50)), lambda x: x * 2, depth=3))
    assert got == [2 * i for i in range(50)]
    wins = list(WindowPrefetcher(iter(range(11)), lambda w: list(w), 4))
    assert wins == [([0, 1, 2, 3], 4), ([4, 5, 6, 7], 4), ([8, 9, 10], 3)]
    endless = DevicePrefetcher(iter(int, 1), lambda x: x, depth=2)
    it = iter(endless)
    assert next(it) == 0
    endless.close(timeout=2.0)
    assert not endless._thread.is_alive()
    with WindowPrefetcher(iter(int, 1), lambda w: w, 2) as wp:
        assert next(iter(wp)) == ([0, 0], 2)
    assert not wp._inner._thread.is_alive()


def test_prefetcher_hands_a_worker_exception_to_the_loop():
    def source():
        yield 1
        yield 2
        raise OSError("bad file")

    seen = []
    with pytest.raises(OSError, match="bad file"):
        for x in DevicePrefetcher(source(), lambda x: x):
            seen.append(x)
    assert seen == [1, 2]

    def put(w):
        if w[0] >= 4:
            raise ValueError(f"cannot pack {w}")
        return threading.current_thread().name

    with pytest.raises(ValueError, match="cannot pack"):
        names = [n for n, _ in WindowPrefetcher(iter(range(8)), put, 2)]
    names = [n for n, _ in WindowPrefetcher(iter(range(4)), put, 2)]
    assert names and all(n != threading.current_thread().name
                         for n in names)
