"""Checkpoints and the serving export of a state sharded over two
processes, on the CPU.

Two gloo processes (``tests/torch_mp_worker.py``, one spawn for the file)
train config 2 (DCN-v2, lazy Adam, the routed exchange) and config 5 (CAN
with its second table, Adagrad) at small width for 2 steps, save a
checkpoint from both processes (rank 0 the parameters, the Adam state and
the step; each rank its rows of each table), train 2 steps more, then:

* restore the checkpoint into a fresh state on the two processes: every
  tensor bit-equal to the saved one, and the 2 steps trained from it
  bit-equal to the unbroken run's;
* restore it on one process (this one, no group): the logical tables
  bit-equal to the two processes' rows merged, the parameters, the Adam
  state and the step equal; ``restore()`` with no target gives the same
  logical tables;
* restore a one-process checkpoint on the two processes: each holds its
  rows of it;
* ``export_serving`` on the two processes writes the tensors one process
  holding the gathered tables writes.
"""
import os

import pytest
import torch

from rec_now_tpu_torch.embedding.sharded import shard_rows
from rec_now_tpu_torch.models import FeatureConfig
from rec_now_tpu_torch.serving import ServingState, export_serving
from rec_now_tpu_torch.training import (Batch, SyntheticCriteo, Trainer,
                                        TrainerConfig)
from rec_now_tpu_torch.training.checkpoint import CheckpointManager
from tests.torch_mp_worker import build_model, snapshot_state, spawn

torch.set_num_threads(1)

ROWS, DIM, B = 96, 8, 64
CASES = {
    "config2": ("dcnv2", dict(pointwise_weight=1.0, pairwise_weight=0.5,
                              click_occurance_power=-0.5,
                              sparse_optimizer="adam", sparse_lr=1e-3,
                              sparse_route_mode="routed")),
    "config5": ("can_dcn", dict(pointwise_weight=1.0, pairwise_weight=0.5,
                                can_param_field=8)),
}
FC = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)


def _one_process(name):
    model, config = CASES[name]
    trainer = Trainer(build_model(model, FC), FC, TrainerConfig(**config),
                      device="cpu")
    return trainer, trainer.init(torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ckpt")
    batches = [b._asdict() for b in SyntheticCriteo(
        rows_per_field=ROWS, num_users=12).batches(B, 4, seed=4)]
    cases, ones = [], {}
    for name, (model, config) in CASES.items():
        trainer, state = _one_process(name)
        state, _ = trainer.train_step(state, *trainer.put(Batch(
            **batches[0])))
        CheckpointManager(str(base / name / "one")).save(1, state)
        ones[name] = snapshot_state(state)
        cases.append({"model": model, "config": config, "rows": ROWS,
                      "dim": DIM, "batches": batches, "save_at": 2,
                      "dir": str(base / name / "two"),
                      "export": str(base / name / "export"),
                      "one_dir": str(base / name / "one")})
    out = spawn("checkpoint", {"cases": cases}, base / "io")
    return {"base": base, "ones": ones, "out": out}


def _ranks(runs, name):
    return [r[list(CASES).index(name)] for r in runs["out"]]


def _merge(parts):
    """Both ranks' rows -> the logical rows (id i from rank i % 2)."""
    if parts[0].dim() == 0:
        return parts[0]
    out = torch.empty((2 * parts[0].shape[0],) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype)
    out[0::2], out[1::2] = parts
    return out


def _assert_equal(got, want, where=""):
    """Nested dicts / lists of tensors and numbers, bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}/{i}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(torch.as_tensor(got), want), where
    else:
        assert got == want, where


@pytest.mark.parametrize("name", list(CASES))
def test_restore_on_two_processes_and_resume(runs, name):
    for r in _ranks(runs, name):
        assert r["steps"] == [2]
        assert r["saved"]["step"] == 2
        _assert_equal(r["restored"], r["saved"], "restored")
        _assert_equal(r["resumed"], r["whole"], "resumed")
        assert r["whole"]["step"] == 4
    assert sorted(os.listdir(runs["base"] / name / "two" / "2")) == [
        "shard-0.pt", "shard-1.pt", "state.pt"]


@pytest.mark.parametrize("name", list(CASES))
def test_two_process_checkpoint_restores_on_one(runs, name):
    ranks = _ranks(runs, name)
    saved = [r["saved"] for r in ranks]
    trainer, state = _one_process(name)
    mgr = CheckpointManager(str(runs["base"] / name / "two"))
    state = mgr.restore(target=state)
    got = snapshot_state(state)
    _assert_equal(got["params"], saved[0]["params"], "params")
    _assert_equal(got["opt"], saved[0]["opt"], "opt")
    assert got["step"] == 2
    untargeted = mgr.restore()
    for key in ("table", "can_table"):
        if key not in saved[0]:
            assert key not in got
            continue
        for t in saved[0][key]:
            want = _merge([s[key][t] for s in saved])
            _assert_equal(got[key][t], want, f"{key}.{t}")
            _assert_equal(untargeted[key][t], want, f"restore() {key}.{t}")
    assert int(untargeted["step"]) == 2


@pytest.mark.parametrize("name", list(CASES))
def test_one_process_checkpoint_restores_on_two(runs, name):
    one = runs["ones"][name]
    for rank, r in enumerate(_ranks(runs, name)):
        got = r["from_one"]
        _assert_equal(got["params"], one["params"], "params")
        assert got["step"] == one["step"] == 1
        for key in ("table", "can_table"):
            for t, v in one.get(key, {}).items():
                want = v if v.dim() == 0 else shard_rows(v, rank, 2)
                _assert_equal(got[key][t], want, f"{key}.{t}")


@pytest.mark.parametrize("name", list(CASES))
def test_export_on_two_processes_writes_the_one_process_file(runs, name,
                                                             tmp_path):
    ranks = _ranks(runs, name)
    whole = [r["whole"] for r in ranks]
    one = ServingState(
        whole[0]["params"],
        _merge([w["table"]["table"] for w in whole])[:FC.total_rows],
        _merge([w["can_table"]["table"] for w in whole])[:ROWS]
        if "can_table" in whole[0] else None)
    export_serving(str(tmp_path), one)
    want = torch.load(tmp_path / "serving.pt", weights_only=True)
    got = torch.load(runs["base"] / name / "export" / "serving.pt",
                     weights_only=True)
    _assert_equal(got, want, "serving.pt")
    assert ("can_table" in got) == (name == "config5")
