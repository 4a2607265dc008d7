"""The training CLI's ``--multihost`` and the multi-process placement, on
the CPU.

* Two gloo processes (``tests/torch_mp_worker.py``, a ``FileStore`` under
  ``tmp_path``, a hard time limit) run ``python -m rec_now_tpu_torch.train
  --multihost --device cpu``'s ``main`` four times: the windowed loop
  with hot8 ids (which fall back to packed ids with JAX's warning) and
  device eval, the stepwise loop with exact eval, a data file that both
  read from its start, and the routed exchange (``--sparse-route-mode
  routed --route-cap-factor 3 --route-ov-cap 64``) with
  ``--checkpoint-dir``.  Both ranks print the same log lines and the same
  final line (the metrics and evals are global); the routed run's
  checkpoints restore on one process.  Before them, a batch that two does
  not divide is refused, and ``--route-strict`` on a cap that drops ids
  fails the run.
* ``--multihost`` with no launcher variables forms a group of one and
  prints what the run without the flag prints (within 1e-6), in both
  loops; with ``torchrun``'s variables the group is formed from them.
* The routed exchange's flags reach the tables on a mesh, where
  ``auto`` routes from 4 processes on.
* ``put_packed_window_local`` offsets the in-batch group remap by ``rank *
  local_batch`` (not raw corpus slots), refuses a global batch past the
  uint16 field, and is ``put_packed_window`` on one process;
  ``put_local`` is ``put``.
* A process's synthetic stream is the one-process stream at its batch
  size with the seed shifted by ``rank * 7919``.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rec_now_tpu_torch import train as cli
from rec_now_tpu_torch.io import write_synthetic_tsv
from rec_now_tpu_torch.models import DCNv2Model, FeatureConfig
from rec_now_tpu_torch.parallel import Mesh
from rec_now_tpu_torch.training import (Batch, SyntheticCriteo, Trainer,
                                        TrainerConfig)
from rec_now_tpu_torch.training.checkpoint import CheckpointManager
from tests.torch_mp_worker import REPO, spawn

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--batch-size", "32", "--rows-per-field", "128",
        "--embedding-dim", "4", "--eval-batches", "2", "--log-every", "2",
        "--pairwise-weight", "0.5", "--occurance-power", "-0.5",
        "--listwise-weight", "0.25"]
WINDOWED = ["--steps", "4", "--scan-window", "2", "--eval-mode", "device",
            "--eval-group-slots", "4096", "--eval-group-buckets", "64"]
STEPWISE = ["--steps", "3", "--scan-window", "0", "--eval-mode", "exact"]
ROUTED = ["--sparse-route-mode", "routed", "--route-cap-factor", "3",
          "--route-ov-cap", "64"]


@pytest.fixture
def no_group(monkeypatch):
    """No launcher variables, and no process group left behind."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_two_process_cli_prints_one_run(tmp_path):
    data = tmp_path / "train.tsv"
    write_synthetic_tsv(str(data), 32 * 6, rows_per_field=128, num_users=8)
    ck = str(tmp_path / "ck")
    routed = TINY + ROUTED + WINDOWED + ["--checkpoint-dir", ck,
                                         "--checkpoint-every", "2"]
    runs = [TINY + ["--multihost"] + WINDOWED + ["--wire-id-mode", "hot8"],
            TINY + ["--multihost"] + STEPWISE,
            TINY + ["--multihost", "--data-file", str(data), "--steps", "4",
                    "--scan-window", "2"],
            routed + ["--multihost"]]
    ranks = spawn("cli", {
        "stops": [TINY + ["--multihost", "--batch-size", "33"],
                  TINY + ["--multihost", "--sparse-route-mode", "routed",
                          "--route-cap-factor", "0.05", "--route-ov-cap",
                          "8", "--route-strict"] + STEPWISE],
        "runs": runs}, tmp_path / "io")
    for r in ranks:
        assert "must divide by the process count 2" in r["stops"][0]
        # a cap that drops ids fails the run at its first log line
        assert r["stops"][1].startswith("routed exchange dropped ")
        assert "(route_strict=True)" in r["stops"][1]
        assert all(run["rc"] == 0 for run in r["runs"])
        hot8 = [w for w in r["runs"][0]["warnings"]
                if "falling back to 'packed'" in w]
        assert len(hot8) == 1
    for i in range(len(runs)):
        a, b = (_strip_rates(r["runs"][i]["lines"]) for r in ranks)
        assert a == b                   # every line, the rate aside
        logs = [ln for ln in a if "loss" in ln]
        assert [ln["step"] for ln in logs] == ([2] if i == 1 else [2, 4])
        for ln in logs:
            assert np.isfinite(ln["loss"]) and ln["loss"] > 0
            assert ln["sparse_dropped"] == 0
        (final,) = [ln for ln in a if "final_eval" in ln]
        assert 0.0 < final["final_eval"]["auc"] < 1.0
    # the routed run's checkpoints, written by both ranks, restore on one
    mgr = CheckpointManager(ck)
    assert mgr.steps() == [2, 4]
    assert sorted(os.listdir(os.path.join(ck, "4"))) == [
        "shard-0.pt", "shard-1.pt", "state.pt"]
    args = cli.parse_args(routed)
    trainer = cli.make_trainer(args)
    state = mgr.restore(target=cli.init_state(trainer, args))
    assert int(state.step) == 4
    saved = mgr.restore()
    assert torch.equal(state.table.table, saved["table"]["table"][
        :trainer.table.vocab_size])
    assert int(saved["step"]) == 4


def _strip_rates(lines):
    for ln in lines:
        ln.pop("examples_per_sec", None)
    return lines


@pytest.mark.parametrize("loop", [WINDOWED, STEPWISE],
                         ids=["windowed", "stepwise"])
def test_multihost_alone_is_a_group_of_one(capsys, no_group, loop):
    assert cli.main(TINY + loop) == 0
    want = _strip_rates(_lines(capsys))
    assert cli.main(TINY + loop + ["--multihost"]) == 0
    assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
    got = _strip_rates(_lines(capsys))
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if isinstance(value, dict):
                for k, v in value.items():
                    if isinstance(v, float):
                        np.testing.assert_allclose(g[key][k], v, rtol=1e-6)
                    else:
                        assert g[key][k] == v
            elif isinstance(value, float):
                np.testing.assert_allclose(g[key], value, rtol=1e-6)
            else:
                assert g[key] == value


def test_launcher_variables_form_the_group():
    """``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` as
    torchrun sets them (port 0: a group of one binds any free port); a
    second call keeps the group."""
    code = ("import torch, torch.distributed as dist\n"
            "from rec_now_tpu_torch.parallel import initialize_multihost, "
            "make_mesh\n"
            "dev = initialize_multihost('cpu')\n"
            "mesh = make_mesh('cpu')\n"
            "x = mesh.all_reduce(torch.ones(3))\n"
            "print(dev, mesh.rank, mesh.size, dist.get_backend(), "
            "float(x.sum()), initialize_multihost('cpu'))\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT="0",
               RANK="0", WORLD_SIZE="1", PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["cpu", "0", "1", "gloo", "3.0", "cpu"]


@pytest.mark.parametrize("flags,size,mode,caps", [
    (["--sparse-route-mode", "routed"], 2, "routed", (416, 32)),
    ([], 2, "allgather", (416, 32)),
    ([], 4, "routed", (104, 16)),
    (ROUTED, 4, "routed", (160, 64))],
    ids=["routed-2", "auto-2", "auto-4", "caps-4"])
def test_routed_flags_reach_the_tables_on_a_mesh(flags, size, mode, caps):
    """``--multihost`` runs with the routed flags: they reach
    ``TrainerConfig`` and the table on a mesh of ``size``, which resolves
    ``auto`` and sizes its buckets as JAX's (a process's 16 x 26 ids)."""
    args = cli.parse_args(TINY + ["--multihost"] + flags)
    trainer = cli.make_trainer(args, _mesh(0, size))
    assert trainer.cfg == cli.trainer_config(args)
    assert trainer.table.route_mode == mode
    assert trainer.table._route_caps(32 // size * 26) == caps


def _trainer(mesh=None, **cfg):
    fc = FeatureConfig(rows_per_field=64, embedding_dim=4)
    return Trainer(DCNv2Model(fc, deep_dims=(8,), dcn_sub_dim=4,
                              device="cpu"), fc,
                   TrainerConfig(**cfg), device="cpu", mesh=mesh)


def _mesh(rank, size):
    """A mesh's coordinates without a group: placement reads no more."""
    return Mesh(rank, size, torch.device("cpu"))


def _window(n=3, b=16):
    return list(SyntheticCriteo(rows_per_field=64, num_users=6).batches(
        b, n, seed=2))


def test_put_packed_window_local_offsets_the_group_remap():
    window = _window()
    plain = _trainer().put_packed_window(window)
    for rank in (0, 1):
        got = _trainer(_mesh(rank, 2)).put_packed_window_local(window)
        np.testing.assert_array_equal(
            got.group_ids.numpy().view(np.uint16),
            plain.group_ids.numpy().view(np.uint16) + rank * 16)
        for name in ("dense", "dense_scale", "id_words", "flags"):
            assert torch.equal(getattr(got, name), getattr(plain, name))
        raw = _trainer(_mesh(rank, 2)).put_packed_window_local(
            window, raw_groups=True)
        assert torch.equal(raw.group_ids, _trainer().put_packed_window(
            window, raw_groups=True).group_ids)
    one = _trainer(_mesh(0, 1)).put_packed_auto(window)
    for a, b in zip(one, plain):
        assert torch.equal(a, b)
    wide = Batch(*[np.zeros(32769)] * 6)
    with pytest.raises(ValueError, match="global batch <= 65536"):
        _trainer(_mesh(1, 2)).put_packed_window_local([wide])
    batch = window[0]
    for a, b in zip(_trainer().put_local(batch), _trainer().put(batch)):
        assert torch.equal(a, b)


def test_hot8_falls_back_to_packed_on_two_processes():
    with pytest.warns(UserWarning, match="falling back to 'packed'"):
        wire = _trainer(_mesh(1, 2), wire_id_mode="hot8").wire
    assert wire.id_mode == "packed"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _trainer(_mesh(0, 1), wire_id_mode="hot8").wire.id_mode \
            == "hot8"


def test_each_process_draws_its_own_synthetic_rows():
    args = cli.parse_args(TINY + ["--steps", "2", "--seed", "3"])
    for rank in (0, 1):
        streams = cli.data_streams(args, rank, 2)
        want = SyntheticCriteo(rows_per_field=128, seed=3)
        shift = rank * cli.PROCESS_SEED_SHIFT
        pairs = [(streams.train, want.batches(16, 2, seed=4 + shift)),
                 (streams.make_eval(), want.batches(16, 2,
                                                    seed=3 + 999 + shift))]
        for got, exp in pairs:
            got, exp = list(got), list(exp)
            assert len(got) == len(exp) == 2
            for g, e in zip(got, exp):
                assert g.labels.shape == (16,)
                for x, y in zip(g, e):
                    np.testing.assert_array_equal(x, y)
