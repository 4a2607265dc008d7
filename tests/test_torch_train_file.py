"""Port vs JAX: the training CLI on a data file, on the CPU.

``main`` of ``rec_now_tpu_torch.train`` and of ``rec_now_tpu.train`` on
the same ``write_synthetic_tsv`` file, at the JAX CLI test's width
(``tests/training/test_cli_and_profiling.py:63-90``: FM, B = 32, 256
rows a field, D = 4).  The JAX CLI runs on one device (``make_mesh``
gives it a one-device mesh, as the port's one device) and its initial
state is carried into the port's run (``init_state``), so both train
the same weights on the same rows: each run's final eval has JAX's keys
and its ``auc`` / ``gauc`` within 1e-6 of JAX's; the log lines' losses
agree to 1e-5 relative.  Cases: the held-out eval (rows past
``--steps``), a file with none held out (the ``warning`` line and
``eval_on_train`` on every eval line and the final line), ``--eval-file``
(and without ``--data-file``, where JAX ignores it), and ``--wire-id-mode
hot8`` with device eval and ``--scan-window`` 3 and 6, equal to packed
ids (against JAX's hot8 CLI where it is deterministic, one window; see
the test).
"""
import json

import jax
import numpy as np
import pytest
import torch

import rec_now_tpu.parallel as jparallel
from rec_now_tpu import train as jcli
from rec_now_tpu.training import Trainer as JaxTrainer
from rec_now_tpu_torch import train as cli
from rec_now_tpu_torch.convert import from_jax_params, table_state_from_jax
from rec_now_tpu_torch.io import write_synthetic_tsv

torch.set_num_threads(1)

COMMON = ["--model", "fm", "--batch-size", "32", "--rows-per-field", "256",
          "--embedding-dim", "4", "--eval-batches", "2", "--log-every", "2"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsv")
    train, other = str(d / "train.tsv"), str(d / "eval.tsv")
    write_synthetic_tsv(train, 32 * 6, rows_per_field=256, num_users=16)
    write_synthetic_tsv(other, 32 * 3, rows_per_field=256, num_users=16,
                        sample_seed=9)
    return train, other


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def _strip(lines):
    """The lines without their rates (host time)."""
    return [{k: v for k, v in ln.items() if k != "examples_per_sec"}
            for ln in lines]


def _run_both(monkeypatch, capsys, argv, port_extra=()):
    """(JAX CLI lines, port CLI lines) of one command line (the port's
    with ``port_extra`` added); the port starts from the JAX run's
    initial state."""
    one = jparallel.make_mesh(1)
    monkeypatch.setattr(jparallel, "make_mesh", lambda *a, **k: one)
    init, seen = JaxTrainer.init, {}

    def spy(self, *a, **k):
        state = init(self, *a, **k)
        # the JAX steps donate the state's buffers: copy them now
        seen["params"] = jax.device_get(state.params)
        seen["table"] = jax.device_get(state.table)
        return state

    monkeypatch.setattr(JaxTrainer, "init", spy)
    assert jcli.main(argv) == 0
    want = _lines(capsys)
    monkeypatch.setattr(cli, "init_state", lambda trainer, args: trainer.init(
        torch.Generator(), params=from_jax_params(seen["params"]),
        table=table_state_from_jax(seen["table"], 1, 4)))
    assert cli.main(["--device", "cpu"] + argv + list(port_extra)) == 0
    return want, _lines(capsys)


def _same_run(got, want):
    assert [sorted(ln) for ln in got] == [sorted(ln) for ln in want]
    for a, b in zip(got, want):
        if "examples_per_sec" in a:
            assert a["step"] == b["step"]
            for key in ("loss", "pointwise"):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5)
        for key in ("eval", "final_eval"):
            if key in a:
                assert set(a[key]) == set(b[key])
                for k in ("auc", "gauc"):
                    assert abs(a[key][k] - b[key][k]) <= 1e-6, (key, k)
        for key in ("warning", "eval_on_train", "steps", "eval_mode"):
            assert a.get(key) == b.get(key)


def test_held_out_eval_matches_jax(monkeypatch, capsys, files):
    want, got = _run_both(monkeypatch, capsys, COMMON + [
        "--data-file", files[0], "--steps", "4", "--eval-every", "4"])
    _same_run(got, want)
    final = got[-1]
    assert "final_eval" in final and "eval_on_train" not in final
    assert not any("warning" in ln for ln in got)


def test_a_file_with_none_held_out_evaluates_training_rows(monkeypatch,
                                                           capsys, files):
    want, got = _run_both(monkeypatch, capsys, COMMON + [
        "--data-file", files[0], "--steps", "6", "--eval-every", "6"])
    _same_run(got, want)
    assert "warning" in got[0] and "TRAINING data" in got[0]["warning"]
    evals = [ln for ln in got if "eval" in ln or "final_eval" in ln]
    assert len(evals) == 2
    assert all(ln["eval_on_train"] is True for ln in evals)


def test_eval_file_matches_jax(monkeypatch, capsys, files):
    want, got = _run_both(monkeypatch, capsys, COMMON + [
        "--data-file", files[0], "--eval-file", files[1], "--steps", "6"])
    _same_run(got, want)
    assert got[-1]["final_eval"]["num_groups"] > 0
    assert not any("warning" in ln for ln in got)


def test_eval_file_without_a_data_file_is_ignored(capsys, files):
    argv = ["--device", "cpu"] + COMMON + ["--steps", "2"]
    assert cli.main(argv + ["--eval-file", files[1]]) == 0
    with_file = _strip(_lines(capsys))
    assert cli.main(argv) == 0
    assert with_file == _strip(_lines(capsys))
    assert "num_groups" in with_file[-1]["final_eval"]


@pytest.mark.parametrize("window,jax_ids", [(3, "packed"), (6, "hot8")])
def test_hot8_windowed_with_device_eval_matches_jax_and_packed(
        monkeypatch, capsys, files, window, jax_ids):
    """The port under hot8 against JAX's CLI, and equal to its own run
    with packed ids.  With windows of 3, the file's second window
    overflows the first window's table and JAX's prefetch thread
    relearns it while the first window waits: JAX then decodes that
    window with whichever table it holds when its scan is traced (the
    stale-table fault the port does not carry over), so there the port's
    hot8 run is held to JAX's run with packed ids, which a lossless codec
    must give.  With one window of 6, JAX's hot8 run packs and traces
    one table per window, and the port is held to it."""
    argv = COMMON + ["--data-file", files[0], "--eval-file", files[1],
                     "--steps", "6", "--scan-window", str(window),
                     "--eval-mode", "device", "--eval-group-slots", "64",
                     "--eval-group-buckets", "64", "--log-every", "3"]
    want, got = _run_both(monkeypatch, capsys,
                          argv + ["--wire-id-mode", jax_ids],
                          ["--wire-id-mode", "hot8"])
    _same_run(got, want)
    assert set(got[-1]["final_eval"]) == {"auc", "gauc_mode", "num_pos",
                                          "num_neg", "gauc", "gauc_groups"}
    assert cli.main(["--device", "cpu"] + argv) == 0      # packed ids
    assert _strip(_lines(capsys)) == _strip(got)
