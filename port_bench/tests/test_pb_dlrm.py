"""The ``dlrm-dcnv2-criteo1tb`` cell at a small size on the CPU: the
multi-hot driver's result line and traffic, the reference loading
nothing of the program, the FLOP count and the pooled lookup's bound on
hand-counted shapes, and three faults the comparison that decides
``correct`` must catch: one field's pooled rows altered, the cross
layer's ``+ x_l`` dropped, a request's id columns shifted by one field.
On the card (``cuda``): the program passes the cell's limit and its
TF32 control fails it, and a traced run prints the new metrics."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import harness
from conftest import ROOT

CELL = "dlrm-dcnv2-criteo1tb-serve-b8192"
# the published widths with a small table, batch and pool
ROWS = [50, 7, 9, 5, 11, 2, 6, 8, 3, 50, 40, 30, 5, 9, 12, 7, 2, 6, 7, 50,
        60, 50, 30, 13, 5, 9]
SIZES = {"cfg": {"num_embeddings_per_feature": ROWS},
         "mix": {"batch_size": 32, "pool_requests": 4, "warmup_requests": 2,
                 "check_requests": 3, "trace_steady_s": 0.3,
                 "trace_s": 0.3}}


def small_cell(trace=False, device="cpu", sizes=SIZES,
               seed=2 ** 33 + 5):
    return harness.Cell(CELL, seed, 0.6, trace, device, time.monotonic(),
                        sizes=sizes)


def _run(**kw):
    cell = small_cell(**kw)
    return cell, cell.driver().run(cell)


def _line(capsys, cell, out, trace):
    import run
    assert run.emit(cell, out, trace) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    return line


def test_pb_dlrm_cell_runs(capsys):
    cell, out = _run()
    line = _line(capsys, cell, out, False)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_examples_per_s", "serve_p95_ms",
                                    "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == {"logit_gap"}


def test_pb_dlrm_cell_traced(capsys):
    from rec_now_tpu_torch.ops import gather_kernel
    before = gather_kernel.gather_pool_rows_plain
    cell, out = _run(trace=True)
    line = _line(capsys, cell, out, True)
    assert line["correct"] is True
    listed = {m["name"] for m in cell.bench["per_layer"]
              if cell.name in m.get("workloads", ())}
    assert {"gather_pool_rows_roofline", "cross_stream_ms.serve",
            "mfu.serve"} <= listed
    # the CPU has no device trace or stream time: only host-side readers
    got = set(line["metrics"])
    assert got <= listed
    assert {"mfu.serve", "request_host_ms.serve", "program_setup_s"} <= got
    assert not got & {"gather_pool_rows_roofline", "cross_stream_ms.serve"}
    # the recorder saw the pooled lookup, one call a request
    assert out["ctx"]["bound_s"]["gather_pool_rows"] > 0
    assert gather_kernel.gather_pool_rows_plain is before


def test_pb_dlrm_same_seed_same_traffic():
    cell = small_cell()
    draw = cell.driver().draw_pool
    a = draw(cell.cfg, cell.mix, 2 ** 40 + 3)
    b = draw(cell.cfg, cell.mix, 2 ** 40 + 3)
    c = draw(cell.cfg, cell.mix, 2 ** 40 + 4)
    for (da, ia), (db, ib) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(da, db)
    assert not np.array_equal(a[0][1], c[0][1])
    dense, ids = a[0]
    assert dense.shape == (32, 13) and dense.dtype == np.float32
    assert ids.shape == (32, 214) and ids.dtype == np.int32
    assert dense.min() >= 0
    at = 0
    for rows, h in zip(ROWS, cell.cfg["multi_hot_sizes"]):
        col = np.stack([x for _, x in a])[..., at:at + h]
        assert 0 <= col.min() and col.max() < rows
        at += h


def test_pb_dlrm_reference_loads_nothing_of_the_program():
    code = f"""
import importlib.util, json, sys
sys.path.insert(0, {str(ROOT / 'reference')!r})
name = "dlrm-dcnv2-criteo1tb"
spec = importlib.util.spec_from_file_location(
    "ref", {str(ROOT / 'reference')!r} + "/" + name + ".py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = {m.split(".", 1)[0]
            for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "optax", "rec_now_tpu",
                       "rec_now_tpu_torch"}


def test_pb_dlrm_flops_by_hand():
    fl = harness.flops("dlrm-dcnv2-criteo1tb")
    cfg = harness.read_json(ROOT / "configs" / "dlrm-dcnv2-criteo1tb.json")
    # dense 2(13*512 + 512*256 + 256*128) = 340,992; cross 3 * 2 * 2 *
    # 3,456 * 512 = 21,233,664; over 2(3,456*1,024 + 1,024^2 + 1,024*512
    # + 512*256 + 256) = 10,486,272
    assert fl.example_flops(cfg) == 340_992 + 21_233_664 + 10_486_272
    assert fl.request_flops(cfg, 8192) == 8192 * 32_060_928
    small = {"num_dense_features": 2, "dense_arch_layer_sizes": [3, 4],
             "num_sparse_features": 1, "embedding_dim": 4,
             "dcn_num_layers": 2, "dcn_low_rank_dim": 3,
             "over_arch_layer_sizes": [5, 1]}
    # dense 2*3 + 3*4 = 18; x0 8 wide: 2 layers of 8*3 + 3*8 = 96; over
    # 8*5 + 5*1 = 45; 2 operations a multiply-add
    assert fl.example_flops(small) == 2 * (18 + 96 + 45)


def test_pb_gather_pool_bound():
    b = harness.load_path(ROOT / "bounds" / "gather_pool_rows.py",
                          "t_bound_gather_pool_rows")
    assert b.TARGET == "rec_now_tpu_torch.ops.gather_kernel:gather_pool_rows"
    table = torch.zeros(10, 4)
    ids = torch.tensor([[1, 1, 3], [9, 30, -2]])        # clamps: 9, 9, 0
    ops, nbytes = b.work(b.record((table, ids, (1, 2)), {}))
    # 4 distinct rows read, 2 x 2 pooled rows written, 6 int64 ids
    assert ops == 0 and nbytes == 4 * 16 + 4 * 16 + 6 * 8


def _fails(monkeypatch, patch):
    patch(monkeypatch)
    cell, out = _run()
    return out["correct"] is False and out["checks"]["logit_gap"][
        "value"] > out["checks"]["logit_gap"]["limit"]


def test_pb_dlrm_sound_run_is_correct():
    assert _run()[1]["correct"] is True


def test_pb_dlrm_pooled_row_altered_fails(monkeypatch):
    import rec_now_tpu_torch.embedding.table as table_mod
    pool = table_mod.gather_pool_rows

    def last_id_left_out(table, ids, hotness):
        # field 20 (100 ids) pools 99 of them
        out = pool(table, ids, hotness)
        last = sum(hotness[:21]) - 1
        out[:, 20] -= table[ids[:, last].clamp(0, table.shape[0] - 1)]
        return out

    assert _fails(monkeypatch, lambda mp: mp.setattr(
        table_mod, "gather_pool_rows", last_id_left_out))


def test_pb_dlrm_cross_residual_dropped_fails(monkeypatch):
    from rec_now_tpu_torch.layers.low_rank_cross_layer import (
        LowRankCrossLayer)

    def no_residual(self, x0):
        x = x0
        for i in range(self.num_layers):
            x = x0 * torch.addmm(self.biases[i], x @ self.v_kernels[i],
                                 self.w_kernels[i])
        return x

    assert _fails(monkeypatch, lambda mp: mp.setattr(
        LowRankCrossLayer, "forward", no_residual))


def test_pb_dlrm_ids_shifted_by_a_field_fails(monkeypatch):
    import rec_now_tpu_torch.serving as serving
    forward = serving._forward

    def shifted(model, fc, table, can, state, dense, ids):
        # the columns read one field late: field 0's 3 ids wrap to the end
        return forward(model, fc, table, can, state, dense,
                       torch.roll(ids, -fc.hotness[0], dims=1))

    assert _fails(monkeypatch, lambda mp: mp.setattr(serving, "_forward",
                                                     shifted))


@pytest.mark.cuda
def test_pb_dlrm_control_fails_program_passes(cuda_device):
    import control
    sizes = {"cfg": {"num_embeddings_per_feature": [
        r // 64 + 1 for r in harness.read_json(
            ROOT / "configs" / "dlrm-dcnv2-criteo1tb.json")[
                "num_embeddings_per_feature"]]},
        "mix": {"pool_requests": 4}}
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        cell = small_cell(device=cuda_device, sizes=sizes, seed=seed)
        prog = control.readings(cell, "program")
        ctrl = control.readings(cell, "control")
        lim = cell.limits["logit_gap"]
        assert prog["logit_gap"]["value"] <= lim < ctrl["logit_gap"]["value"]


@pytest.mark.cuda
def test_pb_dlrm_traced_cell_prints_its_metrics(capsys, cuda_device):
    from rec_now_tpu_torch.ops import gather_kernel
    before = gather_kernel.gather_pool_rows.launches
    cell, out = _run(trace=True, device=cuda_device)
    line = _line(capsys, cell, out, True)
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    listed = {m["name"] for m in cell.bench["per_layer"]
              if cell.name in m.get("workloads", ())}
    assert set(got) == listed
    assert 0 < got["gather_pool_rows_roofline"] <= 100
    assert got["cross_stream_ms.serve"] > 0
    assert gather_kernel.gather_pool_rows.launches > before
