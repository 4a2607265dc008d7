"""The ``ple-aliexpress`` cell at a small size on the CPU: the multi-hot
driver serving a one-hot configuration with dense floats (the result
line's shape, both modes), its traffic, the reference loading nothing of
the program, the FLOP count and the expert banks' bound on hand-counted
shapes, and four faults the comparison that decides ``correct`` must
catch: a task's gate over its own experts only, the level-1 experts'
ReLU dropped, the two tasks' logit rows swapped, the dense floats' field
zeroed.  On the card (``cuda``): the program passes the cell's limit
and its TF32 control fails it, and a traced run prints the new
metrics."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import harness
from conftest import ROOT

CELL = "ple-aliexpress-serve-b8192"
CONFIG = "ple-aliexpress"
# the published widths with a small table, batch and pool
ROWS = [50, 7, 9, 5, 11, 2, 6, 8, 3, 50, 40, 30, 5, 9, 12, 7]
SIZES = {"cfg": {"num_embeddings_per_feature": ROWS},
         "mix": {"batch_size": 32, "pool_requests": 4, "warmup_requests": 2,
                 "check_requests": 3, "trace_steady_s": 0.3,
                 "trace_s": 0.3}}


def small_cell(trace=False, device="cpu", sizes=SIZES, seed=2 ** 33 + 9):
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


def test_pb_ple_cell_runs(capsys):
    cell, out = _run()
    line = _line(capsys, cell, out, False)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_examples_per_s", "serve_p95_ms",
                                    "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == {"logit_gap"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_pb_ple_cell_traced(capsys):
    cell, out = _run(trace=True)
    line = _line(capsys, cell, out, True)
    assert line["correct"] is True
    listed = {m["name"] for m in cell.bench["per_layer"]
              if cell.name in m.get("workloads", ())}
    assert {"ple_stream_ms.serve", "multi_dense_roofline",
            "gather_rows_roofline", "kernel_roofline.serve",
            "mfu.serve"} <= listed
    # the CPU has no device trace or stream time: only host-side readers
    got = set(line["metrics"])
    assert got <= listed
    assert {"mfu.serve", "request_host_ms.serve", "program_setup_s"} <= got
    assert not got & {"ple_stream_ms.serve", "multi_dense_roofline"}
    # one-hot fields: the recorder saw B11, one call a request
    assert out["ctx"]["bound_s"]["gather_rows"] > 0


def test_pb_ple_same_seed_same_traffic():
    cell = small_cell()
    draw = cell.driver().draw_pool
    a = draw(cell.cfg, cell.mix, 2 ** 40 + 3)
    b = draw(cell.cfg, cell.mix, 2 ** 40 + 3)
    c = draw(cell.cfg, cell.mix, 2 ** 40 + 4)
    for (da, ia), (db, ib) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(da, db)
    assert not np.array_equal(a[0][1], c[0][1])
    dense, ids = a[0]
    assert dense.shape == (32, 63) and dense.dtype == np.float32
    assert ids.shape == (32, 16) and ids.dtype == np.int32
    assert dense.min() >= 0
    every = np.stack([x for _, x in a])
    for f, rows in enumerate(ROWS):
        assert 0 <= every[..., f].min() and every[..., f].max() < rows


def test_pb_ple_reference_loads_nothing_of_the_program():
    code = f"""
import importlib.util, json, sys
sys.path.insert(0, {str(ROOT / 'reference')!r})
spec = importlib.util.spec_from_file_location(
    "ref", {str(ROOT / 'reference' / 'ple-aliexpress.py')!r})
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


def test_pb_ple_flops_by_hand():
    fl = harness.flops(CONFIG)
    cfg = harness.read_json(ROOT / "configs" / f"{CONFIG}.json")
    # projection 63 * 128 = 8,064; level 1: 12 experts of 2,176 x 512 =
    # 13,369,344, gates 2,176 x (2 x 8 + 12) = 60,928; level 2: 12 x 512
    # x 256 = 1,572,864, gates 512 x 2 x 8 = 8,192; towers 2 x (256 x
    # 128 + 128 x 64 + 64) = 82,048: 15,101,440 multiply-adds
    assert fl.example_flops(cfg) == 2 * 15_101_440 == 30_202_880
    assert fl.request_flops(cfg, 8192) == 8192 * 30_202_880
    small = {"num_dense_features": 2, "num_sparse_features": 1,
             "embedding_dim": 3, "bottom_mlp_dims": [4, 5],
             "tower_mlp_dims": [2], "task_num": 2, "shared_expert_num": 1,
             "specific_expert_num": 2}
    # projection 2 * 3 = 6; 6 wide in; level 1: 5 experts of 6 x 4 = 120,
    # gates 6 x (2 x 3 + 5) = 66; level 2: 5 x 4 x 5 = 100, gates 4 x 2 x
    # 3 = 24; towers 2 x (5 x 2 + 2 x 1) = 24
    assert fl.example_flops(small) == 2 * (6 + 120 + 66 + 100 + 24 + 24)


def test_pb_multi_dense_bound():
    b = harness.load_path(ROOT / "bounds" / "multi_dense_fused.py",
                          "t_bound_multi_dense_fused")
    assert b.TARGET == ("rec_now_tpu_torch.ops.multi_dense_kernel:"
                        "multi_dense_fused")
    x = torch.zeros(1, 10, 6)
    w = torch.zeros(3, 6, 4)
    bias = torch.zeros(3, 1, 4)
    rec = b.record((x, w, bias, True), {})
    # shapes only: no tensor is held past the call
    assert not any(isinstance(v, torch.Tensor) for v in rec.values())
    ops, nbytes = b.work(rec)
    # 3 x 10 x 6 x 4 = 720 multiply-adds; x 60, W 72, bias 12, out 120
    # floats
    assert ops == 1440 and nbytes == (60 + 72 + 12 + 120) * 4
    ops, nbytes = b.work(b.record((torch.zeros(3, 10, 6), w, None, False),
                                  {}))
    assert ops == 1440 and nbytes == (180 + 72 + 120) * 4


def _fails(monkeypatch, patch):
    patch(monkeypatch)
    cell, out = _run()
    return out["correct"] is False and out["checks"]["logit_gap"][
        "value"] > out["checks"]["logit_gap"]["limit"]


def test_pb_ple_sound_run_is_correct():
    assert _run()[1]["correct"] is True


def _towers(model, outs):
    return torch.stack([
        getattr(model, f"head_{t}")(getattr(model, f"tower_{t}")(
            outs[t], relu_last=True)).squeeze(-1)
        for t in range(model.num_task)])


def test_pb_ple_gate_over_own_experts_fails(monkeypatch):
    from rec_now_tpu_torch.layers.ple_layer import PLELayer

    def own_only(self, inputs):
        # each task's gate weighs its own experts alone, renormalized
        total = len(self.names)
        last = [inputs] * total
        for l in range(self.num_layer):
            banks = getattr(self, f"ple_layer_{l}")
            gates = getattr(self, f"ple_gate_{l}")
            outs = []
            for t in range(total):
                x = last[t]
                for layer in banks[f"task_{self.names[t]}"].values():
                    x = layer(x)
                outs.append(x)
            gated = []
            for t in range(total):
                if self.is_shared[t] and l == self.num_layer - 1:
                    gated.append(None)
                    continue
                experts = (torch.cat(outs, 0) if self.is_shared[t]
                           else outs[t])
                logits = gates[f"task_{self.names[t]}"]["dense"](last[t])
                w = torch.softmax(logits[:, :experts.shape[0]], -1)
                gated.append(torch.einsum("nbu,bn->bu", experts, w))
            last = gated
        return [o for o in last if o is not None]

    assert _fails(monkeypatch, lambda mp: mp.setattr(PLELayer, "forward",
                                                     own_only))


def test_pb_ple_level1_relu_dropped_fails(monkeypatch):
    import rec_now_tpu_torch.layers.multi_dense_layer as mdl
    apply = mdl.multi_dense_apply
    width = 17 * 128

    def no_relu_at_level1(inputs, kernel, bias=None, activation=None):
        if kernel.shape[1] == width:
            activation = None
        return apply(inputs, kernel, bias, activation)

    assert _fails(monkeypatch, lambda mp: mp.setattr(
        mdl, "multi_dense_apply", no_relu_at_level1))


def test_pb_ple_task_rows_swapped_fails(monkeypatch):
    from rec_now_tpu_torch.models import PLEModel
    forward = PLEModel.forward

    def swapped(self, dense, sparse_emb):
        return forward(self, dense, sparse_emb).flip(0)

    assert _fails(monkeypatch, lambda mp: mp.setattr(PLEModel, "forward",
                                                     swapped))


def test_pb_ple_dense_field_zeroed_fails(monkeypatch):
    from rec_now_tpu_torch.models import PLEModel

    def zero_field(self, dense, sparse_emb):
        b, _, d = sparse_emb.shape
        x = torch.cat([sparse_emb, sparse_emb.new_zeros(b, 1, d)],
                      dim=1).reshape(b, -1)
        return _towers(self, self.ple(x))

    assert _fails(monkeypatch, lambda mp: mp.setattr(PLEModel, "forward",
                                                     zero_field))


@pytest.mark.cuda
def test_pb_ple_control_fails_program_passes(cuda_device):
    import control
    sizes = {"cfg": {"num_embeddings_per_feature": [40_000] * 16},
             "mix": {"pool_requests": 4}}
    for seed in (2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33):
        cell = small_cell(device=cuda_device, sizes=sizes, seed=seed)
        prog = control.readings(cell, "program")
        ctrl = control.readings(cell, "control")
        lim = cell.limits["logit_gap"]
        assert prog["logit_gap"]["value"] <= lim < ctrl["logit_gap"]["value"]


@pytest.mark.cuda
def test_pb_ple_traced_cell_prints_its_metrics(capsys, cuda_device):
    from rec_now_tpu_torch.core import profiling
    from rec_now_tpu_torch.ops import multi_dense_kernel as mk

    def tiles():
        c = profiling.span_report()["counters"]
        return c.get("multi_dense.tc", 0), c.get("multi_dense.gate", 0)

    before, counted = mk.multi_dense_fused.launches, tiles()
    cell, out = _run(trace=True, device=cuda_device)
    # six banks a request on the split-TF32 tile, none on the gate kernel
    served = out["attempted"] + cell.mix["warmup_requests"]
    assert tiles() == (counted[0] + 6 * served, counted[1])
    line = _line(capsys, cell, out, True)
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    listed = {m["name"] for m in cell.bench["per_layer"]
              if cell.name in m.get("workloads", ())}
    assert set(got) == listed
    assert 0 < got["multi_dense_roofline"] <= 100
    assert 0 < got["gather_rows_roofline"] <= 100
    assert got["ple_stream_ms.serve"] > 0
    assert mk.multi_dense_fused.launches > before
