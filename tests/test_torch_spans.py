"""The port's spans (``core/profiling.py``) on the CPU.

* with tracing off, importing the port and serving through
  ``build_scorer`` imports no ``torch._dynamo``, starts no profiler,
  creates no CUDA event, opens no profiler range and keeps no request
  span (a fresh process);
* under ``profiling.trace``, the serving spans nest in the Chrome trace
  on one thread, and the kept records share one request id and name
  their parents;
* ``span_report``'s window, self time and top-level time; the ring's
  capacity; ``serve.first_request`` once a scorer with tracing off; the
  loader's one-time spans and counter; ``annotate`` off and on.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.layers import CINLayer
from rec_now_tpu_torch.models import FeatureConfig
from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.serving import ServingState, build_scorer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SERVING = ("serve.request", "serve.to_device", "serve.lookup",
           "serve.model", "cin")

# a model over the table's rows with a CIN (layers 4 and 4 over 3
# fields), served on the CPU; the subprocess runs the same source
MODEL_SRC = textwrap.dedent("""
    import numpy as np
    import torch
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.layers import CINLayer
    from rec_now_tpu_torch.models import FeatureConfig
    from rec_now_tpu_torch.serving import ServingState, build_scorer


    class CinModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cin = CINLayer(3, [4, 4], torch.Generator().manual_seed(0),
                                device="cpu")

        def forward(self, dense, emb):
            return self.cin(emb, output_input=False,
                            sum_channel=False).sum(-1)


    def make_scorer():
        fc = FeatureConfig(num_dense=0, num_sparse=3, rows_per_field=10,
                           embedding_dim=4)
        model = CinModel()
        table = EmbeddingTable(fc.total_rows, fc.embedding_dim, "cpu")
        state = ServingState(dict(model.named_parameters()),
                             table.init(torch.Generator().manual_seed(0)))
        return build_scorer(model, fc, table, device="cpu"), state


    def request(seed):
        ids = np.random.default_rng(seed).integers(0, 10, (5, 3))
        return np.zeros((5, 0), np.float32), ids.astype(np.int32)
""")
_ns: dict = {}
exec(MODEL_SRC, _ns)
make_scorer, request = _ns["make_scorer"], _ns["request"]


def test_tracing_off_costs_no_profiler_event_or_dynamo():
    # the stand-ins go in before the port is imported, so that no name
    # the port binds at import escapes them
    code = textwrap.dedent("""
        import json, sys
        import torch
        import torch.autograd.profiler as ap
        import torch._C._profiler as cp
        used = {"profile": 0, "record_function": 0, "range": 0,
                "cuda_event": 0}

        def counting(key, orig):
            def init(self, *a, **k):
                used[key] += 1
                orig(self, *a, **k)
            return init

        ap.profile.__init__ = counting("profile", ap.profile.__init__)
        ap.record_function.__init__ = counting(
            "record_function", ap.record_function.__init__)
        fast = cp._RecordFunctionFast

        def fast_range(*a, **k):
            used["range"] += 1
            return fast(*a, **k)
        cp._RecordFunctionFast = fast_range

        def cuda_event(*a, **k):
            used["cuda_event"] += 1
            raise RuntimeError("a CUDA event with tracing off")
        torch.cuda.Event = cuda_event
    """) + MODEL_SRC + textwrap.dedent("""
        import rec_now_tpu_torch                      # noqa: F401
        from rec_now_tpu_torch.core import profiling
        scorer, state = make_scorer()
        for seed in (1, 2):
            scorer(state, *request(seed))
        spans = profiling.span_report()["spans"]
        print(json.dumps({
            "used": used, "dynamo": "torch._dynamo" in sys.modules,
            "profiler_on": torch.autograd._profiler_enabled(),
            "spans": {k: v["count"] for k, v in spans.items()}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["used"] == {"profile": 0, "record_function": 0, "range": 0,
                           "cuda_event": 0}
    assert got["dynamo"] is False and got["profiler_on"] is False
    # the one-time span alone: no request span was kept
    assert got["spans"] == {"serve.first_request": 1}


def _nested(outer: dict, inner: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_trace_nests_the_serving_spans_in_one_request(tmp_path):
    scorer, state = make_scorer()
    scorer(state, *request(0))
    t0 = time.perf_counter_ns()
    with profiling.trace(str(tmp_path / "tr")):
        scorer(state, *request(1))
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name") in SERVING]
    by = {e["name"]: e for e in events}
    assert sorted(by) == sorted(SERVING) and len(events) == len(SERVING)
    assert len({e["tid"] for e in events}) == 1
    for child in ("serve.to_device", "serve.lookup", "serve.model"):
        assert _nested(by["serve.request"], by[child])
    assert _nested(by["serve.model"], by["cin"])
    assert not _nested(by["serve.lookup"], by["cin"])

    recs = {r["name"]: r for r in profiling.records(t0)}
    assert sorted(recs) == sorted(SERVING)
    rid = recs["serve.request"]["request"]
    assert rid is not None
    assert {r["request"] for r in recs.values()} == {rid}
    assert recs["serve.request"]["parent"] is None
    for child in ("serve.to_device", "serve.lookup", "serve.model"):
        assert recs[child]["parent"] == recs["serve.request"]["id"]
    assert recs["cin"]["parent"] == recs["serve.model"]["id"]
    # a second request takes a new id
    t1 = time.perf_counter_ns()
    with profiling.trace(str(tmp_path / "tr2")):
        scorer(state, *request(2))
    (again,) = [r for r in profiling.records(t1)
                if r["name"] == "serve.request"]
    assert again["request"] not in (None, rid)


def test_span_report_window_self_and_top_time():
    def hold(ns):
        end = time.perf_counter_ns() + ns
        while time.perf_counter_ns() < end:
            pass

    profiling.enable()
    try:
        with profiling.span("report.a"):
            hold(10_000)
        t0 = time.perf_counter_ns()
        with profiling.span("report.a"):
            hold(20_000)
            with profiling.span("report.b"):
                hold(50_000)
            with profiling.span("report.b"):
                hold(30_000)
        t1 = time.perf_counter_ns()
        with profiling.span("report.a"):
            hold(10_000)
    finally:
        profiling.disable()
    recs = profiling.records(t0, t1)
    assert [r["name"] for r in recs] == ["report.b", "report.b", "report.a"]
    ms = [(r["end_ns"] - r["start_ns"]) / 1e6 for r in recs]
    rep = profiling.span_report(t0, t1)["spans"]
    assert set(rep) == {"report.a", "report.b"}
    a, b = rep["report.a"], rep["report.b"]
    assert a["count"] == 1 and b["count"] == 2
    assert a["host_ms"] == pytest.approx(ms[2])
    assert a["self_ms"] == pytest.approx(ms[2] - ms[0] - ms[1])
    assert a["top_ms"] == pytest.approx(ms[2])
    assert b["host_ms"] == pytest.approx(ms[0] + ms[1])
    assert b["self_ms"] == pytest.approx(b["host_ms"])
    assert b["top_ms"] == 0.0
    assert 0.02 < a["self_ms"] < a["host_ms"]
    # no device events on the CPU: no stream time
    assert "stream_ms" not in a and "stream_ms" not in b
    # a window that cuts a span leaves it out; an open end takes all
    cut = profiling.span_report(t0, recs[2]["end_ns"] - 1)["spans"]
    assert "report.a" not in cut and cut["report.b"]["count"] == 2
    assert profiling.span_report(t0)["spans"]["report.a"]["count"] == 2


class _FakeEvent:
    """A CUDA event's stand-in on a stream of ticks: ``record`` stamps the
    next tick; the stream has passed every tick up to ``passed``."""
    made = tick = passed = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.at = self.stream = None

    def record(self, stream):
        _FakeEvent.tick += 1
        self.at, self.stream = _FakeEvent.tick, stream

    def query(self):
        return self.at <= _FakeEvent.passed

    def synchronize(self):
        _FakeEvent.passed = max(_FakeEvent.passed, self.at)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return float(end.at - self.at)


def test_device_spans_read_their_events_and_reuse_them(monkeypatch):
    """A device span's events are read once the stream has passed them,
    at the next device span's end or in the report, and then reused."""
    import collections
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiling, "_current_stream", lambda: "stream")
    monkeypatch.setattr(profiling, "_free_events", [])
    monkeypatch.setattr(profiling, "_pending", collections.deque())
    _FakeEvent.made = _FakeEvent.tick = _FakeEvent.passed = 0
    t0 = time.perf_counter_ns()
    profiling.enable()
    try:
        with profiling.span("dev", device=True) as first:
            pass
        assert len(profiling._pending) == 1     # the stream is not there
        first_events = first.events
        _FakeEvent.passed = first_events[1].at
        with profiling.span("dev", device=True) as second:
            # the first pair is still pending when the second starts
            assert second.events is not first_events
        # the second's end read the first's pair and pooled it
        assert first.events is None and first.stream_ms == 1.0
        assert list(profiling._pending) == [second]
        with profiling.span("dev", device=True) as third:
            assert set(third.events) == set(first_events)
    finally:
        profiling.disable()
    assert _FakeEvent.made == 4 and first_events[0].stream == "stream"
    rep = profiling.span_report(t0)["spans"]["dev"]
    # the report waits for the rest: three spans of one tick each
    assert rep["count"] == 3 and rep["stream_ms"] == 3.0
    assert not profiling._pending and len(profiling._free_events) == 4


def test_ring_drops_its_oldest_spans():
    t0 = time.perf_counter_ns()
    profiling.enable()
    try:
        for _ in range(profiling.CAPACITY + 10):
            with profiling.span("ring"):
                pass
    finally:
        profiling.disable()
    recs = profiling.records(t0)
    assert len(recs) == profiling.CAPACITY
    ids = [r["id"] for r in recs]
    assert ids == list(range(ids[0], ids[0] + profiling.CAPACITY))
    rep = profiling.span_report(t0)["spans"]
    assert rep["ring"]["count"] == profiling.CAPACITY


def test_first_request_once_per_scorer_with_tracing_off():
    assert not torch.autograd._profiler_enabled()
    t0 = time.perf_counter_ns()
    for _ in range(2):
        scorer, state = make_scorer()
        for seed in range(3):
            scorer(state, *request(seed))
    rep = profiling.span_report(t0)["spans"]
    assert set(rep) == {"serve.first_request"}
    first = rep["serve.first_request"]
    assert first["count"] == 2 and first["top_ms"] == first["host_ms"] > 0
    assert "stream_ms" not in first


def test_loader_spans_and_build_counter(monkeypatch, tmp_path):
    """A library's load is ``kernels.load``, its nvcc run
    ``kernels.build`` inside it, counted in ``kernels.builds``, with
    tracing off; here the build fails for want of nvcc."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "_loaded", {})
    before = profiling.span_report(0, 0)["counters"].get("kernels.builds", 0)
    t0 = time.perf_counter_ns()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("cin")
    rep = profiling.span_report(t0)
    assert rep["counters"]["kernels.builds"] == before + 1
    load, build = rep["spans"]["kernels.load"], rep["spans"]["kernels.build"]
    assert load["count"] == build["count"] == 1
    assert load["top_ms"] == load["host_ms"] and build["top_ms"] == 0.0
    assert load["self_ms"] == pytest.approx(load["host_ms"]
                                            - build["host_ms"])


def test_annotate_is_a_span(tmp_path):
    calls = []

    @profiling.annotate("annotated.block")
    def block(x):
        calls.append(x)
        return x + 1

    t0 = time.perf_counter_ns()
    assert block(1) == 2
    assert profiling.records(t0) == []
    with profiling.trace(str(tmp_path / "tr")):
        assert block(2) == 3
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "annotated.block" for e in events)
    assert [r["name"] for r in profiling.records(t0)] == ["annotated.block"]
    assert calls == [1, 2] and block.__name__ == "block"
