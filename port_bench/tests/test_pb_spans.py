"""The readers of the program's spans (``metrics/request_host_ms.serve.py``,
``cin_host_ms.serve.py``, ``cin_stream_ms.serve.py``,
``program_setup_s.py``) on hand-made span reports, on none, and in a
traced run of the small cell (on the CPU without stream time; on the
card all four)."""
import json

import pytest

import harness
from conftest import CELL, small_cell

READERS = ("request_host_ms.serve", "cin_host_ms.serve",
           "cin_stream_ms.serve", "program_setup_s")
# a stretch of 2 s from t0 = 100 s on the host's perf_counter
CTX = {"t0": 100.0, "wall_s": 2.0}


def _read(name, ctx=CTX):
    return harness.metric_reader(name).read(ctx)


def _report(spans):
    def span_report(t0_ns=None, t1_ns=None):
        _report.windows.append((t0_ns, t1_ns))
        return {"spans": spans, "counters": {"kernels.builds": 0}}
    _report.windows = []
    return span_report


def _span(count, host_ms, top_ms=0.0, **more):
    return dict(count=count, host_ms=host_ms, self_ms=host_ms,
                top_ms=top_ms, **more)


@pytest.fixture
def profiling():
    from rec_now_tpu_torch.core import profiling
    return profiling


def test_pb_span_readers(monkeypatch, profiling):
    spans = {"serve.request": _span(4, 10.0, top_ms=10.0),
             "cin": _span(4, 2.0, stream_ms=16.0),
             "serve.first_request": _span(1, 900.0, top_ms=900.0),
             "kernels.load": _span(3, 400.0, top_ms=100.0),
             "kernels.build": _span(1, 50.0)}
    monkeypatch.setattr(profiling, "span_report", _report(spans))
    assert _read("request_host_ms.serve") == pytest.approx(2.5)
    assert _read("cin_host_ms.serve") == pytest.approx(0.5)
    assert _read("cin_stream_ms.serve") == pytest.approx(4.0)
    # the request readers ask for the stretch in perf_counter ns; the
    # set-up reader for the whole process
    assert _report.windows[:3] == [(100_000_000_000, 102_000_000_000)] * 3
    # the first request, and the loads opened outside any span
    assert _read("program_setup_s") == pytest.approx(1.0)
    assert _report.windows[3] == (None, None)


def test_pb_span_readers_find_nothing(monkeypatch, profiling):
    # no spans kept, and no stream time on the CPU
    monkeypatch.setattr(profiling, "span_report", _report({}))
    for name in READERS:
        assert _read(name) is None
    monkeypatch.setattr(profiling, "span_report", _report(
        {"serve.request": _span(2, 3.0), "cin": _span(2, 1.0)}))
    assert _read("cin_stream_ms.serve") is None
    assert _read("cin_host_ms.serve") == pytest.approx(0.5)
    # no requests in the stretch, or no stretch
    monkeypatch.setattr(profiling, "span_report", _report(
        {"cin": _span(2, 1.0, stream_ms=4.0)}))
    for name in READERS[:3]:
        assert _read(name) is None
        assert _read(name, {"trace": None}) is None
    # a program without spans (the parent of the spans' change)
    monkeypatch.delattr(profiling, "span_report")
    for name in READERS:
        assert _read(name) is None


def _traced_line(capsys, device):
    import run
    cell = small_cell(CELL, trace=True, device=device)
    out = cell.driver().run(cell)
    assert run.emit(cell, out, True) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_pb_traced_cell_reads_the_spans(capsys):
    line = _traced_line(capsys, "cpu")
    got = line["metrics"]
    for name in ("request_host_ms.serve", "cin_host_ms.serve",
                 "program_setup_s"):
        assert got[name]["value"] > 0
    assert got["cin_host_ms.serve"]["value"] < \
        got["request_host_ms.serve"]["value"]
    assert "cin_stream_ms.serve" not in got


@pytest.mark.cuda
def test_pb_traced_cell_prints_the_span_metrics(capsys, cuda_device):
    line = _traced_line(capsys, cuda_device)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(READERS) <= set(got)
    assert all(got[name] > 0 for name in READERS)
    assert got["cin_host_ms.serve"] < got["request_host_ms.serve"]
