"""Spans, counters, profiling and numerical-guard utilities.

Counterpart of ``rec_now_tpu/core/profiling.py`` on ``torch.profiler``,
with the port's own spans:

* :func:`span` -- a named interval of the program's work, kept in memory
  while tracing is on;
* :func:`enable` / :func:`disable` -- tracing on and off by hand (it is
  also on while a ``torch.profiler`` records);
* :func:`span_report` -- count, host time, self time and stream time of
  each span name in a window of time, with the counters;
* :func:`records` -- the kept spans themselves, with their parents and
  request ids;
* :func:`count` -- a named integer total;
* :func:`trace` -- a profiler trace of a block, written into a directory
  as a Chrome trace (open it in Perfetto or ``chrome://tracing``);
* :func:`annotate` -- a decorator whose calls are spans, so they show as
  a named range in such a trace;
* :func:`guard_finite` -- a NaN / Inf check that prints the JAX
  message;
* :func:`device_memory_stats` -- bytes in use, their peak and the
  device's limit, under the JAX keys.

**Tracing off**, a span costs one test of whether tracing is on: no
profiler range, no CUDA event, no clock read, nothing kept.  **Tracing
on** (after :func:`enable`, or while a ``torch.profiler`` records), a
span keeps its name, start and end (``time.perf_counter_ns``), its
parent span and the request it belongs to, in a ring of the last
:data:`CAPACITY` spans of the process; while a profiler records it also
opens a range of its name, which lands in the profiler's trace on the
clock of the device's kernels.  A span with ``device=True`` records a
pair of CUDA events on the current stream around its work, whose
stream milliseconds are read once the stream has passed them (at the
next such span's end, or in :func:`span_report`), and the events
reused.  A one-time set-up span (``always=True``) is
kept with tracing off too, with its host time only.

The spans and counters of the port:

====================  ============================================  ===========
name                  where                                         kept
====================  ============================================  ===========
serve.request         ``serving.build_scorer``'s scorer, the whole  tracing on
                      call; it starts a new request id
serve.to_device       the scorer's copies of the request's arrays   tracing on
serve.lookup          ``serving._forward``: global ids and the      tracing on
                      table's lookup (B11, or ``gather_pool_rows``
                      for multi-hot ids), and a CAN lookup
serve.model           ``serving._forward``: the model's forward     tracing on
cin                   ``layers/cin_layer.py`` ``CINLayer.forward``  tracing on
                      (layout copies, concatenation, B2's
                      launches); stream time on CUDA
cross                 ``models/dlrm_dcnv2_model.py``                tracing on
                      ``DLRMDCNv2Model.forward``: the low-rank
                      cross stack; stream time on CUDA
over                  ``models/dlrm_dcnv2_model.py``                tracing on
                      ``DLRMDCNv2Model.forward``: the over arch's
                      MLP (B8's wgmma launches when served);
                      stream time on CUDA
serve.first_request   the first call of each ``build_scorer``       always
                      scorer: lazy library loads, CUDA's lazy
                      module loading, the first allocations
kernels.load          ``ops/_build.load``: a library's hash, its    always
                      build if stale, its ``dlopen``
kernels.build         ``ops/_build``: an nvcc run (in               always
                      ``build_all``, all of its runs at once)
kernels.builds        counter: nvcc runs                            always
multi_dense.wgmma     counters: B8's launches by kernel             always
multi_dense.mma       (``ops/multi_dense_kernel.py``): ``.wgmma``
multi_dense.tc        ``linear_wg``'s, ``.mma`` every bank call's,
multi_dense.gate      then ``.tc`` (either tensor-core design of
multi_dense.tc_wgmma  the banks) or ``.gate``; ``.tc_wgmma`` the
                      banks' ``wgmma`` design, ``.tc`` too
====================  ============================================  ===========

Example (an operator's look at a serving process)::

    from rec_now_tpu_torch.core import profiling
    t0 = time.perf_counter_ns()
    profiling.enable()
    for dense, ids in requests:
        scorer(state, dense, ids).cpu()
    profiling.disable()
    rep = profiling.span_report(t0)
    per = rep["spans"]["serve.request"]["host_ms"] / \\
        rep["spans"]["serve.request"]["count"]

The spans are one record of the process, as a logger is: every caller
shares the ring and the counters.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Union

import torch

try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:            # a torch without the fast range
    _Range = torch.profiler.record_function

CAPACITY = 65_536               # spans kept; the oldest are dropped

_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_on = False
_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []     # this thread's open spans


_local = _Local()
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_free_events: List = []           # CUDA events to reuse
_pending: collections.deque = collections.deque()  # device spans unread
_streams: Dict[tuple, "torch.cuda.Stream"] = {}
_counters: Dict[str, int] = {}
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


def enable() -> None:
    """Keep spans from now on (until :func:`disable`), profiler or not."""
    global _on
    _on = True


def disable() -> None:
    """Stop keeping spans, except while a profiler records."""
    global _on
    _on = False


def span(name: str, device: bool = False, request: bool = False,
         always: bool = False):
    """A context manager: the block is a span ``name``, kept while
    tracing is on (always with ``always``, host time only when tracing
    is off).  ``device``: also a CUDA event pair on the current stream
    around the block (the caller's work is on CUDA).  ``request``: the
    span starts a new request id, which the spans inside it share."""
    ranged = _profiler_enabled()
    if _on or ranged:
        return _Span(name, device, request, ranged)
    if always:
        return _Span(name, False, request, False)
    return _OFF


class _Span:
    __slots__ = ("name", "device", "request", "ranged", "id", "parent",
                 "rid", "start", "end", "child_ns", "events", "stream",
                 "stream_ms", "range")

    def __init__(self, name: str, device: bool, request: bool,
                 ranged: bool):
        self.name, self.device, self.request = name, device, request
        self.ranged = ranged
        self.child_ns = 0
        self.events = self.stream_ms = self.range = None

    def __enter__(self):
        stack = _local.stack
        parent = stack[-1] if stack else None
        self.parent = parent
        self.id = next(_span_ids)
        self.rid = (next(_request_ids) if self.request
                    else parent.rid if parent is not None else None)
        stack.append(self)
        if self.ranged:
            self.range = _Range(self.name)
            self.range.__enter__()
        if self.device:
            self.stream = _current_stream()
            self.events = _take_events()
            self.events[0].record(self.stream)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record(self.stream)
        self.end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end - self.start
        with _lock:
            _ring.append(self)
            if self.events is not None:
                # the device is still at work on this span: read the
                # earlier spans' events now, off the request's critical
                # path, so the next span reuses them
                _read_events(wait=False)
                _pending.append(self)
        return False


def _current_stream():
    """The current CUDA stream, its ``Stream`` object kept by device and
    raw handle: ``torch.cuda.current_stream`` builds a new one each call,
    which costs more than the event's record."""
    dev = torch.cuda.current_device()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(dev)
    return stream


def _take_events():
    with _lock:
        if len(_free_events) >= 2:
            return _free_events.pop(), _free_events.pop()
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _read_events(wait: bool) -> None:
    """Read the stream milliseconds of the pending device spans, oldest
    first, and return their events to the pool; without ``wait``, stop
    at the first whose end the stream has not reached.  Call under
    ``_lock``."""
    while _pending:
        s = _pending[0]
        if wait:
            s.events[1].synchronize()
        elif not s.events[1].query():
            return
        s.stream_ms = s.events[0].elapsed_time(s.events[1])
        _free_events.extend(s.events)
        s.events = None
        _pending.popleft()


def _window(t0_ns: Optional[int], t1_ns: Optional[int]) -> list:
    """The kept spans that start at or after ``t0_ns`` and end at or
    before ``t1_ns`` (either None: unbounded); call under ``_lock``."""
    return [s for s in _ring
            if (t0_ns is None or s.start >= t0_ns)
            and (t1_ns is None or s.end <= t1_ns)]


def span_report(t0_ns: Optional[int] = None,
                t1_ns: Optional[int] = None) -> dict:
    """What the spans of a window say, on the ``time.perf_counter_ns``
    clock (a span counts where it starts at or after ``t0_ns`` and ends
    at or before ``t1_ns``; None leaves that end open).  Waits for the
    device events of those spans.

    Returns ``{"spans": {name: {"count", "host_ms", "self_ms",
    "top_ms"[, "stream_ms"]}}, "counters": {name: total}}``: ``host_ms``
    the spans' summed durations, ``self_ms`` that less the durations of
    their child spans, ``top_ms`` the durations of those opened inside
    no other span, ``stream_ms`` the stream's milliseconds between each
    span's event pair (spans with ``device`` on CUDA only)."""
    out: Dict[str, dict] = {}
    with _lock:
        _read_events(wait=True)
        for s in _window(t0_ns, t1_ns):
            dur = (s.end - s.start) / 1e6
            r = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                        "self_ms": 0.0, "top_ms": 0.0})
            r["count"] += 1
            r["host_ms"] += dur
            r["self_ms"] += dur - s.child_ns / 1e6
            if s.parent is None:
                r["top_ms"] += dur
            if s.stream_ms is not None:
                r["stream_ms"] = r.get("stream_ms", 0.0) + s.stream_ms
        counters = dict(_counters)
    return {"spans": out, "counters": counters}


def records(t0_ns: Optional[int] = None,
            t1_ns: Optional[int] = None) -> List[dict]:
    """The kept spans of a window (as :func:`span_report` selects them),
    oldest first: ``{"id", "name", "parent" (its id or None), "request"
    (id or None), "start_ns", "end_ns"}``."""
    with _lock:
        return [{"id": s.id, "name": s.name,
                 "parent": None if s.parent is None else s.parent.id,
                 "request": s.rid, "start_ns": s.start, "end_ns": s.end}
                for s in _window(t0_ns, t1_ns)]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (kept whether tracing is on or
    not)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (the host, and the card when CUDA is available)
    and write ``trace_<ns>.json`` into ``log_dir``.  The profiler turns
    spans on for the block: they show as ranges in the trace and are
    kept for :func:`span_report`.

    Example:
        with trace("/tmp/trace"):
            state, _ = trainer.train_step(state, *trainer.put(batch))
            torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """Decorator: each call runs inside ``span(name)``, a named range in
    a profiler trace; nothing with tracing off."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def guard_finite(x: torch.Tensor, name: str = "tensor",
                 enabled: bool = True) -> torch.Tensor:
    """Print ``[guard_finite] non-finite values in <name> min=... max=...``
    (min and max over the values that are not NaN) when ``x`` holds a NaN
    or an Inf; returns ``x`` unchanged, and is an identity when disabled.

    Unlike JAX's, which prints from the device and does not wait on the
    happy path, this check reads one flag on the host: on the card it
    waits for ``x``.
    """
    if not enabled:
        return x
    if not bool(torch.isfinite(x).all()):
        vals = x.detach()[~torch.isnan(x.detach())]
        mn, mx = ((vals.min().item(), vals.max().item()) if vals.numel()
                  else (float("nan"), float("nan")))
        print(f"[guard_finite] non-finite values in {name} "
              f"min={mn} max={mx}")
    return x


def device_memory_stats(device: Optional[Union[str, torch.device]] = None
                        ) -> dict:
    """Bytes in use, their peak and the device's limit (HBM telemetry):
    ``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}``, -1 where
    the device keeps no such count (the CPU).  ``device`` defaults to the
    current CUDA device, or the CPU without one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {"bytes_in_use": -1, "peak_bytes_in_use": -1,
                "bytes_limit": -1}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }
