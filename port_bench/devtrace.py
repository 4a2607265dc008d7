"""The traced stretch: ``torch.profiler`` over a steady part of the
window, its Chrome trace read back, and the trace reduced to what the
per-layer readers take.

* device activity: kernels, copies and memsets (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``) inside the stretch's annotation;
  busy time is the union of their intervals, so overlapping streams
  (the prefetcher's side-stream copies beside the compute stream) count
  once;
* idle gaps: the stretch minus that union, each labelled by the
  innermost host event open on the loop thread at the gap's middle;
* kernel time by name, the port's kernels (a file's anonymous
  namespace, :func:`port_wrapper`) attributed to their wrapper by the
  map in ``kernels/*.json``.

Only the annotation's interval counts: the stretch begins and ends with
a synchronize, so every device operation of its requests lies
inside it.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

STRETCH = "port_bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
ROOT = Path(__file__).resolve().parent


def kernel_map() -> Dict[str, str]:
    """Every ``kernels/*.json`` map of kernel name -> wrapper, merged."""
    out: Dict[str, str] = {}
    for path in sorted((ROOT / "kernels").glob("*.json")):
        out.update(json.loads(path.read_text())["kernels"])
    return out


ANON = "(anonymous namespace)::"


def base_name(name: str) -> str:
    """A demangled kernel name without return type, template arguments
    and parameters, its namespace kept: ``void (anonymous
    namespace)::k<int>(...)`` -> ``(anonymous namespace)::k``, ``void
    at::native::reduce_kernel<...>(...)`` -> ``at::native::reduce_kernel``."""
    name = name.strip()
    anon = name.startswith(ANON) or f" {ANON}" in name
    head = re.split(r"[<(]", name.replace(ANON, ""), maxsplit=1)[0].strip()
    head = head.split()[-1] if head else name
    return ANON + head if anon else head


def port_wrapper(name: str, kmap: Dict[str, str]) -> Optional[str]:
    """The wrapper of a kernel's base name: only a kernel of the
    port's own, which lives in a file's anonymous namespace at the top
    level (``(anonymous namespace)::k``), whose name is in the map; a
    library's kernel of the same name never matches."""
    if not name.startswith(ANON):
        return None
    return kmap.get(name[len(ANON):])


def union(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """[lo, hi) minus the merged ``busy`` intervals."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def label_points(events: List[dict], points: List[float]) -> List[str]:
    """For each time in ``points`` (sorted), the name of the innermost
    host event open there (the latest-starting one that covers it), or
    ``"host: python between ops"``."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    starts = [e["ts"] for e in evs]
    out = []
    stack: List[dict] = []
    i = 0
    for p in points:
        while i < len(evs) and starts[i] <= p:
            stack.append(evs[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < p:
            stack.pop()
        # an outer event may still cover p below an inner one that ended
        inner = next((e for e in reversed(stack)
                      if e["ts"] + e["dur"] >= p), None)
        out.append(inner["name"] if inner else "host: python between ops")
    return out


def reduce_trace(events: List[dict], loop_tid: Optional[int] = None,
                 kmap: Optional[Dict[str, str]] = None) -> dict:
    """A trace's events -> {window_s, busy_s, device_ops (count),
    kernel_s {name: s}, wrapper_s {wrapper: s}, unmapped {name: count},
    idle_by_host {label: s}, top_ops [(name, s)]}; None without the
    stretch's annotation."""
    kmap = kernel_map() if kmap is None else kmap
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("name") == STRETCH
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        return None
    lo = marks[0]["ts"]
    hi = lo + marks[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS
           and lo <= e["ts"] < hi]
    spans = [(e["ts"], min(e["ts"] + e["dur"], hi)) for e in dev]
    busy = union(spans)
    kernel_s: Dict[str, float] = {}
    for e in dev:
        name = base_name(e["name"]) if e["cat"] == "kernel" else e["name"]
        kernel_s[name] = kernel_s.get(name, 0.0) + e["dur"] * 1e-6
    wrapper_s: Dict[str, float] = {}
    unmapped: Dict[str, float] = {}
    for name, s in kernel_s.items():
        wrapper = port_wrapper(name, kmap)
        if wrapper is not None:
            wrapper_s[wrapper] = wrapper_s.get(wrapper, 0.0) + s
        else:
            unmapped[name] = unmapped.get(name, 0.0) + s
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != STRETCH
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    if loop_tid is not None:
        mine = [e for e in host if e.get("tid") == loop_tid]
        host = mine or host
    idle = gaps(busy, lo, hi)
    labels = label_points(host, [(a + b) / 2 for a, b in idle])
    idle_by: Dict[str, float] = {}
    for (a, b), lab in zip(idle, labels):
        idle_by[lab] = idle_by.get(lab, 0.0) + (b - a) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": len(dev), "kernel_s": kernel_s,
            "wrapper_s": wrapper_s, "unmapped": unmapped,
            "idle_by_host": idle_by,
            "top_ops": [[n[:160], s] for n, s in top],
            "top_idle": [[n[:160], s] for n, s in sorted(
                idle_by.items(), key=lambda kv: -kv[1])[:10]]}


def read_trace(prof) -> List[dict]:
    """A finished profiler's Chrome trace events, by way of a file under
    TMPDIR that is removed again."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data
