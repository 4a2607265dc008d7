"""What the traffic drivers share under ``--trace 1``: the profiler's
start-up paid in set-up, and the profiled stretch."""
from __future__ import annotations

import threading
import time

import harness

# room cached before the stretch, in the allocator's large and small
# pools (blocks of 1 MiB and less come from 2 MiB segments of their own)
RESERVE_BYTES = 4 << 30
SMALL_RESERVE_BLOCKS = 1024


def profiler_warmup(torch, cuda: bool) -> None:
    """The first profiler of a process pays the tracer's start-up: one
    short one in set-up, dropped."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        x = torch.ones(8, device="cuda" if cuda else "cpu")
        (x + 1).sum().item()


def profiled(cell, run, seconds: float) -> dict:
    """``run(seconds, spans)`` (which ends in a synchronize and returns
    (count, wall seconds)) under the profiler, inside the stretch's
    annotation after a synchronize, with the kernel-call recorder on;
    -> {count, wall_s, t0, trace, bound_s}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace
    cuda = torch.device(cell.device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    recorder = harness.CallRecorder()
    if cuda:
        # the recorder holds each call's ids until the stretch ends: room
        # cached beforehand keeps their allocations off cudaMalloc, a
        # request's ids of 1 MiB or less (B = 1,024) in the small pool
        torch.empty(RESERVE_BYTES, dtype=torch.uint8, device="cuda")
        blocks = [torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
                  for _ in range(SMALL_RESERVE_BLOCKS)]
        del blocks
    with profile(activities=acts) as prof:
        with record_function(devtrace.STRETCH):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorder:
                count, wall = run(seconds, record_function)
    events = devtrace.read_trace(prof)
    return {"count": count, "wall_s": wall, "t0": t0,
            "trace": devtrace.reduce_trace(events, threading.get_native_id()),
            "bound_s": recorder.bound_s()}
