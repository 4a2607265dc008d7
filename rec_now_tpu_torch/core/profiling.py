"""Profiling and numerical-guard utilities.

Counterpart of ``rec_now_tpu/core/profiling.py`` on ``torch.profiler``:

* :func:`trace` -- a profiler trace of a block, written into a directory
  as a Chrome trace (open it in Perfetto or ``chrome://tracing``);
* :func:`annotate` -- a decorator whose calls show as a named range in
  such a trace;
* :func:`guard_finite` -- a NaN / Inf check that prints the JAX
  message;
* :func:`device_memory_stats` -- bytes in use, their peak and the
  device's limit, under the JAX keys.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterator, Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (the host, and the card when CUDA is available)
    and write ``trace_<ns>.json`` into ``log_dir``.

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
    """Decorator: each call runs inside ``record_function(name)``, a
    named range in a profiler trace."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
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
