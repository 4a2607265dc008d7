"""Host cost of a kernel launch through the port's wrappers.

    python -m rec_now_tpu_torch.profile_launch

Times the host path of the multi-expert dense (B8, ``multi_dense_fused``),
the row gather (B11, ``gather_rows``) and the row scatter-add (B12,
``scatter_add_rows``) wrappers, and of the one PyTorch call that computes
each function (``torch.baddbmm``, ``torch.index_select``,
``Tensor.index_add_``), and of the CIN layer's backward (B5,
``cin_flat_bwd``: three kernel launches, no single PyTorch call to set
beside it).  ``time.perf_counter`` over 10,000 calls of each
at a tiny size, in 5 interleaved rounds of 2,000 after 200 warm-up calls,
with no synchronisation inside a round, so each call's time is what the
host spends to check its inputs and enqueue its kernel (the card finishes
each in a few microseconds and keeps up).  The host's clock moves with its
other load, so each call is read as the median of its rounds.  Prints
microseconds per call beside the card's name and power limit.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Callable, Dict

import torch

from rec_now_tpu_torch.ops import cin_kernel as ck
from rec_now_tpu_torch.ops import expand_kernel as ek
from rec_now_tpu_torch.ops import gather_kernel as gk
from rec_now_tpu_torch.ops import multi_dense_kernel as mk

ROUNDS, CALLS, WARMUP = 5, 2_000, 200


def host_us(fn: Callable[[], object], calls: int) -> float:
    """Host microseconds per ``fn()`` over ``calls`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def median_host_us(calls_of: Dict[str, Callable[[], object]],
                   rounds: int = ROUNDS,
                   calls: int = CALLS) -> Dict[str, float]:
    """Host microseconds per call of each ``calls_of`` entry: the median
    of ``rounds`` interleaved rounds of ``calls`` calls each."""
    for fn in calls_of.values():
        for _ in range(WARMUP):
            fn()
    times = {name: [] for name in calls_of}
    for _ in range(rounds):
        for name, fn in calls_of.items():
            times[name].append(host_us(fn, calls))
    return {name: statistics.median(t) for name, t in times.items()}


def _tiny(dev: torch.device):
    gen = torch.Generator().manual_seed(0)
    return dict(table=torch.randn(64, 16, generator=gen).to(dev),
                ids=torch.randint(0, 64, (32,), generator=gen).to(dev),
                vals=torch.randn(32, 16, generator=gen).to(dev),
                x=torch.randn(1, 8, 16, generator=gen).to(dev),
                w=torch.randn(2, 16, 4, generator=gen).to(dev),
                bias=torch.randn(2, 1, 4, generator=gen).to(dev),
                x0=torch.randn(8, 4, generator=gen).to(dev),
                prev=torch.randn(8, 3, generator=gen).to(dev),
                wc=torch.randn(2, 4, 3, generator=gen).to(dev),
                g=torch.randn(8, 2, generator=gen).to(dev))


def wrapper_host_us() -> Dict[str, float]:
    """Host microseconds per call of each wrapper and its library call, at
    a tiny size on ``cuda:0``."""
    t = _tiny(torch.device("cuda", 0))
    table, ids, vals = t["table"], t["ids"], t["vals"]
    x, w, bias = t["x"], t["w"], t["bias"]
    xe = x.expand(2, 8, 16)
    x0, prev, wc, g = t["x0"], t["prev"], t["wc"], t["g"]
    return median_host_us({
        "multi_dense_fused": lambda: mk.multi_dense_fused(x, w, bias, False),
        "torch.baddbmm": lambda: torch.baddbmm(bias, xe, w),
        "gather_rows": lambda: gk.gather_rows(table, ids),
        "torch.index_select": lambda: torch.index_select(table, 0, ids),
        "scatter_add_rows": lambda: ek.scatter_add_rows(table, ids, vals),
        "Tensor.index_add_": lambda: table.index_add_(0, ids, vals),
        "cin_flat_bwd": lambda: ck.cin_flat_bwd(x0, prev, wc, g)})


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_launch needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for name, us in wrapper_host_us().items():
        print(f"{name}: {us:.3f} us/call on the host [{card}]")


if __name__ == "__main__":
    main()
