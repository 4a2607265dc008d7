"""Where a serving request's time goes on the card.

    python -m rec_now_tpu_torch.profile_serving

Builds full-width xDeepFM (``FeatureConfig()``, ``XDeepFMModel()``, random
weights from a seed), warms up, then scores 5 requests of B = 8,192 per
front end (raw, u8 wire, f16 wire) under ``torch.profiler``.  Prints, per
front end, the wall ms per request, the device's busy share of that window
(sum of kernel times over wall time) and the kernels by total device time.
Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.models import FeatureConfig, XDeepFMModel
from rec_now_tpu_torch.serving import ServingState, WireScorer, build_scorer
from rec_now_tpu_torch.training.data import SyntheticCriteo

REQUESTS, BATCH = 5, 8192


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    fc = FeatureConfig()
    model = XDeepFMModel(fc, seed=0)
    table = EmbeddingTable(fc.total_rows, fc.embedding_dim)
    state = ServingState(dict(model.named_parameters()),
                         table.init(torch.Generator().manual_seed(1)))
    data = SyntheticCriteo(seed=0)
    reqs = list(data.batches(BATCH, REQUESTS + 1, seed=1))
    fronts = {"raw": build_scorer(model, fc, table),
              "u8": WireScorer(model, fc, table, "u8"),
              "f16": WireScorer(model, fc, table, "f16")}
    for name, fn in fronts.items():
        fn(state, reqs[0].dense, reqs[0].sparse_ids)         # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in reqs[1:]:
                fn(state, b.dense, b.sparse_ids)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernels and copies on the card (the CPU ops that launched them
        # carry the same time again)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(_device_us(e) for e in events)
        n = len(reqs) - 1
        print(f"{name}: {wall_us / n / 1e3:.3f} ms/request (profiled, "
              f"B={BATCH}), device busy {busy / n / 1e3:.3f} ms/request"
              f" = {busy / wall_us:.1%} of wall [{card}]")
        for e in sorted(events, key=_device_us, reverse=True)[:12]:
            print(f"  {_device_us(e) / n / 1e3:8.4f} ms/request "
                  f"x{e.count // n:<3d} {e.key[:90]}")


if __name__ == "__main__":
    main()
