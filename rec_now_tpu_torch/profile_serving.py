"""Where a serving request's time goes on the card.

    python -m rec_now_tpu_torch.profile_serving \
        [--model xdeepfm|multitask|dcnv2|fm|can_dcn]

Builds a full-width model (``FeatureConfig()``; ``XDeepFMModel()``,
config 3, ``MultiTaskModel()``, config 4, ``DCNv2Model()``, config 2, or
``FMModel()``, config 1, or ``CANDCNModel()``, config 5, with its
100,000 x 272 CAN table looked up by field 8; random weights and tables
from a seed), warms up, then
scores 5 requests of B = 8,192 per front end (raw, u8 wire, f16 wire)
under ``torch.profiler``.  Prints, per front end, the wall ms per request,
the device's busy share of that window (sum of kernel times over wall
time), the port's kernel launches per request by the wrappers' counts
(the row gather B11 among them), the device work by total time, and the
multi-expert dense's kernels summed (config 4).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.models import (CANDCNModel, DCNv2Model,
                                      FeatureConfig, FMModel, MultiTaskModel,
                                      XDeepFMModel)
from rec_now_tpu_torch.ops import cin_kernel as ck
from rec_now_tpu_torch.ops import expand_kernel as ek
from rec_now_tpu_torch.ops import gather_kernel as gk
from rec_now_tpu_torch.ops import listwise_kernel as lk
from rec_now_tpu_torch.ops import multi_dense_kernel as mk
from rec_now_tpu_torch.ops import pairwise_kernel as pk
from rec_now_tpu_torch.ops import table_update_kernel as tk
from rec_now_tpu_torch.serving import ServingState, WireScorer, build_scorer
from rec_now_tpu_torch.training.data import SyntheticCriteo

REQUESTS, BATCH = 5, 8192
MODELS = {"xdeepfm": XDeepFMModel, "multitask": MultiTaskModel,
          "dcnv2": DCNv2Model, "fm": FMModel, "can_dcn": CANDCNModel}
# config 5's CAN table: looked up by this field (bench_all.py:132-135)
CAN_FIELD = 8
# the port's kernel wrappers, each counting its launches
WRAPPERS = (ck.cin_stack_sum, ck.cin_flat, ck.cin_stack_sum_bwd,
            ck.cin_flat_bwd, pk.pair_loss_sum, pk.pair_row_counts,
            pk.same_group_matvec, pk.group_pair_counts_binary,
            lk.listwise_loss_sum, mk.multi_dense_fused, mk.linear_wg,
            tk.adagrad_dense_pass, tk.adam_dense_pass, gk.gather_rows,
            ek.scatter_add_rows)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launches_per(units: int) -> str:
    """The wrappers' launch counts since :func:`reset_launches`, per
    unit, of the kernels that launched."""
    return ", ".join(f"{fn.__name__} {fn.launches / units:g}"
                     for fn in WRAPPERS if fn.launches)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="xdeepfm")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    fc = FeatureConfig()
    model = MODELS[args.model](fc, seed=0)
    table = EmbeddingTable(fc.total_rows, fc.embedding_dim)
    gen = torch.Generator().manual_seed(1)
    state = ServingState(dict(model.named_parameters()), table.init(gen))
    can = {}
    if args.model == "can_dcn":
        can_table = EmbeddingTable(
            fc.rows_per_field,
            CANDCNModel.can_param_size(fc.embedding_dim, (16,)),
            initializer_scale=0.05)
        state = state._replace(can_table=can_table.init(gen))
        can = dict(can_table=can_table, can_param_field=CAN_FIELD)
    data = SyntheticCriteo(seed=0)
    reqs = list(data.batches(BATCH, REQUESTS + 1, seed=1))
    fronts = {"raw": build_scorer(model, fc, table, **can),
              "u8": WireScorer(model, fc, table, "u8", **can),
              "f16": WireScorer(model, fc, table, "f16", **can)}
    for name, fn in fronts.items():
        fn(state, reqs[0].dense, reqs[0].sparse_ids)         # warm-up
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in reqs[1:]:
                fn(state, b.dense, b.sparse_ids)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernels and copies on the card (the CPU ops that launched them
        # carry the same time again; a user annotation's span on the card,
        # such as Optimizer.step's, covers kernels counted already and the
        # gaps between them)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        busy = sum(_device_us(e) for e in events)
        n = len(reqs) - 1
        print(f"{args.model} {name}: {wall_us / n / 1e3:.3f} ms/request (profiled, "
              f"B={BATCH}), device busy {busy / n / 1e3:.3f} ms/request"
              f" = {busy / wall_us:.1%} of wall [{card}]")
        print(f"  port kernels per request: {launches_per(n)}")
        for e in sorted(events, key=_device_us, reverse=True)[:12]:
            print(f"  {_device_us(e) / n / 1e3:8.4f} ms/request "
                  f"x{e.count // n:<3d} {e.key[:90]}")
        md = [e for e in events if "multi_dense" in e.key]
        if md:
            print(f"  multi_dense's kernels: "
                  f"{sum(_device_us(e) for e in md) / n / 1e3:.4f} "
                  f"ms/request over {sum(e.count for e in md) // n} launches")


if __name__ == "__main__":
    main()
