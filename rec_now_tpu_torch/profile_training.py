"""Where a training step's time goes on the card.

    python -m rec_now_tpu_torch.profile_training \
        [--model xdeepfm|multitask|dcnv2|fm|can_dcn]

Trains at full width (``FeatureConfig()``, random weights from a seed,
B = 8,192) either config 3 (``XDeepFMModel()``,
``TrainerConfig(pairwise_weight=1.0, click_occurance_power=-0.5)``) with
``cin_sum_channel=True`` and then ``False``, or config 4
(``MultiTaskModel()``, ``TrainerConfig(pointwise_weight=1.0,
listwise_weight=0.5, num_tasks=2)``), or config 2 (``DCNv2Model()`` with
lazy sparse Adam, :data:`CONFIG2`), or config 1 (``FMModel()``, the
CLI's defaults: pointwise loss, Adagrad rows), or config 5
(``CANDCNModel()``, :data:`CONFIG5`: its 100,000 x 272 CAN table beside
the main one, Adagrad on both): two warm-up steps and one
profiled and dropped, then 5 steps under ``torch.profiler``.
Prints, per run, the wall ms per step, the device's busy share of
that window (sum of kernel and copy times over wall time), the port's
kernel launches per step by the wrappers' counts (the row gather B11 and
the row scatter-add B12 among them), the device work by total time, and
the multi-expert dense's kernels summed (config 4).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rec_now_tpu_torch.models import (CANDCNModel, DCNv2Model,
                                      FeatureConfig, FMModel, MultiTaskModel,
                                      XDeepFMModel)
from rec_now_tpu_torch.profile_serving import (_device_us, launches_per,
                                               reset_launches)
from rec_now_tpu_torch.training import SyntheticCriteo, Trainer, TrainerConfig

STEPS, WARMUP, BATCH = 5, 2, 8192
# config 2's trainer, as __graft_entry__.py's "2:dcnv2+adam" sets it
CONFIG2 = TrainerConfig(pointwise_weight=1.0, pairwise_weight=0.5,
                        click_occurance_power=-0.5, sparse_optimizer="adam",
                        sparse_lr=1e-3)
# config 5's trainer (bench_all.py:132-135)
CONFIG5 = TrainerConfig(pointwise_weight=1.0, pairwise_weight=0.5,
                        can_param_field=8, can_dnn_dims=(16,))


def _runs(model: str, fc: FeatureConfig):
    """(label, model, trainer config) of each profiled run, built as it
    comes."""
    if model == "dcnv2":
        yield "dcnv2+adam", DCNv2Model(fc, seed=0), CONFIG2
        return
    if model == "can_dcn":
        yield "can_dcn", CANDCNModel(fc, seed=0), CONFIG5
        return
    if model == "fm":
        yield "fm", FMModel(fc, seed=0), TrainerConfig()
        return
    if model == "multitask":
        yield ("multitask", MultiTaskModel(fc, seed=0),
               TrainerConfig(pointwise_weight=1.0, listwise_weight=0.5,
                             num_tasks=2))
        return
    cfg = TrainerConfig(pairwise_weight=1.0, click_occurance_power=-0.5)
    for sc in (True, False):
        yield (f"cin_sum_channel={sc}",
               XDeepFMModel(fc, cin_sum_channel=sc, seed=0), cfg)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="xdeepfm",
                    choices=("xdeepfm", "multitask", "dcnv2", "fm",
                             "can_dcn"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    fc = FeatureConfig()
    batches = list(SyntheticCriteo(seed=0).batches(BATCH, WARMUP + STEPS,
                                                   seed=5))
    for label, model, cfg in _runs(args.model, fc):
        trainer = Trainer(model, fc, cfg)
        state = trainer.init(torch.Generator().manual_seed(1))
        for b in batches[:WARMUP]:
            state, _ = trainer.train_step(state, *trainer.put(b))
        # the first profiled window of a process also pays the tracer's
        # start-up: profile one warm-up step and drop it
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            state, _ = trainer.train_step(state, *trainer.put(batches[0]))
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[WARMUP:]:
                state, _ = trainer.train_step(state, *trainer.put(b))
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
        print(f"{label}: {wall_us / STEPS / 1e3:.3f} "
              f"ms/step (profiled, B={BATCH}), device busy "
              f"{busy / STEPS / 1e3:.3f} ms/step = {busy / wall_us:.1%} of "
              f"wall, {sum(e.count for e in events) // STEPS} device "
              f"launches/step [{card}]")
        print(f"  port kernels per step: {launches_per(STEPS)}")
        for e in sorted(events, key=_device_us, reverse=True)[:16]:
            print(f"  {_device_us(e) / STEPS / 1e3:8.4f} ms/step "
                  f"x{e.count // STEPS:<3d} {e.key[:90]}")
        md = [e for e in events if "multi_dense" in e.key]
        if md:
            print(f"  multi_dense's kernels: "
                  f"{sum(_device_us(e) for e in md) / STEPS / 1e3:.4f} "
                  f"ms/step over {sum(e.count for e in md) // STEPS} "
                  f"launches")
        del trainer, state, model


if __name__ == "__main__":
    main()
