#!/usr/bin/env python3
"""Drive the PyTorch port (``rec_now_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which ends the script with a non-zero exit on failure:

1. print the card (``nvidia-smi`` name and power limit); f32 matmuls and
   convolutions in full f32 (TF32 off);
2. build the package's CUDA sources, one nvcc each, all at once (timed,
   with ptxas's register and spill report);
3. hold each kernel against its plain PyTorch version on the card at the
   xDeepFM config-3 shapes (B = 8192, D = 16, F = 26, CIN (64, 64);
   the pair loss on a ``SyntheticCriteo`` batch; the Adagrad pass over
   the 2.6M x 16 table), at config 4's (the multi-expert dense at its
   four distinct banks, B = 8192; the listwise loss on the same batch
   and on degenerate ones), at config 2's (lazy Adam over the 2.6M x 16
   table with the touched rows of a B = 8192 batch, t = 1 and 1000; the
   pair counts and the general pair loss on a B = 8192 batch with graded
   labels, two groups and a 0/1 mask), the row gather (B11, bit-exact)
   and the row scatter-add (B12, within 1e-6 of each output's summed
   scale) on the 2.6M x 16 table with a B = 8192 batch's 212,992 ids (the
   dense buffer, the sparse path's dedup and its sentinel-heavy
   write-backs, ragged, empty and out-of-range ids, vals off the 16-byte
   grid), and at ragged shapes and the multi-expert dense's dispatch
   edges (N * U = 16 and 17, a small per-expert bank, W too deep for the
   gate kernel, x off the 16-byte grid), and time kernel, plain version
   and, where one exists, a single PyTorch call computing the same
   function (CUDA events, median of 20; each multi-expert dense bank
   beside its bound on the unit that runs it: split TF32 on the tensor
   cores, or f32 for the gate kernel); the wrappers' host microseconds
   per launch (``rec_now_tpu_torch.profile_launch``); then time the
   table's dense and sparse update paths (the median of interleaved
   rounds), which sets ``auto``;
Phases 4-6 go through one table of runs, the port's paths: config 3
(xDeepFM: 26 x 100,000 x 16 table on the card, CIN (64, 64), deep
(256, 128), ``TrainerConfig(pairwise_weight=1.0,
click_occurance_power=-0.5)``) with the channel-summed CIN
(``cin_stack_sum``) and with ``cin_sum_channel=False`` (``cin_flat``),
config 4 (``MultiTaskModel()``, MMoE + PLE + STAR towers,
``TrainerConfig(pointwise_weight=1.0, listwise_weight=0.5,
num_tasks=2)``), then config 2 (``DCNv2Model()``, SENET + DCN-mix +
deep (256, 128), ``TrainerConfig(pointwise_weight=1.0,
pairwise_weight=0.5, click_occurance_power=-0.5,
sparse_optimizer="adam", sparse_lr=1e-3)``).  Each run names its model,
trainer config, loss keys, the launches it expects per request and per
step, and its own kernel checks.  Every serving or training loop sets all
fourteen launch counts to 0 just before it and reads them just after, and
fails unless each is exact (0 for a kernel the run does not name): every
request and step looks its rows up once (B11), every step scatters their
gradients once (B12).

4. serve each run at full width through ``build_scorer`` and
   ``WireScorer`` (u8, f16): logits of the expected shape ((B,), or
   (2, B) for config 4), finite, wire against raw; then the model's own
   check (xDeepFM: the CIN layer on the run's own embeddings against its
   plain version, relative to that output's scale, failing if it could
   not see any one layer -- the table's +-1e-3 rows make the CIN terms
   too small to show in the logits), and the card against the same model
   and table on the CPU through the plain versions;
5. each run's first training step (B = 2048, full-width model and table)
   on the card against the same step on the CPU: the losses, every
   gradient and every param after Adam, the touched rows and
   accumulators (under Adam: m, v and the count); then each kernel on that
   step's own tensors against its plain version, relative to that
   output's scale, failing unless each compared quantity is larger than
   its tolerance: the CIN backward's dx0 and dW of every layer, or the six
   multi-expert dense calls (each also with x off the 16-byte grid, and
   a shared input as one copy per expert); the ranking loss's dlogits
   (pair or
   listwise); the updated rows (and m, v); under Adam, the same step with
   ``sparse_update_mode="sparse"`` against the dense one;
6. train each run at full width (B = 8192): warm-up steps, then timed
   steps (host clock, each ending in ``torch.cuda.synchronize()``);
   every loss finite and > 0; the step is split into each kernel's time
   as phase 3 measured it (an estimate: ``profile_training`` gives the
   step's own device times);
7. the public ``pairwise_loss`` as an entry point at B = 8192 on the card
   against the CPU's (B, B) path (loss, pair count, dlogits): graded
   labels with two groups, a mask and power -0.5 (``pair_row_counts``,
   ``same_group_matvec``, ``pair_loss_sum`` once each), the same with the
   wrong-order filter, binary labels with one group and
   ``binary_labels=True`` (``pair_loss_sum`` alone); then
   ``group_pair_counts_binary`` once, against ``pair_row_counts`` ->
   ``same_group_matvec``;
8. the training entry point as users start it: ``main`` of
   ``rec_now_tpu_torch.train`` (what ``python -m
   rec_now_tpu_torch.train`` runs), in this process, at full width on
   the flagship setting (``bench.py:38-57``: config 2, B = 8192,
   pairwise 0.5 at power -0.5, u8 dense wire, windows of 5 steps), 60
   steps: first the CLI's first window, its C++ pack against the numpy
   pack (byte-equal), the windowed loop against put + train_step on the
   same batches (losses 1e-4 relative: atomics add in another order);
   then the CLI's two loops, with their prefetch
   threads, on batches drawn beforehand, and the windowed loop on windows
   placed beforehand, in turns (the loops' own cost; ms per step whole
   and from the first batch's arrival), and a
   checkpoint restored equal; then ``main`` four times: with device eval
   and checkpoints every 20 steps, again with exact eval (device AUC
   within 1e-3 of exact, GAUC 2e-3), stepwise (``--scan-window 0``), and
   FM (config 1) for 10 steps; each run's launches exact (each step's,
   and one row gather for each eval batch), its losses finite and > 0 and
   its final eval's auc and gauc finite; the CLI's last checkpoint
   evaluated again gives the CLI's eval; ms per step and examples/s of
   the windowed and the stepwise loop through the CLI, which draws each
   synthetic batch as it runs;
9. print one JSON line for the kernels, the card again, and finally
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, TF32
# on the tensor cores (dense), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# f32 kernel vs plain f32 einsum: the same products summed in another
# order over up to F * H = 1,664 terms per channel (and, for the weight
# gradients, over M = 131,072 rows in 1,024-row slices).
REL_TOL = 1e-4
# auto's dense/sparse limit is printed beside each run's crossing of the
# two timed paths, a measurement with no pass/fail line: the sparse path
# is ~30 launches whose time moves with the host, and over nine runs on
# the H100 it took 0.91-1.88 ms, its crossing with the dense path moving
# over 532-911 MiB (Adagrad) and 1,340-3,908 MiB (Adam).  Each path is
# read as the median of this many interleaved rounds
UPDATE_ROUNDS = 7
CIN_TPU = "rec_now_tpu/ops/pallas/cin_kernel.py"
PAIR_TPU = "rec_now_tpu/ops/pallas/pairwise_kernel.py"
TABLE_TPU = "rec_now_tpu/ops/pallas/table_update_kernel.py"
MD_TPU = "rec_now_tpu/ops/pallas/multi_dense_kernel.py"
LW_TPU = "rec_now_tpu/ops/pallas/listwise_kernel.py"
GATHER_TPU = "rec_now_tpu/ops/pallas/gather_kernel.py"
EXPAND_TPU = "rec_now_tpu/ops/pallas/expand_kernel.py"
# B12 against its plain version: atomics add a row's terms in no fixed
# order, so a sum differs by up to ~n eps of the terms' absolute sum (a
# hot row of a B = 8192 zipf batch takes ~2,000 adds)
SUM_TOL = 1e-6
# phase 8: the flagship training setting (bench.py:38-57) through the CLI
CLI_FLAGSHIP = ["--model", "dcnv2", "--batch-size", "8192",
                "--pairwise-weight", "0.5", "--occurance-power", "-0.5",
                "--wire-dense-mode", "u8", "--scan-window", "5"]
CLI_COMMON = ["--steps", "60", "--log-every", "5", "--eval-batches", "8"]
# the FM run's steps and eval batches
FM_STEPS, FM_EVAL = 10, 4
# steps of each in-process loop timing (after the first window)
LOOP_STEPS = 30
# config 4's six multi-expert dense launches per forward at B = 8192:
# (name, inputs' leading dim, experts, D, U, ReLU, launches); then, at
# 0 launches per forward (checked and timed, not summed), the dispatch
# edges of csrc/multi_dense.cu at the same B: a shared input with N * U =
# 16 (the gate kernel) and 17 (the split-TF32 tile), and the gate bank's
# shape as a per-expert input (the tile)
MD_BANKS = (("MMoE experts layer 0", 1, 4, 429, 128, True, 1),
            ("MMoE experts layer 1", 4, 4, 128, 64, False, 1),
            ("MMoE gates", 1, 2, 429, 4, False, 1),
            ("PLE experts", 1, 2, 128, 64, False, 3),
            ("edge: shared, N*U = 16", 1, 4, 429, 4, False, 0),
            ("edge: shared, N*U = 17", 1, 1, 429, 17, False, 0),
            ("edge: per-expert, N*U = 8", 2, 2, 429, 4, False, 0))
# launches that phase 3's "ms" of a kernel covers: one forward's
MS_COVERS = {"cin_flat": 2, "cin_flat_bwd": 2, "multi_dense": 6}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one ``fn()``: the kernels and copies it runs on the
    card, summed by ``torch.profiler`` over ``reps`` calls.  cuda_ms's
    events also time the host's launch path, which a kernel of a few
    microseconds does not hide."""
    return sum(profiled_by_name(torch, fn, reps).values())


def profiled_by_name(torch, fn, reps: int = 20) -> dict:
    """Device ms of one ``fn()`` by the name of each kernel or copy it
    runs on the card (``torch.profiler`` over ``reps`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            ms[e.key] = ms.get(e.key, 0.0) + float(
                getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)) / reps / 1e3
    return ms


def cin_flops(m: int, f: int, h: int, k: int, prev_is_x0: bool) -> int:
    """Least FLOPs of one CIN layer out[m,k] = sum_{f,h} W[k,f,h] x0[m,f]
    prev[m,h]: the products x0[f] prev[h] once per row, then one
    multiply-add per (k, product) -- or W first, whichever is less.  When
    prev is x0 the products are symmetric, F(F+1)/2 per row."""
    terms = f * (f + 1) // 2 if prev_is_x0 else f * h
    return min(m * terms + 2 * m * k * terms, 2 * m * k * f * (h + 1))


def cin_flat_bwd_flops(m: int, f: int, h: int, k: int,
                       prev_is_x0: bool) -> int:
    """Least FLOPs of one CIN layer's backward for g (M, K): dW forms the
    products x0[f] prev[h] once per row (F(F+1)/2 when prev is x0) and
    does one multiply-add per (channel, product); A[f, h] = sum_k g[k]
    W[k, f, h] one multiply-add per (channel, f, h); then dx0 = sum_h A
    prev and dprev = sum_f A x0, one multiply-add per (f, h) each."""
    terms = f * (f + 1) // 2 if prev_is_x0 else f * h
    return m * terms + 2 * m * k * terms + 2 * m * k * f * h + 4 * m * f * h


def cin_stack_bwd_flops(m: int, f: int, ks) -> int:
    """Least FLOPs of the stack's backward for g (M,): the non-last layers
    recomputed (cin_flops); the collapsed last layer, z = h_{n-1} Wc^T,
    dh_{n-1} = x0 Wc and dWc = (g x0)^T h_{n-1} at 2 M F H each plus the
    g scalings (3 M F + M H); then each non-last layer's backward after g
    is added to its hidden gradient (M K).  Layer 1's prev is x0 and the
    stack returns dx0 alone, so its two input terms merge:
    dx0 = (A + A^T) x0 with A = sum_k g W1 -- W1 + W1^T formed once per
    call (K F^2), A on the F(F+1)/2 symmetric pairs, then one multiply-add
    per (f, h); dW1 on the symmetric products.  Layers above it take
    cin_flat_bwd_flops."""
    hs = [f] + list(ks[:-1])
    mid = range(len(ks) - 1)
    sym = f * (f + 1) // 2

    def layer_bwd(i: int) -> int:
        if i:
            return cin_flat_bwd_flops(m, f, hs[i], ks[i], False)
        return (ks[0] * f * f + m * sym + 2 * m * ks[0] * sym
                + 2 * m * ks[0] * sym + 2 * m * f * f)

    return (sum(cin_flops(m, f, hs[i], ks[i], i == 0) for i in mid)
            + 6 * m * f * hs[-1] + 3 * m * f + m * hs[-1]
            + sum(layer_bwd(i) + m * ks[i] for i in mid))


def sort_ops(b: int, keys: int = 1) -> float:
    """Compares of a sort of b samples on ``keys`` keys: the least work
    that brings each group (or each (group, label) run) together, where
    the kernels test every (i, j) instead."""
    return keys * b * math.log2(max(b, 2))


def pair_ops(labels, groups) -> int:
    """Least operations of the fused pair loss on this batch: a sort by
    group, one pass over each group for the occurrence weight (pos and
    tot adds, pos * (tot - pos), its power, the row's weight: 5 a sample),
    and per valid pair the gap, softplus (exp, log1p, max, add), sigmoid
    (exp, add, divide) and four weighted sums: 12."""
    import numpy as np
    _, inv = np.unique(groups, return_inverse=True)
    tot = np.bincount(inv)
    pos = np.bincount(inv, weights=labels)
    b = len(labels)
    return int(sort_ops(b) + 5 * b + 12 * (pos * (tot - pos)).sum())


def multi_dense_work(nx: int, n: int, b: int, d: int, u: int):
    """(FLOPs, bytes) of one multi-expert dense launch: a multiply-add per
    (expert, row, d, unit), the bias add; x read once (a shared input
    once for all experts), W and bias read, the output written."""
    return (2 * n * b * d * u + n * b * u,
            (nx * b * d + n * d * u + n * u + n * b * u) * 4)


def listwise_ops(labels) -> int:
    """Least operations of the fused listwise loss on this batch: a sort
    by group; per sample, once in its group's softmax, the running max's
    compare, the exp, the exp-sum add, the label-sum add, the label *
    logit multiply-add and the two flag tests (7), its share of its
    group's log and loss (at most 1), and its gradient (the softmax's exp
    and divide, p's divide, the subtract: 4): 12."""
    b = len(labels)
    return int(sort_ops(b) + 12 * b)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(name: str, got, want, floor: float = 1.0,
            rel: float = REL_TOL) -> float:
    """Max |got - want|; fails above rel * max(floor, max|want|)."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    ok = got.shape == want.shape and err <= rel * max(scale, floor)
    print(f"  {name}: shape {tuple(got.shape)} max_abs_err {err:.3e} "
          f"max|plain| {scale:.3e} max_rel_err {err / max(scale, 1e-30):.3e}"
          f" (tol {rel:g} of max({floor:g}, max|plain|)) -> "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def compare_all(name: str, got, want) -> float:
    """compare() each output of a multi-output kernel at its own scale."""
    return max(compare(f"{name} [{i}]", a, b, floor=0.0)
               for i, (a, b) in enumerate(zip(got, want)))


def visible(name: str, part, scale: float, rel: float = REL_TOL) -> None:
    """Fail unless ``part`` moves the compared output by more than the
    tolerance (rel * scale), so that a kernel which got it wrong would be
    caught."""
    tol = rel * scale
    seen = float(part.abs().max())
    print(f"    {name}: max {seen:.3e} = {seen / max(tol, 1e-30):.1f} x tol")
    if seen <= tol:
        fail(f"the check cannot see {name}")


def compare_sum(name: str, got, want, scale: float,
                rel: float = SUM_TOL) -> float:
    """Max |got - want| of a scatter-add; fails above rel * scale, where
    scale is the largest |start| + sum |vals| an element adds up."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    ok = got.shape == want.shape and err <= rel * scale
    print(f"  {name}: shape {tuple(got.shape)} max_abs_err {err:.3e} "
          f"summed scale {scale:.3e} rel {err / max(scale, 1e-30):.3e} "
          f"(tol {rel:g}) -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def misaligned(t):
    """A copy of ``t`` whose storage starts 4 bytes off the 16-byte grid:
    the kernels' 4-byte paths."""
    import torch
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def check_gather_scatter(torch, kern, rand, ids8k, grads8k, vfull, gk, ek,
                         table_cls, dev, card) -> None:
    """B11 bit-exact and B12 within SUM_TOL of each output's summed scale
    against their plain versions, on the full-width table with a B = 8192
    batch's ids (the dense buffer, the sparse path's dedup and its
    sentinel-heavy write-backs), ragged, empty and out-of-range ids; then
    kernel, plain version and the library call timed."""
    n = ids8k.numel()
    tfull = rand(vfull, 16, scale=1e-3)
    sparse = table_cls(vfull, 16, device=dev, update_mode="sparse")
    rep, _, valid = sparse._dedup_rows(ids8k, grads8k)
    order = torch.argsort(ids8k, stable=True)
    sid = ids8k[order]
    seg = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool,
                                             device=dev),
                                  sid[1:] != sid[:-1]]), 0) - 1
    distinct = int(valid.sum())
    print(f"  a B=8192 batch: {n} ids, {distinct} distinct rows, "
          f"{n - distinct} sentinel segments (row V, dropped by B12)")
    wild = torch.tensor([-5, -1, 0, vfull - 1, vfull, vfull + 100, 2 ** 40],
                        device=dev)
    small = rand(777, 5)
    print("gather_rows vs plain (bit-exact):")
    g_cases = (("B=8192 batch", tfull, ids8k),
               ("ragged N=1500 int32", tfull, ids8k[:1500].int()),
               ("ids out of range (clamped)", tfull, wild),
               ("the sparse path's rows with sentinels", tfull, rep),
               ("D=5 scalar loop", small, ids8k[:333] % 800),
               ("B=8192 batch (B, F) shape", tfull, ids8k.reshape(-1, 26)))
    for what, table, ids in g_cases:
        got = gk.gather_rows(table, ids)
        want = gk.gather_rows_plain(table, ids)
        ok = got.shape == want.shape and torch.equal(got, want)
        # exact: the check sees any row that is not all zeros
        seen = float(got.abs().max())
        print(f"  {what}: shape {tuple(got.shape)} "
              f"{'equal' if ok else 'MISMATCH'}, max|row| {seen:.3e}")
        if not ok:
            fail(f"gather_rows {what} differs from its plain version")
        if not seen > 0:
            fail(f"the check cannot see gather_rows {what}")
    before = gk.gather_rows.launches
    if gk.gather_rows(tfull, ids8k[:0]).shape != (0, 16) or \
            gk.gather_rows.launches != before:
        fail("gather_rows of no ids launched or gave a wrong shape")
    # bytes this batch needs: its distinct rows read once, the (N, D)
    # rows written, the ids read; no arithmetic
    b_ms, b_by = bound_ms(0, distinct * 64 + n * 64 + n * 8)
    kern["gather_rows"] = dict(
        name="gather_rows", route="cuda",
        source="rec_now_tpu_torch/csrc/gather.cu",
        replaces=f"{GATHER_TPU}:136", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: gk.gather_rows(tfull, ids8k)),
        plain_ms=cuda_ms(torch, lambda: gk.gather_rows_plain(tfull, ids8k)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: torch.index_select(tfull, 0,
                                                             ids8k)))

    print(f"scatter_add_rows vs plain (tol {SUM_TOL:g} of each output's "
          f"summed scale):")
    vals = rand(n, 16, scale=1e-3)
    s_cases = (("dense buffer, B=8192 batch", torch.zeros_like(tfull), ids8k,
                grads8k),
               ("dedup segment sum", torch.zeros_like(grads8k), seg,
                grads8k[order]),
               ("sparse write-back with sentinels", tfull, rep,
                vals * valid),
               ("ragged N=1500 int32", tfull, ids8k[:1500].int(),
                vals[:1500]),
               ("ids out of range (dropped)", tfull, wild, vals[:7] + 1.0),
               ("D=5", small, ids8k[:333] % 800, rand(333, 5)),
               ("vals off the 16-byte grid (scalar loop), B=8192 batch",
                torch.zeros_like(tfull), ids8k, misaligned(grads8k)))
    err = 0.0
    for what, start, ids, v in s_cases:
        got, want = start.clone(), start.clone()
        ek.scatter_add_rows(got, ids, v)
        ek.scatter_add_rows_plain(want, ids, v)
        keep = (ids >= 0) & (ids < start.shape[0])
        scale = start.abs().index_add_(0, ids[keep], v[keep].abs())
        scale = float(scale.max())
        err = max(err, compare_sum(what, got, want, scale))
        visible(f"{what}: the added rows", want - start, scale, rel=SUM_TOL)
    before = ek.scatter_add_rows.launches
    ek.scatter_add_rows(tfull, ids8k[:0], vals[:0])
    if ek.scatter_add_rows.launches != before:
        fail("scatter_add_rows of no ids launched")
    buf = torch.zeros_like(tfull)
    b_ms, b_by = bound_ms(n * 16, n * 64 + n * 8 + 2 * distinct * 64)
    kern["scatter_add_rows"] = dict(
        name="scatter_add_rows", route="cuda",
        source="rec_now_tpu_torch/csrc/gather.cu",
        replaces=f"{EXPAND_TPU}:64", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ek.scatter_add_rows(buf, ids8k, grads8k)),
        plain_ms=cuda_ms(torch, lambda: ek.scatter_add_rows_plain(
            buf, ids8k, grads8k)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: buf.index_add_(0, ids8k,
                                                         grads8k)))
    # the sparse path's write-back: sentinels dropped by B12, against the
    # library call sending them to row V - 1 as zeros
    wb = vals * valid
    clamped = rep.clamp_max(vfull - 1)
    sent_ms = cuda_ms(torch, lambda: ek.scatter_add_rows(buf, rep, wb))
    sent_lib = cuda_ms(torch, lambda: buf.index_add_(0, clamped, wb))
    print(f"  sparse write-back, {n - distinct} sentinels: B12 {sent_ms:.4f}"
          f" ms (dropped), index_add_ {sent_lib:.4f} ms (to row V - 1) "
          f"[{card}]")
    # the same calls' device time alone (the first profiled window of a
    # process pays the tracer's start-up: one is run and dropped)
    profiled_ms(torch, lambda: gk.gather_rows(tfull, ids8k), reps=2)
    dev_ms = {
        "gather_rows": profiled_ms(torch, lambda: gk.gather_rows(tfull,
                                                                 ids8k)),
        "index_select": profiled_ms(torch, lambda: torch.index_select(
            tfull, 0, ids8k)),
        "scatter_add_rows": profiled_ms(
            torch, lambda: ek.scatter_add_rows(buf, ids8k, grads8k)),
        "index_add_": profiled_ms(torch, lambda: buf.index_add_(
            0, ids8k, grads8k)),
        "scatter_add_rows, sentinels": profiled_ms(
            torch, lambda: ek.scatter_add_rows(buf, rep, wb)),
        "index_add_, sentinels to row V - 1": profiled_ms(
            torch, lambda: buf.index_add_(0, clamped, wb))}
    print("  device time by torch.profiler, B=8192 batch: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in dev_ms.items()) + f" [{card}]")
    # the wrappers' host path (B8, B11, B12 and their library calls; B5)
    from rec_now_tpu_torch.profile_launch import wrapper_host_us
    print("host path, us per call at a tiny size, the median of 5 rounds "
          "of 2,000 (rec_now_tpu_torch.profile_launch): " + ", ".join(
              f"{k} {v:.3f}" for k, v in wrapper_host_us().items())
          + f" [{card}]")


def cli_launches(per_step: dict, steps: int, eval_batches: int) -> dict:
    """Launches of a CLI run: ``per_step`` for each step, and one row
    gather for each batch of its one (final) eval."""
    want = {k: v * steps for k, v in per_step.items()}
    want["gather_rows"] = want.get("gather_rows", 0) + eval_batches
    return want


def run_cli(cli, counted, args, what: str, launches: dict):
    """``rec_now_tpu_torch.train.main(args)``, which ``python -m
    rec_now_tpu_torch.train`` runs, in this process with its output
    captured and every launch count set to 0 just before it and held to
    ``launches`` just after -> (its periodic log lines, its final eval);
    fails on a non-zero exit, a loss that is not finite and > 0, or a
    final eval without a finite auc and gauc."""
    out = io.StringIO()

    def main():
        with contextlib.redirect_stdout(out):
            return cli.main(args)

    t0 = time.perf_counter()
    try:
        rc = counted(what, 1, launches, main)
    except BaseException:
        print(out.getvalue()[-3000:])
        raise
    print(f"  exit {rc} after {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        print(out.getvalue()[-3000:])
        fail(f"{what}: the training CLI exited {rc}")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    logs = [ln for ln in lines if "examples_per_sec" in ln]
    finals = [ln for ln in lines if "final_eval" in ln]
    for ln in logs:
        print(f"  {json.dumps(ln)}")
    losses = [v for ln in logs for k, v in ln.items()
              if k not in ("step", "examples_per_sec", "sparse_dropped")]
    if not logs or not all(math.isfinite(v) and v > 0 for v in losses):
        fail(f"{what}: no log line or a bad loss")
    if len(finals) != 1:
        fail(f"{what}: {len(finals)} final_eval lines")
    res = finals[0]["final_eval"]
    print(f"  final_eval {json.dumps(res)}")
    if not all(math.isfinite(res.get(k, math.nan)) for k in ("auc", "gauc")):
        fail(f"{what}: the final eval has no finite auc and gauc")
    return logs, res


def steady_ms(logs, batch: int) -> float:
    """ms per step over the second half of the log lines (the prefetch
    queues' head start spent): a line at step s with rate r was printed
    batch * s / r seconds into the loop."""
    a, b = logs[len(logs) // 2], logs[-1]
    ta = batch * a["step"] / a["examples_per_sec"]
    tb = batch * b["step"] / b["examples_per_sec"]
    return (tb - ta) / (b["step"] - a["step"]) * 1e3


def train_cli_phase(torch, counted, card: str) -> None:
    """Phase 8: the training entry point on the card (module docstring)."""
    import numpy as np
    from rec_now_tpu_torch import train as cli
    from rec_now_tpu_torch.training.checkpoint import CheckpointManager
    from rec_now_tpu_torch.training.prefetch import (DevicePrefetcher,
                                                     WindowPrefetcher)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        args = cli.parse_args(CLI_FLAGSHIP + CLI_COMMON)
        batches, make_eval = cli.data_streams(args)
        first = [next(batches) for _ in range(args.scan_window)]
        per_step = {"gather_rows": 1, "scatter_add_rows": 1,
                    "pair_loss_sum": 1, "adagrad_dense_pass": 1}

        # the CLI's first window, in process: the windowed loop against
        # put + train_step on the same (host-dequantized) batches
        trainer = cli.make_trainer(args)
        state = cli.init_state(trainer, args)
        win = trainer.put_packed_window(first)
        state, seq = counted(
            f"the CLI's first window in process ({len(first)} steps at "
            f"B=8192)", len(first), per_step,
            lambda: trainer.train_many_packed(state, win))
        ref = cli.make_trainer(args)
        rstate = cli.init_state(ref, args)
        packed = ref.wire.pack_window(first)
        native = ref.wire.pack_window_native(first)
        same = all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(native, packed))
        print(f"the first window's C++ pack (what put_packed_window runs) "
              f"vs the numpy pack: {'equal' if same else 'DIFFERENT'} "
              f"bytes")
        if not same:
            fail("the C++ wire pack differs from the numpy pack")
        scale = packed.dense_scale                      # (S, 1, 2, F)
        deq = (packed.dense.astype(np.float32) * scale[:, :, 1]
               + scale[:, :, 0])
        print("windowed loop vs put + train_step, first window:")
        for i, b in enumerate(first):
            rstate, m = ref.train_step(rstate, *ref.put(
                b._replace(dense=deq[i])))
            for key, want in m.items():
                got, want = float(seq[key][i]), float(want)
                print(f"  step {i + 1} {key}: windowed {got:.7f} "
                      f"stepwise {want:.7f}")
                if not abs(got - want) <= 1e-4 * abs(want):
                    fail(f"windowed step {i + 1} {key} {got} != {want}")
        del ref, rstate

        # the CLI's two loops (with their prefetch threads) on batches
        # drawn beforehand (the CLI's rate below includes drawing them),
        # and the windowed loop alone on windows placed beforehand (what
        # the prefetch thread's host work costs it), from the state above,
        # four times each in alternating order; each read whole and from
        # its first batch's arrival (the pipeline's fill left out)
        t0 = time.perf_counter()
        more = [next(batches) for _ in range(LOOP_STEPS)]
        gen_ms = (time.perf_counter() - t0) / LOOP_STEPS * 1e3
        pack_ms = {}
        for name, pack in (("numpy", trainer.wire.pack_window),
                           ("C++", trainer.wire.pack_window_native)):
            t0 = time.perf_counter()
            for i in range(0, LOOP_STEPS, args.scan_window):
                pack(more[i:i + args.scan_window])
            pack_ms[name] = (time.perf_counter() - t0) / LOOP_STEPS * 1e3

        def windowed(st):
            arrived = None
            with WindowPrefetcher(more, trainer.put_packed_window,
                                  args.scan_window) as wins:
                for dev_win, _ in wins:
                    arrived = arrived or time.perf_counter()
                    st, _ = trainer.train_many_packed(st, dev_win)
            return st, arrived

        def stepwise(st):
            arrived = None
            with DevicePrefetcher(more, trainer.put) as steps:
                for dev_batch in steps:
                    arrived = arrived or time.perf_counter()
                    st, _ = trainer.train_step(st, *dev_batch)
            return st, arrived

        placed_wins = [trainer.put_packed_window(
            more[i:i + args.scan_window])
            for i in range(0, LOOP_STEPS, args.scan_window)]

        def placed(st):
            arrived = time.perf_counter()
            for dev_win in placed_wins:
                st, _ = trainer.train_many_packed(st, dev_win)
            return st, arrived

        loops = {"windowed": windowed, "stepwise": stepwise,
                 "windowed on placed windows": placed}
        loop_ms = {k: [] for k in loops}
        for r in range(4):
            for name in list(loops)[::1 if r % 2 == 0 else -1]:
                loop = loops[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, arrived = counted(
                    f"{name} loop, {LOOP_STEPS} steps at B=8192",
                    LOOP_STEPS, per_step, lambda: loop(state))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loop_ms[name].append(((t1 - t0) / LOOP_STEPS * 1e3,
                                      (t1 - arrived) / LOOP_STEPS * 1e3))
        del placed_wins
        print(f"loops on batches drawn beforehand, config 2 at B=8192, "
              f"ms/step whole and from the first batch's arrival: "
              + "; ".join(f"{k} " + ", ".join(f"{a:.3f} / {b:.3f}"
                                               for a, b in v)
                          for k, v in loop_ms.items())
              + "; medians from arrival: " + ", ".join(
                  f"{k} {statistics.median(b for _, b in v):.3f}"
                  for k, v in loop_ms.items())
              + f"; drawing a batch {gen_ms:.1f} ms, packing it "
              + ", ".join(f"{v:.2f} ms ({k})" for k, v in pack_ms.items())
              + f" on the host [{card}]")

        # a checkpoint of that state, restored into a fresh one
        mgr = CheckpointManager(os.path.join(ckdir, "in_process"))
        mgr.save(int(state.step), state)
        other = cli.make_trainer(args)
        back = mgr.restore(target=cli.init_state(other, args))
        saved, restored = state.opt.state_dict(), back.opt.state_dict()
        same = (all(torch.equal(p, back.params[n])
                    for n, p in state.params.items())
                and all(torch.equal(t, getattr(back.table, n))
                        for n, t in state.table._asdict().items()
                        if t is not None)
                and int(back.step) == int(state.step)
                and all(torch.equal(torch.as_tensor(v), torch.as_tensor(
                    restored["state"][i][k]))
                        for i, st in saved["state"].items()
                        for k, v in st.items()))
        print(f"checkpoint at step {int(state.step)} restored into a "
              f"fresh state: {'equal' if same else 'DIFFERENT'}")
        if not same:
            fail("the restored checkpoint differs from the saved state")
        del trainer, state, other, back, win

        # the entry point as users start it, each run counted whole
        fm_step = {"gather_rows": 1, "scatter_add_rows": 1,
                   "adagrad_dense_pass": 1}
        flagship = cli_launches(per_step, args.steps, args.eval_batches)
        cli_ck = os.path.join(ckdir, "cli")
        a_logs, a_res = run_cli(cli, counted, CLI_FLAGSHIP + CLI_COMMON + [
            "--eval-mode", "device", "--checkpoint-dir", cli_ck,
            "--checkpoint-every", "20"],
            "train CLI A: config 2, windowed, u8, device eval, checkpoints",
            flagship)
        got, want = a_logs[0]["loss"], float(seq["loss"][-1])
        print(f"  CLI step {a_logs[0]['step']} loss {got} vs in process "
              f"{want:.7f}")
        if not abs(got - want) <= 1e-4 * abs(want) + 5e-6:
            fail("the CLI's first window differs from the in-process one")
        b_logs, b_res = run_cli(cli, counted, CLI_FLAGSHIP + CLI_COMMON + [
            "--eval-mode", "exact"], "train CLI B: the same, exact eval",
            flagship)
        for key, tol in (("auc", 1e-3), ("gauc", 2e-3)):
            d = abs(a_res[key] - b_res[key])
            print(f"  device {key} {a_res[key]:.6f} vs exact "
                  f"{b_res[key]:.6f}: {d:.2e} (tol {tol:g})")
            if d > tol:
                fail(f"device-eval {key} is off the exact eval's")
        c_logs, _ = run_cli(cli, counted, CLI_FLAGSHIP + CLI_COMMON + [
            "--scan-window", "0", "--eval-mode", "exact"],
            "train CLI C: config 2, stepwise", flagship)
        run_cli(cli, counted, [
            "--model", "fm", "--batch-size", "8192", "--steps",
            str(FM_STEPS), "--scan-window", "5", "--log-every", "5",
            "--eval-batches", str(FM_EVAL), "--eval-mode", "device"],
            "train CLI D: config 1 (FM), windowed, device eval",
            cli_launches(fm_step, FM_STEPS, FM_EVAL))

        # the CLI's last checkpoint, evaluated again in process
        mgr = CheckpointManager(cli_ck)
        print(f"CLI checkpoints: steps {mgr.steps()}")
        if mgr.steps() != [20, 40, 60]:
            fail("the CLI did not keep checkpoints 20, 40 and 60")
        trainer = cli.make_trainer(args)
        state = mgr.restore(target=cli.init_state(trainer, args))
        evals = list(make_eval())
        res = counted(
            f"device eval of the CLI's last checkpoint ({len(evals)} "
            f"batches)", len(evals), {"gather_rows": 1},
            lambda: trainer.evaluate_device(
                state, evals, num_group_slots=cli.eval_slots(args),
                group_buckets=args.eval_group_buckets))
        for key in ("auc", "gauc"):
            d = abs(res[key] - a_res[key])
            print(f"  restored {key} {res[key]!r} vs the CLI's "
                  f"{a_res[key]!r}: {d:.2e}")
            if d > 1e-6:
                fail("the CLI's checkpoint does not give the CLI's eval")
        w_ms, s_ms = steady_ms(b_logs, 8192), steady_ms(c_logs, 8192)
        print(f"train CLI, config 2 at B=8192, steps "
              f"{b_logs[len(b_logs) // 2]['step']}-{b_logs[-1]['step']}, "
              f"batches drawn as it runs: windowed (--scan-window 5) "
              f"{w_ms:.3f} ms/step, {8192 / w_ms * 1e3:.0f} examples/s; "
              f"stepwise {s_ms:.3f} ms/step, {8192 / s_ms * 1e3:.0f} "
              f"examples/s [{card}]")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.layers.multi_dense_layer import MultiDenseLayer
    from rec_now_tpu_torch.losses.pairwise import pairwise_loss
    from rec_now_tpu_torch.models import (DCNv2Model, FeatureConfig,
                                          MultiTaskModel, XDeepFMModel)
    from rec_now_tpu_torch.ops import _build, cin_kernel as ck
    from rec_now_tpu_torch.ops import expand_kernel as expand_k
    from rec_now_tpu_torch.ops import gather_kernel as gather_k
    from rec_now_tpu_torch.ops import listwise_kernel as lk
    from rec_now_tpu_torch.ops import multi_dense_kernel as mk
    from rec_now_tpu_torch.ops import pairwise_kernel as pk
    from rec_now_tpu_torch.ops import table_update_kernel as tk
    from rec_now_tpu_torch.ops.cin_op import cin_contract_plain
    from rec_now_tpu_torch.serving import (ServingState, WireScorer,
                                           build_scorer)
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    from rec_now_tpu_torch.training import SyntheticCriteo, Trainer, \
        TrainerConfig

    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(secs)} sources "
          f"at once")
    for name, sec in secs.items():
        print(f"  csrc/{name}.cu: {sec:.1f} s")
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "properties" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain --------------------------------------------------
    gen = torch.Generator().manual_seed(1234)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def glorot(k, f, h):
        return rand(k, f, h, scale=(2.0 / (f * h + k)) ** 0.5)

    B, D, F, KS = 8192, 16, 26, (64, 64)
    M = B * D
    kern = {}

    print("cin_stack_sum vs plain:")
    x0 = rand(M, F)
    ws = [glorot(KS[0], F, F), glorot(KS[1], F, KS[0])]
    err = 0.0
    for oi in (True, False):
        err = max(err, compare(f"M={M} Ks={KS} output_input={oi}",
                               ck.cin_stack_sum(x0, ws, oi),
                               ck.cin_stack_sum_plain(x0, ws, oi)))
    xr = rand(12345, F)
    for ks in ((100, 37, 50), (5,)):
        hs = (F,) + ks[:-1]
        wr = [glorot(k, F, h) for k, h in zip(ks, hs)]
        err = max(err, compare(f"ragged M=12345 Ks={ks}",
                               ck.cin_stack_sum(xr, wr),
                               ck.cin_stack_sum_plain(xr, wr)))
    # layer 1 on x0 (symmetric products), the last layer collapsed to
    # sum_f x0[f] (sum_h Wc[h, f] h1[h]), then the channel sums
    flops = (cin_flops(M, F, F, KS[0], True) + 2 * M * F * (KS[0] + 1)
             + M * (F + KS[0] + 1))
    nbytes = (M * F + M + sum(w.numel() for w in ws)) * 4
    b_ms, b_by = bound_ms(flops, nbytes)
    kern["cin_stack_sum"] = dict(
        name="cin_stack_sum", route="cuda",
        source="rec_now_tpu_torch/csrc/cin.cu",
        replaces=f"{CIN_TPU}:493", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ck.cin_stack_sum(x0, ws)),
        plain_ms=cuda_ms(torch, lambda: ck.cin_stack_sum_plain(x0, ws)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    print("cin_flat vs plain:")
    err, t = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0,
                       nbytes=0)
    for h, k in ((F, KS[0]), (KS[0], KS[1])):
        prev = x0 if h == F else rand(M, h)
        w = glorot(k, F, h)
        err = max(err, compare(f"M={M} H={h} K={k}",
                               ck.cin_flat(x0, prev, w),
                               ck.cin_flat_plain(x0, prev, w)))
        t["ms"] += cuda_ms(torch, lambda: ck.cin_flat(x0, prev, w))
        t["plain_ms"] += cuda_ms(torch, lambda: ck.cin_flat_plain(x0, prev,
                                                                  w))
        t["library_ms"] += cuda_ms(
            torch, lambda: torch.einsum("mf,mh,kfh->mk", x0, prev, w))
        t["flops"] += cin_flops(M, F, h, k, prev is x0)
        t["nbytes"] += (M * F + (0 if prev is x0 else M * h) + k * F * h
                        + M * k) * 4
    pr = rand(12345, 37)
    w100 = glorot(100, F, 37)
    err = max(err, compare("ragged M=12345 H=37 K=100",
                           ck.cin_flat(xr, pr, w100),
                           ck.cin_flat_plain(xr, pr, w100)))
    b_ms, b_by = bound_ms(t["flops"], t["nbytes"])
    kern["cin_flat"] = dict(
        name="cin_flat", route="cuda", source="rec_now_tpu_torch/csrc/cin.cu",
        replaces=f"{CIN_TPU}:153", max_abs_err=err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=t["library_ms"])
    def einsum_grads(fn, inputs, g):
        """autograd through the einsum forward: the backward alone, the
        graph built once and kept."""
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)

    print("cin_stack_sum_bwd vs plain:")
    g = rand(M)
    err = 0.0
    for oi in (True, False):
        got = ck.cin_stack_sum_bwd(x0, ws, g, oi)
        want = ck.cin_stack_sum_bwd_plain(x0, ws, g, oi)
        err = max(err, compare_all(f"M={M} Ks={KS} output_input={oi}",
                                   [got[0]] + got[1], [want[0]] + want[1]))
    gr = rand(12345)
    for ks in ((100, 37, 50), (5,)):
        hs = (F,) + ks[:-1]
        wr = [glorot(k, F, h) for k, h in zip(ks, hs)]
        got = ck.cin_stack_sum_bwd(xr, wr, gr)
        want = ck.cin_stack_sum_bwd_plain(xr, wr, gr)
        err = max(err, compare_all(f"ragged M=12345 Ks={ks}",
                                   [got[0]] + got[1], [want[0]] + want[1]))
    nbytes = (2 * M * F + M + 2 * sum(w.numel() for w in ws[:-1])
              + ws[-1].numel() + F * KS[0]) * 4
    b_ms, b_by = bound_ms(cin_stack_bwd_flops(M, F, KS), nbytes)
    kern["cin_stack_sum_bwd"] = dict(
        name="cin_stack_sum_bwd", route="cuda",
        source="rec_now_tpu_torch/csrc/cin.cu",
        replaces=f"{CIN_TPU}:534", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ck.cin_stack_sum_bwd(x0, ws, g)),
        plain_ms=cuda_ms(torch,
                         lambda: ck.cin_stack_sum_bwd_plain(x0, ws, g)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, einsum_grads(
            lambda a, *w: ck.cin_stack_sum_plain(a, w), [x0] + ws, g)))

    print("cin_flat_bwd vs plain:")
    err, t = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0,
                       nbytes=0)
    h1 = ck.cin_flat(x0, x0, ws[0])
    for prev, w in ((x0, ws[0]), (h1, ws[1])):
        h, k = prev.shape[1], w.shape[0]
        gk = rand(M, k)
        err = max(err, compare_all(f"M={M} H={h} K={k}",
                                   ck.cin_flat_bwd(x0, prev, w, gk),
                                   ck.cin_flat_bwd_plain(x0, prev, w, gk)))
        t["ms"] += cuda_ms(torch, lambda: ck.cin_flat_bwd(x0, prev, w, gk))
        t["plain_ms"] += cuda_ms(
            torch, lambda: ck.cin_flat_bwd_plain(x0, prev, w, gk))
        t["library_ms"] += cuda_ms(torch, einsum_grads(
            lambda a, b, c: torch.einsum("mf,mh,kfh->mk", a, b, c),
            [x0, prev, w], gk))
        same = prev is x0
        t["flops"] += cin_flat_bwd_flops(M, F, h, k, same)
        io = M * F + (0 if same else M * h) + w.numel()   # read and written
        t["nbytes"] += (2 * io + M * k + (M * h if same else 0)) * 4
        # the device time of its two kernels, each beside its least work:
        # the row kernel A = g W and both epilogues, the weight gradient
        # (its partial sums included)
        by = profiled_by_name(torch, lambda: ck.cin_flat_bwd(x0, prev, w, gk))
        rows = sum(v for n, v in by.items() if "cin_bwd_rows" in n)
        terms = F * (F + 1) // 2 if same else F * h
        parts = (("row kernel", rows, 2 * M * k * F * h + 4 * M * F * h),
                 ("dW kernel + partial sums", sum(by.values()) - rows,
                  M * terms + 2 * M * k * terms))
        print(f"  B5 split, H={h} K={k}, device ms by torch.profiler: "
              + "; ".join(f"{what} {v:.4f} (bound {bound_ms(fl, 0)[0]:.4f}"
                          + (f", {100 * bound_ms(fl, 0)[0] / v:.1f}%)" if v
                             else ", not measured)")
                          for what, v, fl in parts) + f" [{card}]")
    g100 = rand(12345, 100)
    err = max(err, compare_all("ragged M=12345 H=37 K=100",
                               ck.cin_flat_bwd(xr, pr, w100, g100),
                               ck.cin_flat_bwd_plain(xr, pr, w100, g100)))
    b_ms, b_by = bound_ms(t["flops"], t["nbytes"])
    kern["cin_flat_bwd"] = dict(
        name="cin_flat_bwd", route="cuda",
        source="rec_now_tpu_torch/csrc/cin.cu", replaces=f"{CIN_TPU}:235",
        max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=t["library_ms"])
    del h1

    print("pair_loss_sum vs plain:")
    data0 = SyntheticCriteo(seed=0)
    pb = next(data0.batches(8192, 1, seed=1))
    lab = torch.as_tensor(pb.labels, device=dev)
    grp = torch.as_tensor(pb.group_ids, device=dev)
    xl = rand(8192)
    print(f"  B=8192: {len(set(pb.group_ids.tolist()))} groups, "
          f"{pair_ops(pb.labels, pb.group_ids):,} operations")
    err = 0.0
    cases = [(xl, lab, grp, -0.5)]
    rb = next(data0.batches(1000, 1, seed=2))
    cases.append((rand(1000), torch.as_tensor(rb.labels, device=dev),
                  torch.as_tensor(rb.group_ids, device=dev), 0.0))
    for xs, ls, gs, power in cases:
        got = pk.pair_loss_fused(xs, ls, gs, 1.0, power)
        want = pk.pair_loss_fused_plain(xs, ls, gs, 1.0, power)
        if float(got[1]) != float(want[1]):
            fail(f"pair count {float(got[1])} != {float(want[1])}")
        err = max(err, compare_all(f"B={len(xs)} power={power}", got, want))
    err_pair = err
    b_ms, b_by = bound_ms(pair_ops(pb.labels, pb.group_ids), 16 * 8192 + 8)
    kern["pair_loss_sum"] = dict(
        name="pair_loss_sum", route="cuda",
        source="rec_now_tpu_torch/csrc/pairwise.cu",
        replaces=f"{PAIR_TPU}:357", max_abs_err=err,
        ms=cuda_ms(torch, lambda: pk.pair_loss_fused(xl, lab, grp, 1.0,
                                                     -0.5)),
        plain_ms=cuda_ms(torch, lambda: pk.pair_loss_fused_plain(
            xl, lab, grp, 1.0, -0.5)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    print("adagrad_dense_pass vs plain:")
    err = 0.0
    for v, d in ((2_600_000, 16), (12345, 16), (1001, 8)):
        tb, ac = rand(v, d, scale=1e-3), rand(v).abs() * 0.1
        dg = rand(v, d) * (torch.rand(v, generator=gen) < 0.1).to(dev)[:, None]
        t2, a2 = tb.clone(), ac.clone()
        tk.adagrad_dense_pass(tb, ac, dg, 0.05)
        tk.adagrad_dense_pass_plain(t2, a2, dg, 0.05)
        err = max(err, compare(f"V={v} D={d} accumulators", ac, a2, 0.0),
                  compare(f"V={v} D={d} rows", tb, t2, 0.0))
    # per row: 2 D (squares, sum) + 2 D (scale x g, subtract) + 5 (mean,
    # add, max, sqrt, divide); bytes: table and g read, table written,
    # acc read and written
    v, d = 2_600_000, 16
    b_ms, b_by = bound_ms(v * (4 * d + 5), v * (3 * d + 2) * 4)
    tb, ac = rand(v, d, scale=1e-3), torch.full((v,), 0.1, device=dev)
    dg = rand(v, d)
    kern["adagrad_dense_pass"] = dict(
        name="adagrad_dense_pass", route="cuda",
        source="rec_now_tpu_torch/csrc/table_update.cu",
        replaces=f"{TABLE_TPU}:142", max_abs_err=err,
        ms=cuda_ms(torch, lambda: tk.adagrad_dense_pass(tb, ac, dg, 0.05)),
        plain_ms=cuda_ms(torch, lambda: tk.adagrad_dense_pass_plain(
            tb, ac, dg, 0.05)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print("multi_dense vs plain:")
    err = 0.0
    t = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, t_ops=0.0, t_bytes=0.0,
             flops=0, nbytes=0)
    for name, nx, n, d, u, relu, times in MD_BANKS:
        act = "relu" if relu else None
        x = rand(nx, B, d)
        w, bias = rand(n, d, u, scale=d ** -0.5), rand(n, 1, u)
        for bb in (bias, None):
            err = max(err, compare(
                f"{name} ({nx}, {B}, {d}) x ({n}, {d}, {u}) relu={relu} "
                f"bias={bb is not None}", mk.multi_dense_fused(x, w, bb, relu),
                mk.multi_dense_xla(x, w, bb, act), floor=0.0))
        xe = x.expand(n, B, d)
        ms = cuda_ms(torch, lambda: mk.multi_dense_fused(x, w, bias, relu))
        pms = cuda_ms(torch, lambda: mk.multi_dense_xla(x, w, bias, act))
        lms = cuda_ms(torch, lambda: torch.baddbmm(bias, xe, w))
        fl, nb = multi_dense_work(nx, n, B, d, u)
        # the tile runs three TF32 products per multiply-add on the
        # tensor cores; the gate kernel f32 FMAs
        gate = mk.takes_gate_kernel(nx, n, d, u)
        ops, peak, kind = ((fl, PEAK_F32_FLOPS, "f32") if gate
                           else (3 * fl, PEAK_TF32_FLOPS, "ops, split TF32"))
        b_ms, b_by = bound_ms(ops, nb, peak)
        print(f"  {name}: {'gate kernel' if gate else 'split-TF32 tile'} "
              f"{ms:.4f} ms, {pms:.4f} ms plain, {lms:.4f} ms torch.baddbmm;"
              f" bound {b_ms:.4f} ms ({kind if b_by == 'operations' else b_by}"
              f") = {b_ms / ms:.1%} of the kernel's time; f32 SIMT bound "
              f"{bound_ms(fl, nb)[0]:.4f} ms; x{times} per forward [{card}]")
        if b_ms > ms:
            fail(f"multi_dense {name} ran under its bound: the bound or "
                 f"the count is wrong")
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       ("t_ops", ops / peak), ("t_bytes", nb / PEAK_BYTES),
                       ("flops", fl), ("nbytes", nb)):
            t[key] += times * v
    # ragged shapes (B = 1, odd D, U between the tile widths) and the
    # dispatch edges at other B: N * U = 16 with W too deep for the gate
    # kernel's shared memory (the tile), a per-expert input with N * U = 8
    # (the tile), D % 4 == 0 with U % 4 == 0 (16-byte copies) per expert
    for nx, n, b, d, u in ((1, 4, 1, 429, 128), (4, 4, 1000, 128, 64),
                           (1, 2, 1000, 429, 4), (1, 3, 777, 77, 17),
                           (3, 3, 1001, 45, 200), (1, 1, 1, 13, 5),
                           (1, 4, 1000, 5000, 4), (2, 2, 500, 429, 4),
                           (3, 3, 257, 64, 200)):
        x = rand(nx, b, d)
        w, bias = rand(n, d, u, scale=d ** -0.5), rand(n, 1, u)
        for relu in (True, False):
            err = max(err, compare(
                f"ragged ({nx}, {b}, {d}) x ({n}, {d}, {u}) relu={relu}",
                mk.multi_dense_fused(x, w, bias, relu),
                mk.multi_dense_xla(x, w, bias, "relu" if relu else None),
                floor=0.0))
        # x off the 16-byte grid: the tile's 4-byte copies
        err = max(err, compare(
            f"ragged ({nx}, {b}, {d}) x ({n}, {d}, {u}), x misaligned",
            mk.multi_dense_fused(misaligned(x), w, bias, False),
            mk.multi_dense_xla(x, w, bias, None), floor=0.0))
    t_ops, t_bytes = t["t_ops"], t["t_bytes"]
    b_ms = max(t_ops, t_bytes) * 1e3
    b_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  one forward's six launches: {t['flops'] / 1e9:.3f} GFLOP, "
          f"{t['nbytes'] / 1e6:.1f} MB: kernel {t['ms']:.4f} ms, "
          f"torch.baddbmm {t['library_ms']:.4f} ms; bound {b_ms:.4f} ms "
          f"(ops, split TF32 {t_ops * 1e3:.4f}; bytes {t_bytes * 1e3:.4f}) "
          f"= {b_ms / t['ms']:.1%}; f32 SIMT bound "
          f"{bound_ms(t['flops'], t['nbytes'])[0]:.4f} ms [{card}]")
    kern["multi_dense"] = dict(
        name="multi_dense", route="cuda",
        source="rec_now_tpu_torch/csrc/multi_dense.cu",
        replaces=f"{MD_TPU}:75", max_abs_err=err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=t["library_ms"])

    print("listwise_loss_sum vs plain:")
    print(f"  B=8192: {listwise_ops(pb.labels):,} operations")
    err = 0.0
    ones = torch.ones(8192, device=dev)
    lw_cases = [("click batch B=8192", xl, lab, grp),
                ("click batch B=1000", *cases[1][:3]),   # the pair loss's
                ("no valid group", xl, ones, grp),
                ("B=1", xl[:1], lab[:1], grp[:1]),
                ("one group B=2048", xl[:2048], lab[:2048],
                 torch.zeros(2048, dtype=torch.int32, device=dev)),
                ("singletons B=513", xl[:513], lab[:513],
                 torch.arange(513, device=dev))]
    for what, xs, ls, gs in lw_cases:
        got = lk.listwise_loss_fused(xs, ls, gs)
        want = lk.listwise_loss_fused_plain(xs, ls, gs)
        if float(got[1]) != float(want[1]):
            fail(f"listwise count {float(got[1])} != {float(want[1])}")
        print(f"  {what}: {int(want[1])} valid groups")
        err = max(err, compare_all(what, got, want))
    b_ms, b_by = bound_ms(listwise_ops(pb.labels),
                          16 * 8192 + 8)
    kern["listwise_loss_sum"] = dict(
        name="listwise_loss_sum", route="cuda",
        source="rec_now_tpu_torch/csrc/listwise.cu",
        replaces=f"{LW_TPU}:99", max_abs_err=err,
        ms=cuda_ms(torch, lambda: lk.listwise_loss_fused(xl, lab, grp)),
        plain_ms=cuda_ms(torch, lambda: lk.listwise_loss_fused_plain(
            xl, lab, grp)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # -- config 2's kernels: lazy Adam (B10), the pair counts (B7a/b/c) and
    # the general pair loss (B3) --------------------------------------------
    fc = FeatureConfig()
    ids8k = fc.global_ids(torch.as_tensor(pb.sparse_ids, device=dev)
                          ).reshape(-1)
    print("adam_dense_pass vs plain:")
    err = 0.0
    vfull = fc.total_rows
    touched_full = torch.zeros(vfull, dtype=torch.bool, device=dev)
    touched_full.index_fill_(0, ids8k, True)
    n_touched = int(touched_full.sum())
    print(f"  V={vfull}: a B=8192 batch's {ids8k.numel()} ids touch "
          f"{n_touched} rows ({n_touched / vfull:.2%})")
    ragged = []
    for v, d in ((12345, 16), (1001, 8)):
        ragged.append((v, d, (torch.rand(v, generator=gen) < 0.3).to(dev)))
    for v, d, tch in [(vfull, 16, touched_full)] + ragged:
        for t in (1, 1000):
            tb, m1 = rand(v, d, scale=1e-3), rand(v, d, scale=1e-3)
            v1 = rand(v, d, scale=1e-3).square()
            dg = rand(v, d, scale=1e-3) * tch[:, None]
            dg[::7] = 0.0              # touched rows with a zero gradient
            cnt = torch.tensor(t, dtype=torch.int32, device=dev)
            before = [x.clone() for x in (tb, m1, v1)]
            want = [x.clone() for x in (tb, m1, v1)]
            tk.adam_dense_pass(tb, m1, v1, dg, tch, cnt, 1e-3)
            tk.adam_dense_pass_plain(*want, dg, tch, cnt, 1e-3, 0.9, 0.999,
                                     1e-7)
            for name, got, ref, old in zip(("rows", "m", "v"), (tb, m1, v1),
                                           want, before):
                err = max(err, compare(f"V={v} D={d} t={t} {name}", got,
                                       ref, 0.0))
                if not torch.equal(got[~tch], old[~tch]):
                    fail(f"adam_dense_pass changed an untouched {name}")
                visible(f"the touched {name}' change", ref[tch] - old[tch],
                        float(ref.abs().max()))
    # bytes this batch's data needs: every row's flag, then table, m, v and
    # g read and table, m, v written for each touched row; ~14 operations a
    # touched element
    b_ms, b_by = bound_ms(14 * n_touched * 16,
                          vfull + n_touched * 7 * 16 * 4 + 4)
    tb, m1 = rand(vfull, 16, scale=1e-3), rand(vfull, 16, scale=1e-3)
    v1, dg = rand(vfull, 16, scale=1e-3).square(), rand(vfull, 16)
    cnt = torch.tensor(1, dtype=torch.int32, device=dev)
    kern["adam_dense_pass"] = dict(
        name="adam_dense_pass", route="cuda",
        source="rec_now_tpu_torch/csrc/table_update.cu",
        replaces=f"{TABLE_TPU}:186", max_abs_err=err,
        ms=cuda_ms(torch, lambda: tk.adam_dense_pass(
            tb, m1, v1, dg, touched_full, cnt, 1e-3)),
        plain_ms=cuda_ms(torch, lambda: tk.adam_dense_pass_plain(
            tb, m1, v1, dg, touched_full, cnt, 1e-3, 0.9, 0.999, 1e-7)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del tb, m1, v1, dg, before, want

    print("pair counts and the general pair loss vs plain:")
    graded = torch.as_tensor(pb.labels + pb.cvr_labels, device=dev)
    dom = torch.as_tensor(pb.domain_idx, device=dev)
    mask = (torch.rand(8192, generator=gen) > 0.1).float().to(dev)
    two = [grp, dom]
    print(f"  B=8192, labels {{0, 1, 2}}, groups and domain: "
          f"{int(mask.sum())} samples unmasked")
    gcases = [("B=8192 graded, 2 groups, mask", xl, graded, two, mask),
              ("B=8191", xl[:8191], graded[:8191], [grp[:8191], dom[:8191]],
               mask[:8191]),
              ("B=1", xl[:1], graded[:1], [grp[:1], dom[:1]], mask[:1])]
    errs = {"pair_row_counts": 0.0, "same_group_matvec": 0.0,
            "group_pair_counts_binary": 0.0, "pair_loss_sum": err_pair}
    for what, xs, ls, gs, ms in gcases:
        for wrong in (False, True):
            got = pk.pair_row_counts(xs, ls, gs, ms, wrong)
            want = pk.pair_row_counts_plain(xs, ls, gs, ms, wrong)
            errs["pair_row_counts"] = max(errs["pair_row_counts"], compare(
                f"pair_row_counts {what} wrong_order={wrong}", got, want,
                0.0, rel=0.0))
            gpc = pk.same_group_matvec(gs[0], want)
            wgpc = pk.same_group_matvec_plain(gs[0], want)
            errs["same_group_matvec"] = max(
                errs["same_group_matvec"], compare(
                    f"same_group_matvec {what} wrong_order={wrong}", gpc,
                    wgpc, 0.0, rel=0.0))
            rw = torch.where(wgpc > 0, wgpc.clamp_min(1e-30) ** -0.5,
                             torch.zeros_like(wgpc))
            got = pk.pair_loss_fused(xs, ls, gs, 1.0, row_weights=rw,
                                     sample_mask=ms, wrong_order=wrong)
            want = pk.pair_loss_fused_plain(xs, ls, gs, 1.0, row_weights=rw,
                                            sample_mask=ms,
                                            wrong_order=wrong)
            if float(got[1]) != float(want[1]):
                fail(f"general pair count {float(got[1])} != "
                     f"{float(want[1])}")
            print(f"  {what} wrong_order={wrong}: {int(want[1])} pairs")
            errs["pair_loss_sum"] = max(errs["pair_loss_sum"], compare_all(
                f"pair_loss_sum {what} wrong_order={wrong}", got, want))
        clicks = (ls > 1.5).float()     # a click and a conversion: binary
        got = pk.group_pair_counts_binary(gs[0], clicks, ms)
        want = pk.group_pair_counts_binary_plain(gs[0], clicks, ms)
        via = pk.same_group_matvec_plain(gs[0], pk.pair_row_counts_plain(
            xs, clicks, gs[0], ms))
        errs["group_pair_counts_binary"] = max(
            errs["group_pair_counts_binary"],
            compare(f"group_pair_counts_binary {what}", got, want, 0.0,
                    rel=0.0),
            compare(f"group_pair_counts_binary {what} vs B7a -> B7b", got,
                    via, 0.0, rel=0.0))
    counts_full = pk.pair_row_counts_plain(xl, graded, two, mask)
    gpc_full = pk.same_group_matvec_plain(grp, counts_full)
    rw_full = torch.where(gpc_full > 0, gpc_full.clamp_min(1e-30) ** -0.5,
                          torch.zeros_like(gpc_full))
    nb = 8192 * 4
    n_valid = float(pk.pair_loss_fused_plain(xl, graded, two, 1.0,
                                             sample_mask=mask)[1])
    # least work, with no (i, j) sweep: B7a a sort on (group, domain,
    # label) of the unmasked samples, then each sample's mask test and the
    # count of its group's lower labels (4); B7b a sort by group, a
    # segment add and a write back per sample (2); B7c a sort by group,
    # mask * label, the pos and tot adds, pos * (tot - pos) (5 a sample)
    work = {
        "pair_row_counts": (sort_ops(8192, 3) + 4 * 8192, 6 * nb),
        "same_group_matvec": (sort_ops(8192) + 2 * 8192, 3 * nb),
        "group_pair_counts_binary": (sort_ops(8192) + 5 * 8192, 4 * nb),
    }
    calls = {
        "pair_row_counts": (
            lambda: pk.pair_row_counts(xl, graded, two, mask),
            lambda: pk.pair_row_counts_plain(xl, graded, two, mask)),
        "same_group_matvec": (
            lambda: pk.same_group_matvec(grp, counts_full),
            lambda: pk.same_group_matvec_plain(grp, counts_full)),
        "group_pair_counts_binary": (
            lambda: pk.group_pair_counts_binary(grp, lab, mask),
            lambda: pk.group_pair_counts_binary_plain(grp, lab, mask))}
    for name, line in (("pair_row_counts", 170), ("same_group_matvec", 190),
                       ("group_pair_counts_binary", 227)):
        b_ms, b_by = bound_ms(*work[name])
        kern[name] = dict(
            name=name, route="cuda",
            source="rec_now_tpu_torch/csrc/pairwise.cu",
            replaces=f"{PAIR_TPU}:{line}", max_abs_err=errs[name],
            ms=cuda_ms(torch, calls[name][0]),
            plain_ms=cuda_ms(torch, calls[name][1]),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    kern["pair_loss_sum"]["max_abs_err"] = errs["pair_loss_sum"]
    gen_ms = cuda_ms(torch, lambda: pk.pair_loss_fused(
        xl, graded, two, 1.0, row_weights=rw_full, sample_mask=mask))
    gen_plain = cuda_ms(torch, lambda: pk.pair_loss_fused_plain(
        xl, graded, two, 1.0, row_weights=rw_full, sample_mask=mask))
    # a sort on (group, domain, label), the mask test a sample, 12 a
    # valid pair (pair_ops)
    g_ms, g_by = bound_ms(sort_ops(8192, 3) + 8192 + 12 * n_valid,
                          7 * nb + 8)
    print(f"  pair_loss_sum, general form (graded labels, 2 groups, row "
          f"weights, mask; {int(n_valid)} pairs): {gen_ms:.4f} ms kernel, "
          f"{gen_plain:.4f} ms plain, bound {g_ms:.6f} ms ({g_by}) "
          f"[{card}]")

    # -- B11 and B12 on the full-width table with a B = 8192 batch's ids --
    grads8k = rand(ids8k.numel(), 16, scale=1e-3)
    check_gather_scatter(torch, kern, rand, ids8k, grads8k, vfull, gather_k,
                         expand_k, ShardedEmbeddingTable, dev, card)

    print(f"update paths of the table (auto), median of {UPDATE_ROUNDS} "
          f"interleaved rounds of 10 calls each:")
    for opt in ("adagrad", "adam"):
        paths = {}
        for mode, v in (("dense", vfull), ("dense", 4 * vfull),
                        ("sparse", vfull)):
            tbl = ShardedEmbeddingTable(v, 16, device=dev, optimizer=opt,
                                        update_mode=mode)
            st = tbl.state_from(rand(v, 16, scale=1e-3))
            paths[f"{mode} V={v}"] = functools.partial(
                tbl.apply_grads, st, ids8k, grads8k, 1e-3)
        # the sparse path is ~30 launches whose time moves with the host:
        # the paths take turns, in alternating order, and each is read as
        # the median of its rounds
        reads = {k: [] for k in paths}
        for r in range(UPDATE_ROUNDS):
            for k in (list(paths) if r % 2 == 0 else list(paths)[::-1]):
                reads[k].append(cuda_ms(torch, paths[k], reps=10))
        del paths, st
        for k, ts in reads.items():
            print(f"  {opt} {k}: rounds " + " ".join(f"{t:.4f}" for t in ts)
                  + " ms")
        d1, d4, sparse = (statistics.median(ts) for ts in reads.values())
        slope = (d4 - d1) / (3 * vfull)              # ms a row
        cross = (sparse - (d1 - slope * vfull)) / slope
        limit = ShardedEmbeddingTable.DENSE_UPDATE_MAX_TABLE_BYTES[opt]
        # at its limit auto switches paths: where they cost about the
        # same, auto takes the faster one on both sides of it
        dense_at = d1 + slope * (limit / 64 - vfull)
        gap = max(dense_at, sparse) / min(dense_at, sparse) - 1
        print(f"  {opt}: dense {d1:.4f} ms at V={vfull}, {d4:.4f} ms at "
              f"V={4 * vfull}; sparse {sparse:.4f} ms for {ids8k.numel()} "
              f"ids; the two cross at V = {cross:,.0f} rows of D = 16, a "
              f"table of {cross * 64 / 2 ** 20:,.0f} MiB; at auto's limit "
              f"({limit / 2 ** 20:,.0f} MiB) dense takes {dense_at:.4f} "
              f"ms, the paths {gap:.1%} apart [{card}]")
    torch.cuda.empty_cache()

    for v in kern.values():
        print(f"  {v['name']}: {v['ms']:.4f} ms kernel, {v['plain_ms']:.4f} "
              f"ms plain, library {v['library_ms']}, bound {v['bound_ms']:.6f}"
              f" ms ({v['bound_by']}) at full width [{card}]")
    del x0, ws, xr, pr, g, gr, ac, t2, a2, x, xe, w, bias
    torch.cuda.empty_cache()

    # -- 4-6. serve, check one step, train: config 3 in both CIN modes, then
    # config 4 ------------------------------------------------------------
    fc = FeatureConfig()
    data = SyntheticCriteo(num_dense=fc.num_dense, num_sparse=fc.num_sparse,
                           rows_per_field=fc.rows_per_field, seed=0)
    rng_batches = list(data.batches(8192, 6, seed=1))
    small = next(data.batches(1000, 1, seed=2))
    table = EmbeddingTable(fc.total_rows, fc.embedding_dim, device=dev)
    table_t = table.init(torch.Generator().manual_seed(1))
    print(f"table {tuple(table_t.shape)} "
          f"{table_t.numel() * 4 / 1e6:.1f} MB on {table_t.device}")
    cpu_table = EmbeddingTable(fc.total_rows, fc.embedding_dim, device="cpu")
    cpu_table_t = table_t.cpu()

    # the function holding each kernel's launch count
    counter = {"cin_stack_sum": ck.cin_stack_sum, "cin_flat": ck.cin_flat,
               "cin_stack_sum_bwd": ck.cin_stack_sum_bwd,
               "cin_flat_bwd": ck.cin_flat_bwd,
               "pair_loss_sum": pk.pair_loss_sum,
               "adagrad_dense_pass": tk.adagrad_dense_pass,
               "multi_dense": mk.multi_dense_fused,
               "listwise_loss_sum": lk.listwise_loss_sum,
               "adam_dense_pass": tk.adam_dense_pass,
               "pair_row_counts": pk.pair_row_counts,
               "same_group_matvec": pk.same_group_matvec,
               "group_pair_counts_binary": pk.group_pair_counts_binary,
               "gather_rows": gather_k.gather_rows,
               "scatter_add_rows": expand_k.scatter_add_rows}
    for v in kern.values():
        v["launches"] = v["launches_per_step"] = 0

    def counted(what: str, units: int, per_unit: dict, run):
        """``run()`` with every launch count set to 0 just before it and
        read just after: each kernel must have launched ``per_unit`` times
        (0 where not named) for each of ``units``; the counts go to the
        kernels' JSON line."""
        for fn in counter.values():
            fn.launches = 0
        result = run()
        counts = {n: fn.launches for n, fn in counter.items()}
        print(f"{what}: launches {counts}")
        for n, c in counts.items():
            if c != per_unit.get(n, 0) * units:
                fail(f"{what}: {n} launched {c} times, expected "
                     f"{per_unit.get(n, 0)} for each of {units}")
            kern[n]["launches"] += c
        return result

    def check_cin(model, batch) -> None:
        """Serving: the CIN layer on this run's embeddings, kernel vs
        plain."""
        ids = fc.global_ids(torch.as_tensor(batch.sparse_ids, device=dev))
        emb = table.lookup(table_t, ids)                    # (B, F, D)
        b, f, d = emb.shape
        ws = model.cin.weights()
        x0 = emb.transpose(1, 2).contiguous()               # (B, D, F)
        hs = [x0]                                           # plain layers
        for w in ws:
            hs.append(cin_contract_plain(x0, hs[-1], w))
        if model.cin_sum_channel:
            # the model's own call (output_input), then the interactions
            # alone, which every layer must visibly move
            compare("main-path CIN, output_input=True", model.cin(emb),
                    torch.cat(hs, -1).sum(-1), floor=0.0)
            x0f = x0.reshape(b * d, f)
            want = torch.cat(hs[1:], -1).sum(-1).reshape(-1)
            compare("main-path CIN, interactions only",
                    ck.cin_stack_sum(x0f, ws, output_input=False), want,
                    floor=0.0)
            scale = float(want.abs().max())
            for i, h in enumerate(hs[1:], 1):
                visible(f"layer {i}'s channel sum", h.sum(-1), scale)
        else:
            got = model.cin(emb, sum_channel=False).reshape(b, -1, d)
            got = got.split([h.shape[-1] for h in hs], dim=1)
            for i in range(1, len(hs)):
                compare(f"main-path CIN layer {i}", got[i],
                        hs[i].transpose(1, 2), floor=0.0)

    def check_cin_step(taps, sum_channel: bool) -> None:
        """Training: the CIN backward on the step's own input, weights
        and output gradient."""
        (tap,) = taps
        b, f, d = tap["x"].shape
        x0 = tap["x"].transpose(1, 2).reshape(b * d, f).contiguous()
        w0 = tap["w"]
        if sum_channel:
            g = tap["g"].reshape(-1).contiguous()
            for oi in (True, False):      # the step's call, interactions
                got = ck.cin_stack_sum_bwd(x0, w0, g, oi)
                want = ck.cin_stack_sum_bwd_plain(x0, w0, g, oi)
                compare_all(f"cin_stack_sum_bwd output_input={oi}",
                            [got[0]] + got[1], [want[0]] + want[1])
            # the interactions' dx0 (output_input=False), split into the
            # collapsed last layer's share and layer 1's: each must show
            dx0 = want[0]
            wc = w0[-1].sum(0)
            h1 = ck.cin_flat_plain(x0, x0, w0[0])
            last = g[:, None] * (h1 @ wc.t())
            scale = float(dx0.abs().max())
            visible("dx0: collapsed last layer", last, scale)
            visible("dx0: layer 1 and below", dx0 - last, scale)
        else:
            sizes = [f] + [w.shape[0] for w in w0]
            dcin = tap["g"].reshape(b, sum(sizes), d).transpose(1, 2)
            direct = dcin.reshape(b * d, -1).split(sizes, dim=1)
            hs = [x0]
            for w in w0:
                hs.append(ck.cin_flat_plain(x0, hs[-1], w))
            gk = direct[-1].contiguous()
            for i in range(len(w0), 0, -1):
                got = ck.cin_flat_bwd(x0, hs[i - 1], w0[i - 1], gk)
                want = ck.cin_flat_bwd_plain(x0, hs[i - 1], w0[i - 1], gk)
                # dx0, dprev and dW are one term each, held at their
                # own scale
                compare_all(f"cin_flat_bwd layer {i}", got, want)
                if i > 1:
                    gk = (direct[i - 1] + want[1]).contiguous()

    def check_banks_step(taps) -> None:
        """Training: each multi-expert dense call on the step's own input
        and weights."""
        if len(taps) != 6:
            fail(f"{len(taps)} multi-dense calls in a step, expected 6")
        for i, tap in enumerate(taps):
            x = tap["x"] if tap["x"].dim() == 3 else tap["x"][None]
            (w, bias), relu = tap["w"], tap["mod"].activation == "relu"
            want = mk.multi_dense_xla(x, w, bias, "relu" if relu else None)
            compare(f"multi_dense call {i} ({tuple(x.shape)} x "
                    f"{tuple(w.shape)}, relu={relu})",
                    mk.multi_dense_fused(x, w, bias, relu), want, floor=0.0)
            # the same call through the kernel's other paths: x off the
            # 16-byte grid (4-byte copies), and a shared input as one copy
            # per expert (the tile, where the gate kernel took the call)
            others = [("x misaligned", misaligned(x))]
            if x.shape[0] == 1 and w.shape[0] > 1:
                others.append(("x per expert", x.expand(
                    w.shape[0], -1, -1).contiguous()))
            for what, xo in others:
                compare(f"multi_dense call {i}, {what}",
                        mk.multi_dense_fused(xo, w, bias, relu), want,
                        floor=0.0)
            visible(f"call {i}'s product",
                    mk.multi_dense_xla(x, w, None, None),
                    float(want.abs().max()))
            if relu and not ((want == 0).any() and (want > 0).any()):
                fail(f"call {i}'s ReLU cuts nothing or everything")

    def xdeepfm(sum_channel: bool):
        return lambda device: XDeepFMModel(fc, cin_sum_channel=sum_channel,
                                           device=device, seed=0)

    # every path the port runs; launches are per request and per step:
    # each request and step looks its rows up (B11), each step's dense
    # update scatters their gradients into the buffer (B12)
    LOOKUP = {"gather_rows": 1}
    UPDATE = {"gather_rows": 1, "scatter_add_rows": 1}
    cfg3 = TrainerConfig(pointwise_weight=1.0, pairwise_weight=1.0,
                         click_occurance_power=-0.5)
    runs = (
        dict(what="config 3, cin_sum_channel=True", make=xdeepfm(True),
             heads=None, reqs=rng_batches[:5] + [small],
             serve={"cin_stack_sum": 1, **LOOKUP}, check_serve=check_cin,
             cfg=cfg3, keys={"loss", "pointwise", "pairwise"},
             taps=lambda m: [m.cin],
             check_step=lambda taps: check_cin_step(taps, True),
             train={"cin_stack_sum": 1, "cin_stack_sum_bwd": 1,
                    "pair_loss_sum": 1, "adagrad_dense_pass": 1, **UPDATE},
             steps=(2, 10)),
        dict(what="config 3, cin_sum_channel=False", make=xdeepfm(False),
             heads=None, reqs=rng_batches[5:6] + [small],
             serve={"cin_flat": 2, **LOOKUP}, check_serve=check_cin,
             cfg=cfg3, keys={"loss", "pointwise", "pairwise"},
             taps=lambda m: [m.cin],
             check_step=lambda taps: check_cin_step(taps, False),
             train={"cin_flat": 2, "cin_flat_bwd": 2, "pair_loss_sum": 1,
                    "adagrad_dense_pass": 1, **UPDATE},
             steps=(1, 3)),
        dict(what="config 4 (MultiTaskModel)",
             make=lambda device: MultiTaskModel(fc, device=device, seed=0),
             heads=2, reqs=rng_batches[:5] + [small],
             serve={"multi_dense": 6, **LOOKUP}, check_serve=None,
             cfg=TrainerConfig(pointwise_weight=1.0, listwise_weight=0.5,
                               num_tasks=2),
             keys={"loss", "pointwise", "listwise", "cvr_loss"},
             taps=lambda m: [x for x in m.modules()
                             if isinstance(x, MultiDenseLayer)],
             check_step=check_banks_step,
             train={"multi_dense": 6, "listwise_loss_sum": 1,
                    "adagrad_dense_pass": 1, **UPDATE},
             steps=(2, 10)),
        dict(what="config 2 (DCNv2Model) + lazy Adam",
             make=lambda device: DCNv2Model(fc, device=device, seed=0),
             heads=None, reqs=rng_batches[:5] + [small], serve=LOOKUP,
             check_serve=None,
             cfg=TrainerConfig(pointwise_weight=1.0, pairwise_weight=0.5,
                               click_occurance_power=-0.5,
                               sparse_optimizer="adam", sparse_lr=1e-3),
             keys={"loss", "pointwise", "pairwise"}, taps=lambda m: [],
             check_step=lambda taps: None,
             train={"pair_loss_sum": 1, "adam_dense_pass": 1, **UPDATE},
             steps=(2, 10)))

    # -- 4. serve at full width ----------------------------------------------
    def serve(run) -> None:
        """The run's model through build_scorer and WireScorer u8/f16:
        launches per request, logits' shape and finiteness, wire vs raw;
        then (the counts read) the model's own check and the card against
        the same model and table on the CPU."""
        what, reqs = run["what"], run["reqs"]
        model = run["make"](dev)
        state = ServingState(dict(model.named_parameters()), table_t)
        fronts = {"raw": build_scorer(model, fc, table, device=dev),
                  "u8": WireScorer(model, fc, table, "u8", device=dev),
                  "f16": WireScorer(model, fc, table, "f16", device=dev)}
        for fn in fronts.values():                 # warm-up, not counted
            fn(state, reqs[0].dense, reqs[0].sparse_ids)
        torch.cuda.synchronize()

        def requests():
            times, outs = {k: [] for k in fronts}, []
            for batch in reqs:
                out = {}
                for name, fn in fronts.items():
                    t0 = time.perf_counter()
                    out[name] = fn(state, batch.dense, batch.sparse_ids)
                    torch.cuda.synchronize()
                    if len(batch.dense) == 8192:
                        times[name].append((time.perf_counter() - t0) * 1e3)
                outs.append(out)
            return times, outs

        calls = len(reqs) * len(fronts)
        times, outs = counted(f"serve {what}, {calls} requests", calls,
                              run["serve"], requests)
        for batch, out in zip(reqs, outs):
            raw, b = out["raw"], len(batch.dense)
            shape = (run["heads"], b) if run["heads"] else (b,)
            if tuple(raw.shape) != shape or not torch.isfinite(raw).all():
                fail(f"{what}: bad logits {tuple(raw.shape)}, expected "
                     f"{shape}")
            for mode, tol in (("f16", 2e-3), ("u8", 3e-2)):
                e = float((out[mode] - raw).abs().max())
                if e > tol:
                    fail(f"{what}: {mode} wire differs from raw by {e} > "
                         f"{tol}")
        for name, ts in times.items():
            ms = statistics.median(ts)
            print(f"  {name}: {ms:.3f} ms/request (median of {len(ts)}) "
                  f"{8192 / ms * 1e3:.0f} examples/s at B=8192 [{card}]")
        if run["check_serve"]:
            with torch.inference_mode():
                run["check_serve"](model, reqs[0])
        cpu_model = run["make"]("cpu")
        cpu_state = ServingState(dict(cpu_model.named_parameters()),
                                 cpu_table_t)
        score = build_scorer(cpu_model, fc, cpu_table, device="cpu")
        for batch, out in ((reqs[0], outs[0]), (reqs[-1], outs[-1])):
            want = score(cpu_state, batch.dense, batch.sparse_ids)
            e = float((out["raw"].cpu() - want).abs().max())
            print(f"  B={len(batch.dense)} card vs CPU plain: max_abs_err "
                  f"{e:.3e} max|logit| {float(want.abs().max()):.3e}")
            if e > REL_TOL * max(1.0, float(want.abs().max())):
                fail(f"{what}: card logits disagree with the CPU reference")

    for run in runs:
        serve(run)

    # -- 5. one training step: card vs CPU, kernels on its own tensors -------
    step_batch = next(data.batches(2048, 1, seed=3))

    def one_step(run, device, cfg=None):
        """The run's first step on ``device`` from the seed's weights and
        table (``cfg`` in place of the run's own); returns what it saw and
        produced: the logits, each tapped module's input, weights before
        the step and output gradient, the table's ids and gradients, the
        metrics, grads, params and state."""
        model = run["make"](device)
        trainer = Trainer(model, fc, cfg or run["cfg"], device=device)
        state = trainer.init(None, table=trainer.table.state_from(
            table_t.to(device, copy=True)))
        seen = {"taps": []}

        def on_model(mod, args, out):
            seen["logits"] = out.detach()

        def on_tap(mod, args, out):
            tap = {"mod": mod, "x": args[0].detach(),
                   "w": [p.detach().clone() for p in mod.parameters()]}
            out.register_hook(lambda g: tap.__setitem__("g", g))
            seen["taps"].append(tap)

        apply = trainer.table.apply_grads

        def record_apply(st, ids, grads, lr):
            seen["gids"], seen["demb"] = ids, grads
            return apply(st, ids, grads, lr)

        trainer.table.apply_grads = record_apply
        hooks = [model.register_forward_hook(on_model)] + [
            m.register_forward_hook(on_tap) for m in run["taps"](model)]
        state, metrics = trainer.train_step(state, *trainer.put(step_batch))
        for h in hooks:
            h.remove()
        seen["metrics"] = {k: float(v) for k, v in metrics.items()}
        seen["grads"] = {n: p.grad for n, p in state.params.items()}
        seen["params"] = {n: p.detach() for n, p in state.params.items()}
        seen["state"] = state
        return seen

    def check_step(run) -> None:
        cfg = run["cfg"]
        print(f"first step, {run['what']}, B=2048: card vs CPU plain")
        card, cpu = one_step(run, dev), one_step(run, "cpu")
        if set(cpu["metrics"]) != run["keys"]:
            fail(f"{run['what']}: metrics {sorted(cpu['metrics'])}")
        for key, want in cpu["metrics"].items():
            got = card["metrics"][key]
            print(f"  {key}: card {got:.7f} cpu {want:.7f}")
            if not math.isfinite(got) or abs(got - want) > REL_TOL * abs(
                    want):
                fail(f"first-step {key} {got} != CPU {want}")
        for name, want in cpu["grads"].items():
            got = card["grads"][name]
            if got is None:
                fail(f"no gradient reached {name} on the card")
            compare(f"grad {name}", got.cpu(), want, floor=0.0, rel=1e-3)
        for name, want in cpu["params"].items():
            compare(f"{name} after Adam", card["params"][name].cpu(), want)
        # an accumulator grows by mean g^2 on 0.1, often by less than an
        # f32 ulp (7.5e-9): held to a few ulps of 0.1
        acc_tol = 2.0 ** -22
        adam = cfg.sparse_optimizer == "adam"
        rows = torch.unique(cpu["gids"])
        parts = ((("table", REL_TOL), ("m", REL_TOL), ("v", REL_TOL)) if adam
                 else (("table", REL_TOL), ("accumulator", acc_tol)))
        for what, rel in parts:
            got = getattr(card["state"].table, what)[rows.to(dev)].cpu()
            want = getattr(cpu["state"].table, what)[rows]
            compare(f"{len(rows)} touched rows' {what}", got, want, 0.0, rel)
        if adam and not int(card["state"].table.count) == int(
                cpu["state"].table.count) == 1:
            fail("the Adam count is not 1 after the first step")

        print("  the kernels on this step's own tensors (card):")
        run["check_step"](card["taps"])
        # task 0's logits drive the ranking loss
        logits = card["logits"]
        logits = (logits[0] if logits.dim() == 2 else logits).contiguous()
        labels = torch.as_tensor(step_batch.labels, device=dev)
        groups = torch.as_tensor(step_batch.group_ids, device=dev)
        if cfg.pairwise_weight:
            name = "pair_loss_sum"
            power = cfg.click_occurance_power
            got = pk.pair_loss_fused(logits, labels, groups, 1.0, power)
            want = pk.pair_loss_fused_plain(logits, labels, groups, 1.0,
                                            power)
        else:
            name = "listwise_loss_sum"
            got = lk.listwise_loss_fused(logits, labels, groups)
            want = lk.listwise_loss_fused_plain(logits, labels, groups)
        if float(got[1]) != float(want[1]) or float(want[1]) == 0:
            fail(f"{name} count {float(got[1])} vs plain {float(want[1])}")
        print(f"    {name}: count {int(want[1])}")
        compare_all(f"{name} (loss, count, dlogits)", got, want)
        gids = card["gids"].reshape(-1)
        dense_g = torch.zeros_like(table_t)
        dense_g.index_add_(0, gids, card["demb"].reshape(-1, fc.embedding_dim))
        rows = torch.unique(gids)
        st0 = ShardedEmbeddingTable(
            fc.total_rows, fc.embedding_dim, device=dev,
            optimizer=cfg.sparse_optimizer).state_from(table_t)
        if adam:
            touched = torch.zeros(len(table_t), dtype=torch.bool, device=dev)
            touched.index_fill_(0, gids, True)
            cnt = torch.ones((), dtype=torch.int32, device=dev)
            got = [table_t.clone(), st0.m.clone(), st0.v.clone()]
            want = [x.clone() for x in got]
            tk.adam_dense_pass(*got, dense_g, touched, cnt, cfg.sparse_lr)
            tk.adam_dense_pass_plain(*want, dense_g, touched, cnt,
                                     cfg.sparse_lr, 0.9, 0.999, 1e-7)
            for name, a, b, old in zip(("rows", "m", "v"), got, want,
                                       (table_t, st0.m, st0.v)):
                compare(f"adam_dense_pass updated {name}", a[rows], b[rows],
                        0.0)
                visible(f"the {name}' update", b[rows] - old[rows],
                        float(b[rows].abs().max()))
            # the same step through the sparse path, on the card
            sparse = one_step(run, dev, dataclasses.replace(
                cfg, sparse_update_mode="sparse"))
            for what in ("table", "m", "v"):
                compare(f"sparse vs dense update: touched rows' {what}",
                        getattr(sparse["state"].table, what)[rows],
                        getattr(card["state"].table, what)[rows], 0.0)
            return
        tb, ac = table_t.clone(), st0.accumulator.clone()
        t2, a2 = tb.clone(), ac.clone()
        tk.adagrad_dense_pass(tb, ac, dense_g, cfg.sparse_lr)
        tk.adagrad_dense_pass_plain(t2, a2, dense_g, cfg.sparse_lr)
        compare("adagrad_dense_pass updated rows", tb[rows], t2[rows], 0.0)
        visible("the rows' update", t2[rows] - table_t[rows],
                float(t2[rows].abs().max()))
        compare("adagrad_dense_pass accumulators", ac[rows], a2[rows], 0.0,
                rel=acc_tol)
        visible("the accumulators' increase",
                a2[rows] - st0.accumulator[rows],
                float(a2[rows].abs().max()), rel=acc_tol)

    for run in runs:
        check_step(run)

    # -- 6. train at full width ----------------------------------------------
    batches = list(data.batches(8192, 13, seed=5))

    def train(run) -> None:
        """Warm-up steps, then timed steps (host clock, each ending in a
        synchronize) with exact launches; every loss finite and > 0."""
        (warm, timed), what = run["steps"], run["what"]
        model = run["make"](dev)
        trainer = Trainer(model, fc, run["cfg"], device=dev)
        state = trainer.init(torch.Generator().manual_seed(1))
        for batch in batches[:warm]:
            state, _ = trainer.train_step(state, *trainer.put(batch))
        torch.cuda.synchronize()

        def steps(state):
            times, metrics = [], []
            for batch in batches[warm:warm + timed]:
                t0 = time.perf_counter()
                state, m = trainer.train_step(state, *trainer.put(batch))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                metrics.append(m)
            return times, metrics

        times, metrics = counted(
            f"train {what}: {warm} warm-up + {timed} timed steps at B=8192",
            timed, run["train"], lambda: steps(state))
        for name, per in run["train"].items():
            kern[name]["launches_per_step"] = per
        for i, m in enumerate(metrics):
            vals = {k: float(x) for k, x in m.items()}
            print(f"  step {warm + i}: " + " ".join(
                f"{k} {v:.6f}" for k, v in sorted(vals.items()))
                + f" {times[i]:.3f} ms")
            if set(vals) != run["keys"] or not all(
                    math.isfinite(x) and x > 0 for x in vals.values()):
                fail(f"{what}: step {warm + i} has a bad loss {vals}")
        ms = statistics.median(times)
        print(f"  {ms:.3f} ms/step (median of {timed}), {8192 / ms * 1e3:.0f}"
              f" examples/s at B=8192 [{card}]")
        # an estimate: phase 3's kernel times (its own inputs, timed
        # alone) against this step; profile_training measures the step's
        # own device times
        parts = {name: kern[name]["ms"] * per / MS_COVERS.get(name, 1)
                 for name, per in run["train"].items()}
        print("    split estimated from phase 3's kernel times:")
        for name, t in parts.items():
            print(f"    {name}: ~{t:.4f} ms = ~{t / ms:.1%} of the step")
        print(f"    rest (host, library calls, copies): "
              f"~{ms - sum(parts.values()):.4f} ms = "
              f"~{1 - sum(parts.values()) / ms:.1%}")

    for run in runs:
        train(run)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")

    # -- 7. the public pairwise loss as an entry point ------------------------
    lb = next(data.batches(8192, 1, seed=7))
    x_cpu = torch.randn(8192, generator=gen) * 2
    mask_cpu = (torch.rand(8192, generator=gen) > 0.1).float()
    groups2 = [torch.as_tensor(lb.group_ids), torch.as_tensor(lb.domain_idx)]
    entry_cases = (
        ("graded labels, 2 groups, mask, power -0.5", False,
         torch.as_tensor(lb.labels + lb.cvr_labels), groups2, False,
         {"pair_row_counts": 1, "same_group_matvec": 1, "pair_loss_sum": 1}),
        ("the same with the wrong-order filter", True,
         torch.as_tensor(lb.labels + lb.cvr_labels), groups2, False,
         {"pair_row_counts": 1, "same_group_matvec": 1, "pair_loss_sum": 1}),
        ("binary labels, 1 group, binary_labels=True", False,
         torch.as_tensor(lb.labels), groups2[:1], True,
         {"pair_loss_sum": 1}))
    for what, wrong, labels, groups, binary, per in entry_cases:
        out = {}
        for d in (dev, "cpu"):
            xd = x_cpu.to(d).requires_grad_()

            def call():
                loss, cnt = pairwise_loss(
                    xd, labels.to(d), [g.to(d) for g in groups],
                    only_use_wrong_order_pair=wrong, return_num_pair=True,
                    click_occurance_power=-0.5, mask=mask_cpu.to(d),
                    binary_labels=binary)
                return (loss,) + (cnt,) + torch.autograd.grad(loss, xd)

            out[d] = (counted(f"pairwise_loss B=8192, {what}", 1, per, call)
                      if d == dev else call())
        got, want = out[dev], out["cpu"]
        if float(got[1]) != float(want[1]) or float(want[1]) == 0:
            fail(f"pairwise_loss {what}: count {float(got[1])} vs CPU "
                 f"{float(want[1])}")
        print(f"  {int(want[1])} pairs; loss card {float(got[0]):.7f} cpu "
              f"{float(want[0]):.7f}")
        compare(f"pairwise_loss {what}: loss", got[0].detach().cpu(),
                want[0].detach(), 0.0)
        compare(f"pairwise_loss {what}: dlogits", got[2].cpu(), want[2],
                0.0)
    lab_d = torch.as_tensor(lb.labels, device=dev)
    g_d, m_d = groups2[0].to(dev), mask_cpu.to(dev)
    gpc = counted("group_pair_counts_binary B=8192", 1,
                  {"group_pair_counts_binary": 1},
                  lambda: pk.group_pair_counts_binary(g_d, lab_d, m_d))
    via = pk.same_group_matvec(g_d, pk.pair_row_counts(x_cpu.to(dev), lab_d,
                                                       g_d, m_d))
    compare("group_pair_counts_binary vs pair_row_counts -> "
            "same_group_matvec", gpc, via, 0.0, rel=0.0)
    if not float(gpc.max()) > 0:
        fail("group_pair_counts_binary found no pair")

    # -- 8. the training entry point ------------------------------------------
    train_cli_phase(torch, counted, card)

    # -- 9. result ------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_per_step")
    print(json.dumps({"kernels": [{k: v[k] for k in keys}
                                  for v in kern.values()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
