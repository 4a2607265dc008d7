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
   and on degenerate ones) and at ragged shapes, and time kernel, plain
   version and, where one exists, a single PyTorch call computing the
   same function (CUDA events, median of 20);
Phases 4-6 go through one table of runs, the port's paths: config 3
(xDeepFM: 26 x 100,000 x 16 table on the card, CIN (64, 64), deep
(256, 128), ``TrainerConfig(pairwise_weight=1.0,
click_occurance_power=-0.5)``) with the channel-summed CIN
(``cin_stack_sum``) and with ``cin_sum_channel=False`` (``cin_flat``),
then config 4 (``MultiTaskModel()``, MMoE + PLE + STAR towers,
``TrainerConfig(pointwise_weight=1.0, listwise_weight=0.5,
num_tasks=2)``).  Each run names its model, trainer config, loss keys,
the launches it expects per request and per step, and its own kernel
checks.  Every serving or training loop sets all eight launch counts to
0 just before it and reads them just after, and fails unless each is
exact (0 for a kernel the run does not name).

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
   accumulators; then each kernel on that step's own tensors against its
   plain version, relative to that output's scale, failing unless each
   compared quantity is larger than its tolerance: the CIN backward's dx0
   and dW of every layer, or the six multi-expert dense calls; the
   ranking loss's dlogits (pair or listwise); the updated rows;
6. train each run at full width (B = 8192): warm-up steps, then timed
   steps (host clock, each ending in ``torch.cuda.synchronize()``);
   every loss finite and > 0; the step is split into each kernel's time
   as phase 3 measured it (an estimate: ``profile_training`` gives the
   step's own device times);
7. print one JSON line for the kernels, the card again, and finally
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# f32 kernel vs plain f32 einsum: the same products summed in another
# order over up to F * H = 1,664 terms per channel (and, for the weight
# gradients, over M = 131,072 rows in 1,024-row slices).
REL_TOL = 1e-4
CIN_TPU = "rec_now_tpu/ops/pallas/cin_kernel.py"
PAIR_TPU = "rec_now_tpu/ops/pallas/pairwise_kernel.py"
TABLE_TPU = "rec_now_tpu/ops/pallas/table_update_kernel.py"
MD_TPU = "rec_now_tpu/ops/pallas/multi_dense_kernel.py"
LW_TPU = "rec_now_tpu/ops/pallas/listwise_kernel.py"
# config 4's six multi-expert dense launches per forward at B = 8192:
# (name, inputs' leading dim, experts, D, U, ReLU, launches)
MD_BANKS = (("MMoE experts layer 0", 1, 4, 429, 128, True, 1),
            ("MMoE experts layer 1", 4, 4, 128, 64, False, 1),
            ("MMoE gates", 1, 2, 429, 4, False, 1),
            ("PLE experts", 1, 2, 128, 64, False, 3))
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


def pair_ops(labels, groups) -> int:
    """Least operations of the fused pair loss on this batch: one group
    test per (i, j), two counts per same-group pair (the occurrence
    weight), and per valid pair the gap, softplus (exp, log1p, max, add),
    sigmoid (exp, add, divide) and four weighted sums: 12."""
    import numpy as np
    _, inv = np.unique(groups, return_inverse=True)
    tot = np.bincount(inv)
    pos = np.bincount(inv, weights=labels)
    b = len(labels)
    return int(b * b + 2 * (tot ** 2).sum() + 12 * (pos * (tot - pos)).sum())


def multi_dense_work(nx: int, n: int, b: int, d: int, u: int):
    """(FLOPs, bytes) of one multi-expert dense launch: a multiply-add per
    (expert, row, d, unit), the bias add; x read once (a shared input
    once for all experts), W and bias read, the output written."""
    return (2 * n * b * d * u + n * b * u,
            (nx * b * d + n * d * u + n * u + n * b * u) * 4)


def listwise_ops(labels) -> int:
    """Least operations of the fused listwise loss on this batch: one
    group test per (i, j); per sample, once in its group's softmax, the
    running max's compare, the exp, the exp-sum add, the label-sum add,
    the label * logit multiply-add and the two flag tests (7), its share
    of its group's log and loss (at most 1), and its gradient (the
    softmax's exp and divide, p's divide, the subtract: 4): 12."""
    b = len(labels)
    return int(b * b + 12 * b)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.layers.multi_dense_layer import MultiDenseLayer
    from rec_now_tpu_torch.models import (FeatureConfig, MultiTaskModel,
                                          XDeepFMModel)
    from rec_now_tpu_torch.ops import _build, cin_kernel as ck
    from rec_now_tpu_torch.ops import listwise_kernel as lk
    from rec_now_tpu_torch.ops import multi_dense_kernel as mk
    from rec_now_tpu_torch.ops import pairwise_kernel as pk
    from rec_now_tpu_torch.ops import table_update_kernel as tk
    from rec_now_tpu_torch.ops.cin_op import cin_contract_plain
    from rec_now_tpu_torch.serving import (ServingState, WireScorer,
                                           build_scorer)
    from rec_now_tpu_torch.embedding.sharded import (INITIAL_ACCUMULATOR,
                                                     ShardedTableState)
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
    err, t = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0,
                       nbytes=0)
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
        print(f"  {name}: {ms:.4f} ms kernel, {pms:.4f} ms plain, "
              f"{lms:.4f} ms torch.baddbmm, bound "
              f"{bound_ms(fl, nb)[0]:.4f} ms, x{times} per forward")
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       ("flops", fl), ("nbytes", nb)):
            t[key] += times * v
    for nx, n, b, d, u in ((1, 4, 1, 429, 128), (4, 4, 1000, 128, 64),
                           (1, 2, 1000, 429, 4), (1, 3, 777, 77, 17),
                           (3, 3, 1001, 45, 200), (1, 1, 1, 13, 5)):
        x = rand(nx, b, d)
        w, bias = rand(n, d, u, scale=d ** -0.5), rand(n, 1, u)
        for relu in (True, False):
            err = max(err, compare(
                f"ragged ({nx}, {b}, {d}) x ({n}, {d}, {u}) relu={relu}",
                mk.multi_dense_fused(x, w, bias, relu),
                mk.multi_dense_xla(x, w, bias, "relu" if relu else None),
                floor=0.0))
    b_ms, b_by = bound_ms(t["flops"], t["nbytes"])
    print(f"  one forward's six launches: {t['flops'] / 1e9:.3f} GFLOP, "
          f"{t['nbytes'] / 1e6:.1f} MB")
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
    for v in kern.values():
        print(f"  {v['name']}: {v['ms']:.4f} ms kernel, {v['plain_ms']:.4f} "
              f"ms plain, library {v['library_ms']}, bound {v['bound_ms']:.4f}"
              f" ms ({v['bound_by']}) at full width [{card}]")
    del x0, ws, xr, pr, g, gr, tb, ac, dg, t2, a2, x, xe, w, bias
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
               "listwise_loss_sum": lk.listwise_loss_sum}
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
            visible(f"call {i}'s product",
                    mk.multi_dense_xla(x, w, None, None),
                    float(want.abs().max()))
            if relu and not ((want == 0).any() and (want > 0).any()):
                fail(f"call {i}'s ReLU cuts nothing or everything")

    def xdeepfm(sum_channel: bool):
        return lambda device: XDeepFMModel(fc, cin_sum_channel=sum_channel,
                                           device=device, seed=0)

    # every path the port runs; launches are per request and per step
    cfg3 = TrainerConfig(pointwise_weight=1.0, pairwise_weight=1.0,
                         click_occurance_power=-0.5)
    runs = (
        dict(what="config 3, cin_sum_channel=True", make=xdeepfm(True),
             heads=None, reqs=rng_batches[:5] + [small],
             serve={"cin_stack_sum": 1}, check_serve=check_cin,
             cfg=cfg3, keys={"loss", "pointwise", "pairwise"},
             taps=lambda m: [m.cin],
             check_step=lambda taps: check_cin_step(taps, True),
             train={"cin_stack_sum": 1, "cin_stack_sum_bwd": 1,
                    "pair_loss_sum": 1, "adagrad_dense_pass": 1},
             steps=(2, 10)),
        dict(what="config 3, cin_sum_channel=False", make=xdeepfm(False),
             heads=None, reqs=rng_batches[5:6] + [small],
             serve={"cin_flat": 2}, check_serve=check_cin,
             cfg=cfg3, keys={"loss", "pointwise", "pairwise"},
             taps=lambda m: [m.cin],
             check_step=lambda taps: check_cin_step(taps, False),
             train={"cin_flat": 2, "cin_flat_bwd": 2, "pair_loss_sum": 1,
                    "adagrad_dense_pass": 1},
             steps=(1, 3)),
        dict(what="config 4 (MultiTaskModel)",
             make=lambda device: MultiTaskModel(fc, device=device, seed=0),
             heads=2, reqs=rng_batches[:5] + [small],
             serve={"multi_dense": 6}, check_serve=None,
             cfg=TrainerConfig(pointwise_weight=1.0, listwise_weight=0.5,
                               num_tasks=2),
             keys={"loss", "pointwise", "listwise", "cvr_loss"},
             taps=lambda m: [x for x in m.modules()
                             if isinstance(x, MultiDenseLayer)],
             check_step=check_banks_step,
             train={"multi_dense": 6, "listwise_loss_sum": 1,
                    "adagrad_dense_pass": 1},
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
    tstate0 = ShardedTableState(table_t, torch.full(
        (fc.total_rows,), INITIAL_ACCUMULATOR, device=dev))
    step_batch = next(data.batches(2048, 1, seed=3))

    def one_step(run, device):
        """The run's first step on ``device`` from the seed's weights and
        table; returns what it saw and produced: the logits, each tapped
        module's input, weights before the step and output gradient, the
        table's ids and gradients, the metrics, grads, params and state."""
        model = run["make"](device)
        trainer = Trainer(model, fc, run["cfg"], device=device)
        state = trainer.init(None, table=ShardedTableState(
            tstate0.table.to(device, copy=True),
            tstate0.accumulator.to(device, copy=True)))
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
        rows = torch.unique(cpu["gids"])
        for what, rel in (("table", REL_TOL), ("accumulator", acc_tol)):
            got = getattr(card["state"].table, what)[rows.to(dev)].cpu()
            want = getattr(cpu["state"].table, what)[rows]
            compare(f"{len(rows)} touched rows' {what}", got, want, 0.0, rel)

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
        dense_g = torch.zeros_like(tstate0.table)
        dense_g.index_add_(0, card["gids"].reshape(-1),
                           card["demb"].reshape(-1, fc.embedding_dim))
        tb, ac = tstate0.table.clone(), tstate0.accumulator.clone()
        t2, a2 = tb.clone(), ac.clone()
        tk.adagrad_dense_pass(tb, ac, dense_g, cfg.sparse_lr)
        tk.adagrad_dense_pass_plain(t2, a2, dense_g, cfg.sparse_lr)
        rows = torch.unique(card["gids"])
        compare("adagrad_dense_pass updated rows", tb[rows], t2[rows], 0.0)
        visible("the rows' update", t2[rows] - tstate0.table[rows],
                float(t2[rows].abs().max()))
        compare("adagrad_dense_pass accumulators", ac[rows], a2[rows], 0.0,
                rel=acc_tol)
        visible("the accumulators' increase",
                a2[rows] - tstate0.accumulator[rows],
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

    # -- 7. result -------------------------------------------------------------
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
