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
   the 2.6M x 16 table) and at ragged shapes, and time kernel, plain
   version and, where one exists, a single PyTorch call computing the
   same function (CUDA events, median of 20);
4. serve xDeepFM at full width (26 x 100,000 x 16 table on the card,
   CIN (64, 64), deep (256, 128)) through ``build_scorer`` and
   ``WireScorer`` (u8, f16), first with the channel-summed CIN
   (``cin_stack_sum``), then with ``cin_sum_channel=False``
   (``cin_flat``), counting kernel launches over each run; logits are
   checked for shape and finiteness, wire against raw, and against the
   same model run on the CPU through the plain versions; the CIN layer's
   output on the run's own embeddings is held against its plain version
   relative to that output's scale (the table's +-1e-3 rows make the CIN
   terms too small to show in the logits), and the check fails if it
   could not see any one layer;
5. one training step of config 3 (``TrainerConfig(pairwise_weight=1.0,
   click_occurance_power=-0.5)``, B = 2048, full-width model and table)
   on the card against the same step on the CPU through the plain
   versions, for both CIN modes: the losses, every gradient and every
   param after Adam, the touched rows and accumulators; then each new
   kernel on that step's own tensors (the CIN backward's dx0 and dW of
   every layer, the pair loss's dlogits, the updated rows) against its
   plain version, relative to that output's scale, failing unless each
   compared quantity is larger than its tolerance;
6. train config 3 at full width (B = 8192): warm-up steps, then timed
   steps (host clock, each ending in ``torch.cuda.synchronize()``) with
   ``cin_sum_channel=True``, then with ``False``; every step's loss,
   pointwise and pairwise apart, must be finite; the kernels' launches
   per step must be exact; the step is split into each kernel's time as
   phase 3 measured it (an estimate: ``profile_training`` gives the
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
    from rec_now_tpu_torch.models import FeatureConfig, XDeepFMModel
    from rec_now_tpu_torch.ops import _build, cin_kernel as ck
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
    for v in kern.values():
        print(f"  {v['name']}: {v['ms']:.4f} ms kernel, {v['plain_ms']:.4f} "
              f"ms plain, library {v['library_ms']}, bound {v['bound_ms']:.4f}"
              f" ms ({v['bound_by']}) at config 3 [{card}]")
    del x0, ws, xr, pr, g, gr, tb, ac, dg, t2, a2
    torch.cuda.empty_cache()

    # -- 4. serve xDeepFM at full width --------------------------------------
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

    def check_cin(model, batch) -> None:
        """The CIN layer on this run's embeddings: kernel vs plain."""
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
            tol = REL_TOL * float(want.abs().max())
            for i, h in enumerate(hs[1:], 1):
                seen = float(h.sum(-1).abs().max())
                print(f"    layer {i}: max|channel sum| {seen:.3e} = "
                      f"{seen / tol:.1f} x tol")
                if seen <= tol:
                    fail(f"the CIN check cannot see layer {i}")
        else:
            got = model.cin(emb, sum_channel=False).reshape(b, -1, d)
            got = got.split([h.shape[-1] for h in hs], dim=1)
            for i in range(1, len(hs)):
                compare(f"main-path CIN layer {i}", got[i],
                        hs[i].transpose(1, 2), floor=0.0)

    def check_cpu(sum_channel: bool, batch, logits) -> None:
        """Card logits vs the same model and table on the CPU."""
        cpu_model = XDeepFMModel(fc, cin_sum_channel=sum_channel,
                                 device="cpu", seed=0)
        state = ServingState(dict(cpu_model.named_parameters()),
                             cpu_table_t)
        want = build_scorer(cpu_model, fc, cpu_table, device="cpu")(
            state, batch.dense, batch.sparse_ids)
        e = float((logits.cpu() - want).abs().max())
        print(f"  B={len(batch.dense)} card vs CPU plain: max_abs_err "
              f"{e:.3e} max|logit| {float(want.abs().max()):.3e}")
        if e > REL_TOL * max(1.0, float(want.abs().max())):
            fail("card logits disagree with the CPU reference")

    def serve(sum_channel: bool, kernel, per_call: int, reqs):
        model = XDeepFMModel(fc, cin_sum_channel=sum_channel, device=dev,
                             seed=0)
        state = ServingState(dict(model.named_parameters()), table_t)
        fronts = {"raw": build_scorer(model, fc, table, device=dev),
                  "u8": WireScorer(model, fc, table, "u8", device=dev),
                  "f16": WireScorer(model, fc, table, "f16", device=dev)}
        for fn in fronts.values():                 # warm-up, not counted
            fn(state, reqs[0].dense, reqs[0].sparse_ids)
        torch.cuda.synchronize()
        ck.cin_stack_sum.launches = 0
        ck.cin_flat.launches = 0
        times = {k: [] for k in fronts}
        outs = []
        for batch in reqs:
            out = {}
            for name, fn in fronts.items():
                t0 = time.perf_counter()
                out[name] = fn(state, batch.dense, batch.sparse_ids)
                torch.cuda.synchronize()
                if len(batch.dense) == 8192:
                    times[name].append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        launches = kernel.launches
        calls = len(reqs) * len(fronts)
        print(f"serve cin_sum_channel={sum_channel}: {calls} requests, "
              f"{kernel.__name__} launches {launches}")
        if launches != per_call * calls:
            fail(f"{kernel.__name__} launched {launches} times for "
                 f"{calls} requests")
        for batch, out in zip(reqs, outs):
            raw = out["raw"]
            if raw.shape != (len(batch.dense),) or not torch.isfinite(
                    raw).all():
                fail(f"bad logits {tuple(raw.shape)}")
            for mode, tol in (("f16", 2e-3), ("u8", 3e-2)):
                e = float((out[mode] - raw).abs().max())
                if e > tol:
                    fail(f"{mode} wire differs from raw by {e} > {tol}")
        for name, ts in times.items():
            ms = statistics.median(ts)
            print(f"  {name}: {ms:.3f} ms/request (median of {len(ts)}) "
                  f"{8192 / ms * 1e3:.0f} examples/s at B=8192 [{card}]")
        # after the count was read: these launches are checks, not serving
        with torch.inference_mode():
            check_cin(model, reqs[0])
        check_cpu(sum_channel, reqs[-1], outs[-1]["raw"])
        return launches

    kern["cin_stack_sum"]["launches"] = serve(
        True, ck.cin_stack_sum, 1, rng_batches[:5] + [small])
    kern["cin_flat"]["launches"] = serve(
        False, ck.cin_flat, 2, rng_batches[5:6] + [small])
    # -- 5. one training step: card vs CPU, kernels on its own tensors -------
    cfg = TrainerConfig(pointwise_weight=1.0, pairwise_weight=1.0,
                        click_occurance_power=-0.5)
    tstate0 = ShardedTableState(table_t, torch.full(
        (fc.total_rows,), INITIAL_ACCUMULATOR, device=dev))
    step_batch = next(data.batches(2048, 1, seed=3))

    def one_step(sum_channel: bool, device):
        """Config 3's first step on ``device`` from the seed's weights and
        table; returns what the step saw and produced."""
        model = XDeepFMModel(fc, cin_sum_channel=sum_channel, device=device,
                             seed=0)
        trainer = Trainer(model, fc, cfg, device=device)
        state = trainer.init(None, table=ShardedTableState(
            tstate0.table.to(device, copy=True),
            tstate0.accumulator.to(device, copy=True)))
        seen = {"w0": [w.detach().clone() for w in model.cin.weights()]}

        def on_model(mod, args, out):
            seen["logits"] = out.detach()

        def on_cin(mod, args, out):
            seen["cin_in"] = args[0].detach()
            out.register_hook(lambda g: seen.__setitem__("dcin", g))

        apply = trainer.table.apply_grads

        def record_apply(st, ids, grads, lr):
            seen["gids"], seen["demb"] = ids, grads
            return apply(st, ids, grads, lr)

        trainer.table.apply_grads = record_apply
        hooks = (model.register_forward_hook(on_model),
                 model.cin.register_forward_hook(on_cin))
        state, metrics = trainer.train_step(state, *trainer.put(step_batch))
        for h in hooks:
            h.remove()
        seen["metrics"] = {k: float(v) for k, v in metrics.items()}
        seen["grads"] = {n: p.grad for n, p in state.params.items()}
        seen["params"] = {n: p.detach() for n, p in state.params.items()}
        seen["state"] = state
        return seen

    def check_step(sum_channel: bool) -> None:
        print(f"first step, cin_sum_channel={sum_channel}, B=2048: card vs "
              f"CPU plain")
        card, cpu = one_step(sum_channel, dev), one_step(sum_channel, "cpu")
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
        rows = torch.unique(cpu["gids"])
        for what in ("table", "accumulator"):
            got = getattr(card["state"].table, what)[rows.to(dev)].cpu()
            want = getattr(cpu["state"].table, what)[rows]
            compare(f"{len(rows)} touched rows' {what}", got, want, 0.0)

        print("  the new kernels on this step's own tensors (card):")
        b, f, d = card["cin_in"].shape
        x0 = card["cin_in"].transpose(1, 2).reshape(b * d, f).contiguous()
        w0 = card["w0"]
        if sum_channel:
            g = card["dcin"].reshape(-1).contiguous()
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
            dcin = card["dcin"].reshape(b, sum(sizes), d).transpose(1, 2)
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
        labels = torch.as_tensor(step_batch.labels, device=dev)
        groups = torch.as_tensor(step_batch.group_ids, device=dev)
        got = pk.pair_loss_fused(card["logits"], labels, groups, 1.0, -0.5)
        want = pk.pair_loss_fused_plain(card["logits"], labels, groups, 1.0,
                                        -0.5)
        if float(got[1]) != float(want[1]) or float(want[1]) == 0:
            fail(f"pair count {float(got[1])} vs plain {float(want[1])}")
        compare_all("pair_loss_sum (loss, count, dlogits)", got, want)
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
        # an accumulator grows by mean g^2 on 0.1, often by less than an
        # f32 ulp (7.5e-9): held to a few ulps of 0.1, and the largest
        # increase must be seen at that tolerance
        acc_tol = 2.0 ** -22
        compare("adagrad_dense_pass accumulators", ac[rows], a2[rows], 0.0,
                rel=acc_tol)
        visible("the accumulators' increase",
                a2[rows] - tstate0.accumulator[rows],
                float(a2[rows].abs().max()), rel=acc_tol)

    check_step(True)
    check_step(False)

    # -- 6. train config 3 at full width -------------------------------------
    train_kernels = {
        True: {"cin_stack_sum": (ck.cin_stack_sum, 1),
               "cin_stack_sum_bwd": (ck.cin_stack_sum_bwd, 1),
               "cin_flat": (ck.cin_flat, 0), "cin_flat_bwd": (ck.cin_flat_bwd,
                                                              0)},
        False: {"cin_flat": (ck.cin_flat, 2),
                "cin_flat_bwd": (ck.cin_flat_bwd, 2),
                "cin_stack_sum": (ck.cin_stack_sum, 0),
                "cin_stack_sum_bwd": (ck.cin_stack_sum_bwd, 0)}}
    for per in train_kernels.values():
        per["pair_loss_sum"] = (pk.pair_loss_sum, 1)
        per["adagrad_dense_pass"] = (tk.adagrad_dense_pass, 1)
    for v in kern.values():
        v["launches_per_step"] = 0
    for name in ("cin_stack_sum_bwd", "cin_flat_bwd", "pair_loss_sum",
                 "adagrad_dense_pass"):
        kern[name]["launches"] = 0
    batches = list(data.batches(8192, 13, seed=5))
    for sum_channel, warm, timed in ((True, 2, 10), (False, 1, 3)):
        model = XDeepFMModel(fc, cin_sum_channel=sum_channel, device=dev,
                             seed=0)
        trainer = Trainer(model, fc, cfg, device=dev)
        state = trainer.init(torch.Generator().manual_seed(1))
        for batch in batches[:warm]:
            state, _ = trainer.train_step(state, *trainer.put(batch))
        torch.cuda.synchronize()
        for fn, _ in train_kernels[sum_channel].values():
            fn.launches = 0
        times, metrics = [], []
        for batch in batches[warm:warm + timed]:
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, *trainer.put(batch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        counts = {name: fn.launches
                  for name, (fn, _) in train_kernels[sum_channel].items()}
        print(f"train cin_sum_channel={sum_channel}: {warm} warm-up + "
              f"{timed} timed steps at B=8192, launches {counts}")
        for name, (fn, per_step) in train_kernels[sum_channel].items():
            if counts[name] != per_step * timed:
                fail(f"{name} launched {counts[name]} times in {timed} "
                     f"steps, expected {per_step} per step")
            if per_step:
                kern[name]["launches_per_step"] = per_step
                if name in ("cin_stack_sum_bwd", "cin_flat_bwd",
                            "pair_loss_sum", "adagrad_dense_pass"):
                    kern[name]["launches"] += counts[name]
        for i, m in enumerate(metrics):
            vals = {k: float(x) for k, x in m.items()}
            print(f"  step {warm + i}: loss {vals['loss']:.6f} pointwise "
                  f"{vals['pointwise']:.6f} pairwise {vals['pairwise']:.6f} "
                  f"{times[i]:.3f} ms")
            if not all(math.isfinite(x) and x > 0 for x in vals.values()):
                fail(f"step {warm + i} has a bad loss {vals}")
        ms = statistics.median(times)
        print(f"  {ms:.3f} ms/step (median of {timed}), {8192 / ms * 1e3:.0f}"
              f" examples/s at B=8192 [{card}]")
        # an estimate: phase 3's kernel times (its own inputs, timed
        # alone) against this step; profile_training measures the step's
        # own device times
        parts = {name: kern[name]["ms"] * (per / (2 if name.startswith(
            "cin_flat") else 1))
            for name, (_, per) in train_kernels[sum_channel].items() if per}
        print("    split estimated from phase 3's kernel times:")
        for name, t in parts.items():
            print(f"    {name}: ~{t:.4f} ms = ~{t / ms:.1%} of the step")
        print(f"    rest (host, library calls, copies): "
              f"~{ms - sum(parts.values()):.4f} ms = "
              f"~{1 - sum(parts.values()) / ms:.1%}")
        del model, trainer, state
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
