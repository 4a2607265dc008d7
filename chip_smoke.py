#!/usr/bin/env python3
"""Drive the PyTorch port (``rec_now_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which ends the script with a non-zero exit on failure:

1. print the card (``nvidia-smi`` name and power limit); f32 matmuls and
   convolutions in full f32 (TF32 off);
2. build the package's CUDA source with nvcc (timed);
3. hold each kernel against its plain PyTorch version on the card at the
   xDeepFM config-3 shapes (B = 8192, D = 16, F = 26, CIN (64, 64)) and
   at ragged shapes, and time kernel, plain version and, where one
   exists, a single PyTorch call computing the same function;
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
5. print one JSON line per the kernels, the card again, and finally
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# f32 kernel vs plain f32 einsum: the same products summed in another
# order over up to F * H = 1,664 terms per channel.
REL_TOL = 1e-4
CIN_TPU = "rec_now_tpu/ops/pallas/cin_kernel.py"


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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(name: str, got, want, floor: float = 1.0) -> float:
    """Max |got - want|; fails above REL_TOL * max(floor, max|want|)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = got.shape == want.shape and err <= REL_TOL * max(scale, floor)
    print(f"  {name}: shape {tuple(got.shape)} max_abs_err {err:.3e} "
          f"max|plain| {scale:.3e} max_rel_err {err / max(scale, 1e-30):.3e}"
          f" (tol {REL_TOL:g} of max({floor:g}, max|plain|)) -> "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.models import FeatureConfig, XDeepFMModel
    from rec_now_tpu_torch.ops import _build, cin_kernel as ck
    from rec_now_tpu_torch.ops.cin_op import cin_contract_plain
    from rec_now_tpu_torch.serving import (ServingState, WireScorer,
                                           build_scorer)
    from rec_now_tpu_torch.training.data import SyntheticCriteo

    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("cin")
    print(f"build: {time.perf_counter() - t0:.1f} s for csrc/cin.cu")
    log = _build.library_path("cin").with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas cin: {line.strip()}")

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
    for v in kern.values():
        print(f"  {v['name']}: {v['ms']:.4f} ms kernel, {v['plain_ms']:.4f} "
              f"ms plain, library {v['library_ms']}, bound {v['bound_ms']:.4f}"
              f" ms ({v['bound_by']}) at M={M} [{card}]")
    del x0, ws, xr, pr
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
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")

    # -- 5. result -------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: v[k] for k in keys}
                                  for v in kern.values()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
