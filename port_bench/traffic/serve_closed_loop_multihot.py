"""Serving multi-hot requests in a closed loop with one client, as
``serve_closed_loop`` serves one-hot ones: one outstanding request of the
mix's batch size, scored through ``rec_now_tpu_torch.serving.
build_scorer``; the next is sent when the last one's logits are in host
memory.

A request is (dense (B, num_dense) float32, ids (B, sum(hotness))
int32): field f's ``multi_hot_sizes[f]`` ids side by side, fields in
order, each id uniform over the rows the configuration holds of its
field (``num_embeddings_per_feature``); each dense float log(1 + x), x
exponential of mean ``dense_log_scale``.  The pool is ``pool_requests``
such requests drawn from the seed (:func:`draw_pool`; 32 of 8,192 in the
cell, 224 MB of ids), cycled in order.  On the card a request's arrays
sit in page-locked host memory, as a serving front end stages requests
before their copy to the card (Triton Inference Server's pinned memory
pool, ``--pinned-memory-pool-byte-size``).  Pageable, a request's 7.4 MB
would first be copied on the host at the speed of one core's memcpy,
which on an H100's host moved from 0.85 to 1.24 ms a request from one
process to the next (a pinned staging buffer in the scorer took as
long), and would spread the cell's rate by 6% over 6 runs.
The held table is ``weights.make_table`` with every field's rows folded
into one field, field f's rows after those of the fields before it, so
both sides draw it alike.

Set-up, the timed window, the latency and rate, the finite check and the
reservoir of answers scored again by the plain reference after the
window are ``serve_closed_loop``'s (its module docstring).
"""
from __future__ import annotations

import gc
import time

import numpy as np

import harness
import weights
from serve_closed_loop import Reservoir


def table_cfg(cfg: dict) -> dict:
    """The held table as ``weights.make_table`` draws it: one field of
    every field's rows, in field order."""
    return {"num_fields": 1,
            "rows_per_field": sum(cfg["num_embeddings_per_feature"]),
            "table_width": cfg["embedding_dim"],
            "table_init_scale": cfg["table_init_scale"]}


def draw_pool(cfg: dict, mix: dict, seed: int):
    """``pool_requests`` requests [(dense (B, num_dense) float32, ids (B,
    sum(hotness)) int32)] from the seed."""
    if mix["ids"] != "uniform":
        raise ValueError(f"unknown id draw {mix['ids']!r}")
    b, n = mix["batch_size"], mix["pool_requests"]
    rng = np.random.Generator(np.random.PCG64(weights.derive_seed(seed, 4)))
    ids = np.concatenate(
        [rng.integers(0, rows, size=(n, b, h), dtype=np.int32)
         for rows, h in zip(cfg["num_embeddings_per_feature"],
                            cfg["multi_hot_sizes"])], axis=2)
    dense = np.log1p(rng.exponential(
        cfg["dense_log_scale"], size=(n, b, cfg["num_dense_features"]))
                     ).astype(np.float32)
    return [(dense[i], ids[i]) for i in range(n)]


def run(cell: "harness.Cell") -> dict:
    import torch
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.serving import ServingState, build_scorer

    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fc = cell.program.feature_config(cfg)
    params0 = weights.make_params(cell.reference.param_specs(cfg), cell.seed,
                                  dev)
    model = cell.program.build(cfg, dev)
    scorer = build_scorer(model, fc, EmbeddingTable(fc.total_rows,
                                                    fc.embedding_dim, dev),
                          device=dev)
    cell.mark("weights, model, scorer")
    state = ServingState(params0, weights.make_table(table_cfg(cfg),
                                                     cell.seed, dev))
    cell.mark("table")
    pool = draw_pool(cfg, mix, cell.seed)
    if cuda:
        pool = [(torch.from_numpy(d).pin_memory(),
                 torch.from_numpy(i).pin_memory()) for d, i in pool]
    cell.mark("request pool")

    def serve(i):
        dense, ids = pool[i % len(pool)]
        return scorer(state, dense, ids).cpu().numpy()

    for i in range(mix["warmup_requests"]):
        serve(i)
    if cell.trace:
        from traffic_common import profiler_warmup
        profiler_warmup(torch, cuda)
    sync()
    cell.mark("warm-up")

    sample = Reservoir(mix["check_requests"],
                       weights.derive_seed(cell.seed, 3))
    lat, ends = [], []
    at = mix["warmup_requests"]
    failed = 0

    def loop(seconds, spans=None):
        nonlocal at, failed
        t0 = time.perf_counter()
        n = 0
        while True:
            r0 = time.perf_counter()
            if spans is None:
                out = serve(at)
            else:
                with spans("port_bench.request"):
                    out = serve(at)
            t = time.perf_counter()
            lat.append((t - r0) * 1e3)
            ends.append(t)
            failed += not np.isfinite(out).all()
            sample.offer((at % len(pool), out))
            at += 1
            n += 1
            if t - t0 >= seconds:
                break
        sync()
        return n, time.perf_counter() - t0

    setup_s = time.monotonic() - cell.t_start
    cell.log_phases()
    ctx = None
    e2e = {"setup_s": setup_s}
    if not cell.trace:
        t0 = time.perf_counter()
        n, wall = loop(cell.seconds)
        cell.log("requests by second: " + " ".join(
            str(k) for k in harness.per_second(ends, t0)))
        e2e["serve_examples_per_s"] = n * mix["batch_size"] / wall
        e2e["serve_p95_ms"] = float(np.percentile(lat, 95))
    else:
        from traffic_common import profiled
        steady_n, steady_wall = loop(min(mix["trace_steady_s"],
                                         cell.seconds / 2))
        ctx = profiled(cell, lambda s, spans: loop(s, spans),
                       min(mix["trace_s"], cell.seconds / 2))
        ctx.update(kind="serve", requests=ctx.pop("count"),
                   steady_wall_s=steady_wall,
                   steady_flops=steady_n * cell.flops.request_flops(
                       cfg, mix["batch_size"]))
        log_lookup_rows(cell, pool, fc, dev)
    attempted = sample.seen
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    served = sample.items
    del state, scorer, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_logits(cell, params0, [pool[k] for k, _ in served], dev)
    values = harness.serve_checks([o for _, o in served], ref)
    ok, checks = harness.judge(values, cell.limits)
    return {"correct": ok and failed == 0, "attempted": attempted,
            "failed": failed, "e2e": e2e if ctx is None else {}, "ctx": ctx,
            "checks": checks, "memory_peak_bytes": peak}


def log_lookup_rows(cell, pool, fc, device) -> None:
    """The pooled lookup's ids and distinct rows a request and the
    distinct rows over the pool, with their bytes, against the held
    table's."""
    import torch
    width = fc.embedding_dim * 4
    seen = None
    per = []
    for _, ids in pool:
        rows = torch.unique(cell.reference.global_rows(ids, cell.cfg,
                                                       device))
        per.append(rows.numel())
        seen = rows if seen is None else torch.unique(torch.cat([seen,
                                                                 rows]))
    ids_per = np.asarray(pool[0][1]).size
    distinct = float(np.mean(per))
    cell.log(f"lookup: {ids_per} ids a request, {distinct:.0f} distinct "
             f"rows ({distinct * width / 1e6:.1f} MB), {seen.numel()} over "
             f"the pool of {len(pool)} ({seen.numel() * width / 1e9:.2f} "
             f"GB) of the held table's {fc.total_rows} "
             f"({fc.total_rows * width / 1e9:.2f} GB)")


def reference_logits(cell, params0, requests, device, tf32: bool = False):
    """The plain reference's logits of each (dense, ids) request, from the
    weights and the held table drawn again from the seed."""
    import torch
    p = cell.plain
    p.set_tf32(tf32)
    table = weights.make_table(table_cfg(cell.cfg), cell.seed, device)
    out = []
    with torch.no_grad():
        for dense, ids in requests:
            rows = cell.reference.global_rows(ids, cell.cfg, device)
            x = torch.from_numpy(np.asarray(dense, np.float32)).to(device)
            out.append(cell.reference.forward(params0, x, rows, table,
                                              cell.cfg).cpu().numpy())
    p.set_tf32(False)
    return out
