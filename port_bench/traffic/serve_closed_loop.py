"""Serving in a closed loop with one client: one outstanding request of
the mix's batch size, scored through the raw front end
``rec_now_tpu_torch.serving.build_scorer``; the next is sent when the
last one's logits are in host memory.

Set-up: the weights and table from the seed, the scorer around them, a
pool of requests (:func:`draw_pool`) and warm-up requests.  The timed
window sends the pool's requests in turn for ``--seconds``; a request's
latency runs from handing its host arrays to the scorer until its logits
are on the host.  ``serve_p95_ms`` is the 95th percentile of every
request of the window, ``serve_examples_per_s`` every example scored
over the window's wall seconds.  Each answer is checked finite as it
comes; a sample of the window's answers, drawn from the seed as they
come (a reservoir), is kept and, after the window, scored again by the
plain reference (``harness.serve_checks``).
"""
from __future__ import annotations

import gc
import random
import time

import numpy as np

import harness
import weights


def draw_pool(cfg: dict, mix: dict, seed: int):
    """``pool_requests`` requests [(dense (B, 0), ids (B, F) int32)] from
    the seed: each field's ids uniform over its ``rows_per_field`` rows."""
    if mix["ids"] != "uniform":
        raise ValueError(f"unknown id draw {mix['ids']!r}")
    b, f = mix["batch_size"], cfg["num_fields"]
    rng = np.random.Generator(np.random.PCG64(weights.derive_seed(seed, 4)))
    ids = rng.integers(0, cfg["rows_per_field"],
                       size=(mix["pool_requests"], b, f), dtype=np.int32)
    dense = np.zeros((b, 0), np.float32)
    return [(dense, ids[i]) for i in range(mix["pool_requests"])]


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from
    ``seed`` as they come (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


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
    state = ServingState(params0, weights.make_table(cfg, cell.seed, dev))
    cell.mark("table")
    pool = draw_pool(cfg, mix, cell.seed)
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
        log_lookup_rows(cell, pool, fc)
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


def log_lookup_rows(cell, pool, fc) -> None:
    """The lookup's distinct rows a request and over the pool, with their
    bytes, against the table's (what the card's L2 can hold of them)."""
    width = fc.embedding_dim * 4
    offs = np.arange(fc.num_sparse, dtype=np.int64) * fc.rows_per_field
    rows = [np.unique(ids.astype(np.int64) + offs) for _, ids in pool]
    per = float(np.mean([r.size for r in rows]))
    total = np.unique(np.concatenate(rows)).size
    cell.log(f"lookup: {per:.0f} distinct rows a request "
             f"({per * width / 1e6:.2f} MB), {total} over the pool of "
             f"{len(pool)} ({total * width / 1e6:.1f} MB) of the table's "
             f"{fc.total_rows} ({fc.total_rows * width / 1e6:.1f} MB)")


def reference_logits(cell, params0, requests, device, tf32: bool = False):
    """The plain reference's logits of each (dense, ids) request, from the
    weights and table drawn again from the seed."""
    import torch
    p = cell.plain
    p.set_tf32(tf32)
    table = weights.make_table(cell.cfg, cell.seed, device)
    out = []
    with torch.no_grad():
        for dense, ids in requests:
            rows = table[p.global_ids(ids, cell.cfg["rows_per_field"],
                                      device)]
            x = torch.from_numpy(np.asarray(dense, np.float32)).to(device)
            out.append(cell.reference.forward(params0, x, rows, cell.cfg
                                              ).cpu().numpy())
    p.set_tf32(False)
    return out
