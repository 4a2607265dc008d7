"""The benchmark of rec_now_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Runs the workload named in ``BENCHMARK.json`` (from the repository's
root), prints what it found on standard error, the numbers compared for
``correct`` beside their limits as its last lines there, and one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.  Exits non-zero without a result when no CUDA device is
there, when the cell needs more devices than there are, or when a JAX
module was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness
    bench = harness.benchmark()
    found = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not found:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the GPU "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < found[0]["chips"]:
        print(f"{args.workload} needs {found[0]['chips']} devices, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    cell = harness.Cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START, bench=bench)
    cell.mark("interpreter, imports, CUDA context")
    out = cell.driver().run(cell)
    return emit(cell, out, bool(args.trace))


def emit(cell, out: dict, trace: bool) -> int:
    """Print the checks and the result line; non-zero, with no result,
    if a JAX module is loaded."""
    import torch

    import harness
    bad = harness.forbidden_loaded()
    if bad:
        print("loaded a forbidden module: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    cuda = torch.device(cell.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": cell.workload["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"]}
    if trace:
        ctx = out["ctx"]
        tr = ctx["trace"]
        line["metrics"] = harness.per_layer(cell.bench, cell.workload, ctx)
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["device"] = device
        line["breakdown"] = {"device_ops": tr["top_ops"],
                             "idle_gaps": tr["top_idle"]}
        if tr["unmapped"]:
            names = sorted(tr["unmapped"].items(), key=lambda kv: -kv[1])
            print("device work outside the port's kernel map (s): "
                  + "; ".join(f"{n[:80]} {s:.6f}" for n, s in names[:40]),
                  file=sys.stderr)
        print("port kernels by wrapper (device s): "
              + json.dumps(tr["wrapper_s"]) + "; bound s: "
              + json.dumps(ctx["bound_s"]), file=sys.stderr)
    else:
        line["metrics"] = harness.end_to_end(cell.bench, cell.workload,
                                             out["e2e"])
        line["device"] = device
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
