"""Readings that set a cell's correctness limits, several seeds in one
process (not run by the benchmark's own runs).

    python3 port_bench/control.py --workload <name> --seeds 1,2,3 \
        --mode program|control [--seconds 1]

* ``program``: the cell as ``run.py`` runs it, with a short window, on
  each seed: the numbers the program reads against the reference (the
  lower readings).
* ``control``: the plain reference put in the program's place with TF32
  on, the nearest precision below the configuration's float32, against
  the reference with TF32 off (the upper readings).

Each seed prints one JSON line ``{"seed", "mode", "values"}``; a mode
whose run fails prints its error in place of the values.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def readings(cell, mode: str) -> dict:
    """The numbers a cell compares for ``correct``: the program's run
    (``program``), or the plain reference with TF32 on in the program's
    place against it with TF32 off, on as many of the pool's requests
    as a run compares, drawn from the seed (``control``)."""
    import numpy as np

    import harness
    import weights
    if mode == "program":
        return cell.driver().run(cell)["checks"]
    serve = cell.driver()
    params0 = weights.make_params(cell.reference.param_specs(cell.cfg),
                                  cell.seed, cell.device)
    pool = serve.draw_pool(cell.cfg, cell.mix, cell.seed)
    rng = np.random.RandomState(weights.derive_seed(cell.seed, 3) % 2 ** 32)
    picks = rng.choice(len(pool), size=cell.mix["check_requests"])
    reqs = [pool[i] for i in picks]
    got = serve.reference_logits(cell, params0, reqs, cell.device, tf32=True)
    ref = serve.reference_logits(cell, params0, reqs, cell.device)
    return {k: {"value": v} for k, v in harness.serve_checks(got, ref).items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    import torch

    import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.monotonic()
        cell = harness.Cell(args.workload, seed, args.seconds, False, "cuda",
                            t)
        try:
            vals = {k: v["value"] for k, v in readings(cell, args.mode).items()}
        except Exception as e:  # one seed's failure is its reading
            vals = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.mode, "values": vals,
                          "s": round(time.monotonic() - t, 1)}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
