"""How far a training run repeated on the card spreads, and why.

    python -m rec_now_tpu_torch.profile_repeat [--runs 5] [--steps 3]

Trains config 5 (``CANDCNModel()``, ``profile_training.CONFIG5``: Adagrad
on its two tables) at full width (``FeatureConfig()``, B = 8,192) from
the same seeds on the same batches ``--runs`` times in one process.
Prints, for each run against run 0, each part's largest difference over
its largest value:

* the state before the last step (the parameters, each table);
* the last step's gradients (the parameters', each table's rows);
* the last step replayed from the run's own saved state in a fresh
  trainer, against the run itself (0 when the step is a function of its
  state) and against run 0's replay, with the batch positions whose table
  rows' gradients differ from run 0's by more than 1e-3 of the largest.

B12 (the row scatter-add of the table update) adds a hot row's terms in
no fixed order, so the runs' tables part after step 1; what the later
steps make of that is what this measures.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse

import torch

from rec_now_tpu_torch.models import CANDCNModel, FeatureConfig
from rec_now_tpu_torch.profile_training import BATCH, CONFIG5
from rec_now_tpu_torch.training import SyntheticCriteo, Trainer

TABLES = ("table", "can_table")


def _trainer(fc: FeatureConfig, dev: torch.device):
    """A config-5 trainer, its fresh state, and the list each step's row
    gradients (one (B, ..., D) tensor a table) are recorded into."""
    tr = Trainer(CANDCNModel(fc, device=dev, seed=0), fc, CONFIG5,
                 device=dev)
    rows = []
    for table in (tr.table, tr.can_table):
        def record(state, ids, grads, lr, apply=table.apply_grads):
            rows.append(grads.detach().clone())
            return apply(state, ids, grads, lr=lr)
        table.apply_grads = record
    return tr, tr.init(torch.Generator().manual_seed(1)), rows


def _step(tr: Trainer, state, rows: list, batch) -> dict:
    """One step; its gradients."""
    rows.clear()
    state, _ = tr.train_step(state, *tr.put(batch))
    return {"params": {n: p.grad.clone() for n, p in state.params.items()},
            "table": rows[0], "can_table": rows[1]}


def _saved(state) -> dict:
    return {"params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            **{k: (getattr(state, k).table.clone(),
                   getattr(state, k).accumulator.clone()) for k in TABLES}}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _spread(a: dict, b: dict) -> str:
    """Each part's largest difference over its largest value."""
    parts = {"params": max(_rel(a["params"][n], p)
                           for n, p in b["params"].items())}
    for k in TABLES:
        x, y = a[k], b[k]
        parts[k] = _rel(x[0], y[0]) if isinstance(y, tuple) else _rel(x, y)
    return ", ".join(f"{k} {v:.3e}" for k, v in parts.items())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    fc = FeatureConfig()
    data = SyntheticCriteo(num_dense=fc.num_dense, num_sparse=fc.num_sparse,
                           rows_per_field=fc.rows_per_field, seed=0)
    batches = list(data.batches(BATCH, args.steps, seed=5))
    runs = []
    for _ in range(args.runs):
        tr, state, rows = _trainer(fc, dev)
        for b in batches[:-1]:
            _step(tr, state, rows, b)
        saved = _saved(state)
        runs.append((saved, _step(tr, state, rows, batches[-1])))
        del tr, state, rows
    replays = []
    for saved, _ in runs:
        tr, state, rows = _trainer(fc, dev)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(saved["params"][n])
            for k in TABLES:
                getattr(state, k).table.copy_(saved[k][0])
                getattr(state, k).accumulator.copy_(saved[k][1])
        replays.append(_step(tr, state, rows, batches[-1]))
        del tr, state, rows
    name = torch.cuda.get_device_name(0)
    print(f"config 5 at B={BATCH}, {args.runs} runs of {args.steps} steps "
          f"[{name}]")
    for i, ((saved, grads), replay) in enumerate(zip(runs, replays)):
        d = (replay["table"] - replays[0]["table"]).abs()
        d = d.reshape(d.shape[0], -1).amax(1)
        far = (d > 1e-3 * float(replays[0]["table"].abs().max())).nonzero()
        print(f"run {i} vs run 0: state before step {args.steps}: "
              f"{_spread(saved, runs[0][0])}; step {args.steps}'s "
              f"gradients: {_spread(grads, runs[0][1])}; replayed vs "
              f"itself: {_spread(replay, grads)}; batch positions off "
              f"run 0's by > 1e-3: {far.flatten().tolist()[:10]} "
              f"({far.numel()} of {d.shape[0]})")


if __name__ == "__main__":
    main()
