"""CLI training entry point.

Counterpart of ``rec_now_tpu/train.py``: the same flags and JSON lines,
plus ``--device`` (``cuda`` unless asked otherwise; ``cpu`` runs the
plain PyTorch path).

Usage:
    python -m rec_now_tpu_torch.train --model dcnv2 --steps 1000 \\
        --batch-size 8192 --pairwise-weight 0.5 --eval-batches 8 \\
        --scan-window 5 --wire-dense-mode u8 --eval-mode device \\
        --checkpoint-dir /path/to/ckpt
    python -m rec_now_tpu_torch.train --data-file train.tsv \\
        --eval-file eval.tsv --wire-id-mode hot8 --scan-window 5 ...
    torchrun --nproc-per-node 2 -m rec_now_tpu_torch.train --multihost \\
        --batch-size 16384 ...

Models: fm | dcnv2 | xdeepfm | multitask (the four benchmark families),
trained on the synthetic planted-model stream or, with ``--data-file``,
on a Criteo-format TSV read by the native parser (``io/criteo.py``).
Eval then reads ``--eval-file``, or the file's batches past ``--steps``
(held out); a file with none past them is evaluated on its first
batches, after a ``warning`` line, and every eval line and the final
line carry ``"eval_on_train": true``.  ``--eval-file`` without
``--data-file`` is ignored, as in JAX.  ``--scan-window W > 1`` runs the
windowed loop: a worker thread packs W host batches into the compressed
wire (``--wire-id-mode``: bit-packed ids, or hot8 byte codes) and moves
them to the device while the loop runs the previous window
(``Trainer.train_many_packed``); otherwise one step per batch, placed
ahead by a worker thread.  Prints a JSON line every ``--log-every``
steps (at window granularity in the windowed loop), one per eval, and
the final eval.

``--multihost`` trains on every process of a ``torch.distributed`` group
(``parallel/multihost.py``: from ``torchrun``'s variables, or a group of
one without them), one process per device, as JAX's ``--multihost``
(``rec_now_tpu/train.py:130-148``, :168-171, :283-290): each process
feeds ``--batch-size / P`` rows of each global batch (a batch that P
does not divide is refused), draws its synthetic rows with its seeds
shifted by ``rank * 7919``, and reads ``--data-file`` from its start, as
JAX does, so each process is launched with its own part of the data.
The table is mod-sharded over the processes and exchanges rows by
``--sparse-route-mode``: allgather, or the routed exchange (owner
buckets of ``--route-cap-factor`` times the uniform share and an
overflow lane of ``--route-ov-cap`` ids; ``auto`` routes on 4 or more
processes).  Each process prints its own lines, whose metrics (the
routed exchange's ``sparse_dropped`` among them) and evals are global;
``--route-strict`` fails the run at a log line that counts a dropped id.
``--checkpoint-dir`` writes one checkpoint from every process (rank 0
the parameters, each process its rows; ``training/checkpoint.py``), into
a directory every process sees.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

# a process's synthetic seeds are shifted by its rank times this
# (rec_now_tpu/train.py:168-171)
PROCESS_SEED_SHIFT = 7919


def build_model(name: str, fc, device, seed: int):
    """(model, num_tasks) of a ``--model`` choice at its default widths."""
    from rec_now_tpu_torch.models import (DCNv2Model, FMModel,
                                          MultiTaskModel, XDeepFMModel)
    families = {"fm": (FMModel, 1), "dcnv2": (DCNv2Model, 1),
                "xdeepfm": (XDeepFMModel, 1), "multitask": (MultiTaskModel, 2)}
    if name not in families:
        raise SystemExit(f"unknown model {name!r}")
    cls, tasks = families[name]
    return cls(fc, device=device, seed=seed), tasks


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The JAX CLI's flags and ``--device``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="dcnv2",
                   choices=["fm", "dcnv2", "xdeepfm", "multitask"])
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cpu: the plain "
                        "PyTorch path, no kernels)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--rows-per-field", type=int, default=100_000)
    p.add_argument("--embedding-dim", type=int, default=16)
    p.add_argument("--dense-lr", type=float, default=1e-3)
    p.add_argument("--sparse-lr", type=float, default=0.05)
    p.add_argument("--sparse-optimizer", default="adagrad",
                   choices=["adagrad", "adam"])
    p.add_argument("--sparse-update-mode", default="auto",
                   choices=["auto", "sparse", "dense"])
    p.add_argument("--sparse-route-mode", default="auto",
                   choices=["auto", "allgather", "routed"],
                   help="the sharded table's exchange under --multihost: "
                        "allgather (every process sees every id), routed "
                        "(dedup + owner buckets on all_to_all), auto = "
                        "routed on 4 or more processes; one process has "
                        "no exchange")
    p.add_argument("--route-strict", action="store_true",
                   help="fail at a log line when the routed exchange has "
                        "dropped ids to double overflow; sparse_dropped is "
                        "in every log line either way")
    p.add_argument("--route-cap-factor", type=float, default=2.0,
                   help="routed exchange: an owner's bucket is this times "
                        "the uniform share of a process's ids")
    p.add_argument("--route-ov-cap", type=int, default=0,
                   help="routed exchange: the overflow lane's length; 0 = "
                        "a process's ids // 16")
    p.add_argument("--scan-window", type=int, default=0,
                   help="steps per packed window (0 or 1: one step per "
                        "batch)")
    p.add_argument("--pointwise-weight", type=float, default=1.0)
    p.add_argument("--pairwise-weight", type=float, default=0.0)
    p.add_argument("--listwise-weight", type=float, default=0.0)
    p.add_argument("--occurance-power", type=float, default=0.0)
    p.add_argument("--wire-dense-mode", choices=("f16", "u8"), default="f16")
    p.add_argument("--wire-id-mode", choices=("packed", "hot8"),
                   default="packed")
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--eval-every", type=int, default=0,
                   help="eval cadence in steps (0 = only at the end)")
    p.add_argument("--eval-mode", choices=("exact", "device"),
                   default="exact",
                   help="exact: host-side sorted AUC + corpus GAUC; "
                        "device: bucketed AUC + corpus GAUC histograms "
                        "on the device")
    p.add_argument("--eval-group-slots", type=int, default=0,
                   help="device-eval corpus-GAUC group slots; 0 sizes "
                        "them from --num-groups (capped at 65536)")
    p.add_argument("--eval-group-buckets", type=int, default=512)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-file", default=None,
                   help="Criteo-format TSV to train from (native parser); "
                        "default: the synthetic planted-model stream")
    p.add_argument("--eval-file", default=None,
                   help="Criteo-format TSV to evaluate on; default with "
                        "--data-file: the file's batches past --steps")
    p.add_argument("--num-groups", type=int, default=50_000,
                   help="group-id hash space of --data-file (the in-batch "
                        "pairwise / listwise grouping key)")
    p.add_argument("--multihost", action="store_true",
                   help="train on every process of a torch.distributed "
                        "group (torchrun's variables; a group of one "
                        "without them), each feeding its slice of the "
                        "global --batch-size")
    return p.parse_args(argv)


def trainer_config(args: argparse.Namespace, num_tasks: int = 1):
    """The ``TrainerConfig`` of ``args`` (``--route-ov-cap 0``: None, the
    b // 16 lane, as ``rec_now_tpu/train.py:162``)."""
    from rec_now_tpu_torch.training import TrainerConfig
    return TrainerConfig(
        pointwise_weight=args.pointwise_weight,
        pairwise_weight=args.pairwise_weight,
        listwise_weight=args.listwise_weight,
        click_occurance_power=args.occurance_power,
        dense_lr=args.dense_lr, sparse_lr=args.sparse_lr,
        sparse_optimizer=args.sparse_optimizer,
        sparse_update_mode=args.sparse_update_mode,
        sparse_route_mode=args.sparse_route_mode,
        route_strict=args.route_strict,
        route_cap_factor=args.route_cap_factor,
        route_ov_cap=args.route_ov_cap or None,
        wire_dense_mode=args.wire_dense_mode,
        wire_id_mode=args.wire_id_mode,
        num_tasks=num_tasks)


def make_trainer(args: argparse.Namespace, mesh=None):
    """The trainer ``args`` describe, with its model, on ``--device`` or,
    on a mesh, on the mesh's device."""
    from rec_now_tpu_torch.models import FeatureConfig
    from rec_now_tpu_torch.training import Trainer
    fc = FeatureConfig(rows_per_field=args.rows_per_field,
                       embedding_dim=args.embedding_dim)
    device = args.device if mesh is None else mesh.device
    model, num_tasks = build_model(args.model, fc, device, args.seed)
    return Trainer(model, fc, trainer_config(args, num_tasks), device=device,
                   mesh=mesh)


def init_state(trainer, args: argparse.Namespace):
    """The run's initial state: the model's seeded weights and a table
    drawn from ``--seed``."""
    import torch
    return trainer.init(torch.Generator().manual_seed(args.seed))


class Streams(NamedTuple):
    """A run's data: its training batches, a maker of one eval's batches,
    and whether eval scores training rows (a data file with none held
    out)."""
    train: Iterator
    make_eval: Callable[[], Iterator]
    eval_on_train: bool = False


def data_streams(args: argparse.Namespace, rank: int = 0,
                 processes: int = 1) -> Streams:
    """The run's :class:`Streams` for process ``rank`` of ``processes``
    (batches of ``--batch-size / processes`` rows): the synthetic stream
    (its seeds shifted by ``rank * 7919``), or with ``--data-file`` the
    file's first ``--steps`` batches, eval from ``--eval-file`` or the
    file's next ``--eval-batches`` batches (read now, by a second pass
    that skips the training range, as ``rec_now_tpu/train.py:172-206``).
    A file with no batch past the training range prints the JAX
    ``warning`` line and evaluates its first batches."""
    batch = args.batch_size // processes
    if not args.data_file:
        from rec_now_tpu_torch.training import SyntheticCriteo
        data = SyntheticCriteo(rows_per_field=args.rows_per_field,
                               seed=args.seed)
        # disjoint synthetic streams per process (train.py:168-171)
        shift = rank * PROCESS_SEED_SHIFT
        return Streams(
            data.batches(batch, args.steps, seed=args.seed + 1 + shift),
            lambda: data.batches(batch, args.eval_batches,
                                 seed=args.seed + 999 + shift))
    from rec_now_tpu_torch.io import CriteoTSV

    def tsv(path: str) -> CriteoTSV:
        return CriteoTSV(path, rows_per_field=args.rows_per_field,
                         num_groups=args.num_groups)

    ds = tsv(args.data_file)
    train = ds.batches(batch, args.steps)
    if args.eval_file:
        eval_ds = tsv(args.eval_file)
        return Streams(train, lambda: eval_ds.batches(batch,
                                                      args.eval_batches))
    held_out = list(ds.batches(batch, args.eval_batches, skip=args.steps))
    on_train = not held_out
    if on_train:
        print(json.dumps({
            "warning": "data file has no rows past the training range; "
                       "eval scores TRAINING data (eval_on_train=true)"}),
              flush=True)
        held_out = list(ds.batches(batch, args.eval_batches))
    return Streams(train, lambda: iter(held_out), on_train)


def eval_slots(args: argparse.Namespace) -> int:
    """Device-eval group slots: ``--eval-group-slots``, or enough for
    --num-groups distinct groups to map exactly (capped at 65536)."""
    if args.eval_group_slots:
        return args.eval_group_slots
    want = max(args.num_groups, 1024) * 8 // 7 + 1
    return min(0x10000, 1 << math.ceil(math.log2(want)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from rec_now_tpu_torch.training.checkpoint import CheckpointManager
    from rec_now_tpu_torch.training.prefetch import (DevicePrefetcher,
                                                     WindowPrefetcher)

    mesh = None
    if args.multihost:
        # the group first: it picks this process's device
        from rec_now_tpu_torch.parallel import make_mesh
        mesh = make_mesh(args.device)
        if args.batch_size % mesh.size:
            raise SystemExit(f"--batch-size {args.batch_size} must divide "
                             f"by the process count {mesh.size}")
    trainer = make_trainer(args, mesh)
    batches, make_eval_batches, on_train = data_streams(
        args, *((0, 1) if mesh is None else (mesh.rank, mesh.size)))
    state = init_state(trainer, args)
    ckpt = (CheckpointManager(args.checkpoint_dir)
            if args.checkpoint_dir else None)
    if args.eval_mode == "device":
        eval_fn = functools.partial(trainer.evaluate_device,
                                    num_group_slots=eval_slots(args),
                                    group_buckets=args.eval_group_buckets)
    else:
        eval_fn = trainer.evaluate

    def run_eval(step: int) -> None:
        res = eval_fn(state, make_eval_batches())
        line = {"step": step, "eval": res, "eval_mode": args.eval_mode}
        if on_train:
            line["eval_on_train"] = True
        print(json.dumps(line), flush=True)

    def log(step: int, metrics) -> None:
        # the floats wait for the step's work, so the rate counts it
        line = {k: round(float(v), 5) for k, v in metrics.items()}
        eps = args.batch_size * step / (time.perf_counter() - t0)
        line.update(step=step, examples_per_sec=round(eps, 1))
        print(json.dumps(line), flush=True)
        # after the line, as rec_now_tpu/train.py:272, :304
        trainer.check_dropped(metrics)

    def crossed(every: int, prev: int, step: int) -> bool:
        return bool(every) and step // every > prev // every

    t0 = time.perf_counter()
    if args.scan_window > 1:
        # each window's host batches are packed and moved on a worker
        # thread while the loop runs the previous window; log, eval and
        # checkpoint fire at window granularity when the step crosses
        # their cadence
        step = 0
        with WindowPrefetcher(batches, trainer.put_packed_auto,
                              args.scan_window) as wins:
            for dev_win, n_steps in wins:
                state, seq = trainer.train_many_packed(state, dev_win)
                prev, step = step, step + n_steps
                if crossed(args.log_every, prev, step):
                    log(step, {k: v[-1] for k, v in seq.items()})
                if crossed(args.eval_every, prev, step):
                    run_eval(step)
                if ckpt and crossed(args.checkpoint_every, prev, step):
                    ckpt.save(step, state)
    else:
        with DevicePrefetcher(batches, trainer.put_local) as prefetched:
            for i, dev_batch in enumerate(prefetched):
                state, metrics = trainer.train_step(state, *dev_batch)
                step = i + 1
                if args.log_every and step % args.log_every == 0:
                    log(step, metrics)
                if args.eval_every and step % args.eval_every == 0:
                    run_eval(step)
                if ckpt and args.checkpoint_every \
                        and step % args.checkpoint_every == 0:
                    ckpt.save(step, state)

    res = eval_fn(state, make_eval_batches())
    final = {"final_eval": res, "steps": args.steps, "model": args.model,
             "eval_mode": args.eval_mode}
    if on_train:
        final["eval_on_train"] = True
    print(json.dumps(final), flush=True)
    if ckpt:
        ckpt.save(args.steps, state)
        ckpt.wait()
        ckpt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
