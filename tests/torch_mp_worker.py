"""Worker processes of the port's multi-process tests (not collected).

:func:`spawn` starts ``world`` processes of this file, each of which joins
a gloo group through a ``FileStore`` in its own directory (no port, so
test workers cannot collide), runs one task on its rank's slice of the
inputs, saves what it got and leaves the group.  A process that outlives
the time limit is killed with all the others and the test fails, so a hang
costs one test and not the suite.  The workers import the port only,
never JAX.

    python tests/torch_mp_worker.py <task> <directory> <rank> <world>
"""
from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# a spawned group's hard limit, its start-up included
TIME_LIMIT = 120


def spawn(task: str, inputs: dict, directory: Path, world: int = 2,
          time_limit: float = TIME_LIMIT) -> list:
    """Run ``task`` on ``world`` processes over ``inputs`` (pickled into
    ``directory``, which must be new) -> each rank's output, in rank
    order."""
    import torch
    directory.mkdir(parents=True)
    torch.save(inputs, directory / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(directory), str(rank),
         str(world)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=time_limit)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{task}: the {world} processes did not end "
                             f"within {time_limit} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{task}: rank {rank} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return [torch.load(directory / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def local_slice(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous slice of a global batch's arrays."""
    b = len(batch["labels"]) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


# -- tasks (run in the workers) -----------------------------------------------

def task_table(inputs: dict, mesh) -> dict:
    """Each case: lookups and updates of a mod-sharded table from the
    logical state given, on this rank's slice of each step's ids (with a
    case's ``route_mode``, ``dedup`` and per-step ``masks`` where given);
    then, where the case asks, ``export_table_rows`` of its ids."""
    import torch
    from rec_now_tpu_torch.convert import table_state_for_rank
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    from rec_now_tpu_torch.serving import export_table_rows
    out = []
    for case in inputs["table_cases"]:
        table = ShardedEmbeddingTable(
            case["vocab"], case["dim"], device="cpu", mesh=mesh,
            optimizer=case["optimizer"], update_mode=case["mode"],
            route_mode=case.get("route_mode", "auto"))
        state = table_state_for_rank(case["state"], mesh.rank, mesh.size,
                                     case["vocab"])
        masks = case.get("masks") or [None] * len(case["steps"])
        looked = []
        for (ids, grads), mask in zip(case["steps"], masks):
            b = len(ids) // mesh.size
            mine = slice(mesh.rank * b, (mesh.rank + 1) * b)
            ids_l = torch.from_numpy(ids[mine]).long()
            looked.append(table.lookup(state, ids_l))
            state = table.apply_grads(
                state, ids_l, torch.from_numpy(grads[mine]), lr=case["lr"],
                valid_mask=None if mask is None else torch.from_numpy(
                    mask[mine]), dedup=case.get("dedup", True))
        res = {"lookups": looked, "state": state,
               "update_mode": table.update_mode,
               "route_mode": table.route_mode}
        if case.get("export") is not None:
            b = len(case["export"]) // mesh.size
            res["export"] = export_table_rows(
                state, table, case["export"][mesh.rank * b:
                                             (mesh.rank + 1) * b])
        out.append(res)
    return out


def task_routed(inputs: dict, mesh) -> dict:
    """Each table case on both exchanges (``route_mode`` "routed" and
    "allgather", the case's caps): lookups with their dropped counts, then
    updates, on this rank's slice of each step's ids; then each trainer
    case; then ``fit`` under ``route_strict`` on a cap that drops ids."""
    import torch
    from rec_now_tpu_torch.convert import table_state_for_rank
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    out = {"table": [], "trainers": [], "strict": None}
    for case in inputs["table_cases"]:
        res = {}
        for mode in ("routed", "allgather"):
            table = ShardedEmbeddingTable(
                case["vocab"], case["dim"], device="cpu", mesh=mesh,
                optimizer=case["optimizer"], update_mode=case["mode"],
                route_mode=mode, route_cap_factor=case["cap_factor"],
                route_ov_cap=case["ov_cap"])
            state = table_state_for_rank(case["state"], mesh.rank,
                                         mesh.size, case["vocab"])
            looked, dropped = [], []
            for ids, grads in case["steps"]:
                b = len(ids) // mesh.size
                mine = slice(mesh.rank * b, (mesh.rank + 1) * b)
                ids_l = torch.from_numpy(ids[mine]).long()
                rows, d = table.lookup(state, ids_l, return_dropped=True)
                looked.append(rows)
                dropped.append(int(d))
                state = table.apply_grads(state, ids_l,
                                          torch.from_numpy(grads[mine]),
                                          lr=case["lr"])
            res[mode] = {"lookups": looked, "dropped": dropped,
                         "state": state, "route_mode": table.route_mode}
        out["table"].append(res)
    out["trainers"] = task_trainers(inputs, mesh)
    if inputs.get("strict"):
        out["strict"] = run_strict_case(inputs["strict"], mesh)
    return out


def run_strict_case(case: dict, mesh) -> dict:
    """``fit`` on a route cap that drops ids: without ``route_strict`` its
    metrics count the drops; with it, ``fit`` raises at the first log."""
    import dataclasses
    import torch
    from rec_now_tpu_torch.models import FeatureConfig
    from rec_now_tpu_torch.training import Batch, Trainer, TrainerConfig
    fc = FeatureConfig(rows_per_field=case["rows"],
                       embedding_dim=case["dim"])
    cfg = TrainerConfig(**case["config"])
    batches = [Batch(**local_slice(b, mesh.rank, mesh.size))
               for b in case["batches"]]
    out = {}
    for strict in (False, True):
        trainer = Trainer(build_model("dcnv2", fc), fc,
                          dataclasses.replace(cfg, route_strict=strict),
                          device="cpu", mesh=mesh)
        state = trainer.init(torch.Generator().manual_seed(0))
        try:
            _, last = trainer.fit(state, batches, log_every=1)
            out[strict] = last
        except RuntimeError as e:
            out[strict] = str(e)
    return out


def build_model(kind: str, fc, seed: int = 0):
    """The small models of the trainer cases, on the CPU."""
    from rec_now_tpu_torch.models import (CANDCNModel, DCNv2Model,
                                          MultiTaskModel)
    if kind == "dcnv2":
        return DCNv2Model(fc, deep_dims=(16,), dcn_sub_dim=4, device="cpu",
                          seed=seed)
    if kind == "multitask":
        return MultiTaskModel(fc, mmoe_dims=(16, 8), ple_dims=(8,),
                              tower_dim=4, device="cpu", seed=seed)
    return CANDCNModel(fc, deep_dims=(16,), dcn_sub_dim=4, device="cpu",
                       seed=seed)


def run_trainer_case(case: dict, mesh) -> dict:
    """A few steps of one trainer case on this rank's slices (or, with no
    mesh, on the whole batches) -> the metrics of each step, the summed
    parameter gradients of the first, the final params and table rows,
    and each eval."""
    import torch
    from rec_now_tpu_torch.convert import table_state_for_rank
    from rec_now_tpu_torch.models import FeatureConfig
    from rec_now_tpu_torch.training import Batch, Trainer, TrainerConfig
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    fc = FeatureConfig(rows_per_field=case["rows"],
                       embedding_dim=case["dim"])
    trainer = Trainer(build_model(case["model"], fc, case.get("seed", 0)),
                      fc, TrainerConfig(**case["config"]), device="cpu",
                      mesh=mesh)
    kw = {}
    if "params" in case:
        kw["params"] = case["params"]
        kw["table"] = table_state_for_rank(case["table"], rank, world,
                                           fc.total_rows)
    state = trainer.init(torch.Generator().manual_seed(case.get("seed", 0)),
                         **kw)

    def mine(batch):
        return Batch(**local_slice(batch, rank, world))

    metrics, first_grads = [], None
    for batch in case["batches"]:
        state, m = trainer.train_step(state, *trainer.put_local(mine(batch)))
        metrics.append({k: float(v) for k, v in m.items()})
        if first_grads is None:
            first_grads = {n: p.grad.clone()
                           for n, p in state.params.items()}
    evals = {}
    if case.get("eval"):
        evs = [mine(b) for b in case["eval"]]
        evals["exact"] = trainer.evaluate(state, evs)
        for gauc in ("corpus", "inbatch"):
            evals[gauc] = trainer.evaluate_device(state, evs, window=2,
                                                  gauc=gauc,
                                                  num_group_slots=4096,
                                                  group_buckets=64)
    if case.get("windowed"):
        # the windowed loop, its windows placed by put_packed_auto
        _, seq = trainer.train_pipelined(
            state, [mine(b) for b in case["windowed"]], window=2)
        evals["windowed_loss"] = [float(x) for x in seq["loss"]]
    return {"metrics": metrics, "grads": first_grads,
            "params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            "table": state.table, "can_table": state.can_table,
            "evals": evals}


def task_trainers(inputs: dict, mesh) -> list:
    return [run_trainer_case(case, mesh) for case in inputs["trainer_cases"]]


def task_cli(inputs: dict, mesh) -> dict:
    """The training CLI's ``main`` with ``--multihost`` on this group:
    first runs that must stop (their ``SystemExit`` or ``RuntimeError``),
    then each run's JSON lines and warnings."""
    from rec_now_tpu_torch import train as cli
    out = {"stops": [], "runs": []}
    for argv in inputs["stops"]:
        try:
            cli.main(argv)
            out["stops"].append(None)
        except (SystemExit, RuntimeError) as e:
            out["stops"].append(str(e))
    for argv in inputs["runs"]:
        buf = io.StringIO()
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stdout(buf):
            warnings.simplefilter("always")
            rc = cli.main(argv)
        out["runs"].append({
            "rc": rc, "warnings": [str(w.message) for w in caught],
            "lines": [json.loads(ln) for ln in buf.getvalue().splitlines()
                      if ln.startswith("{")]})
    return out


def task_suite(inputs: dict, mesh) -> dict:
    """The table cases, then the trainer cases."""
    return {"table": task_table(inputs, mesh),
            "trainers": task_trainers(inputs, mesh)}


def task_checkpoint(inputs: dict, mesh) -> dict:
    """Each case: train, save a checkpoint from every process, train on
    (the unbroken run); restore the checkpoint into a fresh state and
    train the same steps from it; export the serving state; restore the
    case's one-process checkpoint on this group."""
    import torch
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.models import CANDCNModel, FeatureConfig
    from rec_now_tpu_torch.serving import (ServingState, build_scorer,
                                           export_serving)
    from rec_now_tpu_torch.training import Batch, Trainer, TrainerConfig
    from rec_now_tpu_torch.training.checkpoint import CheckpointManager
    out = []
    for case in inputs["cases"]:
        fc = FeatureConfig(rows_per_field=case["rows"],
                           embedding_dim=case["dim"])
        cfg = TrainerConfig(**case["config"])

        def fresh(seed):
            trainer = Trainer(build_model(case["model"], fc), fc, cfg,
                              device="cpu", mesh=mesh)
            return trainer, trainer.init(torch.Generator().manual_seed(seed))

        batches = [Batch(**local_slice(b, mesh.rank, mesh.size))
                   for b in case["batches"]]
        half = case["save_at"]
        trainer, whole = fresh(0)
        for b in batches[:half]:
            whole, _ = trainer.train_step(whole, *trainer.put_local(b))
        ckpt = CheckpointManager(case["dir"])
        ckpt.save(half, whole)
        saved = snapshot_state(whole)
        for b in batches[half:]:
            whole, _ = trainer.train_step(whole, *trainer.put_local(b))
        other, back = fresh(1)
        back = ckpt.restore(target=back)
        restored = snapshot_state(back)
        for b in batches[half:]:
            back, _ = other.train_step(back, *other.put_local(b))
        can = {}
        if cfg.can_param_field is not None:
            can = dict(can_table=EmbeddingTable(
                fc.rows_per_field, CANDCNModel.can_param_size(
                    fc.embedding_dim, cfg.can_dnn_dims), device="cpu"),
                can_param_field=cfg.can_param_field)
        scorer = build_scorer(trainer.model, fc, EmbeddingTable(
            fc.total_rows, fc.embedding_dim, device="cpu"), device="cpu",
            **can)
        export_serving(case["export"], ServingState(
            dict(whole.params), whole.table.table,
            None if whole.can_table is None else whole.can_table.table),
            scorer)
        _, one = fresh(2)
        one = CheckpointManager(case["one_dir"]).restore(target=one)
        out.append({"saved": saved, "restored": restored,
                    "whole": snapshot_state(whole),
                    "resumed": snapshot_state(back),
                    "from_one": snapshot_state(one),
                    "steps": CheckpointManager(case["dir"]).steps()})
    return out


def snapshot_state(state) -> dict:
    """A copy of a training state: params, the Adam state, the step and
    every tensor of each table."""
    import copy
    out = {"params": {n: p.detach().clone() for n, p in state.params.items()},
           "opt": copy.deepcopy(state.opt.state_dict()),
           "step": int(state.step)}
    for key in ("table", "can_table"):
        t = getattr(state, key)
        if t is not None:
            out[key] = {k: v.clone() for k, v in t._asdict().items()
                        if v is not None}
    return out


TASKS = {"suite": task_suite, "table": task_table, "cli": task_cli,
         "routed": task_routed, "checkpoint": task_checkpoint}


def main() -> None:
    task, directory, rank, world = (sys.argv[1], Path(sys.argv[2]),
                                    int(sys.argv[3]), int(sys.argv[4]))
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from rec_now_tpu_torch.parallel import initialize_multihost, make_mesh
    inputs = torch.load(directory / "inputs.pt", weights_only=False)
    initialize_multihost("cpu", init_method=f"file://{directory}/store",
                         rank=rank, world_size=world,
                         timeout=datetime.timedelta(seconds=TIME_LIMIT))
    try:
        result = TASKS[task](inputs, make_mesh("cpu"))
        torch.save(result, directory / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
