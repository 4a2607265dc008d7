"""Checkpoints of a training state in step-numbered directories, from one
process or from every process of a group.

Counterpart of ``rec_now_tpu/training/checkpoint.py`` (its
``CheckpointManager`` interface: ``save``, ``restore``, ``latest_step``,
``wait``, ``close``, ``max_to_keep=3``), built on ``torch.save`` /
``torch.load`` instead of Orbax.  A save takes a synchronous CPU snapshot
of the whole :class:`TrainState` -- the params, the Adam ``state_dict``,
the table state (rows, accumulator and, under lazy Adam, m, v and the
count), the CAN table's state in the same form where the state has one
(config 5), and the step -- and writes it into ``<directory>/.<step>.tmp``,
which is then renamed ``<directory>/<step>``, so a directory that exists
holds a whole checkpoint.  The oldest directories past ``max_to_keep``
are removed.

* **One process** (no process group, or a group of one) writes it all to
  ``<step>/state.pt``.
* **P processes** (the default ``torch.distributed`` group, every process
  calling ``save`` with its own state, as JAX's sharded save through
  Orbax): rank 0 writes what every process holds alike -- the params, the
  Adam state, the step and P -- to ``state.pt``, and each rank writes its
  own rows of each table (``embedding/sharded.py``: global id g on
  process g % P at local row g // P) to ``shard-<rank>.pt``; then a
  barrier, rank 0 renames the directory and prunes, and a barrier again.
  The directory must be one that every process sees (a shared file
  system), as Orbax's must.

``restore(target=...)`` fills a state of any P: row g of the target's
process comes from the saved rank g % P', local row g // P', where P' is
the P that wrote the checkpoint (as Orbax restores onto the target's
shardings).  A checkpoint of 2 processes restores on 2 and on 1, and one
process's on 2.  Without a target it returns the saved dict of CPU
tensors, its tables as one process holds them.

Example:
    ckpt = CheckpointManager("/path/to/ckpt")
    ckpt.save(100, state)
    state = ckpt.restore(target=trainer.init(gen))   # latest, in place
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_FILE = "state.pt"
_SHARD = "shard-{}.pt"
_TABLES = ("table", "can_table")


def _cpu(x: Any) -> Any:
    """A detached CPU copy of every tensor in a nest of dicts and lists."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def _table_dict(table) -> Dict[str, Any]:
    """A table state's tensors by name (the ones it has)."""
    return {k: v for k, v in table._asdict().items() if v is not None}


def _group() -> Tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _reshard(parts: List[torch.Tensor], saved: int, rank: int, size: int,
             out: torch.Tensor) -> None:
    """Fill ``out``, process ``rank`` of ``size``'s rows of one table
    tensor (local row l: global id rank + size * l), from ``parts``, the
    rows each of ``saved`` processes wrote (global id g: part g % saved,
    row g // saved).  Rows past the saved ones (the padding of a larger
    P) keep their values; a () tensor (Adam's count) is copied."""
    if out.dim() == 0:
        out.copy_(parts[0])
        return
    if saved == size:
        out.copy_(parts[rank])
        return
    g = rank + size * torch.arange(out.shape[0])
    src, row = g % saved, g // saved
    for s, part in enumerate(parts):
        sel = torch.nonzero((src == s) & (row < part.shape[0])).squeeze(1)
        out[sel.to(out.device)] = part[row[sel]].to(out.device)


class CheckpointManager:
    """Step-numbered checkpoints under ``directory``, newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _FILE)))

    def save(self, step: int, state) -> None:
        """Snapshot ``state`` (a ``TrainState``; on P processes, each
        process's own, all calling together) to the CPU and write it as
        checkpoint ``step``; returns when it is written."""
        rank, size = _group()
        tables = {"table": _table_dict(state.table)}
        if state.can_table is not None:
            tables["can_table"] = _table_dict(state.can_table)
        common = {"params": dict(state.params),
                  "opt": state.opt.state_dict(), "step": state.step}
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp")
        if size == 1:
            self._fresh(tmp)
            torch.save(_cpu({**common, **tables}), os.path.join(tmp, _FILE))
            self._publish(tmp, final)
            return
        if rank == 0:
            self._fresh(tmp)
        dist.barrier()
        torch.save(_cpu(tables), os.path.join(tmp, _SHARD.format(rank)))
        if rank == 0:
            torch.save(_cpu({**common, "processes": size}),
                       os.path.join(tmp, _FILE))
        dist.barrier()
        if rank == 0:
            self._publish(tmp, final)
        dist.barrier()

    @staticmethod
    def _fresh(tmp: str) -> None:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

    def _publish(self, tmp: str, final: str) -> None:
        """The written ``tmp`` becomes ``final``; the oldest past
        ``max_to_keep`` go."""
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, target=None):
        """Checkpoint ``step`` (None: the latest).  With a ``target``
        ``TrainState`` (on P processes, each process's own, all calling)
        its tensors are overwritten in place on their own devices and a
        ``TrainState`` is returned; without one, the saved dict of CPU
        tensors, its tables as one process holds them."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, str(step))
        payload = torch.load(os.path.join(path, _FILE), map_location="cpu",
                             weights_only=True)
        saved = payload.pop("processes", 1)
        if saved == 1:
            shards = [{k: payload.pop(k) for k in _TABLES if k in payload}]
        else:
            shards = [torch.load(os.path.join(path, _SHARD.format(s)),
                                 map_location="cpu", weights_only=True,
                                 mmap=True) for s in range(saved)]
        if target is None:
            for key in shards[0]:
                payload[key] = {
                    name: self._merged([sh[key][name] for sh in shards])
                    for name in shards[0][key]}
            return payload
        return self._into(payload, shards, saved, target)

    @staticmethod
    def _merged(parts: List[torch.Tensor]) -> torch.Tensor:
        """One process's whole table tensor from every process's rows."""
        if len(parts) == 1 or parts[0].dim() == 0:
            return parts[0]
        out = parts[0].new_empty((len(parts) * parts[0].shape[0],)
                                 + tuple(parts[0].shape[1:]))
        _reshard(parts, len(parts), 0, 1, out)
        return out

    @staticmethod
    def _into(payload: Dict[str, Any], shards: List[Dict[str, Any]],
              saved: int, target):
        if set(payload["params"]) != set(target.params):
            raise ValueError(f"checkpoint params {sorted(payload['params'])}"
                             f" do not match {sorted(target.params)}")
        has_can = "can_table" in shards[0]
        if has_can != (target.can_table is not None):
            raise ValueError(
                f"checkpoint {'has' if has_can else 'lacks'}"
                f" a CAN table but the target state "
                f"{'lacks' if target.can_table is None else 'has'} one")
        tables = [("table", target.table)]
        if target.can_table is not None:
            tables.append(("can_table", target.can_table))
        for key, table in tables:
            have = set(_table_dict(table))
            if set(shards[0][key]) != have:
                raise ValueError(f"checkpoint {key} state "
                                 f"{sorted(shards[0][key])} does not match "
                                 f"{sorted(have)}")
        rank, size = _group()
        with torch.no_grad():
            for name, p in target.params.items():
                p.copy_(payload["params"][name])
            for key, table in tables:
                for name in shards[0][key]:
                    _reshard([sh[key][name] for sh in shards], saved, rank,
                             size, getattr(table, name))
        target.opt.load_state_dict(payload["opt"])
        return target._replace(step=payload["step"].to(target.step.device))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing to release."""
