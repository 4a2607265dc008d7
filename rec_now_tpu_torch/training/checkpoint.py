"""Checkpoints of a training state in step-numbered directories.

Counterpart of ``rec_now_tpu/training/checkpoint.py`` (its
``CheckpointManager`` interface: ``save``, ``restore``, ``latest_step``,
``wait``, ``close``, ``max_to_keep=3``), built on ``torch.save`` /
``torch.load`` instead of Orbax.  A save takes a synchronous CPU snapshot
of the whole :class:`TrainState` -- the params, the Adam ``state_dict``,
the table state (rows, accumulator and, under lazy Adam, m, v and the
count), the CAN table's state in the same form where the state has one
(config 5), and the step -- and writes ``<directory>/<step>/state.pt``
through a temporary file, so a directory that exists holds a whole
checkpoint.  The oldest directories past ``max_to_keep`` are removed.

Example:
    ckpt = CheckpointManager("/path/to/ckpt")
    ckpt.save(100, state)
    state = ckpt.restore(target=trainer.init(gen))   # latest, in place
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

_FILE = "state.pt"


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
        """Snapshot ``state`` (a ``TrainState``) to the CPU and write it
        as checkpoint ``step``; returns when the file is written."""
        payload = {
            "params": dict(state.params),
            "opt": state.opt.state_dict(),
            "table": _table_dict(state.table),
            "step": state.step,
        }
        if state.can_table is not None:
            payload["can_table"] = _table_dict(state.can_table)
        payload = _cpu(payload)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, target=None):
        """Checkpoint ``step`` (None: the latest).  With a ``target``
        ``TrainState`` its tensors are overwritten in place on their own
        devices and a ``TrainState`` is returned; without one, the saved
        dict of CPU tensors."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(os.path.join(self.directory, str(step), _FILE),
                             map_location="cpu", weights_only=True)
        if target is None:
            return payload
        return self._into(payload, target)

    @staticmethod
    def _into(payload: Dict[str, Any], target):
        if set(payload["params"]) != set(target.params):
            raise ValueError(f"checkpoint params {sorted(payload['params'])}"
                             f" do not match {sorted(target.params)}")
        if ("can_table" in payload) != (target.can_table is not None):
            raise ValueError(
                f"checkpoint {'has' if 'can_table' in payload else 'lacks'}"
                f" a CAN table but the target state "
                f"{'lacks' if target.can_table is None else 'has'} one")
        tables = [("table", target.table)]
        if target.can_table is not None:
            tables.append(("can_table", target.can_table))
        for key, table in tables:
            have = set(_table_dict(table))
            if set(payload[key]) != have:
                raise ValueError(f"checkpoint {key} state "
                                 f"{sorted(payload[key])} does not match "
                                 f"{sorted(have)}")
        with torch.no_grad():
            for name, p in target.params.items():
                p.copy_(payload["params"][name])
            for key, table in tables:
                for name, t in payload[key].items():
                    getattr(table, name).copy_(t)
        target.opt.load_state_dict(payload["opt"])
        return target._replace(step=payload["step"].to(target.step.device))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing to release."""
