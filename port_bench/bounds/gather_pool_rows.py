"""Bound of the pooled multi-hot lookup, ``gather_pool_rows(table, ids,
hotness)`` (``ops/gather_kernel.py``): the distinct rows read once, the
(B, F, D) pooled rows written, the ids read; no arithmetic counted (the
adds are under a thousandth of the bytes' time).

A program without the wrapper (before it was added) gets a ``TARGET``
that no module of the program holds, so the recorder wraps nothing."""
import importlib

import torch

_HOME = "rec_now_tpu_torch.ops.gather_kernel"


def _absent(*args, **kwargs):
    raise RuntimeError("the program has no gather_pool_rows")


TARGET = (f"{_HOME}:gather_pool_rows"
          if hasattr(importlib.import_module(_HOME), "gather_pool_rows")
          else f"{__name__}:_absent")


def record(args, kwargs):
    table, ids, hotness = args[0], args[1], args[2]
    return {"rows": table.shape[0], "d": table.shape[1], "ids": ids,
            "fields": len(hotness)}


def work(rec):
    ids, d = rec["ids"], rec["d"]
    distinct = int(torch.unique(ids.clamp(0, rec["rows"] - 1)).numel())
    pooled = ids.shape[0] * rec["fields"]
    return 0, (distinct + pooled) * d * 4 + ids.numel() * ids.element_size()
