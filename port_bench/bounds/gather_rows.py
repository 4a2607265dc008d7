"""Bound of B11, ``gather_rows(table, ids)`` (``ops/gather_kernel.py``):
the distinct rows read once, the (N, D) rows written, the ids read; no
arithmetic (PERF.md section 6, row 13)."""
import torch

TARGET = "rec_now_tpu_torch.ops.gather_kernel:gather_rows"


def record(args, kwargs):
    table, ids = args[0], args[1]
    return {"rows": table.shape[0], "d": table.shape[1], "ids": ids}


def work(rec):
    ids = rec["ids"].reshape(-1)
    n, d = ids.numel(), rec["d"]
    distinct = int(torch.unique(ids.clamp(0, rec["rows"] - 1)).numel())
    return 0, distinct * d * 4 + n * d * 4 + n * ids.element_size()
