"""Plain PyTorch pieces the configurations' references share: TF32 on or
off, the global ids of the shared table, the glorot limit.  Nothing here
imports the program."""
from __future__ import annotations

import math

import numpy as np
import torch


def set_tf32(on: bool) -> None:
    """TF32 in matrix products and convolutions on (the control) or off
    (the reference)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def global_ids(raw: np.ndarray, rows_per_field: int, device) -> torch.Tensor:
    """(B, F) raw per-field ids -> int64 rows of the shared table: field
    f's ids offset by f * rows_per_field."""
    ids = torch.from_numpy(np.asarray(raw, np.int64)).to(device)
    off = torch.arange(ids.shape[1], device=device) * rows_per_field
    return ids % rows_per_field + off[None, :]


def glorot(fan_in: int, fan_out: int) -> float:
    """The glorot-uniform limit sqrt(6 / (fan_in + fan_out))."""
    return math.sqrt(6.0 / (fan_in + fan_out))
