"""Expand per-field weights to per-element weights.

Counterpart of ``rec_now_tpu/rec_block/embedding_wise_weight.py``: a
gather along the last axis by a fixed position -> field map.

Symbols: B batch, F fields, total_dim = sum of per-field dims.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def gather_embedding_element_wise_weight(
        embedding_weights: torch.Tensor,
        pos_idx: Union[Sequence[int], np.ndarray, torch.Tensor]
) -> torch.Tensor:
    """Per-field weights (B, F) -> per-element weights (B, total_dim).

    Args:
        embedding_weights: (B, F) per-field weights.
        pos_idx: length-total_dim map from position to field index.
    """
    idx = torch.as_tensor(np.asarray(pos_idx, dtype=np.int64).reshape(-1),
                          device=embedding_weights.device)
    return embedding_weights.index_select(-1, idx)
