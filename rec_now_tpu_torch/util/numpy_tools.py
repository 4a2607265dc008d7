"""Numpy test helpers (counterpart of ``rec_now_tpu/util/numpy_tools.py``)."""
from __future__ import annotations

import numpy as np


def calc_sum_of_abs_diff(arr1, arr2) -> float:
    """Sum of absolute differences between two array-likes."""
    arr1 = np.array(arr1, dtype=np.float64)
    arr2 = np.array(arr2, dtype=np.float64)
    return float(np.sum(np.abs(arr1 - arr2)))


def all_equal(arr1, arr2) -> bool:
    """Whether two array-likes are elementwise identical."""
    arr1 = np.array(arr1)
    arr2 = np.array(arr2)
    return bool(np.all(arr1 == arr2))
