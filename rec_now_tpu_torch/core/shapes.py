"""Static-shape helpers.

Counterpart of ``rec_now_tpu/core/shapes.py``:

* ``wrap_as_list`` -- a value in a list unless it already is one;
* ``pad_or_truncate`` -- one axis of a tensor cut or zero-padded (at its
  end) to a fixed length, with ``torch.nn.functional.pad``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def wrap_as_list(inputs):
    """Wrap ``inputs`` in a list unless it already is one."""
    if not isinstance(inputs, list):
        inputs = [inputs]
    return inputs


def pad_or_truncate(tensor: torch.Tensor, length: int, axis: int = -1,
                    constant_values=0) -> torch.Tensor:
    """Pad (at the end) or truncate ``axis`` of ``tensor`` to ``length``.

    Args:
        tensor: input tensor.
        length: target length of ``axis``.
        axis: axis to normalize.
        constant_values: fill value used when padding.

    Returns:
        A tensor whose ``axis`` has extent exactly ``length`` (``tensor``
        itself when it already has).
    """
    length = int(length)
    rank = tensor.dim()
    axis = axis % rank
    origin_length = tensor.shape[axis]
    if length < origin_length:
        return tensor.narrow(axis, 0, length)
    if length > origin_length:
        # F.pad lists (before, after) pairs from the last axis backwards
        pad = [0, 0] * (rank - axis)
        pad[-1] = length - origin_length
        return F.pad(tensor, pad, value=constant_values)
    return tensor
