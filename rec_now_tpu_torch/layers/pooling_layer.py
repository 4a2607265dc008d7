"""Combiner-dispatch pooling.

Counterpart of ``rec_now_tpu/layers/pooling_layer.py`` (``pool`` and
``PoolingLayer``, :12-57): reduce an axis by ``"mean"``, ``"sum"``,
``"max"`` or ``"min"``, apply a callable, or pass the input through
(``None``).  ``axis=None`` reduces every axis, as ``jnp.sum`` does.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

_COMBINERS = {
    "mean": torch.mean,
    "sum": torch.sum,
    "max": torch.amax,
    "min": torch.amin,
}


def pool(inputs: torch.Tensor, combiner: Optional[Union[str, Callable]],
         axis: Optional[int] = None, keepdims: bool = False) -> torch.Tensor:
    """Functional pooling: None (identity), a combiner name or a callable
    (applied to ``inputs`` alone); any other combiner raises."""
    if combiner is None:
        return inputs
    if callable(combiner):
        return combiner(inputs)
    if combiner in _COMBINERS:
        dims = tuple(range(inputs.dim())) if axis is None else axis
        return _COMBINERS[combiner](inputs, dim=dims, keepdim=keepdims)
    raise ValueError("combiner must be one of None, 'mean', 'sum', 'max', "
                     "'min' or a callable object")


class PoolingLayer(nn.Module):
    """Module wrapper over :func:`pool`.

    Example:
        PoolingLayer(axis=0, keepdims=True, combiner="sum")(
            torch.tensor([[1, 2, 3], [10, 11, 12]])) == [[11, 13, 15]]
    """

    def __init__(self, axis: Optional[int] = None, keepdims: bool = False,
                 combiner: Optional[Union[str, Callable]] = None):
        super().__init__()
        self.axis, self.keepdims, self.combiner = axis, keepdims, combiner

    def forward(self, inputs) -> torch.Tensor:
        return pool(torch.as_tensor(inputs), self.combiner, self.axis,
                    self.keepdims)
