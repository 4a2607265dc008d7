"""Pad-or-truncate one axis to a fixed length.

Counterpart of ``rec_now_tpu/layers/fix_length_layer.py``, on
``core/shapes.py`` ``pad_or_truncate`` (padding at the end with
``constant_values``).
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import as_input, resolve_device
from rec_now_tpu_torch.core.shapes import pad_or_truncate


class FixLengthLayer(nn.Module):
    """Bring ``axis`` of the input to extent ``length``.  An input given as
    a list or an array is placed on the layer's device."""

    def __init__(self, length: int, axis: int = -1,
                 constant_values: float = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.length, self.axis = length, axis
        self.constant_values = constant_values

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return pad_or_truncate(as_input(inputs, self.device),
                               self.length, self.axis, self.constant_values)
