"""SENET feature recalibration (FiBiNET), the stacked fast path.

Counterpart of ``rec_now_tpu/layers/senet_layer.py`` (``SENETLayer``,
:45-57 and :78-80) for equal-dim fields given as one (B, F, D) tensor:
squeeze each field to its mean over D, run the bottleneck F -> mid -> F
(two ``Dense`` layers, tanh after each, glorot weights and zero biases;
mid = max(round(F * reduction_ratio), 1), 13 at F = 26 and 0.5), and
scale every element of a field by its weight.  The list path for fields
of unequal dims is not ported: a list input raises.

The two layers sit at ``senet.dense_0`` / ``senet.dense_1``, as Flax's
``"senet/dense_0"`` names become after ``convert`` turns ``/`` into a
dot; inside ``DCNv2Model``'s ``senet`` they load as
``senet.senet.dense_0.weight``.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device


class SENETLayer(nn.Module):
    """Squeeze-excite per-field reweighting: (B, F, D) -> (B, F * D)."""

    def __init__(self, num_field: int, reduction_ratio: float,
                 generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        mid = max(int(round(num_field * reduction_ratio)), 1)
        self.senet = nn.Module()
        self.senet.dense_0 = make_linear(num_field, mid, device, generator)
        self.senet.dense_1 = make_linear(mid, num_field, device, generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if not isinstance(inputs, torch.Tensor) or inputs.dim() != 3:
            raise NotImplementedError(
                "SENETLayer takes one (B, F, D) tensor; the list path for "
                "fields of unequal dims is not ported yet")
        squeezed = inputs.mean(dim=-1)                          # (B, F)
        h = torch.tanh(self.senet.dense_0(squeezed))
        weights = torch.tanh(self.senet.dense_1(h))             # (B, F)
        out = inputs * weights[:, :, None]
        return out.reshape(out.shape[0], -1)                    # (B, F*D)
