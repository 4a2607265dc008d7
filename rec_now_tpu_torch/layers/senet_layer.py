"""SENET feature recalibration (FiBiNET).

Counterpart of ``rec_now_tpu/layers/senet_layer.py`` (``SENETLayer``):
squeeze each field to its mean, run the bottleneck F -> mid -> F (two
``Dense`` layers, tanh after each, glorot weights and zero biases; mid =
max(round(F * reduction_ratio), 1), 13 at F = 26 and 0.5), and scale
every element of a field by its weight.  Two input forms, as JAX's:

* equal-dim fields as one (B, F, D) tensor (:45-57, :78-80), the path of
  configs 2 and 5 -> (B, F * D);
* a list of F (B, Df) fields whose dims may differ (:58-65, :81-83), or
  one (B, D) tensor as one field: each field's weight goes to its
  elements by the position -> field map
  (``rec_block/embedding_wise_weight.py``) -> (B, sum Df).

The two layers sit at ``senet.dense_0`` / ``senet.dense_1``, as Flax's
``"senet/dense_0"`` names become after ``convert`` turns ``/`` into a
dot; inside ``DCNv2Model``'s ``senet`` they load as
``senet.senet.dense_0.weight``.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.rec_block.embedding_wise_weight import \
    gather_embedding_element_wise_weight


class SENETLayer(nn.Module):
    """Squeeze-excite per-field reweighting of ``num_field`` fields."""

    def __init__(self, num_field: int, reduction_ratio: float,
                 generator: torch.Generator,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        mid = max(int(round(num_field * reduction_ratio)), 1)
        self.senet = nn.Module()
        self.senet.dense_0 = make_linear(num_field, mid, device, generator)
        self.senet.dense_1 = make_linear(mid, num_field, device, generator)

    def _weights(self, squeezed: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.senet.dense_0(squeezed))
        return torch.tanh(self.senet.dense_1(h))                # (B, F)

    def forward(self, inputs: Union[torch.Tensor, List[torch.Tensor]]
                ) -> torch.Tensor:
        if isinstance(inputs, torch.Tensor) and inputs.dim() == 3:
            weights = self._weights(inputs.mean(dim=-1))        # (B, F)
            out = inputs * weights[:, :, None]
            return out.reshape(out.shape[0], -1)                # (B, F*D)
        fields = (list(inputs) if isinstance(inputs, (list, tuple))
                  else [inputs])
        if len(fields) != self.senet.dense_0.in_features:
            raise ValueError(
                f"SENETLayer: {len(fields)} fields given, built for "
                f"{self.senet.dense_0.in_features}")
        pos_idx = np.concatenate([np.full(int(x.shape[-1]), i, np.int64)
                                  for i, x in enumerate(fields)])
        weights = self._weights(torch.cat(
            [x.mean(dim=-1, keepdim=True) for x in fields], dim=-1))
        return torch.cat(fields, dim=-1) * \
            gather_embedding_element_wise_weight(weights, pos_idx)
