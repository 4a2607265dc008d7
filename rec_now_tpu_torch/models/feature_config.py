"""Criteo-style input layout shared by the benchmark models.

Counterpart of ``rec_now_tpu/models/feature_config.py``: ``num_dense``
dense floats and ``num_sparse`` categorical fields embedded at
``embedding_dim`` from one shared id space, field f's raw ids offset
into a disjoint range of rows.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Input layout shared by the benchmark models."""
    num_dense: int = 13
    num_sparse: int = 26
    rows_per_field: int = 100_000
    embedding_dim: int = 16

    @property
    def total_rows(self) -> int:
        return self.num_sparse * self.rows_per_field

    def field_offsets(self, device: Union[str, torch.device] = "cpu"
                      ) -> torch.Tensor:
        """(num_sparse,) int64 id offset of each field in the shared table,
        made on ``device``."""
        return torch.arange(self.num_sparse, device=device
                            ) * self.rows_per_field

    def global_ids(self, raw_ids: torch.Tensor) -> torch.Tensor:
        """Offset per-field raw ids (B, F) into the shared id space (int64)."""
        # made on the ids' device: no host-to-device copy per request
        offs = self.field_offsets(raw_ids.device)
        return (raw_ids.to(torch.int64) % self.rows_per_field) + offs[None, :]
