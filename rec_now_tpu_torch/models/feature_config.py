"""Criteo-style input layout shared by the benchmark models.

Counterpart of ``rec_now_tpu/models/feature_config.py``: ``num_dense``
dense floats and ``num_sparse`` categorical fields embedded at
``embedding_dim`` from one shared id space, field f's raw ids offset
into a disjoint range of rows.

By default every field has ``rows_per_field`` rows and one id an example,
as in the JAX package.  A per-field layout (DLRM's, MLPerf's Criteo 1TB)
gives ``field_rows`` and ``hotness`` together: each field's own row
count (``rows_per_field`` is then not read) and the ids each field
carries an example, which the field sum-pools.  A request's ids are then
(B, sum(hotness)) columns, field f's ``hotness[f]`` ids side by side,
fields in order.  Paths that know only the default layout (the trainer,
the wire and ``WireScorer``, the CAN lookup) refuse a per-field one
(:meth:`FeatureConfig.refuse_per_field`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Input layout shared by the benchmark models."""
    num_dense: int = 13
    num_sparse: int = 26
    rows_per_field: int = 100_000
    embedding_dim: int = 16
    field_rows: Optional[Tuple[int, ...]] = None
    hotness: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if (self.field_rows is None) != (self.hotness is None):
            raise ValueError("field_rows and hotness are given together, "
                             f"got field_rows={self.field_rows}, "
                             f"hotness={self.hotness}")
        if not self.per_field:
            return
        for name in ("field_rows", "hotness"):
            value = tuple(int(v) for v in getattr(self, name))
            if len(value) != self.num_sparse or min(value, default=1) < 1:
                raise ValueError(f"{name} needs num_sparse = "
                                 f"{self.num_sparse} counts of at least 1, "
                                 f"got {value}")
            object.__setattr__(self, name, value)

    @property
    def per_field(self) -> bool:
        """True for a per-field layout (``field_rows`` and ``hotness``)."""
        return self.hotness is not None

    @property
    def total_rows(self) -> int:
        if self.per_field:
            return sum(self.field_rows)
        return self.num_sparse * self.rows_per_field

    def field_offsets(self, device: Union[str, torch.device] = "cpu"
                      ) -> torch.Tensor:
        """(num_sparse,) int64 id offset of each field in the shared table,
        made on ``device``."""
        if self.per_field:
            return _columns(self.field_rows, (1,) * self.num_sparse,
                            torch.device(device))[1].clone()
        return torch.arange(self.num_sparse, device=device
                            ) * self.rows_per_field

    def global_ids(self, raw_ids: torch.Tensor) -> torch.Tensor:
        """Offset per-field raw ids into the shared id space (int64): (B,
        sum(hotness)) or (B, num_sparse), each column's raw id modulo its
        field's rows plus the field's offset."""
        if not self.per_field:
            # made on the ids' device: no host-to-device copy per request
            offs = self.field_offsets(raw_ids.device)
            return ((raw_ids.to(torch.int64) % self.rows_per_field)
                    + offs[None, :])
        mod, offs = _columns(self.field_rows, self.hotness, raw_ids.device)
        if raw_ids.shape[-1] != mod.shape[0]:
            raise ValueError(f"ids need {mod.shape[0]} columns (sum of "
                             f"hotness), got {tuple(raw_ids.shape)}")
        return raw_ids.to(torch.int64) % mod + offs

    def refuse_per_field(self, what: str) -> None:
        """Raise for a per-field layout: ``what`` takes one
        ``rows_per_field`` and one id a field."""
        if self.per_field:
            raise ValueError(
                f"{what} takes one rows_per_field and one id a field; this "
                "FeatureConfig has per-field rows and hotness (field_rows="
                f"{self.field_rows}, hotness={self.hotness})")


@functools.lru_cache(maxsize=64)
def _columns(field_rows: Tuple[int, ...], hotness: Tuple[int, ...],
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, offset) of each id column's field, (sum(hotness),) int64 on
    ``device``, made once a layout and device."""
    # normal tensors even when first asked for under inference_mode
    with torch.inference_mode(False):
        rows = torch.tensor(field_rows, dtype=torch.int64)
        offs = torch.cumsum(rows, 0) - rows
        reps = torch.tensor(hotness)
        return (rows.repeat_interleave(reps).to(device),
                offs.repeat_interleave(reps).to(device))
