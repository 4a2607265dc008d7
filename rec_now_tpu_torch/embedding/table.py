"""A logical (V, D) embedding table for serving.

Counterpart of ``rec_now_tpu/embedding/table.py`` and of the one-shard
``ShardedEmbeddingTable.lookup`` (``rec_now_tpu/embedding/sharded.py``).
The table is a plain row-major (V, D) float32 tensor; the TPU's lane
packing of ``128 // D`` rows per line is not kept (``convert.
table_from_packed`` reads a packed JAX table into this layout).  Rows
start uniform in +-``initializer_scale`` (``INIT_SCALE`` unless set; the
trainer's CAN table takes 0.05), as the JAX table does.
"""
from __future__ import annotations

from typing import Union

import torch

from rec_now_tpu_torch.core.config import resolve_device, uniform
from rec_now_tpu_torch.ops.gather_kernel import gather_rows

# rows start in U(-1e-3, 1e-3) (rec_now_tpu/embedding/sharded.py:291-293)
INIT_SCALE = 1e-3


class EmbeddingTable:
    """(V, D) table: ``init`` makes the tensor, ``lookup`` gathers rows.

    Example:
        table = EmbeddingTable(vocab_size=2_600_000, dim=16)
        weights = table.init(torch.Generator().manual_seed(0))
        emb = table.lookup(weights, ids)        # ids.shape + (D,)
    """

    def __init__(self, vocab_size: int, dim: int,
                 device: Union[str, torch.device] = "cuda",
                 initializer_scale: float = INIT_SCALE):
        self.vocab_size = vocab_size
        self.dim = dim
        self.device = resolve_device(device)
        self.initializer_scale = initializer_scale

    def init(self, generator: torch.Generator) -> torch.Tensor:
        """Rows ~ U(-initializer_scale, initializer_scale), drawn on the
        CPU, placed on the device."""
        t = uniform((self.vocab_size, self.dim), self.initializer_scale,
                    generator)
        return t.to(self.device)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows: int ids of any shape -> ids.shape + (D,)."""
        return gather_rows(table, ids)
