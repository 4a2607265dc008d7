"""Inner Product-based Neural Network (IPNN) layer.

Counterpart of ``rec_now_tpu/layers/inner_pnn_layer.py``: one batched
Gram product ``(B, F, D) x (B, D, F) -> (B, F, F)`` in f32, then the
static strict-upper-triangle gather, row-major -- the pair order of the
reference loop.  The layer has no parameters.
"""
from __future__ import annotations

import torch
from torch import nn


class InnerPNNLayer(nn.Module):
    """All pairwise inner products of field embeddings -> (B, P)."""

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        """emb (B, F, D) -> (B, F * (F - 1) / 2)."""
        f = emb.shape[1]
        gram = torch.bmm(emb, emb.transpose(1, 2))          # (B, F, F)
        rows, cols = torch.triu_indices(f, f, offset=1, device=emb.device)
        return gram[:, rows, cols]
