"""FM model -- benchmark config #1.

Counterpart of ``rec_now_tpu/models/fm_model.py`` (``FMModel``): the FM
second-order term of the per-field embeddings, plus first-order terms (a
linear layer on the flattened embeddings and one on the dense features)
and a bias, summed to one logit.  Submodules and the bias carry the Flax
names (``fm``, ``linear_sparse``, ``linear_dense``, ``bias``), so a
converted Flax tree loads with ``strict=True``.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.layers.fm_layer import FMLayer
from rec_now_tpu_torch.models.feature_config import FeatureConfig


class FMModel(nn.Module):
    """Factorization-machine CTR model over looked-up embeddings.

    Args:
        fc: input layout (fields, embedding dim, dense count).
        device: where the parameters live ("cuda" unless asked otherwise).
        seed: seeds the CPU ``torch.Generator`` the init draws from.
    """

    def __init__(self, fc: FeatureConfig = FeatureConfig(),
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.fm = FMLayer()
        self.linear_sparse = make_linear(fc.num_sparse * fc.embedding_dim, 1,
                                         device, gen)
        self.linear_dense = make_linear(fc.num_dense, 1, device, gen)
        self.bias = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, dense: torch.Tensor,
                sparse_emb: torch.Tensor) -> torch.Tensor:
        """dense (B, num_dense), sparse_emb (B, F, D) -> (B,) logits."""
        second_order = self.fm(sparse_emb)                  # (B, 1)
        first_sparse = self.linear_sparse(
            sparse_emb.reshape(sparse_emb.shape[0], -1))    # (B, 1)
        first_dense = self.linear_dense(dense)              # (B, 1)
        logit = second_order + first_sparse + first_dense + self.bias
        return logit.squeeze(-1)
