"""xDeepFM-style CIN + inner-PNN model -- benchmark config #3.

Counterpart of ``rec_now_tpu/models/xdeepfm_model.py``: per-field
embeddings go through the CIN and the inner-PNN beside a DNN tower on
``[flat embeddings, dense]``; the head reads ``[cin, pnn, deep, dense]``
in that order.  Submodules carry the Flax names (``cin``, ``ipnn``,
``deep``, ``head``).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import resolve_device
from rec_now_tpu_torch.layers.cin_layer import CINLayer
from rec_now_tpu_torch.layers.inner_pnn_layer import InnerPNNLayer
from rec_now_tpu_torch.models.feature_config import FeatureConfig
from rec_now_tpu_torch.models.tower import DNNTower, make_linear


class XDeepFMModel(nn.Module):
    """CIN + iPNN + deep tower CTR model.

    Args:
        fc: input layout (fields, embedding dim, dense count).
        cin_hidden_sizes, cin_sum_channel, deep_dims: as in the JAX model.
        device: where the parameters live ("cuda" unless asked otherwise).
        seed: seeds the CPU ``torch.Generator`` the init draws from.
    """

    def __init__(self, fc: FeatureConfig = FeatureConfig(),
                 cin_hidden_sizes: Sequence[int] = (64, 64),
                 cin_sum_channel: bool = True,
                 deep_dims: Sequence[int] = (256, 128),
                 device: Union[str, torch.device] = "cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        f, d = fc.num_sparse, fc.embedding_dim
        self.cin_sum_channel = cin_sum_channel
        self.cin = CINLayer(f, cin_hidden_sizes, device=device,
                            generator=gen)
        self.ipnn = InnerPNNLayer()
        self.deep = DNNTower(f * d + fc.num_dense, deep_dims, device=device,
                             generator=gen)
        cin_dim = (d if cin_sum_channel
                   else (f + sum(cin_hidden_sizes)) * d)
        head_in = cin_dim + f * (f - 1) // 2 + deep_dims[-1] + fc.num_dense
        self.head = make_linear(head_in, 1, device, gen)

    def forward(self, dense: torch.Tensor,
                sparse_emb: torch.Tensor) -> torch.Tensor:
        """dense (B, num_dense), sparse_emb (B, F, D) -> (B,) logits."""
        b, f, d = sparse_emb.shape
        cin = self.cin(sparse_emb, sum_channel=self.cin_sum_channel)
        pnn = self.ipnn(sparse_emb)
        deep = self.deep(torch.cat([sparse_emb.reshape(b, f * d), dense],
                                   dim=-1))
        head = torch.cat([cin, pnn, deep, dense], dim=-1)
        return self.head(head).squeeze(-1)
