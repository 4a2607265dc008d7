"""DCN-v2 (DCN-mix) + SENET model -- benchmark config 2, the flagship.

Counterpart of ``rec_now_tpu/models/dcn_model.py`` (``DCNv2Model``,
:21-56): per-field embeddings -> SENET recalibration -> x =
``[recalibrated embeddings, dense]`` (26 * 16 + 13 = 429 wide at full
width) -> the DCN-mix cross stack and a DNN tower side by side -> a
one-logit head on ``[cross, deep]``.  Submodules carry the Flax names
(``senet``, ``dcn_mix``, ``deep``, ``head``), so a converted Flax tree
loads with ``strict=True``.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.layers.dcn_mix_layer import DCNMixLayer
from rec_now_tpu_torch.layers.senet_layer import SENETLayer
from rec_now_tpu_torch.models.feature_config import FeatureConfig
from rec_now_tpu_torch.models.tower import DNNTower


class DCNv2Model(nn.Module):
    """SENET + DCN-mix + deep tower CTR model.

    Args:
        fc: input layout (fields, embedding dim, dense count).
        dcn_layers, dcn_experts, dcn_sub_dim, deep_dims, use_senet,
            senet_reduction: as in the JAX model, with its defaults.
        device: where the parameters live ("cuda" unless asked otherwise).
        seed: seeds the CPU ``torch.Generator`` the init draws from.
    """

    def __init__(self, fc: FeatureConfig = FeatureConfig(),
                 dcn_layers: int = 2, dcn_experts: int = 2,
                 dcn_sub_dim: int = 16,
                 deep_dims: Sequence[int] = (256, 128),
                 use_senet: bool = True, senet_reduction: float = 0.5,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        in_dim = fc.num_sparse * fc.embedding_dim + fc.num_dense
        self.use_senet = use_senet
        if use_senet:
            self.senet = SENETLayer(fc.num_sparse, senet_reduction, gen,
                                    device=device)
        self.dcn_mix = DCNMixLayer(in_dim, dcn_sub_dim, dcn_layers,
                                   dcn_experts, gen, device=device)
        self.deep = DNNTower(in_dim, deep_dims, gen, device=device)
        self.head = make_linear(in_dim + deep_dims[-1], 1, device, gen)

    def forward(self, dense: torch.Tensor,
                sparse_emb: torch.Tensor) -> torch.Tensor:
        """dense (B, num_dense), sparse_emb (B, F, D) -> (B,) logits."""
        b, f, d = sparse_emb.shape
        flat = (self.senet(sparse_emb) if self.use_senet
                else sparse_emb.reshape(b, f * d))
        x = torch.cat([flat, dense], dim=-1)
        head = torch.cat([self.dcn_mix(x), self.deep(x)], dim=-1)
        return self.head(head).squeeze(-1)
