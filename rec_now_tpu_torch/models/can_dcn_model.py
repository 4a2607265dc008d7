"""CAN co-action + DCN-v2 model -- benchmark config 5.

Counterpart of ``rec_now_tpu/models/can_dcn_model.py`` (``CANDCNModel``,
:24-72): a target field's id looks up per-sample co-action DNN
parameters from a second table (the trainer's ``can_table``); the CAN
layer applies that DNN to the history fields' embeddings and sums over
them; x = ``[SENET(embeddings), dense, CAN output]`` (26 * 16 + 13 + 16
= 445 wide at full width) feeds the DCN-mix cross stack and a DNN tower
side by side, then a one-logit glorot head on ``[cross, deep]``.
Submodules carry the Flax names (``senet``, ``dcn_mix``, ``deep``,
``head``; ``can`` has no parameters), so a converted Flax tree loads
with ``strict=True``.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.layers.can_layer import CANLayer
from rec_now_tpu_torch.layers.dcn_mix_layer import DCNMixLayer
from rec_now_tpu_torch.layers.senet_layer import SENETLayer
from rec_now_tpu_torch.models.feature_config import FeatureConfig
from rec_now_tpu_torch.models.tower import DNNTower


class CANDCNModel(nn.Module):
    """DCN-v2 tower augmented with CAN co-action features.

    Args:
        fc: input layout (fields, embedding dim, dense count).
        history_fields: the fields whose embeddings the CAN layer reads.
        can_dnn_dims, dcn_layers, dcn_experts, dcn_sub_dim, deep_dims,
            senet_reduction: as in the JAX model, with its defaults.
        device: where the parameters live ("cuda" unless asked otherwise).
        seed: seeds the CPU ``torch.Generator`` the init draws from.
    """

    def __init__(self, fc: FeatureConfig = FeatureConfig(),
                 history_fields: Sequence[int] = tuple(range(8)),
                 can_dnn_dims: Sequence[int] = (16,), dcn_layers: int = 2,
                 dcn_experts: int = 2, dcn_sub_dim: int = 16,
                 deep_dims: Sequence[int] = (256, 128),
                 senet_reduction: float = 0.5,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        fields = list(history_fields)
        # a run of fields is a view; any other set is gathered
        self._history = (slice(fields[0], fields[-1] + 1)
                         if fields == list(range(fields[0], fields[-1] + 1))
                         else fields)
        in_dim = (fc.num_sparse * fc.embedding_dim + fc.num_dense
                  + list(can_dnn_dims)[-1])
        self.can = CANLayer(dnn_dims=can_dnn_dims, output_combiner="sum")
        self.senet = SENETLayer(fc.num_sparse, senet_reduction, gen,
                                device=device)
        self.dcn_mix = DCNMixLayer(in_dim, dcn_sub_dim, dcn_layers,
                                   dcn_experts, gen, device=device)
        self.deep = DNNTower(in_dim, deep_dims, gen, device=device)
        self.head = make_linear(in_dim + deep_dims[-1], 1, device, gen)

    @staticmethod
    def can_param_size(embedding_dim: int,
                       can_dnn_dims: Sequence[int]) -> int:
        """Width of the co-action parameter table: D * D1 + D1 + ...
        (272 for D = 16 and one 16-wide layer)."""
        return CANLayer.get_dnn_param_size(embedding_dim,
                                           list(can_dnn_dims), True)

    def forward(self, dense: torch.Tensor, sparse_emb: torch.Tensor,
                can_params: torch.Tensor) -> torch.Tensor:
        """dense (B, num_dense), sparse_emb (B, F, D), can_params (B,
        can_param_size) -> (B,) logits."""
        can_out = self.can(sparse_emb[:, self._history], can_params)
        x = torch.cat([self.senet(sparse_emb), dense, can_out], dim=-1)
        head = torch.cat([self.dcn_mix(x), self.deep(x)], dim=-1)
        return self.head(head).squeeze(-1)
