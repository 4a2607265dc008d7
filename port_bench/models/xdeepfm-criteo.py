"""The program's side of ``xdeepfm-criteo``: xDeepFM as published (Lian et
al., KDD 2018), assembled from rec_now_tpu_torch's public
layers, the way a user of the port's layer library builds it.

The table's rows are 11 wide: a feature's 10-wide embedding and its
linear weight.  Per example, with e the (F, 10) embeddings:

* the linear part: the sum of the F linear weights (w_linear . a over
  one-hot features);
* the CIN: ``CINLayer`` with its hidden layers only (``output_input``
  off) and no channel sum, each feature map then summed over the
  embedding axis (p+);
* the DNN: ``DNNTower`` over the flattened embeddings, ReLU after every
  layer, the last too (x_dnn);
* the output unit: one linear layer over [p+, x_dnn], plus the linear
  part.

The request carries no dense features (every Criteo field is
categorical in the paper), so ``dense`` is (B, 0) and unused.
"""
from __future__ import annotations

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear
from rec_now_tpu_torch.layers import CINLayer
from rec_now_tpu_torch.models import FeatureConfig
from rec_now_tpu_torch.models.tower import DNNTower


def feature_config(cfg: dict) -> FeatureConfig:
    return FeatureConfig(num_dense=0, num_sparse=cfg["num_fields"],
                         rows_per_field=cfg["rows_per_field"],
                         embedding_dim=cfg["table_width"])


class XDeepFM(nn.Module):
    """Parameters ``cin.weight_of_layer{i}``, ``deep.dense_{i}.*`` and
    ``head.*``, the names of the reference's ``param_specs``."""

    def __init__(self, cfg: dict, device):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        f, d = cfg["num_fields"], cfg["embedding_dim"]
        hs = [cfg["cin_layer_size"]] * cfg["cin_layers"]
        dims = [cfg["dnn_layer_size"]] * cfg["dnn_layers"]
        self.d = d
        self.cin = CINLayer(f, hs, generator=gen, device=device)
        self.deep = DNNTower(f * d, dims, generator=gen, device=device)
        self.head = make_linear(sum(hs) + dims[-1], 1, device, gen)

    def forward(self, dense: torch.Tensor,
                sparse_emb: torch.Tensor) -> torch.Tensor:
        """sparse_emb (B, F, 11) -> (B,) logits."""
        b, f, _ = sparse_emb.shape
        e = sparse_emb[..., :self.d]
        linear = sparse_emb[..., self.d].sum(-1)
        p = self.cin(e, output_input=False, sum_channel=False)
        p = p.reshape(b, -1, self.d).sum(-1)                 # (B, sum(Hs))
        x = torch.relu(self.deep(e.reshape(b, f * self.d)))
        return self.head(torch.cat([p, x], dim=-1)).squeeze(-1) + linear


def build(cfg: dict, device) -> nn.Module:
    """The model at the configuration's widths (its own weights are
    replaced by the benchmark's)."""
    return XDeepFM(cfg, device)
