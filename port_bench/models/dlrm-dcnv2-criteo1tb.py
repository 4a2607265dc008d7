"""The program's side of ``dlrm-dcnv2-criteo1tb``: the port's public
``DLRMDCNv2Model`` at MLPerf's widths, on a per-field, multi-hot
``FeatureConfig`` of the rows this card holds.  ``build_scorer`` looks a
request's (B, 214) ids up sum-pooled (``gather_pool_rows``) into (B, 26,
128) and runs the model; the dense arch takes the request's (B, 13)
floats."""
from __future__ import annotations

from torch import nn

from rec_now_tpu_torch.models import DLRMDCNv2Model, FeatureConfig


def feature_config(cfg: dict) -> FeatureConfig:
    return FeatureConfig(num_dense=cfg["num_dense_features"],
                         num_sparse=cfg["num_sparse_features"],
                         embedding_dim=cfg["embedding_dim"],
                         field_rows=tuple(cfg["num_embeddings_per_feature"]),
                         hotness=tuple(cfg["multi_hot_sizes"]))


def build(cfg: dict, device) -> nn.Module:
    """The model at the configuration's widths (its own weights are
    replaced by the benchmark's); the over arch's last width, 1, is its
    output unit."""
    over = cfg["over_arch_layer_sizes"]
    if over[-1] != 1:
        raise ValueError(f"the over arch ends in one logit, got {over}")
    return DLRMDCNv2Model(feature_config(cfg),
                          dense_arch=tuple(cfg["dense_arch_layer_sizes"]),
                          cross_layers=cfg["dcn_num_layers"],
                          cross_rank=cfg["dcn_low_rank_dim"],
                          over_arch=tuple(over[:-1]), device=device)
