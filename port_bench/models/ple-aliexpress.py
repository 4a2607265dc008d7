"""The program's side of ``ple-aliexpress``: the port's public
``PLEModel`` at MTReclib's AliExpress widths, on a per-field, one-hot
``FeatureConfig`` with 63 dense floats.  ``build_scorer`` looks a
request's (B, 16) ids up with B11 (``gather_rows``: every field's
hotness is 1) into (B, 16, 128) and runs the model, which projects the
request's (B, 63) floats into a 17th field."""
from __future__ import annotations

from torch import nn

from rec_now_tpu_torch.models import FeatureConfig, PLEModel


def feature_config(cfg: dict) -> FeatureConfig:
    return FeatureConfig(num_dense=cfg["num_dense_features"],
                         num_sparse=cfg["num_sparse_features"],
                         embedding_dim=cfg["embedding_dim"],
                         field_rows=tuple(cfg["num_embeddings_per_feature"]),
                         hotness=tuple(cfg["multi_hot_sizes"]))


def build(cfg: dict, device) -> nn.Module:
    """The model at the configuration's widths (its own weights are
    replaced by the benchmark's)."""
    return PLEModel(feature_config(cfg),
                    expert_dims=tuple(cfg["bottom_mlp_dims"]),
                    num_task=cfg["task_num"],
                    shared_experts=cfg["shared_expert_num"],
                    task_experts=cfg["specific_expert_num"],
                    tower_dims=tuple(cfg["tower_mlp_dims"]), device=device)
