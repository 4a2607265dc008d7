"""DLRM-DCNv2 as MLPerf Training runs it on Criteo 1TB (the MLCommons
reference ``recommendation_v2/torchrec_dlrm``, TorchRec's ``DLRM_DCN``;
DLRM, arXiv:1906.00091; DCN-V2, arXiv:2008.13535).  No counterpart in
the JAX package.

Per example: the dense arch, an MLP with ReLU after every layer, maps
the ``num_dense`` floats to the embedding width; the interaction
concatenates ``[dense_out, pooled]`` (dense first, as TorchRec's
``InteractionDCNArch``) into (F + 1) * D and runs the low-rank cross
stack (:class:`~rec_now_tpu_torch.layers.LowRankCrossLayer`); the over
arch, an MLP with ReLU after every layer, and one linear unit give the
logit.  The sparse input is each field's embedding, sum-pooled over its
multi-hot ids by the scorer (``serving._forward``, ``gather_pool_rows``).
The cross stack is the span ``cross`` and the over arch's MLP the span
``over``, each with the stream's time across it on CUDA
(``core/profiling.py``).  Both MLPs ask their towers for the ReLU after
the last layer, so where no gradient is recorded it runs in B8's
epilogue with each layer the tower routes to it (``models/tower.py``).
Float32 throughout; nothing here turns TF32 on.

At MLPerf's widths (13 dense, 26 fields of 128, dense arch 512-256-128,
3 cross layers of rank 512, over arch 1024-1024-512-256-1) an example is
32.06 MFLOP, 66% of it in the cross stack.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.layers.low_rank_cross_layer import LowRankCrossLayer
from rec_now_tpu_torch.models.feature_config import FeatureConfig
from rec_now_tpu_torch.models.tower import DNNTower


class DLRMDCNv2Model(nn.Module):
    """Dense arch -> [dense, pooled] -> low-rank cross -> over arch.

    Args:
        fc: input layout; its ``embedding_dim`` is the width of every
            field and of the dense arch's output.
        dense_arch: the dense MLP's widths, the last = ``embedding_dim``.
        cross_layers, cross_rank: the low-rank cross stack.
        over_arch: the over MLP's widths before the one-logit unit.
        device: where the parameters live ("cuda" unless asked otherwise).
        seed: seeds the CPU ``torch.Generator`` the init draws from.
    """

    def __init__(self, fc: FeatureConfig,
                 dense_arch: Sequence[int] = (512, 256, 128),
                 cross_layers: int = 3, cross_rank: int = 512,
                 over_arch: Sequence[int] = (1024, 1024, 512, 256),
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        if dense_arch[-1] != fc.embedding_dim:
            raise ValueError(f"the dense arch ends at {dense_arch[-1]}, the "
                             f"embeddings are {fc.embedding_dim} wide")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        in_dim = (fc.num_sparse + 1) * fc.embedding_dim
        self.dense_arch = DNNTower(fc.num_dense, dense_arch, gen,
                                   device=device)
        self.cross = LowRankCrossLayer(in_dim, cross_rank, cross_layers, gen,
                                       device=device)
        self.over_arch = DNNTower(in_dim, over_arch, gen, device=device)
        self.head = make_linear(over_arch[-1], 1, device, gen)

    def forward(self, dense: torch.Tensor,
                sparse_emb: torch.Tensor) -> torch.Tensor:
        """dense (B, num_dense), sparse_emb (B, F, D) pooled -> (B,)
        logits."""
        b = sparse_emb.shape[0]
        x = self.dense_arch(dense, relu_last=True)
        x0 = torch.cat([x[:, None, :], sparse_emb], dim=1).reshape(b, -1)
        with profiling.span("cross", device=x0.is_cuda):
            x = self.cross(x0)
        with profiling.span("over", device=x.is_cuda):
            x = self.over_arch(x, relu_last=True)
        return self.head(x).squeeze(-1)
