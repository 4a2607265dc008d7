"""MMoE + PLE multi-task model with STAR domain towers -- benchmark
config 4.

Counterpart of ``rec_now_tpu/models/multitask_model.py``
(``MultiTaskModel``, :21-72): ``[flat embeddings, dense]`` -> MMoE ->
the T task views concatenated -> PLE -> per task a
:class:`ParasiticStarDenseLayer` tower (ReLU, the domain chosen by
``domain_idx``) and a one-logit head.  Submodules carry the Flax names
(``mmoe``, ``ple``, ``star_tower_{t}``, ``head_{t}``).  The counts the
benchmark config sets as the JAX defaults -- 2 tasks (CTR and CVR), 4
domains, 4 MMoE experts, 2 PLE experts per task -- are constants here;
the widths stay arguments.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.layers.mmoe_layer import MMOELayer
from rec_now_tpu_torch.layers.ple_layer import PLELayer
from rec_now_tpu_torch.layers.star_dense_layer import ParasiticStarDenseLayer
from rec_now_tpu_torch.models.feature_config import FeatureConfig

NUM_TASK, NUM_DOMAINS, MMOE_EXPERTS, PLE_EXPERTS = 2, 4, 4, 2


class MultiTaskModel(nn.Module):
    """MMoE -> PLE -> STAR domain towers, one logit per task.

    Args:
        fc: input layout (fields, embedding dim, dense count).
        mmoe_dims, ple_dims, tower_dim: as in the JAX model.
        device: where the parameters live ("cuda" unless asked otherwise).
        seed: seeds the CPU ``torch.Generator`` the init draws from.
    """

    def __init__(self, fc: FeatureConfig = FeatureConfig(),
                 mmoe_dims: Sequence[int] = (128, 64),
                 ple_dims: Sequence[int] = (64,), tower_dim: int = 32,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        in_dim = fc.num_sparse * fc.embedding_dim + fc.num_dense
        self.mmoe = MMOELayer(in_dim, NUM_TASK, MMOE_EXPERTS, mmoe_dims, gen,
                              device=device)
        self.ple = PLELayer(NUM_TASK * mmoe_dims[-1], NUM_TASK,
                            [list(ple_dims)], PLE_EXPERTS, gen, device=device)
        for t in range(NUM_TASK):
            setattr(self, f"star_tower_{t}", ParasiticStarDenseLayer(
                ple_dims[-1], tower_dim, NUM_DOMAINS, gen, device=device))
            setattr(self, f"head_{t}", make_linear(tower_dim, 1, device, gen))

    def forward(self, dense: torch.Tensor, sparse_emb: torch.Tensor,
                domain_idx: Union[int, torch.Tensor, None] = 0
                ) -> torch.Tensor:
        """dense (B, num_dense), sparse_emb (B, F, D) -> (T, B) logits.

        ``domain_idx``: an int serves the batch from one domain, an int
        tensor (B,) routes each sample to its own (see
        :class:`ParasiticStarDenseLayer`).
        """
        b, f, d = sparse_emb.shape
        x = torch.cat([sparse_emb.reshape(b, f * d), dense], dim=-1)
        mmoe_out = self.mmoe(x)                               # (T, B, U)
        ple_in = torch.cat(list(mmoe_out.unbind(0)), dim=-1)  # (B, T*U)
        ple_outs = self.ple(ple_in)                           # [(B, U2)] * T
        logits = []
        for t in range(NUM_TASK):
            h = getattr(self, f"star_tower_{t}")(ple_outs[t], domain_idx)
            logits.append(getattr(self, f"head_{t}")(h).squeeze(-1))
        return torch.stack(logits, dim=0)                     # (T, B)
