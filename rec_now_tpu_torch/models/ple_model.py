"""PLE (Progressive Layered Extraction; Tang, Liu, Zhao and Gong, RecSys
2020) as MTReclib's ``PLEModel`` builds it (github.com/easezyc/
Multitask-Recommendation-Library, ``models/ple.py``).  No counterpart in
the JAX package, whose PLE runs inside ``MultiTaskModel``.

Per example: the ``num_dense`` floats through one ``Linear`` to the
embedding width become one more field after the ``num_sparse`` looked-up
ones; the (F + 1) * D flat input runs a :class:`~rec_now_tpu_torch.
layers.PLELayer` in the paper's form (``paper_form``: each level's
inputs the gated outputs below, experts ending in ReLU): at each level
one shared bank and one bank a task, each expert one Linear -> ReLU, the
banks on B8 (``multi_dense_fused``) on CUDA; then per task a
:class:`~rec_now_tpu_torch.models.DNNTower` with ReLU after every layer
and a one-logit head.  The extraction network is the span ``ple`` and
the towers and heads the span ``towers``, each with the stream's time
across it on CUDA (``core/profiling.py``).  Served, BatchNorm is folded
into the Linear before it and dropout is off, so neither is a layer
here.  Float32 throughout; nothing here turns TF32 on.

At MTReclib's AliExpress widths (16 fields and 63 dense floats, all 128
wide: 2,176 in; levels of 512 and 256; 4 shared experts and 4 a task, 2
tasks; towers 128-64-1) an example is 30.20 MFLOP, 98.9% of it in the
expert banks.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.layers.ple_layer import PLELayer
from rec_now_tpu_torch.models.feature_config import FeatureConfig
from rec_now_tpu_torch.models.tower import DNNTower


class PLEModel(nn.Module):
    """Dense projection as a field -> PLE -> a tower and a logit a task.

    Args:
        fc: input layout; its ``embedding_dim`` is the width of every
            field and of the dense floats' projection.
        expert_dims: each extraction level's expert width (one Linear
            an expert).
        num_task: tasks, one gated output, tower and logit each.
        shared_experts, task_experts: experts of the shared bank and of
            each task's bank, at every level.
        tower_dims: each task tower's widths before its one-logit head.
        device: where the parameters live ("cuda" unless asked otherwise).
        seed: seeds the CPU ``torch.Generator`` the init draws from.
    """

    def __init__(self, fc: FeatureConfig,
                 expert_dims: Sequence[int] = (512, 256), num_task: int = 2,
                 shared_experts: int = 4, task_experts: int = 4,
                 tower_dims: Sequence[int] = (128, 64),
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.num_task = num_task
        self.dense_proj = make_linear(fc.num_dense, fc.embedding_dim, device,
                                      gen)
        self.ple = PLELayer((fc.num_sparse + 1) * fc.embedding_dim, num_task,
                            [[d] for d in expert_dims],
                            [[shared_experts] + [task_experts] * num_task],
                            gen, device=device, paper_form=True)
        for t in range(num_task):
            setattr(self, f"tower_{t}", DNNTower(expert_dims[-1], tower_dims,
                                                 gen, device=device))
            setattr(self, f"head_{t}", make_linear(tower_dims[-1], 1, device,
                                                   gen))

    def forward(self, dense: torch.Tensor,
                sparse_emb: torch.Tensor) -> torch.Tensor:
        """dense (B, num_dense), sparse_emb (B, F, D) -> (T, B) logits."""
        b = sparse_emb.shape[0]
        x = torch.cat([sparse_emb, self.dense_proj(dense)[:, None, :]],
                      dim=1).reshape(b, -1)
        with profiling.span("ple", device=x.is_cuda):
            outs = self.ple(x)                          # [(B, U_last)] * T
        with profiling.span("towers", device=x.is_cuda):
            return torch.stack([
                getattr(self, f"head_{t}")(getattr(self, f"tower_{t}")(
                    outs[t], relu_last=True)).squeeze(-1)
                for t in range(self.num_task)])
