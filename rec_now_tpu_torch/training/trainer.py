"""One-device training: lookup -> model -> pointwise + pairwise loss ->
Adam on the dense params, row-wise Adagrad on the embedding rows.

Counterpart of ``rec_now_tpu/training/trainer.py`` (``TrainerConfig``,
``TrainState``, ``Trainer.put`` / ``init`` / ``train_step`` /
``eval_step``, :219-441) for one device and the options its callers set.
A step works as ``_step_body`` (:353-391):

1. the batch's ids are offset into the table's id space and looked up;
2. the looked-up rows become a leaf that requires grad;
3. the loss is ``_loss_fn``'s (:320-350): the mean pointwise sigmoid
   cross-entropy times ``pointwise_weight``, plus ``pairwise_weight *
   loss_sum / (n_pair + 1e-10)`` of the in-batch pairwise BPR loss;
4. ``torch.autograd.grad`` gives the params' and the rows' gradients;
5. ``torch.optim.Adam(lr=dense_lr)`` updates the params (optax.adam's
   math: b1 0.9, b2 0.999, eps 1e-8);
6. ``table.apply_grads`` runs dense-apply Adagrad on the rows.

The model's parameters, the Adam state and the table are updated in
place (JAX donates its state instead).  Metrics stay tensors on the
device: nothing in a step waits for the card.

Example:
    trainer = Trainer(XDeepFMModel(fc), fc, TrainerConfig(
        pairwise_weight=1.0, click_occurance_power=-0.5))
    state = trainer.init(torch.Generator().manual_seed(0))
    for batch in data.batches(8192, 100):
        state, metrics = trainer.train_step(state, *trainer.put(batch))
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from rec_now_tpu_torch.core.config import resolve_device
from rec_now_tpu_torch.embedding.sharded import (ShardedEmbeddingTable,
                                                 ShardedTableState)
from rec_now_tpu_torch.losses.pairwise import pairwise_loss
from rec_now_tpu_torch.losses.pointwise import \
    sigmoid_cross_entropy_with_logits
from rec_now_tpu_torch.models.feature_config import FeatureConfig
from rec_now_tpu_torch.training.data import Batch


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Loss weights and learning rates (the JAX fields the port's callers
    set, with the JAX defaults)."""
    pointwise_weight: float = 1.0
    pairwise_weight: float = 0.0
    click_occurance_power: float = 0.0
    pairwise_factor: float = 1.0
    dense_lr: float = 1e-3
    sparse_lr: float = 0.05


class TrainState(NamedTuple):
    """Everything a step changes (in place)."""
    params: Dict[str, torch.Tensor]      # the model's parameters by name
    opt: torch.optim.Adam                # Adam over ``params``
    table: ShardedTableState
    step: torch.Tensor                   # () int64 on the device


class Trainer:
    """Wires a model to the embedding table and the loss stack.

    Args:
        model: an ``nn.Module`` ``model(dense, sparse_emb) -> (B,)``
            logits, on ``device``.
        feature_config: the input layout.
        config: loss weights and learning rates.
        device: where the table and the step run ("cuda" unless asked).
    """

    def __init__(self, model: nn.Module, feature_config: FeatureConfig,
                 config: TrainerConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.fc = feature_config
        self.cfg = config
        self.table = ShardedEmbeddingTable(feature_config.total_rows,
                                           feature_config.embedding_dim,
                                           device=self.device)

    def put(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        """A host batch -> (dense, sparse_ids, labels, group_ids) on the
        device."""
        dev = self.device
        return (torch.as_tensor(batch.dense, dtype=torch.float32, device=dev),
                torch.as_tensor(batch.sparse_ids, device=dev),
                torch.as_tensor(batch.labels, dtype=torch.float32, device=dev),
                torch.as_tensor(batch.group_ids, device=dev))

    def init(self, generator: torch.Generator,
             params: Optional[Mapping[str, torch.Tensor]] = None,
             table: Optional[ShardedTableState] = None) -> TrainState:
        """A fresh state: the model's own parameters (or ``params``, a
        state_dict such as ``convert.from_jax_params`` gives, copied into
        them), a table drawn from ``generator`` (or ``table``), a new
        Adam."""
        own = dict(self.model.named_parameters())
        if params is not None:
            if set(params) != set(own):
                raise ValueError(f"params {sorted(params)} do not match the "
                                 f"model's {sorted(own)}")
            with torch.no_grad():
                for name, p in own.items():
                    p.copy_(torch.as_tensor(params[name]))
        if table is None:
            table = self.table.init(generator)
        opt = torch.optim.Adam(list(own.values()), lr=self.cfg.dense_lr)
        return TrainState(own, opt, table,
                          torch.zeros((), dtype=torch.int64,
                                      device=self.device))

    def _loss_fn(self, params, emb, dense, labels, groups
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        logits = functional_call(self.model, params, (dense, emb))
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        metrics = {}
        if cfg.pointwise_weight != 0.0:
            pw = sigmoid_cross_entropy_with_logits(labels, logits).mean()
            metrics["pointwise"] = pw.detach()
            loss = loss + cfg.pointwise_weight * pw
        if cfg.pairwise_weight != 0.0:
            pl_sum, n_pair = pairwise_loss(
                logits, labels, groups, factor=cfg.pairwise_factor,
                click_occurance_power=cfg.click_occurance_power)
            pair = pl_sum / (n_pair + 1e-10)
            metrics["pairwise"] = pair.detach()
            loss = loss + cfg.pairwise_weight * pair
        metrics["loss"] = loss.detach()
        return loss, metrics

    def train_step(self, state: TrainState, dense: torch.Tensor,
                   ids: torch.Tensor, labels: torch.Tensor,
                   groups: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimization step; ``state`` is updated in place and
        returned with the step count advanced."""
        gids = self.fc.global_ids(ids)
        emb = self.table.lookup(state.table, gids).requires_grad_()
        loss, metrics = self._loss_fn(state.params, emb, dense, labels,
                                      groups)
        names = list(state.params)
        grads = torch.autograd.grad(
            loss, [state.params[n] for n in names] + [emb])
        for name, g in zip(names, grads):
            state.params[name].grad = g
        state.opt.step()
        self.table.apply_grads(state.table, gids, grads[-1],
                               lr=self.cfg.sparse_lr)
        return state._replace(step=state.step + 1), metrics

    def eval_step(self, state: TrainState, dense: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
        """Logits for an eval batch (no state change)."""
        with torch.no_grad():
            emb = self.table.lookup(state.table, self.fc.global_ids(ids))
            return functional_call(self.model, state.params, (dense, emb))

