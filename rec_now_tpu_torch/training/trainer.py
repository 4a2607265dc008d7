"""One-device training: lookup -> model -> pointwise + in-batch ranking
losses -> Adam on the dense params, row-wise Adagrad or lazy sparse Adam on
the embedding rows.

Counterpart of ``rec_now_tpu/training/trainer.py`` (``TrainerConfig``,
``TrainState``, ``Trainer.put`` / ``init`` / ``train_step`` /
``eval_step``, :219-441) for one device and the options its callers set.
A step works as ``_step_body`` (:353-391):

1. the batch's ids are offset into the table's id space and looked up;
2. the looked-up rows become a leaf that requires grad;
3. the loss is ``_loss_fn``'s (:320-350): the mean pointwise sigmoid
   cross-entropy times ``pointwise_weight``, plus ``pairwise_weight *
   loss_sum / (n_pair + 1e-10)`` of the in-batch pairwise BPR loss (with
   ``binary_labels=True``: the labels are clicks, :264-275), plus
   ``listwise_weight`` times the in-batch listwise loss's mean over its
   valid groups (0 without one, :288-307).  With ``num_tasks > 1`` the
   model gives (T, B) logits: task 0's drive those losses, and task 1's
   against the conversion labels add their mean sigmoid cross-entropy
   (``cvr_loss``) at weight 1 (:329-348).  A model whose ``forward``
   takes ``domain_idx`` gets the batch's per-sample domains (:142-149);
4. ``torch.autograd.grad`` gives the params' and the rows' gradients;
5. ``torch.optim.Adam(lr=dense_lr)`` updates the params (optax.adam's
   math: b1 0.9, b2 0.999, eps 1e-8);
6. ``table.apply_grads`` updates the rows: ``sparse_optimizer``
   ``"adagrad"`` (row-wise) or ``"adam"`` (lazy: only the looked-up rows
   and their moments move), by the path ``sparse_update_mode`` picks
   (``"auto"``, ``"dense"``, ``"sparse"``; ``embedding/sharded.py``).

The model's parameters, the Adam state and the table are updated in
place (JAX donates its state instead).  Metrics stay tensors on the
device: nothing in a step waits for the card.

``put`` gives the JAX tuple ``(dense, ids, labels, groups, cvr,
domain)`` and ``train_step`` takes it.

Example:
    trainer = Trainer(XDeepFMModel(fc), fc, TrainerConfig(
        pairwise_weight=1.0, click_occurance_power=-0.5))
    state = trainer.init(torch.Generator().manual_seed(0))
    for batch in data.batches(8192, 100):
        state, metrics = trainer.train_step(state, *trainer.put(batch))
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from rec_now_tpu_torch.core.config import resolve_device
from rec_now_tpu_torch.embedding.sharded import (ShardedEmbeddingTable,
                                                 ShardedTableState)
from rec_now_tpu_torch.losses.listwise import listwise_loss_sum
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
    listwise_weight: float = 0.0
    click_occurance_power: float = 0.0
    pairwise_factor: float = 1.0
    dense_lr: float = 1e-3
    sparse_lr: float = 0.05
    sparse_optimizer: str = "adagrad"   # "adagrad" | "adam" (lazy, rowwise)
    sparse_update_mode: str = "auto"    # "auto" | "sparse" | "dense"
    num_tasks: int = 1          # >1: multi-task (CTR + CVR) heads


class TrainState(NamedTuple):
    """Everything a step changes (in place)."""
    params: Dict[str, torch.Tensor]      # the model's parameters by name
    opt: torch.optim.Adam                # Adam over ``params``
    table: ShardedTableState             # with m, v, count under Adam
    step: torch.Tensor                   # () int64 on the device


class Trainer:
    """Wires a model to the embedding table and the loss stack.

    Args:
        model: an ``nn.Module`` ``model(dense, sparse_emb) -> (B,)``
            logits, or (T, B) with ``num_tasks`` = T > 1, on ``device``;
            its ``forward`` may take ``domain_idx``.
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
        self.table = ShardedEmbeddingTable(
            feature_config.total_rows, feature_config.embedding_dim,
            device=self.device, optimizer=config.sparse_optimizer,
            update_mode=config.sparse_update_mode)
        # the per-sample domain goes only to models that route on it
        # (MultiTaskModel's STAR towers)
        self._takes_domain = "domain_idx" in inspect.signature(
            model.forward).parameters

    def put(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        """A host batch -> (dense, sparse_ids, labels, group_ids,
        cvr_labels, domain_idx) on the device."""
        dev = self.device
        f32 = torch.float32
        return (torch.as_tensor(batch.dense, dtype=f32, device=dev),
                torch.as_tensor(batch.sparse_ids, device=dev),
                torch.as_tensor(batch.labels, dtype=f32, device=dev),
                torch.as_tensor(batch.group_ids, device=dev),
                torch.as_tensor(batch.cvr_labels, dtype=f32, device=dev),
                torch.as_tensor(batch.domain_idx, device=dev))

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

    def _forward(self, params, dense, emb, domain) -> torch.Tensor:
        kw = {"domain_idx": domain} if self._takes_domain else {}
        return functional_call(self.model, params, (dense, emb), kw)

    def _loss_fn(self, params, emb, dense, labels, groups, cvr, domain
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        logits = self._forward(params, dense, emb, domain)
        metrics = {}
        if cfg.num_tasks > 1:
            task_logits = logits                            # (T, B)
            logits = task_logits[0]
            cvr_loss = sigmoid_cross_entropy_with_logits(
                cvr, task_logits[1]).mean()
            metrics["cvr_loss"] = cvr_loss.detach()
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        if cfg.pointwise_weight != 0.0:
            pw = sigmoid_cross_entropy_with_logits(labels, logits).mean()
            metrics["pointwise"] = pw.detach()
            loss = loss + cfg.pointwise_weight * pw
        if cfg.pairwise_weight != 0.0:
            pl_sum, n_pair = pairwise_loss(
                logits, labels, groups, factor=cfg.pairwise_factor,
                click_occurance_power=cfg.click_occurance_power,
                return_num_pair=True, reduce_mean=False,
                binary_labels=True)
            pair = pl_sum / (n_pair + 1e-10)
            metrics["pairwise"] = pair.detach()
            loss = loss + cfg.pairwise_weight * pair
        if cfg.listwise_weight != 0.0:
            lsum, lcount = listwise_loss_sum(logits, labels, groups)
            listwise = torch.where(lcount > 0,
                                   lsum / lcount.clamp_min(1.0),
                                   torch.zeros_like(lsum))
            metrics["listwise"] = listwise.detach()
            loss = loss + cfg.listwise_weight * listwise
        if cfg.num_tasks > 1:
            loss = loss + cvr_loss
        metrics["loss"] = loss.detach()
        return loss, metrics

    def train_step(self, state: TrainState, dense: torch.Tensor,
                   ids: torch.Tensor, labels: torch.Tensor,
                   groups: torch.Tensor, cvr: torch.Tensor,
                   domain: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimization step on :meth:`put`'s tuple; ``state`` is
        updated in place and returned with the step count advanced."""
        gids = self.fc.global_ids(ids)
        emb = self.table.lookup(state.table, gids).requires_grad_()
        loss, metrics = self._loss_fn(state.params, emb, dense, labels,
                                      groups, cvr, domain)
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
                  ids: torch.Tensor,
                  domain: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits for an eval batch (no state change); a model that
        routes on the domain gets ``domain``, or zeros (B,) without
        one."""
        if domain is None:
            domain = torch.zeros(ids.shape[0], dtype=torch.int32,
                                 device=ids.device)
        with torch.no_grad():
            emb = self.table.lookup(state.table, self.fc.global_ids(ids))
            return self._forward(state.params, dense, emb, domain)

