"""Training on one device or one process per device: lookup -> model ->
pointwise + in-batch ranking losses -> Adam on the dense params, row-wise
Adagrad or lazy sparse Adam on the embedding rows.

Counterpart of ``rec_now_tpu/training/trainer.py`` (``TrainerConfig``,
``TrainState``, ``Trainer.put`` / ``init`` / ``train_step`` /
``eval_step``, :219-441) for the options its callers set.
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

``metrics["sparse_dropped"]`` counts the ids the routed exchange dropped
in the step, both tables and every process (0 on one device and on the
allgather exchange; ``sparse_route_mode``, ``route_cap_factor`` and
``route_ov_cap`` go to both tables).  It stays on the device; with
``route_strict``, ``check_dropped`` reads it and raises on a drop, and
``fit`` calls it at its log cadence (:633-640).

With ``can_param_field`` set (config 5, ``CANDCNModel``; :75-79,
:125-140), a second table, ``can_table`` (``rows_per_field`` rows of the
CAN layer's parameter count, ``CANDCNModel.can_param_size``: 272 at
D = 16 and ``can_dnn_dims=(16,)``; rows U(-0.05, 0.05), the same
optimizer and update mode), is looked up by that field's raw ids modulo
``rows_per_field``; its rows are the model's third input, take their
gradient in step 4 with the others and are updated in step 6 at
``sparse_lr`` (:357-391).  Every loop (``train_step``, ``eval_step``
and the loops on them: ``train_many``, ``train_many_packed``,
``evaluate``, ``evaluate_device``) goes through the second lookup.

The model's parameters, the Adam state and the table are updated in
place (JAX donates its state instead).  Metrics stay tensors on the
device: nothing in a step waits for the card.

``put`` gives the JAX tuple ``(dense, ids, labels, groups, cvr,
domain)`` and ``train_step`` takes it.

**On a mesh** (``mesh=``, ``parallel/mesh.py``: P processes, one per
device, as JAX's trainer on a mesh of P devices) each process feeds its
own slice of the global batch (``put``), the tables are
mod-sharded over the processes (``embedding/sharded.py``), and:

* the in-batch ranking losses are built per process, on its own rows,
  as JAX builds them per data shard (``_ranking_losses``, :252-318); their
  sums and counts, and the pointwise and CVR sums, are combined by one
  ``all_reduce`` of a small vector before the backward (JAX's ``psum``,
  :285-286, :303-304; the global means of :332-337);
* each process runs its backward on its share of the global loss
  (``w_pw * sum_local(pointwise) / B_global + w_pair * pair_sum_local /
  (n_pair_global + 1e-10) + w_lw * list_sum_local / max(L_global, 1) +``
  the CVR term as the pointwise one), so that the shares add up to the
  global loss, and the parameter gradients are **summed** by one
  ``all_reduce``: JAX's dense gradient is the global loss's, which XLA
  sums over the shards (``DistributedDataParallel`` would average);
* the tables exchange rows by ``sparse_route_mode``: allgather, or the
  routed exchange (``embedding/exchange.py``), the default on 4 or more
  processes; the dropped counts come summed from the lookups, so a step
  still calls ``all_reduce`` twice;
* the parameters start from rank 0's (broadcast in ``init``) and Adam
  runs alike on every process; the metrics are the global values on
  every process;
* ``evaluate`` all-gathers each batch's (group, label, cvr, logit)
  columns (:657-664); ``evaluate_device`` sums its histograms over the
  processes and, with more than one, maps corpus groups by hash
  (:779-780);
* the wire packs each process's window as one shard
  (``put_packed_window``; JAX's ``put_packed_window_local``, :517-567);
  hot8 ids fall back to packed ones with JAX's warning on more than one
  process (:483-489).

The windowed loop (``trainer.py:443-622``): ``put_packed_window`` packs a
window of host batches in the compressed wire (``training/wire.py``, ids
bit-packed or, with ``wire_id_mode="hot8"``, byte codes with the window's
own table; on the card by its C++ pack) and moves it to the device; on the card the
copy runs on a side stream from pinned memory and the call returns once
it has landed, so a prefetch thread (``training/prefetch.py``) carries
the wait while the loop thread computes.  ``train_many_packed`` then runs
the window's steps in order,
each decoding its own slice on the device (a loop of steps in place of
JAX's ``lax.scan``).  Evaluation is exact on the host (``evaluate``) or
device-resident over the packed wire (``evaluate_device``, bucketed AUC
and corpus or in-batch GAUC, ``training/metrics.py``).

Example:
    trainer = Trainer(XDeepFMModel(fc), fc, TrainerConfig(
        pairwise_weight=1.0, click_occurance_power=-0.5))
    state = trainer.init(torch.Generator().manual_seed(0))
    for batch in data.batches(8192, 100):
        state, metrics = trainer.train_step(state, *trainer.put(batch))
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import warnings
from typing import (Callable, Dict, Iterable, List, Mapping, NamedTuple,
                    Optional, Tuple, Union)

import numpy as np
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
from rec_now_tpu_torch.models.can_dcn_model import CANDCNModel
from rec_now_tpu_torch.models.feature_config import FeatureConfig
from rec_now_tpu_torch.training.data import Batch
from rec_now_tpu_torch.training.metrics import (CorpusGroupIndexer,
                                                DeviceGroupedAUC,
                                                DeviceStreamingAUC,
                                                StreamingGAUC,
                                                batch_gauc_stats)
from rec_now_tpu_torch.training.prefetch import WindowPrefetcher
from rec_now_tpu_torch.training.wire import (PackedBatch, WireFormat,
                                             to_tensors)

# the columns evaluate gathers from every process: group, label, cvr, and
# one per task's logits
_EVAL_COLUMNS = 3


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
    sparse_route_mode: str = "auto"     # "auto" | "allgather" | "routed"
    # raise (check_dropped, at log cadence) when the routed exchange drops
    # ids to double overflow (metrics["sparse_dropped"] > 0)
    route_strict: bool = False
    # the routed exchange's owner bucket (this times the uniform share)
    # and overflow lane (None: b // 16), given to both tables
    route_cap_factor: float = 2.0
    route_ov_cap: Optional[int] = None
    num_tasks: int = 1          # >1: multi-task (CTR + CVR) heads
    # CAN co-action (config 5): this field's ids look up per-item CAN
    # parameters in a second table, the model's third input
    can_param_field: Optional[int] = None
    can_dnn_dims: tuple = (16,)
    wire_dense_mode: str = "f16"        # "f16" | "u8" (training/wire.py)
    # "packed" | "hot8" (lossless byte codes of each field's hot ids; each
    # window carries the table it was encoded with)
    wire_id_mode: str = "packed"


class TrainState(NamedTuple):
    """Everything a step changes (in place)."""
    params: Dict[str, torch.Tensor]      # the model's parameters by name
    opt: torch.optim.Adam                # Adam over ``params``
    table: ShardedTableState             # with m, v, count under Adam
    step: torch.Tensor                   # () int64 on the device
    can_table: Optional[ShardedTableState] = None   # with can_param_field


class Trainer:
    """Wires a model to the embedding table and the loss stack.

    Args:
        model: an ``nn.Module`` ``model(dense, sparse_emb) -> (B,)``
            logits, or (T, B) with ``num_tasks`` = T > 1, on ``device``;
            its ``forward`` may take ``domain_idx``; with
            ``can_param_field``, ``model(dense, sparse_emb, can_params)``.
        feature_config: the input layout.
        config: loss weights and learning rates.
        device: where the table and the step run ("cuda" unless asked;
            on a mesh, the mesh's device).
        mesh: a :class:`~rec_now_tpu_torch.parallel.Mesh` of the
            processes that train together (module docstring), or None
            for one device.
    """

    def __init__(self, model: nn.Module, feature_config: FeatureConfig,
                 config: TrainerConfig,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        feature_config.refuse_per_field("Trainer")
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.model = model
        self.fc = feature_config
        self.cfg = config
        route = dict(route_mode=config.sparse_route_mode,
                     route_cap_factor=config.route_cap_factor,
                     route_ov_cap=config.route_ov_cap)
        self.table = ShardedEmbeddingTable(
            feature_config.total_rows, feature_config.embedding_dim,
            device=self.device, optimizer=config.sparse_optimizer,
            update_mode=config.sparse_update_mode, mesh=mesh, **route)
        self.can_table = None
        if config.can_param_field is not None:
            # co-action params multiply embeddings: a small centred init
            # (the CAN output starts near zero and the table learns)
            self.can_table = ShardedEmbeddingTable(
                feature_config.rows_per_field,
                CANDCNModel.can_param_size(feature_config.embedding_dim,
                                           config.can_dnn_dims),
                device=self.device, initializer_scale=0.05,
                optimizer=config.sparse_optimizer,
                update_mode=config.sparse_update_mode, mesh=mesh, **route)
        # the per-sample domain goes only to models that route on it
        # (MultiTaskModel's STAR towers)
        self._takes_domain = "domain_idx" in inspect.signature(
            model.forward).parameters
        self._wire: Optional[WireFormat] = None
        # packed windows land through a side stream; the stream that
        # computes on them is the one current when the trainer was built
        self._side = self._compute = None
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.current_stream(self.device)

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

    def put_local(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        """JAX's name (:165-186) for :meth:`put`, kept to mirror its API:
        on a mesh each process puts its own slice of the global batch
        (local batch = global batch / processes) on its own device, and
        no global array is built."""
        return self.put(batch)

    def init(self, generator: torch.Generator,
             params: Optional[Mapping[str, torch.Tensor]] = None,
             table: Optional[ShardedTableState] = None,
             can_table: Optional[ShardedTableState] = None) -> TrainState:
        """A fresh state: the model's own parameters (or ``params``, a
        state_dict such as ``convert.from_jax_params`` gives, copied into
        them), a table drawn from ``generator`` (or ``table``), then, with
        ``can_param_field``, the CAN table drawn from the same generator
        (or ``can_table``), and a new Adam.  On a mesh the parameters
        are rank 0's (broadcast), and ``table`` / ``can_table`` are this
        process's rows (``convert.table_state_for_rank``)."""
        own = dict(self.model.named_parameters())
        if params is not None:
            if set(params) != set(own):
                raise ValueError(f"params {sorted(params)} do not match the "
                                 f"model's {sorted(own)}")
            with torch.no_grad():
                for name, p in own.items():
                    p.copy_(torch.as_tensor(params[name]))
        if self.mesh is not None:
            with torch.no_grad():
                self._flat_collective(list(own.values()),
                                      self.mesh.broadcast)
        if table is None:
            table = self.table.init(generator)
        if self.can_table is None:
            can_table = None
        elif can_table is None:
            can_table = self.can_table.init(generator)
        opt = torch.optim.Adam(list(own.values()), lr=self.cfg.dense_lr)
        return TrainState(own, opt, table,
                          torch.zeros((), dtype=torch.int64,
                                      device=self.device), can_table)

    def _lookup(self, state: TrainState, ids: torch.Tensor):
        """(global ids, their rows, CAN ids, their CAN rows, the ids both
        lookups dropped over every process): the CAN pair is (None, None)
        without ``can_param_field``."""
        gids = self.fc.global_ids(ids)
        emb, dropped = self.table.lookup(state.table, gids,
                                         return_dropped=True)
        if self.can_table is None:
            return gids, emb, None, None, dropped
        can_ids = ids[:, self.cfg.can_param_field] % self.fc.rows_per_field
        can_emb, can_dropped = self.can_table.lookup(
            state.can_table, can_ids, return_dropped=True)
        return gids, emb, can_ids, can_emb, dropped + can_dropped

    def _forward(self, params, dense, emb, can_emb, domain) -> torch.Tensor:
        kw = {"domain_idx": domain} if self._takes_domain else {}
        args = (dense, emb) if can_emb is None else (dense, emb, can_emb)
        return functional_call(self.model, params, args, kw)

    def _loss_fn(self, params, emb, can_emb, dense, labels, groups, cvr,
                 domain) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss this process backpropagates and the step's metrics.
        Each term is a local sum over its count (step 3 of the module
        docstring); on a mesh the counts, and the sums the metrics read,
        are every process's, from one ``all_reduce`` of a small vector,
        so the loss is this process's share of the global one."""
        cfg = self.cfg
        logits = self._forward(params, dense, emb, can_emb, domain)
        cvr_sum = None
        if cfg.num_tasks > 1:
            cvr_sum = sigmoid_cross_entropy_with_logits(cvr,
                                                        logits[1]).sum()
            logits = logits[0]                          # task 0 of (T, B)
        dev = logits.device
        b = logits.shape[0]
        if self.mesh is not None:
            # made on the device: a count copied from the host would wait
            # for the card
            b = torch.full((), b, dtype=torch.float32, device=dev)
        # (name, weight, local sum with its gradient, local count)
        terms = []
        if cfg.pointwise_weight != 0.0:
            terms.append(("pointwise", cfg.pointwise_weight,
                          sigmoid_cross_entropy_with_logits(labels,
                                                            logits).sum(), b))
        if cfg.pairwise_weight != 0.0:
            pl_sum, n_pair = pairwise_loss(
                logits, labels, groups, factor=cfg.pairwise_factor,
                click_occurance_power=cfg.click_occurance_power,
                return_num_pair=True, reduce_mean=False,
                binary_labels=True)
            terms.append(("pairwise", cfg.pairwise_weight, pl_sum, n_pair))
        if cfg.listwise_weight != 0.0:
            lsum, lcount = listwise_loss_sum(logits, labels, groups)
            terms.append(("listwise", cfg.listwise_weight, lsum, lcount))
        if cvr_sum is not None:
            terms.append(("cvr_loss", 1.0, cvr_sum, b))
        sums = [s.detach() for _, _, s, _ in terms]
        counts = [c for *_, c in terms]
        if self.mesh is not None and terms:
            stats = self.mesh.all_reduce(torch.stack([
                torch.stack([s, c]).to(torch.float32)
                for s, c in zip(sums, counts)]))        # (terms, 2) global
            sums, counts = list(stats[:, 0]), list(stats[:, 1])
        loss = total = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {}
        for (name, weight, s, _), s_all, c in zip(terms, sums, counts):
            if name == "pairwise":
                den = c + 1e-10
            elif name == "listwise":
                den = c.clamp_min(1.0)
            else:
                den = c
            share = s / den
            if name == "listwise":                   # 0 without a group
                share = torch.where(c > 0, share, torch.zeros_like(share))
            loss = loss + weight * share
            if self.mesh is None:
                metrics[name] = share.detach()
                continue
            mean = s_all / den
            if name == "listwise":
                mean = torch.where(c > 0, mean, torch.zeros_like(mean))
            metrics[name] = mean
            total = total + weight * mean
        if cvr_sum is not None:                      # JAX's order
            metrics = {"cvr_loss": metrics.pop("cvr_loss"), **metrics}
        metrics["loss"] = loss.detach() if self.mesh is None else total
        return loss, metrics

    def _flat_collective(self, tensors: List[torch.Tensor],
                         op: Callable[[torch.Tensor], torch.Tensor]
                         ) -> List[torch.Tensor]:
        """``op`` (a mesh collective, in place) on ``tensors`` as one flat
        buffer: one call for any number of tensors.  Writes the result
        back into each and returns them."""
        flat = op(torch.cat([t.reshape(-1) for t in tensors]))
        for t, part in zip(tensors, flat.split([t.numel()
                                                for t in tensors])):
            t.copy_(part.view_as(t))
        return tensors

    def train_step(self, state: TrainState, dense: torch.Tensor,
                   ids: torch.Tensor, labels: torch.Tensor,
                   groups: torch.Tensor, cvr: torch.Tensor,
                   domain: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimization step on :meth:`put`'s tuple; ``state`` is
        updated in place and returned with the step count advanced."""
        gids, emb, can_ids, can_emb, dropped = self._lookup(state, ids)
        leaves = [emb.requires_grad_()]
        if can_emb is not None:
            leaves.append(can_emb.requires_grad_())
        loss, metrics = self._loss_fn(state.params, emb, can_emb, dense,
                                      labels, groups, cvr, domain)
        names = list(state.params)
        grads = torch.autograd.grad(
            loss, [state.params[n] for n in names] + leaves)
        if self.mesh is not None:
            # summed, not averaged: each process's loss is its share of
            # the global one
            self._flat_collective(list(grads[:len(names)]),
                                  self.mesh.all_reduce)
        for name, g in zip(names, grads):
            state.params[name].grad = g
        state.opt.step()
        lr = self.cfg.sparse_lr
        self.table.apply_grads(state.table, gids, grads[len(names)], lr=lr)
        if can_emb is not None:
            self.can_table.apply_grads(state.can_table, can_ids,
                                       grads[len(names) + 1], lr=lr)
        # the same ids drive the lookup and the update, so one count
        # observes both (trainer.py:384-387)
        metrics["sparse_dropped"] = dropped
        return state._replace(step=state.step + 1), metrics

    def check_dropped(self, metrics: Mapping) -> None:
        """With ``route_strict``, raise when ``metrics["sparse_dropped"]``
        (a step's, or a stack of steps') counts a dropped id
        (``trainer.py:188-205``).  Reading it waits for the card: call it
        where the host reads the metrics anyway (the log cadence)."""
        if not self.cfg.route_strict:
            return
        dropped = metrics.get("sparse_dropped")
        if dropped is None:
            return
        d = int(torch.as_tensor(dropped).max())
        if d > 0:
            raise RuntimeError(
                f"routed exchange dropped {d} ids to double overflow "
                "(route_strict=True); raise route_cap_factor/"
                "route_ov_cap or switch sparse_route_mode='allgather'")

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
            _, emb, _, can_emb, _ = self._lookup(state, ids)
            return self._forward(state.params, dense, emb, can_emb, domain)

    def train_many(self, state: TrainState, batches: Iterable[Batch]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Several steps on host batches; metrics stacked over the steps."""
        seq = []
        for batch in batches:
            state, metrics = self.train_step(state, *self.put(batch))
            seq.append(metrics)
        return state, _stack(seq)

    # -- packed wire path ---------------------------------------------------
    @property
    def wire(self) -> WireFormat:
        """The wire bound to this trainer's feature layout; a process's
        batch is one shard.  On more than one process hot8 ids fall back
        to packed ones with JAX's warning (``trainer.py:482-489``): JAX
        bakes one table into each process's decode.  The port's windows
        carry their own tables, but per-process tables are left out, as
        JAX has none."""
        if self._wire is None:
            id_mode = self.cfg.wire_id_mode
            if id_mode == "hot8" and self.mesh is not None \
                    and self.mesh.size > 1:
                warnings.warn("wire_id_mode='hot8' is single-process "
                              "only; falling back to 'packed'")
                id_mode = "packed"
            self._wire = WireFormat(self.fc.num_sparse,
                                    self.fc.rows_per_field,
                                    dense_mode=self.cfg.wire_dense_mode,
                                    id_mode=id_mode)
        return self._wire

    def _pack(self, batches: List[Batch], raw_groups: bool):
        """A window's host PackedBatch: the C++ pack for the card (the
        same bytes, with the interpreter lock released), numpy's for the
        CPU."""
        if self.device.type == "cuda":
            return self.wire.pack_window_native(batches,
                                                raw_groups=raw_groups)
        return self.wire.pack_window(batches, raw_groups=raw_groups)

    def put_packed_window(self, batches: Iterable[Batch],
                          raw_groups: bool = False) -> PackedBatch:
        """Pack a window of host batches and move it to the device; on the
        card the copy runs on a side stream from pinned memory and this
        returns when it has landed.  ``raw_groups`` ships group ids
        unremapped (pre-mapped corpus slots, the device-GAUC eval).

        On a mesh the window is this process's slice
        (``put_packed_window_local``, :517-567): the in-batch group remap
        is offset by ``rank * local_batch`` so that no two processes'
        groups share an id, which needs a global batch of at most 65,536
        (the uint16 group field; raw corpus slots are global already and
        take no offset).  JAX's check that the mesh is a multiple of the
        process count has no counterpart: a process has one device."""
        batches = list(batches)
        packed = self._pack(batches, raw_groups)
        if self.mesh is None or raw_groups:
            return self._place(packed)
        rank, size = self.mesh.rank, self.mesh.size
        local_b = int(np.asarray(batches[0].labels).shape[-1])
        if local_b * size > 0x10000:
            raise ValueError(
                "uint16 group wire needs global batch <= 65536 for the "
                f"in-batch group remap; got {local_b * size}")
        if size > 1:
            off = np.uint32(rank * local_b)
            packed = packed._replace(
                group_ids=(packed.group_ids.astype(np.uint32)
                           + off).astype(np.uint16))
        return self._place(packed)

    def put_packed_window_local(self, batches: Iterable[Batch],
                                raw_groups: bool = False) -> PackedBatch:
        """JAX's name (:517-567) for :meth:`put_packed_window`, kept to
        mirror its API."""
        return self.put_packed_window(batches, raw_groups)

    def put_packed_auto(self, batches: Iterable[Batch],
                        raw_groups: bool = False) -> PackedBatch:
        """JAX's name (:569-575) for :meth:`put_packed_window`, kept to
        mirror its API."""
        return self.put_packed_window(batches, raw_groups)

    def _place(self, packed) -> PackedBatch:
        """A host PackedBatch on the device (module docstring)."""
        dev = self.device
        if dev.type != "cuda":
            return PackedBatch(*[t.to(dev) for t in to_tensors(packed)])
        packed = to_tensors(packed)
        with torch.cuda.device(dev):
            # staged by numpy's copy: torch's (pin_memory) wakes its
            # OpenMP team, whose spinning threads take the cores the loop
            # thread dispatches from
            pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in packed]
            for p, t in zip(pinned, packed):
                np.copyto(p.numpy(), t.numpy())
            with torch.cuda.stream(self._side):
                out = [t.to(dev, non_blocking=True) for t in pinned]
                landed = torch.cuda.Event()
                landed.record(self._side)
            # made on the side stream, read on the compute stream: the
            # allocator must not hand the memory back to the side stream
            # before the compute stream's reads are done
            for t in out:
                t.record_stream(self._compute)
            landed.synchronize()
        return PackedBatch(*out)

    def _steps_of(self, packed: PackedBatch):
        """Each step's decoded slice of a device window, in order: the
        window is decoded at once (one set of launches, not one a step),
        a hot8 window with the table it carries."""
        decoded = self.wire.decode(packed)
        for s in range(packed.dense.shape[0]):
            yield tuple(x[s] for x in decoded)

    def train_many_packed(self, state: TrainState, packed: PackedBatch
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Run a device-resident packed window's steps in order; metrics
        stacked over the steps."""
        seq = []
        for step in self._steps_of(packed):
            state, metrics = self.train_step(state, *step)
            seq.append(metrics)
        return state, _stack(seq)

    def train_pipelined(self, state: TrainState,
                        host_batches: Iterable[Batch], window: int = 5
                        ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Windowed training with window k + 1 packed and moved on a worker
        thread while window k runs; returns the final state and the last
        window's stacked metrics."""
        metrics = None
        with WindowPrefetcher(host_batches, self.put_packed_window, window,
                              parse_ahead=False) as wins:
            for dev_win, _ in wins:
                state, metrics = self.train_many_packed(state, dev_win)
        return state, metrics

    # -- loops --------------------------------------------------------------
    def fit(self, state: TrainState, batches: Iterable[Batch],
            log_every: int = 0,
            log_fn: Optional[Callable[[int, Dict], None]] = None
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Run the stream of host batches; return the final state and the
        last logged (or final) metrics as floats."""
        last, metrics = {}, {}
        for i, batch in enumerate(batches):
            state, metrics = self.train_step(state, *self.put(batch))
            if log_every and (i + 1) % log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                self.check_dropped(last)
                if log_fn:
                    log_fn(i + 1, last)
        if not last:
            last = {k: float(v) for k, v in metrics.items()}
            self.check_dropped(last)
        return state, last

    def evaluate(self, state: TrainState,
                 batches: Iterable[Batch]) -> Dict[str, float]:
        """Exact AUC / corpus GAUC over an eval stream, accumulated on the
        host; a multi-task model adds ``cvr_auc`` / ``cvr_gauc``.  On a
        mesh each process scores its slice and every process accumulates
        the global batch."""
        acc = StreamingGAUC()
        cvr_acc = StreamingGAUC() if self.cfg.num_tasks > 1 else None
        for batch in batches:
            dense, ids, _, _, _, domain = self.put(batch)
            logits = self.eval_step(state, dense, ids, domain)
            groups, labels, cvr = (batch.group_ids, batch.labels,
                                   batch.cvr_labels)
            if self.mesh is not None:
                groups, labels, cvr, logits = self._gather_eval(
                    groups, labels, cvr, logits)
            logits = logits.cpu().numpy()
            if logits.ndim == 2:                           # multi-task
                if cvr_acc is not None:
                    cvr_acc.update(groups, cvr, logits[1])
                logits = logits[0]
            acc.update(groups, labels, logits)
        result = acc.result()
        if cvr_acc is not None:
            cvr_res = cvr_acc.result()
            result["cvr_auc"] = cvr_res["auc"]
            result["cvr_gauc"] = cvr_res["gauc"]
        return result

    def _gather_eval(self, groups: np.ndarray, labels: np.ndarray,
                     cvr: np.ndarray, logits: torch.Tensor):
        """Every process's (group, label, cvr) columns and (b,) or (T, b)
        logits, in rank order, in one ``all_gather`` of float64 columns
        (exact for int32 groups and f32 values; ``trainer.py:657-664``)."""
        f64 = torch.float64
        cols = [torch.as_tensor(np.asarray(c), device=self.device).to(f64)
                for c in (groups, labels, cvr)]
        cols += list(logits.to(f64).reshape(-1, logits.shape[-1]))
        every = self.mesh.all_gather(torch.stack(cols, 1)).cpu().numpy()
        logits_all = every[:, _EVAL_COLUMNS:].T.astype(np.float32)
        return (every[:, 0].astype(np.asarray(groups).dtype),
                every[:, 1].astype(np.float32), every[:, 2].astype(np.float32),
                torch.from_numpy(logits_all.reshape(
                    logits.shape[:-1] + (-1,))))

    def evaluate_device(self, state: TrainState, batches: Iterable[Batch],
                        window: int = 8, num_buckets: int = 4096,
                        gauc: str = "corpus", num_group_slots: int = 8192,
                        group_buckets: int = 512) -> Dict[str, float]:
        """Device-resident eval over the packed wire: bucketed AUC
        histograms and, with ``gauc='corpus'``, per-group score histograms
        indexed by host-assigned corpus slots (exact grouping while the
        eval set has fewer than 7/8 of ``num_group_slots`` groups), or
        with ``gauc='inbatch'`` the pair-weighted in-batch GAUC sums.
        Window k + 1 is packed and moved on a worker thread while window k
        runs; the host fetches 2 K floats (and the (3, G) group stats).

        Returns {'auc', 'gauc_mode', 'num_pos', 'num_neg', 'gauc'
        [, 'gauc_groups'][, 'gauc_overflow'][, 'cvr_auc', 'cvr_gauc']}.
        """
        if gauc not in ("corpus", "inbatch"):
            raise ValueError(f"unknown gauc mode {gauc!r}")
        if num_group_slots > 0x10000:
            raise ValueError(
                "corpus group slots travel the uint16 group wire: "
                f"num_group_slots must be <= 65536, got {num_group_slots}")
        corpus = gauc == "corpus"
        multi = self.cfg.num_tasks > 1
        batches = list(batches)
        if not batches:
            raise ValueError("evaluate_device needs at least one batch")
        indexer = None
        many = self.mesh is not None and self.mesh.size > 1
        if corpus:
            # every process maps a group to one slot: by hash on many
            indexer = CorpusGroupIndexer(num_group_slots, use_hash=many)
            batches = [b._replace(group_ids=indexer.assign(b.group_ids))
                       for b in batches]
        dev = self.device
        hist = torch.zeros((2, num_buckets), device=dev)
        cvr_hist = torch.zeros((2, num_buckets), device=dev)
        if corpus:
            ghist = DeviceGroupedAUC.init(num_group_slots, group_buckets, dev)
            cvr_ghist = (DeviceGroupedAUC.init(num_group_slots,
                                               group_buckets, dev)
                         if multi else None)
        else:
            win = torch.zeros((), device=dev)
            total = torch.zeros((), device=dev)
        put = functools.partial(self.put_packed_window, raw_groups=corpus)
        with WindowPrefetcher(batches, put, window,
                              parse_ahead=False) as wins:
            for packed, _ in wins:
                for dense, ids, labels, groups, cvr, domain in \
                        self._steps_of(packed):
                    logits = self.eval_step(state, dense, ids, domain)
                    main = logits[0] if multi else logits
                    DeviceStreamingAUC.accumulate(hist, labels, main)
                    if corpus:
                        DeviceGroupedAUC.accumulate(ghist, groups, labels,
                                                    main, group_buckets)
                    else:
                        w, t = batch_gauc_stats(labels, main, groups)
                        win += w
                        total += t
                    if multi:
                        DeviceStreamingAUC.accumulate(cvr_hist, cvr,
                                                      logits[1])
                        if corpus:
                            DeviceGroupedAUC.accumulate(
                                cvr_ghist, groups, cvr, logits[1],
                                group_buckets)
        overflowed = indexer.overflowed if corpus else 0
        if self.mesh is not None:
            # the histograms and sums over every process's rows
            sums = [hist, cvr_hist]
            if corpus:
                sums += [ghist, cvr_ghist] if multi else [ghist]
            else:
                sums += [win, total]
            self._flat_collective(sums, self.mesh.all_reduce)
        if many and corpus:
            # hash collisions among every process's groups
            merged = CorpusGroupIndexer(num_group_slots, use_hash=True)
            merged.assign(np.concatenate(
                self.mesh.all_gather_object(indexer.seen())))
            overflowed = merged.overflowed
        h = hist.cpu().numpy()
        result = {"auc": DeviceStreamingAUC.auc_from_hist(h),
                  "gauc_mode": gauc,
                  "num_pos": float(h[0].sum()),
                  "num_neg": float(h[1].sum())}
        if corpus:
            # (2 G, K) -> (3, G) on the device: the host fetch is O(G)
            gr = DeviceGroupedAUC.gauc_from_stats(
                DeviceGroupedAUC.finish(ghist).cpu().numpy())
            result["gauc"] = gr["gauc"]
            result["gauc_groups"] = gr["num_groups"]
            if overflowed:
                result["gauc_overflow"] = float(overflowed)
        else:
            result["gauc"] = (float(win / total) if float(total) > 0
                              else 0.5)
        if multi:
            result["cvr_auc"] = DeviceStreamingAUC.auc_from_hist(
                cvr_hist.cpu().numpy())
            if corpus:
                result["cvr_gauc"] = DeviceGroupedAUC.gauc_from_stats(
                    DeviceGroupedAUC.finish(cvr_ghist).cpu().numpy())["gauc"]
        return result


def _stack(seq: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-step metric dicts -> one dict of (steps,) tensors."""
    if not seq:
        return {}
    return {k: torch.stack([m[k] for m in seq]) for k in seq[0]}
