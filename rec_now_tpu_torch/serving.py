"""Serving / inference path.

Counterpart of ``rec_now_tpu/serving.py``.  A serving state is the
model's parameters plus the (V, D) embedding table and, for config 5
(``CANDCNModel``), the CAN table (``rows_per_field`` rows of the CAN
layer's parameters); the scorer does the lookups and the model forward
under ``torch.inference_mode``.  A scorer built with ``can_table`` and
``can_param_field`` looks the CAN rows up by that field's raw ids modulo
``rows_per_field`` (``serving.py:49-60``, :92-106); a state and a scorer
(or an exported file) that disagree on the second table raise
``CAN-table mismatch`` (``_check_can_match``, :119-137).

Two front ends:

* :func:`build_scorer` -- raw f32 dense and integer ids;
* :class:`WireScorer` -- requests cross the host->device link in the
  compressed wire (bit-packed ids + f16/u8 dense, training/wire.py) and
  are decoded on the device.

Example:
    model = XDeepFMModel(fc)                       # on "cuda"
    table = EmbeddingTable(fc.total_rows, fc.embedding_dim)
    state = ServingState(dict(model.named_parameters()),
                         table.init(torch.Generator().manual_seed(0)))
    scorer = build_scorer(model, fc, table)
    logits = scorer(state, dense, sparse_ids)      # (B,) on the device

A model trained on P processes (``Trainer(..., mesh=)``) is exported by
every process at once: :func:`export_serving` gathers the rows each holds
into the logical (V, D) table (and CAN table) on rank 0, which writes the
file one process would write, so :func:`load_serving` serves it on one
card.

Any ported model serves this way: ``XDeepFMModel`` (config 3),
``DCNv2Model`` (config 2), ``DLRMDCNv2Model`` (MLPerf's DLRM-DCNv2, on a
per-field multi-hot ``FeatureConfig``, its lookup sum-pooled by
``gather_pool_rows``; the CAN lookup and :class:`WireScorer` refuse that
layout) and ``CANDCNModel`` (config 5, with
``can_table=EmbeddingTable(fc.rows_per_field, can_dim)`` and
``can_param_field=8`` to the scorer) score (B,).  A multi-task model
scores (T, B), one row of logits per task: ``MultiTaskModel`` (config
4), served from domain 0 as in the JAX scorer, which passes no domain,
and ``PLEModel`` (PLE at MTReclib's AliExpress widths, on a per-field
one-hot ``FeatureConfig`` with dense floats, looked up by B11).
"""
from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.core.config import resolve_device
from rec_now_tpu_torch.embedding.sharded import (ShardedEmbeddingTable,
                                                 ShardedTableState)
from rec_now_tpu_torch.parallel.multihost import process_count
from rec_now_tpu_torch.training.wire import WireFormat, unpack_ids

_FILE = "serving.pt"


class ServingState(NamedTuple):
    """What scoring reads: model parameters by name, the table and, for
    a CAN model, the CAN table."""
    params: Dict[str, torch.Tensor]
    table: torch.Tensor                 # (V, D) float32
    can_table: Optional[torch.Tensor] = None   # (rows_per_field, Dc)


def _check_can_match(can_param_field: Optional[int], has_can: bool,
                     where: str) -> None:
    """Raise when a state's (or a file's) CAN table and the scorer's
    ``can_param_field`` disagree: a CAN model's state scored without its
    second lookup, or a lookup into a table the state lacks."""
    scorer_can = can_param_field is not None
    if scorer_can != has_can:
        raise ValueError(
            f"CAN-table mismatch: {where} "
            f"{'has' if has_can else 'lacks'} a co-action table but the "
            f"scorer (can_param_field={can_param_field!r}) "
            f"{'expects' if scorer_can else 'does not expect'} one; "
            "use a scorer whose can_param_field matches the exported model")


def _forward(model, fc, table, can, state: ServingState,
             dense: torch.Tensor, sparse_ids: torch.Tensor) -> torch.Tensor:
    """The lookups and the forward; ``can`` is (CAN table, field) or
    None."""
    _check_can_match(None if can is None else can[1],
                     state.can_table is not None, "the serving state")
    with profiling.span("serve.lookup"):
        if fc.per_field and max(fc.hotness) > 1:
            emb = table.lookup_pooled(state.table, fc.global_ids(sparse_ids),
                                      fc.hotness)
        else:
            emb = table.lookup(state.table, fc.global_ids(sparse_ids))
        inputs = (dense, emb)
        if can is not None:
            can_table, field = can
            inputs += (can_table.lookup(
                state.can_table, sparse_ids[:, field] % fc.rows_per_field),)
    with profiling.span("serve.model"):
        return functional_call(model, state.params, inputs)


def _can_of(can_table, can_param_field: Optional[int]):
    if (can_table is None) != (can_param_field is None):
        raise ValueError("a CAN scorer needs both can_table and "
                         "can_param_field")
    return None if can_table is None else (can_table, can_param_field)


def build_scorer(model, feature_config, table,
                 device: Union[str, torch.device] = "cuda", can_table=None,
                 can_param_field: Optional[int] = None) -> Callable:
    """Scoring function for a model, its feature layout and its table
    (and, for a CAN model, the CAN ``EmbeddingTable`` and the field whose
    ids look it up).

    Returns ``scorer(state, dense, sparse_ids) -> logits`` on ``device``,
    (B,) for a single-task model and (T, B) for a multi-task one; dense
    (B, num_dense) and sparse_ids (B, F) may be numpy arrays or tensors.
    With a per-field layout (``FeatureConfig.hotness``) sparse_ids is (B,
    sum(hotness)), and a multi-hot one is looked up sum-pooled
    (``EmbeddingTable.lookup_pooled``) into the model's (B, F, D).
    The scorer's ``can_param_field`` attribute names its CAN field.
    A call is the span ``serve.request`` (a request id of its own) while
    tracing is on, and the first call is ``serve.first_request`` always
    (``core/profiling.py``).
    """
    dev = resolve_device(device)
    can = _can_of(can_table, can_param_field)
    if can is not None:
        feature_config.refuse_per_field("the CAN lookup")
    first = True

    def score(state: ServingState, dense, sparse_ids) -> torch.Tensor:
        with profiling.span("serve.request", request=True), \
                torch.inference_mode():
            with profiling.span("serve.to_device"):
                dense = torch.as_tensor(dense, dtype=torch.float32,
                                        device=dev)
                ids = torch.as_tensor(sparse_ids, device=dev)
            return _forward(model, feature_config, table, can, state, dense,
                            ids)

    def scorer(state: ServingState, dense, sparse_ids) -> torch.Tensor:
        nonlocal first
        if first:
            first = False
            with profiling.span("serve.first_request", always=True):
                return score(state, dense, sparse_ids)
        return score(state, dense, sparse_ids)

    scorer.can_param_field = can_param_field
    scorer.tables = (table, can_table)
    return scorer


class WireScorer:
    """Score through the compressed request wire.

    Packs (dense, sparse_ids) on the host (bit-packed ids; f16 or
    per-request-affine u8 dense), moves the packed arrays to the device
    and decodes them there.

    Call: ``scorer(state, dense, sparse_ids) -> logits``, (B,) or
    (T, B) as :func:`build_scorer`'s; ``pack`` and ``score_packed``
    expose the two halves.  ``can_table`` and ``can_param_field`` as
    :func:`build_scorer`'s: the ids travel exactly, so the CAN lookup
    reads the rows the raw scorer reads.
    """

    def __init__(self, model, feature_config, table,
                 dense_mode: str = "f16",
                 device: Union[str, torch.device] = "cuda", can_table=None,
                 can_param_field: Optional[int] = None):
        feature_config.refuse_per_field("WireScorer's wire")
        self.device = resolve_device(device)
        self.wire = WireFormat(feature_config.num_sparse,
                               feature_config.rows_per_field,
                               dense_mode=dense_mode)
        self.model, self.fc, self.table = model, feature_config, table
        self.can = _can_of(can_table, can_param_field)
        self.can_param_field = can_param_field
        self.tables = (table, can_table)

    def pack(self, dense: np.ndarray, sparse_ids: np.ndarray):
        """Host-side request packing -> (qdense, scale, id_words)."""
        return self.wire.pack_request(dense, sparse_ids)

    def score_packed(self, state: ServingState, qdense: np.ndarray,
                     dense_scale: np.ndarray,
                     id_words: np.ndarray) -> torch.Tensor:
        dev = self.device
        with torch.inference_mode():
            q = torch.from_numpy(np.ascontiguousarray(qdense)).to(dev)
            scale = torch.from_numpy(dense_scale).to(dev)
            # uint32 words travel as int32 bit patterns (same bytes)
            words = torch.from_numpy(
                np.ascontiguousarray(id_words).view(np.int32)).to(dev)
            dense = self.wire.decode_dense(q, scale)
            ids = unpack_ids(words, self.wire.num_sparse, self.wire.bits)
            return _forward(self.model, self.fc, self.table, self.can, state,
                            dense, ids)

    def __call__(self, state: ServingState, dense,
                 sparse_ids) -> torch.Tensor:
        return self.score_packed(state, *self.pack(dense, sparse_ids))


def _logical(rows: torch.Tensor, size: int, vocab_size: int
             ) -> torch.Tensor:
    """Every process's (L, D) rows of a mod-sharded table (global id g on
    process g % size at row g // size), gathered in one
    ``all_gather_into_tensor`` -> the logical (vocab_size, D) table."""
    rows = rows.contiguous()
    every = rows.new_empty((size * rows.shape[0],) + tuple(rows.shape[1:]))
    dist.all_gather_into_tensor(every, rows)
    return every.reshape((size,) + tuple(rows.shape)).transpose(0, 1) \
        .reshape(every.shape)[:vocab_size]


def export_serving(directory: str, state: ServingState,
                   scorer=None) -> None:
    """Save the inference-only state (params, table and, for a CAN model,
    the CAN table) with torch.save.  With a ``scorer``
    (:func:`build_scorer`'s or a :class:`WireScorer`), a state whose CAN
    table it would not read, or lacks, raises before writing.

    On P > 1 processes every process calls it with its own state, whose
    tables are its rows (``Trainer(..., mesh=)``); the ``scorer`` is then
    required (its tables give the logical row counts), and rank 0 writes
    the logical tables: the file one process writes."""
    if scorer is not None:
        _check_can_match(scorer.can_param_field,
                         state.can_table is not None,
                         "export_serving(state)")
    payload = {"params": dict(state.params), "table": state.table}
    if state.can_table is not None:
        payload["can_table"] = state.can_table
    size = process_count()
    if size > 1:
        if scorer is None:
            raise ValueError(f"export_serving on {size} processes needs the "
                             "scorer: its tables give the rows to gather")
        for key, table in zip(("table", "can_table"), scorer.tables):
            if key in payload:
                payload[key] = _logical(payload[key], size,
                                        table.vocab_size)
        if dist.get_rank() != 0:
            dist.barrier()               # returns once rank 0 has written
            return
    os.makedirs(directory, exist_ok=True)
    torch.save(payload, os.path.join(directory, _FILE))
    if size > 1:
        dist.barrier()


def load_serving(directory: str,
                 device: Union[str, torch.device] = "cuda",
                 scorer=None) -> ServingState:
    """Restore an :func:`export_serving` state onto ``device``; with a
    ``scorer``, a file whose CAN table disagrees with it raises."""
    payload = torch.load(os.path.join(directory, _FILE),
                         map_location=resolve_device(device),
                         weights_only=True)
    if scorer is not None:
        _check_can_match(scorer.can_param_field, "can_table" in payload,
                         "checkpoint payload")
    return ServingState(params=payload["params"], table=payload["table"],
                        can_table=payload.get("can_table"))


def export_table_rows(state, table, ids) -> torch.Tensor:
    """Rows by global id, ids.shape + (D,) on the table's device, e.g. the
    hot embeddings for an ANN retrieval index (``serving.py:207-211``).
    ``state`` is a training or serving state, a table's state or the bare
    table tensor (each ``table`` attribute is followed down to the rows);
    ``table`` the :class:`~rec_now_tpu_torch.embedding.table.
    EmbeddingTable` or ``ShardedEmbeddingTable`` the rows belong to.  On
    a mesh every process calls it with its own rows and as many ids: the
    lookup is collective, and each process gets its own ids' rows.  (JAX's
    takes only a state whose ``table`` is the table's state: on the
    table's state itself it raises.)"""
    rows = state
    while not isinstance(rows, torch.Tensor):
        rows = rows.table
    ids = torch.as_tensor(ids, device=table.device).to(torch.int64)
    if isinstance(table, ShardedEmbeddingTable):
        return table.lookup(ShardedTableState(rows, None), ids)
    return table.lookup(rows, ids)
