"""Serving / inference path.

Counterpart of ``rec_now_tpu/serving.py`` for single-table models (the
CAN second table is not ported).  A serving state is the model's
parameters plus the (V, D) embedding table; the scorer does the
embedding lookup and the model forward under ``torch.inference_mode``.

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

Any ported model serves this way: ``XDeepFMModel`` (config 3) and
``DCNv2Model`` (config 2) score (B,).  A multi-task model
(``MultiTaskModel``) scores (T, B): one row of logits
per task, served from domain 0 as in the JAX scorer, which passes no
domain.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch
from torch.func import functional_call

from rec_now_tpu_torch.core.config import resolve_device
from rec_now_tpu_torch.training.wire import WireFormat, unpack_ids

_FILE = "serving.pt"


class ServingState(NamedTuple):
    """What scoring reads: model parameters by name, and the table."""
    params: Dict[str, torch.Tensor]
    table: torch.Tensor                 # (V, D) float32


def _forward(model, fc, table, state: ServingState, dense: torch.Tensor,
             sparse_ids: torch.Tensor) -> torch.Tensor:
    emb = table.lookup(state.table, fc.global_ids(sparse_ids))
    return functional_call(model, state.params, (dense, emb))


def build_scorer(model, feature_config, table,
                 device: Union[str, torch.device] = "cuda") -> Callable:
    """Scoring function for a model, its feature layout and its table.

    Returns ``scorer(state, dense, sparse_ids) -> logits`` on ``device``,
    (B,) for a single-task model and (T, B) for a multi-task one; dense
    (B, num_dense) and sparse_ids (B, F) may be numpy arrays or tensors.
    """
    dev = resolve_device(device)

    def scorer(state: ServingState, dense, sparse_ids) -> torch.Tensor:
        with torch.inference_mode():
            dense = torch.as_tensor(dense, dtype=torch.float32, device=dev)
            ids = torch.as_tensor(sparse_ids, device=dev)
            return _forward(model, feature_config, table, state, dense, ids)

    return scorer


class WireScorer:
    """Score through the compressed request wire.

    Packs (dense, sparse_ids) on the host (bit-packed ids; f16 or
    per-request-affine u8 dense), moves the packed arrays to the device
    and decodes them there.

    Call: ``scorer(state, dense, sparse_ids) -> logits``, (B,) or
    (T, B) as :func:`build_scorer`'s; ``pack`` and ``score_packed``
    expose the two halves.
    """

    def __init__(self, model, feature_config, table,
                 dense_mode: str = "f16",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.wire = WireFormat(feature_config.num_sparse,
                               feature_config.rows_per_field,
                               dense_mode=dense_mode)
        self.model, self.fc, self.table = model, feature_config, table

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
            return _forward(self.model, self.fc, self.table, state, dense,
                            ids)

    def __call__(self, state: ServingState, dense,
                 sparse_ids) -> torch.Tensor:
        return self.score_packed(state, *self.pack(dense, sparse_ids))


def export_serving(directory: str, state: ServingState) -> None:
    """Save the inference-only state (params and table) with torch.save."""
    os.makedirs(directory, exist_ok=True)
    torch.save({"params": dict(state.params), "table": state.table},
               os.path.join(directory, _FILE))


def load_serving(directory: str,
                 device: Union[str, torch.device] = "cuda") -> ServingState:
    """Restore an :func:`export_serving` state onto ``device``."""
    payload = torch.load(os.path.join(directory, _FILE),
                         map_location=resolve_device(device),
                         weights_only=True)
    return ServingState(params=payload["params"], table=payload["table"])
