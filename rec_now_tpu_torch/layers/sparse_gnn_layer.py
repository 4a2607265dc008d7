"""Sparse field-graph convolution layer.

Counterpart of ``rec_now_tpu/layers/sparse_gnn_layer.py``: a hand-given
directed graph over the fields; each GNN layer learns one weight per edge
(``weights_{i}`` (E,), 0.1 at init; one set shared by every layer, or one
per layer), places them in a dense (F, F) matrix and computes
``out = act(out + out @ W)`` on the (B, D, F) layout.  The matrix is built
by a non-accumulating ``index_put`` at the edges' sorted
``[neighbor, node]`` indices, so each edge weight gets its gradient; F is
small (tens), so the product runs dense.

Symbols: B batch, D dim, F fields, E edges.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from rec_now_tpu_torch.core.config import (constant_initializer,
                                           get_activation, resolve_device)

DEFAULT_NEIGHBOR_INITIAL_WEIGHT = 0.1


def list_of_edge_to_neighbors(list_of_edge, directed: bool = True) -> Dict:
    """Edges (node_to, node_from) -> {node_to: {node_from, ...}}: node_to
    aggregates node_from; an undirected edge adds both ways."""
    field2neighbors: Dict[Any, set] = {}
    for pair in list_of_edge:
        node_to, node_from = pair[0], pair[1]
        field2neighbors.setdefault(node_to, set()).add(node_from)
        if not directed:
            field2neighbors.setdefault(node_from, set()).add(node_to)
    return field2neighbors


class SparseGNNLayer(nn.Module):
    """Graph convolution over a fixed field graph with learned edges."""

    list_of_edge_to_neighbors = staticmethod(list_of_edge_to_neighbors)

    def __init__(self, fields: Sequence[Any], field2neighbors,
                 initial_weight: float = DEFAULT_NEIGHBOR_INITIAL_WEIGHT,
                 num_layers: int = 1,
                 share_weights_between_layers: bool = True,
                 activation: Optional[str] = "tanh",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.fields = list(fields)
        self.num_layers = num_layers
        self.activation = get_activation(activation)
        f2n = self._neighbors_dict(field2neighbors)
        self._validate(f2n)
        indices = self._edge_indices(f2n)
        self.register_buffer("edge_index",
                             torch.from_numpy(indices).to(device),
                             persistent=False)
        self.num_weight_sets = (1 if share_weights_between_layers
                                else num_layers)
        init = constant_initializer(initial_weight)
        for i in range(self.num_weight_sets):
            setattr(self, f"weights_{i}",
                    nn.Parameter(init((len(indices),)).to(device)))

    @staticmethod
    def _neighbors_dict(f2n) -> Dict:
        if isinstance(f2n, (list, set, tuple)):
            return list_of_edge_to_neighbors(f2n)
        if not isinstance(f2n, Mapping):
            raise TypeError(
                "field2neighbors must be one of `list of pairs`, `set of "
                f"pairs`, `dict of neighbors`, but get {type(f2n)}")
        return dict(f2n)

    def _validate(self, f2n: Dict) -> None:
        set_fields = set(self.fields)
        if len(set_fields) != len(self.fields):
            raise ValueError(
                f"{len(self.fields) - len(set_fields)} duplicated fields in "
                "fields.")
        for field, neighbors in f2n.items():
            if field not in set_fields:
                raise ValueError(
                    f"field `{field}` in field2neighbors but not in fields.")
            for n in neighbors:
                if n not in set_fields:
                    raise ValueError(
                        f"field `{n}` in field2neighbors but not in fields.")

    def _edge_indices(self, f2n: Dict) -> np.ndarray:
        """(E, 2) [neighbor_idx, node_idx], sorted as the reference
        (``sparse_gnn_layer.py:89-98``)."""
        field2idx = {f: i for i, f in enumerate(self.fields)}
        indices = sorted([field2idx[neighbor], idx]
                         for idx, field in enumerate(self.fields)
                         for neighbor in f2n.get(field, []))
        return np.asarray(indices, dtype=np.int64).reshape(-1, 2)

    def forward(self, inputs: Union[torch.Tensor, List[torch.Tensor]],
                return_all_layers: bool = False,
                transpose_outputs: bool = True,
                flattern_outputs: bool = True):
        """Run the stacked graph convolutions.

        Args:
            inputs: (B, F, D), (B, D, F), (B, F * D) or a list of F (B, D)
                embeddings.  A 3-D input whose middle axis equals F is
                taken as (B, F, D), also when D == F.
            return_all_layers: return every layer's output.
            transpose_outputs: return the (B, F, D) layout, not (B, D, F).
            flattern_outputs: flatten the last two axes.

        Returns:
            (B, F * D) by default; a list with ``return_all_layers``.
        """
        num_nodes = len(self.fields)
        if isinstance(inputs, (list, tuple)):
            inputs = torch.cat(list(inputs), dim=-1)         # (B, F*D)
        if inputs.dim() == 2:
            all_dim = inputs.shape[-1]
            if all_dim % num_nodes != 0:
                raise ValueError(
                    f"can not determine embedding_dim! {all_dim} can not "
                    f"be divided by {num_nodes}.")
            inputs = inputs.reshape(-1, num_nodes, all_dim // num_nodes)
        if inputs.shape[1] == num_nodes:
            inputs = inputs.transpose(1, 2)                  # (B, D, F)
        rows, cols = self.edge_index[:, 0], self.edge_index[:, 1]
        outputs = inputs
        all_outputs = []
        for i in range(self.num_layers):
            w = getattr(self, f"weights_{i % self.num_weight_sets}")
            dense_w = w.new_zeros((num_nodes, num_nodes)).index_put(
                (rows, cols), w)                             # (F, F)
            outputs = self.activation(outputs + outputs @ dense_w)
            all_outputs.append(outputs)

        def finish(x):
            if transpose_outputs:
                x = x.transpose(1, 2)                        # (B, F, D)
            if flattern_outputs:
                x = x.reshape(x.shape[0], x.shape[1] * x.shape[2])
            return x

        if return_all_layers:
            return [finish(x) for x in all_outputs]
        return finish(outputs)
