"""DLRM-DCNv2 (MLPerf Training's Criteo 1TB multi-hot model; DLRM,
arXiv:1906.00091; DCN-V2, arXiv:2008.13535) in plain PyTorch, float32,
at the widths of ``configs/dlrm-dcnv2-criteo1tb.json``; imports nothing
of the program.

The lookup: field f's ids are columns [s_f, s_f + h_f) of a request, h_f
its multi-hot size; each id is offset by the rows of the fields before
f, its row indexed and the field's rows summed.  Then: the dense arch,
ReLU after every layer; x0 = [dense_out, pooled] flattened (dense
first); 3 low-rank cross layers x_{l+1} = x0 * (W_l (V_l x_l) + b_l) +
x_l; the over arch, ReLU after all but its last (one-logit) layer.
Weights in (in, out) layout for the cross (``x @ V``), PyTorch's (out,
in) for the MLPs (``x @ W.t()``).  Rows in blocks, so that the gathered
(M, 214, 128) rows stay a few hundred MB.
"""
from __future__ import annotations

import numpy as np
import torch

from plain import glorot

BLOCK = 1024


def _mlp_specs(prefix: str, widths):
    specs = []
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        specs += [(f"{prefix}.dense_{i}.weight", (b, a), glorot(a, b)),
                  (f"{prefix}.dense_{i}.bias", (b,), 0.0)]
    return specs


def param_specs(cfg: dict):
    """[(name, shape, limit)] of the model's weights."""
    d = cfg["embedding_dim"]
    x0 = (cfg["num_sparse_features"] + 1) * d
    layers, r = cfg["dcn_num_layers"], cfg["dcn_low_rank_dim"]
    over = [x0] + list(cfg["over_arch_layer_sizes"])
    return (_mlp_specs("dense_arch", [cfg["num_dense_features"]]
                       + list(cfg["dense_arch_layer_sizes"]))
            + [("cross.v_kernels", (layers, x0, r), glorot(x0, r)),
               ("cross.w_kernels", (layers, r, x0), glorot(r, x0)),
               ("cross.biases", (layers, x0), 0.0)]
            + _mlp_specs("over_arch", over[:-1])
            + [("head.weight", (1, over[-2]), glorot(over[-2], 1)),
               ("head.bias", (1,), 0.0)])


def global_rows(ids: np.ndarray, cfg: dict, device) -> torch.Tensor:
    """(B, sum(hotness)) raw ids -> int64 rows of the held table: each
    column's id modulo its field's rows, plus the rows of the fields
    before it."""
    rows = np.asarray(cfg["num_embeddings_per_feature"], np.int64)
    hot = np.asarray(cfg["multi_hot_sizes"])
    col_rows = np.repeat(rows, hot)
    col_offs = np.repeat(np.cumsum(rows) - rows, hot)
    raw = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
    return (raw % torch.from_numpy(col_rows).to(device)
            + torch.from_numpy(col_offs).to(device))


def pooled(table: torch.Tensor, rows: torch.Tensor, cfg: dict
           ) -> torch.Tensor:
    """(M, sum(hotness)) global rows -> (M, F, D): each field's rows
    indexed and summed."""
    out, at = [], 0
    for h in cfg["multi_hot_sizes"]:
        out.append(table[rows[:, at:at + h]].sum(1))
        at += h
    return torch.stack(out, dim=1)


def _mlp(p, prefix: str, x: torch.Tensor, n: int, last_relu: bool):
    for i in range(n):
        x = x @ p[f"{prefix}.dense_{i}.weight"].t() + p[f"{prefix}.dense_{i}.bias"]
        if last_relu or i < n - 1:
            x = torch.relu(x)
    return x


def _block(p, dense, emb, cfg: dict) -> torch.Tensor:
    b = dense.shape[0]
    x = _mlp(p, "dense_arch", dense, len(cfg["dense_arch_layer_sizes"]),
             True)
    x0 = torch.cat([x[:, None, :], emb], dim=1).reshape(b, -1)
    x = x0
    for i in range(cfg["dcn_num_layers"]):
        xw = (x @ p["cross.v_kernels"][i]) @ p["cross.w_kernels"][i]
        x = x0 * (xw + p["cross.biases"][i]) + x
    x = _mlp(p, "over_arch", x, len(cfg["over_arch_layer_sizes"]) - 1, True)
    return (x @ p["head.weight"].t() + p["head.bias"]).squeeze(-1)


def forward(p, dense: torch.Tensor, rows: torch.Tensor,
            table: torch.Tensor, cfg: dict) -> torch.Tensor:
    """dense (B, 13), rows (B, sum(hotness)) global rows of ``table`` ->
    (B,) logits."""
    return torch.cat([
        _block(p, dense[lo:lo + BLOCK],
               pooled(table, rows[lo:lo + BLOCK], cfg), cfg)
        for lo in range(0, rows.shape[0], BLOCK)])
