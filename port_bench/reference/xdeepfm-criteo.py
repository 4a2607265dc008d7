"""xDeepFM (Lian et al., KDD 2018) in plain PyTorch, float32, at the
widths of ``configs/xdeepfm-criteo.json``; imports nothing of the
program.

The output unit: logit = w_linear . a + w_dnn . x_dnn + w_cin . p+ + b.  A
row of the table holds a feature's embedding (its first ``embedding_dim``
columns) and its linear weight (the last), so w_linear . a over the
one-hot features is the sum of the looked-up linear weights.  CIN layer
k: X^k[h, :] = sum_{i, j} W^k[h, i, j] (X^{k-1}[i, :] o
X^0[j, :]), with X^0 the (F, D) embeddings; p^k[h] = sum over D of
X^k[h, :] and p+ = [p^1, ..., p^T].  The DNN: ReLU after
each layer over the flattened embeddings.  Rows in blocks, so that the
(M, K, F) products stay a few hundred MB.
"""
from __future__ import annotations

import torch

from plain import glorot

BLOCK = 1024


def param_specs(cfg: dict):
    """[(name, shape, limit)] of the model's weights; W^k is held (H_k,
    F, H_{k-1}) with the glorot limit of its (F * H_{k-1}, H_k) view."""
    f, d = cfg["num_fields"], cfg["embedding_dim"]
    specs, h = [], f
    for i in range(1, cfg["cin_layers"] + 1):
        k = cfg["cin_layer_size"]
        specs.append((f"cin.weight_of_layer{i}", (k, f, h), glorot(f * h, k)))
        h = k
    prev = f * d
    for i in range(cfg["dnn_layers"]):
        dim = cfg["dnn_layer_size"]
        specs += [(f"deep.dense_{i}.weight", (dim, prev), glorot(prev, dim)),
                  (f"deep.dense_{i}.bias", (dim,), 0.0)]
        prev = dim
    head_in = cfg["cin_layers"] * cfg["cin_layer_size"] + prev
    specs += [("head.weight", (1, head_in), glorot(head_in, 1)),
              ("head.bias", (1,), 0.0)]
    return specs


def _block(p, rows: torch.Tensor, cfg: dict) -> torch.Tensor:
    b, f, _ = rows.shape
    d = cfg["embedding_dim"]
    e = rows[..., :d]
    linear = rows[..., d].sum(-1)
    x0 = e.transpose(1, 2).reshape(b * d, f)                 # (M, F)
    prev, pooled = x0, []
    for i in range(1, cfg["cin_layers"] + 1):
        w = p[f"cin.weight_of_layer{i}"]                     # (K, F, H)
        t = torch.einsum("mh,kfh->mkf", prev, w)
        prev = torch.einsum("mkf,mf->mk", t, x0)             # (M, K)
        pooled.append(prev.reshape(b, d, -1).sum(1))         # (B, K)
    x = e.reshape(b, f * d)
    for i in range(cfg["dnn_layers"]):
        x = torch.relu(x @ p[f"deep.dense_{i}.weight"].t()
                       + p[f"deep.dense_{i}.bias"])
    head = torch.cat(pooled + [x], dim=-1)
    return (head @ p["head.weight"].t() + p["head.bias"]).squeeze(-1) + linear


def forward(p, dense: torch.Tensor, rows: torch.Tensor, cfg: dict
            ) -> torch.Tensor:
    """dense (B, 0), rows (B, F, table_width) looked up -> (B,) logits."""
    return torch.cat([_block(p, rows[lo:lo + BLOCK], cfg)
                      for lo in range(0, rows.shape[0], BLOCK)])
