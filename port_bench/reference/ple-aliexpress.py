"""PLE (Progressive Layered Extraction; Tang, Liu, Zhao and Gong, RecSys
2020) as MTReclib's ``PLEModel`` computes it, in plain PyTorch, float32,
at the widths of ``configs/ple-aliexpress.json``; imports nothing of the
program.

The lookup: each of the 16 one-hot ids is offset by the rows of the
fields before its field and its row indexed.  The 63 dense floats pass
through one Linear to the embedding width, a 17th field after the 16;
the flat (B, 17 * 128) is every module's input at level 1.  At level j,
one expert at a time: each of task k's experts and each shared expert is
ReLU(x W + b) of its module's input; task k's output is its gate's
softmax(x W_g + b_g) over [task k's experts; the shared experts], read
from task k's own input, each expert's output scaled by its weight and
added; the shared module's output, at every level but the last, its
gate over [the shared experts; each task's experts], read from the
shared input.  Each module's output is its input at level j + 1.  Task
k's tower: Linear -> ReLU per width, then one Linear to its logit.

Departures from MTReclib's model, each as the served program has it:

* BatchNorm1d in eval mode, an affine per unit, folded into the Linear
  before it: the weights drawn from the seed are the folded ones;
* dropout off (eval);
* logits before the sigmoid, (T, B), task 0 (CTR) first;
* the shared gate's outputs weight the shared experts first, then each
  task's experts in task order (MTReclib concatenates the tasks' experts
  first), a permutation of the gate's rows that the program's parameters
  store in this order.

The parameters carry the program's names and layout so that both sides
load one set: a bank's ``kernel`` (N, in, out) holds expert e's weight
as ``kernel[e]`` and its ``bias`` (N, 1, out) the bias as ``bias[e, 0]``;
the other Linears PyTorch's (out, in) weight and (out,) bias.
"""
from __future__ import annotations

import numpy as np
import torch

from plain import glorot


def _linear(name: str, a: int, b: int, bias: float):
    return [(f"{name}.weight", (b, a), glorot(a, b)),
            (f"{name}.bias", (b,), bias)]


def _modules(cfg: dict):
    """The shared module, then each task: (program name, experts)."""
    return ([("shared_0", cfg["shared_expert_num"])]
            + [(f"special_{k}", cfg["specific_expert_num"])
               for k in range(cfg["task_num"])])


def param_specs(cfg: dict):
    """[(name, shape, limit)] of the model's weights."""
    bias = cfg["bias_init_scale"]
    d = cfg["embedding_dim"]
    width = (cfg["num_sparse_features"] + 1) * d
    levels = cfg["bottom_mlp_dims"]
    mods = _modules(cfg)
    n_all = sum(n for _, n in mods)
    specs = _linear("dense_proj", cfg["num_dense_features"], d, bias)
    for j, dim in enumerate(levels):
        for name, n in mods:
            bank = f"ple.ple_layer_{j}.task_{name}.MultiDenseLayer_0"
            specs += [(f"{bank}.kernel", (n, width, dim), glorot(width, dim)),
                      (f"{bank}.bias", (n, 1, dim), bias)]
        for name, n in mods:
            if name.startswith("shared"):
                if j == len(levels) - 1:
                    continue
                outs = n_all
            else:
                outs = n + cfg["shared_expert_num"]
            specs += _linear(f"ple.ple_gate_{j}.task_{name}.dense", width,
                             outs, bias)
        width = dim
    towers = [levels[-1]] + list(cfg["tower_mlp_dims"])
    for k in range(cfg["task_num"]):
        for i, (a, b) in enumerate(zip(towers, towers[1:])):
            specs += _linear(f"tower_{k}.dense_{i}", a, b, bias)
        specs += _linear(f"head_{k}", towers[-1], 1, bias)
    return specs


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


def _dense(p, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def _experts(p, bank: str, x: torch.Tensor, n: int):
    k, b = p[f"{bank}.kernel"], p[f"{bank}.bias"]
    return [torch.relu(x @ k[e] + b[e, 0]) for e in range(n)]


def _combine(p, gate: str, x: torch.Tensor, experts) -> torch.Tensor:
    w = torch.softmax(_dense(p, gate, x), dim=1)            # (B, len)
    out = w[:, :1] * experts[0]
    for e in range(1, len(experts)):
        out = out + w[:, e:e + 1] * experts[e]
    return out


def forward(p, dense: torch.Tensor, rows: torch.Tensor,
            table: torch.Tensor, cfg: dict) -> torch.Tensor:
    """dense (B, 63), rows (B, 16) global rows of ``table`` -> (T, B)
    logits."""
    b = rows.shape[0]
    x = torch.cat([table[rows], _dense(p, "dense_proj", dense)[:, None]],
                  dim=1).reshape(b, -1)
    tasks = cfg["task_num"]
    levels = len(cfg["bottom_mlp_dims"])
    mods = _modules(cfg)
    inputs = {name: x for name, _ in mods}
    for j in range(levels):
        out = {name: _experts(p, f"ple.ple_layer_{j}.task_{name}"
                                 ".MultiDenseLayer_0", inputs[name], n)
               for name, n in mods}
        gated = {}
        for k in range(tasks):
            name = f"special_{k}"
            gated[name] = _combine(p, f"ple.ple_gate_{j}.task_{name}.dense",
                                   inputs[name], out[name] + out["shared_0"])
        if j < levels - 1:
            gated["shared_0"] = _combine(
                p, f"ple.ple_gate_{j}.task_shared_0.dense",
                inputs["shared_0"],
                [e for name, _ in mods for e in out[name]])
        inputs = gated
    logits = []
    for k in range(tasks):
        h = inputs[f"special_{k}"]
        for i in range(len(cfg["tower_mlp_dims"])):
            h = torch.relu(_dense(p, f"tower_{k}.dense_{i}", h))
        logits.append(_dense(p, f"head_{k}", h).squeeze(-1))
    return torch.stack(logits)
