"""Progressive Layered Extraction (PLE) layer.

Counterpart of ``rec_now_tpu/layers/ple_layer.py`` (``PLELayer`` and
``_extend_int_list``, :24-161): per extraction layer, each task (the
shared ones first, then the special ones) owns a :class:`MultiDenseLayer`
expert bank (ReLU between its layers, the last linear); a special task reads its own experts plus the shared ones
through a softmax gate, a shared task all experts; the last layer drops
the shared tasks' gates.  Above the first layer a shared task's bank
reads every task's previous output, a special task's its own and the
shared ones, concatenated.

Submodules carry the Flax names with ``/`` as nesting:
``ple_layer_{l}.task_{name}.MultiDenseLayer_{i}`` and
``ple_gate_{l}.task_{name}.dense`` (an ``nn.Linear``, glorot weight and
zero bias as Flax's ``Dense``), task names ``shared_{i}`` then
``special_{i}``.

Symbols: B batch, D in-dim, T tasks, N experts (per task and layer), U
per-layer out-dim.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Union

import torch
from torch import nn

from rec_now_tpu_torch.core.config import make_linear, resolve_device
from rec_now_tpu_torch.layers.multi_dense_layer import MultiDenseLayer


def _extend_int_list(list_or_int: Union[int, Sequence[int]],
                     size_extend: int) -> List[int]:
    """Broadcast-extend an int or list to ``size_extend`` entries by
    repeating the last one."""
    if not isinstance(list_or_int, (int, list, tuple)):
        raise TypeError("`list_or_int` must be of type `int` or `list of "
                        "int`, but got `%s`" % type(list_or_int))
    if isinstance(list_or_int, int):
        list_or_int = [list_or_int]
    if not list_or_int:
        raise ValueError("list can not be empty")
    list_or_int = list(list_or_int)
    while len(list_or_int) < size_extend:
        list_or_int.append(list_or_int[-1])
    return list_or_int


class PLELayer(nn.Module):
    """PLE multi-task extraction network: (B, D) -> T tensors (B, U)."""

    def __init__(self, in_dim: int, num_task: int,
                 list_of_dnn_dims: Sequence[Any],
                 list_of_num_experts_per_task: Any,
                 generator: torch.Generator, num_shared_task: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        if not isinstance(list_of_dnn_dims, (list, tuple)):
            raise TypeError("`list_of_dnn_dims` must be a list or list[list]")
        num_total = num_task + num_shared_task
        num_layer = len(list_of_dnn_dims)
        experts = list_of_num_experts_per_task
        experts = _extend_int_list(
            experts if isinstance(experts, int) else list(experts), num_layer)
        self.experts_per_layer = [_extend_int_list(n, num_total)
                                  for n in experts]
        self.dnn_dims = [_extend_int_list(d, 1) if isinstance(d, int)
                         else list(d) for d in list_of_dnn_dims]
        self.is_shared = [True] * num_shared_task + [False] * num_task
        self.names = ([f"shared_{i}" for i in range(num_shared_task)]
                      + [f"special_{i}" for i in range(num_task)])
        self.num_layer = num_layer

        out_dims = [in_dim] * num_total        # each task's previous output
        for l in range(num_layer):
            is_first, is_last = l == 0, l == num_layer - 1
            n_per_task = self.experts_per_layer[l]
            n_shared = sum(n for sh, n in zip(self.is_shared, n_per_task)
                           if sh)
            banks, gates = nn.ModuleDict(), nn.ModuleDict()
            for t in range(num_total):
                if is_first:
                    d_in = in_dim
                elif self.is_shared[t]:
                    d_in = sum(out_dims)
                else:
                    d_in = out_dims[t] + sum(
                        o for o, sh in zip(out_dims, self.is_shared) if sh)
                bank, d = nn.ModuleDict(), d_in
                for i, dim in enumerate(self.dnn_dims[l]):
                    last_dnn = i == len(self.dnn_dims[l]) - 1
                    bank[f"MultiDenseLayer_{i}"] = MultiDenseLayer(
                        d, dim, n_per_task[t], generator,
                        activation=None if last_dnn else "relu",
                        device=device)
                    d = dim
                banks[f"task_{self.names[t]}"] = bank
                if self.is_shared[t] and is_last:
                    continue
                gate_dim = (sum(n_per_task) if self.is_shared[t]
                            else n_per_task[t] + n_shared)
                gates[f"task_{self.names[t]}"] = nn.ModuleDict(
                    {"dense": make_linear(d_in, gate_dim, device, generator)})
            setattr(self, f"ple_layer_{l}", banks)
            setattr(self, f"ple_gate_{l}", gates)
            out_dims = [self.dnn_dims[l][-1]] * num_total

    def forward(self, inputs: torch.Tensor) -> List[torch.Tensor]:
        """inputs (B, D) -> ``num_task`` task outputs, each (B, U_last)."""
        num_total = len(self.names)
        last_outputs: List[torch.Tensor] = []
        for l in range(self.num_layer):
            is_first, is_last = l == 0, l == self.num_layer - 1
            banks = getattr(self, f"ple_layer_{l}")
            gates = getattr(self, f"ple_gate_{l}")
            dnn_outputs, task_inputs = [], []
            for t in range(num_total):
                if is_first:
                    x = inputs
                elif self.is_shared[t]:
                    x = torch.cat(last_outputs, dim=-1)
                else:
                    x = torch.cat([last_outputs[t]] + [
                        o for o, sh in zip(last_outputs, self.is_shared)
                        if sh], dim=-1)
                task_inputs.append(x)
                for layer in banks[f"task_{self.names[t]}"].values():
                    x = layer(x)                            # (N_t, B, U)
                dnn_outputs.append(x)

            gated: List[torch.Tensor] = []
            for t in range(num_total):
                if self.is_shared[t] and is_last:
                    gated.append(None)
                    continue
                if self.is_shared[t]:
                    experts = torch.cat(dnn_outputs, dim=0)
                else:
                    experts = torch.cat([dnn_outputs[t]] + [
                        o for o, sh in zip(dnn_outputs, self.is_shared)
                        if sh], dim=0)
                gate = torch.softmax(
                    gates[f"task_{self.names[t]}"]["dense"](task_inputs[t]),
                    dim=-1)                                 # (B, N)
                gated.append(torch.einsum("nbu,bn->bu", experts, gate))
            last_outputs = gated
        return [o for o in last_outputs if o is not None]
