"""Initializers, activations and device resolution.

Counterpart of ``rec_now_tpu/core/config.py``, reduced to what the
ported modules use: the glorot-uniform (also with chosen fan axes, as
``glorot_uniform_nd``), uniform, ones, zeros and constant initializers,
drawn from an explicit ``torch.Generator`` on the CPU so that a seed gives
the same weights on every device, and :func:`get_initializer` to resolve
a name; :func:`make_linear`, an ``nn.Linear`` with Flax's default
``Dense`` init; :func:`get_activation` for the activations the ported
layers set; and :func:`resolve_device`.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "linear": lambda x: x,
    "none": lambda x: x,
}


def get_activation(act: Optional[str]) -> Callable:
    """An activation name (``"relu"``, ``"tanh"``, ``"linear"``/``"none"``)
    or None -> a callable; None is the identity."""
    if act is None:
        return _ACTIVATIONS["linear"]
    key = str(act).lower()
    if key not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    return _ACTIVATIONS[key]


def glorot_uniform(shape, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), on the CPU."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(shape, limit, generator)


def glorot_uniform_nd(shape, generator: torch.Generator, in_axis: int = -2,
                      out_axis: int = -1) -> torch.Tensor:
    """Glorot-uniform with Flax's fans for an n-D kernel: every axis other
    than ``in_axis`` and ``out_axis`` is receptive field, so fan_in =
    shape[in_axis] * field and fan_out = shape[out_axis] * field
    (``variance_scaling(1, "fan_avg", "uniform", in_axis, out_axis)``, as
    the JAX package's ``glorot_uniform_nd`` and, with the last two axes,
    Flax's ``glorot_uniform`` build it).  An (N, D, U) expert bank thus
    has fans D * N and U * N; DCN-mix's (L, N, D, S) kernels D * L * N and
    S * L * N, its (L, D, N) gates D * L and N * L."""
    field = math.prod(shape) // shape[in_axis] // shape[out_axis]
    return glorot_uniform(shape, shape[in_axis] * field,
                          shape[out_axis] * field, generator)


def ones(shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32)


def zeros(shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


def constant_initializer(value: float) -> Callable:
    """An initializer filling ``shape`` with ``value`` (the sparse GNN's
    edge weights)."""
    def init(shape, generator=None) -> torch.Tensor:
        return torch.full(tuple(shape), float(value), dtype=torch.float32)
    return init


def get_initializer(init: str) -> Callable:
    """A name (``"zeros"``, ``"ones"``, ``"glorot_uniform"`` with Flax's
    fans for any rank) -> a callable ``(shape, generator) -> tensor``."""
    key = str(init).lower()
    if key == "zeros":
        return lambda shape, generator=None: zeros(shape)
    if key == "ones":
        return lambda shape, generator=None: ones(shape)
    if key in ("glorot_uniform", "xavier_uniform"):
        return lambda shape, generator: glorot_uniform_nd(shape, generator)
    raise ValueError(f"unknown initializer {init!r}")


def uniform(shape, limit: float, generator: torch.Generator
            ) -> torch.Tensor:
    """U(-limit, limit) float32, on the CPU."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u.mul_(2.0 * limit).sub_(limit)


def make_linear(in_dim: int, out_dim: int, device: torch.device,
                generator: torch.Generator) -> nn.Linear:
    """nn.Linear with Flax's default Dense init: glorot weight, zero bias."""
    lin = nn.Linear(in_dim, out_dim, device="meta")
    w = glorot_uniform((in_dim, out_dim), in_dim, out_dim, generator)
    lin.weight = nn.Parameter(w.t().contiguous().to(device))
    lin.bias = nn.Parameter(torch.zeros(out_dim, device=device))
    return lin


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; CUDA must exist when asked for.

    Entry points default to ``"cuda"``: the CPU is used only when the
    caller asks for it, and a CUDA-less host raises instead of quietly
    running there.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_input(x, device: torch.device) -> torch.Tensor:
    """A tensor as it is; anything else (a list, an array) as a tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=device)
