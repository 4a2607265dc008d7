"""Initializers, activations and device resolution.

Counterpart of ``rec_now_tpu/core/config.py``, reduced to what the
ported modules use: the glorot-uniform (also with per-expert fans, as
``glorot_uniform_nd(1, 2)``), uniform, ones and zeros initializers, drawn
from an explicit ``torch.Generator`` on the CPU so that a seed gives the
same weights on every device; :func:`make_linear`, an ``nn.Linear`` with
Flax's default ``Dense`` init; :func:`get_activation` for the
activations the ported models set; and :func:`resolve_device`.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn

_ACTIVATIONS = {
    "relu": torch.relu,
    "linear": lambda x: x,
    "none": lambda x: x,
}


def get_activation(act: Optional[str]) -> Callable:
    """An activation name (``"relu"``, ``"linear"``/``"none"``) or None
    -> a callable; None is the identity."""
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


def glorot_uniform_nd(shape, generator: torch.Generator) -> torch.Tensor:
    """Glorot-uniform for (N, D, U) expert-bank kernels with the fans of
    one expert, in = D and out = U (``glorot_uniform_nd(1, 2)``)."""
    return glorot_uniform(shape, shape[1], shape[2], generator)


def ones(shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32)


def zeros(shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32)


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
