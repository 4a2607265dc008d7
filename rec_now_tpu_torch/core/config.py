"""Initializers and device resolution.

Counterpart of ``rec_now_tpu/core/config.py``, reduced to what the
ported modules use: the glorot-uniform and uniform initializers, drawn
from an explicit ``torch.Generator`` on the CPU so that a seed gives the
same weights on every device, and :func:`resolve_device`.
"""
from __future__ import annotations

import math
from typing import Union

import torch


def glorot_uniform(shape, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), on the CPU."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(shape, limit, generator)


def uniform(shape, limit: float, generator: torch.Generator
            ) -> torch.Tensor:
    """U(-limit, limit) float32, on the CPU."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return u.mul_(2.0 * limit).sub_(limit)


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
