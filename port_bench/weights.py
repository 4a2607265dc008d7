"""The weights both sides get, made from ``--seed`` on the device.

Dense weights: one uniform draw for every weight whose limit is not 0,
split by the reference's ``param_specs`` and scaled to each limit;
limit 0 is zeros.  The table: one uniform draw, U(-scale, scale).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``seed`` (``--seed`` may pass more
    than 32 bits)."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags]
                                   ).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_params(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} from [(name, shape, limit)]: U(-limit, limit), or
    zeros where limit is 0."""
    drawn = [(n, s, lim) for n, s, lim in specs if lim]
    total = sum(math.prod(s) for _, s, _ in drawn)
    u = torch.rand(total, generator=_generator(device, derive_seed(seed, 1)),
                   device=device)
    out, at = {}, 0
    for name, shape, limit in specs:
        if not limit:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        out[name] = (u[at:at + n] * (2 * limit) - limit).reshape(shape)
        at += n
    return out


def make_table(cfg: dict, seed: int, device) -> torch.Tensor:
    """The (num_fields * rows_per_field, table_width) table."""
    scale = cfg["table_init_scale"]
    u = torch.rand((cfg["num_fields"] * cfg["rows_per_field"],
                    cfg["table_width"]),
                   generator=_generator(device, derive_seed(seed, 2)),
                   device=device)
    return u.mul_(2 * scale).sub_(scale)
