"""Stateless integer hashing for the multi-hash embedding trick.

Counterpart of ``rec_now_tpu/ops/hashing.py``, bit for bit: murmur3's
fmix32 avalanche on 32-bit words, salted per hash function.  torch has no
32-bit unsigned arithmetic with shifts on every device, so each word is
an int64 holding [0, 2^32), masked to 32 bits after every multiply, add
and shift: an int64 product of two 32-bit values wraps, but its low 32
bits are the uint32 product's.

Ids of any integer dtype.  An int64 tensor (torch's default integer) is
folded to 32 bits as JAX's ``_to_u32`` folds 64-bit ids, ``lo ^
mix32(hi)``: ids in [0, 2^32) hash as in JAX's default mode, where
``jnp.asarray`` wraps int64 ids to int32 and no fold runs (their hi is 0
and ``mix32(0) = 0``); a negative or wider int64 id hashes as JAX does
under ``jax_enable_x64``.  Every other
integer dtype is cast (its two's complement low 32 bits), as JAX casts an
int32.  Hashes come back as int64 (torch's index dtype) where JAX gives
int32 bins or uint32 words; the values are the same.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
# murmur3 fmix32 constants (public domain)
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer ids -> int64 words in [0, 2^32): int64 folded, others
    cast."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise TypeError(f"hashing takes integer ids, got {x.dtype}")
    if x.dtype == torch.int64:
        lo = x & _MASK
        hi = (x >> 32) & _MASK
        return lo ^ mix32(hi)
    return x.to(torch.int64) & _MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on 32-bit words (an int64 tensor holding
    [0, 2^32); other values are taken modulo 2^32)."""
    x = x.to(torch.int64) & _MASK
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 13)
    x = (x * _M2) & _MASK
    return x ^ (x >> 16)


# kept under the historical name the JAX package uses
splitmix64 = mix32


def salted_hash(ids: torch.Tensor, salt: int, num_bins: int) -> torch.Tensor:
    """Hash integer ids into [0, num_bins) with a per-function salt.

    Args:
        ids: integer tensor of any shape.
        salt: int salt distinguishing hash functions.
        num_bins: bucket count.

    Returns:
        int64 bucket indices, the shape of ``ids``.
    """
    seed = int(mix32(torch.tensor(salt & _MASK)))
    h = mix32(_to_u32(torch.as_tensor(ids)) ^ seed)
    # a second round decorrelates consecutive ids across salts
    h = mix32((h + seed) & _MASK)
    return h % num_bins


def combine_hash(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-sensitive combination of two id streams into one 32-bit word
    (boost-style hash_combine, avalanched), as an int64 in [0, 2^32)."""
    a = _to_u32(torch.as_tensor(a))
    b = _to_u32(torch.as_tensor(b))
    return mix32(a ^ ((mix32(b) + _GOLDEN + ((a << 6) & _MASK)
                       + (a >> 2)) & _MASK))
