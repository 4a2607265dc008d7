"""Frozen arithmetic of operations and bytes: the least work of one CIN
layer, copied from ``chip_smoke.py`` (``cin_flops``, :486-493), the
function behind PERF.md section 6's "bound ms" column of the CIN rows;
and the peaks every bound is held to.

One change from PERF.md: every operation is held to one rate, the dense
TF32 tensor-core peak, whatever unit runs it (PERF.md counted split TF32
as three products at that rate and the rest at the f32 rate).  With one
rate no f32-accurate implementation can read over 100%.
"""
from __future__ import annotations

import json
from pathlib import Path

_PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json"
                     ).read_text())
OPS_PER_S = float(_PEAKS["ops_per_s"])
BYTES_PER_S = float(_PEAKS["bytes_per_s"])


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds: the larger of ops at the peak rate and bytes at
    the peak bandwidth."""
    return max(ops / OPS_PER_S, nbytes / BYTES_PER_S)


def cin_flops(m: int, f: int, h: int, k: int, prev_is_x0: bool) -> int:
    """Least operations of one CIN layer out[m,k] = sum_{f,h} W[k,f,h]
    x0[m,f] prev[m,h]: the products x0[f] prev[h] once per row, then a
    multiply-add per (k, product), or W first, whichever is less; with
    prev = x0 the products are symmetric, F(F+1)/2 a row."""
    terms = f * (f + 1) // 2 if prev_is_x0 else f * h
    return min(m * terms + 2 * m * k * terms, 2 * m * k * f * (h + 1))
