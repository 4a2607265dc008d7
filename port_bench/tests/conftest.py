"""The benchmark's own tests: ``python -m pytest port_bench/tests -q``
from the repository's root (the ``cuda`` ones on the card: ``-m cuda``).
Small shapes on the CPU through the port's plain kernel versions."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELL = "xdeepfm-criteo-serve-b8192"
CELLS = [CELL, "xdeepfm-criteo-serve-b1024"]
# the cell at test sizes: the configuration's widths, a small table,
# batch and pool, short windows
SIZES = {"cfg": {"rows_per_field": 500},
         "mix": {"batch_size": 64, "pool_requests": 6, "warmup_requests": 2,
                 "check_requests": 3, "trace_steady_s": 0.3,
                 "trace_s": 0.3}}


def small_cell(name: str = CELL, seed: int = 2 ** 33 + 7,
               trace: bool = False, device: str = "cpu", sizes=None):
    """A harness cell at :data:`SIZES` (``sizes`` may replace them)."""
    import harness
    return harness.Cell(name, seed, 0.6, trace, device, time.monotonic(),
                        sizes=SIZES if sizes is None else sizes)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
