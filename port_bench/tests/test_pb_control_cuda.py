"""On the card, at each cell's widths and batch with a smaller table and
pool: the program passes the cell's limits and its control (the plain
reference with TF32 on in the program's place) fails them."""
import time

import pytest

import control
import harness
from conftest import CELLS

SIZES = {"cfg": {"rows_per_field": 5_000}, "mix": {"pool_requests": 8}}


def _fails(checks, limits) -> bool:
    return any(c["value"] > limits[k] for k, c in checks.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_pb_control_fails_program_passes(name, cuda_device):
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        cell = harness.Cell(name, seed, 1.0, False, cuda_device,
                            time.monotonic(), sizes=SIZES)
        assert not _fails(control.readings(cell, "program"), cell.limits)
        assert _fails(control.readings(cell, "control"), cell.limits)
