"""The traffic driver end to end at a small size on the CPU: the result
line's keys, the cell's metrics, ``correct``; and the traffic drawn from
the seed."""
import json

import pytest

from conftest import CELLS, small_cell


def _line(capsys, cell, out, trace):
    import run
    assert run.emit(cell, out, trace) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    return line


@pytest.mark.parametrize("name", CELLS)
def test_pb_cell_runs(name, capsys):
    cell = small_cell(name)
    out = cell.driver().run(cell)
    line = _line(capsys, cell, out, False)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in cell.bench["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


@pytest.mark.parametrize("name", CELLS)
def test_pb_cell_traced(name, capsys):
    cell = small_cell(name, trace=True)
    out = cell.driver().run(cell)
    line = _line(capsys, cell, out, True)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    listed = {m["name"] for m in cell.bench["per_layer"]
              if cell.name in m["workloads"]}
    # the CPU has no device trace: only host-clock readers find something
    assert set(line["metrics"]) <= listed
    assert "mfu.serve" in line["metrics"]


def test_pb_same_seed_same_traffic():
    import numpy as np
    cell = small_cell()
    draw = cell.driver().draw_pool
    a = draw(cell.cfg, cell.mix, 2 ** 40 + 3)
    b = draw(cell.cfg, cell.mix, 2 ** 40 + 3)
    c = draw(cell.cfg, cell.mix, 2 ** 40 + 4)
    for (_, x), (_, y) in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0][1], c[0][1])
    ids = np.stack([x for _, x in a])
    assert ids.shape[2] == cell.cfg["num_fields"]
    assert 0 <= ids.min() and ids.max() < cell.cfg["rows_per_field"]


def test_pb_reservoir_is_uniform():
    import numpy as np
    res = small_cell().driver().Reservoir
    counts = np.zeros(20)
    for seed in range(2000):
        r = res(4, seed)
        for i in range(20):
            r.offer(i)
        assert r.seen == 20 and len(r.items) == 4
        counts[r.items] += 1
    # each item kept 4/20 of the time: 400 of 2,000, sd ~18
    assert np.abs(counts - 400).max() < 90
