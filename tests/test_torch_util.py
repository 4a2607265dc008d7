"""Port vs JAX: ``core/shapes.py``, ``util/``, ``core/debug.py`` and
``core/profiling.py``.

* ``wrap_as_list`` and ``pad_or_truncate`` against JAX's on the same numpy
  inputs (every axis, pad, cut and keep, a fill value), exactly;
* ``numpy_tools`` against JAX's;
* ``dbg_*``: identity, JAX's printed shape and values;
* ``profiling``: ``annotate`` shows in a trace, ``trace`` writes a Chrome
  trace, ``guard_finite`` passes through, is silent when disabled and
  prints JAX's message on a NaN, ``device_memory_stats`` gives JAX's
  keys (-1 on the CPU).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.core import shapes as jshapes
from rec_now_tpu.util import numpy_tools as jtools
from rec_now_tpu_torch import util
from rec_now_tpu_torch.core import debug, profiling, shapes
from rec_now_tpu_torch.util import numpy_tools, param_normalizer

torch.set_num_threads(1)


@pytest.mark.parametrize("value", [3, [1, 2], (1, 2), None, "x"])
def test_wrap_as_list_matches_jax(value):
    assert shapes.wrap_as_list(value) == jshapes.wrap_as_list(value)
    assert util.wrap_as_list is param_normalizer.wrap_as_list
    assert util.wrap_as_list is shapes.wrap_as_list


@pytest.mark.parametrize("shape,length,axis", [
    ((2, 5, 3), 7, 1), ((2, 5, 3), 2, 1), ((2, 5, 3), 5, 1),
    ((2, 5, 3), 4, -1), ((2, 5, 3), 1, 0), ((2, 5, 3), 6, -3), ((4,), 9, 0)])
@pytest.mark.parametrize("dtype,fill", [(np.float32, 0), (np.float32, -1.5),
                                        (np.int64, 7)])
def test_pad_or_truncate_matches_jax(shape, length, axis, dtype, fill):
    x = (np.random.RandomState(0).randn(*shape) * 10).astype(dtype)
    got = shapes.pad_or_truncate(torch.from_numpy(x), length, axis, fill)
    want = np.asarray(jshapes.pad_or_truncate(jnp.asarray(x), length, axis,
                                              fill))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[axis] == length


def test_numpy_tools_match_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(4, 3), rng.randn(4, 3)
    assert numpy_tools.calc_sum_of_abs_diff(a, b) == \
        jtools.calc_sum_of_abs_diff(a, b)
    assert util.calc_sum_of_abs_diff([1, 2], [3, 5]) == 5.0
    for x, y in ((a, a.copy()), (a, b), ([1, 2], [1, 2])):
        assert util.all_equal(x, y) == jtools.all_equal(x, y)


def test_dbg_prints_the_jax_format_and_returns_its_input(capsys):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert debug.dbg_print(t, "x", do_print=False) is t
    assert debug.dbg_minmax(t, "x", do_print=False) is t
    assert capsys.readouterr().out == ""
    assert debug.dbg_print(t, "x", summarize=4) is t
    assert debug.dbg_minmax(t - 2, "y") is not None
    pair = [t, t[0]]
    assert debug.dbg_print_list(pair, "l") is pair
    assert debug.dbg_print_list(pair, "l", do_print=False) is pair
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["x shape=(2, 3) values=[0. 1. 2. 3.]",
                     "y shape=(2, 3) min=-2.0 max=3.0",
                     "l[0] shape=(2, 3) values=[0. 1. 2. 3. 4. 5.]",
                     "l[1] shape=(3,) values=[0. 1. 2.]"]


def test_guard_finite(capsys):
    x = torch.tensor([1.0, -2.0, 3.0])
    assert profiling.guard_finite(x, "ok") is x
    assert capsys.readouterr().out == ""
    bad = torch.tensor([1.0, float("nan"), -4.0, float("inf")])
    assert profiling.guard_finite(bad, "bad", enabled=False) is bad
    assert capsys.readouterr().out == ""
    assert profiling.guard_finite(bad, "bad") is bad
    assert capsys.readouterr().out.strip() == \
        "[guard_finite] non-finite values in bad min=-4.0 max=inf"
    profiling.guard_finite(torch.full((2,), float("nan")), "nan")
    assert capsys.readouterr().out.strip() == \
        "[guard_finite] non-finite values in nan min=nan max=nan"


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    @profiling.annotate("my_block")
    def block(a):
        return (a @ a).sum()

    assert block.__name__ == "block"
    with profiling.trace(str(tmp_path / "tr")):
        out = block(torch.ones(8, 8))
    assert float(out) == 512.0
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "my_block" for e in events)


def test_device_memory_stats_keys_on_the_cpu():
    want = {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    for dev in ("cpu", torch.device("cpu")):
        stats = profiling.device_memory_stats(dev)
        assert set(stats) == want and set(stats.values()) == {-1}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == stats
