"""The per-layer readers' arithmetic on hand-made traces."""
import math

import pytest

import devtrace
import harness

S = devtrace.STRETCH


def _x(cat, name, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _trace():
    # a 1,000 us stretch; two streams overlap in 100-150; a memset, a
    # copy; one kernel outside the stretch is not counted
    return [_x("user_annotation", S, 1000, 1000),
            _x("kernel", "void (anonymous namespace)::gather4_kernel<long>"
               "(float4 const*)", 1100, 100),
            _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1150, 100),
            _x("kernel", "void (anonymous namespace)::cin_layer_tc_kernel<2>"
               "(float const*)", 1400, 50),
            _x("gpu_memset", "Memset (Device)", 1700, 20),
            _x("kernel", "void at::native::(anonymous namespace)::"
               "gather1_kernel<long>(float const*)", 1800, 100),
            _x("kernel", "gather4_kernel", 2500, 100),
            _x("cpu_op", "aten::argsort", 1250, 200),
            _x("cpu_op", "aten::index_add_", 1460, 300),
            _x("cpu_op", "aten::mm", 1500, 100),
            _x("cpu_op", "aten::mm", 1500, 100, tid=8)]


def test_pb_kernel_names():
    kmap = {"reduce_kernel": "w"}
    port = devtrace.base_name(
        "void (anonymous namespace)::reduce_kernel<4>(float const*)")
    assert port == "(anonymous namespace)::reduce_kernel"
    assert devtrace.port_wrapper(port, kmap) == "w"
    # a library's kernel of the same name, in a namespace or in a nested
    # anonymous one, or a bare global one, is never the port's
    for raw, base in [
            ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)",
             "at::native::reduce_kernel"),
            ("void at::native::(anonymous namespace)::reduce_kernel<1>(int)",
             "at::native::reduce_kernel"),
            ("void reduce_kernel<2>(float*)", "reduce_kernel"),
            ("ampere_sgemm_64x32_nn", "ampere_sgemm_64x32_nn")]:
        assert devtrace.base_name(raw) == base
        assert devtrace.port_wrapper(base, kmap) is None


def test_pb_union_counts_overlap_once():
    assert devtrace.union([(0, 10), (5, 20), (30, 40)]) == [(0, 20), (30, 40)]
    assert devtrace.gaps([(0, 20), (30, 40)], -5, 50) == [
        (-5, 0), (20, 30), (40, 50)]


def test_pb_reduce_trace():
    r = devtrace.reduce_trace(_trace(), loop_tid=7)
    assert r["window_s"] == pytest.approx(1000e-6)
    # 1100-1250 (two streams), 1400-1450, 1700-1720, 1800-1900
    assert r["busy_s"] == pytest.approx((150 + 50 + 20 + 100) * 1e-6)
    assert r["device_ops"] == 5
    assert r["wrapper_s"] == pytest.approx({"gather_rows": 100e-6,
                                            "cin_flat": 50e-6})
    assert "at::native::gather1_kernel" in r["unmapped"]
    idle = r["idle_by_host"]
    # gaps by their middles: 1000-1100 (1050, none), 1250-1400 (1325,
    # argsort), 1450-1700 (1575: the mm inside index_add_; the other
    # thread's mm is not the loop's), 1720-1800 (1760, index_add_),
    # 1900-2000 (none)
    assert idle == pytest.approx({"host: python between ops": 200e-6,
                                  "aten::argsort": 150e-6,
                                  "aten::mm": 250e-6,
                                  "aten::index_add_": 80e-6})


def _read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def test_pb_readers():
    tr = devtrace.reduce_trace(_trace(), loop_tid=7)
    ctx = {"trace": tr, "requests": 5,
           "bound_s": {"gather_rows": 50e-6, "cin_flat": 25e-6},
           "steady_wall_s": 2.0, "steady_flops": 4.95e12}
    assert _read("launches_per_request.serve", ctx) == 1.0
    assert _read("kernel_roofline.serve", ctx) == pytest.approx(50.0)
    assert _read("gather_rows_roofline", ctx) == pytest.approx(50.0)
    assert _read("cin_flat_roofline", ctx) == pytest.approx(50.0)
    assert _read("device_idle_share.serve", ctx) == pytest.approx(68.0)
    assert _read("mfu.serve", ctx) == pytest.approx(0.5)
    empty = {"trace": None}
    for name in ("launches_per_request.serve", "kernel_roofline.serve",
                 "cin_flat_roofline", "gather_rows_roofline",
                 "device_idle_share.serve", "mfu.serve"):
        assert _read(name, empty) is None


def test_pb_roofline_leaves_out_unbounded_wrappers():
    tr = {"wrapper_s": {"gather_rows": 1e-3, "adam_dense_pass": 1.0},
          "device_ops": 2}
    ctx = {"trace": tr, "bound_s": {"gather_rows": 0.5e-3}}
    assert _read("kernel_roofline.serve", ctx) == pytest.approx(50.0)
    assert _read("gather_rows_roofline", ctx) == pytest.approx(50.0)
    # a wrapper with a bound whose kernels never ran reads nothing
    assert _read("cin_flat_roofline", {"trace": tr, "bound_s": {
        "cin_flat": 1e-3}}) is None
    assert math.isfinite(_read("kernel_roofline.serve", ctx))
