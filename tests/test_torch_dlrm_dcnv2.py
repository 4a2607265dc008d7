"""DLRM-DCNv2 on the port: the per-field, multi-hot ``FeatureConfig``, the
pooled lookup ``gather_pool_rows`` (plain version; the kernel on the
card), DCN-V2's low-rank cross layer (its torch ops; B8's ``wgmma``
kernel through ``cross_wg`` on the card, and where the layer falls back),
and ``DLRMDCNv2Model`` served
through ``build_scorer`` against the benchmark's plain reference
(``port_bench/reference/dlrm-dcnv2-criteo1tb.py``, loaded by path) on
seeded random weights; and the paths that refuse the new layout.

No JAX here: the JAX package has neither the layout nor the model.  The
``cuda`` tests run on the card with ``python -m pytest --noconftest
tests/test_torch_dlrm_dcnv2.py -q -m cuda``.

Tolerances: id arithmetic exact; the plain lookup against a Python loop
of float32 adds in the same column order exact; the cross layer against
its formula in float64 1e-6 of the largest output (float32 products of
width 12), on the card's kernel 2e-6 (split TF32, sums in other orders,
the epilogue's multiply-add fused); the model against the reference 1e-5
of the largest logit (both float32, sums in other orders: the pooled
rows, ``addmm``'s bias);
the kernel against the plain version exact (the same adds in the same
order, no fused multiply-add), the served logits on the card against the
CPU's 1e-5 of the largest (float32 products in other orders).
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rec_now_tpu_torch.core import profiling
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.layers import LowRankCrossLayer
from rec_now_tpu_torch.models import (CANDCNModel, DLRMDCNv2Model,
                                      FeatureConfig)
from rec_now_tpu_torch.ops import gather_kernel as gk
from rec_now_tpu_torch.ops import multi_dense_kernel as mk
from rec_now_tpu_torch.serving import ServingState, WireScorer, build_scorer
from rec_now_tpu_torch.training import Trainer, TrainerConfig

torch.set_num_threads(1)

REF = Path(__file__).resolve().parents[1] / "port_bench" / "reference"
# the small model of the comparisons: 4 fields of 8, hotness (1, 3, 2, 5)
ROWS, HOT = (5, 7, 3, 11), (1, 3, 2, 5)
SMALL = {"num_dense_features": 3, "num_sparse_features": 4,
         "embedding_dim": 8, "num_embeddings_per_feature": list(ROWS),
         "multi_hot_sizes": list(HOT), "dense_arch_layer_sizes": [16, 8],
         "dcn_num_layers": 2, "dcn_low_rank_dim": 4,
         "over_arch_layer_sizes": [16, 8, 1]}


def _fc(**kw):
    args = dict(num_dense=3, num_sparse=4, embedding_dim=8, field_rows=ROWS,
                hotness=HOT)
    args.update(kw)
    return FeatureConfig(**args)


def _reference():
    if str(REF) not in sys.path:
        sys.path.insert(0, str(REF))
    spec = importlib.util.spec_from_file_location(
        "dlrm_dcnv2_reference", REF / "dlrm-dcnv2-criteo1tb.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- FeatureConfig -----------------------------------------------------------
def test_per_field_layout_by_hand():
    fc = _fc()
    assert fc.per_field
    assert fc.total_rows == 26
    assert fc.field_offsets().tolist() == [0, 5, 12, 15]
    raw = torch.tensor([[4, 0, 6, 13, 2, 5, 0, 10, 11, 22, -1],
                        [5, 1, 2, 3, 4, 3, 9, 0, 1, 2, 3]], dtype=torch.int32)
    # columns: field 0 | field 1 x 3 | field 2 x 2 | field 3 x 5; each id
    # modulo its field's rows, plus the rows before the field
    want = [[4, 5, 11, 5 + 6, 12 + 2, 12 + 2, 15, 15 + 10, 15 + 0,
             15 + 0, 15 + 10],
            [0, 6, 7, 8, 12 + 1, 12 + 0, 15 + 9, 15, 16, 17, 18]]
    got = fc.global_ids(raw)
    assert got.dtype == torch.int64 and got.tolist() == want
    with pytest.raises(ValueError, match="11 columns"):
        fc.global_ids(raw[:, :4])


@pytest.mark.parametrize("kw", [dict(hotness=None),
                                dict(field_rows=None)])
def test_per_field_layout_needs_rows_and_hotness_together(kw):
    with pytest.raises(ValueError, match="given together"):
        _fc(**kw)


@pytest.mark.parametrize("hotness,cols,lookup", [
    (HOT, 11, "lookup_pooled"),        # a multi-hot layout pools
    ((1, 1, 1, 1), 4, "lookup")])      # one id a field: B11, as by default
def test_scorer_takes_the_lookup_of_its_layout(hotness, cols, lookup):
    fc = _fc(hotness=hotness)
    if cols == 4:
        assert fc.global_ids(torch.tensor([[6, 7, 3, 12]])).tolist() == [
            [1, 5, 12, 16]]
    model = DLRMDCNv2Model(fc, dense_arch=(8,), cross_layers=1,
                           cross_rank=2, over_arch=(4,), device="cpu")
    table = EmbeddingTable(fc.total_rows, 8, "cpu")
    calls = []
    for name in ("lookup", "lookup_pooled"):
        real = getattr(table, name)
        setattr(table, name, lambda *a, _n=name, _f=real: (calls.append(_n),
                                                            _f(*a))[1])
    scorer = build_scorer(model, fc, table, device="cpu")
    state = ServingState({n: p.detach() for n, p in model.named_parameters()},
                         torch.randn(fc.total_rows, 8))
    ids = np.arange(2 * cols, dtype=np.int32).reshape(2, cols)
    out = scorer(state, np.ones((2, 3), np.float32), ids)
    assert out.shape == (2,) and bool(torch.isfinite(out).all())
    assert calls == [lookup]


def test_default_layout_gives_todays_ids():
    fc = FeatureConfig(num_sparse=5, rows_per_field=1000)
    assert not fc.per_field
    assert fc.field_rows is None and fc.hotness is None
    assert fc == FeatureConfig(num_sparse=5, rows_per_field=1000)
    raw = torch.from_numpy(np.random.RandomState(0).randint(
        -10 ** 6, 10 ** 6, size=(7, 5)).astype(np.int32))
    want = raw.to(torch.int64) % 1000 + torch.arange(5) * 1000
    assert torch.equal(fc.global_ids(raw), want)
    assert fc.total_rows == 5000


@pytest.mark.parametrize("kw", [dict(field_rows=(5, 7, 3)),
                                dict(hotness=(1, 0, 2, 1)),
                                dict(field_rows=(5, 7, 3, -1))])
def test_per_field_layout_refuses_bad_counts(kw):
    with pytest.raises(ValueError, match="num_sparse = 4"):
        _fc(**kw)


# -- the pooled lookup, plain -------------------------------------------------
def _loop_pool(table, ids, hotness):
    out = torch.zeros(ids.shape[0], len(hotness), table.shape[1])
    for b in range(ids.shape[0]):
        at = 0
        for f, h in enumerate(hotness):
            for j in range(at, at + h):
                out[b, f] += table[int(ids[b, j].clamp(0,
                                                       table.shape[0] - 1))]
            at += h
    return out


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_pool_rows_plain_is_index_and_sum(dtype):
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(40, 6, generator=gen)
    hotness = (1, 3, 0, 5, 2)
    ids = torch.randint(-4, 44, (7, 11), generator=gen).to(dtype)
    want = _loop_pool(table, ids, hotness)
    assert torch.equal(gk.gather_pool_rows_plain(table, ids, hotness), want)
    before = gk.gather_pool_rows.launches
    assert torch.equal(gk.gather_pool_rows(table, ids, hotness), want)
    assert torch.equal(EmbeddingTable(40, 6, "cpu").lookup_pooled(
        table, ids, hotness), want)
    assert gk.gather_pool_rows.launches == before   # the CPU launches none
    with pytest.raises(ValueError, match="sum\\(hotness\\) = 11"):
        gk.gather_pool_rows(table, ids[:, :10], hotness)
    with pytest.raises(ValueError, match="forward only"):
        gk.gather_pool_rows(table.requires_grad_(), ids, hotness)


# -- the low-rank cross layer -------------------------------------------------
def test_low_rank_cross_layer_is_its_formula():
    gen = torch.Generator().manual_seed(5)
    layer = LowRankCrossLayer(12, 4, 3, gen, device="cpu")
    assert layer.v_kernels.shape == (3, 12, 4)
    assert layer.w_kernels.shape == (3, 4, 12)
    assert torch.equal(layer.biases, torch.zeros(3, 12))
    lim = (6 / 16) ** 0.5                             # glorot, fans 12 and 4
    assert 0.5 * lim < float(layer.v_kernels.detach().abs().max()) <= lim
    with torch.no_grad():
        layer.biases.uniform_(-1, 1, generator=gen)
    x0 = torch.randn(9, 12, generator=gen)
    v, w, bias = (t.detach().double() for t in
                  (layer.v_kernels, layer.w_kernels, layer.biases))
    x = x0.double()
    for i in range(3):
        x = x0.double() * (x @ v[i] @ w[i] + bias[i]) + x
    got = layer(x0).detach()
    assert float((got.double() - x).abs().max()) <= 1e-6 * float(
        x.abs().max())


def _counter(name):
    return profiling.span_report()["counters"].get(name, 0)


def _cross_by_hand(layer, x0):
    """The three torch ops of every layer, as the layer ran them before it
    asked cross_wg."""
    x = x0
    for i in range(layer.num_layers):
        xw = torch.addmm(layer.biases[i], x @ layer.v_kernels[i],
                         layer.w_kernels[i])
        x = torch.addcmul(x, x0, xw)
    return x


# (b, d, r, aligned, taken): DLRM-DCNv2's cross (3,456 wide, rank 512) at
# B = 8,192 and at the least batch the plan takes; its rows off the 16-byte
# grid; a width and a rank off the 4-float grid; a narrow rank that keeps
# b * min(d, r) small; an empty batch
CROSS_PLAN_CASES = [
    (8192, 3456, 512, True, True),
    (mk.CROSS_MIN_OUTPUTS // 512, 3456, 512, True, True),
    (mk.CROSS_MIN_OUTPUTS // 512 - 1, 3456, 512, True, False),
    (8192, 3456, 512, False, False),
    (8192, 3458, 512, True, False),
    (8192, 3456, 514, True, False),
    (8192, 3456, 4, True, False),
    (0, 3456, 512, True, False)]


@pytest.mark.parametrize("b,d,r,aligned,taken", CROSS_PLAN_CASES)
def test_cross_plan_decides_by_shape_and_alignment(b, d, r, aligned, taken):
    assert mk.cross_plan(b, d, r, aligned) is taken


@pytest.mark.parametrize("case", ["cpu", "grad", "d_not_4", "unaligned"])
def test_cross_layer_falls_back_where_cross_wg_refuses(monkeypatch, case):
    """LowRankCrossLayer asks cross_wg for each layer (x_l, x0, the
    layer's own v, w and b, and x_l as the output past layer 0) where no
    gradient is recorded, never where one is; where the answer is None it
    runs today's addmm and addcmul,
    counted once a layer in ``cross.torch``, to the same numbers.  Each
    case refuses for its own reason: CPU tensors, a gradient recorded, a
    width off the 4-float grid, x0 off the 16-byte grid (the plan's
    verdict at DLRM-DCNv2's widths beside it)."""
    asked = []

    def spy(x, x0, v, w, b, out=None):
        y = real(x, x0, v, w, b, out)
        asked.append((tuple(x.shape), x0, v, w, b, y, out is x,
                      out is None))
        return y

    real = mk.cross_wg
    monkeypatch.setattr(mk, "cross_wg", spy)
    d = 14 if case == "d_not_4" else 12
    gen = torch.Generator().manual_seed(11)
    layer = LowRankCrossLayer(d, 4, 3, gen, device="cpu")
    with torch.no_grad():
        layer.biases.uniform_(-1, 1, generator=gen)
    x0 = torch.randn(9, d, generator=gen)
    if case == "unaligned":
        x0 = torch.empty(x0.numel() + 1)[1:].view(9, d).copy_(x0)
        assert x0.data_ptr() % 16
    wide = 3458 if case == "d_not_4" else 3456
    assert mk.cross_plan(8192, wide, 512, case != "unaligned") is (
        case in ("cpu", "grad"))
    profiling.enable()
    try:
        before = _counter("cross.torch")
        if case == "grad":
            got = layer(x0)
            assert got.requires_grad
        else:
            with torch.no_grad():
                got = layer(x0)
        assert _counter("cross.torch") - before == 3
        assert _counter("cross.wgmma") == 0
    finally:
        profiling.disable()
    if case == "grad":
        assert asked == []
    else:
        def where(t):                      # a layer's slice of a parameter
            return t.data_ptr(), tuple(t.shape)

        assert [(s, x0_ is x0, where(v), where(w), where(b), y, onto_x,
                 fresh) for s, x0_, v, w, b, y, onto_x, fresh in asked] == [
            ((9, d), True, where(layer.v_kernels[i]),
             where(layer.w_kernels[i]), where(layer.biases[i]), None,
             i > 0, i == 0) for i in range(3)]
    with torch.no_grad():
        assert torch.equal(got.detach(), _cross_by_hand(layer, x0))


# -- the model through build_scorer against the benchmark's reference -------
def _weights(ref, cfg, seed):
    """Random weights by the reference's names: every tensor, biases too,
    U(-limit, limit) (biases U(-0.5, 0.5))."""
    rng = np.random.RandomState(seed)
    return {name: torch.from_numpy(rng.uniform(
        -(limit or 0.5), limit or 0.5, size=shape).astype(np.float32))
        for name, shape, limit in ref.param_specs(cfg)}


def test_model_serves_as_the_reference():
    ref = _reference()
    fc = _fc()
    model = DLRMDCNv2Model(fc, dense_arch=(16, 8), cross_layers=2,
                           cross_rank=4, over_arch=(16, 8), device="cpu")
    params = _weights(ref, SMALL, 0)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(p.shape) for n, p in params.items()}
    rng = np.random.RandomState(1)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (fc.total_rows, 8))
                             .astype(np.float32))
    dense = np.log1p(rng.exponential(8.0, (64, 3))).astype(np.float32)
    ids = rng.randint(0, 1000, size=(64, 11)).astype(np.int32)
    scorer = build_scorer(model, fc, EmbeddingTable(fc.total_rows, 8, "cpu"),
                          device="cpu")
    before = gk.gather_rows.launches
    profiling.enable()
    try:
        got = scorer(ServingState(params, table), dense, ids)
        spans = profiling.span_report()["spans"]
    finally:
        profiling.disable()
    for name in ("cross", "over"):
        assert spans[name]["count"] >= 1 and "stream_ms" not in spans[name]
    assert gk.gather_rows.launches == before
    with torch.no_grad():
        want = ref.forward(params, torch.from_numpy(dense),
                           ref.global_rows(ids, SMALL, "cpu"), table, SMALL)
    assert got.shape == (64,)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("relu_last", [False, True])
def test_tower_is_the_same_in_every_grad_mode(relu_last):
    """On the CPU a DNNTower runs nn.Linear in every grad mode: the same
    numbers with a gradient, under no_grad and under inference_mode;
    ``relu_last`` is ReLU after the last layer."""
    from rec_now_tpu_torch.models.tower import DNNTower
    gen = torch.Generator().manual_seed(4)
    tower = DNNTower(12, (16, 8), gen, device="cpu")
    x = torch.randn(37, 12, generator=gen)
    with_grad = tower(x, relu_last=relu_last)
    assert with_grad.requires_grad
    with torch.no_grad():
        no_grad = tower(x, relu_last=relu_last)
    with torch.inference_mode():
        inference = tower(x, relu_last=relu_last)
    assert torch.equal(with_grad.detach(), no_grad)
    assert torch.equal(no_grad, inference)
    plain = tower(x).detach()
    assert torch.equal(no_grad, torch.relu(plain) if relu_last else plain)


def test_model_is_the_same_in_every_grad_mode():
    """DLRMDCNv2Model's logits with a gradient recorded, under no_grad
    and under inference_mode (the ReLU after each tower folded into the
    tower's call) are the same on the CPU, and match its MLPs by hand."""
    fc = _fc()
    model = DLRMDCNv2Model(fc, dense_arch=(16, 8), cross_layers=2,
                           cross_rank=4, over_arch=(16, 8), device="cpu")
    gen = torch.Generator().manual_seed(6)
    dense = torch.randn(23, 3, generator=gen)
    emb = torch.randn(23, 4, 8, generator=gen)
    with_grad = model(dense, emb)
    with torch.no_grad():
        no_grad = model(dense, emb)
    with torch.inference_mode():
        inference = model(dense, emb)
    assert torch.equal(with_grad.detach(), no_grad)
    assert torch.equal(no_grad, inference)
    with torch.no_grad():
        x = dense
        for i in range(2):
            x = torch.relu(getattr(model.dense_arch, f"dense_{i}")(x))
        x0 = torch.cat([x[:, None, :], emb], dim=1).reshape(23, -1)
        x = model.cross(x0)
        for i in range(2):
            x = torch.relu(getattr(model.over_arch, f"dense_{i}")(x))
        assert torch.equal(model.head(x).squeeze(-1), no_grad)


def test_model_refuses_a_dense_arch_of_another_width():
    with pytest.raises(ValueError, match="dense arch ends at 16"):
        DLRMDCNv2Model(_fc(), dense_arch=(16,), device="cpu")


# -- paths that refuse the new layout ----------------------------------------
def test_paths_without_the_layout_refuse_it():
    fc = _fc()
    model = DLRMDCNv2Model(fc, dense_arch=(8,), device="cpu")
    table = EmbeddingTable(fc.total_rows, 8, "cpu")
    with pytest.raises(ValueError, match="Trainer takes one rows_per_field"):
        Trainer(model, fc, TrainerConfig(), device="cpu")
    with pytest.raises(ValueError, match="WireScorer's wire takes one"):
        WireScorer(model, fc, table, device="cpu")
    with pytest.raises(ValueError, match="the CAN lookup takes one"):
        build_scorer(CANDCNModel(FeatureConfig(rows_per_field=16,
                                               embedding_dim=8),
                                 device="cpu"),
                     fc, table, device="cpu",
                     can_table=EmbeddingTable(16, 8, "cpu"),
                     can_param_field=0)
    # per-field rows with one id a field are refused as well
    with pytest.raises(ValueError, match="Trainer takes one"):
        Trainer(model, _fc(hotness=(1, 1, 1, 1)), TrainerConfig(),
                device="cpu")


# -- the kernel on the card ---------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,b,hotness", [
    (40, 8, 7, (1, 3, 0, 5, 2)),                  # float4, a field of none
    (777, 5, 33, (2, 1, 7)),                      # D % 4: the scalar loop
    (3000, 128, 257, (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1,
                      1, 1, 12, 100, 27, 10, 3, 1, 1)),   # the published
    (50, 16, 0, (2, 3))])                         # no example
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_pool_rows_matches_plain_exactly(dev, v, d, b, hotness, dtype):
    gen = torch.Generator().manual_seed(v + d + b)
    table = torch.randn(v, d, generator=gen).to(dev)
    ids = torch.randint(-3, v + 3, (b, sum(hotness)), generator=gen
                        ).to(dtype).to(dev)
    before = gk.gather_pool_rows.launches
    got = gk.gather_pool_rows(table, ids, hotness)
    assert got.shape == (b, len(hotness), d)
    assert torch.equal(got, gk.gather_pool_rows_plain(table, ids, hotness))
    assert gk.gather_pool_rows.launches == before + (1 if b else 0)
    # a table view off the 16-byte grid takes the scalar loop
    off = torch.randn(v * d + 1, generator=gen).to(dev)[1:].view(v, d)
    assert torch.equal(gk.gather_pool_rows(off, ids, hotness),
                       gk.gather_pool_rows_plain(off, ids, hotness))


@pytest.mark.cuda
def test_gather_pool_rows_reads_rows_past_32_bit_offsets(dev):
    """Rows past 2^31 / D: a (2^24 + 300, 128) table, 8.6 GB, whose far
    rows start past 2^31 floats."""
    v, d = (1 << 24) + 300, 128
    table = torch.empty(v, d, device=dev)
    far = torch.arange(v - 260, v, device=dev)
    table[far] = torch.randn(far.numel(), d, device=dev)
    table[:64] = torch.randn(64, d, device=dev)
    gen = torch.Generator().manual_seed(7)
    hotness = (100, 27, 1)
    cols = sum(hotness)
    ids = torch.where(torch.rand(64, cols, generator=gen) < 0.5,
                      torch.randint(v - 260, v + 5, (64, cols),
                                    generator=gen),
                      torch.randint(0, 64, (64, cols), generator=gen)).to(dev)
    assert int(ids.max()) * d > 2 ** 31
    got = gk.gather_pool_rows(table, ids, hotness)
    want = gk.gather_pool_rows_plain(table, ids, hotness)
    assert torch.equal(got, want)
    del table


@pytest.mark.cuda
def test_scorer_on_the_card_pools_with_one_launch(dev):
    ref = _reference()
    fc = _fc()
    params = _weights(ref, SMALL, 2)
    rng = np.random.RandomState(3)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (fc.total_rows, 8))
                             .astype(np.float32))
    dense = np.log1p(rng.exponential(8.0, (300, 3))).astype(np.float32)
    ids = rng.randint(0, 1000, size=(300, 11)).astype(np.int32)
    out = {}
    for device in ("cpu", dev):
        model = DLRMDCNv2Model(fc, dense_arch=(16, 8), cross_layers=2,
                               cross_rank=4, over_arch=(16, 8),
                               device=device)
        scorer = build_scorer(model, fc, EmbeddingTable(fc.total_rows, 8,
                                                        device),
                              device=device)
        state = ServingState({k: p.to(device) for k, p in params.items()},
                             table.to(device))
        before = (gk.gather_pool_rows.launches, gk.gather_rows.launches)
        out[str(device)] = scorer(state, dense, ids).cpu()
        launched = (gk.gather_pool_rows.launches - before[0],
                    gk.gather_rows.launches - before[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 0))
    want = out["cpu"]
    assert float((out[str(dev)] - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def _wgmma_launches():
    return profiling.span_report()["counters"].get("multi_dense.wgmma", 0)


@pytest.mark.cuda
def test_served_model_counts_the_towers_wgmma_layers(dev):
    """Served at B = 8,192, each tower layer that wgmma_plan takes is one
    B8 wgmma launch a request (the over arch's 40 -> 256 -> 128; not the
    dense arch's 3-wide rows nor its 8,192 x 8 output), and the logits
    agree with the CPU's (nn.Linear) within 1e-5 of the largest."""
    from rec_now_tpu_torch.ops import multi_dense_kernel as mk
    ref = _reference()
    fc = _fc()
    small = dict(SMALL, over_arch_layer_sizes=[256, 128, 1])
    params = _weights(ref, small, 4)
    rng = np.random.RandomState(5)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, (fc.total_rows, 8))
                             .astype(np.float32))
    b = 8192
    dense = np.log1p(rng.exponential(8.0, (b, 3))).astype(np.float32)
    ids = rng.randint(0, 1000, size=(b, 11)).astype(np.int32)
    out, taken = {}, None
    for device in ("cpu", dev):
        model = DLRMDCNv2Model(fc, dense_arch=(16, 8), cross_layers=2,
                               cross_rank=4, over_arch=(256, 128),
                               device=device)
        taken = [mk.wgmma_plan(b, layer.in_features, layer.out_features,
                               True)
                 for tower in (model.dense_arch, model.over_arch)
                 for layer in tower.children()]
        scorer = build_scorer(model, fc, EmbeddingTable(fc.total_rows, 8,
                                                        device),
                              device=device)
        state = ServingState({k: p.to(device) for k, p in params.items()},
                             table.to(device))
        before = _wgmma_launches()
        out[str(device)] = scorer(state, dense, ids).cpu()
        assert _wgmma_launches() - before == (
            0 if device == "cpu" else sum(taken))
    assert taken == [False, False, True, True]
    want = out["cpu"]
    assert float((out[str(dev)] - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_xdeepfm_tower_takes_what_the_plan_decides(dev):
    """The port's xDeepFM at its default widths: the tower's 429-wide
    rows stay on nn.Linear, its 256 -> 128 layer is one wgmma launch at
    B = 8,192 and none at B = 1,000; training (a gradient recorded)
    launches none."""
    from rec_now_tpu_torch.models import XDeepFMModel
    model = XDeepFMModel(FeatureConfig(), device=dev)
    gen = torch.Generator().manual_seed(8)
    for b, want in ((8192, 1), (1000, 0)):
        dense = torch.randn(b, 13, generator=gen).to(dev)
        emb = (torch.randn(b, 26, 16, generator=gen) * 0.1).to(dev)
        before = _wgmma_launches()
        with torch.inference_mode():
            fast = model(dense, emb)
        assert _wgmma_launches() - before == want
        slow = model(dense, emb)
        assert _wgmma_launches() - before == want and slow.requires_grad
        assert float((fast - slow.detach()).abs().max()) <= 1e-5 * float(
            slow.detach().abs().max())


def _cross_f64(x, x0, v, w, b):
    y = x0.double() * (x.double() @ v.double() @ w.double()
                       + (0 if b is None else b.double())) + x.double()
    return y


def _within(got, want, tol=2e-6):
    """got within tol of max|want| where want is a number, NaN where it
    is NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    err = float((got.double() - want)[~nan].abs().max())
    assert err <= tol * float(want[~nan].abs().max())


# (b, d, r): DLRM-DCNv2's cross (3,456 wide, rank 512) at B = 300, off
# the 128-row tile, and 512, the kernel forced (below cross_plan's least
# b * min(d, r)); a width off the 32-float k-block with a rank off every
# pass width (product 1's passes of 64, product 2's of 128); a width
# below one pass; one row
CROSS_SHAPES = [(300, 3456, 512), (512, 3456, 512), (257, 420, 132),
                (77, 36, 20), (1, 36, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,r", CROSS_SHAPES)
def test_cross_wg_matches_float64(dev, b, d, r):
    """One cross layer on B8's wgmma kernel, x0 * ((x V) W + b) + x with V
    and W in their (in, out) storage: 2e-6 of the largest output from
    float64, as layer 0 (x is x0) and a later layer, with a nonzero bias
    and without; each call two launches and one ``cross.wgmma``; a repeat
    bit-equal, and written over x (``out=x``) the same bits."""
    gen = torch.Generator().manual_seed(b + d + r)
    x0 = torch.randn(b, d, generator=gen).to(dev)
    x = torch.randn(b, d, generator=gen).to(dev)
    v = (torch.randn(d, r, generator=gen) / d ** 0.5).to(dev)
    w = (torch.randn(r, d, generator=gen) / r ** 0.5).to(dev)
    bias = torch.randn(d, generator=gen).to(dev)
    profiling.enable()
    try:
        for xl in (x0, x):
            for bb in (bias, None):
                launches, layers = mk.cross_wg.launches, _counter(
                    "cross.wgmma")
                got = mk._cross_wg(xl, x0, v, w, bb)
                assert mk.cross_wg.launches == launches + 2
                assert _counter("cross.wgmma") == layers + 1
                _within(got, _cross_f64(xl, x0, v, w, bb))
        assert torch.equal(got, mk._cross_wg(x, x0, v, w, None))
        over = x.clone()
        assert mk._cross_wg(over, x0, v, w, None, over) is over
        assert torch.equal(over, got)
    finally:
        profiling.disable()


@pytest.mark.cuda
def test_cross_wg_carries_a_nan_in_x0(dev):
    """A NaN in x0 at layer 0 (x is x0) makes its row NaN, as through
    x @ V, addmm and addcmul; every other row stays within 2e-6."""
    gen = torch.Generator().manual_seed(13)
    b, d, r = 200, 420, 132
    x0 = torch.randn(b, d, generator=gen)
    x0[5, 7] = float("nan")
    x0 = x0.to(dev)
    v = (torch.randn(d, r, generator=gen) / d ** 0.5).to(dev)
    w = (torch.randn(r, d, generator=gen) / r ** 0.5).to(dev)
    bias = torch.randn(d, generator=gen).to(dev)
    got = mk._cross_wg(x0, x0, v, w, bias)
    want = _cross_f64(x0, x0, v, w, bias)
    assert torch.isnan(want[5]).all() and not torch.isnan(want[6:]).any()
    _within(got, want)
    torch_ops = torch.addcmul(x0, x0, torch.addmm(bias, x0 @ v, w))
    assert torch.equal(torch.isnan(got), torch.isnan(torch_ops))


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,r", [(257, 420, 132), (300, 3456, 512)])
def test_cross_layer_on_the_card_is_its_formula(monkeypatch, dev, b, d, r):
    """cross_wg refuses this batch (below cross_plan's least b * min(d,
    r)); with that least set to 0, LowRankCrossLayer's three layers with
    no gradient recorded run on the kernel: 2e-6 of the largest output
    from the float64 formula, two launches and one ``cross.wgmma`` a
    layer, no ``cross.torch``; with a gradient recorded the torch ops, one
    ``cross.torch`` a layer and no launch, within 1e-5."""
    gen = torch.Generator().manual_seed(17)
    layer = LowRankCrossLayer(d, r, 3, gen, device=dev)
    with torch.no_grad():
        layer.biases.copy_(torch.rand(3, d, generator=gen) * 2 - 1)
    x0 = torch.randn(b, d, generator=gen).to(dev)
    assert mk.cross_wg(x0, x0, layer.v_kernels[0], layer.w_kernels[0],
                       layer.biases[0]) is None
    monkeypatch.setattr(mk, "CROSS_MIN_OUTPUTS", 0)
    profiling.enable()
    try:
        counts = (mk.cross_wg.launches, _counter("cross.wgmma"),
                  _counter("cross.torch"))
        with torch.inference_mode():
            fast = layer(x0)
        assert (mk.cross_wg.launches, _counter("cross.wgmma"),
                _counter("cross.torch")) == (counts[0] + 6, counts[1] + 3,
                                             counts[2])
        slow = layer(x0)
        assert slow.requires_grad
        assert (mk.cross_wg.launches, _counter("cross.wgmma"),
                _counter("cross.torch")) == (counts[0] + 6, counts[1] + 3,
                                             counts[2] + 3)
    finally:
        profiling.disable()
    v, w, bias = (t.detach().double() for t in
                  (layer.v_kernels, layer.w_kernels, layer.biases))
    want = x0.double()
    for i in range(3):
        want = x0.double() * (want @ v[i] @ w[i] + bias[i]) + want
    _within(fast, want)
    _within(slow.detach(), fast, 1e-5)
