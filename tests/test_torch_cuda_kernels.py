"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (marked ``cuda``; they skip
elsewhere).  Run on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda``.
Shapes are the small odd ones of the JAX kernel tests plus edge cases
(one field, one channel, K past one 64-channel chunk, ragged M, B and
V, more rows than one weight-gradient slice; for the CIN layer's
backward also prev = x0, F * H % 4 != 0, H past one 64-wide pass, M = 0
and two calls equal bit for bit) and, for the multi-expert
dense and the listwise loss, config 4's shapes (the four banks at
B = 1,000 and 8,192) and degenerate batches, and each dispatch edge of
the multi-expert dense (N * U = 16 and 17 on a shared input, a small
per-expert bank, W too deep for the gate kernel, x off the 16-byte grid);
for lazy Adam (B10) ragged V,
every D it takes and t = 1 and 1,000; for the pair counts (B7a/b/c) and
the general pair loss (B3) graded labels, two groups, a 0/1 mask and the
wrong-order filter at B = 1, 8,191 and 8,192; for the row gather (B11)
and the row scatter-add (B12) int32 and int64 ids, ragged and empty N,
ids out of range, D = 5, a misaligned table or vals (the scalar loops),
D = 128 (float4 atomics) and the full 2.6M x 16 table with a B = 8,192
batch's count of ids; the windowed training loop (packed windows moved
on a side stream) against put + train_step; and the wire's C++ window
pack against its numpy pack (byte-equal).  Tolerance: f32 with a
different summation order (the multi-expert dense's tile in split TF32,
as close as f32), 1e-5 relative to the largest output (1e-4 for
gradients through the whole
model and for the windowed loop's losses); B11 exact; B12 1e-6 of each
element's summed |terms| (atomics add in no fixed order).
"""
import numpy as np
import pytest
import torch

from rec_now_tpu_torch.losses.pairwise import pairwise_loss
from rec_now_tpu_torch.ops import cin_kernel as ck
from rec_now_tpu_torch.ops import listwise_kernel as lk
from rec_now_tpu_torch.ops import multi_dense_kernel as mk
from rec_now_tpu_torch.ops import pairwise_kernel as pk
from rec_now_tpu_torch.ops import table_update_kernel as tk

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(gen, dev, *shape):
    return torch.randn(shape, generator=gen).to(dev)


def _close(got, want):
    assert got.shape == want.shape
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("m,f,h,k", [(32, 5, 6, 7), (15, 4, 4, 4),
                                     (1, 1, 1, 1), (300, 26, 26, 64),
                                     (129, 3, 70, 130)])
def test_cin_flat_matches_plain(dev, m, f, h, k):
    gen = torch.Generator().manual_seed(m + k)
    x0, prev = _rand(gen, dev, m, f), _rand(gen, dev, m, h)
    w = _rand(gen, dev, k, f, h)
    before = ck.cin_flat.launches
    _close(ck.cin_flat(x0, prev, w), ck.cin_flat_plain(x0, prev, w))
    assert ck.cin_flat.launches == before + 1


@pytest.mark.parametrize("hidden", [(5,), (5, 4), (5, 4, 6), (1, 65)])
@pytest.mark.parametrize("output_input", [True, False])
@pytest.mark.parametrize("m", [15, 257])
def test_cin_stack_sum_matches_plain(dev, hidden, output_input, m):
    gen = torch.Generator().manual_seed(m)
    f = 4
    x0 = _rand(gen, dev, m, f)
    ws = [_rand(gen, dev, k, f, h) * 0.3
          for k, h in zip(hidden, (f,) + hidden[:-1])]
    before = ck.cin_stack_sum.launches
    _close(ck.cin_stack_sum(x0, ws, output_input),
           ck.cin_stack_sum_plain(x0, ws, output_input))
    assert ck.cin_stack_sum.launches == before + 1


def test_wrappers_reject_bad_inputs(dev):
    x0 = torch.zeros(8, 4, device=dev)
    with pytest.raises(TypeError):
        ck.cin_flat(x0.double(), x0.double(),
                    torch.zeros(2, 4, 4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        ck.cin_flat(x0, torch.zeros(8, 3, device=dev),
                    torch.zeros(2, 4, 4, device=dev))
    with pytest.raises(ValueError):
        ck.cin_stack_sum(x0.t(), [torch.zeros(2, 8, 8, device=dev)])
    with pytest.raises(ValueError):
        ck.cin_stack_sum(x0, [])


def _close_rel(got, want, rel=1e-5):
    """Within ``rel`` of the largest |want| (f32, another summation
    order) -- the scale of each output on its own."""
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())


# (m, f, h, k, prev is x0): small odd shapes; config 3's layers (H = 26
# at an M off the 128-row tile, and prev = x0 as in layer 1); F * H % 4
# != 0 (4-byte weight copies); K = 1; K = 130 past two 64-channel
# chunks, with H = 70 past one 64-wide pass
@pytest.mark.parametrize("m,f,h,k,prev_is_x0", [
    (32, 5, 6, 7, False), (15, 4, 4, 4, False), (1, 1, 1, 1, False),
    (300, 26, 26, 64, False), (129, 3, 70, 130, False),
    (2100, 26, 64, 64, False), (2100, 26, 26, 64, False),
    (300, 5, 7, 9, False), (50, 6, 8, 1, False), (300, 26, 64, 130, False),
    (15, 4, 4, 4, True), (300, 26, 26, 64, True), (2100, 26, 26, 64, True)])
def test_cin_flat_bwd_matches_plain(dev, m, f, h, k, prev_is_x0):
    gen = torch.Generator().manual_seed(m + 3 * k)
    x0, prev = _rand(gen, dev, m, f), _rand(gen, dev, m, h)
    prev = x0 if prev_is_x0 else prev
    w, g = _rand(gen, dev, k, f, h), _rand(gen, dev, m, k)
    before = ck.cin_flat_bwd.launches
    got = ck.cin_flat_bwd(x0, prev, w, g)
    assert ck.cin_flat_bwd.launches == before + 1
    for a, b in zip(got, ck.cin_flat_bwd_plain(x0, prev, w, g)):
        _close_rel(a, b)


def test_cin_flat_bwd_empty_and_repeatable(dev):
    """M = 0 gives empty input gradients and a zero dW; two calls on the
    same inputs give the same bits (fixed summation order, no atomics)."""
    x0, prev = torch.zeros(0, 5, device=dev), torch.zeros(0, 7, device=dev)
    w, g = torch.ones(3, 5, 7, device=dev), torch.zeros(0, 3, device=dev)
    dx0, dprev, dw = ck.cin_flat_bwd(x0, prev, w, g)
    assert dx0.shape == (0, 5) and dprev.shape == (0, 7)
    assert torch.equal(dw, torch.zeros(3, 5, 7, device=dev))
    gen = torch.Generator().manual_seed(5)
    x0, prev = _rand(gen, dev, 2100, 26), _rand(gen, dev, 2100, 64)
    w, g = _rand(gen, dev, 64, 26, 64), _rand(gen, dev, 2100, 64)
    first = ck.cin_flat_bwd(x0, prev, w, g)
    again = ck.cin_flat_bwd(x0, prev, w, g)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hidden", [(5,), (5, 4), (5, 4, 6), (1, 65)])
@pytest.mark.parametrize("output_input", [True, False])
@pytest.mark.parametrize("m", [15, 2100])
def test_cin_stack_sum_bwd_matches_plain(dev, hidden, output_input, m):
    gen = torch.Generator().manual_seed(m + len(hidden))
    f = 4
    x0, g = _rand(gen, dev, m, f), _rand(gen, dev, m)
    ws = [_rand(gen, dev, k, f, h) * 0.3
          for k, h in zip(hidden, (f,) + hidden[:-1])]
    before = ck.cin_stack_sum_bwd.launches
    dx0, dws = ck.cin_stack_sum_bwd(x0, ws, g, output_input)
    assert ck.cin_stack_sum_bwd.launches == before + 1
    want_dx0, want_dws = ck.cin_stack_sum_bwd_plain(x0, ws, g, output_input)
    _close_rel(dx0, want_dx0)
    for a, b in zip(dws, want_dws):
        _close_rel(a, b)


@pytest.mark.parametrize("sum_channel", [True, False])
def test_cin_grads_through_the_model_match_the_cpu(dev, sum_channel):
    """The repair: on the card the CIN is differentiable (its weights and
    the embeddings get the CIN's gradient), as on the CPU."""
    from rec_now_tpu_torch.models import FeatureConfig, XDeepFMModel
    fc = FeatureConfig(rows_per_field=50, embedding_dim=8)
    gen = torch.Generator().manual_seed(5)
    emb = torch.randn(64, fc.num_sparse, 8, generator=gen)
    dense = torch.randn(64, fc.num_dense, generator=gen)
    grads = {}
    for d in ("cpu", dev):
        model = XDeepFMModel(fc, (8, 6), sum_channel, (16,), device=d, seed=1)
        e = emb.to(d).requires_grad_()
        out = model(dense.to(d), e)
        ws = model.cin.weights()
        grads[str(d)] = [t.cpu() for t in torch.autograd.grad(
            (out * torch.linspace(-1, 1, 64, device=d)).sum(), [e] + ws)]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        assert float(want.abs().max()) > 0
        _close_rel(got, want, 1e-4)


@pytest.mark.parametrize("b,power", [(1, -0.5), (37, 0.0), (1000, -0.5),
                                     (4096, -0.5)])
def test_pair_loss_matches_plain(dev, b, power):
    gen = torch.Generator().manual_seed(b)
    x = _rand(gen, dev, b)
    lab = (torch.rand(b, generator=gen) > 0.6).float().to(dev)
    grp = torch.randint(0, max(1, b // 7), (b,), generator=gen).to(dev)
    before = pk.pair_loss_sum.launches
    loss, cnt, dx = pk.pair_loss_fused(x, lab, grp, 0.8, power)
    assert pk.pair_loss_sum.launches == before + 1
    want = pk.pair_loss_fused_plain(x, lab, grp, 0.8, power)
    assert float(cnt) == float(want[1])
    _close_rel(loss, want[0])
    _close_rel(dx, want[2])
    xg = x.clone().requires_grad_()
    loss2, _ = pk.pair_loss_sum(xg, lab, grp, 0.8, power)
    (dxg,) = torch.autograd.grad(loss2 * 3.0, xg)
    _close_rel(dxg, 3.0 * want[2])


def test_pair_loss_without_pairs_is_zero(dev):
    x = torch.randn(64, device=dev)
    loss, cnt, dx = pk.pair_loss_fused(x, torch.ones(64, device=dev),
                                       torch.zeros(64, device=dev,
                                                   dtype=torch.int32),
                                       1.0, -0.5)
    assert float(loss) == 0.0 and float(cnt) == 0.0
    assert torch.isfinite(dx).all() and not dx.any()


@pytest.mark.parametrize("v,d", [(1, 4), (1000, 16), (12345, 16), (777, 8),
                                 (300, 128)])
def test_adagrad_dense_pass_matches_plain(dev, v, d):
    gen = torch.Generator().manual_seed(v + d)
    table = _rand(gen, dev, v, d)
    acc = _rand(gen, dev, v).abs() * 0.1
    g = _rand(gen, dev, v, d) * (torch.arange(v, device=dev) % 3 == 0
                                 )[:, None]
    t2, a2 = table.clone(), acc.clone()
    before = tk.adagrad_dense_pass.launches
    tk.adagrad_dense_pass(table, acc, g, 0.05)
    assert tk.adagrad_dense_pass.launches == before + 1
    tk.adagrad_dense_pass_plain(t2, a2, g, 0.05)
    torch.testing.assert_close(acc, a2, rtol=1e-6, atol=0)
    torch.testing.assert_close(table, t2, rtol=1e-6, atol=1e-7)
    untouched = torch.arange(v, device=dev) % 3 != 0
    assert torch.equal(table[untouched], t2[untouched])


def test_new_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        tk.adagrad_dense_pass(torch.zeros(8, 12, device=dev),
                              torch.zeros(8, device=dev),
                              torch.zeros(8, 12, device=dev), 0.1)
    with pytest.raises(ValueError):
        pk.pair_loss_fused(torch.zeros(8, device=dev),
                           torch.zeros(7, device=dev),
                           torch.zeros(8, device=dev), 1.0, 0.0)
    with pytest.raises(ValueError):
        ck.cin_flat_bwd(torch.zeros(8, 4, device=dev),
                        torch.zeros(8, 3, device=dev),
                        torch.zeros(2, 4, 3, device=dev),
                        torch.zeros(8, 5, device=dev))


# (N_in, N, B, D, U): config 4's four banks, then ragged ones (B = 1, odd
# D, U between the tile widths), then the kernel's dispatch edges: a shared
# input with N * U = 16 (the gate kernel) and 17 (the tensor-core tile), a
# per-expert input with N * U = 8 (the tile), N * U = 16 with D too deep
# for the gate kernel's shared memory (the tile), D % 4 == 0 with U % 4 == 0
# (16-byte copies) on a per-expert input
MD_SHAPES = [(1, 4, 1000, 429, 128), (4, 4, 1000, 128, 64),
             (1, 2, 8192, 429, 4), (1, 2, 1000, 128, 64),
             (1, 3, 1, 13, 5), (2, 2, 77, 31, 17), (1, 1, 300, 429, 200),
             (1, 4, 1000, 45, 4), (1, 1, 300, 77, 17), (2, 2, 500, 429, 4),
             (1, 4, 300, 5000, 4), (3, 3, 257, 64, 200)]


@pytest.mark.parametrize("nx,n,b,d,u", MD_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_multi_dense_matches_plain(dev, nx, n, b, d, u, relu):
    gen = torch.Generator().manual_seed(b + d + u)
    x = _rand(gen, dev, nx, b, d)
    w = _rand(gen, dev, n, d, u) / d ** 0.5
    bias = _rand(gen, dev, n, 1, u)
    act = "relu" if relu else None
    for bb in (bias, None):
        before = mk.multi_dense_fused.launches
        got = mk.multi_dense_fused(x, w, bb, relu)
        assert mk.multi_dense_fused.launches == before + 1
        _close_rel(got, mk.multi_dense_xla(x, w, bb, act))
    # x off the 16-byte grid: the tile copies it 4 bytes a thread
    off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    off.copy_(x)
    _close_rel(mk.multi_dense_fused(off, w, bias, relu),
               mk.multi_dense_xla(x, w, bias, act))


def test_multi_dense_grads_match_the_cpu(dev):
    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn(1, 70, 45, generator=gen), torch.randn(3, 45, 9,
                                                              generator=gen)
    bias, g = torch.randn(3, 1, 9, generator=gen), torch.randn(
        3, 70, 9, generator=gen)
    grads = {}
    for d in ("cpu", dev):
        leaves = [t.to(d).requires_grad_() for t in (x, w, bias)]
        out = mk.multi_dense(*leaves, True)
        grads[str(d)] = [t.cpu() for t in torch.autograd.grad(
            out, leaves, g.to(d))]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        _close_rel(got, want, 1e-4)


def _lw_batch(gen, b, kind):
    if kind == "none_valid":
        lab = torch.ones(b)
        grp = torch.randint(0, 5, (b,), generator=gen)
    elif kind == "one_group":
        lab = (torch.rand(b, generator=gen) > 0.5).float()
        grp = torch.zeros(b, dtype=torch.int64)
    elif kind == "singletons":
        lab = (torch.rand(b, generator=gen) > 0.5).float()
        grp = torch.arange(b)
    else:
        lab = (torch.rand(b, generator=gen) > 0.6).float()
        grp = torch.randint(0, max(1, b // 7), (b,), generator=gen)
    return torch.randn(b, generator=gen) * 2, lab, grp


@pytest.mark.parametrize("b,kind", [(1, "mixed"), (37, "mixed"),
                                    (1000, "mixed"), (8192, "mixed"),
                                    (300, "none_valid"),
                                    (2100, "one_group"),
                                    (513, "singletons")])
def test_listwise_matches_plain(dev, b, kind):
    gen = torch.Generator().manual_seed(b)
    x, lab, grp = (t.to(dev) for t in _lw_batch(gen, b, kind))
    before = lk.listwise_loss_sum.launches
    loss, cnt, dx = lk.listwise_loss_fused(x, lab, grp)
    assert lk.listwise_loss_sum.launches == before + 1
    want = lk.listwise_loss_fused_plain(x, lab, grp)
    assert float(cnt) == float(want[1])
    assert torch.isfinite(dx).all()
    if float(want[1]) == 0:
        assert float(loss) == 0.0 and not dx.any()
    else:
        _close_rel(loss, want[0])
        _close_rel(dx, want[2])
    xg = x.clone().requires_grad_()
    loss2, cnt2 = lk.listwise_loss_sum(xg, lab, grp)
    assert not cnt2.requires_grad
    (dxg,) = torch.autograd.grad(loss2 * 3.0, xg)
    torch.testing.assert_close(dxg, 3.0 * dx, rtol=0, atol=0)


def test_multitask_grads_through_the_model_match_the_cpu(dev):
    """B8's forward and its plain backward inside the model: on the card
    as on the CPU, for every parameter and the embeddings."""
    from rec_now_tpu_torch.models import FeatureConfig, MultiTaskModel
    fc = FeatureConfig(rows_per_field=50, embedding_dim=8)
    gen = torch.Generator().manual_seed(6)
    emb = torch.randn(96, fc.num_sparse, 8, generator=gen)
    dense = torch.randn(96, fc.num_dense, generator=gen)
    dom = torch.randint(0, 4, (96,), generator=gen)
    grads = {}
    for d in ("cpu", dev):
        model = MultiTaskModel(fc, mmoe_dims=(32, 16), ple_dims=(16,),
                               tower_dim=8, device=d, seed=2)
        e = emb.to(d).requires_grad_()
        out = model(dense.to(d), e, dom.to(d))
        params = list(model.parameters())
        grads[str(d)] = [t.cpu() for t in torch.autograd.grad(
            (out * torch.linspace(-1, 2, 96, device=d)).sum(), [e] + params)]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        _close_rel(got, want, 1e-4)


def test_slice3_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(1, 8, 5, device=dev)
    with pytest.raises(ValueError):      # D mismatch
        mk.multi_dense_fused(x, torch.zeros(2, 4, 3, device=dev), None, True)
    with pytest.raises(ValueError):      # 3 inputs for 2 experts
        mk.multi_dense_fused(torch.zeros(3, 8, 5, device=dev),
                             torch.zeros(2, 5, 3, device=dev), None, True)
    with pytest.raises(ValueError):      # bias not (N, 1, U)
        mk.multi_dense_fused(x, torch.zeros(2, 5, 3, device=dev),
                             torch.zeros(2, 3, device=dev), False)
    with pytest.raises(TypeError):
        mk.multi_dense_fused(x.double(), torch.zeros(
            2, 5, 3, device=dev, dtype=torch.float64), None, False)
    with pytest.raises(ValueError):
        lk.listwise_loss_fused(torch.zeros(8, device=dev),
                               torch.zeros(7, device=dev),
                               torch.zeros(8, device=dev))


@pytest.mark.parametrize("v,d", [(1, 4), (777, 8), (12345, 16), (1000, 32),
                                 (301, 64), (300, 128)])
@pytest.mark.parametrize("t", [1, 1000])
def test_adam_dense_pass_matches_plain(dev, v, d, t):
    gen = torch.Generator().manual_seed(v + d + t)
    table = _rand(gen, dev, v, d)
    m = _rand(gen, dev, v, d) * 1e-3
    vv = _rand(gen, dev, v, d).square() * 1e-6
    touched = (torch.arange(v) % 3 != 1).to(dev)
    g = _rand(gen, dev, v, d) * touched[:, None]
    g[::6] = 0.0                 # touched rows with a zero gradient
    count = torch.tensor(t, dtype=torch.int32, device=dev)
    want = [x.clone() for x in (table, m, vv)]
    before = tk.adam_dense_pass.launches
    tk.adam_dense_pass(table, m, vv, g, touched, count, 1e-3)
    assert tk.adam_dense_pass.launches == before + 1
    tk.adam_dense_pass_plain(*want, g, touched, count, 1e-3, 0.9, 0.999,
                             1e-7)
    for got, ref in zip((table, m, vv), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-7)
        assert torch.equal(got[~touched], ref[~touched])
    assert int(count) == t


def _general_batch(b, seed, dev):
    """Graded labels {0, 1, 2}, two group conditions, a 0/1 mask."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, generator=gen) * 2
    lab = torch.randint(0, 3, (b,), generator=gen).float()
    g1 = torch.randint(0, max(1, b // 6), (b,), generator=gen)
    g2 = torch.randint(0, 2, (b,), generator=gen)
    mask = (torch.rand(b, generator=gen) > 0.2).float()
    return [t.to(dev) for t in (x, lab, g1, g2, mask)]


@pytest.mark.parametrize("b", [1, 37, 8191, 8192])
@pytest.mark.parametrize("wrong_order", [False, True])
def test_pair_counts_and_general_loss_match_plain(dev, b, wrong_order):
    x, lab, g1, g2, mask = _general_batch(b, b, dev)
    groups = [g1, g2]
    counts = pk.pair_row_counts(x, lab, groups, mask, wrong_order)
    torch.testing.assert_close(
        counts, pk.pair_row_counts_plain(x, lab, groups, mask, wrong_order),
        rtol=0, atol=0)
    gpc = pk.same_group_matvec(g1, counts)
    torch.testing.assert_close(gpc, pk.same_group_matvec_plain(g1, counts),
                               rtol=0, atol=0)
    w = torch.where(gpc > 0, gpc.clamp_min(1e-30) ** -0.5,
                    torch.zeros_like(gpc))
    before = pk.pair_loss_sum.launches
    got = pk.pair_loss_fused(x, lab, groups, 0.8, row_weights=w,
                             sample_mask=mask, wrong_order=wrong_order)
    assert pk.pair_loss_sum.launches == before + 1
    want = pk.pair_loss_fused_plain(x, lab, groups, 0.8, row_weights=w,
                                    sample_mask=mask,
                                    wrong_order=wrong_order)
    assert float(got[1]) == float(want[1]) == float(counts.sum())
    if float(want[1]):
        _close_rel(got[0], want[0])
        _close_rel(got[2], want[2])
    else:
        assert float(got[0]) == 0.0 and not got[2].any()


@pytest.mark.parametrize("b", [1, 8191, 8192])
def test_binary_counts_and_in_kernel_weight_match_plain(dev, b):
    x, lab, g1, _, mask = _general_batch(b, b + 1, dev)
    clicks = (lab > 1).float()
    before = pk.group_pair_counts_binary.launches
    got = pk.group_pair_counts_binary(g1, clicks, mask)
    assert pk.group_pair_counts_binary.launches == before + 1
    want = pk.group_pair_counts_binary_plain(g1, clicks, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the same counts by the general route, B7a then B7b
    via = pk.same_group_matvec(g1, pk.pair_row_counts(x, clicks, g1, mask))
    torch.testing.assert_close(got, via, rtol=0, atol=0)
    loss, cnt, dx = pk.pair_loss_fused(x, clicks, g1, 1.0, -0.5,
                                       sample_mask=mask)
    ref = pk.pair_loss_fused_plain(x, clicks, g1, 1.0, -0.5,
                                   sample_mask=mask)
    assert float(cnt) == float(ref[1])
    if float(ref[1]):
        _close_rel(loss, ref[0])
        _close_rel(dx, ref[2])


@pytest.mark.parametrize("case", ["graded", "wrong_order", "binary"])
def test_pairwise_loss_on_the_card_matches_the_cpu(dev, case):
    """The public loss: the card's dispatch (B7a -> B7b -> B3, or B3 with
    the in-kernel weight) against the CPU's (B, B) math under autograd."""
    x, lab, g1, g2, mask = _general_batch(2048, 7, dev)
    kw = dict(click_occurance_power=-0.5, mask=mask, return_num_pair=True)
    if case == "binary":
        lab, groups = (lab > 1).float(), g1
        kw["binary_labels"] = True
    else:
        groups = [g1, g2]
        kw["only_use_wrong_order_pair"] = case == "wrong_order"
    out = {}
    before = (pk.pair_row_counts.launches, pk.same_group_matvec.launches,
              pk.pair_loss_sum.launches)
    for d in (dev, "cpu"):
        xd = x.to(d).requires_grad_()
        gd = ([g.to(d) for g in groups] if isinstance(groups, list)
              else groups.to(d))
        loss, cnt = pairwise_loss(xd, lab.to(d), gd, **{
            k: (v.to(d) if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items()})
        (dx,) = torch.autograd.grad(loss, xd)
        out[str(d)] = (loss.detach().cpu(), cnt.cpu(), dx.cpu())
    b7 = 0 if case == "binary" else 1
    assert (pk.pair_row_counts.launches, pk.same_group_matvec.launches,
            pk.pair_loss_sum.launches) == (before[0] + b7, before[1] + b7,
                                           before[2] + 1)
    got, want = out[str(dev)], out["cpu"]
    assert float(got[1]) == float(want[1]) > 0
    _close_rel(got[0], want[0], 1e-5)
    _close_rel(got[2], want[2], 1e-4)


def test_slice4_wrappers_reject_bad_inputs(dev):
    z = torch.zeros(8, 8, device=dev)
    t = torch.zeros(8, dtype=torch.bool, device=dev)
    c = torch.ones((), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):      # D = 12
        tk.adam_dense_pass(*(torch.zeros(8, 12, device=dev),) * 4, t, c,
                           1e-3)
    with pytest.raises(TypeError):       # a float touched flag
        tk.adam_dense_pass(z, z.clone(), z.clone(), z.clone(), t.float(), c,
                           1e-3)
    with pytest.raises(ValueError):      # five group conditions
        pk.pair_row_counts(z[0], z[0], [t.int()] * 5)
    with pytest.raises(ValueError):      # occurrence weight with two groups
        pk.pair_loss_fused(z[0], z[0], [t.int()] * 2, 1.0, -0.5)


# -- B11 (row gather) and B12 (row scatter-add) --------------------------

@pytest.mark.parametrize("v,d,n", [(1, 4, 7), (1000, 16, 1500),
                                   (2_600_000, 16, 212_992), (777, 5, 333),
                                   (300, 128, 4097), (50, 16, 0)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_rows_matches_plain_exactly(dev, v, d, n, dtype):
    from rec_now_tpu_torch.ops import gather_kernel as gk
    gen = torch.Generator().manual_seed(v + d + n)
    table = _rand(gen, dev, v, d)
    ids = torch.randint(-3, v + 3, (n,), generator=gen).to(dtype).to(dev)
    before = gk.gather_rows.launches
    got = gk.gather_rows(table, ids)
    assert torch.equal(got, gk.gather_rows_plain(table, ids))
    assert gk.gather_rows.launches == before + (1 if n else 0)
    # a view that starts off the 16-byte grid takes the scalar loop
    off = _rand(gen, dev, v * d + 1)[1:].view(v, d)
    assert torch.equal(gk.gather_rows(off, ids),
                       gk.gather_rows_plain(off, ids))
    shaped = ids[:n - n % 4].reshape(-1, 2, 2)
    assert gk.gather_rows(table, shaped).shape == tuple(shaped.shape) + (d,)


@pytest.mark.parametrize("v,d,n", [(1, 4, 7), (1000, 16, 1500),
                                   (2_600_000, 16, 212_992), (777, 5, 333),
                                   (50, 16, 0), (300, 128, 4097)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_scatter_add_rows_matches_plain(dev, v, d, n, dtype):
    from rec_now_tpu_torch.ops import expand_kernel as ek
    gen = torch.Generator().manual_seed(v + d + n + 1)
    ids = torch.randint(-3, v + 3, (n,), generator=gen)
    ids[::3] = v // 2                          # a hot row
    ids[1::5] = v                              # sentinel rows: dropped
    ids, vals = ids.to(dtype).to(dev), _rand(gen, dev, n, d)
    out = _rand(gen, dev, v, d)
    want = out.clone()
    before = ek.scatter_add_rows.launches
    assert ek.scatter_add_rows(out, ids, vals) is out
    assert ek.scatter_add_rows.launches == before + (1 if n else 0)
    ek.scatter_add_rows_plain(want, ids, vals)
    # atomics add in no fixed order: 1e-6 of the summed |vals| per element
    keep = (ids >= 0) & (ids < v)
    scale = torch.zeros_like(out).index_add_(0, ids[keep],
                                             vals[keep].abs())
    tol = 1e-6 * float((scale + want.abs()).max())
    assert float((out - want).abs().max()) <= tol
    # vals off the 16-byte grid: the scalar loop, where D % 4 == 0 takes
    # float4 atomics above
    off = torch.empty(vals.numel() + 1, device=dev)[1:].view(vals.shape)
    off.copy_(vals)
    out2 = want.clone()
    ek.scatter_add_rows(out2, ids, off)
    ek.scatter_add_rows_plain(want, ids, vals)
    assert float((out2 - want).abs().max()) <= tol


def test_gather_scatter_reject_bad_inputs(dev):
    from rec_now_tpu_torch.ops import expand_kernel as ek
    from rec_now_tpu_torch.ops import gather_kernel as gk
    table = torch.zeros(8, 4, device=dev)
    ids = torch.zeros(3, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):       # float ids
        gk.gather_rows(table, ids.float())
    with pytest.raises(ValueError):      # ids on the CPU
        gk.gather_rows(table, ids.cpu())
    with pytest.raises(ValueError):      # an empty table
        gk.gather_rows(table[:0], ids)
    with pytest.raises(ValueError, match="forward only"):
        gk.gather_rows(table.clone().requires_grad_(), ids)
    with pytest.raises(ValueError):      # vals of another width
        ek.scatter_add_rows(table, ids, torch.zeros(3, 5, device=dev))
    with pytest.raises(TypeError):       # f64 vals
        ek.scatter_add_rows(table, ids, torch.zeros(3, 4, device=dev,
                                                    dtype=torch.float64))


def test_windowed_loop_on_the_card_matches_put_and_train_step(dev):
    """The packed window moved on the side stream and decoded on the card
    gives the steps that put + train_step give on the same decoded
    batches (f16 dense: lossless for the synthetic stream's values)."""
    from rec_now_tpu_torch.models import DCNv2Model, FeatureConfig
    from rec_now_tpu_torch.training import (SyntheticCriteo, Trainer,
                                            TrainerConfig)
    fc = FeatureConfig(rows_per_field=1000, embedding_dim=8)
    cfg = TrainerConfig(pairwise_weight=0.5, click_occurance_power=-0.5)
    batches = list(SyntheticCriteo(rows_per_field=1000).batches(512, 6))
    runs = []
    for windowed in (True, False):
        trainer = Trainer(DCNv2Model(fc, deep_dims=(32,), device=dev), fc,
                          cfg, device=dev)
        state = trainer.init(torch.Generator().manual_seed(0))
        losses = []
        if windowed:
            state, m = trainer.train_pipelined(state, iter(batches), 3)
            losses = m["loss"]
        else:
            for b in batches:
                b = b._replace(dense=b.dense.astype(np.float16).astype(
                    np.float32))
                state, m = trainer.train_step(state, *trainer.put(b))
                losses.append(m["loss"])
            losses = torch.stack(losses[3:])
        runs.append((losses, state))
    (lw, sw), (ls, ss) = runs
    torch.testing.assert_close(lw, ls, rtol=1e-4, atol=0)
    torch.testing.assert_close(sw.table.table, ss.table.table, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["u8", "f16"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("rows", [3, 1000, 100_000, 2 ** 32])
def test_native_wire_pack_matches_numpy(dev, mode, shards, rows):
    """The C++ window pack (csrc/wire.cu, what put_packed_window runs on
    the card) gives pack_window's bytes: int32 and int64 ids, groups and
    domains, ids and groups out of range, a constant feature (step 0),
    signed labels, domains that wrap in uint8, raw groups; domain >= 64
    and a non-f32 dense raise."""
    from rec_now_tpu_torch.training import SyntheticCriteo
    from rec_now_tpu_torch.training.wire import WireFormat
    rng = np.random.default_rng(rows + shards)
    wire = WireFormat(26, rows, dense_mode=mode, num_shards=shards)
    base = list(SyntheticCriteo(rows_per_field=min(rows, 1000)).batches(
        512, 3))
    wide = [b._replace(
        dense=(b.dense * 1e3).astype(np.float32),
        sparse_ids=rng.integers(-2 ** 40, 2 ** 40, b.sparse_ids.shape),
        group_ids=rng.integers(-5, 60000, 512),
        labels=rng.integers(-1, 2, 512).astype(np.float32),
        domain_idx=rng.integers(0, 64, 512) + 256) for b in base]
    for b in wide:
        b.dense[:, 0] = 3.5
    for batches in (base, wide):
        for raw in (False, True):
            if raw:
                batches = [b._replace(group_ids=np.abs(b.group_ids))
                           for b in batches]
            want = wire.pack_window(batches, raw_groups=raw)
            got = wire.pack_window_native(batches, raw_groups=raw)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="domain"):
        wire.pack_window_native([base[0]._replace(
            domain_idx=base[0].domain_idx + 64)])
    with pytest.raises(TypeError, match="dense"):
        wire.pack_window_native([base[0]._replace(
            dense=base[0].dense.astype(np.float64))])
