"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (marked ``cuda``; they skip
elsewhere).  Run on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda``.
Shapes are the small odd ones of the JAX kernel tests plus edge cases
(one field, one channel, K past one 64-channel chunk, ragged M, B and
V, more rows than one weight-gradient slice) and, for the multi-expert
dense and the listwise loss, config 4's shapes (the four banks at
B = 1,000 and 8,192) and degenerate batches.  Tolerance: f32 with a
different summation order, 1e-5 relative to the largest output (1e-4
for gradients through the whole model).
"""
import pytest
import torch

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


@pytest.mark.parametrize("m,f,h,k", [(32, 5, 6, 7), (15, 4, 4, 4),
                                     (1, 1, 1, 1), (300, 26, 26, 64),
                                     (129, 3, 70, 130), (2100, 26, 64, 64)])
def test_cin_flat_bwd_matches_plain(dev, m, f, h, k):
    gen = torch.Generator().manual_seed(m + 3 * k)
    x0, prev = _rand(gen, dev, m, f), _rand(gen, dev, m, h)
    w, g = _rand(gen, dev, k, f, h), _rand(gen, dev, m, k)
    before = ck.cin_flat_bwd.launches
    got = ck.cin_flat_bwd(x0, prev, w, g)
    assert ck.cin_flat_bwd.launches == before + 1
    for a, b in zip(got, ck.cin_flat_bwd_plain(x0, prev, w, g)):
        _close_rel(a, b)


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
# D, U between the tile widths)
MD_SHAPES = [(1, 4, 1000, 429, 128), (4, 4, 1000, 128, 64),
             (1, 2, 8192, 429, 4), (1, 2, 1000, 128, 64),
             (1, 3, 1, 13, 5), (2, 2, 77, 31, 17), (1, 1, 300, 429, 200)]


@pytest.mark.parametrize("nx,n,b,d,u", MD_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_multi_dense_matches_plain(dev, nx, n, b, d, u, relu):
    gen = torch.Generator().manual_seed(b + d + u)
    x = _rand(gen, dev, nx, b, d)
    w = _rand(gen, dev, n, d, u) / d ** 0.5
    bias = _rand(gen, dev, n, 1, u)
    for bb in (bias, None):
        before = mk.multi_dense_fused.launches
        got = mk.multi_dense_fused(x, w, bb, relu)
        assert mk.multi_dense_fused.launches == before + 1
        _close_rel(got, mk.multi_dense_xla(x, w, bb, "relu" if relu else None))


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
