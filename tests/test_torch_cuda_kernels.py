"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (marked ``cuda``; they skip
elsewhere).  Run on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda``.
Shapes are the small odd ones of the JAX kernel tests plus edge cases
(one field, one channel, K past one 64-channel chunk, ragged M, B and
V, more rows than one weight-gradient slice; for the CIN layer's
backward also prev = x0, F * H % 4 != 0, H past one 64-wide pass, M = 0
and two calls equal bit for bit; for the CIN layer in split TF32 H = 26,
37 and 64, K = 1 to 130, W or prev off the 16-byte grid, F or H past
one block's tiles, xDeepFM's widths at M = 10,240 and 10,237, its layer
1 on the pairs (prev is x0) against the fields (a copy), K = 256 and
300 (two channel passes), a bit-equal repeat, and the kernel each call
ran, counted; for the
stack's forward config 3's stack on each of its paths (128- and 64-row
blocks, layer by layer), an odd F, one and three layers, a hidden layer
past one 64-channel pass, the widest F + 2 h_max the f32 stack kernel
took, M = 0 and a bit-equal repeat of each; for the
stack's backward one, two and three layers at config 3's widths, M off
the row tile, K_l not a multiple of 8, M = 0 and a bit-equal repeat)
and, for the multi-expert
dense and the listwise loss, config 4's shapes (the four banks at
B = 1,000 and 8,192) and degenerate batches, and each dispatch edge of
the multi-expert dense (N * U = 16 and 17 on a shared input, a small
per-expert bank, W too deep for the gate kernel, x off the 16-byte grid),
and its wgmma path for one nn.Linear weight (``linear_wg``) against
float64 (2e-6 of the largest output) at DLRM-DCNv2's over-arch widths at
B = 1, 300 and 512 (forced) and 8,191, what its plan refuses (390-wide
rows, rows off the grid) left to the caller, expert banks and stored
(1, D, U) weights on the tile as before, and a DNNTower's launches by
grad mode and B;
for the listwise loss also B on both sides of its one-block sort (8,192)
on SyntheticCriteo's zipf groups, ids at the int32 ends, one group and
singletons at 8,192, a {+1, -1} group, each path forced and a bit-equal
repeat of each; for lazy Adam (B10) ragged V, every D it takes, t = 1 and
1,000, no row, every row, rows only in a partial last 512-flag chunk,
zipf-clustered rows, flags off the 16-byte grid and a bit-equal repeat;
for the pair counts (B7a/b/c), the general loss in one call (its
sort and its composition of sweeps, against its plain version and the
parent's B7a -> B7b -> B3 composition, power -0.5 and -1.0), B7b's hash
(integer and f32 vec, ids of 0, the hash's empty key, among them) and
the general pair loss (B3) graded labels, two to four groups, a 0/1 mask
and the wrong-order filter at B = 1 to 8,193, B7a and B7c on each path
(the sort forced only where B <= 8,192), B7c also on graded labels with a
fractional mask (1e-6 of the largest count: both sum in double, in
other orders), and for the pair counts and pair-loss tests main groups of one
group, all singletons, ids across the int32 range and a SyntheticCriteo
zipf batch, B on both sides of the one-block sort (8,192) and a bit-equal
repeat of each; for the row gather (B11)
and the row scatter-add (B12) int32 and int64 ids, ragged and empty N,
ids out of range, D = 5, a misaligned table or vals (the scalar loops),
D = 128 (float4 atomics) and the full 2.6M x 16 table with a B = 8,192
batch's count of ids; the windowed training loop (packed windows moved
on a side stream) against put + train_step; the wire's C++ window
pack against its numpy pack (byte-equal); and the mod-sharded table in a
NCCL group of one against the table without a mesh (every update path,
D = 16 and 272: distinct ids bit for bit, zipf ids with one-signed
gradients within 1e-5 of the largest move).  Tolerance: f32 with a
different summation order (the multi-expert dense's tile and the CIN
layer in split TF32, as close as f32), 1e-5 relative to the largest output (1e-4 for
gradients through the whole
model and for the windowed loop's losses); B11 exact; B12 1e-6 of each
element's summed |terms| (atomics add in no fixed order).
"""
import numpy as np
import pytest
import torch

from rec_now_tpu_torch.core import profiling
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


def _off_grid(t):
    """A copy of ``t`` whose storage starts 4 bytes past the 16-byte grid
    (the kernels' 4-byte copy paths)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# (m, f, h, k, W on the 16-byte grid, prev): small odd shapes; the
# tensor-core layer at config 3's H (26 zero-filled to 32, 64) and a
# ragged one (37), K from one channel to past two 64-channel passes, M off
# the 128-row tile, W also off the grid (4-byte copies); layers whose x0
# and prev tiles do not fit one block (H, F or both past 256: launches
# over (f, h) slices); xDeepFM's layers (F = 39, H = K = 200) at
# M = 10,240 and off every tile, its layer 1 with prev x0 itself (the
# pairs) and a copy of it (the fields), K of 1, 8, 200, 256 (two channel
# passes) and 300 on both
@pytest.mark.parametrize("m,f,h,k,aligned,prev", [
    (32, 5, 6, 7, True, "rand"), (15, 4, 4, 4, True, "rand"),
    (1, 1, 1, 1, True, "rand"), (300, 26, 26, 64, True, "rand"),
    (129, 3, 70, 130, True, "rand")] + [
    (1000, 26, h, k, aligned, "rand") for h in (26, 37, 64)
    for k in (1, 64, 100, 130) for aligned in (True, False)] + [
    (300, 26, 700, 5, True, "rand"), (200, 700, 3, 4, True, "rand"),
    (150, 400, 400, 70, True, "rand"), (150, 400, 402, 9, False, "rand")] + [
    (m, 39, 200, 200, True, "rand") for m in (10240, 10237)] + [
    (m, 39, 39, k, True, prev) for m in (10240, 10237)
    for k in (1, 8, 200, 256, 300) for prev in ("x0", "copy")] + [
    (1000, 39, 200, k, True, "rand") for k in (1, 8, 256, 300)])
def test_cin_flat_matches_plain(dev, m, f, h, k, aligned, prev):
    gen = torch.Generator().manual_seed(m + k)
    x0 = _rand(gen, dev, m, f)
    p = {"rand": lambda: _rand(gen, dev, m, h), "x0": lambda: x0,
         "copy": lambda: x0.clone()}[prev]()
    w = _rand(gen, dev, k, f, h)
    if not aligned:
        w = _off_grid(w)
    before = ck.cin_flat.launches
    got = ck.cin_flat(x0, p, w)
    assert ck.cin_flat.launches == before + 1
    _close(got, ck.cin_flat_plain(x0, p, w))
    assert torch.equal(got, ck.cin_flat(x0, p, w))
    if prev == "x0":                 # the pairs agree with the fields
        _close(got, ck.cin_flat(x0, x0.clone(), w))


def _layer_counts():
    c = profiling.span_report()["counters"]
    return c.get("cin.layer_wgmma", 0), c.get("cin.layer_mma", 0)


def test_cin_layer_counts_its_kernel_paths(dev):
    """xDeepFM's CIN without the channel sum runs each of its three
    layers on the wgmma kernel; a collapsed layer (one field) runs on the
    mma.sync kernel."""
    from rec_now_tpu_torch.layers.cin_layer import CINLayer
    cin = CINLayer(39, [200] * 3, torch.Generator().manual_seed(0),
                   device=dev)
    emb = torch.randn(64, 39, 10, device=dev)
    wg, mma = _layer_counts()
    cin(emb, output_input=False, sum_channel=False)
    assert _layer_counts() == (wg + 3, mma)
    gen = torch.Generator().manual_seed(1)
    x0, prev = _rand(gen, dev, 300, 1), _rand(gen, dev, 300, 64)
    w = _rand(gen, dev, 39, 1, 64)
    got = ck.cin_flat(x0, prev, w)
    assert _layer_counts() == (wg + 3, mma + 1)
    _close(got, ck.cin_flat_plain(x0, prev, w))


def test_cin_flat_empty_and_off_grid_prev(dev):
    """M = 0 launches nothing and gives an empty output; prev off the
    16-byte grid at H % 4 == 0 takes the 4-byte copies."""
    w = torch.ones(3, 5, 8, device=dev)
    out = ck.cin_flat(torch.zeros(0, 5, device=dev),
                      torch.zeros(0, 8, device=dev), w)
    assert out.shape == (0, 3)
    gen = torch.Generator().manual_seed(4)
    x0, prev = _rand(gen, dev, 300, 5), _off_grid(_rand(gen, dev, 300, 8))
    _close_rel(ck.cin_flat(x0, prev, w), ck.cin_flat_plain(x0, prev, w))


# (m, f, hidden, rows a block): small odd stacks at F = 4; config 3's
# stack (F = 26, Ks = (64, 64)) on each path -- 128-row blocks (the
# default), 64-row blocks and layer-by-layer launches (-1); an odd F; one
# layer (the collapse alone), on each path; three layers, K_l not a
# multiple of 8; a hidden layer past one 64-channel pass; the widest F + 2
# h_max the f32 stack kernel took (1,493: tiles too large for one block,
# so layer by layer by default); M = 0
@pytest.mark.parametrize("m,f,hidden,rows", [
    (m, 4, hidden, 0) for m in (15, 257)
    for hidden in ((5,), (5, 4), (5, 4, 6), (1, 65))] + [
    (1000, 26, (64, 64), 0), (1000, 26, (64, 64), 64),
    (1000, 26, (64, 64), -1), (300, 33, (40, 17), 0), (129, 33, (100,), 0),
    (300, 26, (64,), 0), (300, 26, (64,), 64), (300, 26, (64,), -1),
    (257, 26, (12, 37, 9), 0), (257, 26, (12, 37, 9), -1),
    (257, 7, (130, 5), 0), (65, 27, (733, 5), 0), (0, 26, (64, 64), 0)])
@pytest.mark.parametrize("output_input", [True, False])
def test_cin_stack_sum_matches_plain(dev, m, f, hidden, rows, output_input):
    gen = torch.Generator().manual_seed(m + f)
    x0 = _rand(gen, dev, m, f)
    ws = [_rand(gen, dev, k, f, h) * (2.0 / (f * h + k)) ** 0.5
          for k, h in zip(hidden, (f,) + hidden[:-1])]

    def run():
        if rows == ck.STACK_ROWS_AUTO:
            return ck.cin_stack_sum(x0, ws, output_input)
        return ck._stack_fwd_cuda(x0, ws, output_input, rows)

    before = ck.cin_stack_sum.launches
    got = run()
    assert ck.cin_stack_sum.launches == before + (m > 0)
    want = ck.cin_stack_sum_plain(x0, ws, output_input)
    if m == 0:
        assert got.shape == (0,)
        return
    _close(got, want)
    assert torch.equal(got, run())       # a fixed summation order


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


# (m, f, hidden): small odd stacks; the row kernel's epilogue modes at
# config 3's widths -- one layer (no row kernel), two (layer 1: prev is
# x0, dx0 += both input gradients) and three (the middle layer adds g to
# its hidden gradient) -- at M off the 128-row tile, K_l not a multiple
# of 8; a hidden layer too wide for one forward block (700)
@pytest.mark.parametrize("m,f,hidden", [
    (m, 4, hidden) for m in (15, 2100)
    for hidden in ((5,), (5, 4), (5, 4, 6), (1, 65))] + [
    (300, 26, (64,)), (300, 26, (64, 64)), (2100, 26, (64, 64)),
    (1000, 26, (12, 37, 9)), (257, 7, (13, 5, 70)), (129, 26, (100, 37, 50)),
    (257, 26, (700, 3))])
@pytest.mark.parametrize("output_input", [True, False])
def test_cin_stack_sum_bwd_matches_plain(dev, m, f, hidden, output_input):
    gen = torch.Generator().manual_seed(m + f + len(hidden))
    x0, g = _rand(gen, dev, m, f), _rand(gen, dev, m)
    ws = [_rand(gen, dev, k, f, h) * (2.0 / (f * h + k)) ** 0.5
          for k, h in zip(hidden, (f,) + hidden[:-1])]
    before = ck.cin_stack_sum_bwd.launches
    dx0, dws = ck.cin_stack_sum_bwd(x0, ws, g, output_input)
    assert ck.cin_stack_sum_bwd.launches == before + 1
    want_dx0, want_dws = ck.cin_stack_sum_bwd_plain(x0, ws, g, output_input)
    _close_rel(dx0, want_dx0)
    for a, b in zip(dws, want_dws):
        _close_rel(a, b)


def test_cin_stack_sum_bwd_empty_and_repeatable(dev):
    """M = 0 gives an empty dx0 and zero weight gradients; two calls on
    the same inputs give the same bits (every sum in a fixed order)."""
    ws = [torch.ones(6, 4, 4, device=dev), torch.ones(3, 4, 6, device=dev)]
    dx0, dws = ck.cin_stack_sum_bwd(torch.zeros(0, 4, device=dev), ws,
                                    torch.zeros(0, device=dev))
    assert dx0.shape == (0, 4)
    for d, w in zip(dws, ws):
        assert torch.equal(d, torch.zeros_like(w))
    gen = torch.Generator().manual_seed(9)
    x0, g = _rand(gen, dev, 2100, 26), _rand(gen, dev, 2100)
    ws = [_rand(gen, dev, 64, 26, 26) * 0.05, _rand(gen, dev, 64, 26, 64) * 0.05]
    first = ck.cin_stack_sum_bwd(x0, ws, g)
    again = ck.cin_stack_sum_bwd(x0, ws, g)
    for a, b in zip([first[0]] + first[1], [again[0]] + again[1]):
        assert torch.equal(a, b)


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


# ids far apart: negative, past 2^24 and the int32 ends (every pass of the
# radix sort)
_WIDE_IDS = torch.tensor([-2 ** 31, -70000, -7, 0, 3, 2 ** 24 + 1, 2 ** 30,
                          2 ** 31 - 1])


def _groups_of(kind, b, gen):
    """(B,) int32 main groups: random (about B / 7 of them), one group of
    every sample, all singletons, ids across the int32 range, or a
    SyntheticCriteo batch's zipf-skewed users."""
    if kind == "random":
        return torch.randint(0, max(1, b // 7), (b,), generator=gen)
    if kind == "one group":
        return torch.full((b,), 5)
    if kind == "singletons":
        return torch.randperm(b, generator=gen) - b // 2
    if kind == "wide ids":
        return _WIDE_IDS[torch.randint(0, len(_WIDE_IDS), (b,),
                                       generator=gen)]
    from rec_now_tpu_torch.training.data import SyntheticCriteo
    batch = next(SyntheticCriteo(seed=0).batches(b, 1, seed=1))
    return torch.as_tensor(batch.group_ids)


# B on both sides of the one-block sort (8,192: past it the O(B^2) sweep
# runs), each kind of main group; every case repeated bit for bit
@pytest.mark.parametrize("b,power,kind", [
    (1, -0.5, "random"), (37, 0.0, "random"), (1000, -0.5, "random"),
    (4096, -0.5, "random"), (8192, -0.5, "random"), (8193, -0.5, "random"),
    (2048, -0.5, "one group"), (8192, 0.0, "one group"),
    (8193, -0.5, "one group"), (8192, -0.5, "singletons"),
    (1000, -0.5, "wide ids"), (8192, 0.0, "wide ids"), (8192, -0.5, "zipf"),
    (8193, -0.5, "zipf")])
def test_pair_loss_matches_plain(dev, b, power, kind):
    gen = torch.Generator().manual_seed(b)
    x = _rand(gen, dev, b)
    lab = (torch.rand(b, generator=gen) > 0.6).float().to(dev)
    grp = _groups_of(kind, b, gen).to(torch.int32).to(dev)
    before = pk.pair_loss_sum.launches
    loss, cnt, dx = pk.pair_loss_fused(x, lab, grp, 0.8, power)
    assert pk.pair_loss_sum.launches == before + 1
    want = pk.pair_loss_fused_plain(x, lab, grp, 0.8, power)
    assert float(cnt) == float(want[1])
    if float(want[1]):
        _close_rel(loss, want[0])
        _close_rel(dx, want[2])
    else:
        assert float(loss) == 0.0 and not dx.any()
    for a, r in zip((loss, cnt, dx), pk.pair_loss_fused(x, lab, grp, 0.8,
                                                         power)):
        assert torch.equal(a, r)
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


# the widths of D / 4 threads a row (4 to 128), a warp a row on float4s
# (72, and config 5's CAN table at 272 over 100,000 rows) and on floats (45,
# 5, and D = 16 with the tensors off the 16-byte grid); each repeated bit
# for bit
@pytest.mark.parametrize("v,d,off_grid", [
    (1, 4, False), (1000, 16, False), (12345, 16, False), (777, 8, False),
    (300, 128, False), (1001, 45, False), (777, 72, False), (33, 5, False),
    (100_000, 272, False), (1000, 16, True), (513, 272, True)])
def test_adagrad_dense_pass_matches_plain(dev, v, d, off_grid):
    gen = torch.Generator().manual_seed(v + d)
    table = _rand(gen, dev, v, d)
    acc = _rand(gen, dev, v).abs() * 0.1
    g = _rand(gen, dev, v, d) * (torch.arange(v, device=dev) % 3 == 0
                                 )[:, None]
    if off_grid:
        table, g = _off_grid(table), _off_grid(g)
    t2, a2 = table.clone(), acc.clone()
    # the repeat on the same layout (a clone lands on the grid)
    again = [_off_grid(table) if off_grid else table.clone(), acc.clone()]
    before = tk.adagrad_dense_pass.launches
    tk.adagrad_dense_pass(table, acc, g, 0.05)
    assert tk.adagrad_dense_pass.launches == before + 1
    tk.adagrad_dense_pass_plain(t2, a2, g, 0.05)
    torch.testing.assert_close(acc, a2, rtol=1e-6, atol=0)
    torch.testing.assert_close(table, t2, rtol=1e-6, atol=1e-7)
    untouched = torch.arange(v, device=dev) % 3 != 0
    assert torch.equal(table[untouched], t2[untouched])
    tk.adagrad_dense_pass(*again, g, 0.05)
    assert torch.equal(again[0], table) and torch.equal(again[1], acc)


def test_new_wrappers_reject_bad_inputs(dev):
    with pytest.raises(ValueError):
        tk.adagrad_dense_pass(torch.zeros(8, 12, device=dev),
                              torch.zeros(8, device=dev),
                              torch.zeros(8, 16, device=dev), 0.1)
    with pytest.raises(ValueError):
        tk.adagrad_dense_pass(torch.zeros(8, 0, device=dev),
                              torch.zeros(8, device=dev),
                              torch.zeros(8, 0, device=dev), 0.1)
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


def _md_counts():
    c = profiling.span_report()["counters"]
    return c.get("multi_dense.wgmma", 0), c.get("multi_dense.mma", 0)


def _linear_f64(x, w, bias, relu):
    y = x.double() @ w.double().t()
    if bias is not None:
        y = y + bias.double()
    return torch.relu(y) if relu else y


# (B, D, U): DLRM-DCNv2's over arch (3,456 -> 1,024 -> 1,024 -> 512 ->
# 256) at B = 1, 300 (off the 128-row tile) and 512, the kernel forced
# (below wgmma_plan's least output); xDeepFM's 400 -> 400 (passes of 200);
# D off the 32-float k-block with U below one pass; then the first layer
# at B = 8,191, which the plan takes
MD_WG_SHAPES = [(b, d, u) for b in (1, 300, 512)
                for d, u in ((3456, 1024), (1024, 1024), (1024, 512),
                             (512, 256))] + [(300, 400, 400), (77, 36, 17),
                                             (8191, 3456, 1024)]


@pytest.mark.parametrize("b,d,u", MD_WG_SHAPES)
def test_multi_dense_wgmma_matches_float64(dev, b, d, u):
    """B8's wgmma kernel on nn.Linear's (U, D) weight: 2e-6 of the
    largest output from float64, bias and ReLU each on and off, every
    call counted in ``multi_dense.wgmma``; a repeat bit-equal."""
    gen = torch.Generator().manual_seed(b + d + u)
    x = _rand(gen, dev, b, d)
    w = _rand(gen, dev, u, d) / d ** 0.5
    bias = _rand(gen, dev, u)
    taken = mk.wgmma_plan(b, d, u, True)
    assert taken == (b == 8191)
    run = mk.linear_wg if taken else mk._linear_wg
    for bb in (bias, None):
        for relu in (True, False):
            wg, mma = _md_counts()
            got = run(x, w, bb, relu)
            assert _md_counts() == (wg + 1, mma)
            want = _linear_f64(x, w, bb, relu)
            err = float((got.double() - want).abs().max())
            assert err <= 2e-6 * float(want.abs().max())
    assert torch.equal(got, run(x, w, None, False))


@pytest.mark.parametrize("case", ["d390", "off_grid", "experts", "stored"])
def test_multi_dense_plan_refusals_run_todays_kernel(dev, case):
    """What wgmma_plan refuses is no wgmma launch: linear_wg gives None
    for xDeepFM's 390-wide rows and for rows off the 16-byte grid (the
    tower then runs nn.Linear); an expert bank (N > 1) and a weight stored
    (1, D, U) run the banks' own kernels through multi_dense_fused (at
    these shapes their wgmma design, ``multi_dense.tc_wgmma``), counted
    in ``multi_dense.mma``, not ``multi_dense.wgmma``, within the tile's
    tolerance of the plain version."""
    gen = torch.Generator().manual_seed(7)
    d, u, n = (390, 400, 1) if case == "d390" else (
        (512, 256, 3) if case == "experts" else (512, 256, 1))
    x = _rand(gen, dev, 1, 4096, d)
    if case == "off_grid":
        x = _off_grid(x)
    w = _rand(gen, dev, n, u, d) / d ** 0.5
    bias = _rand(gen, dev, n, 1, u)
    wg, mma = _md_counts()
    if case in ("d390", "off_grid"):
        assert not mk.wgmma_plan(4096, d, u, x.data_ptr() % 16 == 0)
        assert mk.linear_wg(x[0], w[0], bias[0, 0], True) is None
        assert _md_counts() == (wg, mma)
        return
    stored = w.transpose(1, 2).contiguous()                 # (N, D, U)
    got = mk.multi_dense_fused(x, stored, bias, True)
    assert _md_counts() == (wg, mma + 1)
    assert torch.equal(got, mk.multi_dense_fused(x, stored, bias, True))
    _close_rel(got, mk.multi_dense_xla(x, stored, bias, "relu"))


def test_tower_routes_by_grad_mode_and_plan(dev):
    """A DNNTower of xDeepFM's (390 -> 400 -> 400) and the over arch's
    first widths at B = 4,096: with no gradient recorded each layer the
    plan takes is one wgmma launch, the 390-wide one nn.Linear; with a
    gradient, none; the outputs agree within 1e-5 of the largest.  At
    B = 1,024 the plan leaves 400 -> 400 to nn.Linear too."""
    from rec_now_tpu_torch.models.tower import DNNTower
    gen = torch.Generator().manual_seed(3)
    for b, d, dims, taken in ((4096, 390, (400, 400), 1),
                              (4096, 3456, (1024, 512), 2),
                              (1024, 390, (400, 400), 0)):
        tower = DNNTower(d, dims, gen, device=dev)
        x = torch.randn(b, d, device=dev)
        with torch.no_grad():
            wg, mma = _md_counts()
            fast = tower(x, relu_last=True)
            assert _md_counts() == (wg + taken, mma)
        wg, mma = _md_counts()
        slow = tower(x, relu_last=True)
        assert _md_counts() == (wg, mma) and slow.requires_grad
        _close_rel(fast, slow.detach())


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
    elif kind == "plus_minus":     # label sums 0 (valid), b / 3, -b / 3
        lab = torch.cat([torch.tensor([1.0, -1.0]).repeat(b // 6),
                         torch.ones(b // 3), -torch.ones(b - b // 3 * 2)])
        grp = torch.arange(b) * 3 // b
    elif kind in ("zipf", "wide ids"):
        lab = (torch.rand(b, generator=gen) > 0.6).float()
        grp = _groups_of(kind, b, gen)
    else:
        lab = (torch.rand(b, generator=gen) > 0.6).float()
        grp = torch.randint(0, max(1, b // 7), (b,), generator=gen)
    return torch.randn(b, generator=gen) * 2, lab, grp


# B on both sides of the one-block sort (8,192: past it the O(B^2) sweep),
# the SyntheticCriteo zipf groups, ids at the int32 ends, one group and
# singletons at 8,192, a {+1, -1} group (label sum 0, valid), and both
# paths forced at one B; every case repeated bit for bit
@pytest.mark.parametrize("b,kind,path", [
    (1, "mixed", "auto"), (37, "mixed", "auto"), (1000, "mixed", "auto"),
    (8192, "mixed", "auto"), (300, "none_valid", "auto"),
    (2100, "one_group", "auto"), (513, "singletons", "auto"),
    (8192, "zipf", "auto"), (8193, "zipf", "auto"),
    (1000, "wide ids", "auto"), (8192, "wide ids", "auto"),
    (8192, "one_group", "auto"), (8192, "singletons", "auto"),
    (300, "plus_minus", "auto"), (8192, "zipf", "sort"),
    (8192, "zipf", "sweep"), (4096, "wide ids", "sweep")])
def test_listwise_matches_plain(dev, b, kind, path):
    gen = torch.Generator().manual_seed(b)
    x, lab, grp = (t.to(dev) for t in _lw_batch(gen, b, kind))
    before = lk.listwise_loss_sum.launches
    loss, cnt, dx = lk._listwise_fused(x, lab, grp, path)
    assert lk.listwise_loss_sum.launches == before + 1
    want = lk.listwise_loss_fused_plain(x, lab, grp)
    assert float(cnt) == float(want[1])
    assert torch.isfinite(dx).all()
    if float(want[1]) == 0:
        assert float(loss) == 0.0 and not dx.any()
    else:
        _close_rel(loss, want[0])
        _close_rel(dx, want[2])
    for a, r in zip((loss, cnt, dx), lk._listwise_fused(x, lab, grp, path)):
        assert torch.equal(a, r)
    xg = x.clone().requires_grad_()
    loss2, cnt2 = lk.listwise_loss_sum(xg, lab, grp)
    assert not cnt2.requires_grad
    (dxg,) = torch.autograd.grad(loss2 * 3.0, xg)
    _, _, dx_auto = lk.listwise_loss_fused(x, lab, grp)
    torch.testing.assert_close(dxg, 3.0 * dx_auto, rtol=0, atol=0)


# a caller's threshold on graded labels in [-0.4, 1.2): below 0 a
# non-member's 0 counts as a label above it (one group has none)
@pytest.mark.parametrize("th", [0.3, -0.25])
@pytest.mark.parametrize("b,kind,path", [
    (1000, "zipf", "auto"), (8192, "zipf", "sort"), (8192, "zipf", "sweep"),
    (2100, "one_group", "sort"), (2100, "one_group", "sweep"),
    (513, "singletons", "auto")])
def test_listwise_threshold_matches_plain(dev, b, kind, path, th):
    gen = torch.Generator().manual_seed(b)
    x, _, grp = (t.to(dev) for t in _lw_batch(gen, b, kind))
    lab = (torch.rand(b, generator=gen) * 1.6 - 0.4).to(dev)
    before = lk.listwise_loss_sum.launches
    got = lk._listwise_fused(x, lab, grp, path, th)
    assert lk.listwise_loss_sum.launches == before + 1
    want = lk.listwise_loss_fused_plain(x, lab, grp, th)
    assert float(got[1]) == float(want[1])
    if kind == "singletons":
        # a valid singleton's row is x - lab * x / lab = 0 up to rounding
        # (the plain version's is 0 exactly): no scale to be relative to
        assert float(want[0]) == 0.0 and not want[2].any()
        assert float(got[0].abs()) <= 1e-6 * float(x.abs().sum())
        assert float(got[2].abs().max()) <= 1e-6
    elif float(want[1]):
        _close_rel(got[0], want[0])
        _close_rel(got[2], want[2])
    else:
        assert float(got[0]) == 0.0 and not got[2].any()
    for a, r in zip(got, lk._listwise_fused(x, lab, grp, path, th)):
        assert torch.equal(a, r)


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
    with pytest.raises(ValueError, match="sort path"):   # past kSortMax
        z = torch.zeros(lk.SORT_MAX + 1, device=dev)
        lk._listwise_fused(z, z, z.int(), "sort")


def _touched(v, flags, gen):
    """(V,) bool flags: every row but each third, none, all, only rows in
    a partial last 512-flag chunk, or zipf-clustered toward low rows."""
    if flags == "none":
        return torch.zeros(v, dtype=torch.bool)
    if flags == "all":
        return torch.ones(v, dtype=torch.bool)
    if flags == "tail":
        return torch.arange(v) >= v // 512 * 512
    if flags == "zipf":
        rows = (torch.rand(v // 20, generator=gen) ** 4 * v).long()
        return torch.zeros(v, dtype=torch.bool).index_fill_(0, rows, True)
    return torch.arange(v) % 3 != 1


# ragged V, every D of D / 4 threads a row, and widths of a warp a row on
# float4s (72, 272: config 5's CAN table) and on floats (45, 5, and D = 16
# with the tables off the 16-byte grid); flags none, all, in a partial
# last chunk only (V = 513, 1,025), zipf-clustered, and a flag tensor off
# the 16-byte grid (the byte loads); each repeated bit for bit
@pytest.mark.parametrize("v,d,flags", [
    (1, 4, "thirds"), (777, 8, "thirds"), (12345, 16, "thirds"),
    (1000, 32, "thirds"), (301, 64, "thirds"), (300, 128, "thirds"),
    (5000, 16, "none"), (5000, 16, "all"), (513, 16, "tail"),
    (1025, 8, "tail"), (100_000, 16, "zipf"), (1000, 16, "off grid"),
    (1001, 45, "thirds"), (777, 72, "thirds"), (33, 5, "thirds"),
    (513, 72, "tail"), (100_000, 272, "zipf"), (1000, 45, "off grid"),
    (1000, 16, "tables off grid"), (300, 272, "tables off grid")])
@pytest.mark.parametrize("t", [1, 1000])
def test_adam_dense_pass_matches_plain(dev, v, d, flags, t):
    gen = torch.Generator().manual_seed(v + d + t)
    table = _rand(gen, dev, v, d)
    m = _rand(gen, dev, v, d) * 1e-3
    vv = _rand(gen, dev, v, d).square() * 1e-6
    touched = _touched(v, flags, gen).to(dev)
    if flags == "off grid":
        touched = _off_grid(touched)
    if flags == "tables off grid":
        table, m, vv = _off_grid(table), _off_grid(m), _off_grid(vv)
    g = _rand(gen, dev, v, d) * touched[:, None]
    g[::6] = 0.0                 # touched rows with a zero gradient
    count = torch.tensor(t, dtype=torch.int32, device=dev)
    want = [x.clone() for x in (table, m, vv)]
    again = [_off_grid(x) if flags == "tables off grid" else x.clone()
             for x in (table, m, vv)]
    before = tk.adam_dense_pass.launches
    tk.adam_dense_pass(table, m, vv, g, touched, count, 1e-3)
    assert tk.adam_dense_pass.launches == before + 1
    tk.adam_dense_pass_plain(*want, g, touched, count, 1e-3, 0.9, 0.999,
                             1e-7)
    for got, ref in zip((table, m, vv), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-7)
        assert torch.equal(got[~touched], ref[~touched])
    tk.adam_dense_pass(*again, g, touched, count, 1e-3)
    for got, rep in zip((table, m, vv), again):
        assert torch.equal(got, rep)
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


# graded labels, a 0/1 mask, NG = 2 (the main group and two domains), 3 or
# 4 conditions, main groups of each kind, B on both sides of the one-block
# sort; every case repeated bit for bit
@pytest.mark.parametrize("b,ng,kind", [
    (1, 2, "random"), (37, 2, "random"), (8191, 2, "random"),
    (8192, 2, "random"), (8193, 2, "random"), (1000, 3, "random"),
    (8192, 4, "random"), (2048, 2, "one group"), (8192, 3, "one group"),
    (8192, 2, "singletons"), (1000, 4, "wide ids"), (8192, 2, "zipf"),
    (8193, 4, "zipf")])
@pytest.mark.parametrize("wrong_order", [False, True])
def test_pair_counts_and_general_loss_match_plain(dev, b, ng, kind,
                                                  wrong_order):
    x, lab, g1, g2, mask = _general_batch(b, b, dev)
    gen = torch.Generator().manual_seed(b + ng)
    if kind != "random":
        g1 = _groups_of(kind, b, gen).to(dev)
    groups = [g1, g2] + [torch.randint(0, 3, (b,), generator=gen).to(dev)
                         for _ in range(ng - 2)]
    want_counts = pk.pair_row_counts_plain(x, lab, groups, mask,
                                           wrong_order)
    # B7a on each path (the sort only where B <= 8,192; auto past it takes
    # the sweep), exact, and bit-equal on a repeat
    for path in (("auto", "sort", "sweep") if b <= pk.SORT_MAX
                 else ("auto", "sweep")):
        before = pk.pair_row_counts.launches
        counts = pk._pair_row_counts(x, lab, groups, mask, wrong_order, path)
        assert pk.pair_row_counts.launches == before + 1
        torch.testing.assert_close(counts, want_counts, rtol=0, atol=0)
        assert torch.equal(counts, pk._pair_row_counts(
            x, lab, groups, mask, wrong_order, path))
    counts = pk.pair_row_counts(x, lab, groups, mask, wrong_order)
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
    again = pk.pair_loss_fused(x, lab, groups, 0.8, row_weights=w,
                               sample_mask=mask, wrong_order=wrong_order)
    for a, r in zip(got, again):
        assert torch.equal(a, r)


# B on both sides of the one-block sort, main groups of each kind; B7c
# on 0/1 inputs exact (and equal to B7a -> B7b), on graded labels and a
# fractional mask within 1e-6 of the largest count (both sum in double,
# in other orders), each path bit-equal on a repeat
@pytest.mark.parametrize("b,kind", [
    (1, "random"), (8191, "random"), (8192, "random"), (8193, "random"),
    (8192, "one group"), (8192, "singletons"), (8192, "wide ids"),
    (8192, "zipf"), (8193, "zipf"), (1000, "wide ids")])
def test_binary_counts_and_in_kernel_weight_match_plain(dev, b, kind):
    x, lab, g1, _, mask = _general_batch(b, b + 1, dev)
    if kind != "random":
        g1 = _groups_of(kind, b, torch.Generator().manual_seed(b)).to(dev)
    clicks = (lab > 1).float()
    frac = torch.rand(b, generator=torch.Generator().manual_seed(3)).to(dev)
    want = pk.group_pair_counts_binary_plain(g1, clicks, mask)
    graded_want = pk.group_pair_counts_binary_plain(g1, lab, frac)
    # the same counts by the general route, B7a then B7b
    via = pk.same_group_matvec(g1, pk.pair_row_counts(x, clicks, g1, mask))
    torch.testing.assert_close(want, via, rtol=0, atol=0)
    for path in (("auto", "sort", "sweep") if b <= pk.SORT_MAX
                 else ("auto", "sweep")):
        before = pk.group_pair_counts_binary.launches
        got = pk._group_pair_counts_binary(g1, clicks, mask, path)
        assert pk.group_pair_counts_binary.launches == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert torch.equal(got, pk._group_pair_counts_binary(
            g1, clicks, mask, path))
        graded = pk._group_pair_counts_binary(g1, lab, frac, path)
        tol = 1e-6 * float(graded_want.abs().max())
        assert float((graded - graded_want).abs().max()) <= tol
        assert torch.equal(graded, pk._group_pair_counts_binary(
            g1, lab, frac, path))
    loss, cnt, dx = pk.pair_loss_fused(x, clicks, g1, 1.0, -0.5,
                                       sample_mask=mask)
    ref = pk.pair_loss_fused_plain(x, clicks, g1, 1.0, -0.5,
                                   sample_mask=mask)
    assert float(cnt) == float(ref[1])
    if float(ref[1]):
        _close_rel(loss, ref[0])
        _close_rel(dx, ref[2])


def _composed(x, lab, groups, mask, wrong_order, power):
    """The general loss as the parent composed it on the card: B7a, B7b,
    the weights in torch, then B3 with row weights."""
    counts = pk.pair_row_counts(x, lab, groups, mask, wrong_order)
    gpc = pk.same_group_matvec(groups[0], counts)
    w = torch.where(gpc > 0, gpc.clamp_min(1e-30) ** power,
                    torch.zeros_like(gpc))
    return pk.pair_loss_fused(x, lab, groups, 1.0, row_weights=w,
                              sample_mask=mask, wrong_order=wrong_order)


# the general loss in one call on each path (the one sort only where B <=
# 8,192; auto past it composes the sweeps) against its plain version and
# the parent's composition: the count exact, the loss 1e-5 of its
# magnitude and dlogits 1e-4 of their largest (powf against torch's
# rsqrt or reciprocal, sums in other orders); one pair_loss_sum launch a
# call and none of B7a or B7b; bit-equal on a repeat
@pytest.mark.parametrize("b,ng,kind,power", [
    (1, 2, "random", -0.5), (37, 2, "random", -1.0),
    (1000, 3, "random", -0.5), (8191, 2, "random", -0.5),
    (8192, 2, "random", -1.0), (8193, 2, "random", -0.5),
    (2048, 2, "one group", -0.5), (8192, 2, "singletons", -0.5),
    (1000, 4, "wide ids", -0.5), (8192, 2, "zipf", -0.5),
    (8192, 4, "zipf", -1.0), (8193, 2, "zipf", -0.5)])
@pytest.mark.parametrize("wrong_order", [False, True])
def test_general_loss_matches_plain_and_composition(dev, b, ng, kind, power,
                                                    wrong_order):
    x, lab, g1, g2, mask = _general_batch(b, b + 11, dev)
    gen = torch.Generator().manual_seed(b + ng + 1)
    if kind != "random":
        g1 = _groups_of(kind, b, gen).to(dev)
    groups = [g1, g2] + [torch.randint(0, 3, (b,), generator=gen).to(dev)
                         for _ in range(ng - 2)]
    want = pk.pair_loss_general_plain(x, lab, groups, 1.0, power,
                                      sample_mask=mask,
                                      wrong_order=wrong_order)
    parent = _composed(x, lab, groups, mask, wrong_order, power)
    assert float(parent[1]) == float(want[1])
    for path in (("auto", "sort", "sweep") if b <= pk.SORT_MAX
                 else ("auto", "sweep")):
        before = (pk.pair_loss_sum.launches, pk.pair_row_counts.launches,
                  pk.same_group_matvec.launches)
        got = pk._pair_loss_general(x, lab, groups, 1.0, power, mask,
                                    wrong_order, path)
        assert (pk.pair_loss_sum.launches, pk.pair_row_counts.launches,
                pk.same_group_matvec.launches) == (before[0] + 1,
                                                   before[1], before[2])
        assert float(got[1]) == float(want[1])
        for ref in (want, parent):
            if float(want[1]):
                _close_rel(got[0], ref[0], 1e-5)
                _close_rel(got[2], ref[2], 1e-4)
            else:
                assert float(got[0]) == 0.0 and not got[2].any()
        again = pk._pair_loss_general(x, lab, groups, 1.0, power, mask,
                                      wrong_order, path)
        for a, r in zip(got, again):
            assert torch.equal(a, r)


# B7b's hash against its plain version, which sums in double as the kernel
# does: integer vec (B7a's counts) exact and bit-equal on a repeat; f32 vec
# within 1e-6 of max|plain| (the double atomics add in no fixed order)
@pytest.mark.parametrize("b,kind", [
    (1, "random"), (37, "random"), (8191, "random"), (8192, "random"),
    (8193, "random"), (8192, "one group"), (8192, "zeros"),
    (8192, "singletons"), (8192, "wide ids"), (1000, "wide ids"),
    (8192, "zipf"), (8193, "zipf")])
def test_same_group_matvec_matches_plain(dev, b, kind):
    gen = torch.Generator().manual_seed(b + 3)
    g = (torch.zeros(b, dtype=torch.int64) if kind == "zeros"
         else _groups_of(kind, b, gen)).to(dev)
    counts = torch.randint(0, 3000, (b,), generator=gen).float().to(dev)
    vec = (torch.randn(b, generator=gen) * 3).to(dev)
    want_c = pk.same_group_matvec_plain(g, counts)
    want_v = pk.same_group_matvec_plain(g, vec)
    before = pk.same_group_matvec.launches
    got = pk.same_group_matvec(g, counts)
    assert pk.same_group_matvec.launches == before + 1
    torch.testing.assert_close(got, want_c, rtol=0, atol=0)
    assert torch.equal(got, pk.same_group_matvec(g, counts))
    got = pk.same_group_matvec(g, vec)
    assert float((got - want_v).abs().max()) <= 1e-6 * float(
        want_v.abs().max())


@pytest.mark.parametrize("case", ["graded", "wrong_order", "binary"])
def test_pairwise_loss_on_the_card_matches_the_cpu(dev, case):
    """The public loss: the card's dispatch (the general loss in one call,
    or B3 with the in-kernel weight: one pair_loss_sum launch either way,
    no B7a or B7b) against the CPU's (B, B) math under autograd."""
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
    assert (pk.pair_row_counts.launches, pk.same_group_matvec.launches,
            pk.pair_loss_sum.launches) == (before[0], before[1],
                                           before[2] + 1)
    got, want = out[str(dev)], out["cpu"]
    assert float(got[1]) == float(want[1]) > 0
    _close_rel(got[0], want[0], 1e-5)
    _close_rel(got[2], want[2], 1e-4)


def test_slice4_wrappers_reject_bad_inputs(dev):
    z = torch.zeros(8, 8, device=dev)
    t = torch.zeros(8, dtype=torch.bool, device=dev)
    c = torch.ones((), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):      # m of another width (D = 12)
        tk.adam_dense_pass(z, torch.zeros(8, 12, device=dev), z.clone(),
                           z.clone(), t, c, 1e-3)
    with pytest.raises(ValueError):      # D = 0
        tk.adam_dense_pass(*(torch.zeros(8, 0, device=dev),) * 4, t, c,
                           1e-3)
    with pytest.raises(TypeError):       # a float touched flag
        tk.adam_dense_pass(z, z.clone(), z.clone(), z.clone(), t.float(), c,
                           1e-3)
    with pytest.raises(ValueError):      # five group conditions
        pk.pair_row_counts(z[0], z[0], [t.int()] * 5)
    big = torch.zeros(pk.SORT_MAX + 1, device=dev)
    with pytest.raises(ValueError, match="sort path"):   # past kSortMax
        pk._pair_row_counts(big, big, big.int(), None, False, "sort")
    with pytest.raises(ValueError, match="sort path"):
        pk._group_pair_counts_binary(big.int(), big, None, "sort")
    with pytest.raises(ValueError, match="sort path"):
        pk._pair_loss_general(big, big, big.int(), 1.0, -0.5, None, False,
                              "sort")
    with pytest.raises(ValueError):      # groups and vec of two lengths
        pk.same_group_matvec(big.int(), z[0])
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


@pytest.mark.parametrize("shards", [1, 4])
def test_native_hot8_pack_matches_numpy(dev, shards):
    """The C++ hot8 encode (csrc/wire.cu, built by nvcc, what
    put_packed_window runs on the card) gives pack_window's bytes and
    table: zipf ids at 26 x 100,000, then a window from another id space
    that overflows the cap and relearns, then a flat window that raises;
    each window decodes on the card to its own ids."""
    from rec_now_tpu_torch.training import SyntheticCriteo
    from rec_now_tpu_torch.training.wire import (PackedBatch, WireFormat,
                                                 to_tensors)
    numpy_wire = WireFormat(26, 100_000, "u8", shards, id_mode="hot8")
    native = WireFormat(26, 100_000, "u8", shards, id_mode="hot8")
    zipf = list(SyntheticCriteo().batches(1024, 3))
    rng = np.random.default_rng(shards)
    moved = [b._replace(sparse_ids=(b.sparse_ids + 50_000) % 100_000)
             for b in zipf]
    for batches, version in ((zipf, 1), (moved, 2), (zipf[:1], 3)):
        want = numpy_wire.pack_window(batches)
        got = native.pack_window_native(batches)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert native.hot_version == numpy_wire.hot_version == version
        on_card = PackedBatch(*[t.to(dev) for t in to_tensors(got)])
        ids = native.decode(on_card)[1].cpu().numpy()
        np.testing.assert_array_equal(
            ids, np.stack([b.sparse_ids for b in batches]))
    flat = zipf[0]._replace(sparse_ids=rng.integers(0, 100_000, (1024, 26)))
    with pytest.raises(ValueError, match="esc_cap_frac"):
        WireFormat(26, 100_000, id_mode="hot8",
                   esc_cap_frac=0.05).pack_window_native([flat])


# -- the mod-sharded table in a NCCL group of one ---------------------------

@pytest.fixture
def group_of_one(dev):
    """A NCCL process group of one on the card, left after the test."""
    import torch.distributed as dist
    from rec_now_tpu_torch.parallel import make_mesh
    mesh = make_mesh(dev)
    assert (mesh.size, dist.get_backend()) == (1, "nccl")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("d", [16, 272])
@pytest.mark.parametrize("ids_kind", ["distinct", "zipf"])
def test_sharded_table_in_a_group_of_one_matches_one_device(
        dev, group_of_one, optimizer, mode, d, ids_kind):
    """Lookups (B11) are bit for bit: the first on the same table, every
    one against its own table's rows.  Distinct ids: every update path bit
    for bit too (B12 adds one term a row; B9 / B10 see the same gradient
    buffer).  Zipf ids: B12's atomics add a hot row's terms in no fixed
    order (SUM_TOL, 1e-6 of the summed |terms|); the gradients have one
    sign, so no sum cancels and each summed gradient moves by at most
    SUM_TOL of itself, and each row's move is held within 1e-5 of the
    largest move (Adam, which divides by |g|, too)."""
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    from rec_now_tpu_torch.ops import gather_kernel as gk
    v, n = 100_003, 4096
    gen = torch.Generator().manual_seed(d + n)
    if ids_kind == "distinct":
        ids = torch.randperm(v, generator=gen)[:n]
    else:
        ids = (torch.rand(n, generator=gen) ** 4 * v).long()
    ids = ids.reshape(-1, 8).to(dev)
    tables = [ShardedEmbeddingTable(v, d, device=dev, optimizer=optimizer,
                                    update_mode=mode, mesh=mesh)
              for mesh in (None, group_of_one)]
    states = [t.init(torch.Generator().manual_seed(3)) for t in tables]
    start = states[0].table.clone()
    assert torch.equal(states[1].table, start)
    for step in range(2):
        grads = _rand(gen, dev, *ids.shape, d).abs() * 1e-2
        before = gk.gather_rows.launches
        looked = [t.lookup(s, ids) for t, s in zip(tables, states)]
        assert gk.gather_rows.launches == before + 2
        for got, s in zip(looked, states):
            assert torch.equal(got, s.table[ids])
        if step == 0 or ids_kind == "distinct":
            assert torch.equal(looked[0], looked[1])
        for t, s in zip(tables, states):
            t.apply_grads(s, ids, grads, lr=0.05)
    torch.cuda.synchronize()
    names = (("table", "accumulator") if optimizer == "adagrad"
             else ("table", "m", "v", "count"))
    for name in names:
        a, b = (getattr(s, name) for s in states)
        if ids_kind == "distinct":
            assert torch.equal(a, b), name
        elif name == "table":
            moved = a - start
            tol = 1e-5 * float(moved.abs().max())
            assert float((b - a).abs().max()) <= tol
        else:
            tol = 1e-5 * float(a.abs().max())
            assert float((b - a).abs().max()) <= tol, name


# -- the one table's update, per-occurrence Adagrad and the slot utilities --

def _zipf_ids(gen, v, n):
    ids = (torch.rand(n, generator=gen) ** 4 * v).long()
    ids[::7] = v // 3                          # a hot row
    return ids


@pytest.mark.parametrize("v,d,n", [(1000, 16, 1500), (100_003, 16, 4096),
                                   (777, 5, 333), (5000, 272, 700)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("acc0", [0.1, 0.0])
def test_one_table_update_matches_cpu(dev, v, d, n, masked, acc0):
    """``EmbeddingTable.apply_grads`` on the card (B12 twice: the segment
    sums and the write-back; no B9) against the CPU from the same state:
    one-signed gradients, so no sum cancels and B12's order of adds moves
    each row by at most 1e-5 of the largest move; accumulators rtol 1e-5;
    the masked-only rows at accumulator 0 stay as they were."""
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.ops import expand_kernel as ek
    from rec_now_tpu_torch.ops import gather_kernel as gk
    gen = torch.Generator().manual_seed(v + d + n)
    ids = _zipf_ids(gen, v, n)
    grads = torch.randn(n, d, generator=gen).abs() * 1e-2
    mask = torch.rand(n, generator=gen) > 0.2 if masked else None
    tables = {x: EmbeddingTable(v, d, device=x, initial_accumulator=acc0)
              for x in ("cpu", dev)}
    start = tables["cpu"].init(torch.Generator().manual_seed(1))
    states = {x: t.state_from(start.to(x).clone())
              for x, t in tables.items()}
    before = (gk.gather_rows.launches, ek.scatter_add_rows.launches,
              tk.adagrad_dense_pass.launches)
    rows = tables[dev].embedding_func(states[dev])(ids.to(dev))
    assert torch.equal(rows.cpu(), start[ids])
    for x, t in tables.items():
        t.apply_grads(states[x], ids.to(x), grads.to(x), 0.05,
                      None if mask is None else mask.to(x))
    assert (gk.gather_rows.launches, ek.scatter_add_rows.launches,
            tk.adagrad_dense_pass.launches) == (before[0] + 1,
                                                before[1] + 2, before[2])
    got, want = states[dev], states["cpu"]
    assert torch.isfinite(got.table).all()
    moved = want.table - start
    assert float(moved.abs().max()) > 0
    tol = 1e-5 * float(moved.abs().max())
    assert float((got.table.cpu() - want.table).abs().max()) <= tol
    torch.testing.assert_close(got.accumulator.cpu(), want.accumulator,
                               rtol=1e-5, atol=1e-12)
    if masked:
        only_masked = torch.zeros(v, dtype=torch.bool)
        only_masked[ids[~mask]] = True
        only_masked[ids[mask]] = False
        if acc0 == 0.0 and only_masked.any():
            assert torch.equal(got.table.cpu()[only_masked],
                               start[only_masked])


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("dedup", [True, False])
def test_sharded_mask_and_dedup_match_cpu(dev, optimizer, mode, dedup):
    """``ShardedEmbeddingTable.apply_grads(..., valid_mask, dedup)`` on the
    card against the CPU: per-occurrence Adagrad is one B12 launch and no
    B9 in either mode; Adam ignores ``dedup``."""
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    from rec_now_tpu_torch.ops import expand_kernel as ek
    v, d, n = 50_001, 16, 4096
    gen = torch.Generator().manual_seed(n + d)
    ids = _zipf_ids(gen, v, n)
    grads = torch.randn(n, d, generator=gen).abs() * 1e-2
    mask = torch.rand(n, generator=gen) > 0.2
    tables = {x: ShardedEmbeddingTable(v, d, device=x, optimizer=optimizer,
                                       update_mode=mode)
              for x in ("cpu", dev)}
    states = {x: t.init(torch.Generator().manual_seed(2))
              for x, t in tables.items()}
    start = states["cpu"].table.clone()
    before = (ek.scatter_add_rows.launches, tk.adagrad_dense_pass.launches)
    tables[dev].apply_grads(states[dev], ids.to(dev), grads.to(dev), 0.05,
                            valid_mask=mask.to(dev), dedup=dedup)
    if optimizer == "adagrad" and not dedup:
        assert (ek.scatter_add_rows.launches,
                tk.adagrad_dense_pass.launches) == (before[0] + 1,
                                                    before[1])
    tables["cpu"].apply_grads(states["cpu"], ids, grads, 0.05,
                              valid_mask=mask, dedup=dedup)
    got, want = states[dev], states["cpu"]
    moved = want.table - start
    tol = 1e-5 * float(moved.abs().max())
    assert float((got.table.cpu() - want.table).abs().max()) <= tol
    names = ("accumulator",) if optimizer == "adagrad" else ("m", "v")
    for name in names:
        a, b = getattr(got, name).cpu(), getattr(want, name)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("method", ["sum", "mean"])
def test_slot_utilities_on_the_card_match_the_cpu(dev, method):
    """Pooling and padding of (slot, id, weight) triples through the
    table's ``embedding_func`` (one B11 launch a call) on the card against
    the CPU, with gradients to the rows and the weights; integer outputs
    exact."""
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.ops import gather_kernel as gk
    from rec_now_tpu_torch.rec_block import embedding_util as eu
    gen = torch.Generator().manual_seed(9)
    b, c, v = 512, 40, 10_000
    slots = torch.randint(-1, 12, (b, c), generator=gen)
    ids = torch.randint(0, v, (b, c), generator=gen)
    weights = torch.rand(b, c, generator=gen)
    table = EmbeddingTable(v, 16, device="cpu")
    rows = table.init(torch.Generator().manual_seed(3))
    res = {}
    for x in ("cpu", dev):
        t = EmbeddingTable(v, 16, device=x)
        leaves, inner = [], t.embedding_func(rows.to(x))

        def f(i):
            e = inner(i).requires_grad_()
            leaves.append(e)
            return e
        w = weights.to(x).requires_grad_()
        before = gk.gather_rows.launches
        pooled = eu.embedding_using_batch_segment_ids(
            f, slots.to(x), [0, 3, 5, 3, 11], ids.to(x), w, method=method)
        if x != "cpu":
            assert gk.gather_rows.launches == before + 1
        padded, pw, hits = eu.embedding_single_slot(
            f, slots.to(x), 4, ids.to(x), w, default_weight=0.5, ncols=6)
        grads = torch.autograd.grad(pooled.sum() + (padded * pw).sum(),
                                    [*leaves, w])
        pids, pwt = eu.pool_slots(slots.to(x), [1, 2, 7], ids.to(x), w,
                                  method=method, drop_duplicate_slot=True)
        fids, _ = eu.fetch_single_slot(slots.to(x), 2, ids.to(x),
                                       default_id=-1, ncols=5)
        res[x] = (pooled, padded, pw, hits, pids, pwt, fids, *grads)
    for got, want in zip(res[dev], res["cpu"]):
        got = got.detach().cpu()
        if want.is_floating_point():
            _close(got, want.detach())
        else:
            assert torch.equal(got, want)
