"""Port vs JAX: the public in-batch pairwise loss with every option of
the kernel path, and its counting kernels (B7a/b/c) and general loss
kernel (B3) through their plain versions.

* The plain ``pair_row_counts``, ``same_group_matvec`` and
  ``group_pair_counts_binary`` against the JAX Pallas kernels,
  interpreted off the TPU (exact: small integer counts); the row counts
  also on one group, singletons and ids at both int32 ends, and the
  binary group counts on graded labels with a fractional mask, which
  both sum as mask * label and mask (1e-6 of the largest count: f32 sums
  in other orders).
* The port's ``pairwise_loss`` -- loss, pair count and dlogits by
  autograd -- against JAX ``pairwise_loss`` (its (B, B) XLA path) over a
  grid: labels binary or graded {0, 1, 2}; one group or two AND-combined;
  no mask or a 0/1 mask with zeros; the wrong-order filter off and on;
  occurrence power -0.5, 0 and 0.5; ``binary_labels`` on binary labels.
  Both the CPU path (the (B, B) math) and the card's dispatch
  (``_pairwise_loss_kernels``: B7a -> B7b -> B3, or B3 with the in-kernel
  weight), which on CPU tensors runs the kernels' plain versions.
* The card's dispatch against JAX ``pairwise_loss_pallas`` (interpreted).
* A fractional mask: the public loss on the CPU counts a sample where
  mask > 0.5, as ``pairwise_loss_pallas`` and the port's kernels do.
* The general plain ``pair_loss_fused_plain`` against JAX
  ``_pair_loss_fused_impl`` (interpreted), with row weights, a mask, two
  groups and the wrong-order filter.
* Edge cases: B = 1; B = 37 (not a multiple of 8); no valid pair gives
  loss 0, count 0 and zero, finite dlogits.
* The general loss as one call (``pair_loss_general``, what the card runs
  on one sort): its plain version and its autograd wrapper on the CPU
  against JAX ``pairwise_loss_pallas`` interpreted (the sum: loss, count
  and dlogits by ``jax.grad``) on graded labels, two groups and a mask,
  wrong order off and on, power -0.5 and -1.0; the sort path's order in
  plain PyTorch (``_general_by_segments`` here: B7a's counts summed per
  segment of the main group, one weight a segment) against JAX and the
  plain version, with weights bit-equal to the plain composition's, on
  one group, singletons and ids at both int32 ends; B7b as its hash sums
  (``_matvec_by_segments`` here: each group's sum in double, once per
  group, rounded once) against ``jpk.same_group_matvec`` interpreted on
  the same groups.

f32 on both sides, summed in other orders: the mean loss rtol 1e-5,
dlogits atol 1e-6 (terms of order 1 / n_pair), the counts exact; the
general loss's sum rtol 1e-5 and its dlogits 1e-5 of their largest
magnitude (terms of order 1); B7b exact on integer vec, and on f32 vec
1e-6 of sum |vec| against JAX's f32 sums (the port's sum in double).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.losses.pairwise import pairwise_loss as jax_pairwise_loss
from rec_now_tpu.ops.pallas import pairwise_kernel as jpk
from rec_now_tpu_torch.losses.pairwise import (_pairwise_loss_kernels,
                                               pairwise_loss)
from rec_now_tpu_torch.ops import pairwise_kernel as pk

torch.set_num_threads(1)


def _batch(b, seed, graded=True, two_groups=True, masked=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b) * 2).astype(np.float32)
    lab = rng.randint(0, 3 if graded else 2, b).astype(np.float32)
    groups = [rng.randint(0, max(1, b // 6), b).astype(np.int32)]
    if two_groups:
        groups.append(rng.randint(0, 2, b).astype(np.int32))
    mask = ((rng.rand(b) > 0.25).astype(np.float32) if masked else None)
    return x, lab, groups, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _segment_totals(groups, vec):
    """(each segment's sum of ``vec`` in ``vec``'s type, each row's
    segment id) over a stable sort by group (a segment's first position
    is its group's first occurrence, as the kernels' sort)."""
    g = groups.reshape(-1).to(torch.int64)
    order = torch.sort(g, stable=True).indices
    _, sizes = torch.unique_consecutive(g[order], return_counts=True)
    seg = torch.repeat_interleave(torch.arange(len(sizes)), sizes)
    tot = torch.zeros(len(sizes), dtype=vec.dtype).index_add_(
        0, seg, vec[order])
    return tot, torch.empty_like(seg).index_copy_(0, order, seg)


def _matvec_by_segments(groups, vec):
    """B7b as its kernel sums: each group's sum of vec in float64 (one
    table slot or one segment a group), rounded once to f32 and written
    to every member."""
    tot, row_seg = _segment_totals(groups, vec.double())
    return tot.float()[row_seg]


def _weights_by_segments(groups, counts, power):
    """(B,) f32 weights of the general loss as its sort path takes them:
    B7a's counts summed over each segment of the main group in integers
    (the count sweep's atomics), the total rounded once to f32, then
    ``gpc ** power`` for the segment (0 where gpc is 0)."""
    tot, row_seg = _segment_totals(groups, counts.to(torch.int64))
    gpc = tot.float()
    w = torch.where(gpc > 0, gpc.clamp_min(1e-30) ** power,
                    torch.zeros_like(gpc))
    return w[row_seg]


def _general_by_segments(logits, labels, groups, factor=1.0, power=-0.5, *,
                         sample_mask=None, wrong_order=False):
    """``pk.pair_loss_general_plain`` with the weights taken as the sort
    path takes them (:func:`_weights_by_segments`)."""
    g = pk.group_rows(groups)
    counts = pk.pair_row_counts_plain(logits, labels, g, sample_mask,
                                      wrong_order)
    w = _weights_by_segments(g[0], counts, power)
    return pk.pair_loss_fused_plain(logits, labels, g, factor, row_weights=w,
                                    sample_mask=sample_mask,
                                    wrong_order=wrong_order)


def _jax(x, lab, groups, mask, **kw):
    """JAX pairwise_loss (mean, count) and d mean / d logits."""
    jg = [jnp.asarray(g) for g in groups]
    jm = None if mask is None else jnp.asarray(mask)

    def f(xx):
        return jax_pairwise_loss(xx, jnp.asarray(lab), jg, mask=jm,
                                 return_num_pair=True, **kw)
    loss, cnt = f(jnp.asarray(x))
    dx = jax.grad(lambda xx: f(xx)[0])(jnp.asarray(x))
    return float(loss), float(cnt), np.asarray(dx)


def _port(fn, x, lab, groups, mask, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    loss, cnt = fn(xt, _t(lab), [_t(g) for g in groups], _t(mask), **kw)
    (dx,) = torch.autograd.grad(loss, xt, allow_unused=True)
    dx = torch.zeros_like(xt) if dx is None else dx
    assert not cnt.requires_grad
    return float(loss.detach()), float(cnt), dx.numpy()


def _public(x, lab, groups, mask, wrong, power, binary):
    return pairwise_loss(x, lab, groups, mask=mask, return_num_pair=True,
                         only_use_wrong_order_pair=wrong,
                         click_occurance_power=power, binary_labels=binary)


def _dispatch(x, lab, groups, mask, wrong, power, binary):
    loss, cnt = _pairwise_loss_kernels(x, lab, groups, 1.0, wrong, power,
                                       mask, binary)
    return loss / (cnt + 1e-10), cnt


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)


GRID = list(itertools.product([False, True], [False, True], [False, True],
                              [False, True], [-0.5, 0.0, 0.5]))


@pytest.mark.parametrize("graded,two,masked,wrong,power", GRID)
def test_pairwise_loss_matches_jax(graded, two, masked, wrong, power):
    x, lab, groups, mask = _batch(61, 3, graded, two, masked)
    want = _jax(x, lab, groups, mask, only_use_wrong_order_pair=wrong,
                click_occurance_power=power)
    assert want[1] > 0
    # binary_labels is a promise only binary labels may make
    for binary in ([False, True] if not graded else [False]):
        for fn in (_public, _dispatch):
            _close(_port(fn, x, lab, groups, mask, wrong=wrong, power=power,
                         binary=binary), want)


@pytest.mark.parametrize("wrong,binary", [(False, True), (False, False),
                                          (True, False)])
def test_dispatch_matches_jax_pallas_interpret(wrong, binary):
    x, lab, groups, mask = _batch(64, 5, graded=not binary,
                                  two_groups=not binary)
    jg = [jnp.asarray(g) for g in groups]

    def f(xx):
        return jpk.pairwise_loss_pallas(
            xx, jnp.asarray(lab), jg, only_use_wrong_order_pair=wrong,
            return_num_pair=True, click_occurance_power=-0.5,
            mask=jnp.asarray(mask), binary_labels=binary)
    loss, cnt = f(jnp.asarray(x))
    dx = jax.grad(lambda xx: f(xx)[0])(jnp.asarray(x))
    _close(_port(_dispatch, x, lab, groups, mask, wrong=wrong, power=-0.5,
                 binary=binary), (float(loss), float(cnt), np.asarray(dx)))


@pytest.mark.parametrize("wrong", [False, True])
def test_fractional_mask_counts_above_half(wrong):
    # the public loss takes a sample where mask > 0.5 on the CPU path too,
    # as the kernels (and JAX's kernel path) do
    x, lab, groups, _ = _batch(64, 7)
    frac = np.random.RandomState(2).choice(
        np.float32([0.0, 0.3, 0.5, 0.7, 1.0]), 64)
    jg = [jnp.asarray(g) for g in groups]

    def f(xx):
        return jpk.pairwise_loss_pallas(
            xx, jnp.asarray(lab), jg, only_use_wrong_order_pair=wrong,
            return_num_pair=True, click_occurance_power=-0.5,
            mask=jnp.asarray(frac))
    loss, cnt = f(jnp.asarray(x))
    dx = jax.grad(lambda xx: f(xx)[0])(jnp.asarray(x))
    want = (float(loss), float(cnt), np.asarray(dx))
    binary = (frac > 0.5).astype(np.float32)
    for mask in (frac, binary):
        _close(_port(_public, x, lab, groups, mask, wrong=wrong, power=-0.5,
                     binary=False), want)
    # the fractional samples matter: counting them as valid changes the pairs
    assert _port(_public, x, lab, groups, (frac > 0).astype(np.float32),
                 wrong=wrong, power=-0.5, binary=False)[1] != want[1]


@pytest.mark.parametrize("b", [40, 64])
@pytest.mark.parametrize("wrong", [False, True])
def test_counts_match_jax_pallas_interpret(b, wrong):
    x, lab, groups, mask = _batch(b, b)
    jg = tuple(jnp.asarray(g) for g in groups)
    want = np.asarray(jpk.pair_row_counts(jnp.asarray(x), jnp.asarray(lab),
                                          jg, jnp.asarray(mask), wrong))
    counts = pk.pair_row_counts(_t(x), _t(lab), [_t(g) for g in groups],
                                _t(mask), wrong)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert want.sum() > 0
    want = np.asarray(jpk.same_group_matvec(jg[0], jnp.asarray(want)))
    got = pk.same_group_matvec(_t(groups[0]), counts)
    np.testing.assert_array_equal(got.numpy(), want)
    clicks = (lab > 1).astype(np.float32)
    want = np.asarray(jpk.group_pair_counts_binary(
        jg[0], jnp.asarray(clicks), jnp.asarray(mask)))
    got = pk.group_pair_counts_binary(_t(groups[0]), _t(clicks), _t(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    # on binary labels the closed form is the B7a -> B7b composition ...
    via = pk.same_group_matvec(_t(groups[0]), pk.pair_row_counts(
        _t(x), _t(clicks), _t(groups[0]), _t(mask)))
    np.testing.assert_array_equal(got.numpy(), via.numpy())
    # ... and on graded labels it is not: only B7a -> B7b is right there
    graded = pk.group_pair_counts_binary(_t(groups[0]), _t(lab), _t(mask))
    right = pk.same_group_matvec(_t(groups[0]), pk.pair_row_counts(
        _t(x), _t(lab), _t(groups[0]), _t(mask)))
    assert not torch.equal(graded, right)


# main groups the sort by group meets at its ends: one group of every
# sample, all singletons (no pair), ids at both ends of the int32 range
_EDGE_GROUPS = {
    "one group": lambda rng, b: np.full(b, 7, np.int32),
    "singletons": lambda rng, b: rng.permutation(b).astype(np.int32) - b // 2,
    "int32 ends": lambda rng, b: rng.choice(np.array(
        [-2 ** 31, -2 ** 31 + 1, -7, 0, 3, 2 ** 31 - 2, 2 ** 31 - 1],
        np.int64), b).astype(np.int32)}


@pytest.mark.parametrize("kind", sorted(_EDGE_GROUPS))
@pytest.mark.parametrize("wrong", [False, True])
def test_row_counts_plain_matches_jax_on_edge_groups(kind, wrong):
    b = 53
    x, lab, groups, mask = _batch(b, 13)
    groups[0] = _EDGE_GROUPS[kind](np.random.RandomState(4), b)
    jg = tuple(jnp.asarray(g) for g in groups)
    want = np.asarray(jpk.pair_row_counts(jnp.asarray(x), jnp.asarray(lab),
                                          jg, jnp.asarray(mask), wrong))
    got = pk.pair_row_counts(_t(x), _t(lab), [_t(g) for g in groups],
                             _t(mask), wrong)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want.sum() == 0) == (kind == "singletons")


@pytest.mark.parametrize("b,frac", [(40, "levels"), (64, "levels"),
                                    (64, "uniform")])
def test_binary_counts_plain_matches_jax_on_graded_labels(b, frac):
    # graded labels and a fractional mask: both sum mask * label and mask
    x, lab, groups, _ = _batch(b, b + 5)
    rng = np.random.RandomState(b)
    mask = (rng.choice(np.float32([0.0, 0.3, 0.5, 0.7, 1.0]), b)
            if frac == "levels" else rng.rand(b).astype(np.float32))
    want = np.asarray(jpk.group_pair_counts_binary(
        jnp.asarray(groups[0]), jnp.asarray(lab), jnp.asarray(mask)))
    got = pk.group_pair_counts_binary(_t(groups[0]), _t(lab), _t(mask))
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    # the fractional values matter: counting by mask > 0.5 differs
    by_half = pk.group_pair_counts_binary(_t(groups[0]), _t(lab),
                                          _t((mask > 0.5).astype(np.float32)))
    assert np.abs(by_half.numpy() - want).max() > 1e-6 * scale


@pytest.mark.parametrize("wrong", [False, True])
@pytest.mark.parametrize("power", [0.0, -0.5])
def test_general_plain_matches_jax_pallas_interpret(wrong, power):
    b = 48
    x, lab, groups, mask = _batch(b, 9, graded=power == 0.0,
                                  two_groups=power == 0.0)
    if wrong and power:
        groups = groups[:1]
        wrong = False          # the in-kernel weight forbids the filter
    w = (np.random.RandomState(1).rand(b) + 0.5).astype(np.float32)
    loss, cnt, dx = jpk._pair_loss_fused_impl(
        jnp.asarray(x), jnp.asarray(lab), tuple(jnp.asarray(g)
                                                for g in groups),
        jnp.asarray(w), jnp.asarray(mask), 0.7, wrong, power)
    got = pk.pair_loss_fused_plain(
        _t(x), _t(lab), [_t(g) for g in groups], 0.7, power,
        row_weights=_t(w), sample_mask=_t(mask), wrong_order=wrong)
    np.testing.assert_allclose(float(got[0]), float(loss), rtol=1e-5)
    assert float(got[1]) == float(cnt) > 0
    np.testing.assert_allclose(got[2].numpy(), np.asarray(dx), atol=1e-6)
    with pytest.raises(ValueError, match="single group"):
        pk.pair_loss_fused_plain(_t(x), _t(lab), [_t(groups[0])] * 2, 1.0,
                                 -0.5)


@pytest.mark.parametrize("b", [1, 37])
@pytest.mark.parametrize("fn", [_public, _dispatch])
def test_edge_batches(b, fn):
    x, lab, groups, mask = _batch(b, 11)
    want = _jax(x, lab, groups, mask, click_occurance_power=-0.5)
    got = _port(fn, x, lab, groups, mask, wrong=False, power=-0.5,
                binary=False)
    _close(got, want)
    # no valid pair: all labels equal
    same = np.ones_like(lab)
    got = _port(fn, x, same, groups, mask, wrong=True, power=-0.5,
                binary=False)
    assert got[0] == 0.0 and got[1] == 0.0
    assert np.isfinite(got[2]).all() and not got[2].any()


def test_options_without_a_kernel_path_raise():
    """The options JAX runs off its kernel path -- a label-pair weight
    function, a custom pair loss, an extra keyword (which JAX hands to the
    weight function, and ignores without one) -- run on the CPU and give
    JAX's ``pairwise_loss`` numbers; none raises."""
    x, lab, groups, mask = _batch(16, 0)
    args = (_t(x), _t(lab), [_t(g) for g in groups])
    jargs = (jnp.asarray(x), jnp.asarray(lab),
             [jnp.asarray(g) for g in groups])

    def hinge(pos, neg, weights, pair_mask=None):
        per = (1.0 - (pos - neg)).clamp_min(0.0) * pair_mask
        return per.sum() / (pair_mask.sum() + 1e-10)

    def jhinge(pos, neg, weights, pair_mask=None):
        m = pair_mask.astype(jnp.float32)
        return jnp.sum(jnp.maximum(1.0 - (pos - neg), 0.0) * m) / (
            jnp.sum(m) + 1e-10)

    cases = ((dict(label_pair_to_weight_func=lambda a, b: a - b),
              dict(label_pair_to_weight_func=lambda a, b: a - b)),
             (dict(pairloss_func=hinge), dict(pairloss_func=jhinge)),
             (dict(margin=1.0), dict(margin=1.0)))
    for kw, jkw in cases:
        got, cnt = pairwise_loss(*args, mask=_t(mask), return_num_pair=True,
                                 **kw)
        want, jcnt = jax_pairwise_loss(*jargs, mask=jnp.asarray(mask),
                                       return_num_pair=True,
                                       use_pallas=False, **jkw)
        assert float(cnt) == float(jcnt) > 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _general_jax(x, lab, groups, mask, wrong, power):
    """JAX pairwise_loss_pallas, interpreted: (loss sum, count, d sum /
    d logits) on the general path (graded labels)."""
    jg = [jnp.asarray(g) for g in groups]

    def f(xx):
        return jpk.pairwise_loss_pallas(
            xx, jnp.asarray(lab), jg, only_use_wrong_order_pair=wrong,
            return_num_pair=True, click_occurance_power=power,
            mask=jnp.asarray(mask), reduce_mean=False)
    loss, cnt = f(jnp.asarray(x))
    dx = jax.grad(lambda xx: f(xx)[0])(jnp.asarray(x))
    return float(loss), float(cnt), np.asarray(dx)


def _close_sum(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[2], want[2], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want[2]).max()))


def _as_numpy(out):
    loss, cnt, dx = out
    return float(loss), float(cnt), dx.detach().numpy()


@pytest.mark.parametrize("wrong", [False, True])
@pytest.mark.parametrize("power", [-0.5, -1.0])
def test_general_loss_plain_matches_jax_pallas_interpret(wrong, power):
    x, lab, groups, mask = _batch(64, 17)
    want = _general_jax(x, lab, groups, mask, wrong, power)
    assert want[1] > 0
    args = (_t(x), _t(lab), [_t(g) for g in groups], 1.0, power)
    kw = dict(sample_mask=_t(mask), wrong_order=wrong)
    _close_sum(_as_numpy(pk.pair_loss_general_plain(*args, **kw)), want)
    _close_sum(_as_numpy(_general_by_segments(*args, **kw)),
               want)
    # the wrapper the public loss calls, through its autograd Function
    xt = _t(x).clone().requires_grad_()
    before = pk.pair_loss_sum.launches
    loss, cnt = pk.pair_loss_general_sum(xt, *args[1:], **kw)
    (dx,) = torch.autograd.grad(loss, xt)
    assert not cnt.requires_grad and pk.pair_loss_sum.launches == before
    _close_sum((float(loss.detach()), float(cnt), dx.numpy()), want)


@pytest.mark.parametrize("kind", sorted(_EDGE_GROUPS))
@pytest.mark.parametrize("wrong", [False, True])
def test_general_loss_by_segments_on_edge_groups(kind, wrong):
    b = 53
    x, lab, groups, mask = _batch(b, 19)
    groups[0] = _EDGE_GROUPS[kind](np.random.RandomState(6), b)
    g = [_t(a) for a in groups]
    kw = dict(sample_mask=_t(mask), wrong_order=wrong)
    got = _general_by_segments(_t(x), _t(lab), g, 1.0, -0.5, **kw)
    plain = pk.pair_loss_general_plain(_t(x), _t(lab), g, 1.0, -0.5, **kw)
    # the weights: the per-segment totals in integers and the (B, B)
    # double sums round to the same f32 gpc, so they are bit-equal
    counts = pk.pair_row_counts_plain(_t(x), _t(lab), g, _t(mask), wrong)
    gpc = pk.same_group_matvec_plain(g[0], counts)
    w = torch.where(gpc > 0, gpc ** -0.5, torch.zeros_like(gpc))
    torch.testing.assert_close(
        _weights_by_segments(g[0], counts, -0.5), w, rtol=0,
        atol=0)
    for a, r in zip(got, plain):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    if kind == "singletons":
        assert float(got[1]) == 0.0 and float(got[0]) == 0.0
        assert not got[2].any()
    else:
        assert float(got[1]) > 0
        _close_sum(_as_numpy(got), _general_jax(x, lab, groups, mask, wrong,
                                                -0.5))


@pytest.mark.parametrize("kind", sorted(_EDGE_GROUPS) + ["random"])
def test_matvec_by_segments_matches_jax_pallas_interpret(kind):
    b = 53
    rng = np.random.RandomState(21)
    grp = (_EDGE_GROUPS[kind](rng, b) if kind != "random"
           else rng.randint(0, 9, b).astype(np.int32))
    counts = rng.randint(0, 50, b).astype(np.float32)   # B7b's one input
    vec = (rng.randn(b) * 3).astype(np.float32)
    for v, exact in ((counts, True), (vec, False)):
        want = np.asarray(jpk.same_group_matvec(jnp.asarray(grp),
                                                jnp.asarray(v)))
        got = _matvec_by_segments(_t(grp), _t(v))
        plain = pk.same_group_matvec_plain(_t(grp), _t(v))
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        atol = 0.0 if exact else 1e-6 * np.abs(v).sum()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    if kind == "singletons":
        np.testing.assert_array_equal(got.numpy(), vec)


def test_general_wrappers_take_plain_version_on_cpu_only():
    x, lab, groups, mask = _batch(40, 23)
    args = (_t(x), _t(lab), [_t(g) for g in groups], 0.7, -0.5)
    kw = dict(sample_mask=_t(mask), wrong_order=True)
    before = (pk.pair_loss_sum.launches, pk.same_group_matvec.launches)
    for path in ("auto", "sort", "sweep"):
        for a, r in zip(pk._pair_loss_general(*args, kw["sample_mask"],
                                              True, path),
                        pk.pair_loss_general_plain(*args, **kw)):
            torch.testing.assert_close(a, r, rtol=0, atol=0)
    torch.testing.assert_close(
        pk.same_group_matvec(_t(groups[0]), _t(x)),
        pk.same_group_matvec_plain(_t(groups[0]), _t(x)), rtol=0, atol=0)
    assert (pk.pair_loss_sum.launches,
            pk.same_group_matvec.launches) == before
    meta = [a.to("meta") for a in args[:2]]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pk.pair_loss_general(*meta, [g.to("meta") for g in args[2]])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pk.same_group_matvec(args[2][0].to("meta"), meta[0])
