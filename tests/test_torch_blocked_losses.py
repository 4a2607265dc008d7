"""Port vs JAX: the blocked losses, the rest of ``pairwise_loss`` and
``listwise``, and the focal loss.

* ``pairwise_loss_blocked`` = the port's dense ``pairwise_loss`` and =
  JAX's ``pairwise_loss_blocked`` (value, pair count and ``jax.grad``)
  over JAX's option grid (``tests/losses/test_pairwise_blocked.py``):
  blocks of 8, 16 and 64 rows, a ragged last block, occurrence powers,
  a mask with the wrong-order filter, a label-pair weight function over
  two groups, a custom tile-contract ``pairloss_func``;
* the dispatch at a monkeypatched ``BLOCKED_MIN_BATCH``, as JAX's own
  test does: a capable custom callable and the default BPR routed
  blocked, a signature-only one routed with one warning, an incapable
  one kept dense; the contract's introspection; the
  ``functools.partial(bpr_loss_func, ...)`` form JAX's trainer passes;
  extra keywords reaching the weight function;
* backward memory: what autograd keeps for the blocked forms is O(B),
  not O(B^2) (counted through ``saved_tensors_hooks``);
* ``listwise_loss_blocked`` = the dense form and = JAX's blocked form,
  gradients included; ``to_listwise_sample``'s options,
  ``listwise_loss_via_softmax_cross_entropy_with_logits``'s ``weights``
  / ``do_reduce`` / ``row_valid`` and ``listwise_loss`` against JAX;
* ``focal_crossentropy_loss`` against JAX over its alpha / gamma grid.

f32 on both sides, summed in other orders: losses rtol 1e-5 (atol 1e-7),
gradients within 1e-4 of their largest magnitude; pair counts exact.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.losses import focal as jfocal
from rec_now_tpu.losses import listwise as jlw
from rec_now_tpu.losses import listwise_blocked as jlwb
from rec_now_tpu.losses import pairwise as jpw
from rec_now_tpu.losses import pairwise_blocked as jpwb
from rec_now_tpu_torch.losses import focal_crossentropy_loss
from rec_now_tpu_torch.losses import listwise as lw
from rec_now_tpu_torch.losses import listwise_blocked as lwb
from rec_now_tpu_torch.losses import pairwise as pw
from rec_now_tpu_torch.losses import pairwise_blocked as pwb

torch.set_num_threads(1)

LTOL = dict(rtol=1e-5, atol=1e-7)


def _mk(b, seed=0, n_groups=5, graded=False):
    rng = np.random.RandomState(seed)
    lab = (rng.randint(0, 4, b) if graded else rng.rand(b) > 0.5)
    return (rng.randn(b).astype(np.float32), lab.astype(np.float32),
            rng.randint(0, n_groups, b).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_grad(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def _wfn_t(lp, ln, offset=0.5):
    return (lp > ln).float() * (lp - ln + offset)


def _wfn_j(lp, ln, offset=0.5):
    return (lp > ln).astype(jnp.float32) * (lp - ln + offset)


def _huber_t(pos, neg, weights=None, delta=0.8, reduce_mean=True,
             pair_mask=None):
    gap = delta - (pos - neg)
    per = torch.where(gap > 1.0, gap - 0.5,
                      0.5 * torch.clamp_min(gap, 0.0) ** 2)
    if weights is not None:
        per = per * weights
    m = pair_mask.to(per.dtype)
    out = (per * m).sum()
    return out / (m.sum() + 1e-10) if reduce_mean else out


def _huber_j(pos, neg, weights=None, delta=0.8, reduce_mean=True,
             pair_mask=None):
    gap = delta - (pos - neg)
    per = jnp.where(gap > 1.0, gap - 0.5, 0.5 * jnp.maximum(gap, 0.0) ** 2)
    if weights is not None:
        per = per * weights
    m = pair_mask.astype(per.dtype)
    out = jnp.sum(per * m)
    return out / (jnp.sum(m) + 1e-10) if reduce_mean else out


# (name, batch, block, options): the grid of JAX's blocked tests
PAIR_CASES = [
    ("default-8", 48, 8, {}),
    ("default-16", 48, 16, {}),
    ("default-64", 48, 64, {}),
    ("ragged", 50, 16, {}),
    ("power-1", 40, 8, {"click_occurance_power": -1.0}),
    ("power0.5", 40, 8, {"click_occurance_power": 0.5}),
    ("mask-wrong-order", 32, 8, {"mask": True,
                                 "only_use_wrong_order_pair": True}),
    ("weight-fn-2-groups", 24, 8, {"weight_fn": True, "groups": 2}),
    ("weight-fn-power-mask", 37, 8, {"weight_fn": True, "mask": True,
                                     "click_occurance_power": -0.5}),
    ("factor-sum", 45, 16, {"factor": 2.0, "reduce_mean": False,
                            "click_occurance_power": -0.5}),
    ("custom", 64, 16, {"custom": True}),
    ("custom-power-mask", 48, 16, {"custom": True, "mask": True,
                                   "click_occurance_power": -0.5}),
]


def _pair_inputs(b, seed, opts):
    x, lab, g = _mk(b, seed, graded=opts.get("weight_fn", False))
    rng = np.random.RandomState(seed + 100)
    groups = [g] + ([rng.randint(0, 2, b).astype(np.int32)]
                    if opts.get("groups") == 2 else [])
    mask = ((rng.rand(b) > 0.3).astype(np.float32) if opts.get("mask")
            else None)
    return x, lab, groups, mask


@pytest.mark.parametrize("name,b,block,opts", PAIR_CASES,
                         ids=[c[0] for c in PAIR_CASES])
def test_pairwise_blocked_matches_dense_and_jax(name, b, block, opts):
    x, lab, groups, mask = _pair_inputs(b, len(name), opts)
    common = dict(
        click_occurance_power=opts.get("click_occurance_power", 0.0),
        only_use_wrong_order_pair=opts.get("only_use_wrong_order_pair",
                                           False),
        return_num_pair=True)
    tkw, jkw = dict(common), dict(common)
    if mask is not None:
        tkw["mask"], jkw["mask"] = _t(mask), jnp.asarray(mask)
    if opts.get("weight_fn"):
        tkw["label_pair_to_weight_func"] = _wfn_t
        jkw["label_pair_to_weight_func"] = _wfn_j
    for k in ("factor", "reduce_mean"):
        if k in opts:
            tkw[k] = jkw[k] = opts[k]
    if opts.get("custom"):
        tkw["pairloss_func"], jkw["pairloss_func"] = _huber_t, _huber_j

    def jax_loss(xx):
        return jpwb.pairwise_loss_blocked(
            xx, jnp.asarray(lab), [jnp.asarray(g) for g in groups],
            block_rows=block, **jkw)

    jl, jn = jax_loss(jnp.asarray(x))
    jg = jax.grad(lambda xx: jax_loss(xx)[0])(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    tl, tn = pwb.pairwise_loss_blocked(xt, _t(lab), [_t(g) for g in groups],
                                       block_rows=block, **tkw)
    tg, = torch.autograd.grad(tl, xt)
    assert float(tn) == float(jn) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LTOL)
    _close_grad(tg.numpy(), jg)
    # the port's dense form (B < BLOCKED_MIN_BATCH) on the same call
    xd = _t(x).requires_grad_()
    dl, dn = pw.pairwise_loss(xd, _t(lab), [_t(g) for g in groups], **tkw)
    dg, = torch.autograd.grad(dl, xd)
    assert float(dn) == float(tn)
    np.testing.assert_allclose(float(dl.detach()), float(tl.detach()),
                               **LTOL)
    _close_grad(dg.numpy(), tg.numpy())


def test_pairwise_dense_options_match_jax():
    """The dense form with a weight function (extra keywords forwarded),
    a custom callable and the partial BPR form, against JAX's
    ``pairwise_loss`` (XLA path)."""
    x, lab, g = _mk(40, 3, graded=True)
    mask = (np.random.RandomState(4).rand(40) > 0.2).astype(np.float32)
    cases = [
        (dict(label_pair_to_weight_func=_wfn_t, offset=1.5),
         dict(label_pair_to_weight_func=_wfn_j, offset=1.5)),
        (dict(pairloss_func=_huber_t, click_occurance_power=-0.5),
         dict(pairloss_func=_huber_j, click_occurance_power=-0.5)),
        (dict(pairloss_func=functools.partial(pw.bpr_loss_func, factor=2.0,
                                              reduce_mean=False),
              click_occurance_power=-0.5),
         dict(pairloss_func=functools.partial(jpw.bpr_loss_func, factor=2.0,
                                              reduce_mean=False),
              click_occurance_power=-0.5)),
    ]
    for tkw, jkw in cases:
        def jloss(xx):
            return jpw.pairwise_loss(xx, jnp.asarray(lab), jnp.asarray(g),
                                     mask=jnp.asarray(mask),
                                     return_num_pair=True,
                                     use_pallas=False, **jkw)
        jl, jn = jloss(jnp.asarray(x))
        jg = jax.grad(lambda xx: jloss(xx)[0])(jnp.asarray(x))
        xt = _t(x).requires_grad_()
        tl, tn = pw.pairwise_loss(xt, _t(lab), _t(g), mask=_t(mask),
                                  return_num_pair=True, **tkw)
        tg, = torch.autograd.grad(tl, xt)
        assert float(tn) == float(jn) > 0
        np.testing.assert_allclose(float(tl.detach()), float(jl), **LTOL)
        _close_grad(tg.numpy(), jg)


def test_dispatch_at_a_lowered_threshold(monkeypatch):
    """At B >= BLOCKED_MIN_BATCH (lowered to 32 here): the default BPR, a
    declared-capable callable and the weight function (with its extra
    keyword) go to the blocked form; a signature-only callable too, with
    one warning; an incapable one stays dense.  The JAX trainer's partial
    form gives JAX's numbers on both sides of the threshold."""
    x, lab, g = _mk(64, 5, graded=True)
    args = (_t(x), _t(lab), _t(g))
    calls = []
    orig = pwb.pairwise_loss_blocked

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(pwb, "pairwise_loss_blocked", spy)
    below = pw.pairwise_loss(*args, click_occurance_power=-0.5)
    assert not calls
    monkeypatch.setattr(pw, "BLOCKED_MIN_BATCH", 32)
    routed = pw.pairwise_loss(*args, click_occurance_power=-0.5)
    assert len(calls) == 1 and calls[-1]["pairloss_func"] is None
    np.testing.assert_allclose(float(routed), float(below), **LTOL)

    def declared(pos, neg, weights=None, pair_mask=None, reduce_mean=True):
        return _huber_t(pos, neg, weights, pair_mask=pair_mask,
                        reduce_mean=reduce_mean)
    declared.blocked_capable = True
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pw.pairwise_loss(*args, pairloss_func=declared)
    assert calls[-1]["pairloss_func"] is declared
    assert calls[-1]["reduce_mean"] is True

    pw.pairwise_loss(*args, label_pair_to_weight_func=_wfn_t, offset=2.0)
    wf = calls[-1]["label_pair_to_weight_func"]
    assert isinstance(wf, functools.partial) and wf.keywords == {
        "offset": 2.0}

    def sniffed(pos, neg, weights=None, pair_mask=None, reduce_mean=True):
        return _huber_t(pos, neg, weights, pair_mask=pair_mask,
                        reduce_mean=reduce_mean)
    with pytest.warns(UserWarning, match="blocked") as rec:
        out = pw.pairwise_loss(*args, pairloss_func=sniffed)
    assert len([w for w in rec if "blocked" in str(w.message)]) == 1
    np.testing.assert_allclose(
        float(out), float(jpw.pairwise_loss(
            jnp.asarray(x), jnp.asarray(lab), jnp.asarray(g),
            pairloss_func=_huber_j, use_pallas=False)), **LTOL)

    n_calls = len(calls)

    def legacy(pos, neg, weights, pair_mask=None):
        per = torch.clamp_min(1.0 - (pos - neg), 0.0)
        m = pair_mask.float()
        return (per * m).sum() / (m.sum() + 1e-10)
    dense = pw.pairwise_loss(*args, pairloss_func=legacy)
    assert len(calls) == n_calls and torch.isfinite(dense)

    # the JAX trainer's CPU form on both sides of the threshold
    part_t = functools.partial(pw.bpr_loss_func, factor=1.5,
                               reduce_mean=False)
    part_j = functools.partial(jpw.bpr_loss_func, factor=1.5,
                               reduce_mean=False)
    want, wn = jpw.pairwise_loss(
        jnp.asarray(x), jnp.asarray(lab), jnp.asarray(g),
        pairloss_func=part_j, click_occurance_power=-0.5,
        return_num_pair=True, use_pallas=False)
    for limit in (32, 4096):
        monkeypatch.setattr(pw, "BLOCKED_MIN_BATCH", limit)
        got, gn = pw.pairwise_loss(*args, pairloss_func=part_t,
                                   click_occurance_power=-0.5,
                                   return_num_pair=True)
        assert float(gn) == float(wn)
        np.testing.assert_allclose(float(got), float(want), **LTOL)
    assert calls[-1]["reduce_mean"] is False


def test_blocked_capable_contract():
    def explicit(pos, neg, w, pair_mask=None, reduce_mean=True):
        return torch.zeros(())

    def swallows(pos, neg, w, pair_mask=None, **kw):
        return torch.zeros(())

    def bare(pos, neg, w):
        return torch.zeros(())

    def opted_in(pos, neg, w, pair_mask=None, reduce_mean=True):
        return torch.zeros(())
    opted_in.blocked_capable = True

    def opted_out(pos, neg, w, pair_mask=None, reduce_mean=True):
        return torch.zeros(())
    opted_out.blocked_capable = False

    cap = pw._blocked_capable
    assert cap(explicit) is None and cap(swallows) is False
    assert cap(bare) is False and cap(opted_in) is True
    assert cap(opted_out) is False
    assert cap(functools.partial(opted_in, reduce_mean=False)) is True
    assert cap(functools.partial(pw.bpr_loss_func, factor=2.0)) is True
    assert pw._callable_reduces(explicit) is True
    assert pw._callable_reduces(
        functools.partial(explicit, reduce_mean=False)) is False
    assert pw._callable_reduces(bare) is True
    x, lab, g = _mk(16, 1)
    with pytest.raises(ValueError, match="bind them"):
        pw.pairwise_loss(_t(x), _t(lab), _t(g), pairloss_func=explicit,
                         reduce_mean=False)


def _saved_numel(fn):
    """Elements autograd keeps for backward while ``fn()`` runs, each
    storage counted once (every block of a checkpointed loss keeps the
    same logits)."""
    kept = {}

    def pack(t):
        kept[(t.untyped_storage().data_ptr(), t.numel())] = t.numel()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(kept.values())


def test_blocked_backward_memory_is_linear():
    """What autograd keeps for backward: O(B) for the blocked forms (the
    BPR and listwise Functions keep the logits; a custom callable's
    blocks are checkpointed), O(B^2) for the dense forms."""
    b = 512
    x, lab, g = _mk(b, 7, n_groups=20, graded=True)
    xt = _t(x).requires_grad_()
    blocked = [
        lambda: pwb.pairwise_loss_blocked(xt, _t(lab), _t(g), block_rows=64,
                                          click_occurance_power=-0.5),
        lambda: pwb.pairwise_loss_blocked(
            xt, _t(lab), _t(g), block_rows=64,
            label_pair_to_weight_func=_wfn_t, pairloss_func=_huber_t),
        lambda: lwb.listwise_loss_blocked(_t(g), _t(lab), xt,
                                          block_rows=64)]
    dense = [
        lambda: pw.pairwise_loss(xt, _t(lab), _t(g),
                                 label_pair_to_weight_func=_wfn_t),
        lambda: lw.listwise_loss(_t(g), _t(lab), xt)]
    for fn in blocked:
        assert _saved_numel(fn) <= 8 * b
    for fn in dense:
        assert _saved_numel(fn) >= b * b


LIST_CASES = [("block-8", 48, 8), ("block-16", 48, 16), ("block-64", 48, 64),
              ("ragged", 45, 16)]


@pytest.mark.parametrize("name,b,block", LIST_CASES,
                         ids=[c[0] for c in LIST_CASES])
def test_listwise_blocked_matches_dense_and_jax(name, b, block):
    x, lab, g = _mk(b, len(name), n_groups=6)
    for kw in ({}, {"value_of_masked_logit": -1e4, "pos_neg_th": 0.4}):
        jl, jg = jax.value_and_grad(lambda s: jlwb.listwise_loss_blocked(
            jnp.asarray(g), jnp.asarray(lab), s, block_rows=block, **kw))(
            jnp.asarray(x))
        xt = _t(x).requires_grad_()
        tl = lwb.listwise_loss_blocked(_t(g), _t(lab), xt,
                                       block_rows=block, **kw)
        tg, = torch.autograd.grad(tl, xt)
        np.testing.assert_allclose(float(tl.detach()), float(jl), **LTOL)
        _close_grad(tg.numpy(), jg)
        xd = _t(x).requires_grad_()
        dl = lw.listwise_loss(_t(g), _t(lab), xd, **kw)
        dg, = torch.autograd.grad(dl, xd)
        np.testing.assert_allclose(float(dl.detach()), float(tl.detach()),
                                   **LTOL)
        _close_grad(dg.numpy(), tg.numpy())


def test_listwise_no_valid_group_is_zero():
    g, lab = _t([1, 2, 3]), torch.ones(3)
    s = torch.tensor([0.5, -0.1, 0.2], requires_grad=True)
    for loss in (lwb.listwise_loss_blocked(g, lab, s, block_rows=2),
                 lw.listwise_loss(g, lab, s)):
        assert float(loss.detach()) == 0.0
        gs, = torch.autograd.grad(loss, s)
        assert torch.isfinite(gs).all() and not gs.any()


def test_listwise_options_match_jax(monkeypatch):
    """``to_listwise_sample``'s options, the softmax-CE's ``weights`` /
    ``do_reduce`` / ``row_valid``, ``listwise_loss`` (dense, and blocked
    at a lowered threshold) against JAX."""
    x, lab, g = _mk(40, 11, n_groups=7)
    lab = lab * np.random.RandomState(12).rand(40).astype(np.float32) * 2
    w = np.random.RandomState(13).rand(40).astype(np.float32)
    for kw in ({}, {"do_mask_logits": False},
               {"value_of_masked_logit": -1e4, "pos_neg_th": 0.7}):
        want = jlw.to_listwise_sample(jnp.asarray(g), jnp.asarray(lab),
                                      jnp.asarray(x), **kw)
        got = lw.to_listwise_sample(_t(g), _t(lab), _t(x), **kw)
        for field in ("mask", "labels", "logits", "row_valid"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field)), err_msg=field, **LTOL)
        for ce_kw in ({}, {"do_reduce": False}, {"weights": True},
                      {"weights": True, "do_reduce": False},
                      {"row_valid": True}, {"row_valid": True,
                                            "weights": True,
                                            "do_reduce": False}):
            jce, tce = dict(ce_kw), dict(ce_kw)
            if ce_kw.get("weights"):
                jce["weights"], tce["weights"] = jnp.asarray(w), _t(w)
            if ce_kw.get("row_valid"):
                jce["row_valid"], tce["row_valid"] = (want.row_valid,
                                                      got.row_valid)
            logits = got.logits.detach().clone().requires_grad_()
            tv = lw.listwise_loss_via_softmax_cross_entropy_with_logits(
                got.labels, logits, **tce)
            jv, jvjp = jax.vjp(
                lambda z: jlw.
                listwise_loss_via_softmax_cross_entropy_with_logits(
                    want.labels, z, **jce), want.logits)
            np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                                       **LTOL)
            ct = np.asarray(np.random.RandomState(14).randn(
                *np.shape(jv)), np.float32)
            tg, = torch.autograd.grad(tv, logits, _t(ct).reshape(tv.shape))
            _close_grad(tg.numpy(), jvjp(jnp.asarray(ct))[0])
    for kw in ({}, {"value_of_masked_logit": -1e4, "pos_neg_th": 0.7}):
        want = jlw.listwise_loss(jnp.asarray(g), jnp.asarray(lab),
                                 jnp.asarray(x), use_pallas=False, **kw)
        np.testing.assert_allclose(
            float(lw.listwise_loss(_t(g), _t(lab), _t(x), **kw)),
            float(want), **LTOL)
        calls = []
        orig = lwb.listwise_loss_blocked
        monkeypatch.setattr(lwb, "listwise_loss_blocked",
                            lambda *a, **k: calls.append(k) or orig(*a, **k))
        monkeypatch.setattr(pw, "BLOCKED_MIN_BATCH", 32)
        np.testing.assert_allclose(
            float(lw.listwise_loss(_t(g), _t(lab), _t(x), **kw)),
            float(want), **LTOL)
        assert len(calls) == 1
        monkeypatch.undo()


def test_small_helpers_match_jax():
    g = np.array([3, 1, 3, 3, 2, 1, 3], np.int32)
    for band in (False, True):
        np.testing.assert_array_equal(
            pw.generate_pair_mask([_t(g), _t(g % 2)], band).numpy(),
            np.asarray(jpw.generate_pair_mask(
                [jnp.asarray(g), jnp.asarray(g % 2)], band)))
    v = np.arange(5, dtype=np.float32)
    for a, c in zip(pw.vec_to_matrix_pair(_t(v)),
                    jpw.vec_to_matrix_pair(jnp.asarray(v))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    for power in (0.0, 1.0, -0.5):
        np.testing.assert_allclose(
            pw.occurance_power_weight(_t(g), power).numpy(),
            np.asarray(jpw.occurance_power_weight(jnp.asarray(g), power)),
            **LTOL)
    rows = np.array([[0.0, 0.0], [0.0, -2.0], [np.nan, 1.0]], np.float32)
    np.testing.assert_array_equal(
        lw.row_not_all_zero(_t(rows)).numpy(),
        np.asarray(jlw.row_not_all_zero(jnp.asarray(rows))))
    np.testing.assert_array_equal(
        lw.nan_to_zero(_t(rows)).numpy(),
        np.asarray(jlw.nan_to_zero(jnp.asarray(rows))))
    x, lab, g2 = _mk(12, 2)
    np.testing.assert_allclose(
        float(pw.bpr_loss_func(_t(x)[:, None], _t(x)[None, :], factor=2.0)),
        float(jpw.bpr_loss_func(jnp.asarray(x)[:, None],
                                jnp.asarray(x)[None, :], factor=2.0)),
        **LTOL)


FOCAL_GRID = [(0.25, 2.0), (None, None), (0, 0), (0.5, 0.5), (None, 2.0),
              (0.75, None)]


@pytest.mark.parametrize("alpha,gamma", FOCAL_GRID)
@pytest.mark.parametrize("stop", [False, True])
def test_focal_matches_jax(alpha, gamma, stop):
    rng = np.random.RandomState(0)
    labels = (rng.rand(64) > 0.5).astype(np.float32)
    logits = (rng.randn(64) * 2).astype(np.float32)
    logits[:3] = 0.0                      # JAX's gradient at a zero logit
    for mean in (True, False):
        def jf(z):
            return jfocal.focal_crossentropy_loss(
                jnp.asarray(labels), z, alpha=alpha, gamma=gamma,
                stop_weight_gradient=stop, return_mean=mean)
        jv, jvjp = jax.vjp(jf, jnp.asarray(logits))
        zt = _t(logits).requires_grad_()
        tv = focal_crossentropy_loss(_t(labels), zt, alpha=alpha,
                                     gamma=gamma, stop_weight_gradient=stop,
                                     return_mean=mean)
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                                   **LTOL)
        ct = np.ones(np.shape(jv), np.float32)
        tg, = torch.autograd.grad(tv, zt, _t(ct).reshape(tv.shape))
        _close_grad(tg.numpy(), jvjp(jnp.asarray(ct))[0])


def test_focal_validation():
    with pytest.raises(ValueError, match="alpha"):
        focal_crossentropy_loss(torch.zeros(2), torch.zeros(2), alpha=1.5)
    with pytest.raises(ValueError, match="gamma"):
        focal_crossentropy_loss(torch.zeros(2), torch.zeros(2), gamma=-1.0)
