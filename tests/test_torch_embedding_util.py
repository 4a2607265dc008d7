"""Port vs JAX: the slot / segment embedding utilities
(``rec_block/embedding_util.py``) on the table's ``embedding_func``.

* Every documented example of ``tests/rec_block/test_embedding_util.py``,
  through the port, to the same golden values.
* Random (slot, id, weight) triples, the same numpy arrays through both
  packages: ``embedding_using_batch_segment_ids`` (sum and mean, with and
  without weights, a target slot listed twice: the last index wins),
  ``embedding_single_slot`` (truncation at ``ncols``, ``default_weight``),
  ``pool_slots`` (both methods, integer weights under mean, 1-D slots,
  ``drop_duplicate_slot``, which drops only adjacent repeats),
  ``pool_single_slot``, ``fetch_single_slot`` and the helpers.  The
  port's ``embedding_func`` is ``EmbeddingTable.embedding_func`` (B11's
  plain version here).
* Gradients with respect to the ``embedding_func`` output and the
  weights against ``jax.grad``.
* ``fetch_single_slot`` equal to JAX's on ids below 2^24 and exact above
  it, where JAX's float32 round trip rounds them.

f32 on both sides: pooled rows rtol 1e-5 / atol 1e-6 (sums in another
order), gradients rtol 1e-5 / atol 1e-6; integer outputs and masks
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.rec_block import embedding_util as ju
from rec_now_tpu_torch.embedding.table import EmbeddingTable
from rec_now_tpu_torch.rec_block import embedding_util as eu

torch.set_num_threads(1)

V, D = 97, 5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _func(params):
    """The port's embedding_func over a (V, D) numpy table."""
    table = EmbeddingTable(params.shape[0], params.shape[1], device="cpu")
    return table.embedding_func(_t(params))


def _jfunc(params):
    return lambda ids: jnp.take(jnp.asarray(params), ids, axis=0)


def _close(got, want, **kw):
    want = np.asarray(want)
    kw.setdefault("rtol", 1e-5)
    kw.setdefault("atol", 1e-6 * max(1.0, float(np.abs(want).max(initial=0))))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **kw)


# -- the documented examples (tests/rec_block/test_embedding_util.py) --------

DOC = np.array([[i, -i] for i in range(40)], np.float32)


def test_isin_and_mask_values_doc_examples():
    mat = _t([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]])
    np.testing.assert_array_equal(
        eu.isin(mat, [1, 3, 5, 7, 9]).numpy(),
        [[False, True, False, True, False], [True, False, True, False, True]])
    np.testing.assert_array_equal(
        eu.mask_values(mat, [1, 3, 5, 7, 9], padding_value=-1).numpy(),
        [[-1, 1, -1, 3, -1], [5, -1, 7, -1, 9]])


def test_first_occurance_doc_examples():
    got = eu.first_occurance_in_row(
        _t([[0, 1, 1, 2, 3, 3], [1, 3, 3, 2, 5, 5]]), padding_value=-1)
    np.testing.assert_array_equal(got.numpy(), [[0, 1, -1, 2, 3, -1],
                                                [1, 3, -1, 2, 5, -1]])
    got = eu.first_occurance_in_row(_t([[3, 1, 3, 1]]), need_sort=True,
                                    padding_value=0)
    np.testing.assert_array_equal(got.numpy(), [[1, 0, 3, 0]])
    with pytest.raises(ValueError):
        eu.first_occurance_in_row(_t([1, 2, 3]))


def test_batch_segment_ids_doc_examples():
    slots = _t([[0, 1, 1, 2, 3, 3], [1, 3, 3, 2, 5, 5]])
    ids, num_rows, num_ids, num_segments = \
        eu.batch_segment_ids_of_targets(slots, [1, 3, 5])
    np.testing.assert_array_equal(ids.numpy(), [[-1, 0, 0, -1, 1, 1],
                                                [3, 4, 4, -1, 5, 5]])
    assert (num_rows, num_ids, num_segments) == (2, 3, 6)
    mask, flat, _, _, num_segments = \
        eu.sparse_batch_segment_ids_of_targets(slots, [1, 3, 5])
    np.testing.assert_array_equal(
        mask.numpy(), [[False, True, True, False, True, True],
                       [True, True, True, False, True, True]])
    flat = flat.numpy().reshape(2, 6)
    assert flat[0, 1] == 0 and flat[0, 4] == 1
    assert flat[1, 0] == 3 and flat[1, 4] == 5
    assert flat[0, 0] == num_segments


@pytest.mark.parametrize("case", ["weighted", "unweighted", "mean"])
def test_pooled_doc_examples(case):
    f = _func(DOC)
    ids = np.array([[0, 10, 20, 30], [21, 30, 31, 1]])
    slots = ((ids + 0.5) / 10.0).astype(np.int32)
    if case == "mean":
        got = eu.embedding_using_sparse_batch_segment_ids(
            f, _t([[1, 1, 2]]), [1], _t([[10, 12, 20]]), method="mean")
        _close(got, [[[11., -11.]]])
        return
    weights = _t(ids.astype(np.float32) * 10.0) if case == "weighted" \
        else None
    got = eu.embedding_using_sparse_batch_segment_ids(
        f, _t(slots), [1, 3], _t(ids), weights=weights)
    want = ([[[1000., -1000.], [9000., -9000.]],
             [[0., 0.], [18610., -18610.]]] if weights is not None else
            [[[10., -10.], [30., -30.]], [[0., 0.], [61., -61.]]])
    _close(got, want)


def test_single_slot_doc_examples():
    f = _func(DOC)
    ids = np.array([[0, 10, 10, 30], [21, 22, 31, 1]])
    slots = ((ids + 0.5) / 10.0).astype(np.int32)
    emb, w, mask = eu.embedding_single_slot(
        f, _t(slots), 2, _t(ids), _t(ids.astype(np.float32) * 10.0),
        ncols=2)
    _close(emb, [[[0., 0.], [0., 0.]], [[21., -21.], [22., -22.]]])
    _close(w, [[[0.], [0.]], [[210.], [220.]]])
    np.testing.assert_array_equal(mask.numpy(),
                                  [[[False], [False]], [[True], [True]]])
    eye = np.eye(5, dtype=np.float32)
    emb, _, mask = eu.embedding_single_slot(_func(eye), _t([[1, 1, 1]]), 1,
                                            _t([[0, 1, 2]]), ncols=2)
    _close(emb, eye[None, :2])
    with pytest.raises(ValueError):
        eu.embedding_single_slot(f, _t([[1, 1]]), 1, _t([[1, 1]]))


def test_pool_slots_doc_examples():
    slots = np.array([[1, 2, 3, 0, 0], [2, 2, 4, 5, 0]])
    ids = slots * 10 + np.array([[0, 0, 0, 0, 0], [8, 0, 0, 0, 0]])
    weights = slots.astype(np.float32) * 0.1
    pooled_ids, pooled_w = eu.pool_slots(_t(slots), [2, 3], _t(ids),
                                         _t(weights))
    np.testing.assert_array_equal(pooled_ids.numpy(), [[20, 30], [20, 0]])
    _close(pooled_w, [[0.2, 0.3], [0.4, 0.0]])
    pooled_ids, _ = eu.pool_slots(_t(slots), [2, 3], _t(ids), _t(weights),
                                  drop_duplicate_slot=True)
    np.testing.assert_array_equal(pooled_ids.numpy(), [[20, 30], [28, 0]])
    pooled_ids, _ = eu.pool_slots(_t([1, 2, 2]), [2], _t([10, 20, 20]))
    np.testing.assert_array_equal(pooled_ids.numpy(), [[20]])


def test_fetch_and_pool_single_slot_doc_examples():
    ids = np.array([[0, 10], [10, 20], [20, 21]])
    slots = ((ids + 0.5) / 10.0).astype(np.int32)
    got_ids, got_w = eu.fetch_single_slot(
        _t(slots), 2, _t(ids), _t(ids.astype(np.float32) * 10.0),
        default_id=0, ncols=2)
    np.testing.assert_array_equal(got_ids.numpy(),
                                  [[0, 0], [20, 0], [20, 21]])
    _close(got_w, [[0., 0.], [200., 0.], [200., 210.]])
    got_ids, got_w = eu.fetch_single_slot(_t([[1, 3]]), 2, _t([[7, 9]]),
                                          None, default_id=-5, ncols=3)
    np.testing.assert_array_equal(got_ids.numpy(), [[-5, -5, -5]])
    assert got_w is None
    slots = np.array([[1, 2, 3], [2, 3, 4]])
    with pytest.warns(UserWarning):
        p_ids, p_w = eu.pool_single_slot(_t(slots), 2, _t(slots * 10),
                                         _t(slots.astype(np.float32) * 0.1))
    np.testing.assert_array_equal(p_ids.numpy(), [[20], [20]])
    _close(p_w, [[0.2], [0.2]])


# -- random triples against JAX ------------------------------------------------

def _triples(seed, b=48, c=12, num_slots=8, vocab=V):
    """(B, C) slots in [-1, num_slots) (-1 pads), ids in [0, vocab),
    weights U(0, 1), and a (vocab, D) table."""
    rng = np.random.RandomState(seed)
    slots = rng.randint(-1, num_slots, size=(b, c)).astype(np.int32)
    slots[0] = 3                  # one row all one slot: truncation
    slots[1] = -1                 # one row of padding only
    ids = rng.randint(0, vocab, size=(b, c)).astype(np.int32)
    weights = rng.rand(b, c).astype(np.float32)
    params = rng.randn(vocab, D).astype(np.float32)
    return slots, ids, weights, params


TARGETS = {"plain": [1, 3, 5], "duplicate": [2, 4, 2, 7],
           "absent": [0, 11, 6]}


@pytest.mark.parametrize("targets", list(TARGETS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("method", ["sum", "mean"])
def test_pooled_embedding_matches_jax(targets, weighted, method):
    slots, ids, weights, params = _triples(1)
    tg = TARGETS[targets]
    w = weights if weighted else None
    want = ju.embedding_using_batch_segment_ids(
        _jfunc(params), jnp.asarray(slots), tg, jnp.asarray(ids),
        None if w is None else jnp.asarray(w), method=method)
    got = eu.embedding_using_batch_segment_ids(
        _func(params), _t(slots), tg, _t(ids),
        None if w is None else _t(w), method=method)
    _close(got, want)
    for name in ("embedding_using_sparse_batch_segment_ids",
                 "embedding_using_sparse_batch_segment_ids_v1"):
        assert getattr(eu, name) is eu.embedding_using_batch_segment_ids


@pytest.mark.parametrize("targets", list(TARGETS))
def test_segment_ids_match_jax(targets):
    slots = _triples(2)[0]
    tg = TARGETS[targets]
    want = ju.batch_segment_ids_of_targets(jnp.asarray(slots), tg)
    got = eu.batch_segment_ids_of_targets(_t(slots), tg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1:] == tuple(want[1:])
    jm, jflat = ju.sparse_batch_segment_ids_of_targets(jnp.asarray(slots),
                                                       tg)[:2]
    m, flat = eu.sparse_batch_segment_ids_of_targets(_t(slots), tg)[:2]
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(eu.isin(_t(slots), tg).numpy(),
                                  np.asarray(ju.isin(jnp.asarray(slots),
                                                     tg)))
    np.testing.assert_array_equal(
        eu.mask_values(_t(slots), tg, padding_value=-7).numpy(),
        np.asarray(ju.mask_values(jnp.asarray(slots), tg,
                                  padding_value=-7)))
    for need_sort in (False, True):
        np.testing.assert_array_equal(
            eu.first_occurance_in_row(_t(slots), need_sort, -1).numpy(),
            np.asarray(ju.first_occurance_in_row(jnp.asarray(slots),
                                                 need_sort, -1)))


def test_targets_the_dtype_cannot_hold_match_nothing():
    """A fractional or out-of-range target matches no integer slot, as
    JAX's compare after promotion finds none; a float slot matches."""
    slots = _t([[1, 2, 3]])
    np.testing.assert_array_equal(eu.isin(slots, [1.5, 2 ** 40, 3]).numpy(),
                                  [[False, False, True]])
    np.testing.assert_array_equal(
        eu.isin(slots.to(torch.int32), [2 ** 40]).numpy(),
        [[False, False, False]])
    np.testing.assert_array_equal(
        eu.isin(_t(np.array([[0.5, 2.0]], np.float32)), [0.5]).numpy(),
        np.asarray(ju.isin(jnp.asarray([[0.5, 2.0]], jnp.float32), [0.5])))


@pytest.mark.parametrize("ncols", [3, 12, 20])
@pytest.mark.parametrize("default_weight", [0.0, -1.5])
def test_single_slot_matches_jax(ncols, default_weight):
    """ncols 3 cuts the all-slot-3 row off, 20 pads past C."""
    slots, ids, weights, params = _triples(3)
    want = ju.embedding_single_slot(
        _jfunc(params), jnp.asarray(slots), 3, jnp.asarray(ids),
        jnp.asarray(weights), default_weight=default_weight, ncols=ncols)
    got = eu.embedding_single_slot(
        _func(params), _t(slots), 3, _t(ids), _t(weights),
        default_weight=default_weight, ncols=ncols)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.bool
    # no weights
    got = eu.embedding_single_slot(_func(params), _t(slots), 3, _t(ids),
                                   ncols=ncols)
    assert got[1] is None
    _close(got[0], want[0])


@pytest.mark.parametrize("method", ["sum", "mean"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("int_weights", [False, True])
def test_pool_slots_matches_jax(method, drop, int_weights):
    """Integer weights under mean give floats on both sides."""
    slots, ids, weights, _ = _triples(4)
    slots[2, :4] = [1, 2, 1, 1]      # 1 is repeated adjacent and not
    if int_weights:
        weights = (weights * 10).astype(np.int32)
    tg = TARGETS["duplicate"] + [1]
    want = ju.pool_slots(jnp.asarray(slots), tg, jnp.asarray(ids),
                         jnp.asarray(weights), method=method,
                         drop_duplicate_slot=drop)
    got = eu.pool_slots(_t(slots), tg, _t(ids), _t(weights), method=method,
                        drop_duplicate_slot=drop)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].is_floating_point() == (method == "mean" or
                                          not int_weights)
    _close(got[1], want[1])
    # slots [1, 2, 1, 1]: drop_duplicate_slot keeps both runs of 1
    row = eu.pool_slots(_t(slots[2:3]), [1], None, _t(np.ones((1, 12))),
                        drop_duplicate_slot=True)[1]
    assert float(row) == 2.0 + float((slots[2, 4:] == 1).sum())


def test_pool_slots_1d_and_float_ids_match_jax():
    slots, ids, weights = (a[5] for a in _triples(5)[:3])
    fids = ids.astype(np.float32) + 0.25
    for a in (ids, fids):
        want = ju.pool_slots(jnp.asarray(slots), [1, 4, 6], jnp.asarray(a),
                             jnp.asarray(weights))
        got = eu.pool_slots(_t(slots), [1, 4, 6], _t(a), _t(weights))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1], want[1])
    with pytest.raises(ValueError):
        eu.pool_slots(_t(np.zeros((2, 2, 2))), [1])


def test_pool_single_and_fetch_single_slot_match_jax():
    slots, ids, weights, _ = _triples(6)
    with pytest.warns(UserWarning):
        want = ju.pool_single_slot(jnp.asarray(slots), 5, jnp.asarray(ids),
                                   jnp.asarray(weights))
    with pytest.warns(UserWarning):
        got = eu.pool_single_slot(_t(slots), 5, _t(ids), _t(weights))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])
    for ncols in (2, 12, 15):
        want = ju.fetch_single_slot(jnp.asarray(slots), 3, jnp.asarray(ids),
                                    jnp.asarray(weights), default_id=-3,
                                    default_weight=0.5, ncols=ncols)
        got = eu.fetch_single_slot(_t(slots), 3, _t(ids), _t(weights),
                                   default_id=-3, default_weight=0.5,
                                   ncols=ncols)
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1], want[1])
    with pytest.raises(ValueError):
        eu.fetch_single_slot(_t(slots), 3, _t(ids))


def test_fetch_single_slot_keeps_ids_past_2_24_exact():
    """JAX sends ids through float32: 16,777,217 comes back 16,777,216
    and 2^31 - 2 as 2^31 - 1 (its cast saturates).  The port keeps them;
    below 2^24 both agree."""
    slots = np.array([[1, 2, 1, 1]], np.int32)
    ids = np.array([[16_777_217, 5, 2 ** 31 - 2, 16_777_215]], np.int32)
    want = np.asarray(ju.fetch_single_slot(jnp.asarray(slots), 1,
                                           jnp.asarray(ids), ncols=3)[0])
    got = eu.fetch_single_slot(_t(slots), 1, _t(ids), ncols=3)[0].numpy()
    np.testing.assert_array_equal(got, [[16_777_217, 2 ** 31 - 2,
                                         16_777_215]])
    np.testing.assert_array_equal(want, [[16_777_216, 2 ** 31 - 1,
                                          16_777_215]])
    wide = _t([[2 ** 32 + 3, 7]])             # a multi-hash id past int32
    assert eu.fetch_single_slot(_t([[1, 1]]), 1, wide, ncols=2)[0].tolist() \
        == [[2 ** 32 + 3, 7]]


# -- gradients against jax.grad ------------------------------------------------

def _leaf_func(params, leaves):
    """The port's embedding_func with its output made a leaf that takes a
    gradient (the trainer's ``requires_grad_()`` pattern)."""
    inner = _func(params)

    def f(ids):
        e = inner(ids).requires_grad_()
        leaves.append(e)
        return e
    return f


@pytest.mark.parametrize("method", ["sum", "mean"])
def test_pooled_gradients_match_jax(method):
    slots, ids, weights, params = _triples(7)
    tg = TARGETS["duplicate"]
    ct = np.random.RandomState(8).randn(48, len(tg), D).astype(np.float32)

    def jloss(delta, w):
        f = lambda i: jnp.take(jnp.asarray(params), i, axis=0) + delta
        out = ju.embedding_using_batch_segment_ids(
            f, jnp.asarray(slots), tg, jnp.asarray(ids), w, method=method)
        return jnp.sum(out * ct)

    jd, jw = jax.grad(jloss, argnums=(0, 1))(
        jnp.zeros((ids.size, D), jnp.float32), jnp.asarray(weights))
    leaves = []
    w = _t(weights).requires_grad_()
    out = eu.embedding_using_batch_segment_ids(
        _leaf_func(params, leaves), _t(slots), tg, _t(ids), w, method=method)
    gd, gw = torch.autograd.grad((out * _t(ct)).sum(), [leaves[0], w])
    _close(gd, jd)
    _close(gw, jw)
    assert float(gd.abs().max()) > 0 and float(gw.abs().max()) > 0


def test_single_slot_gradients_match_jax():
    slots, ids, weights, params = _triples(9)
    ncols = 4
    rng = np.random.RandomState(10)
    ct_e = rng.randn(48, ncols, D).astype(np.float32)
    ct_w = rng.randn(48, ncols, 1).astype(np.float32)

    def jloss(delta, w):
        f = lambda i: jnp.take(jnp.asarray(params), i, axis=0) + delta
        e, wt, _ = ju.embedding_single_slot(
            f, jnp.asarray(slots), 3, jnp.asarray(ids), w,
            default_weight=0.5, ncols=ncols)
        return jnp.sum(e * ct_e) + jnp.sum(wt * ct_w)

    jd, jw = jax.grad(jloss, argnums=(0, 1))(
        jnp.zeros((ids.size, D), jnp.float32), jnp.asarray(weights))
    leaves = []
    w = _t(weights).requires_grad_()
    e, wt, _ = eu.embedding_single_slot(
        _leaf_func(params, leaves), _t(slots), 3, _t(ids), w,
        default_weight=0.5, ncols=ncols)
    gd, gw = torch.autograd.grad(
        (e * _t(ct_e)).sum() + (wt * _t(ct_w)).sum(), [leaves[0], w])
    _close(gd, jd)
    _close(gw, jw)
    assert float(gd.abs().max()) > 0 and float(gw.abs().max()) > 0
