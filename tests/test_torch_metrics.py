"""Port vs JAX: the eval metrics of ``training/metrics.py`` on the same
numpy inputs.

The bucket histograms (``DeviceStreamingAUC``, ``DeviceGroupedAUC``)
must equal JAX's: their cells are sums of unit (or zero) weights, exact
in f32 in any order.  The rank AUC and the in-batch GAUC sums match to
f32 rounding (1e-6); the group indexer's slots, its hash mode included
(uint64 arithmetic), and the host-side metrics are the same numpy code
and must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.training import metrics as jm
from rec_now_tpu_torch.training import metrics as tm

torch.set_num_threads(1)


def _inputs(b=500, seed=0, ties=False, groups=40):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(b) < 0.3).astype(np.float32)
    scores = (rng.randn(b) * 2 + labels).astype(np.float32)
    if ties:
        scores = np.round(scores * 2) / 2
    gids = rng.randint(0, groups, b).astype(np.int32)
    return labels, scores, gids


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_auc_matches_jax(ties, weighted):
    labels, scores, _ = _inputs(ties=ties, seed=1)
    w = np.random.RandomState(2).rand(len(labels)).astype(np.float32)
    want = jm.binary_auc(jnp.asarray(labels), jnp.asarray(scores),
                         jnp.asarray(w) if weighted else None)
    got = tm.binary_auc(t(labels), t(scores), t(w) if weighted else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(tm.binary_auc(t(np.ones(5, np.float32)),
                               t(scores[:5]))) == 0.5


@pytest.mark.parametrize("ties", [False, True])
def test_batch_gauc_matches_jax(ties):
    labels, scores, gids = _inputs(b=300, ties=ties, seed=3)
    args_j = [jnp.asarray(x) for x in (labels, scores, gids)]
    args_t = [t(x) for x in (labels, scores, gids)]
    for a, b in zip(tm.batch_gauc_stats(*args_t),
                    jm.batch_gauc_stats(*args_j)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    np.testing.assert_allclose(float(tm.batch_gauc(*args_t)),
                               float(jm.batch_gauc(*args_j)), rtol=1e-6)
    # no same-group (pos, neg) pair: 0.5
    assert float(tm.batch_gauc(t(labels), t(scores),
                               t(np.arange(300)))) == 0.5


@pytest.mark.parametrize("k", [64, 4096])
def test_streaming_auc_histogram_equals_jax(k):
    labels, scores, _ = _inputs(b=2000, seed=4)
    w = (np.arange(2000) % 5 != 0).astype(np.float32)     # 0 = ignored
    want = jnp.zeros((2, k))
    got = torch.zeros(2, k)
    for lo in range(0, 2000, 500):
        sl = slice(lo, lo + 500)
        want = jm.DeviceStreamingAUC.accumulate(
            want, jnp.asarray(labels[sl]), jnp.asarray(scores[sl]),
            jnp.asarray(w[sl]))
        tm.DeviceStreamingAUC.accumulate(got, t(labels[sl]), t(scores[sl]),
                                         t(w[sl]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tm.DeviceStreamingAUC.auc_from_hist(got.numpy()) == \
        jm.DeviceStreamingAUC.auc_from_hist(np.asarray(want))
    ours = tm.DeviceStreamingAUC(k, device="cpu")
    theirs = jm.DeviceStreamingAUC(k)
    for lo in range(0, 2000, 1000):
        ours.update(labels[lo:lo + 1000], scores[lo:lo + 1000])
        theirs.update(labels[lo:lo + 1000], scores[lo:lo + 1000])
    assert ours.result() == theirs.result()


@pytest.mark.parametrize("k", [64, 512])
def test_grouped_auc_matches_jax(k):
    labels, scores, gids = _inputs(b=1500, seed=5, groups=70)
    g = 64                                  # ids past it clamp into slot 63
    w = (np.arange(1500) % 7 != 0).astype(np.float32)
    want = jm.DeviceGroupedAUC.init(g, k)
    got = tm.DeviceGroupedAUC.init(g, k, device="cpu")
    for lo in range(0, 1500, 500):
        sl = slice(lo, lo + 500)
        want = jm.DeviceGroupedAUC.accumulate(
            want, jnp.asarray(gids[sl]), jnp.asarray(labels[sl]),
            jnp.asarray(scores[sl]), k, weights=jnp.asarray(w[sl]))
        tm.DeviceGroupedAUC.accumulate(got, t(gids[sl]), t(labels[sl]),
                                       t(scores[sl]), k, weights=t(w[sl]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stats = tm.DeviceGroupedAUC.finish(got).numpy()
    jstats = np.asarray(jm.DeviceGroupedAUC.finish(want))
    np.testing.assert_allclose(stats, jstats, rtol=1e-6)
    for by in ("pairs", "impressions"):
        assert tm.DeviceGroupedAUC.gauc_from_stats(jstats, by) == \
            jm.DeviceGroupedAUC.gauc_from_stats(jstats, by)
        assert tm.DeviceGroupedAUC.gauc_from_hist(got.numpy(), k, by) == \
            jm.DeviceGroupedAUC.gauc_from_hist(np.asarray(want), k, by)


@pytest.mark.parametrize("use_hash", [False, True])
def test_corpus_group_indexer_matches_jax(use_hash):
    rng = np.random.RandomState(6)
    ours = tm.CorpusGroupIndexer(64, use_hash=use_hash)
    theirs = jm.CorpusGroupIndexer(64, use_hash=use_hash)
    for _ in range(4):                      # 80 groups: dict mode spills
        g = rng.randint(0, 80, 100) * 7919 + 3
        np.testing.assert_array_equal(ours.assign(g), theirs.assign(g))
    assert ours.overflowed == theirs.overflowed > 0
    big = np.array([2 ** 40 + 5, 2 ** 62 + 11, 0], np.int64)
    if use_hash:                            # uint64 wrap-around, bit-exact
        np.testing.assert_array_equal(ours.assign(big), theirs.assign(big))


@pytest.mark.parametrize("weight_by", ["pairs", "impressions"])
def test_streaming_gauc_matches_jax(weight_by):
    ours = tm.StreamingGAUC(weight_by)
    theirs = jm.StreamingGAUC(weight_by)
    for seed in range(3):
        labels, scores, gids = _inputs(b=200, seed=seed, ties=seed == 1)
        ours.update(t(gids), t(labels), t(scores))
        theirs.update(gids, labels, scores)
    assert ours.result() == theirs.result()
    with pytest.raises(ValueError):
        tm.StreamingGAUC("clicks")
