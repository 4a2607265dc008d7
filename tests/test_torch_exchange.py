"""Port vs JAX: the routed exchange's plan (``embedding/exchange.py``) and
the table's cap arithmetic, on the CPU.

``sort_dedup`` and ``plan_route`` are held bit for bit to
``rec_now_tpu/embedding/exchange.py`` (every field of the plan, the
dropped count among them) on uniform, duplicate-heavy, one-owner and tiny
ids, for n in {2, 4, 8} and caps that leave room, fill the buckets and
spill past the overflow lane; ``gather_planned`` and ``scatter_planned``
on the same plans with random rows; ``_route_caps`` and
``exchange_bytes`` against JAX's table at n in {2, 4, 8}, among them
config 2's batch of 8,192 x 26 ids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.embedding import exchange as jx
from rec_now_tpu.embedding.sharded import ShardedEmbeddingTable as JaxTable
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu_torch.embedding import exchange as tx
from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.parallel import Mesh

torch.set_num_threads(1)

KINDS = ("uniform", "duplicates", "one_owner", "tiny")
# (cap, ov_cap): room to spare, full buckets, a spill past the lane
CAPS = [(64, 16), (16, 8), (8, 8)]


def _ids(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(len(kind) * 10 + n)
    if kind == "uniform":
        return rng.integers(0, 1000, 200)
    if kind == "duplicates":
        return rng.integers(0, 17, 200)
    if kind == "one_owner":
        return rng.integers(0, 40, 200) * n
    return np.array([5, 5, 3])


_JAX_PLAN = jax.jit(jx.plan_route, static_argnums=(1, 2, 3))


def _both(kind, n, cap, ov_cap):
    ids = _ids(kind, n).astype(np.int32)
    ju, js = jx.sort_dedup(jnp.asarray(ids))
    tu, ts = tx.sort_dedup(torch.from_numpy(ids).long())
    return (ju, js, _JAX_PLAN(ju, n, cap, ov_cap)), (
        tu, ts, tx.plan_route(tu, n, cap, ov_cap))


@pytest.mark.parametrize("kind", KINDS)
def test_sort_dedup_matches_jax(kind):
    ids = _ids(kind, 4).astype(np.int32)
    ju, js = jx.sort_dedup(jnp.asarray(ids))
    tu, ts = tx.sort_dedup(torch.from_numpy(ids).long())
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    distinct = np.unique(ids)
    np.testing.assert_array_equal(tu.numpy()[:len(distinct)], distinct)
    assert (tu.numpy()[len(distinct):] == tx.BIG).all()
    np.testing.assert_array_equal(tu.numpy()[ts.numpy()], ids)


@pytest.mark.parametrize("cap,ov_cap", CAPS, ids=[f"cap{c}-ov{o}"
                                                  for c, o in CAPS])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_route_matches_jax(kind, n, cap, ov_cap):
    (_, _, jp), (_, _, tp) = _both(kind, n, cap, ov_cap)
    for name in tx.RoutePlan._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    # every distinct id is in a bucket, in the lane, or dropped
    placed = int((tp.ret_slot >= 0).sum() + (tp.ov_slot >= 0).sum())
    assert placed + int(tp.dropped) == len(np.unique(_ids(kind, n)))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_and_scatter_planned_match_jax(kind, n):
    cap, ov_cap = 8, 8
    (ju, js, jp), (tu, ts, tp) = _both(kind, n, cap, ov_cap)
    rng = np.random.default_rng(n)
    recv = rng.standard_normal((n * cap, 5)).astype(np.float32)
    ov = rng.standard_normal((ov_cap, 5)).astype(np.float32)
    got = tx.gather_planned(tp, torch.from_numpy(recv), torch.from_numpy(ov),
                            ts)
    want = jx.gather_planned(jp, jnp.asarray(recv), jnp.asarray(ov), js)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = rng.standard_normal((len(ts), 5)).astype(np.float32)
    for a, b in zip(tx.scatter_planned(tp, torch.from_numpy(vals)),
                    jx.scatter_planned(jp, jnp.asarray(vals))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("b,factor,ov_cap", [
    (8192 * 26, 2.0, None), (8192 * 26, 0.1, None), (333, 2.0, 64),
    (40, 0.25, 3)])
def test_route_caps_and_exchange_bytes_match_jax(n, b, factor, ov_cap):
    flat = b // n
    jt = JaxTable(2_600_000, 16, make_mesh(n), route_cap_factor=factor,
                  route_ov_cap=ov_cap)
    t = ShardedEmbeddingTable(2_600_000, 16,
                              mesh=Mesh(0, n, torch.device("cpu")),
                              route_cap_factor=factor, route_ov_cap=ov_cap)
    assert t._route_caps(flat) == jt._route_caps(flat)
    assert t.exchange_bytes(flat) == jt.exchange_bytes(flat)
