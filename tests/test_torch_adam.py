"""Port vs JAX: lazy sparse Adam on the embedding table (kernel B10) and
the table's dense and sparse update paths.

* The port's plain ``adam_dense_pass`` against JAX ``adam_dense_pass``
  (the Pallas kernel, interpreted off the TPU) on the packed layout, at
  t = 1 and t = 1000, with untouched rows bit-equal.
* ``ShardedEmbeddingTable.apply_grads`` of both packages on
  ``make_mesh(1)``, three updates with duplicate ids and a looked-up row
  whose summed gradient is zero, for Adam and Adagrad, the port's
  ``dense`` and ``sparse`` modes each against JAX's ``dense`` and
  ``sparse`` (JAX's sparse path is its reference semantics), both
  started from the JAX init carried over by ``convert``.
* JAX's ``tests/embedding/test_adam.py`` cases on both port modes: the
  first step is ``lr * g / (|g| + eps)``, untouched rows and moments
  stay as they were, duplicates sum before the moments.
* A touched row with a zero gradient still decays its moments and moves.

f32 on both sides; gradient sums and the sparse path's set-by-delta
(``m + (m_new - m)``) round in other places: table rtol 1e-5 / atol 1e-7
(lr 0.01: each touched element moves by up to 1e-2 a step), m and v
rtol 1e-5 and atol 1e-6 of their largest value, the Adagrad accumulator
rtol 1e-6, the count exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.embedding.sharded import \
    ShardedEmbeddingTable as JaxTable
from rec_now_tpu.ops.pallas import table_update_kernel as jtk
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu_torch.convert import table_state_from_jax
from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.ops import table_update_kernel as tk

torch.set_num_threads(1)

HP = dict(b1=0.9, b2=0.999, eps=1e-7)


@pytest.mark.parametrize("v,dim", [(64, 16), (48, 8)])
@pytest.mark.parametrize("t", [1, 1000])
def test_plain_pass_matches_jax_pallas_interpret(v, dim, t):
    rng = np.random.RandomState(v + dim + t)
    pack = 128 // dim
    table = rng.randn(v, dim).astype(np.float32)
    m = (rng.randn(v, dim) * 1e-2).astype(np.float32)
    vv = (rng.randn(v, dim) ** 2 * 1e-4).astype(np.float32)
    touched = np.arange(v) % 3 != 0
    g = (rng.randn(v, dim) * touched[:, None]).astype(np.float32)
    g[::5] = 0.0                    # touched rows with a zero gradient too
    cnt = touched.astype(np.float32) * 2          # JAX counts occurrences
    packed = [jnp.asarray(a.reshape(v // pack, pack * dim))
              for a in (table, m, vv, g)]
    jt, jm, jv = jtk.adam_dense_pass(
        *packed, jnp.asarray(cnt.reshape(v // pack, pack)),
        jnp.asarray(t, jnp.int32), lr=0.01, pack=pack, dim=dim, **HP)
    got = [torch.from_numpy(a.copy()) for a in (table, m, vv)]
    tk.adam_dense_pass(*got, torch.from_numpy(g),
                       torch.from_numpy(touched),
                       torch.tensor(t, dtype=torch.int32), 0.01, **HP)
    for name, a, b, before in zip("tmv", got, (jt, jm, jv),
                                  (table, m, vv)):
        want = np.asarray(b).reshape(v, dim)
        np.testing.assert_allclose(a.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
        np.testing.assert_array_equal(a.numpy()[~touched],
                                      before[~touched])
        assert not np.array_equal(a.numpy()[touched], before[touched])


VOCAB, DIM, LR = 512, 8, 0.01


def _updates():
    """Three batches of (32, 4) ids over 40 rows (duplicates); row 5 is
    looked up by every batch with a zero summed gradient from the second
    on, row 7 is looked up once, in the first."""
    rng = np.random.RandomState(0)
    out = []
    for step in range(3):
        ids = rng.randint(8, 40, size=(32, 4)).astype(np.int32)
        grads = (rng.randn(32, 4, DIM) * 0.1).astype(np.float32)
        ids[0, :2] = 5
        if step:
            grads[0, 1] = -grads[0, 0]    # row 5's two occurrences cancel
        else:
            ids[1, 0] = 7
        out.append((ids, grads))
    return out


def _check_state(got, jtable, jstate, optimizer):
    every = np.arange(VOCAB)

    def read(a):
        return jtable.debug_read(jax.device_get(a), every)

    want_t = read(jstate.table)
    np.testing.assert_allclose(got.table.numpy(), want_t, rtol=1e-5,
                               atol=1e-7)
    if optimizer == "adagrad":
        np.testing.assert_allclose(got.accumulator.numpy(),
                                   read(jstate.accumulator), rtol=1e-6)
        return
    for name in ("m", "v"):
        want = read(getattr(jstate, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), want,
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    assert int(got.count) == int(jstate.count) == 3


@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("jax_mode", ["dense", "sparse"])
def test_apply_grads_matches_jax_one_shard(optimizer, mode, jax_mode):
    jtable = JaxTable(VOCAB, DIM, make_mesh(1), optimizer=optimizer,
                      update_mode=jax_mode)
    jstate = jtable.init(jax.random.PRNGKey(3))
    table = ShardedEmbeddingTable(VOCAB, DIM, device="cpu",
                                  optimizer=optimizer, update_mode=mode)
    state = table_state_from_jax(jax.device_get(jstate), 1, DIM)
    start = state.table.clone()
    for ids, grads in _updates():
        jstate = jtable.apply_grads(jstate, jnp.asarray(ids),
                                    jnp.asarray(grads), lr=LR)
        state = table.apply_grads(state, torch.from_numpy(ids).long(),
                                  torch.from_numpy(grads), lr=LR)
    _check_state(state, jtable, jstate, optimizer)
    looked_up = np.zeros(VOCAB, bool)
    looked_up[np.concatenate([i.ravel() for i, _ in _updates()])] = True
    moved = (state.table != start).any(dim=1).numpy()
    np.testing.assert_array_equal(moved, looked_up)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_jax_adam_cases(mode):
    """tests/embedding/test_adam.py's three formula cases."""
    table = ShardedEmbeddingTable(64, 4, device="cpu", optimizer="adam",
                                  update_mode=mode)
    s = table.init(torch.Generator().manual_seed(0))
    before = s.table.clone()
    ids = torch.tensor([3, 10])
    g = torch.tensor([[1.0, 0, 0, 0], [0, 2.0, 0, 0]])
    s = table.apply_grads(s, ids, g, lr=0.1)
    assert int(s.count) == 1
    # step 1: mhat = g, vhat = g^2 -> update = lr * g / (|g| + eps)
    torch.testing.assert_close(s.table[ids],
                               before[ids] - 0.1 * g / (g.abs() + 1e-7),
                               rtol=1e-4, atol=1e-6)
    others = torch.tensor([i for i in range(64) if i not in (3, 10)])
    assert torch.equal(s.table[others], before[others])
    assert not s.m[others].any() and not s.v[others].any()
    assert s.m[3].any()
    # duplicates sum before the moments: row grad [2, 0] -> m = 0.2
    table2 = ShardedEmbeddingTable(64, 2, device="cpu", optimizer="adam",
                                   update_mode=mode)
    s2 = table2.apply_grads(table2.init(torch.Generator()),
                            torch.tensor([7, 7]),
                            torch.tensor([[1.0, 0.0], [1.0, 0.0]]), lr=0.1)
    torch.testing.assert_close(s2.m[7], torch.tensor([0.2, 0.0]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_touched_row_with_zero_gradient_decays_and_moves(mode):
    """The touched flag comes from the ids, not from the gradient: a row
    looked up with a zero summed gradient decays m and v and still moves
    by lr * m_hat / (sqrt(v_hat) + eps); a flag made from g != 0 would
    leave it as it was."""
    table = ShardedEmbeddingTable(16, 4, device="cpu", optimizer="adam",
                                  update_mode=mode)
    s = table.init(torch.Generator().manual_seed(1))
    g = torch.tensor([[0.5, -1.0, 0.25, 2.0]])
    s = table.apply_grads(s, torch.tensor([2]), g, lr=0.1)
    m1, v1, t1 = s.m[2].clone(), s.v[2].clone(), s.table[2].clone()
    s = table.apply_grads(s, torch.tensor([2, 2]),
                          torch.cat([g, -g]), lr=0.1)     # sums to zero
    torch.testing.assert_close(s.m[2], 0.9 * m1, rtol=1e-6, atol=0)
    torch.testing.assert_close(s.v[2], 0.999 * v1, rtol=1e-6, atol=0)
    mhat, vhat = 0.9 * m1 / (1 - 0.9 ** 2), 0.999 * v1 / (1 - 0.999 ** 2)
    torch.testing.assert_close(s.table[2],
                               t1 - 0.1 * mhat / (vhat.sqrt() + 1e-7),
                               rtol=1e-5, atol=1e-7)
    assert float((s.table[2] - t1).abs().min()) > 0.01


def test_auto_picks_dense_at_the_full_table():
    """``auto`` takes the dense pass at FeatureConfig()'s 2.6M x 16 table
    for both optimizers, and the sparse path past each one's limit."""
    limits = ShardedEmbeddingTable.DENSE_UPDATE_MAX_TABLE_BYTES
    for opt, limit in limits.items():
        full = ShardedEmbeddingTable(2_600_000, 16, device="cpu",
                                     optimizer=opt)
        assert full.update_mode == "dense"
        rows = limit // 64
        at = ShardedEmbeddingTable(rows, 16, device="cpu", optimizer=opt)
        assert at.update_mode == "dense"
        past = ShardedEmbeddingTable(rows + 1, 16, device="cpu",
                                     optimizer=opt)
        assert past.update_mode == "sparse"
    with pytest.raises(ValueError):
        ShardedEmbeddingTable(8, 4, device="cpu", update_mode="lazy")
