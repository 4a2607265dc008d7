"""Port vs JAX: the dense Adagrad pass and the one-device table update.

The port's plain ``adagrad_dense_pass`` against JAX
``adagrad_dense_pass`` (the Pallas kernel, interpreted off the TPU) on
the same rows, and the port's ``ShardedEmbeddingTable.apply_grads``
against JAX ``ShardedEmbeddingTable.apply_grads`` on ``make_mesh(1)``
(dense-apply Adagrad, read back through ``debug_read``) after 3 updates
with duplicate ids, both started from the JAX init carried over by
``convert``.  f32 on both sides; the row means and sums run in another
order: rtol 1e-6 on the accumulators, rtol 1e-5 / atol 1e-7 on the rows.
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
from rec_now_tpu_torch.convert import acc_from_packed, table_from_packed
from rec_now_tpu_torch.embedding.sharded import (ShardedEmbeddingTable,
                                                 ShardedTableState)
from rec_now_tpu_torch.ops import table_update_kernel as tk

torch.set_num_threads(1)


@pytest.mark.parametrize("v,dim", [(64, 16), (48, 8)])
def test_plain_pass_matches_jax_pallas_interpret(v, dim):
    rng = np.random.RandomState(v + dim)
    pack = 128 // dim
    table = rng.randn(v, dim).astype(np.float32)
    acc = (np.abs(rng.randn(v)) * 0.1).astype(np.float32)
    g = (rng.randn(v, dim) * (np.arange(v)[:, None] % 3 == 0)
         ).astype(np.float32)                       # most rows untouched
    # JAX's layout: pack consecutive rows per 128-lane line
    jt, ja = jtk.adagrad_dense_pass(
        jnp.asarray(table.reshape(v // pack, pack * dim)),
        jnp.asarray(acc.reshape(v // pack, pack)),
        jnp.asarray(g.reshape(v // pack, pack * dim)), lr=0.05, pack=pack,
        dim=dim)
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    tk.adagrad_dense_pass(t, a, torch.from_numpy(g), 0.05)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja).reshape(v),
                               rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt).reshape(v, dim),
                               rtol=1e-5, atol=1e-7)
    untouched = np.arange(v) % 3 != 0
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


def test_apply_grads_matches_jax_one_shard():
    vocab, dim, lr = 512, 8, 0.05
    jtable = JaxTable(vocab, dim, make_mesh(1), update_mode="dense")
    jstate = jtable.init(jax.random.PRNGKey(3))
    table = ShardedEmbeddingTable(vocab, dim, device="cpu")
    state = ShardedTableState(
        table_from_packed(jax.device_get(jstate.table), 1, dim),
        acc_from_packed(jax.device_get(jstate.accumulator), 1))
    rng = np.random.RandomState(0)
    for _ in range(3):
        ids = rng.randint(0, 40, size=(32, 4)).astype(np.int32)  # repeats
        grads = (rng.randn(32, 4, dim) * 0.1).astype(np.float32)
        jstate = jtable.apply_grads(jstate, jnp.asarray(ids),
                                    jnp.asarray(grads), lr=lr)
        state = table.apply_grads(state, torch.from_numpy(ids).long(),
                                  torch.from_numpy(grads), lr=lr)
    every = np.arange(vocab)
    np.testing.assert_allclose(
        state.accumulator.numpy(),
        jtable.debug_read(jax.device_get(jstate.accumulator), every),
        rtol=1e-6)
    np.testing.assert_allclose(
        state.table.numpy(),
        jtable.debug_read(jax.device_get(jstate.table), every),
        rtol=1e-5, atol=1e-7)
    assert float(state.accumulator[:40].min()) > 0.1      # touched rows
    torch.testing.assert_close(state.accumulator[40:],
                               torch.full((vocab - 40,), 0.1))
