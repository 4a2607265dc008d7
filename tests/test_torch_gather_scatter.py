"""Port vs JAX: the row gather (kernel B11) and the row scatter-add (kernel
B12) by their plain versions on the CPU, and the table paths through them.

* ``gather_rows`` against ``packed_gather`` (the Pallas kernel,
  interpreted off the TPU) on a lane-packed table that
  ``convert.table_from_packed`` reads into the port's (V, D) layout, at
  N = 1,500 ids (ragged against the kernel's 1,024-row chunk); ids out of
  range clamp as the kernel's physical row does (at ``pack=1`` the same
  thing).  Exact: a gather moves values.
* ``scatter_add_rows`` against ``expand_lines`` followed by the
  ``.at[pr].add`` of ``_scatter_dense_grads`` (and of the sparse
  write-backs, into a non-zero table), reshaped to (V, D): duplicate ids
  sum, ids past the table are dropped as JAX's scatter drops its sentinel
  rows.  Both add in index order on the CPU; held to 1e-6 of each
  element's summed |vals| (the scale of an f32 sum's rounding).
* The table's lookup and its dense and sparse updates, both optimizers,
  against the JAX table on ``make_mesh(1)``, counting the B11 / B12
  calls each path makes (the kernel launches it makes on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.embedding.sharded import ShardedEmbeddingTable as JaxTable
from rec_now_tpu.ops.pallas.expand_kernel import expand_lines
from rec_now_tpu.ops.pallas.gather_kernel import packed_gather
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu_torch import convert
from rec_now_tpu_torch.embedding import sharded, table
from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.ops.expand_kernel import (scatter_add_rows,
                                                 scatter_add_rows_plain)
from rec_now_tpu_torch.ops.gather_kernel import (gather_rows,
                                                 gather_rows_plain)

torch.set_num_threads(1)


@pytest.mark.parametrize("pack,dim", [(8, 16), (4, 32)])
def test_gather_matches_packed_gather_interpreted(pack, dim):
    rng = np.random.RandomState(pack)
    vp = 64
    packed = rng.randn(vp, pack * dim).astype(np.float32)
    logical = convert.table_from_packed(packed, 1, dim)      # (V, D)
    rows = rng.randint(0, vp * pack, 1500).astype(np.int32)
    want = np.asarray(packed_gather(jnp.asarray(packed), jnp.asarray(rows),
                                    pack=pack, dim=dim))
    for dtype in (torch.int32, torch.int64):
        got = gather_rows(logical, torch.from_numpy(rows).to(dtype))
        assert got.shape == (1500, dim)
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_clamps_out_of_range_ids_as_packed_gather_at_pack_1():
    rng = np.random.RandomState(5)
    v, dim = 40, 16
    tab = rng.randn(v, dim).astype(np.float32)
    rows = np.array([-7, -1, 0, 5, v - 1, v, v + 3, 10 ** 6], np.int32)
    want = np.asarray(packed_gather(jnp.asarray(tab), jnp.asarray(rows),
                                    pack=1, dim=dim))
    got = gather_rows(torch.from_numpy(tab), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[[0, 1, 5, 6, 7]],
                                  tab[[0, 0, v - 1, v - 1, v - 1]])


def test_gather_keeps_the_ids_shape():
    tab = torch.randn(30, 4)
    ids = torch.randint(0, 30, (5, 3, 2))
    got = gather_rows(tab, ids)
    assert got.shape == (5, 3, 2, 4)
    torch.testing.assert_close(got, tab[ids], rtol=0, atol=0)
    assert gather_rows(tab, ids[:0]).shape == (0, 3, 2, 4)


def _jax_scatter(base, ids, vals, pack, dim):
    """expand_lines + ``.at[pr].add`` on the packed layout, read back as
    (V, D)."""
    off = jnp.asarray(ids % pack, jnp.int32)
    lines = expand_lines(jnp.asarray(vals), off, pack=pack, dim=dim,
                         out_dtype=jnp.float32, tile=1024)
    packed = jnp.asarray(base.reshape(-1, pack * dim))
    out = packed.at[jnp.asarray(ids // pack)].add(lines)
    return np.asarray(convert.table_from_packed(np.asarray(out), 1, dim))


@pytest.mark.parametrize("start", ["zeros", "table"])
@pytest.mark.parametrize("pack,dim", [(8, 16), (4, 32)])
def test_scatter_matches_expand_lines_and_scatter(start, pack, dim):
    rng = np.random.RandomState(pack + dim)
    v = 64 * pack
    base = (np.zeros((v, dim), np.float32) if start == "zeros"
            else rng.randn(v, dim).astype(np.float32))
    ids = rng.randint(0, v, 1300)
    ids[::4] = ids[0]                        # one row hit ~325 times
    ids[1::9] = np.resize([v, v + 5, 10 ** 6], 145)  # past: dropped
    vals = rng.randn(1300, dim).astype(np.float32)
    want = _jax_scatter(base, ids, vals, pack, dim)
    got = scatter_add_rows(torch.from_numpy(base.copy()),
                           torch.from_numpy(ids), torch.from_numpy(vals))
    keep = ids < v
    scale = np.zeros((v, dim), np.float32)
    np.add.at(scale, ids[keep], np.abs(vals[keep]))
    scale += np.abs(base)
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * scale.max())
    hit = np.zeros(v, bool)
    hit[ids[keep]] = True
    np.testing.assert_array_equal(got.numpy()[~hit], base[~hit])
    assert np.abs(got.numpy()[hit] - base[hit]).max() > 1e-3


def test_scatter_drops_negative_ids_and_returns_out():
    out = torch.zeros(6, 2)
    ids = torch.tensor([-1, 2, 2, 6, 0])
    vals = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    assert scatter_add_rows(out, ids, vals) is out
    want = torch.zeros(6, 2)
    want[2] = vals[1] + vals[2]
    want[0] = vals[4]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


VOCAB, DIM, LR = 48, 8, 0.01


def _counting(monkeypatch):
    """Count the calls of B11 and B12 from the table's modules."""
    calls = {"gather_rows": 0, "scatter_add_rows": 0}

    def wrap(name, fn):
        def counted(*a):
            calls[name] += 1
            return fn(*a)
        return counted

    monkeypatch.setattr(table, "gather_rows",
                        wrap("gather_rows", gather_rows_plain))
    monkeypatch.setattr(sharded, "gather_rows",
                        wrap("gather_rows", gather_rows_plain))
    for module in (table, sharded):
        monkeypatch.setattr(module, "scatter_add_rows",
                            wrap("scatter_add_rows", scatter_add_rows_plain))
    return calls


# calls per step (a lookup and an update): the launches on the card
PER_STEP = {("adagrad", "dense"): (1, 1), ("adam", "dense"): (1, 1),
            ("adagrad", "sparse"): (1, 2), ("adam", "sparse"): (3, 4)}


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_table_paths_match_jax_and_count_b11_b12(monkeypatch, optimizer,
                                                  mode):
    jtable = JaxTable(VOCAB, DIM, make_mesh(1), optimizer=optimizer,
                      update_mode=mode)
    jstate = jtable.init(jax.random.PRNGKey(4))
    port = ShardedEmbeddingTable(VOCAB, DIM, device="cpu",
                                 optimizer=optimizer, update_mode=mode)
    state = convert.table_state_from_jax(jax.device_get(jstate), 1, DIM)
    calls = _counting(monkeypatch)
    rng = np.random.RandomState(9)
    for step in range(3):
        ids = rng.randint(0, VOCAB, size=(32, 4)).astype(np.int32)
        ids[:8, 0] = 3                            # duplicates
        grads = (rng.randn(32, 4, DIM) * 0.1).astype(np.float32)
        # exact on the carried-over table, then within the update's
        # rounding
        np.testing.assert_allclose(
            port.lookup(state, torch.from_numpy(ids)).numpy(),
            np.asarray(jtable.lookup(jstate, jnp.asarray(ids))),
            rtol=1e-5 if step else 0, atol=1e-7 if step else 0)
        jstate = jtable.apply_grads(jstate, jnp.asarray(ids),
                                    jnp.asarray(grads), lr=LR)
        state = port.apply_grads(state, torch.from_numpy(ids),
                                 torch.from_numpy(grads), lr=LR)
    g, s = PER_STEP[optimizer, mode]
    assert calls == {"gather_rows": 3 * g, "scatter_add_rows": 3 * s}
    every = np.arange(VOCAB)

    def read(a):
        return jtable.debug_read(jax.device_get(a), every)

    np.testing.assert_allclose(state.table.numpy(), read(jstate.table),
                               rtol=1e-5, atol=1e-7)
    if optimizer == "adagrad":
        np.testing.assert_allclose(state.accumulator.numpy(),
                                   read(jstate.accumulator), rtol=1e-6)
    else:
        for name in ("m", "v"):
            want = read(getattr(jstate, name))
            np.testing.assert_allclose(getattr(state, name).numpy(), want,
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())
