"""Port vs JAX: the table's leftovers.

* ``EmbeddingTable`` (one table): ``embedding_func`` (one B11 call a
  call), ``state_from`` and ``apply_grads`` (row-wise Adagrad, sort-dedup,
  ``valid_mask``) against JAX's ``EmbeddingTable`` on
  ``tests/embedding/test_table.py``'s cases (untouched rows, duplicates,
  ``valid_mask``, the 50-step fit) and on random masked batches, from
  JAX's initial state; an update is two B12 calls and no B9.
* ``initial_accumulator=0``: a row reached only by masked occurrences is
  NaN in JAX (``lr / sqrt(0) * 0``, ``table.py:128``) and does not move
  in the port, which clamps the accumulator at 1e-12 as JAX's sharded
  update does.
* ``ShardedEmbeddingTable.apply_grads(..., valid_mask, dedup)`` against
  JAX's on ``make_mesh(1)``: both update modes, both optimizers, a row
  hammered eight times in a batch (``tests/embedding/test_dedup_modes.py``'s
  per-occurrence formula), Adam ignoring ``dedup``, a masked-only row
  under Adam that still decays and moves; per-occurrence Adagrad takes
  the sparse body (one B12 call, no B9) in dense mode too.
* The same on two gloo processes (``tests/torch_mp_worker.py``) against
  JAX's table on ``make_mesh(2)``, with ``route_mode="routed"``, which
  ``dedup=False`` forces onto the allgather exchange as JAX does (routing
  would pre-sum the duplicates, and the accumulators would differ), and
  ``export_table_rows`` of each process's ids, a collective lookup.
* ``serving.export_table_rows``, ``losses.bce_loss`` and
  ``FeatureConfig.field_offsets`` against JAX.

f32 on both sides: tables rtol 1e-5 / atol 1e-7, accumulators and
moments rtol 1e-6 (moments atol 1e-6 of their largest value), as
``tests/test_torch_adam.py``; lookups exact; losses rtol 1e-6.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.embedding import EmbeddingTable as JaxOneTable
from rec_now_tpu.embedding.sharded import ShardedEmbeddingTable as JaxTable
from rec_now_tpu.losses import bce_loss as jax_bce
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.serving import export_table_rows as jax_export
from rec_now_tpu_torch.convert import table_state_from_jax
from rec_now_tpu_torch.embedding import sharded, table
from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.embedding.table import (EmbeddingTable,
                                               EmbeddingTableState)
from rec_now_tpu_torch.losses import bce_loss
from rec_now_tpu_torch.models import FeatureConfig
from rec_now_tpu_torch.ops import table_update_kernel
from rec_now_tpu_torch.ops.expand_kernel import scatter_add_rows_plain
from rec_now_tpu_torch.ops.gather_kernel import gather_rows_plain
from rec_now_tpu_torch.serving import ServingState, export_table_rows
from tests.torch_mp_worker import spawn

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def _one_state(jtable, jstate, port):
    """The port's state from JAX's, through ``state_from``."""
    got = port.state_from(torch.from_numpy(np.array(jstate.table)))
    np.testing.assert_array_equal(got.accumulator.numpy(),
                                  np.asarray(jstate.accumulator))
    return got


def _check_one(got, jstate):
    np.testing.assert_allclose(got.table.numpy(), np.asarray(jstate.table),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.accumulator.numpy(),
                               np.asarray(jstate.accumulator), rtol=1e-6)


def _counting(monkeypatch):
    """Count B11 / B12 calls from the table modules and refuse B9."""
    calls = {"gather_rows": 0, "scatter_add_rows": 0}

    def wrap(name, fn):
        def counted(*a):
            calls[name] += 1
            return fn(*a)
        return counted

    for module in (table, sharded):
        monkeypatch.setattr(module, "gather_rows",
                            wrap("gather_rows", gather_rows_plain))
        monkeypatch.setattr(module, "scatter_add_rows",
                            wrap("scatter_add_rows", scatter_add_rows_plain))

    def no_dense_pass(*a, **k):
        raise AssertionError("the dense Adagrad pass (B9) ran")
    monkeypatch.setattr(table_update_kernel, "adagrad_dense_pass",
                        no_dense_pass)
    return calls


# -- the one table -------------------------------------------------------------

def test_one_table_lookup_and_embedding_func(monkeypatch):
    jt = JaxOneTable(vocab_size=100, dim=4)
    js = jt.init(KEY)
    port = EmbeddingTable(100, 4, device="cpu")
    state = _one_state(jt, js, port)
    calls = _counting(monkeypatch)
    ids = np.array([[1, 2], [3, 1]])
    np.testing.assert_array_equal(
        port.lookup(state.table, torch.from_numpy(ids)).numpy(),
        np.asarray(jt.lookup(js, jnp.asarray(ids))))
    for arg in (state, state.table):
        f = port.embedding_func(arg)
        out = f(torch.tensor([0, 5, 99]))
        assert out.shape == (3, 4)
        np.testing.assert_array_equal(
            out.numpy(),
            np.asarray(jt.embedding_func(js)(jnp.array([0, 5, 99]))))
    assert calls == {"gather_rows": 3, "scatter_add_rows": 0}


def test_one_table_untouched_rows_and_duplicates_match_jax(monkeypatch):
    """test_table.py's untouched-rows and duplicate cases; an update is
    two B12 calls (the segment sums, the write-back) and no B9."""
    jt = JaxOneTable(vocab_size=50, dim=4)
    js = jt.init(KEY)
    port = EmbeddingTable(50, 4, device="cpu")
    state = _one_state(jt, js, port)
    before = state.table.clone()
    calls = _counting(monkeypatch)
    ids = np.array([3, 7, 3])
    grads = np.ones((3, 4), np.float32)
    js = jt.apply_grads(js, jnp.asarray(ids), jnp.asarray(grads), lr=0.1)
    assert port.apply_grads(state, torch.from_numpy(ids),
                            torch.from_numpy(grads), 0.1) is state
    assert calls == {"gather_rows": 0, "scatter_add_rows": 2}
    _check_one(state, js)
    others = np.ones(50, bool)
    others[[3, 7]] = False
    np.testing.assert_array_equal(state.table.numpy()[others],
                                  before.numpy()[others])
    np.testing.assert_array_equal(state.accumulator.numpy()[others],
                                  np.float32(0.1))
    # duplicates sum first: row grad [2, 0], acc 0.1 + mean([4, 0])
    jt2 = JaxOneTable(vocab_size=10, dim=2, initial_accumulator=0.1)
    js2 = jt2.init(KEY)
    port2 = EmbeddingTable(10, 2, device="cpu", initial_accumulator=0.1)
    s2 = _one_state(jt2, js2, port2)
    start = s2.table[3].clone()
    g = np.array([[1.0, 0.0], [1.0, 0.0]], np.float32)
    js2 = jt2.apply_grads(js2, jnp.array([3, 3]), jnp.asarray(g), lr=0.1)
    port2.apply_grads(s2, torch.tensor([3, 3]), torch.from_numpy(g), 0.1)
    _check_one(s2, js2)
    assert float(s2.accumulator[3]) == pytest.approx(2.1, rel=1e-6)
    torch.testing.assert_close(
        s2.table[3], start - 0.1 / np.sqrt(2.1) * torch.tensor([2.0, 0.0]),
        rtol=1e-5, atol=1e-7)


def test_one_table_valid_mask_matches_jax():
    jt = JaxOneTable(vocab_size=10, dim=2)
    js = jt.init(KEY)
    port = EmbeddingTable(10, 2, device="cpu")
    state = _one_state(jt, js, port)
    before = state.table.clone()
    mask = np.array([True, False])
    js = jt.apply_grads(js, jnp.array([1, 2]), jnp.ones((2, 2)), lr=0.1,
                        valid_mask=jnp.asarray(mask))
    port.apply_grads(state, torch.tensor([1, 2]), torch.ones(2, 2), 0.1,
                     valid_mask=torch.from_numpy(mask))
    _check_one(state, js)
    assert not torch.equal(state.table[1], before[1])
    assert torch.equal(state.table[2], before[2])


@pytest.mark.parametrize("acc0", [0.1, 0.5])
def test_one_table_random_masked_batches_match_jax(acc0):
    """Three batches of (16, 4) ids over 30 rows with duplicates, a mask
    dropping about a quarter, from JAX's init."""
    jt = JaxOneTable(vocab_size=64, dim=8, initial_accumulator=acc0)
    js = jt.init(jax.random.PRNGKey(5))
    port = EmbeddingTable(64, 8, device="cpu", initial_accumulator=acc0)
    state = _one_state(jt, js, port)
    rng = np.random.RandomState(acc0 > 0.2)
    for _ in range(3):
        ids = rng.randint(0, 30, size=(16, 4))
        grads = (rng.randn(16, 4, 8) * 0.1).astype(np.float32)
        mask = rng.rand(16, 4) > 0.25
        js = jt.apply_grads(js, jnp.asarray(ids), jnp.asarray(grads),
                            lr=0.05, valid_mask=jnp.asarray(mask))
        port.apply_grads(state, torch.from_numpy(ids),
                         torch.from_numpy(grads), 0.05,
                         valid_mask=torch.from_numpy(mask))
        _check_one(state, js)


def test_one_table_training_reduces_loss_as_jax():
    """test_table.py's 50-step fit: each step's loss equal to JAX's, the
    last below a fifth of the first."""
    jt = JaxOneTable(vocab_size=20, dim=4, initializer_scale=0.1)
    js = jt.init(KEY)
    port = EmbeddingTable(20, 4, device="cpu", initializer_scale=0.1)
    state = _one_state(jt, js, port)
    ids = np.array([0, 5, 9, 5])
    target = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 4)))

    @jax.jit
    def step(s):
        emb = jt.lookup(s, jnp.asarray(ids))
        loss, grad = jax.value_and_grad(
            lambda e: jnp.mean((e - target) ** 2))(emb)
        return jt.apply_grads(s, jnp.asarray(ids), grad, lr=0.5), loss

    f = port.embedding_func(state)
    losses = []
    for _ in range(50):
        js, jloss = step(js)
        emb = f(torch.from_numpy(ids)).requires_grad_()
        loss = ((emb - torch.from_numpy(target)) ** 2).mean()
        grad, = torch.autograd.grad(loss, emb)
        port.apply_grads(state, torch.from_numpy(ids), grad, 0.5)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2
    _check_one(state, js)


def test_zero_initial_accumulator_nan_in_jax_not_in_port():
    """Row 4 is reached only by masked occurrences: JAX's one-table
    update scales its zero gradient by lr / sqrt(0) and writes NaN.  So
    does row 0, which no id reaches: JAX's unused dedup segments (the
    duplicate 4 leaves one) carry row 0 with a zero gradient
    (``table.py:119-128``).  The port clamps the accumulator at 1e-12, as
    JAX's sharded update does, and both rows stay; the others agree."""
    jt = JaxOneTable(vocab_size=8, dim=2, initial_accumulator=0.0)
    js = jt.init(KEY)
    port = EmbeddingTable(8, 2, device="cpu", initial_accumulator=0.0)
    state = _one_state(jt, js, port)
    before = state.table.clone()
    ids = np.array([1, 4, 4, 6])
    grads = np.ones((4, 2), np.float32)
    mask = np.array([True, False, False, True])
    js = jt.apply_grads(js, jnp.asarray(ids), jnp.asarray(grads), lr=0.1,
                        valid_mask=jnp.asarray(mask))
    port.apply_grads(state, torch.from_numpy(ids), torch.from_numpy(grads),
                     0.1, valid_mask=torch.from_numpy(mask))
    jrows = np.asarray(js.table)
    nan_rows = [0, 4]
    assert np.isnan(jrows[nan_rows]).all()
    assert torch.isfinite(state.table).all()
    assert torch.equal(state.table[nan_rows], before[nan_rows])
    keep = ~np.isin(np.arange(8), nan_rows)
    assert not np.isnan(jrows[keep]).any()
    np.testing.assert_allclose(state.table.numpy()[keep], jrows[keep],
                               rtol=1e-5, atol=1e-7)
    assert not torch.equal(state.table[1], before[1])
    np.testing.assert_array_equal(state.accumulator.numpy(),
                                  np.asarray(js.accumulator))


# -- the sharded table: valid_mask and dedup -----------------------------------

VOCAB, DIM, LR = 96, 8, 0.05


def _updates(seed=0, n=3):
    """Steps of (ids (32, 4), grads, mask): row 5 hammered (eight times in
    the first step), row 9 looked up only under the mask from the second
    step on (unmasked in the first), about a tenth of the rest masked."""
    rng = np.random.RandomState(seed)
    out = []
    for step in range(n):
        ids = rng.randint(10, VOCAB, size=(32, 4)).astype(np.int32)
        grads = (rng.randn(32, 4, DIM) * 0.1).astype(np.float32)
        mask = rng.rand(32, 4) > 0.1
        ids[0, :2] = 5
        ids[7, 1] = 9
        mask[7, 1] = step == 0
        if step == 0:
            ids[1] = 5
            ids[2, :2] = 5
            mask[:3] = True
        out.append((ids, grads, mask))
    return out


def _jax_run(mesh_size, optimizer, mode, dedup, masked, route="auto"):
    jtable = JaxTable(VOCAB, DIM, make_mesh(mesh_size), optimizer=optimizer,
                      update_mode=mode, route_mode=route)
    jstate = jtable.init(jax.random.PRNGKey(3))
    logical = table_state_from_jax(jax.device_get(jstate), mesh_size, DIM)
    for ids, grads, mask in _updates():
        jstate = jtable.apply_grads(
            jstate, jnp.asarray(ids), jnp.asarray(grads), lr=LR,
            valid_mask=jnp.asarray(mask) if masked else None, dedup=dedup)
    every = np.arange(VOCAB)
    final = {k: jtable.debug_read(jax.device_get(getattr(jstate, k)), every)
             for k in (("table", "accumulator") if optimizer == "adagrad"
                       else ("table", "m", "v"))}
    return jtable, jstate, logical, final


def _check_final(got, want):
    np.testing.assert_allclose(got["table"], want["table"], rtol=1e-5,
                               atol=1e-7)
    for name in ("accumulator", "m", "v"):
        if name in want:
            w = np.asarray(want[name])
            np.testing.assert_allclose(got[name], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)


SHARDED = ([("adagrad", mode, dedup, masked) for mode in ("dense", "sparse")
            for dedup in (True, False) for masked in (False, True)]
           + [("adam", mode, False, masked) for mode in ("dense", "sparse")
              for masked in (False, True)])


@pytest.mark.parametrize("optimizer,mode,dedup,masked", SHARDED)
def test_sharded_mask_and_dedup_match_jax_one_shard(optimizer, mode, dedup,
                                                    masked):
    _, _, logical, final = _jax_run(1, optimizer, mode, dedup, masked)
    port = ShardedEmbeddingTable(VOCAB, DIM, device="cpu",
                                 optimizer=optimizer, update_mode=mode)
    state = logical
    start = state.table.clone()
    for ids, grads, mask in _updates():
        port.apply_grads(state, torch.from_numpy(ids).long(),
                         torch.from_numpy(grads), LR,
                         valid_mask=torch.from_numpy(mask) if masked
                         else None, dedup=dedup)
    _check_final({k: getattr(state, k).numpy() for k in final}, final)
    # row 9: masked from the second step on; under Adam still touched
    moved = not torch.equal(state.table[9], start[9])
    assert moved
    if optimizer == "adam" and masked:
        ref = logical.table.new_tensor(final["table"][9])
        torch.testing.assert_close(state.table[9], ref, rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_masked_only_row_still_moves_under_adam(mode):
    """After an unmasked first step, row 9's later occurrences are all
    masked: its gradient is 0, but it is looked up, so its moments decay
    and it moves by lr * m_hat / (sqrt(v_hat) + eps), as in JAX."""
    port = ShardedEmbeddingTable(VOCAB, DIM, device="cpu", optimizer="adam",
                                 update_mode=mode)
    s = port.init(torch.Generator().manual_seed(0))
    (ids0, g0, m0), (ids1, g1, m1) = _updates(n=2)
    port.apply_grads(s, torch.from_numpy(ids0).long(), torch.from_numpy(g0),
                     LR, valid_mask=torch.from_numpy(m0))
    m9, v9, t9 = s.m[9].clone(), s.v[9].clone(), s.table[9].clone()
    assert (m1[ids1 == 9] == 0).all()
    port.apply_grads(s, torch.from_numpy(ids1).long(), torch.from_numpy(g1),
                     LR, valid_mask=torch.from_numpy(m1))
    torch.testing.assert_close(s.m[9], 0.9 * m9, rtol=1e-6, atol=0)
    torch.testing.assert_close(s.v[9], 0.999 * v9, rtol=1e-6, atol=0)
    mhat, vhat = 0.9 * m9 / (1 - 0.9 ** 2), 0.999 * v9 / (1 - 0.999 ** 2)
    torch.testing.assert_close(s.table[9], t9 - LR * mhat / (vhat.sqrt()
                                                              + 1e-7),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_per_occurrence_hammered_row(monkeypatch, mode):
    """test_dedup_modes.py: row 5 eight times with gradient 1: acc += 8 *
    mean(1^2), and each occurrence scales by the batch's accumulator
    (8 * 0.1 / sqrt(8.1)); one B12 call and no B9 in either mode."""
    port = ShardedEmbeddingTable(64, 2, device="cpu", update_mode=mode)
    s = port.init(torch.Generator().manual_seed(2))
    start = s.table[5].clone()
    calls = _counting(monkeypatch)
    port.apply_grads(s, torch.full((8,), 5), torch.ones(8, 2), 0.1,
                     dedup=False)
    assert calls == {"gather_rows": 0, "scatter_add_rows": 1}
    assert float(s.accumulator[5]) == pytest.approx(8.1, rel=1e-6)
    torch.testing.assert_close(s.table[5],
                               start - 8 * 0.1 / np.sqrt(8.1), rtol=1e-5,
                               atol=1e-7)
    # with dedup, the row gradient 8 is squared once: acc 0.1 + 64
    d = ShardedEmbeddingTable(64, 2, device="cpu", update_mode="sparse")
    sd = d.init(torch.Generator().manual_seed(2))
    d.apply_grads(sd, torch.full((8,), 5), torch.ones(8, 2), 0.1)
    assert float(sd.accumulator[5]) == pytest.approx(64.1, rel=1e-6)


def test_sharded_adam_ignores_dedup():
    a = ShardedEmbeddingTable(VOCAB, DIM, device="cpu", optimizer="adam")
    sa = a.init(torch.Generator().manual_seed(4))
    sb = ShardedEmbeddingTable(VOCAB, DIM, device="cpu",
                               optimizer="adam").init(
        torch.Generator().manual_seed(4))
    for ids, grads, mask in _updates():
        for s, dedup in ((sa, True), (sb, False)):
            a.apply_grads(s, torch.from_numpy(ids).long(),
                          torch.from_numpy(grads), LR,
                          valid_mask=torch.from_numpy(mask), dedup=dedup)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


# -- two processes -------------------------------------------------------------

# (optimizer, update mode, route mode, dedup, masked): dedup=False forces
# the allgather exchange under "routed"
TWO = [("adagrad", "dense", "routed", False, True),
       ("adagrad", "sparse", "routed", False, False),
       ("adagrad", "sparse", "routed", True, True),
       ("adagrad", "dense", "allgather", True, True),
       ("adam", "dense", "allgather", True, True),
       ("adam", "sparse", "routed", False, True)]
EXPORT = np.array([5, 9, 0, 95, 40, 41, 12, 5], np.int32)


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    refs, cases = [], []
    for opt, mode, route, dedup, masked in TWO:
        jtable, jstate, logical, final = _jax_run(2, opt, mode, dedup,
                                                  masked, route)
        exported = np.asarray(jax_export(types.SimpleNamespace(table=jstate),
                                         jtable, jnp.asarray(EXPORT)))
        refs.append((final, exported))
        steps = _updates()
        cases.append({"vocab": VOCAB, "dim": DIM, "optimizer": opt,
                      "mode": mode, "route_mode": route, "dedup": dedup,
                      "lr": LR, "state": logical,
                      "steps": [(i, g) for i, g, _ in steps],
                      "masks": [m for _, _, m in steps] if masked else None,
                      "export": EXPORT})
    out = spawn("table", {"table_cases": cases},
                tmp_path_factory.mktemp("leftovers") / "io")
    return refs, out


def _merge(parts):
    a, b = parts
    out = torch.empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]),
                      dtype=a.dtype)
    out[0::2], out[1::2] = a, b
    return out


@pytest.mark.parametrize("i", range(len(TWO)),
                         ids=["-".join(map(str, c)) for c in TWO])
def test_two_process_mask_and_dedup_match_jax(two_process, i):
    (final, exported), ranks = two_process[0][i], [r[i] for r in
                                                   two_process[1]]
    assert {r["route_mode"] for r in ranks} == {TWO[i][2]}
    merged = {k: _merge([getattr(r["state"], k) for r in ranks])[:VOCAB]
              .numpy() for k in final}
    _check_final(merged, final)
    got = torch.cat([r["export"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, exported, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got, merged["table"][EXPORT])


# -- export_table_rows, bce_loss, field_offsets --------------------------------

def test_export_table_rows_matches_jax():
    """On JAX's one-shard table and a state holding it (JAX's call
    raises on the table's state itself), against the port's sharded
    table given the training state, its table state or the bare rows, and
    its one table given a serving state or the rows."""
    jtable = JaxTable(VOCAB, DIM, make_mesh(1))
    jstate = jtable.init(KEY)
    ids = np.array([[0, 5], [95, 5], [40, 1]], np.int32)
    want = np.asarray(jax_export(types.SimpleNamespace(table=jstate),
                                 jtable, ids))
    with pytest.raises(AttributeError):
        jax_export(jstate, jtable, ids)
    state = table_state_from_jax(jax.device_get(jstate), 1, DIM)
    port = ShardedEmbeddingTable(VOCAB, DIM, device="cpu")
    one = EmbeddingTable(VOCAB, DIM, device="cpu")
    holder = types.SimpleNamespace(table=state)
    for tbl, st in ((port, holder), (port, state), (port, state.table),
                    (one, ServingState({}, state.table)),
                    (one, EmbeddingTableState(state.table, None)),
                    (one, state.table)):
        got = export_table_rows(st, tbl, ids)
        assert got.shape == (3, 2, DIM)
        np.testing.assert_array_equal(got.numpy(), want)
    assert export_table_rows(state, port, ids.tolist()).shape == (3, 2, DIM)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce_mean", [False, True])
def test_bce_loss_matches_jax(weighted, reduce_mean):
    rng = np.random.RandomState(3)
    labels = (rng.rand(64) > 0.6).astype(np.float32)
    logits = (rng.randn(64) * 3).astype(np.float32)
    logits[:3] = 0.0
    weights = rng.rand(64).astype(np.float32) if weighted else None
    want_fn = lambda x: jax_bce(jnp.asarray(labels), x,
                                None if weights is None
                                else jnp.asarray(weights), reduce_mean)
    want = want_fn(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = bce_loss(torch.from_numpy(labels), x,
                   None if weights is None else torch.from_numpy(weights),
                   reduce_mean)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    if reduce_mean:
        jg = jax.grad(want_fn)(jnp.asarray(logits))
        g, = torch.autograd.grad(got, x)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-8)


def test_field_offsets_and_global_ids_match_jax():
    jfc = JaxFC(num_sparse=5, rows_per_field=1000)
    fc = FeatureConfig(num_sparse=5, rows_per_field=1000)
    offs = fc.field_offsets()
    assert offs.dtype == torch.int64 and offs.device == torch.device("cpu")
    np.testing.assert_array_equal(offs.numpy(), jfc.field_offsets())
    raw = np.random.RandomState(0).randint(0, 10 ** 6, size=(7, 5))
    np.testing.assert_array_equal(
        fc.global_ids(torch.from_numpy(raw)).numpy(),
        np.asarray(jfc.global_ids(jnp.asarray(raw.astype(np.int32)))))
    np.testing.assert_array_equal(
        FeatureConfig().field_offsets().numpy(), JaxFC().field_offsets())
