"""Port vs JAX: the mod-sharded table and the trainer on two processes.

Two gloo processes of the port (``tests/torch_mp_worker.py``, one spawn
for the whole file) are held to the JAX package on ``make_mesh(2)`` with
the allgather exchange, each process feeding its half of every global
batch as a JAX shard does:

* **the table** (vocabulary 301: padded to 302 rows here, 320 in JAX's
  16-row lines): lookups, then updates, on each of the four update paths
  (dense and sparse, Adagrad and lazy Adam), from JAX's 2-shard state
  carried over by ``convert.table_state_for_rank``.  Lookups are exact
  on the carried-over table and then within the rounding of JAX's
  updates (rtol 1e-5, atol 1e-7, as ``test_torch_gather_scatter.py``);
  rows within atol 1e-7, accumulators and moments rtol 1e-6 (the
  moments with atol 1e-6 of their largest value: tiny gradients summed
  in another order).  Against the port's one-process table every
  lookup is exact and the states within the same tolerances.
* **the trainer**: DCN-v2 (deep (16,)) with pointwise, pairwise at 0.5
  (power -0.5) and listwise at 0.25, dense Adagrad on the rows, on
  batches whose groups cross the two halves (so the in-batch losses are
  per process, as JAX's are per shard): the loss and each term per step
  rtol 1e-5, params atol 1e-6, rows atol 1e-7, and the summed parameter
  gradients of the first step against ``jax.grad`` of JAX's loss (rtol
  1e-5, atol 1e-7 of the largest): they are JAX's dense gradient, so a
  port that averaged the processes' gradients fails here.
* **P-invariance**: on group-aligned batches (no group crosses the
  halves) two processes equal one (rtol 1e-5), after
  ``tests/training/test_ndevice_equivalence.py``, for config 2's DCN-v2
  under lazy Adam, config 4 (multitask: listwise and the CVR head) and
  config 5 (CAN, two sharded tables); then ``evaluate`` (exact, 1e-6),
  ``evaluate_device`` (the bucketed AUC and in-batch GAUC 1e-6, corpus
  GAUC by hash slots on two processes 1e-6) and the windowed loop
  through ``put_packed_auto`` (losses rtol 1e-5).

Measured on a CPU: trainer vs JAX losses within 1.7e-7 relative, params
6e-8, rows 1.2e-10; two processes vs one losses within 2.6e-7, params
3e-8, rows 1.8e-9, the evals equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.embedding.sharded import ShardedEmbeddingTable as JaxTable
from rec_now_tpu.models import DCNv2Model as JaxDCN
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.training import SyntheticCriteo as JaxData
from rec_now_tpu.training import Trainer as JaxTrainer
from rec_now_tpu.training import TrainerConfig as JaxConfig
from rec_now_tpu_torch.convert import (from_jax_params, table_state_for_rank,
                                       table_state_from_jax)
from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.parallel import Mesh
from tests.torch_mp_worker import run_trainer_case, spawn

torch.set_num_threads(1)

VOCAB, DIM, LR = 301, 8, 0.05
PATHS = [(opt, mode) for opt in ("adagrad", "adam")
         for mode in ("dense", "sparse")]
ROWS, B, STEPS = 96, 64, 4
LOSS = dict(pointwise_weight=1.0, pairwise_weight=0.5, listwise_weight=0.25,
            click_occurance_power=-0.5)
INVARIANT = {
    "config2": ("dcnv2", dict(pointwise_weight=1.0, pairwise_weight=0.5,
                              click_occurance_power=-0.5,
                              sparse_optimizer="adam", sparse_lr=1e-3)),
    "config4": ("multitask", dict(pointwise_weight=1.0, listwise_weight=0.5,
                                  num_tasks=2)),
    "config5": ("can_dcn", dict(pointwise_weight=1.0, pairwise_weight=0.5,
                                can_param_field=8)),
}


def _updates(seed=0):
    """Three steps of (ids (32, 4), grads (32, 4, D)): duplicates within
    and across the halves, ids of both owners, row 5 in every step."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        ids = rng.randint(0, VOCAB, size=(32, 4)).astype(np.int32)
        ids[0, :2] = 5
        ids[20, 1] = 5
        ids[3, 3] = VOCAB - 1
        out.append((ids, (rng.randn(32, 4, DIM) * 0.1).astype(np.float32)))
    return out


def _batches(n, seed, aligned=False):
    """Global batches of B as dicts; ``aligned``: groups confined to each
    process's half (2 per 8-row block, distinct across blocks)."""
    data = JaxData(rows_per_field=ROWS, num_users=12)
    rng = np.random.RandomState(seed)
    out = []
    for b in data.batches(B, n, seed=seed):
        b = b._asdict()
        if aligned:
            b["group_ids"] = ((np.arange(B) // 8) * 100
                              + rng.randint(0, 2, B)).astype(np.int32)
        out.append(b)
    return out


def _jax_table_run(optimizer, mode):
    jtable = JaxTable(VOCAB, DIM, make_mesh(2), optimizer=optimizer,
                      update_mode=mode, route_mode="allgather")
    jstate = jtable.init(jax.random.PRNGKey(3))
    logical = table_state_from_jax(jax.device_get(jstate), 2, DIM)
    looked = []
    for ids, grads in _updates():
        looked.append(np.asarray(jtable.lookup(jstate, jnp.asarray(ids))))
        jstate = jtable.apply_grads(jstate, jnp.asarray(ids),
                                    jnp.asarray(grads), lr=LR)
    every = np.arange(VOCAB)
    final = {k: jtable.debug_read(jax.device_get(getattr(jstate, k)), every)
             for k in (("table", "accumulator") if optimizer == "adagrad"
                       else ("table", "m", "v"))}
    return logical, looked, final


def _jax_trainer():
    """JAX's trainer on make_mesh(2), its initial state, its steps on
    group-crossing batches, and jax.grad of its loss at the first."""
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    jt = JaxTrainer(JaxDCN(deep_dims=(16,), dcn_sub_dim=4), jfc,
                    JaxConfig(**LOSS, sparse_route_mode="allgather"),
                    mesh=make_mesh(2))
    batches = list(JaxData(rows_per_field=ROWS, num_users=12).batches(
        B, STEPS, seed=7))
    jstate = jt.init(jax.random.PRNGKey(0), batches[0])
    params = from_jax_params(jax.device_get(jstate.params))
    table = table_state_from_jax(jax.device_get(jstate.table), 2, DIM)
    dense, ids, labels, groups, cvr, domain = jt.put(batches[0])
    emb = jt.table.lookup(jstate.table, jfc.global_ids(ids))
    grads = jax.grad(lambda p: jt._loss_fn(p, emb, None, dense, labels,
                                           groups, cvr, domain)[0])(
        jstate.params)
    metrics = []
    for b in batches:
        jstate, m = jt.train_step(jstate, *jt.put(b))
        metrics.append({k: float(v) for k, v in m.items()
                        if k != "sparse_dropped"})
    every = np.arange(jfc.total_rows)
    return {"params": params, "table": table,
            "batches": [b._asdict() for b in batches],
            "grads": from_jax_params(jax.device_get(grads)),
            "metrics": metrics,
            "final_params": from_jax_params(jax.device_get(jstate.params)),
            "rows": jt.table.debug_read(jax.device_get(jstate.table.table),
                                        every),
            "acc": jt.table.debug_read(
                jax.device_get(jstate.table.accumulator), every)}


def _invariant_case(name):
    model, config = INVARIANT[name]
    return {"model": model, "config": config, "rows": ROWS, "dim": DIM,
            "seed": 5, "batches": _batches(STEPS, 11, aligned=True),
            "eval": _batches(3, 12, aligned=True) if name == "config2"
            else None,
            "windowed": _batches(4, 13, aligned=True) if name == "config2"
            else None}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX reference, then one spawn of two port processes that run
    every case."""
    table_refs = {path: _jax_table_run(*path) for path in PATHS}
    jref = _jax_trainer()
    inputs = {
        "table_cases": [
            {"vocab": VOCAB, "dim": DIM, "optimizer": opt, "mode": mode,
             "lr": LR, "state": table_refs[(opt, mode)][0],
             "steps": _updates()} for opt, mode in PATHS],
        "trainer_cases": [
            {"model": "dcnv2", "config": LOSS, "rows": ROWS, "dim": DIM,
             "params": jref["params"], "table": jref["table"],
             "batches": jref["batches"]}]
        + [_invariant_case(name) for name in INVARIANT]}
    out = spawn("suite", inputs, tmp_path_factory.mktemp("parallel") / "io")
    return {"table_refs": table_refs, "jax": jref, "inputs": inputs,
            "out": out}


def _merge(parts):
    """Two ranks' local rows -> the logical rows (id i from rank i % 2)."""
    a, b = parts
    out = torch.empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]),
                      dtype=a.dtype)
    out[0::2], out[1::2] = a, b
    return out


def _check_state(got, want, atol_rows=1e-7):
    np.testing.assert_allclose(got["table"], want["table"], rtol=0,
                               atol=atol_rows)
    for name in ("accumulator", "m", "v"):
        if name in want:
            w = np.asarray(want[name])
            np.testing.assert_allclose(got[name], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("path", PATHS, ids=["-".join(p) for p in PATHS])
def test_two_process_table_matches_jax_and_one_process(runs, path):
    i = PATHS.index(path)
    logical, jlooked, jfinal = runs["table_refs"][path]
    ranks = [r["table"][i] for r in runs["out"]]
    assert {r["update_mode"] for r in ranks} == {path[1]}
    # the port's table on one process, from the same logical state
    one = ShardedEmbeddingTable(VOCAB, DIM, device="cpu", optimizer=path[0],
                                update_mode=path[1])
    state = table_state_for_rank(logical, 0, 1, VOCAB)
    for step, (ids, grads) in enumerate(_updates()):
        got = torch.cat([r["lookups"][step] for r in ranks]).numpy()
        # exact on the carried-over table, then within JAX's rounding of
        # the updates (its lane-packed one-hot lines)
        np.testing.assert_allclose(got, jlooked[step],
                                   rtol=1e-5 if step else 0,
                                   atol=1e-7 if step else 0)
        ids_t = torch.from_numpy(ids).long()
        np.testing.assert_array_equal(got, one.lookup(state, ids_t).numpy())
        state = one.apply_grads(state, ids_t, torch.from_numpy(grads), LR)
    merged = {k: _merge([getattr(r["state"], k) for r in ranks])[:VOCAB]
              .numpy() for k in jfinal}
    _check_state(merged, jfinal)
    _check_state(merged, {k: getattr(state, k).numpy() for k in jfinal})
    if path[0] == "adam":
        assert all(int(r["state"].count) == 3 for r in ranks)
    moved = (merged["table"] != logical.table[:VOCAB].numpy()).any(1)
    touched = np.zeros(VOCAB, bool)
    touched[np.concatenate([i.ravel() for i, _ in _updates()])] = True
    np.testing.assert_array_equal(moved, touched)


def test_two_process_trainer_matches_jax_on_crossing_groups(runs):
    jref, ranks = runs["jax"], [r["trainers"][0] for r in runs["out"]]
    groups = [set(b["group_ids"][:B // 2]) & set(b["group_ids"][B // 2:])
              for b in jref["batches"]]
    assert all(groups), "every batch has a group in both halves"
    for r in ranks:
        for got, want in zip(r["metrics"], jref["metrics"]):
            assert set(got) == set(want)
            for key in want:
                assert want[key] > 0, key
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
        for name, want in jref["grads"].items():
            w = want.numpy()
            np.testing.assert_allclose(r["grads"][name].numpy(), w,
                                       rtol=1e-5,
                                       atol=1e-7 * np.abs(w).max(),
                                       err_msg=name)
        for name, want in jref["final_params"].items():
            np.testing.assert_allclose(r["params"][name].numpy(),
                                       want.numpy(), atol=1e-6,
                                       err_msg=name)
    rows = _merge([r["table"].table for r in ranks])[:len(jref["rows"])]
    acc = _merge([r["table"].accumulator for r in ranks])[:len(jref["acc"])]
    np.testing.assert_allclose(rows.numpy(), jref["rows"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(acc.numpy(), jref["acc"], rtol=1e-6)
    start = jref["table"].table[:len(jref["rows"])].numpy()
    assert ((jref["rows"] != start).any(1)).sum() > 100


@pytest.mark.parametrize("name", list(INVARIANT))
def test_two_processes_equal_one_on_aligned_groups(runs, name):
    i = 1 + list(INVARIANT).index(name)
    case = runs["inputs"]["trainer_cases"][i]
    one = run_trainer_case(case, None)
    ranks = [r["trainers"][i] for r in runs["out"]]
    for r in ranks:
        assert len(r["metrics"]) == STEPS
        for got, want in zip(r["metrics"], one["metrics"]):
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
        for n, p in one["params"].items():
            np.testing.assert_allclose(r["params"][n].numpy(), p.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=n)
            g = one["grads"][n].numpy()
            np.testing.assert_allclose(r["grads"][n].numpy(), g, rtol=1e-5,
                                       atol=1e-6 * np.abs(g).max(),
                                       err_msg=n)
    for key in ("table", "can_table"):
        if one[key] is None:
            continue
        want = getattr(one[key], "table")
        got = _merge([getattr(r[key], "table") for r in ranks])
        np.testing.assert_allclose(got[:len(want)].numpy(), want.numpy(),
                                   rtol=0, atol=1e-7, err_msg=key)
    if name == "config2":
        got, want = ranks[0]["evals"], one["evals"]
        assert ranks[1]["evals"] == got
        for mode in ("exact", "corpus", "inbatch"):
            for key in ("auc", "gauc"):
                np.testing.assert_allclose(got[mode][key], want[mode][key],
                                           rtol=0, atol=1e-6,
                                           err_msg=f"{mode} {key}")
        for key in ("num_pos", "num_neg"):
            assert got["corpus"][key] == want["corpus"][key]
        np.testing.assert_allclose(got["windowed_loss"],
                                   want["windowed_loss"], rtol=1e-5)


def test_auto_judges_the_local_shard():
    """``auto`` reads the local shard's bytes, as JAX does: a table past
    the one-device limit takes the dense path on two processes."""
    limit = ShardedEmbeddingTable.DENSE_UPDATE_MAX_TABLE_BYTES["adagrad"]
    rows = limit // (16 * 4) + 1
    assert ShardedEmbeddingTable(rows, 16, device="cpu").update_mode \
        == "sparse"
    two = ShardedEmbeddingTable(rows, 16, mesh=Mesh(1, 2,
                                                    torch.device("cpu")))
    assert (two.update_mode, two.vocab_size, two.local_rows) == (
        "dense", rows + rows % 2, (rows + 1) // 2)
