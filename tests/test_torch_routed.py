"""Port vs JAX: the routed embedding exchange on 2 and 4 processes.

Gloo processes of the port (``tests/torch_mp_worker.py``, one spawn for
each mesh size) are held to the JAX package's routed table on
``make_mesh(2)`` / ``make_mesh(4)``, each process feeding its slice of
every global batch as a JAX shard does, from JAX's state carried over by
``convert.table_state_for_rank`` (vocabulary 301, D = 8):

* **the table** on each of the four update paths (dense and sparse,
  Adagrad and lazy Adam), two steps of lookups then updates: the first
  lookup exact and the next within the rounding of JAX's updates; with
  dyadic gradients (multiples of 2^-8, as
  ``tests/embedding/test_routed.py``) the routed state equals the port's
  allgather state bit for bit, and with random gradients it is within
  rows atol 1e-7, moments rtol 1e-6 of JAX's (``test_torch_parallel.py``'s
  tolerances: the duplicates sum in another order);
* **forced caps** (``route_cap_factor=0.25, route_ov_cap=8``) on ids
  skewed onto one owner: the dropped count equals JAX's, the distinct
  ids whose rows read zero number exactly that count, and the states
  (a dropped id takes no update) match JAX's;
* **the trainer**: DCN-v2 under ``sparse_route_mode="routed"`` on two
  processes against JAX's ``Trainer`` on ``make_mesh(2)`` (losses rtol
  1e-5, params atol 1e-6, rows atol 1e-7), and against the port's own
  allgather run; ``route_strict`` raises in ``fit`` when ids drop, and
  without it the drops are counted in ``sparse_dropped``;
* ``route_mode="auto"`` resolves as JAX's does at P = 1, 2 and 4.
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
from rec_now_tpu_torch.convert import from_jax_params, table_state_from_jax
from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
from rec_now_tpu_torch.parallel import Mesh
from tests.torch_mp_worker import spawn

torch.set_num_threads(1)

VOCAB, DIM, LR = 301, 8, 0.05
PATHS = [(opt, mode) for opt in ("adagrad", "adam")
         for mode in ("dense", "sparse")]
# (gradients, route_cap_factor, route_ov_cap, skewed ids)
KINDS = {"dyadic": ("dyadic", 2.0, None, False),
         "random": ("random", 2.0, None, False),
         "forced": ("random", 0.25, 8, True)}
CASES = [(kind, path) for kind in KINDS for path in PATHS]
ROWS, B, STEPS = 96, 64, 3
LOSS = dict(pointwise_weight=1.0, pairwise_weight=0.5, listwise_weight=0.25,
            click_occurance_power=-0.5)


def _steps(n, kind, seed=0):
    """Two steps of (ids (32, 4), grads (32, 4, D)): duplicates within and
    across the processes' slices; skewed: every id owned by process 0."""
    grads_kind, _, _, skewed = KINDS[kind]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        if skewed:
            ids = rng.randint(0, VOCAB // n, size=(32, 4)) * n
        else:
            ids = rng.randint(0, VOCAB, size=(32, 4))
            ids[0, :2] = 5
            ids[20, 1] = 5
        if grads_kind == "dyadic":
            g = rng.randint(-64, 64, size=(32, 4, DIM)) / 256.0
        else:
            g = rng.randn(32, 4, DIM) * 0.1
        out.append((ids.astype(np.int32), g.astype(np.float32)))
    return out


def _jax_table_run(n, kind, optimizer, mode):
    _, factor, ov_cap, _ = KINDS[kind]
    jtable = JaxTable(VOCAB, DIM, make_mesh(n), optimizer=optimizer,
                      update_mode=mode, route_mode="routed",
                      route_cap_factor=factor, route_ov_cap=ov_cap)
    jstate = jtable.init(jax.random.PRNGKey(3))
    logical = table_state_from_jax(jax.device_get(jstate), n, DIM)
    looked, dropped = [], []
    for ids, grads in _steps(n, kind):
        rows, d = jtable.lookup(jstate, jnp.asarray(ids),
                                return_dropped=True)
        looked.append(np.asarray(rows))
        dropped.append(int(d))
        jstate = jtable.apply_grads(jstate, jnp.asarray(ids),
                                    jnp.asarray(grads), lr=LR)
    every = np.arange(VOCAB)
    final = {k: jtable.debug_read(jax.device_get(getattr(jstate, k)), every)
             for k in (("table", "accumulator") if optimizer == "adagrad"
                       else ("table", "m", "v"))}
    return {"logical": logical, "looked": looked, "dropped": dropped,
            "final": final}


def _jax_trainer():
    """JAX's trainer on make_mesh(2) with the routed exchange: its initial
    state and its steps on group-crossing batches."""
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    jt = JaxTrainer(JaxDCN(deep_dims=(16,), dcn_sub_dim=4), jfc,
                    JaxConfig(**LOSS, sparse_route_mode="routed"),
                    mesh=make_mesh(2))
    assert jt.table.route_mode == "routed"
    batches = list(JaxData(rows_per_field=ROWS, num_users=12).batches(
        B, STEPS, seed=7))
    jstate = jt.init(jax.random.PRNGKey(0), batches[0])
    params = from_jax_params(jax.device_get(jstate.params))
    table = table_state_from_jax(jax.device_get(jstate.table), 2, DIM)
    metrics = []
    for b in batches:
        jstate, m = jt.train_step(jstate, *jt.put(b))
        metrics.append({k: float(v) for k, v in m.items()})
    every = np.arange(jfc.total_rows)
    return {"params": params, "table": table,
            "batches": [b._asdict() for b in batches], "metrics": metrics,
            "final_params": from_jax_params(jax.device_get(jstate.params)),
            "rows": jt.table.debug_read(jax.device_get(jstate.table.table),
                                        every)}


def _table_cases(n, refs):
    return [{"vocab": VOCAB, "dim": DIM, "optimizer": opt, "mode": mode,
             "lr": LR, "cap_factor": KINDS[kind][1],
             "ov_cap": KINDS[kind][2], "state": refs[(kind, opt, mode)][
                 "logical"], "steps": _steps(n, kind)}
            for kind, (opt, mode) in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every JAX reference, then one spawn of 2 and one of 4 port
    processes."""
    refs = {n: {(kind, opt, mode): _jax_table_run(n, kind, opt, mode)
                for kind, (opt, mode) in CASES} for n in (2, 4)}
    jref = _jax_trainer()
    trainer = {"model": "dcnv2", "rows": ROWS, "dim": DIM,
               "params": jref["params"], "table": jref["table"],
               "batches": jref["batches"]}
    strict_batches = [b._asdict() for b in JaxData(
        rows_per_field=ROWS, num_users=12).batches(B, 2, seed=9)]
    inputs = {
        2: {"table_cases": _table_cases(2, refs[2]),
            "trainer_cases": [
                dict(trainer, config=dict(LOSS, sparse_route_mode=mode))
                for mode in ("routed", "allgather")],
            "strict": {"rows": ROWS, "dim": DIM, "batches": strict_batches,
                       "config": dict(LOSS, sparse_route_mode="routed",
                                      route_cap_factor=0.25,
                                      route_ov_cap=8)}},
        4: {"table_cases": _table_cases(4, refs[4]), "trainer_cases": []}}
    base = tmp_path_factory.mktemp("routed")
    out = {n: spawn("routed", inputs[n], base / f"io{n}", world=n)
           for n in (2, 4)}
    return {"refs": refs, "jax": jref, "out": out}


def _merge(parts):
    """Each rank's local rows -> the logical rows (id i from rank i % P)."""
    n = len(parts)
    out = torch.empty((n * parts[0].shape[0],) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype)
    for r, p in enumerate(parts):
        out[r::n] = p
    return out


def _check_state(got, want):
    np.testing.assert_allclose(got["table"], want["table"], rtol=0,
                               atol=1e-7)
    for name in ("accumulator", "m", "v"):
        if name in want:
            w = np.asarray(want[name])
            np.testing.assert_allclose(got[name], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"{k}-{o}-{m}" for k, (o, m) in CASES])
def test_routed_table_matches_jax(runs, n, case):
    kind, (opt, mode) = case
    ref = runs["refs"][n][(kind, opt, mode)]
    i = CASES.index(case)
    ranks = [r["table"][i] for r in runs["out"][n]]
    assert {r["routed"]["route_mode"] for r in ranks} == {"routed"}
    assert {r["allgather"]["route_mode"] for r in ranks} == {"allgather"}
    steps = _steps(n, kind)
    for step, (ids, _) in enumerate(steps):
        got = torch.cat([r["routed"]["lookups"][step] for r in ranks])
        np.testing.assert_allclose(got.numpy().reshape(ref["looked"][step]
                                                       .shape),
                                   ref["looked"][step],
                                   rtol=1e-5 if step else 0,
                                   atol=1e-7 if step else 0)
        # every process reads the global count, JAX's
        assert {r["routed"]["dropped"][step] for r in ranks} == {
            ref["dropped"][step]}
        # a dropped id reads zero: the distinct ids with zero rows, over
        # the processes, are the dropped ones
        b = len(ids) // n
        zeros = 0
        for rank, r in enumerate(ranks):
            rows = r["routed"]["lookups"][step].reshape(-1, DIM)
            mine = ids[rank * b:(rank + 1) * b].reshape(-1)
            zeros += len(set(mine[(rows == 0).all(1).numpy()].tolist()))
        assert zeros == ref["dropped"][step]
        if kind == "forced":
            assert ref["dropped"][step] > 0
        else:
            assert ref["dropped"][step] == 0
            # the allgather exchange reads the same rows (on equal states)
            ag = torch.cat([r["allgather"]["lookups"][step] for r in ranks])
            if step == 0 or kind == "dyadic":
                assert torch.equal(got, ag)
    merged = {k: _merge([getattr(r["routed"]["state"], k) for r in ranks])
              [:VOCAB].numpy() for k in ref["final"]}
    _check_state(merged, ref["final"])
    if kind == "dyadic":
        for k in ref["final"]:
            ag = _merge([getattr(r["allgather"]["state"], k)
                         for r in ranks])[:VOCAB].numpy()
            np.testing.assert_array_equal(merged[k], ag, err_msg=k)
    if opt == "adam":
        assert all(int(r["routed"]["state"].count) == 2 for r in ranks)


def test_routed_trainer_matches_jax_and_allgather(runs):
    jref = runs["jax"]
    ranks = runs["out"][2]
    for r in ranks:
        routed, allgather = r["trainers"]
        for got, ag, want in zip(routed["metrics"], allgather["metrics"],
                                 jref["metrics"]):
            assert set(got) == set(want) == set(ag)
            assert got["sparse_dropped"] == want["sparse_dropped"] == 0
            for key in want:
                if key != "sparse_dropped":
                    np.testing.assert_allclose(got[key], want[key],
                                               rtol=1e-5, err_msg=key)
                    np.testing.assert_allclose(got[key], ag[key], rtol=1e-6,
                                               err_msg=key)
        for name, want in jref["final_params"].items():
            np.testing.assert_allclose(routed["params"][name].numpy(),
                                       want.numpy(), atol=1e-6,
                                       err_msg=name)
    rows = _merge([r["trainers"][0]["table"].table for r in ranks])
    ag_rows = _merge([r["trainers"][1]["table"].table for r in ranks])
    n_rows = len(jref["rows"])
    np.testing.assert_allclose(rows[:n_rows].numpy(), jref["rows"], rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(rows.numpy(), ag_rows.numpy(), rtol=0,
                               atol=1e-7)
    start = jref["table"].table[:n_rows].numpy()
    assert ((jref["rows"] != start).any(1)).sum() > 100


def test_route_strict_raises_in_fit_when_ids_drop(runs):
    for r in runs["out"][2]:
        counted, raised = r["strict"][False], r["strict"][True]
        assert counted["sparse_dropped"] > 0
        assert np.isfinite(counted["loss"])
        assert isinstance(raised, str), "fit did not raise"
        head = "routed exchange dropped "
        assert raised.startswith(head) and "(route_strict=True)" in raised
        assert int(raised[len(head):].split()[0]) > 0


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mode", ["auto", "allgather", "routed"])
def test_route_mode_resolves_as_jax(n, mode):
    want = JaxTable(1024, 8, make_mesh(n), route_mode=mode).route_mode
    mesh = Mesh(0, n, torch.device("cpu"))
    got = ShardedEmbeddingTable(1024, 8, mesh=mesh, route_mode=mode)
    assert got.route_mode == want
    if n == 1:
        assert ShardedEmbeddingTable(1024, 8, device="cpu",
                                     route_mode=mode).route_mode == want
    with pytest.raises(ValueError, match="unknown route_mode"):
        ShardedEmbeddingTable(1024, 8, mesh=mesh, route_mode="ring")
