"""Port vs JAX: the wire's hot8 id mode (``training/wire.py``).

* ``pack_window`` / ``pack`` give JAX's bytes under hot8 (zipf ids, one
  and four shards, raw groups, the relearn after a shift), and the table
  each window was encoded with; a flat stream raises and rows past 2^24
  are refused, as in JAX; ``wire_cost`` is JAX's.
* ``decode`` gives JAX's jitted decode and the host ids exactly.
* The C++ encode (``csrc/wire.cu``, what ``put_packed_window`` runs on the
  card), compiled here as host C++ with g++, gives the numpy bytes, the
  relearn and the raise included.
* The stale-table fault of the JAX wire (its decode reads the table the
  wire holds when it runs) is not carried over: windows packed before a
  relearn, queued in a ``WindowPrefetcher`` or packed by other threads,
  each decode to their own ids.
* Two ``Trainer.train_many_packed`` windows under hot8 equal packed mode's
  bit for bit, and JAX's ``Trainer`` under hot8 within
  ``test_torch_train_loop.py``'s tolerances.
"""
import ctypes
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.models import DCNv2Model as JaxDCN
from rec_now_tpu.models import FeatureConfig as JaxFC
from rec_now_tpu.parallel import make_mesh
from rec_now_tpu.training import Trainer as JaxTrainer
from rec_now_tpu.training import TrainerConfig as JaxConfig
from rec_now_tpu.training import wire as jwire
from rec_now_tpu.training.data import SyntheticCriteo as JaxData
from rec_now_tpu_torch.convert import from_jax_params, table_state_from_jax
from rec_now_tpu_torch.models import DCNv2Model, FeatureConfig
from rec_now_tpu_torch.ops import _build
from rec_now_tpu_torch.training import Batch, Trainer, TrainerConfig
from rec_now_tpu_torch.training import wire as twire
from rec_now_tpu_torch.training.prefetch import WindowPrefetcher

torch.set_num_threads(1)


def _zipf(n, b=64, rows=512, seed=0):
    data = JaxData(rows_per_field=rows, num_users=32, seed=seed)
    rng = np.random.RandomState(seed + 1)
    return [data.sample(b, rng) for _ in range(n)]


def _batch(ids, rng):
    b = ids.shape[0]
    return Batch(dense=rng.randn(b, 13).astype(np.float32), sparse_ids=ids,
                 labels=(rng.rand(b) > 0.5).astype(np.float32),
                 group_ids=rng.randint(0, 9, b).astype(np.int32),
                 cvr_labels=np.zeros(b, np.float32),
                 domain_idx=np.zeros(b, np.int32))


def _drawn(space, n=2, b=64, fields=8, seed=0):
    rng = np.random.RandomState(seed)
    return [_batch(rng.choice(space, size=(b, fields)).astype(np.int32), rng)
            for _ in range(n)]


def _same_bytes(got, want):
    """The port's fields equal JAX's; the port's window also carries the
    table JAX's wire held when it encoded."""
    assert got._fields == want._fields + ("hot_table",)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_ids(wire, packed):
    """JAX's jitted decode (a fresh trace: it bakes the wire's table)."""
    dec = jax.jit(lambda p: wire.decode(p))
    return np.asarray(dec(jwire.PackedBatch(*[jnp.asarray(x)
                                              for x in packed]))[1])


def _ids(wire, packed):
    return wire.decode(twire.to_tensors(packed))[1].numpy()


def _stack(batches):
    return np.stack([b.sparse_ids for b in batches])


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("mode", ["f16", "u8"])
def test_pack_window_and_decode_match_jax(shards, raw, mode):
    ours = twire.WireFormat(26, 512, mode, shards, id_mode="hot8")
    theirs = jwire.WireFormat(26, 512, mode, shards, id_mode="hot8")
    for seed in (0, 5):
        batches = _zipf(3, seed=seed)          # seed 5 relearns
        got = ours.pack_window(batches, raw_groups=raw)
        want = theirs.pack_window(batches, raw_groups=raw)
        _same_bytes(got, want)
        np.testing.assert_array_equal(got.hot_table, theirs.hot_table)
        assert got.id_words.dtype == np.uint8
        assert got.esc.shape == (3, shards, ours._esc_cap(64, shards) * 3)
        np.testing.assert_array_equal(_ids(ours, got), _jax_ids(theirs,
                                                                want))
        np.testing.assert_array_equal(_ids(ours, got), _stack(batches))
    assert ours.hot_version == theirs.hot_version >= 1


@pytest.mark.parametrize("shards", [1, 4])
def test_pack_matches_jax_and_honors_the_shard_override(shards):
    (batch,) = _zipf(1, b=128, seed=2)
    ours = twire.WireFormat(26, 512, id_mode="hot8", num_shards=shards)
    theirs = jwire.WireFormat(26, 512, id_mode="hot8", num_shards=shards)
    got, want = ours.pack(batch), theirs.pack(batch)
    _same_bytes(got, want)
    np.testing.assert_array_equal(_ids(ours, got), batch.sparse_ids)
    np.testing.assert_array_equal(_jax_ids(theirs, want), batch.sparse_ids)
    # the override sizes and orders the escape streams too (JAX keeps the
    # instance's count there, wire.py:377); the decode reads the window's
    over = ours.pack(batch, num_shards=2)
    assert over.esc.shape == (2, ours._esc_cap(128, 2) * 3)
    assert over.dense_scale.shape[-3] == 2
    np.testing.assert_array_equal(_ids(ours, over), batch.sparse_ids)
    fresh = twire.WireFormat(26, 512, id_mode="hot8", num_shards=2)
    _same_bytes(over, jwire.WireFormat(26, 512, id_mode="hot8",
                                       num_shards=2).pack(batch))
    assert fresh.hot_table is None


def test_relearn_after_a_shift_matches_jax():
    """A window whose ids the table does not cover overflows the cap and
    relearns the table from itself; both wires stay lossless and equal."""
    ours = twire.WireFormat(8, 4096, id_mode="hot8", esc_cap_frac=0.3)
    theirs = jwire.WireFormat(8, 4096, id_mode="hot8", esc_cap_frac=0.3)
    # the third window repeats the second's ids: the relearned table
    # covers them, so no relearn
    for space, version in ((np.arange(32), 1), (np.arange(2048, 4096), 2),
                           (np.arange(2048, 4096), 2)):
        batches = _drawn(space, seed=version)
        got, want = ours.pack_window(batches), theirs.pack_window(batches)
        _same_bytes(got, want)
        assert ours.hot_version == theirs.hot_version == version
        np.testing.assert_array_equal(got.hot_table, theirs.hot_table)
        np.testing.assert_array_equal(_ids(ours, got), _stack(batches))
        np.testing.assert_array_equal(_jax_ids(theirs, want),
                                      _stack(batches))


def test_flat_stream_raises_and_wide_rows_are_refused():
    rng = np.random.RandomState(1)
    flat = _batch(rng.randint(0, 1 << 20, (4096, 8)).astype(np.int32), rng)
    for wire in (twire.WireFormat(8, 1 << 20, id_mode="hot8",
                                  esc_cap_frac=0.05),
                 jwire.WireFormat(8, 1 << 20, id_mode="hot8",
                                  esc_cap_frac=0.05)):
        with pytest.raises(ValueError, match="esc_cap_frac"):
            wire.pack_window([flat])
        assert wire.hot_version == 2           # learned, then relearned
    for wire in (twire.WireFormat, jwire.WireFormat):
        with pytest.raises(ValueError, match="2\\^24"):
            wire(26, 1 << 25, id_mode="hot8")
        wire(26, 1 << 24, id_mode="hot8")      # 24 bits fit
    with pytest.raises(ValueError, match="id_mode"):
        twire.WireFormat(26, 512, id_mode="hot16")


def test_a_packed_mode_window_does_not_decode_as_hot8():
    batches = _zipf(2)
    packed = twire.WireFormat(26, 512).pack_window(batches)
    assert packed.hot_table.shape == (0, 255)
    with pytest.raises(ValueError, match="table"):
        _ids(twire.WireFormat(26, 512, id_mode="hot8"), packed)


@pytest.mark.parametrize("mode", ["f16", "u8"])
@pytest.mark.parametrize("rows", [512, 100_000])
@pytest.mark.parametrize("frac", [0.25, 0.1])
def test_wire_cost_matches_jax(mode, rows, frac):
    for id_mode in ("packed", "hot8"):
        assert twire.WireFormat.wire_cost(13, 26, rows, mode, id_mode,
                                          frac) == \
            jwire.WireFormat.wire_cost(13, 26, rows, mode, id_mode, frac)
    hot, _ = twire.WireFormat.wire_cost(13, 26, rows, mode, "hot8")
    packed, _ = twire.WireFormat.wire_cost(13, 26, rows, mode)
    assert hot < packed or rows == 512


def _stale_stream():
    """Three windows on one id space, then three on another: the fourth
    window overflows the first table's cap and relearns it."""
    return (_drawn(np.arange(32), n=9, seed=1)
            + _drawn(np.arange(2048, 4096), n=9, seed=2))


def test_the_jax_wire_decodes_a_window_packed_before_a_relearn_wrongly():
    """The fault the port does not carry over (the JAX wire decodes with
    the table it holds when it decodes)."""
    stream = _stale_stream()
    theirs = jwire.WireFormat(8, 4096, id_mode="hot8", esc_cap_frac=0.3)
    first = theirs.pack_window(stream[:3])
    theirs.pack_window(stream[9:12])              # relearns
    assert theirs.hot_version == 2
    assert not np.array_equal(_jax_ids(theirs, first), _stack(stream[:3]))
    ours = twire.WireFormat(8, 4096, id_mode="hot8", esc_cap_frac=0.3)
    first = ours.pack_window(stream[:3])
    ours.pack_window(stream[9:12])
    assert ours.hot_version == 2
    np.testing.assert_array_equal(_ids(ours, first), _stack(stream[:3]))


@pytest.mark.parametrize("depth", [1, 3])
def test_windows_queued_across_a_relearn_decode_to_their_own_ids(depth):
    """Through a WindowPrefetcher whose worker has packed ahead of the
    loop (its queue full), the table is relearned while earlier windows
    wait: by the worker itself (depth 3: its fourth window is from the
    other id space) or by an eval window packed on the loop thread.
    Every window decodes to its own ids."""
    stream = _stale_stream()
    ours = twire.WireFormat(8, 4096, id_mode="hot8", esc_cap_frac=0.3)
    versions = []

    def put(batches):
        packed = ours.pack_window(batches)
        return packed, _stack(batches), ours.hot_version

    with WindowPrefetcher(iter(stream), put, 3, depth=depth,
                          parse_ahead=False) as wins:
        for k, ((packed, want, version), n) in enumerate(wins):
            if k == 0:
                deadline = time.monotonic() + 30
                while not wins._inner._q.full():
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                # an eval window from the other id space, packed now
                ev = _drawn(np.arange(2048, 4096), n=3, seed=7)
                evp = ours.pack_window(ev, raw_groups=True)
                assert ours.hot_version >= 2
                np.testing.assert_array_equal(_ids(ours, evp), _stack(ev))
            versions.append(version)
            np.testing.assert_array_equal(_ids(ours, packed), want)
            assert n == 3
    # the window taken and those queued behind it from the first id space
    # (the stream's first three) were packed under the first table, and
    # decoded after the relearn
    first = min(depth + 1, 3)
    assert versions[:first] == [1] * first and versions[-1] >= 2


def test_threads_packing_through_one_wire_stay_lossless():
    """More threads than cores pack windows from two id spaces through
    one wire with a short switch interval: every window decodes to its
    own ids, and each one's table is one the wire learned."""
    ours = twire.WireFormat(8, 4096, id_mode="hot8", esc_cap_frac=0.3)
    spaces = (np.arange(32), np.arange(2048, 4096))
    errors = []

    def work(k):
        try:
            for i in range(6):
                batches = _drawn(spaces[(k + i) % 2], n=2, seed=100 * k + i)
                packed = ours.pack_window(batches)
                np.testing.assert_array_equal(_ids(ours, packed),
                                              _stack(batches))
        except Exception as e:                  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    assert ours.hot_version >= 2


@pytest.fixture(scope="module")
def host_wire(tmp_path_factory):
    """``csrc/wire.cu`` is host code: compiled here as C++ by g++, it
    stands in for the nvcc build the card loads."""
    out = tmp_path_factory.mktemp("wire") / "wire_host.so"
    subprocess.run(["g++", "-x", "c++", "-O3", "-std=c++17", "-shared",
                    "-fPIC", "-o", str(out),
                    str(_build.SRC_DIR / "wire.cu")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_the_cxx_encode_gives_the_numpy_bytes(monkeypatch, host_wire,
                                              shards, dtype):
    monkeypatch.setitem(_build._loaded, "wire", host_wire)
    numpy_wire = twire.WireFormat(8, 4096, "u8", shards, id_mode="hot8",
                                  esc_cap_frac=0.3)
    native = twire.WireFormat(8, 4096, "u8", shards, id_mode="hot8",
                              esc_cap_frac=0.3)
    for space, version in ((np.arange(32), 1), (np.arange(2048, 4096), 2),
                           (np.arange(2048, 4096), 2)):
        batches = [b._replace(sparse_ids=b.sparse_ids.astype(dtype))
                   for b in _drawn(space, n=3, seed=version)]
        want = numpy_wire.pack_window(batches)
        got = native.pack_window_native(batches)
        assert got._fields == want._fields
        for name in got._fields:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert native.hot_version == numpy_wire.hot_version == version
    rng = np.random.RandomState(1)
    flat = _batch(rng.randint(0, 4096, (2048, 8)).astype(dtype), rng)
    with pytest.raises(ValueError, match="esc_cap_frac"):
        twire.WireFormat(8, 4096, id_mode="hot8",
                         esc_cap_frac=0.05).pack_window_native([flat])
    with pytest.raises(ValueError, match="\\[0, 4096\\)"):
        native.pack_window_native([flat._replace(
            sparse_ids=flat.sparse_ids + 4096)])
    zipf = _zipf(2, b=256, rows=512, seed=9)
    for shards_ in (1, 4):
        a = twire.WireFormat(26, 512, id_mode="hot8", num_shards=shards_)
        b = twire.WireFormat(26, 512, id_mode="hot8", num_shards=shards_)
        for x, y in zip(a.pack_window_native(zipf), b.pack_window(zipf)):
            np.testing.assert_array_equal(x, y)


ROWS, DIM, B = 64, 8, 128
DCN = dict(deep_dims=(32, 16), dcn_sub_dim=4)
LOSS = dict(pointwise_weight=1.0, pairwise_weight=0.5,
            click_occurance_power=-0.5, wire_dense_mode="u8")


def _trainers(id_mode):
    jfc = JaxFC(rows_per_field=ROWS, embedding_dim=DIM)
    jtrainer = JaxTrainer(JaxDCN(**DCN), jfc,
                          JaxConfig(**LOSS, wire_id_mode=id_mode),
                          mesh=make_mesh(1))
    first = next(JaxData(rows_per_field=ROWS, num_users=40).batches(B, 1))
    jstate = jtrainer.init(jax.random.PRNGKey(0), first)
    fc = FeatureConfig(rows_per_field=ROWS, embedding_dim=DIM)
    trainer = Trainer(DCNv2Model(fc, **DCN, device="cpu"), fc,
                      TrainerConfig(**LOSS, wire_id_mode=id_mode),
                      device="cpu")
    state = trainer.init(
        torch.Generator(),
        params=from_jax_params(jax.device_get(jstate.params)),
        table=table_state_from_jax(jax.device_get(jstate.table), 1, DIM))
    return jtrainer, jstate, trainer, state


def test_train_many_packed_under_hot8_matches_packed_and_jax():
    from rec_now_tpu_torch.training import SyntheticCriteo
    batches = list(SyntheticCriteo(rows_per_field=ROWS, num_users=40)
                   .batches(B, 6, seed=4))
    runs = {}
    for id_mode in ("hot8", "packed"):
        jtrainer, jstate, trainer, state = _trainers(id_mode)
        losses, jlosses = [], []
        for lo in (0, 3):
            win = trainer.put_packed_window(batches[lo:lo + 3])
            assert (win.hot_table.shape == (26, 255)) == (id_mode == "hot8")
            state, m = trainer.train_many_packed(state, win)
            losses.append(m["loss"])
            if id_mode == "hot8":
                jstate, jm = jtrainer.train_many_packed(
                    jstate, jtrainer.put_packed_window(batches[lo:lo + 3]))
                np.testing.assert_allclose(m["loss"].numpy(),
                                           np.asarray(jm["loss"]), rtol=2e-6)
        runs[id_mode] = (torch.cat(losses), state)
        if id_mode == "hot8":
            assert trainer.wire.id_mode == "hot8"
            want = from_jax_params(jax.device_get(jstate.params))
            for name, p in state.params.items():
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[name].numpy(), atol=1e-6,
                                           err_msg=name)
            every = np.arange(trainer.fc.total_rows)
            np.testing.assert_allclose(
                state.table.table.numpy(),
                jtrainer.table.debug_read(jax.device_get(jstate.table.table),
                                          every), atol=1e-7)
    (lh, sh), (lp, sp) = runs["hot8"], runs["packed"]
    assert torch.equal(lh, lp)
    for name in sh.params:
        assert torch.equal(sh.params[name], sp.params[name]), name
    assert torch.equal(sh.table.table, sp.table.table)
    assert torch.equal(sh.table.accumulator, sp.table.accumulator)


def test_evaluate_device_under_hot8_equals_packed():
    from rec_now_tpu_torch.training import SyntheticCriteo
    evals = list(SyntheticCriteo(rows_per_field=ROWS, num_users=40)
                 .batches(B, 5, seed=9))
    got = {}
    for id_mode in ("hot8", "packed"):
        _, _, trainer, state = _trainers(id_mode)
        got[id_mode] = trainer.evaluate_device(
            state, evals, window=2, num_buckets=1024, num_group_slots=64,
            group_buckets=128)
    assert got["hot8"] == got["packed"]
