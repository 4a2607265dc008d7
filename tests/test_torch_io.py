"""Port vs JAX: Criteo-TSV ingestion (``rec_now_tpu_torch/io``).

* ``parse_chunk``: the port's native parser (its own build of
  ``io/native/criteo_parser.cpp``) and its Python plain version against
  JAX's ``parse_chunk`` on both of JAX's paths, on the JAX test's hand
  lines and on ~5,000 generated lines parsed on 7 threads: ids, labels
  and groups exact, dense within 1e-6 relative; the partial tail not
  consumed; ``rn_fnv1a_mod`` against ``fnv1a_mod``.
* ``CriteoTSV.batches`` equal to JAX's on one file: shapes, ``skip``,
  chunk sizes down to 4 KB, ``drop_remainder=False``'s padding.
* ``write_synthetic_tsv`` byte-equal to JAX's.
* The build: into the port's ``_build/``, keyed by the source; a broken
  compiler or source raises with g++'s output, and nothing falls back
  to the Python parser.
"""
import ctypes
import filecmp

import numpy as np
import pytest
import torch

from rec_now_tpu.io import CriteoTSV as JaxTSV
from rec_now_tpu.io import fnv1a_mod as jax_fnv
from rec_now_tpu.io import parse_chunk as jax_parse
from rec_now_tpu.io import write_synthetic_tsv as jax_write
from rec_now_tpu_torch.io import (CriteoTSV, build, fnv1a_mod, parse_chunk,
                                  write_synthetic_tsv)
from rec_now_tpu_torch.io.criteo import fnv1a_mod_many

torch.set_num_threads(1)

HAND = (b"1\t3\t\t-2\t0\ta1b2c3\t\tffee\n"
        b"0\t\t7\t1\t100\tdeadbeef\tcafe\tffee\n"
        b"1\t0\t1\t2\t3\txyz\txyz\txyz\n")
PARAMS = dict(num_dense=4, num_sparse=3, rows_per_field=1000,
              group_field=0, num_groups=17)


def _generated(n=5000, seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        parts = [str(rng.randint(0, 2))]
        for _ in range(4):
            parts.append("" if rng.rand() < 0.2
                         else str(rng.randint(-5, 2000)))
        for _ in range(3):
            parts.append("" if rng.rand() < 0.2
                         else format(rng.randint(0, 1 << 32), "x"))
        rows.append("\t".join(parts))
    return ("\n".join(rows) + "\n").encode()


def _same_parse(got, want):
    assert got[4] == want[4]
    for k in (1, 2, 3):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


@pytest.mark.parametrize("buf,threads", [(HAND, None), (_generated(), 7),
                                         (_generated(2000, 1), 1)])
@pytest.mark.parametrize("ours_python", [False, True])
@pytest.mark.parametrize("theirs_python", [False, True])
def test_parse_chunk_matches_jax(buf, threads, ours_python, theirs_python):
    got = parse_chunk(buf, num_threads=threads, force_python=ours_python,
                      **PARAMS)
    want = jax_parse(buf, num_threads=threads, force_python=theirs_python,
                     **PARAMS)
    _same_parse(got, want)
    assert got[4] == buf.count(b"\n")


def test_hand_lines_semantics():
    d, i, l, g, n = parse_chunk(HAND, **PARAMS)
    assert n == 3
    np.testing.assert_array_equal(l, [1.0, 0.0, 1.0])
    assert d[0, 0] == pytest.approx(np.log1p(3.0))
    assert d[0, 1] == d[0, 2] == d[0, 3] == 0.0      # missing, -2, 0
    assert i[0, 0] == fnv1a_mod(b"a1b2c3", 1000) and i[0, 1] == 0
    assert i[2, 0] == i[2, 1] == i[2, 2]
    assert g[0] == fnv1a_mod(b"a1b2c3", 17)
    assert g[1] == fnv1a_mod(b"deadbeef", 17)


@pytest.mark.parametrize("force_python", [False, True])
def test_partial_tail_not_consumed(force_python):
    buf = b"1\t1\t2\t3\t4\ta\tb\tc\n0\t1\t2\t3\t4\ta\tb"   # no final \n
    _, _, l, _, n = parse_chunk(buf, force_python=force_python, **PARAMS)
    assert n == 1 and l.shape == (1,) and l[0] == 1.0
    empty = parse_chunk(b"0\t1", **PARAMS)
    assert empty[4] == 0 and empty[1].shape == (0, 3)


def test_fnv_matches_jax_and_the_c_abi():
    lib = build.load()
    toks = [b"", b"a", b"deadbeef", b"u0001f2e", bytes(range(256))]
    for tok in toks:
        for mod in (99991, 17, 1 << 40):
            want = jax_fnv(tok, mod)
            assert fnv1a_mod(tok, mod) == want
            assert lib.rn_fnv1a_mod(tok, len(tok), mod) == want
    words = ["u000001f", "01deadbeef", "x", "0ffffffffffffffffff", ""]
    np.testing.assert_array_equal(
        fnv1a_mod_many(words, 100_000),
        [jax_fnv(w.encode(), 100_000) for w in words])


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "criteo.tsv"
    write_synthetic_tsv(str(path), 3000, rows_per_field=5000,
                        num_users=200, seed=3)
    return str(path)


KW = dict(rows_per_field=5000, num_groups=200)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a._fields == b._fields
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            if name == "dense":
                np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(x, y, err_msg=name)
    return got


@pytest.mark.parametrize("chunk", [1 << 12, 1 << 14, 8 << 20])
@pytest.mark.parametrize("call", [
    dict(batch_size=256, num_batches=4), dict(batch_size=256, num_batches=4,
                                              skip=2),
    dict(batch_size=1024), dict(batch_size=1024, drop_remainder=False),
    dict(batch_size=512, num_batches=2, skip=1000)])
def test_criteo_tsv_batches_match_jax(tsv, chunk, call):
    got = _same_batches(CriteoTSV(tsv, chunk_bytes=chunk, **KW).batches(
        **call), JaxTSV(tsv, chunk_bytes=chunk, **KW).batches(**call))
    size = call["batch_size"]
    for b in got:
        assert b.dense.shape == (size, 13) and b.sparse_ids.shape == (size, 26)
        assert b.sparse_ids.min() >= 0 and b.sparse_ids.max() < 5000
        assert b.group_ids.max() < 200
    if call.get("skip") == 1000:
        assert got == []
    if call.get("drop_remainder") is False:
        assert len(got) == 3                              # 3,000 rows
        assert np.all(got[-1].sparse_ids[3000 - 2048:] == 0)


def test_criteo_tsv_skip_is_an_offset_and_chunks_change_nothing(tsv):
    full = list(CriteoTSV(tsv, **KW).batches(256, 6))
    for a, b in zip(full[2:], CriteoTSV(tsv, **KW).batches(256, 4, skip=2)):
        np.testing.assert_array_equal(a.sparse_ids, b.sparse_ids)
        np.testing.assert_array_equal(a.labels, b.labels)
    tiny = CriteoTSV(tsv, chunk_bytes=1 << 12, **KW).batches(256, 6)
    python = CriteoTSV(tsv, force_python=True, **KW).batches(256, 6)
    for a, b, c in zip(full, tiny, python):
        for x in (b, c):
            np.testing.assert_array_equal(a.sparse_ids, x.sparse_ids)
            np.testing.assert_array_equal(a.group_ids, x.group_ids)
            np.testing.assert_allclose(a.dense, x.dense, rtol=1e-6)
    _, counts = np.unique(full[0].group_ids, return_counts=True)
    assert counts.max() >= 2                 # zipf users share groups


@pytest.mark.parametrize("kw", [
    dict(num_rows=500, rows_per_field=256, num_users=16),
    dict(num_rows=700, rows_per_field=100_000, num_users=5000, seed=4,
         sample_seed=11, missing_rate=0.3),
    dict(num_rows=300, num_dense=2, num_sparse=5, rows_per_field=64,
         num_users=3)])
def test_write_synthetic_tsv_is_byte_equal_to_jax(tmp_path, kw):
    ours, theirs = tmp_path / "ours.tsv", tmp_path / "theirs.tsv"
    write_synthetic_tsv(str(ours), **kw)
    jax_write(str(theirs), **kw)
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert ours.read_bytes().count(b"\n") == kw["num_rows"]


def test_build_is_keyed_and_lives_in_the_port(monkeypatch, tmp_path):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parent.name == "rec_now_tpu_torch"
    assert path.name.startswith("recio-") and path.suffix == ".so"
    lib = build.load()
    assert path.exists() and lib is build.load()
    # another source is another library
    src = tmp_path / "criteo_parser.cpp"
    src.write_text(build.SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(build, "SRC", src)
    assert build.library_path() != path


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        parse_chunk(HAND, **PARAMS)
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        list(CriteoTSV(__file__).batches(4))
    # a source the compiler refuses: its error comes back
    monkeypatch.setattr(build, "CXX", "g++")
    bad = tmp_path / "criteo_parser.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(build, "SRC", bad)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        build.load()
    assert build._lib is None and not list((tmp_path / "_build").iterdir())
    # the plain version runs only when asked
    assert parse_chunk(HAND, force_python=True, **PARAMS)[4] == 3


def test_native_parser_runs_in_threads_without_the_interpreter_lock():
    """The parse is one foreign call (ctypes releases the lock): threads
    parsing at once give each its own, equal results."""
    import threading
    buf = _generated(3000, 5)
    want = parse_chunk(buf, num_threads=2, **PARAMS)
    out = [None] * 6

    def work(k):
        out[k] = parse_chunk(buf, num_threads=2, **PARAMS)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for got in out:
        _same_parse(got, want)
    assert isinstance(build.load(), ctypes.CDLL)
