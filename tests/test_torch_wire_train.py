"""Port vs JAX: the training half of the compressed wire.

``pack`` and ``pack_window`` are numpy on both sides and must give the
same bytes field by field (f16 and u8 dense, one and two affine shards,
remapped and raw groups).  ``decode`` runs on tensors in the port (the
words as int32 and the groups as int16 bit patterns) and must give JAX's
values exactly: the u8 affine is one fused multiply-add on both sides
(JAX's decode jitted, as its trainer runs it).
Where JAX's ``pack`` ignores its ``num_shards`` override in the escape
placeholder (``wire.py:377``), the port honors it.  The port's windows
carry one field more, the hot8 table (empty here, in the packed id mode;
``test_torch_wire_hot8.py`` holds the hot8 mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.training import wire as jwire
from rec_now_tpu.training.data import SyntheticCriteo as JaxCriteo
from rec_now_tpu_torch.training import wire as twire

torch.set_num_threads(1)

ROWS = 512


def _batches(n=3, b=64, seed=0):
    return list(JaxCriteo(rows_per_field=ROWS, num_users=20,
                          seed=seed).batches(b, n, seed=seed + 1))


def _same_bytes(got, want, skip=()):
    # the port's window also carries its hot8 table: empty in packed mode
    assert got._fields == want._fields + ("hot_table",)
    assert got.hot_table.shape == (0, 255)
    for name in want._fields:
        if name in skip:
            continue
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("mode", ["f16", "u8"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("raw", [False, True])
def test_pack_window_matches_jax(mode, shards, raw):
    batches = _batches()
    ours = twire.WireFormat(26, ROWS, dense_mode=mode, num_shards=shards)
    theirs = jwire.WireFormat(26, ROWS, dense_mode=mode, num_shards=shards)
    _same_bytes(ours.pack_window(batches, raw_groups=raw),
                theirs.pack_window(batches, raw_groups=raw))


@pytest.mark.parametrize("mode", ["f16", "u8"])
def test_pack_matches_jax_and_honors_the_shard_override(mode):
    (batch,) = _batches(1)
    ours = twire.WireFormat(26, ROWS, dense_mode=mode)
    theirs = jwire.WireFormat(26, ROWS, dense_mode=mode)
    _same_bytes(ours.pack(batch), theirs.pack(batch))
    got, want = ours.pack(batch, num_shards=4), theirs.pack(batch,
                                                            num_shards=4)
    _same_bytes(got, want, skip=("esc",))
    assert got.dense_scale.shape[-3] == 4
    # JAX keeps the instance's one shard in the placeholder; the port
    # gives every field the override's four
    assert want.esc.shape == (1, 1) and got.esc.shape == (4, 1)
    win = ours.pack_window(_batches(2), num_shards=2)
    assert win.esc.shape == (2, 2, 1) and win.dense_scale.shape[:2] == (2, 2)


@pytest.mark.parametrize("mode", ["f16", "u8"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("raw", [False, True])
def test_decode_matches_jax(mode, shards, raw):
    batches = _batches(seed=3)
    ours = twire.WireFormat(26, ROWS, dense_mode=mode, num_shards=shards)
    theirs = jwire.WireFormat(26, ROWS, dense_mode=mode, num_shards=shards)
    packed = theirs.pack_window(batches, raw_groups=raw)
    # jitted, as the JAX trainer runs it (XLA fuses the u8 affine)
    want = jax.jit(theirs.decode)(jwire.PackedBatch(*[jnp.asarray(x)
                                                      for x in packed]))
    got = ours.decode(twire.to_tensors(packed))
    names = ("dense", "ids", "labels", "groups", "cvr", "domain")
    for name, a, b in zip(names, got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    stacked = np.stack([b.sparse_ids for b in batches])
    np.testing.assert_array_equal(got[1].numpy(), stacked)
    if raw:
        np.testing.assert_array_equal(
            got[3].numpy(), np.stack([b.group_ids for b in batches]))


def test_decode_groups_past_int16():
    """Group ids above 32,767 survive the int16 bit patterns."""
    batch = _batches(1)[0]
    slots = np.arange(64, dtype=np.int32) * 1000 + 1          # up to 63,001
    packed = twire.WireFormat(26, ROWS).pack_window(
        [batch._replace(group_ids=slots)], raw_groups=True)
    got = twire.WireFormat(26, ROWS).decode(twire.to_tensors(packed))[3]
    np.testing.assert_array_equal(got.numpy()[0], slots)


def test_flags_domain_and_group_limits_raise():
    batch = _batches(1)[0]
    wire = twire.WireFormat(26, ROWS)
    with pytest.raises(ValueError, match=">= 64"):
        wire.pack(batch._replace(domain_idx=batch.domain_idx + 62))
    with pytest.raises(ValueError, match="65536"):
        twire.raw_groups_u16(np.array([0, 70000]))
    with pytest.raises(ValueError, match="65535"):
        twire.remap_groups(np.zeros((1, 70000), np.int32))
    with pytest.raises(ValueError, match="divide"):
        twire.WireFormat(26, ROWS, num_shards=3).pack(batch)
    with pytest.raises(ValueError, match="2\\^24"):
        twire.WireFormat(26, 1 << 25, id_mode="hot8")
    with pytest.raises(ValueError, match="id_mode"):
        twire.WireFormat(26, ROWS, id_mode="hot16")
    with pytest.raises(ValueError, match="num_shards"):
        twire.WireFormat(26, ROWS, num_shards=0)


@pytest.mark.parametrize("mode", ["f16", "u8"])
@pytest.mark.parametrize("rows", [512, 100_000])
def test_wire_cost_matches_jax(mode, rows):
    assert twire.WireFormat.wire_cost(13, 26, rows, mode) == \
        jwire.WireFormat.wire_cost(13, 26, rows, mode)
