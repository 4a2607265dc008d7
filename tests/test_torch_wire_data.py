"""Port vs JAX: the synthetic stream and the request wire.

The same numpy inputs go through ``rec_now_tpu`` and ``rec_now_tpu_torch``;
packing is numpy on both sides and must agree bit for bit, decoding runs
on tensors in the port and must give the same values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.training import wire as jwire
from rec_now_tpu.training.data import SyntheticCriteo as JaxCriteo
from rec_now_tpu_torch.training import wire as twire
from rec_now_tpu_torch.training.data import SyntheticCriteo

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_criteo_identical_batches(seed):
    kw = dict(rows_per_field=512, num_users=50, seed=seed)
    ours = list(SyntheticCriteo(**kw).batches(64, 3, seed=seed + 1))
    theirs = list(JaxCriteo(**kw).batches(64, 3, seed=seed + 1))
    for a, b in zip(ours, theirs):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("rows", [3, 512, 100_000, 2 ** 20, 2 ** 32 - 1])
def test_pack_ids_matches_jax(rows):
    rng = np.random.RandomState(rows % 1000)
    ids = rng.randint(0, rows, size=(5, 7, 26), dtype=np.int64)
    bits = twire.id_bits(rows)
    assert bits == jwire.id_bits(rows)
    assert twire.num_words(26, bits) == jwire.num_words(26, bits)
    np.testing.assert_array_equal(twire.pack_ids(ids, bits),
                                  jwire.pack_ids(ids, bits))


@pytest.mark.parametrize("rows", [3, 512, 100_000, 2 ** 20])
def test_unpack_ids_matches_jax(rows):
    rng = np.random.RandomState(1)
    ids = rng.randint(0, rows, size=(64, 26)).astype(np.int32)
    bits = jwire.id_bits(rows)
    words = jwire.pack_ids(ids, bits)
    want = np.asarray(jwire.unpack_ids(jnp.asarray(words), 26, bits))
    got = twire.unpack_ids(torch.from_numpy(words.view(np.int32)), 26, bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ids)


@pytest.mark.parametrize("rows", [2, 2 ** 31, 2 ** 32 - 1])
def test_unpack_ids_roundtrip_wide(rows):
    """Ids up to 32 bits survive pack -> int32 bit patterns -> unpack."""
    ids = np.random.RandomState(2).randint(0, rows, size=(3, 4, 26),
                                           dtype=np.int64)
    bits = twire.id_bits(rows)
    words = twire.pack_ids(ids, bits)
    got = twire.unpack_ids(torch.from_numpy(words.view(np.int32)), 26, bits)
    np.testing.assert_array_equal(got.numpy(), ids)


@pytest.mark.parametrize("mode", ["f16", "u8"])
@pytest.mark.parametrize("batch", [1, 64])
def test_pack_and_decode_dense_match_jax(mode, batch):
    """Same bytes as the JAX wire's one-shard packing; B = 1 gives the u8
    affine a zero step."""
    rng = np.random.RandomState(3)
    dense = (rng.randn(batch, 13) * 3).astype(np.float32)
    ids = rng.randint(0, 512, size=(batch, 26)).astype(np.int32)
    ours = twire.WireFormat(26, 512, dense_mode=mode)
    theirs = jwire.WireFormat(26, 512, dense_mode=mode)
    packed = ours.pack_request(dense, ids)
    for a, b in zip(packed, theirs.pack_request(dense, ids)):
        assert a.dtype == b.dtype
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    q, scale, _ = packed
    want = np.asarray(theirs.decode_dense(jnp.asarray(q),
                                          jnp.asarray(scale)))
    got = ours.decode_dense(torch.from_numpy(q), torch.from_numpy(scale))
    # f32 multiply-add on both sides; XLA may contract it into one FMA
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wire_format_rejects_bad_arguments():
    for mode in ("bf16", "U8", None):
        with pytest.raises(ValueError, match="unknown dense_mode"):
            twire.WireFormat(26, 512, dense_mode=mode)


def test_global_ids_match_jax():
    from rec_now_tpu.models import FeatureConfig as JaxFC
    from rec_now_tpu_torch.models import FeatureConfig
    raw = np.random.RandomState(4).randint(0, 3000, size=(32, 26)
                                           ).astype(np.int32)
    want = np.asarray(JaxFC(rows_per_field=512).global_ids(jnp.asarray(raw)))
    got = FeatureConfig(rows_per_field=512).global_ids(torch.from_numpy(raw))
    np.testing.assert_array_equal(got.numpy(), want)
