"""Port vs Flax: CINLayer, InnerPNNLayer and DNNTower.

Flax initializes the parameters; ``convert.from_jax_params`` carries
them into the port's modules; the same numpy inputs go through both.
Both sides compute in f32 on the CPU: rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rec_now_tpu.layers.cin_layer import CINLayer as FlaxCIN
from rec_now_tpu.layers.inner_pnn_layer import InnerPNNLayer as FlaxIPNN
from rec_now_tpu.models.tower import DNNTower as FlaxTower
from rec_now_tpu_torch.convert import from_jax_params
from rec_now_tpu_torch.layers.cin_layer import CINLayer
from rec_now_tpu_torch.layers.inner_pnn_layer import InnerPNNLayer
from rec_now_tpu_torch.models.tower import DNNTower

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _emb(b=16, f=6, d=4, seed=0):
    return np.random.RandomState(seed).randn(b, f, d).astype(np.float32)


@pytest.mark.parametrize("hidden", [(8, 8), (5, 4, 6)])
@pytest.mark.parametrize("sum_channel", [True, False])
@pytest.mark.parametrize("output_input", [True, False])
def test_cin_layer_matches_flax(hidden, sum_channel, output_input):
    emb = _emb()
    flax_mod = FlaxCIN(hidden_sizes=hidden)
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(emb))
    want = np.asarray(flax_mod.apply(params, jnp.asarray(emb),
                                     output_input=output_input,
                                     sum_channel=sum_channel))
    ours = CINLayer(emb.shape[1], hidden, torch.Generator(), device="cpu")
    ours.load_state_dict(from_jax_params(jax.device_get(params)))
    got = ours(torch.from_numpy(emb), output_input=output_input,
               sum_channel=sum_channel)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)


def test_cin_layer_init_matches_flax_fan():
    """Port init: shapes of the Flax params, glorot bound of the
    flattened (F*H, K) view, reproducible from the generator's seed."""
    f, hidden = 6, (8, 5)
    ours = CINLayer(f, hidden, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    flax_params = FlaxCIN(hidden_sizes=hidden).init(
        jax.random.PRNGKey(0), jnp.zeros((2, f, 4)))["params"]
    again = CINLayer(f, hidden, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    for (name, p), k, h in zip(ours.state_dict().items(), hidden,
                               (f,) + hidden[:-1]):
        assert tuple(p.shape) == flax_params[name].shape
        limit = np.sqrt(6.0 / (f * h + k))
        assert float(p.abs().max()) <= limit
        assert float(p.abs().max()) > 0.5 * limit
        torch.testing.assert_close(p, getattr(again, name), rtol=0, atol=0)


def test_inner_pnn_matches_flax():
    emb = _emb(b=9, f=7, d=5, seed=1)
    want = np.asarray(FlaxIPNN().apply({}, jnp.asarray(emb)))
    got = InnerPNNLayer()(torch.from_numpy(emb))
    assert got.shape == (9, 21)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dims", [(32,), (32, 8)])
def test_dnn_tower_matches_flax(dims):
    x = np.random.RandomState(2).randn(16, 37).astype(np.float32)
    flax_mod = FlaxTower(dims=dims)
    params = flax_mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(flax_mod.apply(params, jnp.asarray(x)))
    ours = DNNTower(37, dims, torch.Generator(), device="cpu")
    ours.load_state_dict(from_jax_params(jax.device_get(params)))
    got = ours(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
