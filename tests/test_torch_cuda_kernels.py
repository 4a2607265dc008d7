"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (marked ``cuda``; they skip
elsewhere).  Run on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda``.
Shapes are the small odd ones of the JAX kernel tests plus edge cases
(one field, one channel, K past one 64-channel chunk, ragged M).
Tolerance: f32 with a different summation order, 1e-5 relative to the
largest output.
"""
import pytest
import torch

from rec_now_tpu_torch.ops import cin_kernel as ck

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(gen, dev, *shape):
    return torch.randn(shape, generator=gen).to(dev)


def _close(got, want):
    assert got.shape == want.shape
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("m,f,h,k", [(32, 5, 6, 7), (15, 4, 4, 4),
                                     (1, 1, 1, 1), (300, 26, 26, 64),
                                     (129, 3, 70, 130)])
def test_cin_flat_matches_plain(dev, m, f, h, k):
    gen = torch.Generator().manual_seed(m + k)
    x0, prev = _rand(gen, dev, m, f), _rand(gen, dev, m, h)
    w = _rand(gen, dev, k, f, h)
    before = ck.cin_flat.launches
    _close(ck.cin_flat(x0, prev, w), ck.cin_flat_plain(x0, prev, w))
    assert ck.cin_flat.launches == before + 1


@pytest.mark.parametrize("hidden", [(5,), (5, 4), (5, 4, 6), (1, 65)])
@pytest.mark.parametrize("output_input", [True, False])
@pytest.mark.parametrize("m", [15, 257])
def test_cin_stack_sum_matches_plain(dev, hidden, output_input, m):
    gen = torch.Generator().manual_seed(m)
    f = 4
    x0 = _rand(gen, dev, m, f)
    ws = [_rand(gen, dev, k, f, h) * 0.3
          for k, h in zip(hidden, (f,) + hidden[:-1])]
    before = ck.cin_stack_sum.launches
    _close(ck.cin_stack_sum(x0, ws, output_input),
           ck.cin_stack_sum_plain(x0, ws, output_input))
    assert ck.cin_stack_sum.launches == before + 1


def test_wrappers_reject_bad_inputs(dev):
    x0 = torch.zeros(8, 4, device=dev)
    with pytest.raises(TypeError):
        ck.cin_flat(x0.double(), x0.double(),
                    torch.zeros(2, 4, 4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        ck.cin_flat(x0, torch.zeros(8, 3, device=dev),
                    torch.zeros(2, 4, 4, device=dev))
    with pytest.raises(ValueError):
        ck.cin_stack_sum(x0.t(), [torch.zeros(2, 8, 8, device=dev)])
    with pytest.raises(ValueError):
        ck.cin_stack_sum(x0, [])
