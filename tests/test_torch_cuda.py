"""Tests of the port that need a CUDA card; they skip without one.

This file imports neither jax nor the JAX package, so it runs on a card
host that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy
import pytest
import torch

from veles_torch.znicz.ops import activations as TA
from veles_torch.znicz.ops import bias_grad as TBG


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_grad_kernel_matches_plain(card, dtype):
    """Every activation: the kernel agrees with its plain version, two
    launches agree bitwise, and each launch is counted once."""
    rng = numpy.random.default_rng(77)
    err = torch.from_numpy(rng.normal(0, 1, (4097, 100)).astype(
        numpy.float32)).to(card, dtype)
    y = torch.from_numpy(rng.normal(0, 1, (4097, 100)).astype(
        numpy.float32)).to(card, dtype)
    for act in sorted(TA.ACTIVATIONS):
        before = TBG.bias_grad.launches
        got = TBG.bias_grad(err, y, act)
        assert TBG.bias_grad.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (100,)
        assert torch.equal(got, TBG.bias_grad(err, y, act)), act
        want = TBG.bias_grad_plain(err, y, act)
        assert torch.allclose(got, want, atol=2e-4), \
            (act, (got - want).abs().max().item())


@pytest.mark.cuda
def test_bias_grad_kernel_refuses_what_it_does_not_take(card):
    e = torch.zeros((64, 32), device=card)
    with pytest.raises(ValueError):
        TBG.bias_grad(e.t(), e.t(), "tanh")
    with pytest.raises(TypeError):
        TBG.bias_grad(e, e.to(torch.bfloat16), "tanh")
    with pytest.raises(TypeError):
        TBG.bias_grad(e.double(), e.double(), "tanh")
    with pytest.raises(ValueError):
        TBG.bias_grad(e, e.cpu(), "tanh")
