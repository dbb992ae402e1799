"""The port's bias-gradient op (veles_torch/znicz/ops/bias_grad.py)
against the JAX package's Pallas kernel (ops/pallas_grads.py, interpret
mode on the CPU), and the port's activation table against the
reference's. Inputs come from a numpy seed and go to both packages."""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles.znicz_tpu.ops import activations as JA
from veles.znicz_tpu.ops import pallas_grads as PG
from veles_torch.znicz.ops import activations as TA
from veles_torch.znicz.ops import bias_grad as TBG

SHAPES = [(128, 96), (96, 7), (100, 5)]


def _inputs(shape, seed=77):
    rng = numpy.random.default_rng(seed)
    return (rng.normal(0, 1.0, shape).astype(numpy.float32),
            rng.normal(0, 1.0, shape).astype(numpy.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", sorted(JA.ACTIVATIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bias_grad_matches_pallas(shape, act, dtype):
    """Every activation, tile-friendly and awkward shapes, f32 and bf16
    inputs; the result is f32 in both packages and agrees to 2e-4
    (summation order differs)."""
    err, y = _inputs(shape)
    want = numpy.asarray(PG.bias_grad(
        jnp.asarray(err, dtype), jnp.asarray(y, dtype), act))
    got = TBG.bias_grad(torch.from_numpy(err).to(getattr(torch, dtype)),
                        torch.from_numpy(y).to(getattr(torch, dtype)), act)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (shape[1],)
    assert numpy.allclose(got.numpy(), want, atol=2e-4), \
        numpy.abs(got.numpy() - want).max()


def test_bias_grad_rejects_bad_inputs():
    x = torch.zeros((8, 4))
    with pytest.raises(KeyError):
        TBG.bias_grad(x, x, "no_such_activation")
    with pytest.raises(ValueError):
        TBG.bias_grad(x, torch.zeros((8, 5)), "linear")
    with pytest.raises(ValueError):
        TBG.bias_grad(torch.zeros(8), torch.zeros(8), "linear")


@pytest.mark.parametrize("act", sorted(JA.ACTIVATIONS))
def test_activation_table_matches_reference(act):
    """Forward and derivative-by-output of the port's table equal the
    reference formulas on the same f32 inputs."""
    v, y = _inputs((64, 10), seed=5)
    jf, jd = JA.ACTIVATIONS[act]
    tf, td = TA.ACTIVATIONS[act]
    assert numpy.allclose(tf(torch.from_numpy(v)).numpy(), jf(numpy, v),
                          atol=1e-6)
    want = jd(numpy, y)
    got = td(torch.from_numpy(y))
    assert isinstance(got, float) == isinstance(want, float)
    assert TA.is_identity(act) == isinstance(want, float)
    if not isinstance(want, float):
        assert numpy.allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1), (100, 10), (100, 100),
                                   (72900, 96), (4097, 1000),
                                   (10 ** 8, 3)], ids=str)
def test_launch_plan_covers_every_row(shape):
    """The pass-1 grid tiles all N rows exactly once: chunks of
    ``rows_per_block``, the last one possibly short, never empty."""
    n, k = shape
    bx, row_blocks, rows_per_block = TBG.plan(n, k)
    assert TBG.THREADS % bx == 0 and bx >= 8
    assert 1 <= row_blocks <= 65535
    assert (row_blocks - 1) * rows_per_block < n <= \
        row_blocks * rows_per_block
