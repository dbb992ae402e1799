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

#: tile-friendly and awkward shapes, and the LM's column counts (its
#: bias gradients at the 110M shape, N cut from 4096 to 256 rows so that
#: interpret mode stays fast)
SHAPES = [(128, 96), (96, 7), (100, 5), (256, 768), (256, 2304),
          (256, 3072), (256, 16384)]


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


#: (N, K, itemsize) of the plan tests: MNIST's, the LM's at the 110M
#: shape, the conv and wide shapes of the kernel checks, degenerate ones
PLAN_SHAPES = [(1, 1, 4), (100, 10, 2), (100, 100, 2), (100, 100, 4),
               (4096, 768, 2), (4096, 2304, 2), (4096, 16384, 2),
               (4096, 768, 4), (4096, 3072, 4), (72900, 96, 2),
               (4097, 1000, 2), (4097, 1000, 4), (333, 40, 2), (10 ** 8, 3, 4),
               (7, 100000, 2), (57600, 9, 2), (57600, 9, 4), (20000, 8, 2),
               (20000, 8, 4)]


def _covered(n, k, p):
    """How often the launch of plan ``p`` reads each row and each column
    of an (n, k) input, as the kernel's loops do: (rows, columns)."""
    rows = numpy.zeros(n, numpy.int64)
    for b in range(p.row_blocks):
        r0, r1 = b * p.rows_per_block, min((b + 1) * p.rows_per_block, n)
        for ty in range(p.ty):
            rows[r0 + ty:r1:p.ty] += 1
    cols = numpy.zeros(k, numpy.int64)
    for c in range(p.col_tiles):
        for tx in range(p.tx):
            col = (c * p.tx + tx) * p.vec
            if col < k:
                cols[col:col + p.vec] += 1
    return rows, cols


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_launch_plan_covers_every_row(shape, aligned):
    """The grid reads every row and every column exactly once: row blocks
    of ``rows_per_block`` (the last possibly short, never empty), lanes
    interleaved over each, and column tiles of ``tx`` packs of ``vec``
    columns; at most THREADS threads a CTA and MAX_ROW_BLOCKS row
    blocks."""
    n, k, itemsize = shape
    p = TBG.plan(n, k, itemsize, aligned)
    assert 1 <= p.tx * p.ty <= TBG.THREADS and p.tx <= TBG.WARP
    assert 1 <= p.row_blocks <= TBG.MAX_ROW_BLOCKS
    assert (p.row_blocks - 1) * p.rows_per_block < n <= \
        p.row_blocks * p.rows_per_block
    assert k % p.vec == 0
    if n > 10 ** 6:
        return
    rows, cols = _covered(n, k, p)
    assert (rows == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_vector_path_only_where_aligned(shape):
    """16-byte loads (``vec`` = 16 / itemsize) exactly where the base
    pointers are 16-byte aligned and so is the row pitch K·itemsize; one
    element a thread everywhere else (MNIST's K = 10 and 100 in bf16, a
    view at an odd offset)."""
    n, k, itemsize = shape
    pitch_ok = (k * itemsize) % 16 == 0
    assert TBG.plan(n, k, itemsize, True).vec == \
        (16 // itemsize if pitch_ok else 1)
    assert TBG.plan(n, k, itemsize, False).vec == 1
    assert TBG.plan(100, 100, 2).vec == TBG.plan(100, 10, 2).vec == 1
    assert TBG.plan(4096, 768, 2).vec == 8
    assert TBG.plan(4096, 3072, 4).vec == 4


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_cross_cta_order_is_fixed_by_the_shape(shape):
    """The last CTA of a column tile adds every row block's partial once,
    lane ``ty`` over row blocks ``ty, ty + TY, ...`` and then the lanes in
    order: a function of the plan, which is a function of (N, K, itemsize,
    alignment) alone. One ticket per column tile; one row block needs no
    ticket and no partials."""
    n, k, itemsize = shape
    p = TBG.plan(n, k, itemsize)
    assert p == TBG.plan(n, k, itemsize)
    order = TBG.sum_order(p)
    assert len(order) == p.ty
    assert sorted(rb for lane in order for rb in lane) == \
        list(range(p.row_blocks))
    for lane, blocks in enumerate(order):
        assert blocks == sorted(blocks)
        assert all(rb % p.ty == lane for rb in blocks)
    units = k // p.vec
    assert (p.col_tiles - 1) * p.tx < units <= p.col_tiles * p.tx


@pytest.mark.parametrize("k", [10, 96, 768, 16384])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_grid_fills_the_card_at_every_width(k, itemsize):
    """At N = 72900 (the conv shape) the grid holds two to four CTAs per
    SM of an H100 (132 SMs) whether K is 10, 96, 768 or 16384; at the
    110M LM step's N = 4096, at least one per SM where K is 768 or
    wider."""
    p = TBG.plan(72900, k, itemsize)
    assert 2 * 132 <= p.col_tiles * p.row_blocks <= 4 * 132, p
    if k >= 768:
        p = TBG.plan(4096, k, itemsize)
        assert 132 <= p.col_tiles * p.row_blocks <= 4 * 132, p


def test_tickets_are_one_zeroed_buffer_per_stream():
    """The tickets: int32 zeros, at least one per column tile, kept per
    (device, stream) and grown when a wider plan needs more."""
    dev = torch.device("cpu")
    a = TBG.tickets(dev, 1, 64)
    assert a.dtype == torch.int32 and a.numel() >= 64 and not a.any()
    assert TBG.tickets(dev, 1, 10) is a
    assert TBG.tickets(dev, 2, 10) is not a
    wide = TBG.tickets(dev, 1, a.numel() + 1)
    assert wide.numel() > a.numel() and not wide.any()
    assert TBG.tickets(dev, 1, 5) is wide


#: the autoencoders' conv GD views: MnistAE's conv_tanh at minibatch 100
#: (100·24·24, 9) and VideoAE's at minibatch 50 (50·20·20, 8), with the
#: plan each dtype takes: K = 9 is no multiple of a 16-byte pack in
#: either dtype (the scalar path, 9 × 28 = 252 threads, warps straddling
#: rows); K = 8 is one in both (f32: 2 packs of 4; bf16: 1 pack of 8)
AE_PLANS = [((57600, 9), 4, (1, 9, 28)), ((57600, 9), 2, (1, 9, 28)),
            ((20000, 8), 4, (4, 2, 128)), ((20000, 8), 2, (8, 1, 256))]


def kernel_model(err, y, activation, p):
    """The sums of csrc/bias_grad.cu under plan ``p``, in float32 numpy:
    each lane's rows in order, the lanes of a CTA in order, then the row
    blocks' partials in :func:`sum_order`. The kernel's own rounding may
    differ where its compiler fuses a multiply and an add."""
    n, k = err.shape
    d = TA.ACTIVATIONS[activation][1](torch.from_numpy(y))
    dz = err if isinstance(d, float) else err * d.numpy()
    dz = dz.astype(numpy.float32)
    lanes_rows = -(-p.rows_per_block // p.ty) * p.ty
    blocks = numpy.zeros((p.row_blocks, lanes_rows, k), numpy.float32)
    for b in range(p.row_blocks):
        part = dz[b * p.rows_per_block:(b + 1) * p.rows_per_block]
        blocks[b, :len(part)] = part
    blocks = blocks.reshape(p.row_blocks, -1, p.ty, k)
    lane = blocks[:, 0].copy()
    for j in range(1, blocks.shape[1]):
        lane += blocks[:, j]
    partial = lane[:, 0].copy()
    for t in range(1, p.ty):
        partial += lane[:, t]
    if p.row_blocks == 1:
        return partial[0]
    order = TBG.sum_order(p)
    acc = numpy.zeros((p.ty, k), numpy.float32)
    for t, rbs in enumerate(order):
        for rb in rbs:
            acc[t] += partial[rb]
    out = acc[0].copy()
    for t in range(1, p.ty):
        out += acc[t]
    return out


@pytest.mark.parametrize("case", AE_PLANS,
                         ids=lambda c: "%s-%dB" % (c[0], c[1]))
def test_autoencoder_shapes(case):
    """The plan at the autoencoders' shapes, and its sums (the kernel's
    order, modelled in f32) and the plain version within the card check's
    bound of the float64 sum: 1e-4·Σ|dz| per column (chip_smoke.py
    TOLERANCE), tanh, inputs rounded to the dtype."""
    (n, k), itemsize, (vec, tx, ty) = case
    p = TBG.plan(n, k, itemsize)
    assert (p.vec, p.tx, p.ty) == (vec, tx, ty)
    assert p.col_tiles == 1 and p.row_blocks > 1
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    err, y = (torch.from_numpy(a).to(dtype).float().numpy()
              for a in _inputs((n, k), seed=9))
    d = 1.7159 * 2 / 3 - (2 / 3 / 1.7159) * y.astype(numpy.float64) ** 2
    dz = err.astype(numpy.float64) * d
    exact, limit = dz.sum(0), 1e-4 * numpy.abs(dz).sum(0)
    model = kernel_model(err, y, "tanh", p)
    plain = TBG.bias_grad_plain(torch.from_numpy(err).to(dtype),
                                torch.from_numpy(y).to(dtype), "tanh")
    assert (numpy.abs(model - exact) <= limit).all()
    assert (numpy.abs(plain.numpy() - exact) <= limit).all()
