"""Tests of the port that need a CUDA card (the bias-gradient and
flash-attention kernels, the bf16 wgmma forward and backward and the
two-kernel backward's too, against their plain versions, and their
refusals; the f32 products of ``TorchDevice.dot``; the repeatable
embedding gradient); they skip without one.

This file imports neither jax nor the JAX package, so it runs on a card
host that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json

import numpy
import pytest
import torch

from veles_torch.znicz.ops import activations as TA
from veles_torch.znicz.ops import bias_grad as TBG

#: the bias gradient against the float64 math, per column: TOLERANCE
#: times the column's sum of |dz| (chip_smoke.py's limit: f32 sums taken
#: in another order)
TOLERANCE = 1e-4


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


def _device_kernels(fn, tmp_path):
    """Names of the device kernels ``fn()`` launches, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def _misaligned(t):
    """A contiguous copy of ``t`` two elements past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[2:2 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype, acts, offset", [
    ((4096, 768), torch.bfloat16, ("linear", "tanh"), False),
    ((4096, 2304), torch.bfloat16, ("linear", "tanh"), False),
    ((4096, 16384), torch.bfloat16, ("linear", "tanh"), False),
    ((4096, 768), torch.float32, ("linear", "tanh"), False),
    ((4096, 3072), torch.float32, ("linear", "tanh"), False),
    ((4097, 10), torch.bfloat16, tuple(sorted(TA.ACTIVATIONS)), False),
    ((4097, 100), torch.bfloat16, tuple(sorted(TA.ACTIVATIONS)), False),
    ((100, 100), torch.float16, tuple(sorted(TA.ACTIVATIONS)), False),
    ((4096, 768), torch.bfloat16, ("linear", "tanh"), True),
    ((999, 100), torch.float32, ("linear", "sigmoid"), True)], ids=str)
def test_bias_grad_kernel_at_lm_and_misaligned_shapes(card, tmp_path, shape,
                                                      dtype, acts, offset):
    """The LM's shapes (vector path) and misaligned ones (K = 10 and 100
    in bf16, views two elements past a 16-byte boundary: the scalar
    path): within TOLERANCE·Σ|dz| of the float64 math, two launches
    bitwise equal, one device kernel per call."""
    rng = numpy.random.default_rng(shape[1])
    err, y = (torch.from_numpy(rng.normal(0, 1, shape).astype(
        numpy.float32)).to(card, dtype) for _ in range(2))
    if offset:
        err, y = _misaligned(err), _misaligned(y)
    for act in acts:
        got = TBG.bias_grad(err, y, act)
        again = TBG.bias_grad(err, y, act)
        assert torch.equal(got, again), act
        d = TA.ACTIVATIONS[act][1](y.double())
        dz = err.double() if isinstance(d, float) else err.double() * d
        diff = (got.double() - dz.sum(0)).abs()
        assert bool((diff <= TOLERANCE * dz.abs().sum(0)).all()), \
            (act, diff.max().item())
    names = _device_kernels(lambda: TBG.bias_grad(err, y, acts[-1]),
                            tmp_path)
    assert len(names) == 1 and "bias_grad_kernel" in names[0], names


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


def _flash_inputs(card, shape, dtype, seed=7):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=card).to(dtype)
                 for _ in range(4))


def _rel(got, want):
    """Worst element of ``got`` against ``want``, each held to its own
    size and the rms of its row (out and dq rows are queries, dk and dv
    rows keys: a causal row shrinks with its position, so a tensor-wide
    scale would leave the later rows unchecked), beyond 1e-6·max|want|
    for f32 sums that cancel to 0 (dq of row 0 in a causal run)."""
    g, w = got.double(), want.double()
    d = (g - w).abs() - 1e-6 * w.abs().max()
    scale = w.abs() + w.square().mean(-1, keepdim=True).sqrt()
    return (d.clamp_min(0) / scale.clamp_min(1e-300)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (2, 3, 200, 64),
                                   (1, 2, 96, 128)], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(card, dtype, causal, shape):
    """Forward, pipelined forward and fused backward against their plain
    versions (``_rel``: 1e-4 in f32, 2e-2 in bf16),
    two launches bitwise equal, each launch counted once by variant."""
    from veles_torch.znicz.ops import flash_attention as FA
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q, k, v, dout = _flash_inputs(card, shape, dtype)
    want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v, causal)
    FA.reset_launches()
    for pipeline in (False, True):
        out, lse = FA.flash_attention_fwd(q, k, v, causal, pipeline)
        again = FA.flash_attention_fwd(q, k, v, causal, pipeline)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert out.dtype == dtype and lse.dtype == torch.float32
        assert _rel(out, want_out) <= tol
        assert (lse - want_lse).abs().max().item() <= 1e-3
    assert FA.flash_attention_fwd.variant_launches == {"fwd": 2,
                                                       "fwd_pipe": 2}
    grads = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    assert FA.flash_attention_bwd.launches == 2
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    for g, a, w in zip(grads, again, want):
        assert torch.equal(g, a) and g.dtype == dtype
        assert _rel(g, w) <= tol


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(card):
    from veles_torch.znicz.ops import flash_attention as FA
    q, k, v, dout = _flash_inputs(card, (1, 2, 64, 16), torch.float32)
    out, lse = FA.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q.transpose(2, 3).contiguous()
                               .transpose(2, 3), k, v)
    wide = torch.zeros((1, 2, 64, 160), device=card)
    with pytest.raises(ValueError, match="ROADMAP"):
        FA.flash_attention_fwd(wide, wide, wide)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(
            q, k, v, out, lse.transpose(1, 2).contiguous().transpose(1, 2),
            dout)
    FA.reset_launches()
    FA.flash_attention_bwd(q, k, v, out, lse, dout, fused=False)
    torch.cuda.synchronize()
    assert FA.flash_attention_bwd.variant_launches == {"fused": 0, "dq": 1,
                                                       "dkv": 1}
    with pytest.raises(ValueError):
        FA.flash_attention_dq(q, k, v, out, lse.cpu(), dout)
    with pytest.raises(ValueError):
        FA.flash_attention_dkv(q, k, v, out, lse, dout, delta=lse[..., :8])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (2, 3, 200, 64),
                                   (1, 2, 96, 128), (1, 2, 130, 32)],
                         ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_two_kernel_backward_matches_plain(card, dtype, causal,
                                                 shape):
    """The dq and dk/dv kernels (``fused=False``) against their plain
    versions and against the fused kernel (``_rel``: 1e-4 in f32, 2e-2 in
    bf16); two launches, and a hoisted delta, bitwise equal; each launch
    counted once by variant."""
    from veles_torch.znicz.ops import flash_attention as FA
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q, k, v, dout = _flash_inputs(card, shape, dtype, seed=11)
    out, lse = FA.flash_attention_fwd(q, k, v, causal)
    FA.reset_launches()
    two = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                 fused=False)
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                   delta=FA.row_delta(out, dout),
                                   fused=False)
    fused = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    dq = FA.flash_attention_dq(q, k, v, out, lse, dout, causal)
    dk, dv = FA.flash_attention_dkv(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert FA.flash_attention_bwd.variant_launches == {"fused": 1, "dq": 3,
                                                       "dkv": 3}
    assert FA.flash_attention_bwd.launches == 7
    want = (FA.flash_attention_dq_plain(q, k, v, out, lse, dout, causal),
            *FA.flash_attention_dkv_plain(q, k, v, out, lse, dout, causal))
    for g, a, alone, f, w in zip(two, again, (dq, dk, dv), fused, want):
        assert torch.equal(g, a) and torch.equal(g, alone)
        assert g.dtype == dtype
        assert _rel(g, w) <= tol
        assert _rel(g, f) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (1, 2, 130, 32),
                                   (4, 4, 256, 32), (2, 3, 200, 64),
                                   (1, 2, 96, 128), (2, 3, 200, 128)],
                         ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fused_backward_sm90_matches_plain(card, causal, shape):
    """The bf16 fused backward (the wgmma kernel of csrc/flash_bwd_sm90.cu)
    at every head dim it takes, S ragged or not: against its plain version
    and the two-kernel backward (``_rel`` 2e-2), two launches bitwise
    equal, one fused launch counted per call."""
    from veles_torch.znicz.ops import flash_attention as FA
    q, k, v, dout = _flash_inputs(card, shape, torch.bfloat16, seed=13)
    out, lse = FA.flash_attention_fwd(q, k, v, causal)
    FA.reset_launches()
    grads = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                   delta=FA.row_delta(out, dout))
    torch.cuda.synchronize()
    assert FA.flash_attention_bwd.variant_launches == {"fused": 2, "dq": 0,
                                                       "dkv": 0}
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    two = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                 fused=False)
    for g, a, w, t in zip(grads, again, want, two):
        assert torch.equal(g, a) and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all())
        assert _rel(g, w) <= 2e-2
        assert _rel(g, t) <= 2e-2


@pytest.mark.cuda
def test_flash_fused_backward_sm90_refuses_what_it_does_not_take(card):
    """The bf16 fused backward's wrapper raises before any launch on a
    head dim, dtype, device or layout the kernel does not take."""
    from veles_torch.znicz.ops import flash_attention as FA
    q, k, v, dout = _flash_inputs(card, (1, 2, 64, 32), torch.bfloat16)
    out, lse = FA.flash_attention_fwd(q, k, v)
    FA.reset_launches()
    wide = torch.zeros((1, 2, 64, 160), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP"):
        FA.flash_attention_bwd(wide, wide, wide, wide, lse, wide)
    with pytest.raises(TypeError):
        FA.flash_attention_bwd(q.half(), k.half(), v.half(), out.half(), lse,
                               dout.half())
    with pytest.raises(TypeError):
        FA.flash_attention_bwd(q, k, v, out, lse, dout.float())
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, k, v, out, lse.cpu(), dout)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, k.transpose(2, 3).contiguous()
                               .transpose(2, 3), v, out, lse, dout)
    assert FA.flash_attention_bwd.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 77, 16), (64, 4, 32, 16),
                                   (1, 2, 300, 16), (1, 2, 130, 32),
                                   (4, 4, 256, 32), (2, 3, 200, 64),
                                   (1, 2, 700, 64), (1, 2, 77, 128),
                                   (2, 3, 200, 128), (1, 2, 520, 128)],
                         ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_sm90_matches_plain(card, causal, shape):
    """The bf16 forward (the wgmma kernel of csrc/flash_fwd_sm90.cu) at
    every head dim it takes, S ragged or not, one K tile or several, more
    than its load ring holds (S 700 at dh 64, 520 at dh 128), both
    variants: against its
    plain version (``_rel`` 2e-2, lse 1e-3); with the bf16 accumulator
    against the plain bf16-accumulated version, which rounds the chain
    once where the kernel rounds once per K tile (``_rel`` 5e-2); two
    launches bitwise equal; the pipelined variant's extra mask tests
    change no bit; each launch counted once in its variant."""
    from veles_torch.znicz.ops import flash_attention as FA
    q, k, v, _ = _flash_inputs(card, shape, torch.bfloat16, seed=17)
    FA.reset_launches()
    got = {}
    for acc in (None, torch.bfloat16):
        want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v, causal,
                                                          acc)
        for pipeline in (False, True):
            out, lse = FA.flash_attention_fwd(q, k, v, causal, pipeline,
                                              acc)
            again = FA.flash_attention_fwd(q, k, v, causal, pipeline, acc)
            torch.cuda.synchronize()
            assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
            assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
            assert bool(torch.isfinite(out.float()).all())
            assert _rel(out, want_out) <= (2e-2 if acc is None else 5e-2)
            assert (lse - want_lse).abs().max().item() <= 1e-3
            got[acc, pipeline] = out, lse
        for a, b in zip(got[acc, False], got[acc, True]):
            assert torch.equal(a, b)
    assert FA.flash_attention_fwd.variant_launches == {"fwd": 4,
                                                       "fwd_pipe": 4}
    assert FA.flash_attention_fwd.launches == 8


@pytest.mark.cuda
def test_flash_forward_sm90_refuses_what_it_does_not_take(card):
    """The bf16 forward's wrapper raises before any launch on a head dim,
    dtype, device, layout or accumulator the kernel does not take."""
    from veles_torch.znicz.ops import flash_attention as FA
    q, k, v, _ = _flash_inputs(card, (1, 2, 64, 32), torch.bfloat16)
    FA.reset_launches()
    wide = torch.zeros((1, 2, 64, 160), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP"):
        FA.flash_attention_fwd(wide, wide, wide)
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q, k.float(), v)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, k.transpose(2, 3).contiguous()
                               .transpose(2, 3), v)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, k, v, acc_dtype=torch.float16)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd(q, k[:, :, :32], v)
    assert FA.flash_attention_fwd.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 32, 48), (2, 3, 200, 48),
                                   (1, 2, 130, 8), (2, 2, 77, 80),
                                   (1, 2, 96, 112)], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_unbuilt_head_dims(card, dtype, causal, shape):
    """Head dims no kernel is built for run zero-padded to the next built
    one: forward (both variants) and fused and two-kernel backward against
    their plain versions at the true dh (``_rel``: 1e-4 in f32, 2e-2 in
    bf16), outputs of the true width, two launches bitwise equal, one
    launch counted per call."""
    from veles_torch.znicz.ops import flash_attention as FA
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q, k, v, dout = _flash_inputs(card, shape, dtype, seed=shape[3])
    want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v, causal)
    FA.reset_launches()
    for pipeline in (False, True):
        out, lse = FA.flash_attention_fwd(q, k, v, causal, pipeline)
        again = FA.flash_attention_fwd(q, k, v, causal, pipeline)
        assert out.shape == q.shape and out.is_contiguous()
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert _rel(out, want_out) <= tol
        assert (lse - want_lse).abs().max().item() <= 1e-3
    assert FA.flash_attention_fwd.launches == 4
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    for fused in (True, False):
        grads = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       fused=fused)
        again = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       fused=fused)
        for g, a, w in zip(grads, again, want):
            assert g.shape == q.shape and g.dtype == dtype
            assert torch.equal(g, a)
            assert _rel(g, w) <= tol
    torch.cuda.synchronize()
    assert FA.flash_attention_bwd.variant_launches == {"fused": 2, "dq": 2,
                                                       "dkv": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dot_is_an_f32_product_of_rounded_inputs(card, dtype):
    """``TorchDevice.dot`` under a narrow compute dtype: the f32
    accumulation of the rounded inputs (within 1e-5 of the float64
    product of the same rounded inputs, relative to its largest element),
    not rounded to the input dtype; 2-D, transposed, (B, S, D) @ (D, E)
    and batched 4-D operands alike."""
    from veles_torch.backends import TorchDevice
    from veles_torch.config import root
    engine = root.common.engine
    try:
        engine.compute_dtype = str(dtype).replace("torch.", "")
        dev = TorchDevice("cuda")
    finally:
        engine.compute_dtype = None
    assert dev.compute_dtype == dtype
    gen = torch.Generator(device=card)
    gen.manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=card)

    x, w = rnd(4096, 768), rnd(768, 2304)
    cases = [(x, w), (x.t(), rnd(4096, 512)), (rnd(8, 512, 768), w),
             (rnd(2, 3, 200, 64), rnd(2, 3, 64, 200)),
             (rnd(300, 96), rnd(100, 96).t())]
    for a, b in cases:
        got = dev.dot(a, b)
        want = torch.matmul(a.to(dtype).double(), b.to(dtype).double())
        assert got.dtype == torch.float32 and got.shape == want.shape
        rel = ((got.double() - want).abs().max() / want.abs().max()).item()
        assert rel <= 1e-5, (tuple(a.shape), tuple(b.shape), rel)
        assert not torch.equal(got, got.to(dtype).float())


@pytest.mark.cuda
def test_embedding_grad_repeats_bit_for_bit(card):
    """The embedding gradient at the 110M step's shape (4096 tokens of a
    16384-word vocabulary, dim 768, bf16 error rows, many ids repeated):
    two launches give equal bits, and it agrees with ``index_add_`` to f32
    order error (1e-5 relative)."""
    from veles_torch.znicz.ops.embedding import embedding_grad
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    ids = torch.randint(0, 512, (8, 512), generator=gen, device=card)
    err = torch.randn((8, 512, 768), generator=gen,
                      device=card).to(torch.bfloat16)
    got = embedding_grad(ids, err, 16384)
    assert torch.equal(got, embedding_grad(ids, err, 16384))
    want = torch.zeros((16384, 768), device=card).index_add_(
        0, ids.reshape(-1), err.reshape(-1, 768).float())
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert got.shape == (16384, 768) and rel <= 1e-5, rel
