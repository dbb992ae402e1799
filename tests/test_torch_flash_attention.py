"""The port's flash attention (veles_torch/znicz/ops/flash_attention.py)
against the JAX package's Pallas kernels (parallel/pallas_attention.py,
interpret mode on the CPU), fused and two-kernel backward alike, and its
dense attention core, on inputs made from a numpy seed; the wrappers'
refusals; and a pure-Python model of the CUDA kernels' launch plans,
the bf16 fused backward's tickets and dq order included."""

import collections

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles.znicz_tpu.ops.attention import (
    dense_attention_core_bwd, dense_attention_core_fwd)
from veles.znicz_tpu.parallel import pallas_attention as PA
from veles_torch.znicz.ops import flash_attention as FA

#: the reference's own cases (tests/test_pallas_attention.py)
CASES = [
    dict(causal=True, s=64, block=32),
    dict(causal=False, s=64, block=32),
    dict(causal=True, s=128, block=64),
    dict(causal=True, s=64, block=64),
]
UNEQUAL = [(32, 16), (16, 32)]
#: the reference test's tolerances: forward (out, lse) and backward
FWD_ATOL, BWD_ATOL = 2e-5, 2e-4


def _inputs(s, b=2, h=2, dh=8, seed=909):
    rng = numpy.random.default_rng(seed)
    return tuple(rng.normal(0, 1.0, (b, h, s, dh)).astype(numpy.float32)
                 for _ in range(4))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(numpy.array(a, numpy.float32))
                 .to(dtype) for a in arrays)


def _close(got, want, atol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = numpy.asarray(want, numpy.float32)
    diff = numpy.abs(got - want).max()
    assert diff <= atol, diff


def _jax_pair(q, k, v, dout, causal, bq, bk, dtype=jnp.float32,
              fused=True):
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, dout))
    out, lse = PA.flash_attention_fwd(jq, jk, jv, causal=causal,
                                      block_q=bq, block_k=bk,
                                      interpret=True)
    grads = PA.flash_attention_bwd(jq, jk, jv, out, lse, jdo,
                                   causal=causal, block_q=bq, block_k=bk,
                                   interpret=True, fused=fused)
    return out, lse, grads


@pytest.mark.parametrize("case", CASES + [
    dict(causal=c, s=64, bq=bq, bk=bk) for bq, bk in UNEQUAL
    for c in (True, False)], ids=str)
def test_plain_matches_pallas(case):
    """Forward to 2e-5 and backward to 2e-4 of the Pallas kernels on the
    reference's own cases, the backward from the same saved out/lse."""
    q, k, v, dout = _inputs(case["s"])
    bq = case.get("bq", case.get("block"))
    bk = case.get("bk", case.get("block"))
    out, lse, grads = _jax_pair(q, k, v, dout, case["causal"], bq, bk)
    got_out, got_lse = FA.flash_attention_fwd_plain(
        *_t(q, k, v), causal=case["causal"])
    _close(got_out, out, FWD_ATOL)
    _close(got_lse, lse, FWD_ATOL)
    got = FA.flash_attention_bwd_plain(
        *_t(q, k, v, out), torch.from_numpy(numpy.asarray(lse)),
        _t(dout)[0], causal=case["causal"])
    for g, w in zip(got, grads):
        _close(g, w, BWD_ATOL)


@pytest.mark.parametrize("case", CASES + [
    dict(causal=c, s=64, bq=bq, bk=bk) for bq, bk in UNEQUAL
    for c in (True, False)], ids=str)
def test_two_kernel_matches_pallas(case):
    """``fused=False`` (on the CPU: the dq and dk/dv plain versions)
    against the Pallas two-kernel backward (``_dq_kernel`` +
    ``_dkv_kernel``) to 2e-4 on the reference's own cases; and, as
    ``test_pallas_bwd_fused_matches_two_kernel`` holds the reference's
    fused kernel to its two-kernel form, the port's fused call against
    the same Pallas two-kernel output, at dh 16 (a head dim the kernels
    are built for)."""
    q, k, v, dout = _inputs(case["s"], dh=16, seed=911)
    bq = case.get("bq", case.get("block"))
    bk = case.get("bk", case.get("block"))
    out, lse, grads = _jax_pair(q, k, v, dout, case["causal"], bq, bk,
                                fused=False)
    args = (*_t(q, k, v, out), torch.from_numpy(numpy.asarray(lse)),
            _t(dout)[0])
    for fused in (False, True):
        got = FA.flash_attention_bwd(*args, causal=case["causal"],
                                     fused=fused)
        for g, w in zip(got, grads):
            _close(g, w, BWD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_two_kernel_bf16_matches_pallas(causal):
    """bf16 inputs: ``fused=False`` against the Pallas two-kernel
    backward on the same bf16 inputs, to bf16 rounding (2e-2, as
    test_plain_bf16_matches_pallas)."""
    q, k, v, dout = _inputs(64, dh=16, seed=6)
    out, lse, grads = _jax_pair(q, k, v, dout, causal, 32, 32,
                                jnp.bfloat16, fused=False)
    tq, tk, tv, tdo = _t(q, k, v, dout, dtype=torch.bfloat16)
    tout = torch.from_numpy(numpy.asarray(
        out.astype(jnp.float32))).to(torch.bfloat16)
    got = FA.flash_attention_bwd(tq, tk, tv, tout,
                                 torch.from_numpy(numpy.asarray(lse)), tdo,
                                 causal, fused=False)
    for g, w in zip(got, grads):
        assert g.dtype == torch.bfloat16
        _close(g, numpy.asarray(w.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("s", [64, 77])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_kernel_plain_splits_the_fused_plain(dtype, causal, s):
    """The dq and dk/dv plain versions are flash_attention_bwd_plain's
    results to the bit, and so is ``fused=False`` on CPU tensors; a
    hoisted ``delta`` changes no bit of any of them."""
    q, k, v, dout = _t(*_inputs(s, dh=16, seed=12), dtype=dtype)
    out, lse = FA.flash_attention_fwd_plain(q, k, v, causal)
    delta = FA.row_delta(out, dout)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    for d in (None, delta):
        got = (FA.flash_attention_dq_plain(q, k, v, out, lse, dout, causal,
                                           d),
               *FA.flash_attention_dkv_plain(q, k, v, out, lse, dout,
                                             causal, d))
        for fused in (True, False):
            wrapped = FA.flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal, d, fused)
            assert all(torch.equal(a, b) for a, b in zip(wrapped, want))
        hoisted = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                               causal, d)
        for g, h, w in zip(got, hoisted, want):
            assert g.dtype == dtype
            assert torch.equal(g, w) and torch.equal(h, w)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_matches_pallas(causal):
    """bf16 inputs: the plain version's dtype rules (p and ds rounded to
    bf16 before their products, f32 accumulation) against the Pallas
    kernels run on the same bf16 inputs. The two round p under different
    running maxima (one block vs the whole row), so they agree to bf16
    rounding: 2e-2."""
    q, k, v, dout = _inputs(64, dh=16, seed=5)
    out, lse, grads = _jax_pair(q, k, v, dout, causal, 32, 32,
                                jnp.bfloat16)
    tq, tk, tv, tdo = _t(q, k, v, dout, dtype=torch.bfloat16)
    got_out, got_lse = FA.flash_attention_fwd_plain(tq, tk, tv, causal)
    assert got_out.dtype == torch.bfloat16 and got_lse.dtype == \
        torch.float32
    _close(got_out, numpy.asarray(out.astype(jnp.float32)), 2e-2)
    _close(got_lse, lse, 1e-3)
    got = FA.flash_attention_bwd_plain(
        tq, tk, tv, torch.from_numpy(numpy.asarray(
            out.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(numpy.asarray(lse)), tdo, causal)
    for g, w in zip(got, grads):
        assert g.dtype == torch.bfloat16
        _close(g, numpy.asarray(w.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("s", [40, 77])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_sequence_matches_dense_core(s, causal):
    """S that no power-of-two tile divides (the Pallas kernels refuse
    it): the plain versions against the JAX package's dense attention
    core, forward to 2e-5 and backward to 2e-4."""
    q, k, v, dout = _inputs(s, dh=16, seed=31)
    scale = numpy.float32(1.0 / numpy.sqrt(16))
    probs, ctx = dense_attention_core_fwd(numpy, q, k, v, causal, scale)
    scores = numpy.matmul(q, k.transpose(0, 1, 3, 2)) * scale
    if causal:
        scores = scores + numpy.triu(numpy.full((s, s), -1e9,
                                                numpy.float32), 1)
    m = scores.max(axis=-1, keepdims=True)
    lse = (m + numpy.log(numpy.exp(scores - m).sum(axis=-1,
                                                    keepdims=True)))[..., 0]
    got_out, got_lse = FA.flash_attention_fwd(*_t(q, k, v), causal=causal)
    _close(got_out, ctx, FWD_ATOL)
    _close(got_lse, lse, FWD_ATOL)
    want = dense_attention_core_bwd(numpy, q, k, v, probs, dout, scale)
    got = FA.flash_attention_bwd(*_t(q, k, v), got_out, got_lse,
                                 _t(dout)[0], causal=causal)
    for g, w in zip(got, want):
        _close(g, w, BWD_ATOL)


def test_bf16_accumulator_gate():
    """The attn_acc='bf16' gate of tests/test_pallas_attention.py: the
    output within the bf16 accumulation regime (< 1.5e-2) of the f32
    accumulation yet not equal to it, and the lse unchanged."""
    q, k, v, _ = _inputs(128, dh=16)
    for causal in (True, False):
        ref, lse_ref = FA.flash_attention_fwd(*_t(q, k, v), causal=causal)
        out, lse = FA.flash_attention_fwd(*_t(q, k, v), causal=causal,
                                          acc_dtype=torch.bfloat16)
        err = (out - ref).abs().max().item()
        assert 0.0 < err < 1.5e-2, err
        _close(lse, lse_ref.numpy(), FWD_ATOL)


def test_wrappers_take_cpu_tensors_to_the_plain_version():
    """On the CPU the wrappers return the plain versions' results and
    count no launch; the pipelined variant is the same function."""
    q, k, v, dout = _t(*_inputs(64, dh=16))
    FA.reset_launches()
    out, lse = FA.flash_attention_fwd(q, k, v)
    want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    pout, plse = FA.flash_attention_fwd(q, k, v, pipeline=True)
    assert torch.equal(pout, out) and torch.equal(plse, lse)
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert FA.flash_attention_fwd.launches == 0
    assert FA.flash_attention_fwd.variant_launches == {"fwd": 0,
                                                       "fwd_pipe": 0}
    assert FA.flash_attention_bwd.launches == 0
    assert FA.flash_attention_bwd.variant_launches["fused"] == 0


def test_wrappers_refuse_what_is_not_ported():
    """The wrappers' refusals; ``fused=False``, ported now, takes CPU
    tensors to the plain versions and counts no launch, and so does a head
    dim no kernel is built for (dh 8)."""
    q, k, v, dout = _t(*_inputs(64, dh=16))
    out, lse = FA.flash_attention_fwd(q, k, v)
    FA.reset_launches()
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, fused=False)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(FA.flash_attention_dq(q, k, v, out, lse, dout),
                       want[0])
    assert all(torch.equal(g, w) for g, w in zip(
        FA.flash_attention_dkv(q, k, v, out, lse, dout), want[1:]))
    q8, k8, v8, do8 = _t(*_inputs(64, dh=8))
    out8, lse8 = FA.flash_attention_fwd(q8, k8, v8)
    assert torch.equal(out8, FA.flash_attention_fwd_plain(q8, k8, v8)[0])
    got8 = FA.flash_attention_bwd(q8, k8, v8, out8, lse8, do8)
    assert all(torch.equal(g, w) for g, w in zip(
        got8, FA.flash_attention_bwd_plain(q8, k8, v8, out8, lse8, do8)))
    assert FA.flash_attention_fwd.launches == 0
    assert FA.flash_attention_bwd.launches == 0
    assert FA.flash_attention_bwd.variant_launches == {"fused": 0, "dq": 0,
                                                       "dkv": 0}
    with pytest.raises(ValueError, match="acc_dtype"):
        FA.flash_attention_fwd(q, k, v, acc_dtype=torch.float16)
    with pytest.raises(ValueError, match="differ"):
        FA.flash_attention_fwd(q, k[:, :, :32], v)
    with pytest.raises(ValueError, match="differ"):
        FA.flash_attention_bwd(q8, k8, v8, q8, lse, q)


@pytest.mark.parametrize("dh, kernel_dh", [
    (1, 16), (8, 16), (16, 16), (17, 32), (40, 64), (48, 64), (64, 64),
    (80, 128), (96, 128), (112, 128), (128, 128)])
def test_kernel_head_dim_pads_to_the_next_built_one(dh, kernel_dh):
    """A head dim up to 128 runs at the smallest built one that holds it,
    zero-padded: the padded plain math at the true dh's scale gives the
    unpadded result in its first dh columns (out, lse, dq, dk, dv) and
    zeros in the rest."""
    assert FA.kernel_head_dim(dh) == kernel_dh
    q, k, v, dout = _t(*_inputs(40, b=1, dh=dh, seed=dh))
    out, lse = FA.flash_attention_fwd_plain(q, k, v)
    grads = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    wide = FA._widen((q, k, v, dout), kernel_dh)
    assert all(t.shape[-1] == kernel_dh for t in wide)
    scale = torch.tensor(FA.scale_for(dh))
    sc = torch.matmul(wide[0], wide[1].transpose(-1, -2)) * scale
    sc = sc.masked_fill(FA._causal_mask(40, sc.device), FA.MASK_VALUE)
    p = torch.softmax(sc, dim=-1)
    _close(FA._narrow(torch.matmul(p, wide[2]), dh), out.numpy(), FWD_ATOL)
    _close(torch.logsumexp(sc, dim=-1), lse.numpy(), FWD_ATOL)
    dp = torch.matmul(wide[3], wide[2].transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    for g, w in zip((torch.matmul(ds, wide[1]),
                     torch.matmul(ds.transpose(-1, -2), wide[0]),
                     torch.matmul(p.transpose(-1, -2), wide[3])), grads):
        _close(FA._narrow(g, dh), w.numpy(), BWD_ATOL)
        assert not bool(g[..., dh:].any())


@pytest.mark.parametrize("dh", [161, 256])
def test_kernel_head_dim_refuses_above_128(dh):
    with pytest.raises(ValueError, match="ROADMAP"):
        FA.kernel_head_dim(dh)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_48_matches_pallas(causal):
    """dh 48, which no kernel is built for, at (1, 2, 32, 48): the
    wrappers' forward and fused backward on the CPU against the Pallas
    functions in interpret mode, forward to 2e-5 and backward to 2e-4."""
    q, k, v, dout = _inputs(32, b=1, dh=48, seed=48)
    out, lse, grads = _jax_pair(q, k, v, dout, causal, 32, 32)
    got_out, got_lse = FA.flash_attention_fwd(*_t(q, k, v), causal=causal)
    assert got_out.shape == (1, 2, 32, 48)
    _close(got_out, out, FWD_ATOL)
    _close(got_lse, lse, FWD_ATOL)
    got = FA.flash_attention_bwd(*_t(q, k, v, out),
                                 torch.from_numpy(numpy.asarray(lse)),
                                 _t(dout)[0], causal=causal)
    for g, w in zip(got, grads):
        assert g.shape == (1, 2, 32, 48)
        _close(g, w, BWD_ATOL)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 512, 8192])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_plan_covers_every_pair_once(s, causal):
    """The forward grid (one CTA per Q tile) and each CTA's K-tile range
    visit every attended (row, col) pair — col <= row when causal — in
    exactly one tile, skip only tiles that hold no attended pair, and
    leave the mask off only on tiles with no masked pair."""
    n_qt, n_kt = FA.n_tiles(s), FA.n_tiles(s)
    seen = numpy.zeros((n_qt, n_kt), numpy.int64)
    for qt in range(n_qt):
        hi, clear = FA.fwd_k_tiles(s, qt, causal)
        rows = numpy.arange(qt * 64, min(qt * 64 + 64, s))
        for kt in range(n_kt):
            cols = numpy.arange(kt * 64, min(kt * 64 + 64, s))
            attended = (cols[None, :] <= rows[:, None]) if causal \
                else numpy.ones((len(rows), len(cols)), bool)
            if kt >= hi:
                assert not attended.any(), (qt, kt)
                continue
            seen[qt, kt] += 1
            if kt < clear:
                assert attended.all(), (qt, kt)
    assert (seen <= 1).all()
    if not causal:
        assert (seen == 1).all()


@pytest.mark.parametrize("bh,s,dh", [(96, 512, 64), (48, 8192, 64),
                                     (1, 200, 16), (8, 64, 32),
                                     (4096, 8192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_plan_covers_every_pair_once(bh, s, dh, causal):
    """The f32 fused backward's chunks visit every (K tile, Q tile) pair
    that holds an attended score exactly once; each chunk's first K tile
    covers every Q tile its later ones touch (so it writes, they add);
    dq_reduce sums, for each row, exactly the chunks that wrote it; the
    partial buffer stays under its cap."""
    n_chunks = FA.bwd_chunks(bh, s, dh)
    n_qt = n_kt = FA.n_tiles(s)
    assert 1 <= n_chunks <= n_kt
    assert n_chunks in (1, n_kt) \
        or n_chunks * 4 * bh * s * dh <= FA.DQ_PARTIAL_CAP
    visits = {}
    writers = {}
    for chunk in range(n_chunks):
        pairs = FA.bwd_pairs(s, chunk, n_chunks, causal)
        first = {qt for kt, qt in pairs if kt == chunk}
        assert {qt for _, qt in pairs} <= first
        for qt in first:
            writers.setdefault(qt, []).append(chunk)
        for pair in pairs:
            visits[pair] = visits.get(pair, 0) + 1
    assert set(visits.values()) == {1}
    want = {(kt, qt) for kt in range(n_kt) for qt in range(n_qt)
            if not causal or qt >= kt}
    assert set(visits) == want
    for qt in range(n_qt):
        row = min(qt * 64 + 63, s - 1)
        assert list(FA.dq_chunks(row, n_chunks, causal)) == \
            sorted(writers[qt])


def _attended(s, qt, kt, causal):
    """The (row, col) pairs of tile (qt, kt) that attend, over its rows
    and columns below S."""
    rows = numpy.arange(qt * 64, min(qt * 64 + 64, s))
    cols = numpy.arange(kt * 64, min(kt * 64 + 64, s))
    if causal:
        return cols[None, :] <= rows[:, None]
    return numpy.ones((len(rows), len(cols)), bool)


def _check_grid(s, causal, visits, rows_matter):
    """``visits``: the (q tile, k tile, masked) triples of a whole grid.
    Every tile that holds an attended pair is visited exactly once and no
    other; the mask is off only on tiles whose pairs all attend and that
    have no padded column, nor, where the kernel writes the keys' rows
    (``rows_matter``), a padded row."""
    seen = collections.Counter((qt, kt) for qt, kt, _ in visits)
    assert set(seen.values()) == {1}
    n = FA.n_tiles(s)
    for qt in range(n):
        for kt in range(n):
            assert ((qt, kt) in seen) == bool(
                _attended(s, qt, kt, causal).any()), (qt, kt)
    for qt, kt, masked in visits:
        if not masked:
            assert _attended(s, qt, kt, causal).all(), (qt, kt)
            assert (kt + 1) * 64 <= s, (qt, kt)
            assert not rows_matter or (qt + 1) * 64 <= s, (qt, kt)


@pytest.mark.parametrize("bh,s,dh", [(96, 512, 64), (48, 8192, 64),
                                     (1, 200, 16), (8, 64, 32),
                                     (4096, 8192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_plan_covers_every_pair_once(bh, s, dh, causal):
    """The dq kernel's grid (one CTA per Q tile over the forward's K
    tiles): every attended pair in exactly one visited tile, the mask on
    every tile that holds a masked score or a padded key (padded query
    rows are never written)."""
    visits = [(qt, kt, masked) for qt in range(FA.n_tiles(s))
              for kt, masked in FA.dq_plan(s, qt, causal)]
    _check_grid(s, causal, visits, rows_matter=False)


@pytest.mark.parametrize("bh,s,dh", [(96, 512, 64), (48, 8192, 64),
                                     (1, 200, 16), (8, 64, 32),
                                     (4096, 8192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_plan_covers_every_pair_once(bh, s, dh, causal):
    """The dk/dv kernel's grid (one CTA per K tile over the Q tiles from
    the diagonal): every attended pair in exactly one visited tile, the
    mask on every tile that holds a masked score, a padded key or a
    padded query row (whose lse reads 0)."""
    visits = [(qt, kt, masked) for kt in range(FA.n_tiles(s))
              for qt, masked in FA.dkv_plan(s, kt, causal)]
    _check_grid(s, causal, visits, rows_matter=True)


#: (b*h, S, dh) of the plan tests, as above
PLAN_SHAPES = [(96, 512, 64), (48, 8192, 64), (1, 200, 16), (8, 64, 32),
               (4096, 8192, 128)]


def _attended_sm90(s, qt, kt, causal):
    """The (row, key) pairs of Q tile ``qt`` and K tile ``kt`` (of
    SM90_BLOCK_K keys) that attend, over rows and keys below S."""
    rows = numpy.arange(qt * 64, min(qt * 64 + 64, s))
    keys = numpy.arange(kt * FA.SM90_BLOCK_K,
                        min((kt + 1) * FA.SM90_BLOCK_K, s))
    if causal:
        return keys[None, :] <= rows[:, None]
    return numpy.ones((len(rows), len(keys)), bool)


@pytest.mark.parametrize("bh,s,dh", PLAN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_plan_orders_every_pair_once(bh, s, dh, causal):
    """The bf16 fused backward's plan, on two heads (every head's plan is
    the same): tickets go head by head, K tiles descending; every
    attended (K tile, Q tile) pair is visited exactly once and no other,
    unmasked only where every pair attends and no key or row is padded;
    each Q tile's contributors arrive in the order its counter admits
    (K tiles descending, the visits in ticket order), each waits only on
    an item with an earlier ticket, exactly one (the first) stores without
    adding and exactly one (the last, K tile 0) writes the bf16 dq: the
    same one for Q tile 0 of a causal run."""
    heads = min(bh, 2)
    items, order = FA.bwd_sm90_plan(heads, s, causal)
    n_kt = FA.n_tiles(s, FA.SM90_BLOCK_K)
    n_qt = FA.n_tiles(s)
    assert [(b, kt) for b, kt, _ in items] == [
        (b, kt) for b in range(heads) for kt in reversed(range(n_kt))]
    ticket = {(b, kt): i for i, (b, kt, _) in enumerate(items)}
    arrivals = collections.defaultdict(list)
    for b, kt, steps in items:
        for qt, masked in steps:
            arrivals[b, qt].append(kt)
            attended = _attended_sm90(s, qt, kt, causal)
            assert attended.any(), (kt, qt)
            if not masked:
                assert attended.all(), (kt, qt)
                assert (kt + 1) * FA.SM90_BLOCK_K <= s, (kt, qt)
                assert (qt + 1) * 64 <= s, (kt, qt)
    for b in range(heads):
        for qt in range(n_qt):
            want = [kt for kt in range(n_kt)
                    if _attended_sm90(s, qt, kt, causal).any()]
            got = arrivals[b, qt]
            assert sorted(got) == want, (qt, got)
            assert got == order[b, qt] == sorted(got, reverse=True)
            assert got[-1] == 0
            for before, after in zip(got, got[1:]):
                assert ticket[b, before] < ticket[b, after]
            stores = [kt for kt in got if kt == got[0]]
            writes = [kt for kt in got if kt == 0]
            assert len(stores) == len(writes) == 1
            if causal and qt == 0:
                assert got == [0]


def _scaled_err(got, want):
    """Worst element of ``got`` held to its own size and its row's rms
    (chip_smoke.scaled_err without its absolute share)."""
    g, w = got.double(), want.double()
    scale = w.abs() + w.square().mean(-1, keepdim=True).sqrt()
    return ((g - w).abs() / scale.clamp_min(1e-300)).max().item()


@pytest.mark.parametrize("dh", [16, 128])
@pytest.mark.parametrize("s", [64, 77, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_dq_order_matches_plain(causal, s, dh):
    """dq summed in f32 as the bf16 fused backward sums it: for each Q
    tile, its K tiles in the plan's order, each tile's two 64-key halves
    added first, the first contribution stored, the later ones added,
    matches flash_attention_dq_plain (scaled error 1e-5: f32 sums taken
    in another order)."""
    b, h = 1, 2
    q, k, v, dout = _t(*_inputs(s, b=b, h=h, dh=dh, seed=21))
    out, lse = FA.flash_attention_fwd_plain(q, k, v, causal)
    want = FA.flash_attention_dq_plain(q, k, v, out, lse, dout, causal)
    scale = FA.scale_for(dh)
    flat = [t.reshape(b * h, s, dh) for t in (q, k, v, dout, out)]
    sc = torch.matmul(flat[0], flat[1].transpose(1, 2)) * scale
    if causal:
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                            FA.MASK_VALUE)
    p = torch.exp(sc - lse.reshape(b * h, s, 1))
    dp = torch.matmul(flat[3], flat[2].transpose(1, 2))
    ds = p * (dp - FA.row_delta(out, dout).reshape(b * h, s, 1)) * scale
    _, order = FA.bwd_sm90_plan(b * h, s, causal)
    got = torch.empty((b * h, s, dh))
    half = FA.SM90_BLOCK_K // 2
    for (bh, qt), kts in order.items():
        rows = slice(qt * 64, min(qt * 64 + 64, s))
        acc = None
        for kt in kts:
            k0 = kt * FA.SM90_BLOCK_K
            lo, hi = slice(k0, k0 + half), slice(k0 + half, k0 + 2 * half)
            part = (torch.matmul(ds[bh, rows, lo], flat[1][bh, lo])
                    + torch.matmul(ds[bh, rows, hi], flat[1][bh, hi]))
            acc = part if acc is None else acc + part
        got[bh, rows] = acc
    assert _scaled_err(got.reshape(b, h, s, dh), want) <= 1e-5


# -- the bf16 forward of csrc/flash_fwd_sm90.cu ---------------------------


def _attended_fwd_sm90(s, qt, kt, causal):
    """The (row, key) pairs of Q tile ``qt`` (SM90_FWD_BLOCK_Q rows) and K
    tile ``kt`` (SM90_BLOCK_K keys) that attend, over rows and keys below
    S."""
    rows = numpy.arange(qt * FA.SM90_FWD_BLOCK_Q,
                        min((qt + 1) * FA.SM90_FWD_BLOCK_Q, s))
    keys = numpy.arange(kt * FA.SM90_BLOCK_K,
                        min((kt + 1) * FA.SM90_BLOCK_K, s))
    if causal:
        return keys[None, :] <= rows[:, None]
    return numpy.ones((len(rows), len(keys)), bool)


@pytest.mark.parametrize("s", [1, 77, 127, 128, 129, 200, 512, 8192])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pipe", [False, True])
def test_fwd_sm90_plan_covers_every_pair_once(pipe, causal, s):
    """The bf16 forward's work items, on two heads: in order with the Q
    tiles longest first and every head's tile in turn; every
    attended (row, key) pair in exactly one visited (Q tile, K tile) and
    no other tile visited; each CTA's K tiles ascending; ``pipe=True``
    masks every visited tile, ``pipe=False`` exactly the tiles that hold
    a masked pair or a padded key (padded query rows are never stored)."""
    heads = 2
    plan = FA.fwd_sm90_plan(heads, s, causal, pipe)
    n_qt = FA.n_tiles(s, FA.SM90_FWD_BLOCK_Q)
    n_kt = FA.n_tiles(s, FA.SM90_BLOCK_K)
    assert [(b, qt) for b, qt, _ in plan] == [
        (b, qt) for qt in reversed(range(n_qt)) for b in range(heads)]
    for b, qt, visits in plan:
        kts = [kt for kt, _ in visits]
        assert kts == sorted(set(kts))
        for kt in range(n_kt):
            attended = _attended_fwd_sm90(s, qt, kt, causal)
            assert (kt in kts) == bool(attended.any()), (qt, kt)
        for kt, masked in visits:
            attended = _attended_fwd_sm90(s, qt, kt, causal)
            padded = (kt + 1) * FA.SM90_BLOCK_K > s
            assert masked == (pipe or padded or not attended.all()), \
                (qt, kt)


@pytest.mark.parametrize("bh,s", [(96, 512), (48, 8192), (2, 77),
                                  (256, 32), (1, 1000)])
def test_fwd_sm90_deal_gives_every_item_once(bh, s):
    """The persistent forward's deal over 132 SMs (an H100's; fewer CTAs
    when there are fewer items): every item to exactly one CTA, each
    CTA's items in plan order (longest first), and on a causal plan no
    CTA's share of K tiles more than the longest item above the mean."""
    plan = FA.fwd_sm90_plan(bh, s, True, False)
    grid = min(len(plan), 132)
    deal = FA.fwd_sm90_deal(len(plan), grid)
    assert len(deal) == grid
    assert sorted(i for items in deal for i in items) == list(range(len(plan)))
    work = [sum(len(plan[i][2]) for i in items) for items in deal]
    longest = max(len(visits) for _, _, visits in plan)
    for items in deal:
        assert items == sorted(items) and items
    assert max(work) <= sum(work) / grid + longest


def _fwd_sm90_sim(q, k, v, causal, pipe, acc_dtype=None):
    """The bf16 forward's arithmetic in f32 on the CPU, after its plan:
    per CTA, its K tiles in order, each an online-softmax step (running
    max and sum in f32, p in the storage dtype for the PV product, the
    mask only on the plan's masked tiles, padded keys left out as the
    kernel's -inf leaves them); the PV chain in f32, or with ``acc_dtype``
    bf16 rounded once per K tile as the kernel rounds it:
    acc = bf16(bf16(acc * bf16(coef)) + bf16(pv))."""
    b, h, s, dh = q.shape
    scale = FA.scale_for(dh)
    qf, kf, vf = (t.reshape(b * h, s, dh).float() for t in (q, k, v))
    out = torch.empty((b * h, s, dh), dtype=q.dtype)
    lse = torch.empty((b * h, s))

    def rnd(t):
        return t.to(torch.bfloat16).float()

    bq, bk = FA.SM90_FWD_BLOCK_Q, FA.SM90_BLOCK_K
    for bh, qt, visits in FA.fwd_sm90_plan(b * h, s, causal, pipe):
        rows = torch.arange(qt * bq, min(qt * bq + bq, s))
        m = torch.full((len(rows), 1), -numpy.inf)
        l = torch.zeros((len(rows), 1))
        acc = torch.zeros((len(rows), dh))
        for kt, masked in visits:
            keys = torch.arange(kt * bk, min(kt * bk + bk, s))
            x = torch.matmul(qf[bh, rows], kf[bh, keys].T) * scale
            if masked and causal:
                x = x.masked_fill(keys[None, :] > rows[:, None],
                                  FA.MASK_VALUE)
            m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
            p = torch.exp(x - m_new)
            coef = torch.exp(m - m_new)
            l = l * coef + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p.to(q.dtype).float(), vf[bh, keys])
            if acc_dtype == torch.bfloat16:
                acc = rnd(rnd(acc * rnd(coef)) + rnd(pv))
            else:
                acc = acc * coef + pv
            m = m_new
        out[bh, rows] = (acc / l).to(q.dtype)
        lse[bh, rows] = (m + torch.log(l)).squeeze(-1)
    return out.reshape(b, h, s, dh), lse.reshape(b, h, s)


@pytest.mark.parametrize("s", [64, 77, 200, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pipe", [False, True])
def test_fwd_sm90_simulation_matches_plain(pipe, causal, s):
    """The bf16 forward's per-K-tile arithmetic with the f32 chain, on f32
    inputs, against flash_attention_fwd_plain: out and lse to 1e-5 (the
    same function with its sums taken per K tile)."""
    q, k, v = _t(*_inputs(s, dh=32, seed=41)[:3])
    out, lse = _fwd_sm90_sim(q, k, v, causal, pipe)
    want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v, causal)
    _close(out, want_out, 1e-5)
    _close(lse, want_lse, 1e-5)


#: the bf16 chain against the Pallas kernel's, both rounding once per K
#: tile of 128 keys: they differ only where an f32 exp or sum rounds
#: differently and moves a bf16 rounding (read on this test's inputs:
#: 9.5e-7 causal, 0 non-causal; the plain version, which rounds the chain
#: once, reads 3.9e-3 against the same Pallas output)
ACC_BF16_VS_PALLAS = 1e-3


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_sm90_acc_bf16_matches_pallas(causal):
    """With the bf16 accumulator, bf16 inputs, S = 384 (three K tiles of
    128): the simulation against the Pallas ``_fwd_kernel`` in interpret
    mode with ``acc_dtype=bfloat16`` and ``block_k=128``, within
    ACC_BF16_VS_PALLAS and closer than the plain version, which rounds
    the chain once at the end; lse to 1e-5."""
    q, k, v, _ = _inputs(384, dh=16, seed=43)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want, want_lse = PA.flash_attention_fwd(
        jq, jk, jv, causal=causal, block_q=128, block_k=128, interpret=True,
        acc_dtype=jnp.bfloat16)
    want = numpy.asarray(want.astype(jnp.float32))
    tq, tk, tv = _t(q, k, v, dtype=torch.bfloat16)
    out, lse = _fwd_sm90_sim(tq, tk, tv, causal, False, torch.bfloat16)
    plain = FA.flash_attention_fwd_plain(tq, tk, tv, causal,
                                         torch.bfloat16)[0]
    err = numpy.abs(out.float().numpy() - want).max()
    err_plain = numpy.abs(plain.float().numpy() - want).max()
    assert err <= ACC_BF16_VS_PALLAS and err < err_plain, (err, err_plain)
    _close(lse, want_lse, 1e-5)
