"""The port's blocked scan attention (veles_torch/znicz/ops/scan_attention.py)
against the reference's (veles/znicz_tpu/parallel/flash.py) on the CPU,
the attention unit's dispatch (``mode``: dense, scan, the flash kernels
and the auto policy), and the LM sample with ``attn_block`` set and no
``attn_impl`` (the scan on the CPU) against the JAX package's."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles.znicz_tpu.parallel import flash as JF
from veles_torch.backends import TorchDevice
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.znicz.ops import flash_attention as FA
from veles_torch.znicz.ops import scan_attention as SA
from veles_torch.znicz.ops.attention import MultiHeadAttention

from tests.test_torch_lm import (
    EPOCHS_ATOL, STEP_ATOL, assert_trees_close, jax_lm, jax_tree, lm_config,
    one_step, torch_lm)

#: the scan against the reference's, f32, the same block schedule: within
#: this share of each output's largest element (exp and the block sums
#: in another order)
SCAN_RTOL = 2e-6

#: (B, H, S, dh, block)
SHAPES = [(2, 2, 32, 16, 8), (1, 3, 48, 8, 16), (2, 1, 64, 32, 64),
          (1, 2, 40, 16, 8)]


def _inputs(shape, seed):
    b, h, s, dh, _ = shape
    rng = numpy.random.default_rng(seed)
    return [rng.normal(0, 1, (b, h, s, dh)).astype(numpy.float32)
            for _ in range(4)]


def _share(got, want):
    want = numpy.asarray(want, numpy.float64)
    return numpy.abs(got.detach().numpy().astype(numpy.float64)
                     - want).max() / numpy.abs(want).max()


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_matches_reference(shape, causal):
    """out, lse, dq, dk and dv within SCAN_RTOL of the reference's scan
    from the same f32 inputs and block."""
    block = shape[-1]
    q, k, v, dout = _inputs(shape, sum(shape))
    jout, jlse = JF.blocked_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block=block)
    jd = JF.blocked_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jout, jlse,
        jnp.asarray(dout), causal=causal, block=block)
    tq, tk, tv, td = map(torch.from_numpy, (q, k, v, dout))
    out, lse = SA.blocked_attention_fwd(tq, tk, tv, causal=causal,
                                        block=block)
    grads = SA.blocked_attention_bwd(tq, tk, tv, out, lse, td,
                                     causal=causal, block=block)
    assert out.dtype == torch.float32 and lse.shape == shape[:3]
    for got, want in zip((out, lse, *grads), (jout, jlse, *jd)):
        assert _share(got, want) <= SCAN_RTOL


def test_scan_equals_dense_and_the_flash_plain_version():
    """The scan is the exact softmax: it agrees with the plain flash
    version (``ops/flash_attention.py``'s CPU path) and its lse, causal,
    within SCAN_RTOL; a block that does not divide S is refused."""
    shape = (2, 2, 64, 16, 16)
    q, k, v, dout = map(torch.from_numpy, _inputs(shape, 9))
    out, lse = SA.blocked_attention_fwd(q, k, v, block=16)
    fout, flse = FA.flash_attention_fwd(q, k, v, causal=True)
    assert _share(out, fout.numpy()) <= SCAN_RTOL
    assert _share(lse, flse.numpy()) <= SCAN_RTOL
    dq, dk, dv = SA.blocked_attention_bwd(q, k, v, out, lse, dout, block=16)
    fd = FA.flash_attention_bwd(q, k, v, fout, flse, dout, causal=True)
    for got, want in zip((dq, dk, dv), fd):
        assert _share(got, want.numpy()) <= SCAN_RTOL
    with pytest.raises(ValueError, match="divide"):
        SA.blocked_attention_fwd(q, k, v, block=24)


def _unit(platform, **kwargs):
    mha = MultiHeadAttention(heads=2, **kwargs)
    mha.device = None if platform is None else \
        SimpleNamespace(platform=platform)
    return mha


@pytest.mark.parametrize("platform", [None, "cpu", "cuda"])
def test_dispatch_table(platform):
    """``mode``: attn_impl='pallas' is the kernels anywhere, no block is
    dense, 'scan' is the scan at any S; a block without attn_impl is the
    scan on the CPU whatever S, and on the card the kernels from
    PALLAS_AUTO_MIN_S on."""
    bound = MultiHeadAttention.PALLAS_AUTO_MIN_S
    for s in (16, bound - 1, bound, 4 * bound):
        assert _unit(platform, attn_impl="pallas").mode(s) == "pallas"
        assert _unit(platform).mode(s) == "dense"
        assert _unit(platform, attn_impl="scan",
                     attn_block_size=8).mode(s) == "scan"
        auto = _unit(platform, attn_block_size=8).mode(s)
        want = "pallas" if platform == "cuda" and s >= bound else "scan"
        assert auto == want, (platform, s)
    # the experiment knobs are refused wherever the auto policy picks the
    # scan, and pallas_tile wherever it picks the kernels
    with pytest.raises(ValueError, match="pallas"):
        _unit(platform, attn_block_size=8, attn_pipeline=True).mode(16)
    if platform == "cuda":
        with pytest.raises(NotImplementedError, match="pallas_tile"):
            _unit(platform, attn_block_size=8,
                  pallas_tile=64).mode(4 * bound)
    assert _unit(platform, attn_block_size=8, pallas_tile=64).mode(16) \
        == "scan"


def test_scan_mode_keeps_the_kernel_cache_layout():
    """The unit in the scan mode caches (q, k, v, out_heads, lse, merged)
    as the kernels' mode does, and its output equals the dense mode's
    within SCAN_RTOL."""
    x = torch.from_numpy(numpy.random.default_rng(3).normal(
        0, 1, (2, 32, 32)).astype(numpy.float32))
    outs = []
    for kwargs in ({"attn_block_size": 8}, {}):
        import veles_torch.prng as tprng
        tprng.seed_all(5)
        mha = MultiHeadAttention(heads=2, **kwargs)
        mha.initialize((2, 32, 32), TorchDevice("cpu"))
        outs.append(mha(x))
        assert len(mha.cache) == (6 if kwargs else 5)
    assert _share(outs[0], outs[1].numpy()) <= SCAN_RTOL


SCAN_MODEL = {"attn_impl": None, "attn_block": 8}


def test_lm_scan_step_matches_reference():
    """One LM train step with attn_block 8 (two blocks of S 16) and no
    attn_impl, from the reference's state: every parameter and momentum
    within STEP_ATOL, the same loss and wrong-token count."""
    with lm_config(model=SCAN_MODEL):
        jw, tw = jax_lm(), torch_lm()
        assert tw.forwards[1].mode(16) == "scan"
        want, got, outs, metrics = one_step(jw, tw)
    assert_trees_close(want, got, STEP_ATOL)
    assert abs(float(outs["loss"]) - float(metrics[0])) < STEP_ATOL
    assert int(outs["n_err"]) == int(metrics[1])


def test_lm_scan_epochs_match_reference():
    """Three epochs with attn_block 8: per-epoch losses and the final
    parameters within EPOCHS_ATOL; no flash kernel is reached."""
    FA.reset_launches()
    with lm_config(model=SCAN_MODEL):
        jw, tw = jax_lm(), torch_lm()
        jw.run()
        tw.run()
    for j, t in zip(jw.decision.history, tw.decision.history):
        for cls in ("validation", "train"):
            assert abs(j[cls]["loss"] - t[cls]["loss"]) < EPOCHS_ATOL
    assert len(tw.decision.history) == 3
    assert_trees_close(jax_tree(jw), params_to_numpy(tw.export_tree()),
                       EPOCHS_ATOL)
    assert FA.flash_attention_fwd.launches == 0


def test_lm_scan_step_bf16_policy():
    """One scan-mode step under the card's dtype policy: the momenta
    within the pallas mode's BF16_STEP_RTOL of the reference's largest
    element (q, k, v and p in bf16, f32 sums on both sides)."""
    from tests.test_torch_lm import BF16_STEP_RTOL, bf16_policy
    with lm_config(model=SCAN_MODEL), bf16_policy():
        jw, tw = jax_lm(), torch_lm()
        tw.import_tree(params_from_jax(jax_tree(jw)))
        want, got, outs, metrics = one_step(jw, tw)
    for unit in want:
        for key in want[unit]:
            if key.startswith("vel"):
                w = want[unit][key].astype(numpy.float64)
                share = numpy.abs(got[unit][key] - w).max() / \
                    numpy.abs(w).max()
                assert share <= BF16_STEP_RTOL, (unit, key, share)
    assert int(outs["n_err"]) == int(metrics[1])
