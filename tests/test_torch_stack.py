"""The port's stacked transformer block (veles_torch/znicz/parallel/
pipeline.py, ops/transformer_stack.py) against the JAX package's on the
CPU: the block's forward and backward, the unit pair's step, remat bit
for bit against no remat, the stacked LM's step and epochs, its guards,
its archive byte for byte, and greedy decoding through ``block_decode``
token for token with the reference's ``generate()``."""

import json

import numpy
import pytest
import torch

import veles.prng as jprng
from veles.znicz_tpu import generate as jgen
from veles.znicz_tpu.models import transformer_lm as jlm
from veles.znicz_tpu.ops import transformer_stack as JTS
from veles.znicz_tpu.parallel import pipeline as JPL
import veles_torch.prng as tprng
from veles_torch.backends import TorchDevice
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.serving import ArchiveModel, GenerativeEngine
from veles_torch.znicz import generate as tgen
from veles_torch.znicz.models import transformer_lm as tlm
from veles_torch.znicz.nn_units import gradient_unit_for
from veles_torch.znicz.ops import flash_attention as FA
from veles_torch.znicz.ops import transformer_stack as TTS
from veles_torch.znicz.parallel import pipeline as TPL

from tests.test_conv_stack import build, xla_backward, xla_forward
from tests.test_torch_lm import (
    EPOCHS_ATOL, STEP_ATOL, assert_trees_close, jax_lm, jax_tree, lm_config,
    one_step, torch_lm)
from tests.torch_threads import one_intra_op_thread  # noqa: F401

#: the block against the reference's numpy block, f32: a share of each
#: output's largest element (order error of the products and sums)
BLOCK_RTOL = 1e-6
STACK = {"layers": 2, "heads": 2, "hidden": 32}
STACKED_MODEL = {"stacked": True, "attn_impl": None, "attn_block": None}


def _close(got, want, rtol=BLOCK_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = numpy.asarray(want, numpy.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    share = numpy.abs(got.astype(numpy.float64) - want).max() / \
        max(numpy.abs(want).max(), 1e-30)
    assert share <= rtol, share


def _layer(rng, d=16, h=32):
    p = {"weights": (d, 3 * d), "bias": (3 * d,), "weights_out": (d, d),
         "bias_out": (d,), "ln1_g": (d,), "ln1_b": (d,), "ffn_w1": (d, h),
         "ffn_b1": (h,), "ffn_w2": (h, d), "ffn_b2": (d,), "ln2_g": (d,),
         "ln2_b": (d,)}
    return {k: ((1.0 if k.endswith("_g") else 0.0)
                + rng.normal(0, 0.3, s)).astype(numpy.float32)
            for k, s in p.items()}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_matches_reference(causal):
    """block_fwd's output and every cache entry, block_bwd's dx and every
    parameter gradient within BLOCK_RTOL of the reference's numpy block."""
    rng = numpy.random.default_rng(11)
    lp = _layer(rng)
    x = rng.normal(0, 1, (2, 12, 16)).astype(numpy.float32)
    err = rng.normal(0, 1, (2, 12, 16)).astype(numpy.float32)
    jy, jc = JPL.block_fwd(numpy, x, lp, 2, causal, 1e-5)
    jdx, jg = JPL.block_bwd(numpy, lp, jc, err, 2, 1e-5)
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    ty, tc = TPL.block_fwd(torch.from_numpy(x), tlp, 2, causal, 1e-5)
    tdx, tg = TPL.block_bwd(tlp, tc, torch.from_numpy(err), 2, 1e-5)
    _close(ty, jy)
    assert list(tc) == list(TPL.CACHE_KEYS) == list(JPL.CACHE_KEYS)
    for key in TPL.CACHE_KEYS:
        _close(tc[key], jc[key])
    _close(tdx, jdx)
    assert sorted(tg) == sorted(jg) == sorted(TPL.PARAMS)
    for key in jg:
        _close(tg[key], jg[key])


def _port_stack(params, x_shape, remat=False, gd_kwargs=None):
    fwd = TTS.TransformerBlockStack(remat=remat, **STACK)
    fwd.initialize(x_shape, TorchDevice("cpu"))
    for key, value in params.items():
        setattr(fwd, key, torch.from_numpy(numpy.array(value)))
    gd = gradient_unit_for(TTS.TransformerBlockStack)(
        **dict(gd_kwargs or {}, learning_rate=1.0))
    gd.setup_forward(fwd)
    gd.initialize()
    return fwd, gd


@pytest.mark.parametrize("remat", [False, True], ids=["cached", "remat"])
def test_unit_step_matches_reference(remat):
    """The unit pair on the reference's traced path (lax.scan, remat or
    not): the output, err_input and every updated stacked parameter
    within BLOCK_RTOL."""
    wf, feed, jf, jg, x, err, comp = build(
        JTS.TransformerBlockStack, input_shape=(2, 8, 16), gd_kwargs={},
        remat=remat, **STACK)
    params0 = comp.gather_params()
    want_y = xla_forward(comp, feed, jf, params0, x)
    want_ei, params1 = xla_backward(comp, feed, jf, jg, params0,
                                    comp.gather_state(), x, err)
    fwd, gd = _port_stack(params0[jf.name], x.shape, remat)
    xt = torch.from_numpy(x.astype(numpy.float32))
    y = fwd(xt)
    _close(y, want_y)
    _close(gd.run(xt, y, torch.from_numpy(err.astype(numpy.float32))),
           want_ei)
    assert sorted(params1[jf.name]) == sorted(fwd.PARAMS)
    for key, value in params1[jf.name].items():
        _close(getattr(fwd, key), value)


def test_remat_equals_no_remat_bitwise():
    """Two AdamW steps of the stack with remat equal two without it, bit
    for bit: output, err_input, every parameter and solver tensor; the
    remat forward stashes only the layer inputs."""
    rng = numpy.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 16)).astype(numpy.float32))
    errs = [torch.from_numpy(rng.normal(0, 1, (2, 8, 16)).astype(
        numpy.float32)) for _ in range(2)]
    tprng.seed_all(3)
    init = TTS.TransformerBlockStack(**STACK)
    init.initialize(x.shape, TorchDevice("cpu"))
    params = {k: v.numpy() for k, v in init.export_params().items()}
    runs = []
    for remat in (False, True):
        fwd, gd = _port_stack(params, x.shape, remat,
                              {"solver": "adam", "gradient_moment": 0.9})
        outs = []
        for err in errs:
            y = fwd(x)
            if remat:
                assert [t.shape for t in fwd.cache] == [x.shape] * 2
            else:
                assert len(fwd.cache[0]) == len(TPL.CACHE_KEYS)
            outs += [y, gd.run(x, y, err)]
        runs.append((outs, {**fwd.export_params(), **gd.export_state()}))
    (o1, s1), (o2, s2) = runs
    assert all(torch.equal(a, b) for a, b in zip(o1, o2))
    assert sorted(s1) == sorted(s2)
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key


@pytest.mark.parametrize("remat", [False, True], ids=["cached", "remat"])
def test_stacked_lm_step_and_epochs_match_reference(remat):
    """The stacked LM (one transformer_stack unit): the same initial
    parameters bit for bit, one step within STEP_ATOL, three epochs within
    EPOCHS_ATOL (losses and every final tensor); the validation loss
    falls; no flash kernel is reached."""
    FA.reset_launches()
    with lm_config(model=dict(STACKED_MODEL, remat=remat)):
        jw, tw = jax_lm(), torch_lm()
        assert [type(f).__name__ for f in tw.forwards] == [
            "EmbeddingForward", "TransformerBlockStack", "TokenDense"]
        for unit, sub in jax_tree(jw).items():
            for key, value in sub.items():
                if key in tw.forwards[1].PARAMS:
                    assert numpy.array_equal(
                        value, getattr(tw.units()[unit], key).numpy())
        want, got, outs, metrics = one_step(jw, tw)
        assert_trees_close(want, got, STEP_ATOL)
        assert int(outs["n_err"]) == int(metrics[1])
        jw, tw = jax_lm(), torch_lm()
        jw.run()
        tw.run()
    for j, t in zip(jw.decision.history, tw.decision.history):
        for cls in ("validation", "train"):
            assert abs(j[cls]["loss"] - t[cls]["loss"]) < EPOCHS_ATOL
    hist = tw.decision.history
    assert len(hist) == 3
    assert hist[-1]["validation"]["loss"] < hist[0]["validation"]["loss"]
    assert_trees_close(jax_tree(jw), params_to_numpy(tw.export_tree()),
                       EPOCHS_ATOL)
    assert FA.flash_attention_fwd.launches == 0


@pytest.mark.parametrize("model,error", [
    ({"moe_experts": 4}, ValueError),
    ({"attn_block": 8}, ValueError),
    ({"attn_impl": "pallas"}, ValueError),
    ({"attn_pipeline": True}, ValueError),
    ({"attn_acc": "bf16"}, ValueError)], ids=str)
def test_stacked_guards_match_reference(model, error):
    """stacked=True refuses MoE and the flash/scan knobs, as the
    reference does (the same exception type)."""
    with lm_config(model=dict(STACKED_MODEL, **model)):
        with pytest.raises(error):
            jlm.build_layers()
        with pytest.raises(error, match="stacked"):
            tlm.build_layers()


def _stack_pair(seed=1337):
    """(reference LM on numpy, port LM on cpu) of the stacked sample with
    the reference's parameters imported."""
    jprng.seed_all(seed)
    jw = jlm.create_workflow(name="StackLM")
    jw.initialize(device="numpy")
    tprng.seed_all(seed)
    tw = tlm.create_workflow(name="StackLM").initialize(device="cpu")
    tw.import_tree(params_from_jax({u.name: u.export_params()
                                    for u in jw.forwards}))
    return jw, tw


def test_stacked_archive_equals_reference(tmp_path):
    """From the same weights the port writes the reference's archive of
    the stacked LM (contents.json equal, every .npy the same bytes); the
    port's ArchiveModel serves it as the training forward does."""
    with lm_config(model=STACKED_MODEL):
        jw, tw = _stack_pair()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jw.export_inference(str(jdir))
    tw.export_inference(str(tdir))
    assert json.loads((tdir / "contents.json").read_text()) == \
        json.loads((jdir / "contents.json").read_text())
    files = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == files
    assert any("ffn_w2" in f for f in files)
    for name in files:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    rows = tw.loader.original_data[:4].astype(numpy.float32)
    _, want = tw.step._forward(torch.from_numpy(rows), False)
    got = ArchiveModel.from_dir(str(tdir), device="cpu")(rows)
    _close(got, want.numpy())


PROMPTS = numpy.array([[1, 2, 3, 1, 2, 3], [5, 6, 5, 6, 5, 6]], numpy.int32)


def test_block_decode_greedy_equals_reference(tmp_path):
    """The stacked LM trained by the port for 8 epochs: its greedy
    generate() (KV caches through block_decode) equals the reference's
    generate() with the same weights token for token, past the training
    length; GenerativeEngine on the exported archive gives the same."""
    with lm_config(model=STACKED_MODEL, decision={"max_epochs": 8}):
        tprng.seed_all(7)
        tw = tlm.create_workflow(name="StackGen").initialize(device="cpu")
        tw.run()
        jprng.seed_all(7)
        jw = jlm.create_workflow(name="StackGen")
        jw.initialize(device="numpy")
    for ju, tu in zip(jw.forwards, tw.forwards):
        ju.import_params({k: v.numpy() for k, v in
                          tu.export_params().items()})
    want = jgen.generate(jw, PROMPTS, 24, temperature=0.0)
    got = tgen.generate(tw, PROMPTS, 24)
    numpy.testing.assert_array_equal(got, want)
    assert len(set(got.ravel().tolist())) > 2
    tw.export_inference(str(tmp_path))
    engine = GenerativeEngine(ArchiveModel.from_dir(str(tmp_path),
                                                    device="cpu"),
                              n_slots=2, max_len=64, device="cpu")
    assert engine.plan.n_caches == tw.forwards[1].layers
    toks = [[engine.prefill_into(i, list(PROMPTS[i]), 0.0)]
            for i in range(2)]
    pos = numpy.full(2, PROMPTS.shape[1], numpy.int32)
    for _ in range(7):
        nxt = engine.step(numpy.array([t[-1] for t in toks], numpy.int32),
                          pos, numpy.zeros(2, numpy.float32))
        for t, n in zip(toks, nxt):
            t.append(int(n))
        pos += 1
    numpy.testing.assert_array_equal(numpy.array(toks), want[:, :8])


@pytest.mark.parametrize("model", [STACKED_MODEL, {
    "moe_experts": 4, "attn_impl": None, "attn_block": None}],
    ids=["stacked", "moe"])
def test_tree_from_jax_carries_the_slice_state(model):
    """``convert.tree_from_jax`` of a reference LM under AdamW with
    accumulation carries the stacked (L, ...) parameters or the MoE
    router and experts, and every ``vel_*``/``sq_*``/``acc_*`` tensor,
    ``acc_count`` and ``iteration``; the port imports it and exports the
    same tree bit for bit."""
    from veles.config import root as jroot
    from veles_torch.config import root as troot
    from veles_torch.convert import tree_from_jax
    saved = [(r, r.lm.train.to_dict()) for r in (jroot, troot)]
    try:
        with lm_config(model=model):
            for r in (jroot, troot):
                r.lm.train.update({"solver": "adam",
                                   "accumulate_gradient": 2})
            jw, tw = jax_lm(), torch_lm()
    finally:
        for r, tree in saved:
            r.lm.train = tree
    tree = tree_from_jax(jw)
    keys = {k for sub in tree.values() for k in sub}
    assert {"sq_weights", "acc_weights", "acc_count", "iteration"} <= keys
    assert ("ffn_w2" in keys and "sq_ffn_w2" in keys) if "stacked" in \
        model else ("router" in keys and "acc_router" in keys)
    tw.import_tree(params_from_jax(tree))
    got = params_to_numpy(tw.export_tree())
    assert sorted(got) == sorted(tree)
    for unit, sub in tree.items():
        assert sorted(got[unit]) == sorted(sub), unit
        for key, value in sub.items():
            assert numpy.array_equal(got[unit][key], value), (unit, key)
