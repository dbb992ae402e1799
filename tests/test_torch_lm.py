"""The port's transformer LM (veles_torch/znicz/models/transformer_lm.py)
against the JAX package's (veles/znicz_tpu/models/transformer_lm.py) run
with ``device="cpu"`` (XLA on the CPU; with ``attn_impl="pallas"`` the
Pallas flash kernels run in interpret mode), at the small size of
tests/test_pallas_attention.py: dim 32, 2 heads, 1 layer, S 16, vocab 8.
Same seed -> the same data and initial parameters bit for bit; one train
step from the same state, and a few epochs, agree within stated f32
tolerances; the unported modes refuse loudly."""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.znicz_tpu.models import transformer_lm as jlm
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.backends import TorchDevice
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.znicz.models import transformer_lm as tlm
from veles_torch.znicz.ops import flash_attention as FA
from veles_torch.znicz.ops.attention import MultiHeadAttention
from veles_torch.znicz.ops.embedding import embedding_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = os.path.join(REPO, "veles_torch", "znicz", "models", "transformer_lm.py")
SMALL_LOADER = {"minibatch_size": 32, "n_train": 256, "n_valid": 64,
                "seq_len": 16, "vocab": 8, "max_period": 4}
SMALL_MODEL = {"dim": 32, "heads": 2, "layers": 1, "ffn_hidden": 64,
               "attn_block": None, "attn_impl": "pallas", "moe_experts": 0,
               "stacked": False}
#: one train step from the same state: parameters and momentum agree to
#: f32 summation-order error (the matmuls and the scatter-add sum in
#: another order; the flash kernels in blocks on the JAX side). Observed
#: on this CPU: 3e-8
STEP_ATOL = 1e-6
#: three epochs (24 train steps at momentum 0.9): per-epoch losses and
#: the final parameters; the order differences above compound step by
#: step. Observed: 3.6e-7 (losses), 1.3e-7 (parameters)
EPOCHS_ATOL = 1e-5
#: one step under the bf16 policy, against each momentum's largest
#: element: both packages multiply the same bf16-rounded inputs in f32.
#: Observed 5.2e-7; with products rounded to bf16 (the port's ``dot``
#: once did) 3.7e-4 to 1.8e-2
BF16_STEP_RTOL = 1e-5


@contextlib.contextmanager
def lm_config(loader=None, model=None, decision=None, parallel=None):
    """The same root.lm overrides in both packages, restored after."""
    saved = [(r, r.lm.to_dict()) for r in (jroot, troot)]
    try:
        for r in (jroot, troot):
            r.lm.loader.update(dict(SMALL_LOADER, **(loader or {})))
            r.lm.model.update(dict(SMALL_MODEL, **(model or {})))
            r.lm.decision.update(dict({"max_epochs": 3}, **(decision or {})))
            r.lm.parallel.update(dict({"seq": 1, "model": 1, "data": 1,
                                       "expert": 1, "pipe": 1},
                                      **(parallel or {})))
        yield
    finally:
        for r, tree in saved:
            r.lm.update(tree)


def jax_lm(seed=1337):
    jprng.seed_all(seed)
    wf = jlm.create_workflow(name="JaxLM")
    wf.initialize(device="cpu")
    return wf


def torch_lm(seed=1337):
    tprng.seed_all(seed)
    return tlm.create_workflow(name="TorchLM").initialize(device="cpu")


def jax_tree(wf):
    return {u.name: {**u.export_params(), **u.export_state()}
            for u in wf.forwards + wf.gds}


def assert_trees_close(want, got, atol):
    assert sorted(want) == sorted(got)
    worst = 0.0
    for unit in want:
        assert sorted(want[unit]) == sorted(got[unit]), unit
        for key, value in want[unit].items():
            diff = numpy.abs(got[unit][key].astype(numpy.float64)
                             - numpy.asarray(value, numpy.float64)).max()
            assert diff <= atol, (unit, key, diff)
            worst = max(worst, diff)
    return worst


def test_same_seed_same_data_and_parameters():
    """At seed 1337 the periodic corpus, the [valid | train] layout, the
    first shuffle and every initial parameter are bitwise the JAX
    package's, under the same unit names and keys."""
    with lm_config():
        jw, tw = jax_lm(), torch_lm()
    assert numpy.array_equal(jw.loader.original_data.mem,
                             tw.loader.original_data)
    assert numpy.array_equal(jw.loader.original_labels.mem,
                             tw.loader.original_labels)
    assert tw.loader.class_lengths == list(jw.loader.class_lengths)
    assert numpy.array_equal(jw.loader.class_schedule(2)[0],
                             tw.loader.class_schedule(2)[0])
    want, got = jax_tree(jw), params_to_numpy(tw.export_tree())
    assert sorted(want) == sorted(got)
    for unit, sub in want.items():
        assert sorted(sub) == sorted(got[unit]), unit
        for key, value in sub.items():
            assert numpy.array_equal(value, got[unit][key]), (unit, key)


@contextlib.contextmanager
def bf16_policy():
    """The card's dtype policy in both packages on the CPU:
    ``root.common.engine.amp = compute_dtype = "bfloat16"``, cleared
    after."""
    try:
        for r in (jroot, troot):
            r.common.engine.amp = r.common.engine.compute_dtype = "bfloat16"
        yield
    finally:
        for r in (jroot, troot):
            r.common.engine.amp = r.common.engine.compute_dtype = None


def one_step(jw, tw):
    """One train step of both LMs from the reference's state ->
    (reference tree, port tree, reference outputs, port metrics)."""
    tw.import_tree(params_from_jax(jax_tree(jw)))
    idx_mat, valids = jw.loader.class_schedule(2)
    data = jw.loader.original_data.mem[idx_mat[0]]
    labels = jw.loader.original_labels.mem[idx_mat[0]]
    step = jw.xla_step
    fn = step.compiler.compile(step._batch_spec, train=True)
    params, state, outs = fn(
        step.params, step.state,
        {"data": data, "labels": labels,
         "batch_size": numpy.int32(valids[0])},
        step._gather_hyper(), jax.random.PRNGKey(0))
    metrics = tw.step.train_minibatch(
        torch.from_numpy(data), torch.from_numpy(labels.astype(numpy.int64)),
        torch.tensor(int(valids[0])))
    want = {u: {k: numpy.asarray(v) for k, v in
                {**params.get(u, {}), **state.get(u, {})}.items()}
            for u in set(params) | set(state)}
    return want, params_to_numpy(tw.export_tree()), outs, metrics


@pytest.mark.parametrize("impl", ["pallas", None], ids=["pallas", "dense"])
def test_one_train_step_matches_reference(impl):
    """One train step from the reference's exported state: every
    parameter and momentum within STEP_ATOL, the same loss and wrong-token
    count."""
    with lm_config(model={"attn_impl": impl}):
        jw, tw = jax_lm(), torch_lm()
    want, got, outs, metrics = one_step(jw, tw)
    assert_trees_close(want, got, STEP_ATOL)
    assert abs(float(outs["loss"]) - float(metrics[0])) < STEP_ATOL
    assert int(outs["n_err"]) == int(metrics[1])


def test_one_train_step_matches_reference_bf16_policy():
    """One pallas-mode train step under the card's dtype policy (bf16
    products, activations and flash inputs), held on the CPU: every
    momentum (from zero: the gradient times the rate) within
    BF16_STEP_RTOL of the reference's largest element, the same loss (to
    STEP_ATOL) and wrong-token count."""
    with lm_config(), bf16_policy():
        jw, tw = jax_lm(), torch_lm()
        assert tw.device.compute_dtype == tw.device.act_dtype == \
            torch.bfloat16
        want, got, outs, metrics = one_step(jw, tw)
    momenta = [(u, k) for u in want for k in want[u] if k.startswith("vel")]
    assert len(momenta) == 15
    for unit, key in momenta:
        w = want[unit][key].astype(numpy.float64)
        diff = numpy.abs(got[unit][key] - w).max() / numpy.abs(w).max()
        assert diff <= BF16_STEP_RTOL, (unit, key, diff)
    assert abs(float(outs["loss"]) - float(metrics[0])) < STEP_ATOL
    assert int(outs["n_err"]) == int(metrics[1])


@pytest.mark.parametrize("impl", ["pallas", None], ids=["pallas", "dense"])
def test_epochs_match_reference(impl):
    """Three epochs at seed 1337: equal history lengths and sample
    counts, per-epoch losses and the final parameters and momenta within
    EPOCHS_ATOL, and the validation loss falls."""
    with lm_config(model={"attn_impl": impl}):
        jw, tw = jax_lm(), torch_lm()
        jw.run()
        tw.run()
    jh, th = jw.decision.history, tw.decision.history
    assert len(jh) == len(th) == 3
    for j, t in zip(jh, th):
        for cls in ("validation", "train"):
            assert j[cls]["samples"] == t[cls]["samples"]
            assert abs(j[cls]["loss"] - t[cls]["loss"]) < EPOCHS_ATOL, \
                (cls, j[cls]["loss"], t[cls]["loss"])
    assert th[-1]["validation"]["loss"] < th[0]["validation"]["loss"]
    assert_trees_close(jax_tree(jw), params_to_numpy(tw.export_tree()),
                       EPOCHS_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_grad_matches_reference_scatter(dtype):
    """The embedding gradient (a stable sort, then a sum per id in the
    order the ids appear) against the reference's ``zeros.at[ids].add``
    (``GDEmbedding.xla_run``) on 256 tokens of a 13-word vocabulary: every
    id repeated, ids 0 and 12 never seen (their rows stay 0); within 1e-6
    (f32 sums; observed equal)."""
    rng = numpy.random.default_rng(8)
    ids = rng.integers(1, 12, (16, 16))
    err = rng.normal(0, 1, (16, 16, 32)).astype(numpy.float32)
    want = numpy.asarray(jnp.zeros((13, 32), jnp.float32).at[
        jnp.asarray(ids.ravel(), jnp.int32)].add(
        jnp.asarray(err, dtype).reshape(-1, 32)))
    got = embedding_grad(torch.from_numpy(ids),
                         torch.from_numpy(err).to(getattr(torch, dtype)), 13)
    assert got.dtype == torch.float32 and got.shape == (13, 32)
    assert not bool(got[0].any()) and not bool(got[12].any())
    assert numpy.abs(got.numpy() - want).max() <= 1e-6, \
        numpy.abs(got.numpy() - want).max()


def test_pallas_mode_goes_through_the_flash_wrappers():
    """attn_impl='pallas' (and the pipelined variant) reaches the flash
    wrappers: their plain versions on the CPU give what the dense mode
    gives, to f32 order error."""
    x = torch.from_numpy(numpy.random.default_rng(3).normal(
        0, 1, (2, 40, 32)).astype(numpy.float32))
    cpu = TorchDevice("cpu")
    outs = []
    for kwargs in ({"attn_impl": "pallas"},
                   {"attn_impl": "pallas", "attn_pipeline": True}, {}):
        tprng.seed_all(5)
        mha = MultiHeadAttention(heads=2, **kwargs)
        mha.initialize((2, 40, 32), cpu)
        outs.append(mha(x))
        assert len(mha.cache) == (6 if kwargs else 5)
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] - outs[2]).abs().max().item() < 1e-5


def test_knob_refusals_match_reference():
    """attention.py:481-491: attn_pipeline / attn_acc='bf16' off the
    pallas mode raise ValueError naming pallas; attn_acc='f32' is the
    plain default; bad knob values are refused at construction."""
    for kwargs in ({"attn_pipeline": True}, {"attn_acc": "bf16"}):
        with pytest.raises(ValueError, match="pallas"):
            MultiHeadAttention(heads=2, **kwargs).mode(32)
        with pytest.raises(ValueError, match="pallas"):
            MultiHeadAttention(heads=2, attn_impl="scan",
                               attn_block_size=16, **kwargs).mode(32)
        assert MultiHeadAttention(heads=2, attn_impl="pallas",
                                  **kwargs).mode(32) == "pallas"
    assert MultiHeadAttention(heads=2, attn_acc="f32").mode(32) == "dense"
    with pytest.raises(ValueError):
        MultiHeadAttention(heads=2, attn_acc="fp64")
    with pytest.raises(ValueError):
        MultiHeadAttention(heads=2, attn_impl="ring")


@pytest.mark.parametrize("kwargs", [
    {"attn_impl": "pallas", "pallas_tile": 16}], ids=str)
def test_unported_attention_modes_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultiHeadAttention(heads=2, **kwargs).mode(32)


@pytest.mark.parametrize("override", [
    {"parallel": {"seq": 2}},
    {"parallel": {"pipe": 2}},
    {"parallel": {"expert": 2}}], ids=str)
def test_unported_lm_options_raise(override):
    """``seq``, ``pipe`` and ``expert`` are ported and build, and need
    their ranks: initialized in one process (no process group of 2) each
    raises naming the mesh."""
    with lm_config(**override):
        wf = tlm.create_workflow()
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            wf.initialize(device="cpu")


def test_entry_point_trains_on_cpu(tmp_path, capsys):
    """The CLI line of the sample on -d cpu: the history has every epoch
    and the validation loss falls; kernels are not launched on the CPU."""
    FA.reset_launches()
    small = ["root.lm.%s.%s=%r" % (part, key, value)
             for part, sub in (("loader", SMALL_LOADER),
                               ("model", SMALL_MODEL))
             for key, value in sub.items()]
    with lm_config():
        wf = torch_main([LM, *small, "root.lm.model.attn_impl=pallas",
                         "root.lm.decision.max_epochs=3", "-d", "cpu",
                         "--seed", "1337"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"] == "cpu" and len(last["history"]) == 3
    losses = [h["validation"]["loss"] for h in last["history"]]
    assert losses[-1] < losses[0], losses
    assert wf.step.train_steps == 3 * 256 // 32
    assert FA.flash_attention_fwd.launches == 0


def test_entry_point_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with lm_config():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_main([LM, "root.lm.decision.max_epochs=1"])
