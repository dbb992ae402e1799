"""The port's MoE FFN (veles_torch/znicz/ops/moe.py) against the JAX
package's (veles/znicz_tpu/ops/moe.py) on the CPU: the forward, the GD's
gradients with the load-balancing term, the capacity drops index for
index, the MoE LM's step, archive and greedy decode."""

import json

import jax
import numpy
import pytest
import torch

from veles.accelerated_units import FlowContext
from veles.znicz_tpu import generate as jgen
from veles.znicz_tpu.ops import moe as JM
import veles_torch.prng as tprng
from veles_torch.backends import TorchDevice
from veles_torch.convert import params_to_numpy
from veles_torch.serving import ArchiveModel
from veles_torch.znicz import generate as tgen
from veles_torch.znicz.models import transformer_lm as tlm
from veles_torch.znicz.nn_units import gradient_unit_for
from veles_torch.znicz.ops import moe as TM

from tests.test_conv_stack import build
from tests.test_torch_lm import (
    EPOCHS_ATOL, STEP_ATOL, assert_trees_close, jax_lm, jax_tree, lm_config,
    one_step, torch_lm)
from tests.test_torch_stack import _stack_pair

#: the forward against the reference's traced forward, a share of the
#: largest output (f32 order error)
FWD_RTOL = 1e-6
#: the gradients (one step at lr 1 from zero momentum) and err_input
GRAD_RTOL = 1e-5
CASES = [dict(experts=4, hidden=16), dict(experts=2, hidden=8,
                                          residual=False),
         dict(experts=4, hidden=16, capacity_factor=0.5)]
#: the MoE LM of both packages, its capacity and aux weight set (the
#: samples' defaults): tests/test_moe.py leaves the reference's root at
#: other values, and a worker that ran it first built two MoE LMs apart
MOE_MODEL = {"moe_experts": 4, "moe_capacity_factor": 2.0,
             "moe_aux_weight": 0.01, "attn_impl": None, "attn_block": None,
             "stacked": False}


def _share(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = numpy.asarray(want, numpy.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return numpy.abs(got.astype(numpy.float64) - want).max() / \
        max(numpy.abs(want).max(), 1e-30)


def traced(comp, feed, fwd, gd, x, err):
    """The reference's traced forward and GD -> (output, cache, err_input,
    new params)."""
    def fn(p, s, xv, ev):
        ctx = FlowContext(comp, dict(p), dict(s),
                          {gd.name: gd.hyperparams()},
                          jax.random.PRNGKey(7), True)
        ctx.set(feed, "minibatch_data", xv)
        fwd.xla_run(ctx)
        y = ctx.get(fwd, "output")
        cache = {k: ctx.get(fwd, "cache_" + k) for k in ("dispatch", "gate")}
        ctx.set(gd, "err_output", ev)
        gd.xla_run(ctx)
        return y, cache, ctx.values.get((gd.name, "err_input")), ctx.params

    return jax.jit(fn)(comp.gather_params(), comp.gather_state(), x, err)


def port_pair(params, kwargs, x_shape, gd_kwargs):
    fwd = TM.MoEFFN(**kwargs)
    fwd.initialize(x_shape, TorchDevice("cpu"))
    for key, value in params.items():
        setattr(fwd, key, torch.from_numpy(numpy.array(value)))
    gd = gradient_unit_for(TM.MoEFFN)(**dict(gd_kwargs, learning_rate=1.0))
    gd.setup_forward(fwd)
    gd.initialize()
    return fwd, gd


@pytest.mark.parametrize("kwargs", CASES, ids=str)
@pytest.mark.parametrize("aux", [0.0, 0.37], ids=["no_aux", "aux"])
def test_unit_matches_reference(kwargs, aux):
    """Forward within FWD_RTOL; the dispatch assignment (the capacity
    drops) index for index; err_input and every parameter after one step
    at lr 1 (the gradients, the router's with the load-balancing term)
    within GRAD_RTOL."""
    wf, feed, jf, jg, x, err, comp = build(
        JM.MoEFFN, input_shape=(2, 6, 8), gd_kwargs={"aux_weight": aux},
        **kwargs)
    params0 = comp.gather_params()[jf.name]
    y, cache, ei, params1 = traced(comp, feed, jf, jg,
                                   x.astype(numpy.float32),
                                   err.astype(numpy.float32))
    fwd, gd = port_pair(params0, kwargs, x.shape, {"aux_weight": aux})
    xt = torch.from_numpy(x.astype(numpy.float32))
    ty = fwd(xt)
    assert _share(ty, y) <= FWD_RTOL
    dispatch = fwd.cache["dispatch"]
    assert numpy.array_equal(dispatch.numpy(), numpy.asarray(
        cache["dispatch"]))
    dropped = 12 - int(numpy.asarray(cache["dispatch"]).sum())
    assert int(fwd.dropped) == dropped
    if kwargs.get("capacity_factor") == 0.5:
        assert dropped > 0
    tei = gd.run(xt, ty, torch.from_numpy(err.astype(numpy.float32)))
    assert _share(tei, ei) <= GRAD_RTOL
    for key, value in params1[jf.name].items():
        assert _share(getattr(fwd, key), value) <= GRAD_RTOL, key


def test_aux_gradient_matches_jax_grad():
    """The router's gradient from the analytic load-balancing term alone
    (zero error) equals jax.grad of aux_w·E·Σ_e f_e·mean_t(probs), f held
    constant, within GRAD_RTOL."""
    import jax.numpy as jnp
    aux_w = 0.37
    wf, feed, jf, jg, x, err, comp = build(
        JM.MoEFFN, input_shape=(2, 6, 8), gd_kwargs={"aux_weight": aux_w},
        experts=4, hidden=16)
    params0 = comp.gather_params()

    def loss(p):
        ctx = FlowContext(comp, dict(p), {}, {}, jax.random.PRNGKey(7),
                          True)
        ctx.set(feed, "minibatch_data", x)
        jf.xla_run(ctx)
        probs = ctx.get(jf, "cache_probs")
        onehot = jax.lax.stop_gradient(ctx.get(jf, "cache_onehot_e"))
        return aux_w * jf.experts * jnp.sum(onehot.mean(axis=0)
                                            * probs.mean(axis=0))

    want = numpy.asarray(jax.grad(loss)(params0)[jf.name]["router"])
    fwd, gd = port_pair(params0[jf.name], dict(experts=4, hidden=16),
                        x.shape, {"aux_weight": aux_w})
    xt = torch.from_numpy(x.astype(numpy.float32))
    fwd(xt)
    _, grads = gd.backward(xt, torch.zeros_like(xt))
    assert _share(grads["router"], want) <= GRAD_RTOL


def test_capacity_drop_brute_force():
    """Capacity 1 per expert: routing token by token in order reproduces
    the unit's output (dropped tokens pass through the residual alone)."""
    tprng.seed_all(2)
    fwd = TM.MoEFFN(experts=2, hidden=8, capacity_factor=0.25)
    fwd.initialize((1, 8, 8), TorchDevice("cpu"))
    assert fwd.capacity(8) == 1
    x = torch.from_numpy(numpy.random.default_rng(1).normal(
        0, 1, (1, 8, 8)).astype(numpy.float32))
    y = fwd(x)[0]
    xt = x[0]
    logits = xt @ fwd.router
    probs = torch.softmax(logits, -1)
    seen, want = [0, 0], xt.clone()
    for t in range(8):
        e = int(logits[t].argmax())
        if seen[e] >= 1:
            continue
        seen[e] += 1
        h = torch.clamp_min(xt[t] @ fwd.weights[e] + fwd.bias[e], 0)
        want[t] += probs[t, e] * (h @ fwd.weights2[e] + fwd.bias2[e])
    assert sum(seen) == 2 and int(fwd.dropped) == 6
    assert (y - want).abs().max() <= 1e-5


def test_moe_lm_step_and_epochs_match_reference():
    """The MoE LM (4 experts a layer, capacity factor 2, aux weight 0.01):
    one step from the reference's state within STEP_ATOL, three epochs
    from the same seed within EPOCHS_ATOL."""
    with lm_config(model=MOE_MODEL):
        jw, tw = jax_lm(), torch_lm()
        assert type(tw.forwards[3]).__name__ == "MoEFFN"
        want, got, outs, metrics = one_step(jw, tw)
        assert_trees_close(want, got, STEP_ATOL)
        assert int(outs["n_err"]) == int(metrics[1])
        jw, tw = jax_lm(), torch_lm()
        jw.run()
        tw.run()
    for j, t in zip(jw.decision.history, tw.decision.history):
        for cls in ("validation", "train"):
            assert abs(j[cls]["loss"] - t[cls]["loss"]) < EPOCHS_ATOL
    assert len(tw.decision.history) == 3
    assert_trees_close(jax_tree(jw), params_to_numpy(tw.export_tree()),
                       EPOCHS_ATOL)


def test_moe_archive_and_decode_equal_reference(tmp_path):
    """The MoE LM's archive byte for byte against the reference's from the
    same weights; served by the port as the training forward computes
    each sample (routed on its own tokens); greedy generate() equal to
    the reference's for one prompt."""
    with lm_config(model=MOE_MODEL):
        jw, tw = _stack_pair()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jw.export_inference(str(jdir))
    tw.export_inference(str(tdir))
    assert json.loads((tdir / "contents.json").read_text()) == \
        json.loads((jdir / "contents.json").read_text())
    files = sorted(p.name for p in jdir.iterdir())
    assert any("router" in f for f in files)
    for name in files:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    rows = tw.loader.original_data[:2].astype(numpy.float32)
    model = ArchiveModel.from_dir(str(tdir), device="cpu")
    for i in range(2):
        _, want = tw.step._forward(torch.from_numpy(rows[i:i + 1]), False)
        assert _share(model(rows[i:i + 1]), want.numpy()) <= FWD_RTOL
    prompt = numpy.array([[1, 2, 3, 1, 2, 3]], numpy.int32)
    numpy.testing.assert_array_equal(
        tgen.generate(tw, prompt, 12),
        jgen.generate(jw, prompt, 12, temperature=0.0))


def test_moe_refusals():
    with pytest.raises(ValueError, match="experts >= 2"):
        TM.MoEFFN(experts=1)
