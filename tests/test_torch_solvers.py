"""The port's solver options (veles_torch/znicz/nn_units.py,
veles_torch/znicz/lr_adjust.py) against the JAX package's traced update
(veles/znicz_tpu/nn_units.py, lr_adjust.py) run on the CPU: AdamW,
gradient accumulation, the six lr policies, ``lr_scale`` applied after
the policy, ``link_lr_adjuster``, and the EXTRA_PARAMS updates of the
attention, FFN and MoE units, from the same state (the reference's tree,
converted by ``params_from_jax``)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles.prng as jprng
from veles.accelerated_units import FlowContext
from veles.config import root as jroot
from veles.znicz_tpu import lr_adjust as JLR
from veles.znicz_tpu.models.mnist import MnistLoader as JaxMnistLoader
from veles.znicz_tpu.ops import attention as JA
from veles.znicz_tpu.ops import moe as JM
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
import veles_torch.prng as tprng
from veles_torch.backends import TorchDevice
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.znicz import lr_adjust as TLR
from veles_torch.znicz.models.mnist import MnistLoader as TorchMnistLoader
from veles_torch.znicz.nn_units import gradient_unit_for
from veles_torch.znicz.ops import attention as TA
from veles_torch.znicz.ops import moe as TM
from veles_torch.znicz.standard_workflow import \
    StandardWorkflow as TorchStandardWorkflow

from tests.test_conv_stack import build
from tests.test_torch_lm import jax_lm, lm_config, torch_lm

#: MNIST at the size of tests/test_torch_mnist.py: 5 train steps an epoch
SMALL = dict(minibatch_size=20, n_train=100, n_valid=40)
#: one step, or a few, from the same state: every parameter and solver
#: tensor within this share of its largest element. The gradients
#: themselves differ by f32 order error and XLA's tanh, up to 8.8e-7 of
#: the largest (MNIST, momentum, observed)
STEP_RTOL = 1e-6
#: the second moment ``sq_*`` squares the gradient, which doubles its
#: relative error (observed 1.1e-6 on the LM's attention)
SQ_RTOL = 2 * STEP_RTOL
#: three epochs: the order errors compound over 15 (MNIST) or 24 (LM)
#: updates
EPOCHS_RTOL = 1e-5
#: an lr policy's value against the reference's traced f32 value, as a
#: share of the base rate: the reference's XLA CPU code fuses ``1 +
#: gamma·t`` and the cosine's ``min + a·(1 + cos)`` into single-rounding
#: multiply-adds, and its cos lies up to 2.1e-7 from torch's (7 ulp at
#: 0.3), halved by the cosine schedule's 0.5: the two read up to 1.1e-7
#: of the base rate apart (observed)
POLICY_RTOL = 2e-7

#: AdamW as the workflow tests run it. adam_eps sets how far the step
#: m/(sqrt(v) + eps) moves with the gradient where the gradient is small:
#: by lr/eps times the gradient's own error. Between the packages that
#: error is f32 order error (and XLA's tanh), some 1e-7 of the largest
#: gradient (the momentum tests hold it); at lr 0.002 and eps 1e-2 the
#: weights stay within STEP_RTOL, where eps 1e-8 would turn that noise
#: into steps of ±lr. test_adam_update_matches_reference_traced holds the
#: update itself at the default eps, from equal gradients
ADAM = {"solver": "adam", "learning_rate": 0.002, "gradient_moment": 0.9,
        "adam_beta2": 0.99, "adam_eps": 1e-2, "weights_decay": 0.01}


def _layers(gd):
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
             "<-": dict(gd)},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": dict(gd)}]


def mnist_pair(gd, max_epochs=1, seed=1337, before_init=None):
    """The reference's MNIST chain and the port's, with GD kwargs ``gd``,
    the port holding the reference's initial state; ``before_init(wf)``
    runs on each workflow before it is initialized."""
    before_init = before_init or (lambda wf: None)
    gd = dict({"learning_rate": 0.02}, **gd)
    jprng.seed_all(seed)
    mb = SMALL["minibatch_size"]
    decision = {"max_epochs": max_epochs, "fail_iterations": 50}
    jw = JaxStandardWorkflow(
        None, name="JaxMnist", layers=_layers(gd),
        loader_factory=lambda w: JaxMnistLoader(
            w, name="loader", minibatch_size=mb, n_train=SMALL["n_train"],
            n_valid=SMALL["n_valid"]),
        decision_config=decision)
    before_init(jw)
    jw.initialize(device="cpu")
    tprng.seed_all(seed)
    tw = TorchStandardWorkflow(
        name="TorchMnist", layers=_layers(gd),
        loader_factory=lambda w: TorchMnistLoader(
            w, name="loader", minibatch_size=mb, n_train=SMALL["n_train"],
            n_valid=SMALL["n_valid"]),
        decision_config=decision)
    before_init(tw)
    tw.initialize(device="cpu")
    tw.import_tree(params_from_jax(jax_tree(jw)))
    return jw, tw


def jax_tree(wf):
    return {u.name: {**u.export_params(), **u.export_state()}
            for u in wf.forwards + wf.gds}


def assert_close_rel(want, got, rtol):
    """Every tensor of ``got`` within ``rtol`` of the largest element of
    its counterpart in ``want`` (a second moment ``sq_*`` within twice
    that: it squares the gradient); the same units and keys. -> the worst
    share."""
    assert sorted(want) == sorted(got)
    worst = 0.0
    for unit in want:
        assert sorted(want[unit]) == sorted(got[unit]), unit
        for key, value in want[unit].items():
            w = numpy.asarray(value, numpy.float64)
            g = numpy.asarray(got[unit][key], numpy.float64)
            assert w.shape == g.shape, (unit, key)
            scale = max(numpy.abs(w).max(), 1e-30)
            share = numpy.abs(g - w).max() / scale
            limit = 2 * rtol if key.startswith("sq_") else rtol
            assert share <= limit, (unit, key, share)
            worst = max(worst, share)
    return worst


def train_steps(jw, tw, n):
    """``n`` train steps of both workflows on the first train minibatches
    of the schedule -> [(reference tree, port tree)] after each."""
    idx_mat, valids = jw.loader.class_schedule(2)
    step = jw.xla_step
    fn = step.compiler.compile(step._batch_spec, train=True)
    params, state = step.params, step.state
    out = []
    for i in range(n):
        data = jw.loader.original_data.mem[idx_mat[i]]
        labels = jw.loader.original_labels.mem[idx_mat[i]]
        params, state, _ = fn(
            params, state,
            {"data": data, "labels": labels,
             "batch_size": numpy.int32(valids[i])},
            step._gather_hyper(), jax.random.PRNGKey(0))
        tw.step.train_minibatch(
            torch.from_numpy(data),
            torch.from_numpy(labels.astype(numpy.int64)),
            torch.tensor(int(valids[i])))
        want = {u: {k: numpy.asarray(v) for k, v in
                    {**params.get(u, {}), **state.get(u, {})}.items()}
                for u in set(params) | set(state)}
        out.append((want, params_to_numpy(tw.export_tree())))
    return out


# -- lr policies ------------------------------------------------------------

POLICY_SPECS = [
    {"name": "fixed"},
    {"name": "step", "gamma": 0.5, "step": 7},
    {"name": "exp", "gamma": 0.97},
    {"name": "inv", "gamma": 0.01, "power": 0.75},
    {"name": "arbitrary_step", "schedule": [(0.1, 5), (0.03, 20),
                                            (0.007, 1)]},
    {"name": "arbitrary_step", "schedule": [(0.2, 1)]},
    {"name": "warmup_cosine", "warmup": 10, "total": 100,
     "min_ratio": 0.1},
    {"name": "warmup_cosine", "warmup": 0, "total": 50},
]


@pytest.mark.parametrize("spec", POLICY_SPECS,
                         ids=lambda s: "%s-%d" % (s["name"], len(s)))
def test_policy_matches_reference_traced(spec):
    """lr(t) at t = 0..120 against the reference's policy traced by
    jax.jit on an int32 counter with an f32 base rate: within POLICY_RTOL
    of the base rate (of the value itself where a schedule replaces the
    base), computed from the port's int32 counter as an f32 scalar."""
    base = numpy.float32(0.05)
    jpol, tpol = JLR.make_policy(dict(spec)), TLR.make_policy(dict(spec))
    traced = jax.jit(lambda t: jpol(jnp, jnp.float32(base), t))
    for t in range(121):
        want = float(traced(jnp.int32(t)))
        got = tpol(float(base), torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        scale = max(float(base), abs(want))
        assert abs(float(got) - want) <= POLICY_RTOL * scale, \
            (t, float(got), want)


def test_policy_specs_and_errors():
    assert TLR.make_policy(None) is None
    pol = TLR.StepPolicy(0.5, 3)
    assert TLR.make_policy(pol) is pol
    with pytest.raises(ValueError):
        TLR.WarmupCosinePolicy(warmup=10, total=10)
    with pytest.raises(ValueError):
        TLR.ArbitraryStepPolicy([])
    with pytest.raises(TypeError):
        TLR.make_policy(3)
    with pytest.raises(ValueError, match="solver"):
        gradient_unit_for(TA.TokenDense)(solver="sgd")
    assert "gamma=0.5" in repr(pol)


# -- AdamW ------------------------------------------------------------------


def _reference_step(solver, accumulate, w, vel, acc, sq, grad, t, h):
    """The reference's traced ``_step_param`` (jitted, t an int32 scalar)
    on host arrays -> (w, vel, acc, sq) as numpy."""
    from types import SimpleNamespace
    from veles.znicz_tpu.nn_units import GradientDescentBase as JGD
    gd = SimpleNamespace(solver=solver, accumulate_gradient=accumulate,
                         apply_update=JGD.apply_update)
    gd.apply_update_adam = lambda *a: JGD.apply_update_adam(gd, *a)

    def fn(w, vel, acc, sq, grad, t, count):
        apply_now = count >= accumulate
        return JGD._step_param(gd, jnp, w, vel, acc, grad, apply_now,
                               h["lr"] * h["lr_scale"], h["moment"],
                               h["l2"], h["l1_vs_l2"], sq=sq, t=t,
                               beta2=h["beta2"], adam_eps=h["adam_eps"])

    count = (t % accumulate) + 1
    out = jax.jit(fn)(w, vel, acc, sq, grad, jnp.int32(t), count)
    return [None if o is None else numpy.asarray(o) for o in out]


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("solver", ["adam", "momentum"])
def test_adam_update_matches_reference_traced(solver, accumulate):
    """One parameter update from equal state and equal gradients (spread
    over eight decades, zeros among them) at the default adam_eps, at t =
    0, 1 and 6: the weights, moments and accumulator within STEP_RTOL of
    their largest element (the reference's XLA code fuses multiply-adds:
    a few ulp)."""
    rng = numpy.random.default_rng(5)
    shape = (16, 24)
    mag = 10.0 ** rng.uniform(-8, 0, shape)
    grad = (rng.normal(0, 1, shape) * mag).astype(numpy.float32)
    grad[0, :4] = 0
    w = rng.normal(0, 0.1, shape).astype(numpy.float32)
    vel = rng.normal(0, 1e-3, shape).astype(numpy.float32)
    sq = (rng.normal(0, 1e-3, shape) ** 2).astype(numpy.float32) \
        if solver == "adam" else None
    acc = (rng.normal(0, 1, shape) * mag).astype(numpy.float32) \
        if accumulate > 1 else None
    for t in (0, 1, 6):
        gd = gradient_unit_for(TA.TokenDense)(
            solver=solver, learning_rate=0.003, gradient_moment=0.9,
            weights_decay=0.01, accumulate_gradient=accumulate)
        gd.lr_scale = 0.7
        fwd = TA.TokenDense(output_features=24, include_bias=False)
        fwd.weights = torch.from_numpy(w.copy())
        gd.setup_forward(fwd)
        gd.initialize()
        gd.vel_weights = torch.from_numpy(vel.copy())
        if sq is not None:
            gd.sq_weights = torch.from_numpy(sq.copy())
        if acc is not None:
            gd.acc_weights = torch.from_numpy(acc.copy())
            gd.acc_count = torch.tensor(t % accumulate, dtype=torch.int32)
        gd.iteration = torch.tensor(t, dtype=torch.int32)
        gd.update_weights(torch.from_numpy(grad), None)
        want = _reference_step(solver, accumulate, w, vel, acc, sq, grad,
                               t, gd.hyperparams())
        got = [fwd.weights, gd.vel_weights, gd.acc_weights, gd.sq_weights]
        assert_close_rel(
            {"u": {str(i): v for i, v in enumerate(want) if v is not None}},
            {"u": {str(i): g.numpy() for i, (v, g) in
                   enumerate(zip(want, got)) if v is not None}}, STEP_RTOL)
        assert int(gd.iteration) == t + 1


def test_mnist_adam_steps_match_reference():
    """Three AdamW steps (decoupled decay, bias correction from step 1)
    from the same state: every weight, bias, first moment ``vel_*`` and
    second moment ``sq_*`` within STEP_RTOL of its largest element after
    each step."""
    jw, tw = mnist_pair(ADAM)
    for want, got in train_steps(jw, tw, 3):
        assert_close_rel(want, got, STEP_RTOL)
        assert "sq_weights" in got["GDTanh"] and \
            "acc_weights" not in got["GDTanh"]


def test_mnist_adam_epochs_match_reference():
    """Three AdamW epochs under a warmup-cosine schedule: per-epoch losses
    and every final tensor within EPOCHS_RTOL."""
    gd = dict(ADAM, lr_policy={"name": "warmup_cosine", "warmup": 4,
                               "total": 15})
    jw, tw = mnist_pair(gd, max_epochs=3)
    jw.run()
    tw.run()
    for j, t in zip(jw.decision.history, tw.decision.history):
        for cls in ("validation", "train"):
            assert abs(j[cls]["loss"] - t[cls]["loss"]) <= \
                EPOCHS_RTOL * abs(j[cls]["loss"])
    assert len(tw.decision.history) == 3
    assert_close_rel(jax_tree(jw), params_to_numpy(tw.export_tree()),
                     EPOCHS_RTOL)


@contextlib.contextmanager
def lm_train(**train):
    """The small LM of tests/test_torch_lm.py with ``root.lm.train``
    overridden in both packages (restored after, the added keys
    dropped)."""
    saved = [(r, r.lm.train.to_dict()) for r in (jroot, troot)]
    try:
        with lm_config(model={"attn_impl": None}):
            for r in (jroot, troot):
                r.lm.train.update(train)
            yield
    finally:
        for r, tree in saved:
            r.lm.train = tree


def test_lm_adam_step_and_epochs_match_reference():
    """The LM sample under AdamW and a warmup-cosine policy: one step from
    the same state within STEP_RTOL (every parameter, ``vel_*``, ``sq_*``
    of the attention, FFN, layernorm, embedding and output units), then
    three epochs within EPOCHS_RTOL."""
    train = dict(ADAM, learning_rate=0.01,
                 lr_policy={"name": "warmup_cosine", "warmup": 5,
                            "total": 24})
    with lm_train(**train):
        jw, tw = jax_lm(), torch_lm()
        tw.import_tree(params_from_jax(jax_tree(jw)))
        (want, got), = train_steps(jw, tw, 1)
        assert_close_rel(want, got, STEP_RTOL)
        assert {"sq_weights_out", "sq_bias_out"} <= set(
            got["GDMultiHeadAttention"])
        jw, tw = jax_lm(), torch_lm()
        jw.run()
        tw.run()
    for j, t in zip(jw.decision.history, tw.decision.history):
        assert abs(j["validation"]["loss"] - t["validation"]["loss"]) <= \
            EPOCHS_RTOL * j["validation"]["loss"]
    assert tw.decision.history[-1]["validation"]["loss"] < \
        tw.decision.history[0]["validation"]["loss"]
    assert_close_rel(jax_tree(jw), params_to_numpy(tw.export_tree()),
                     EPOCHS_RTOL)


#: the bf16 step's moments against the reference's largest element, as
#: tests/test_torch_mnist.py holds the momentum step's: both packages
#: multiply the same bf16-rounded inputs in f32 (observed 0 to 1e-7),
#: except GDTanh's weight gradient, where XLA on the CPU folds the bf16
#: rounding of dz into its product (the second moment squares it)
BF16_STEP_RTOL = 1e-5
BF16_DZ_FOLD_RTOL = 2e-2


def test_mnist_adam_step_bf16_policy():
    """One AdamW step under the card's dtype policy, held on the CPU: the
    first and second moments of each layer within the tolerances above,
    and the parameters whose gradients agree to BF16_STEP_RTOL (the
    softmax layer's, the tanh layer's bias) within STEP_RTOL."""
    from tests.test_torch_mnist import bf16_policy
    with bf16_policy():
        # the reference's bias gradient through its Pallas kernel (f32
        # products, as the port's kernel sums), as tests/test_torch_mnist.py
        jw, tw = mnist_pair(dict(ADAM, fused_bias_grad=True))
        assert tw.device.compute_dtype == torch.bfloat16
        (want, got), = train_steps(jw, tw, 1)
    for unit, key, rtol in (
            ("GDSoftmax", "vel_weights", BF16_STEP_RTOL),
            ("GDSoftmax", "sq_weights", BF16_STEP_RTOL),
            ("GDSoftmax", "vel_bias", BF16_STEP_RTOL),
            ("GDTanh", "vel_bias", BF16_STEP_RTOL),
            ("GDTanh", "sq_bias", BF16_STEP_RTOL),
            ("GDTanh", "vel_weights", BF16_DZ_FOLD_RTOL),
            ("GDTanh", "sq_weights", BF16_DZ_FOLD_RTOL)):
        w = want[unit][key].astype(numpy.float64)
        share = numpy.abs(got[unit][key] - w).max() / numpy.abs(w).max()
        assert share <= rtol, (unit, key, share)
    for fwd, key in (("All2AllSoftmax", "weights"),
                     ("All2AllSoftmax", "bias"), ("All2AllTanh", "bias")):
        w = want[fwd][key].astype(numpy.float64)
        share = numpy.abs(got[fwd][key] - w).max() / numpy.abs(w).max()
        assert share <= STEP_RTOL, (fwd, key, share)


# -- gradient accumulation --------------------------------------------------


@pytest.mark.parametrize("solver", ["momentum", "adam"])
@pytest.mark.parametrize("n", [2, 3])
def test_mnist_accumulation_matches_reference(solver, n):
    """``accumulate_gradient = n``: n + 2 steps from the same state, each
    within STEP_RTOL of the reference (``acc_*`` the grown sum,
    ``acc_count``, ``vel_*``, ``sq_*``); the weights, ``vel_*`` and
    ``sq_*`` move only on every n-th step, where ``acc_*`` returns to
    zero."""
    gd = dict(ADAM if solver == "adam" else {"gradient_moment": 0.5},
              accumulate_gradient=n)
    jw, tw = mnist_pair(gd)
    before = params_to_numpy(tw.export_tree())
    for i, (want, got) in enumerate(train_steps(jw, tw, n + 2)):
        # acc_* sums up to n gradients, each with its own order error
        assert_close_rel(want, got, n * STEP_RTOL)
        applied = (i + 1) % n == 0
        for gdn, fwd in (("GDTanh", "All2AllTanh"),
                         ("GDSoftmax", "All2AllSoftmax")):
            assert int(got[gdn]["acc_count"]) == (i + 1) % n
            assert int(got[gdn]["iteration"]) == i + 1
            for key in ("weights", "bias"):
                moved = not numpy.array_equal(got[fwd][key],
                                              before[fwd][key])
                assert moved == applied, (i, fwd, key)
                for state in ("vel_", "sq_") if solver == "adam" \
                        else ("vel_",):
                    moved = not numpy.array_equal(
                        got[gdn][state + key], before[gdn][state + key])
                    assert moved == applied, (i, gdn, state + key)
                assert bool(numpy.any(got[gdn]["acc_" + key])) \
                    != applied, (i, gdn, key)
        before = got


# -- lr policy and lr_scale -------------------------------------------------


def test_lr_scale_applies_after_the_policy():
    """An ``arbitrary_step`` policy replaces the base rate; ``lr_scale =
    0.5`` must still halve the step. Two steps (one on each side of the
    schedule's boundary) within STEP_RTOL of the reference, and the port's
    first update is half the unscaled one."""
    policy = {"name": "arbitrary_step", "schedule": [(0.1, 1), (0.04, 5)]}
    jw, tw = mnist_pair({"lr_policy": policy})
    for gd in jw.gds + tw.gds:
        gd.lr_scale = 0.5
    steps = train_steps(jw, tw, 2)
    for want, got in steps:
        assert_close_rel(want, got, STEP_RTOL)
    jw2, tw2 = mnist_pair({"lr_policy": policy})
    (_, full), = train_steps(jw2, tw2, 1)
    for gd in ("GDSoftmax", "GDTanh"):
        # from zero momentum vel = -lr·grad, and 0.05 is 0.1 halved
        half = steps[0][1][gd]["vel_weights"]
        assert numpy.array_equal(half, 0.5 * full[gd]["vel_weights"])


def test_link_lr_adjuster_matches_reference():
    """``link_lr_adjuster`` gives every GD unit the policy (and the bias
    policy); one epoch of momentum steps under a step policy on both
    packages agrees within STEP_RTOL·5."""
    weights = {"name": "step", "gamma": 0.5, "step": 2}
    bias = {"name": "exp", "gamma": 0.9}
    linked = []
    jw, tw = mnist_pair({"gradient_moment": 0.5}, before_init=lambda wf:
                        linked.append(wf.link_lr_adjuster(weights, bias)))
    assert linked[1] is tw.gds
    for gd in tw.gds:
        assert isinstance(gd.lr_policy, TLR.StepPolicy)
        assert isinstance(gd.lr_policy_bias, TLR.ExpPolicy)
    for want, got in train_steps(jw, tw, 5):
        assert_close_rel(want, got, 5 * STEP_RTOL)
    tw.link_lr_adjuster(weights)
    assert all(isinstance(gd.lr_policy_bias, TLR.StepPolicy)
               for gd in tw.gds)


# -- EXTRA_PARAMS under adam and accumulation -------------------------------

EXTRA_CASES = [
    ("ffn", JA.TransformerFFN, TA.TransformerFFN, {"hidden": 16},
     ("weights2",), ("bias2",)),
    ("mha", JA.MultiHeadAttention, TA.MultiHeadAttention, {"heads": 2},
     ("weights_out",), ("bias_out",)),
    ("moe", JM.MoEFFN, TM.MoEFFN, {"experts": 2, "hidden": 8},
     ("weights2", "router"), ("bias2",)),
]


def traced_steps(comp, feed, fwd, gd, x, errs):
    """The reference's traced forward + GD over ``errs``, one step each,
    -> [(params, state)] after each."""
    def fn(p, s, xv, ev):
        ctx = FlowContext(comp, dict(p), dict(s),
                          {gd.name: gd.hyperparams()},
                          jax.random.PRNGKey(7), True)
        ctx.set(feed, "minibatch_data", xv)
        fwd.xla_run(ctx)
        ctx.set(gd, "err_output", ev)
        gd.xla_run(ctx)
        return ctx.params, ctx.state

    step = jax.jit(fn)
    p, s = comp.gather_params(), comp.gather_state()
    out = []
    for e in errs:
        p, s = step(p, s, x, e)
        out.append((p, s))
    return out


@pytest.mark.parametrize("case", EXTRA_CASES, ids=[c[0] for c in
                                                   EXTRA_CASES])
def test_extra_params_adam_accumulation_match_reference(case):
    """A unit with parameters beyond weights/bias under AdamW with decay
    and ``accumulate_gradient = 2``: after the first step no parameter
    moves and every ``acc_*`` holds its gradient; after the second every
    parameter (the weight-like extras decayed under the weight set, the
    bias-like ones under the bias set), ``vel_*``, ``sq_*`` and ``acc_*``
    (zeroed) agree with the reference's traced update within STEP_RTOL."""
    _, jcls, tcls, kwargs, wlike, blike = case
    gd_kwargs = dict(solver="adam", accumulate_gradient=2,
                     learning_rate=0.001, weights_decay=0.2,
                     gradient_moment=0.9, adam_beta2=0.99, adam_eps=0.1)
    wf, feed, jf, jg, x, err, comp = build(
        jcls, input_shape=(2, 4, 8), gd_kwargs=gd_kwargs, **kwargs)
    err2 = jprng.get("cs").normal(0, 1.0, err.shape)
    errs = [err.astype(numpy.float32), err2.astype(numpy.float32)]
    p0 = comp.gather_params()[jf.name]
    traced = traced_steps(comp, feed, jf, jg, x.astype(numpy.float32), errs)

    fwd = tcls(**kwargs)
    fwd.initialize(x.shape, TorchDevice("cpu"))
    for key, value in p0.items():
        setattr(fwd, key, torch.from_numpy(numpy.array(value)))
    gd = gradient_unit_for(tcls)(**gd_kwargs)
    gd.setup_forward(fwd)
    gd.initialize()
    xt = torch.from_numpy(x.astype(numpy.float32))
    for i, e in enumerate(errs):
        y = fwd(xt)
        gd.run(xt, y, torch.from_numpy(e))
        got = {**{k: getattr(fwd, k) for k in fwd.PARAMS},
               **gd.export_state()}
        p, s = traced[i]
        want = {k: numpy.array(v) for k, v in
                {**p[jf.name], **s[jg.name]}.items()}
        got = params_to_numpy({"x": got})["x"]
        assert sorted(want) == sorted(got)
        if tcls is TA.MultiHeadAttention:
            # the key bias has a zero gradient in exact arithmetic (the
            # softmax drops a per-query constant): each package moves it
            # by its own rounding noise: gradients of 3e-8 against the
            # others' O(1); the rest of the tensor is held below
            keys = slice(8, 16)
            for k in ("bias", "vel_bias", "sq_bias", "acc_bias"):
                assert numpy.abs(got[k][keys] - want[k][keys]).max() \
                    <= 1e-7, k
                got[k][keys] = want[k][keys] = 0
        assert_close_rel({"u": want}, {"u": got}, STEP_RTOL)
        for key in fwd.PARAMS:
            moved = not numpy.array_equal(getattr(fwd, key).numpy(),
                                          p0[key])
            assert moved == (i == 1), (i, key)
        assert int(gd.acc_count) == (i + 1) % 2
    assert set(wlike + blike) <= {p for p, _ in gd.EXTRA_PARAMS}
