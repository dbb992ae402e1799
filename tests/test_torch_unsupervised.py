"""The port's unsupervised path (veles_torch/znicz/ops/kohonen.py,
ops/rbm.py, models/kohonen.py, models/mnist_rbm.py, the step body of
znicz/step.py) against the JAX package on the CPU: the Kohonen forward
and one trainer step against the reference's traced ``xla_run``, the
reference test's 10-epoch run epoch by epoch; the RBM's units one by one
against the reference's ``numpy_run`` with the same uniforms injected, a
whole RBM run at the reference's own cross-backend thresholds (its
Binarization draws ``jax.random`` numbers the port cannot reproduce);
both workflows' checkpoints resumed by either package; the model-health
plane on both paths (no layer stats: neither trainer is a
``GradientDescentBase``; the decision's losses as the reference's
monitor sees them)."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

import veles.model_health as JMH
import veles.prng as jprng
import veles.snapshotter as JS
from veles.accelerated_units import FlowContext, StepCompiler
from veles.backends import XLADevice
from veles.config import root as jroot
from veles.workflow import Workflow
from veles.znicz_tpu.models import kohonen as jkoh
from veles.znicz_tpu.models import mnist_rbm as jrbm
from veles.znicz_tpu.ops import all2all as JA
from veles.znicz_tpu.ops import kohonen as JK
from veles.znicz_tpu.ops import rbm as JR
import veles_torch.model_health as TMH
import veles_torch.prng as tprng
import veles_torch.snapshotter as TS
from veles_torch.__main__ import main as torch_main
from veles_torch.backends import TorchDevice
from veles_torch.config import root as troot
from veles_torch.znicz.models import kohonen as tkoh
from veles_torch.znicz.models import mnist_rbm as trbm
from veles_torch.znicz.ops import all2all as TA
from veles_torch.znicz.ops import kohonen as TK
from veles_torch.znicz.ops import rbm as TR

from tests.test_all2all import FeedUnit
from tests.test_torch_model_health import (
    JaxRecording, TorchRecording, assert_docs_equal)
from tests.torch_monitor import port_model_health_isolation  # noqa: F401
from tests.torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "veles_torch", "znicz", "models")
#: one Kohonen step and the forward's distances: f32 products and sums
#: in another order than XLA's, held to this share of the tensor's
#: largest element (observed: below 2e-7)
KOHONEN_ATOL = 1e-6
#: the reference test's 10-epoch run (tests/test_unsupervised.py): the
#: final weights to this share of their largest element, each epoch's
#: train metric to this relative error (observed: 1.5e-7 and 1.3e-7; no
#: winner flips between the packages over the 120 steps)
KOHONEN_RUN_ATOL = 1e-6
KOHONEN_RUN_RTOL = 1e-6
#: the RBM units against the reference's numpy_run: f32 products
RBM_ATOL = 1e-6
#: the reference's own thresholds for a whole RBM run
#: (tests/test_unsupervised.py): the validation error falls by 13%, and
#: the two backends' last errors agree within 35%
RBM_FALL = 0.87
RBM_CROSS_RTOL = 0.35


@pytest.fixture
def unsupervised_config():
    """Each test sets both packages' root.kohonen / root.mnist_rbm; the
    values are put back after it."""
    saved = [(r, name, getattr(r, name).to_dict())
             for r in (jroot, troot) for name in ("kohonen", "mnist_rbm")]
    yield
    for r, name, tree in saved:
        getattr(r, name).update(tree)


def configure(**sections):
    """Set ``root.<sample>.<section>.<key>`` in both packages."""
    for r in (jroot, troot):
        for sample, tree in sections.items():
            getattr(r, sample).update(tree)


def seed(n):
    jprng.seed_all(n)
    tprng.seed_all(n)


def close(got, want, atol_share, what):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    assert got.shape == want.shape, what
    diff = numpy.abs(got - want).max(initial=0.0)
    limit = atol_share * max(numpy.abs(want).max(initial=0.0), 1e-30)
    assert diff <= limit, (what, diff, limit)


# -- the Kohonen units ------------------------------------------------------


def kohonen_inputs(batch, fan_in, grid, seed_=5):
    rng = numpy.random.default_rng(seed_)
    x = rng.normal(0.0, 1.0, (batch, fan_in)).astype(numpy.float32)
    w = rng.uniform(-1.0, 1.0, (int(numpy.prod(grid)), fan_in)) \
        .astype(numpy.float32)
    return x, w


def jax_kohonen(x, w, grid, **trainer):
    """The reference's forward and trainer on ``x`` with weights ``w``,
    and their StepCompiler."""
    wf = Workflow(None, name="wf")
    feed = FeedUnit(wf, x)
    fwd = JK.KohonenForward(wf, name="kf", shape=grid)
    fwd.link_attrs(feed, ("input", "minibatch_data"))
    fwd.initialize(device=None)
    fwd.weights.mem[...] = w
    kt = JK.KohonenTrainer(wf, name="kt", **trainer).setup_forward(fwd)
    kt.batch_size = len(x)
    kt.initialize(device=None)
    comp = StepCompiler([fwd, kt], XLADevice(platform="cpu"))
    return feed, fwd, kt, comp


def torch_kohonen(x, w, grid, **trainer):
    fwd = TK.KohonenForward(name="kf", shape=grid)
    fwd.initialize(x.shape, TorchDevice("cpu"))
    fwd.weights = torch.as_tensor(w)
    kt = TK.KohonenTrainer(name="kt", **trainer).setup_forward(fwd)
    kt.initialize()
    return fwd, kt


@pytest.mark.parametrize("grid,fan_in", [((8, 8), 2), ((4, 5), 7)])
def test_kohonen_forward_matches_reference(grid, fan_in):
    """Distances and winners against the reference's traced xla_run and
    its numpy_run."""
    x, w = kohonen_inputs(50, fan_in, grid)
    feed, jf, _, comp = jax_kohonen(x, w, grid)

    def fn(weights, xv):
        ctx = FlowContext(comp, {"kf": {"weights": weights}}, {}, {},
                          jax.random.PRNGKey(0), False)
        ctx.set(feed, "minibatch_data", xv)
        jf.xla_run(ctx)
        return ctx.get(jf, "distances"), ctx.get(jf, "output")

    want_d, want_bmu = jax.jit(fn)(w, x)
    jf.numpy_run()
    tf, _ = torch_kohonen(x, w, grid)
    got_bmu = tf(torch.as_tensor(x))
    close(tf.distances, want_d, KOHONEN_ATOL, "distances")
    close(tf.distances, jf.distances.mem, KOHONEN_ATOL, "numpy distances")
    assert got_bmu.dtype == torch.int32
    assert numpy.array_equal(got_bmu.numpy(), numpy.asarray(want_bmu))
    assert numpy.array_equal(got_bmu.numpy(), jf.output.mem)


@pytest.mark.parametrize("valid,t", [(10, 0.0), (7, 150.0), (10, 250.0)])
def test_kohonen_trainer_step_matches_reference(valid, t):
    """One step at ``time_step`` t (before, inside and past the decay)
    with ``valid`` of 10 rows: the weights within KOHONEN_ATOL of the
    largest, ``weight_delta`` likewise, ``time_step`` equal."""
    grid = (4, 5)
    x, w = kohonen_inputs(10, 3, grid)
    trainer = {"alpha": 0.5, "alpha_min": 0.01, "radius_min": 1.0,
               "decay_steps": 200.0}
    feed, jf, jt, comp = jax_kohonen(x, w, grid, **trainer)

    def fn(weights, ts, xv, n):
        ctx = FlowContext(comp, {"kf": {"weights": weights}},
                          {"kt": {"time_step": ts}}, {},
                          jax.random.PRNGKey(0), True)
        ctx.set(feed, "minibatch_data", xv)
        ctx.set(jt, "batch_size", n)
        jt.xla_run(ctx)
        return (ctx.params["kf"]["weights"], ctx.state["kt"]["time_step"],
                ctx.outputs["weight_delta"])

    want_w, want_t, want_delta = jax.jit(fn)(
        w, jnp.float32(t), x, jnp.int32(valid))
    tf, tt = torch_kohonen(x, w, grid, **trainer)
    tt.time_step = torch.tensor(t, dtype=torch.float32)
    delta = tt.run(torch.as_tensor(x), torch.tensor(valid))
    assert tt.radius == jt.radius == 2.5
    close(tf.weights, want_w, KOHONEN_ATOL, "weights")
    close(delta, want_delta, KOHONEN_ATOL, "weight_delta")
    assert tt.time_step.dtype == torch.float32
    assert float(tt.time_step) == float(want_t) == t + 1.0


def jax_kohonen_run(max_epochs, n_samples, name="Koh"):
    configure(kohonen={"decision": {"max_epochs": max_epochs},
                       "loader": {"n_samples": n_samples}})
    jprng.seed_all(77)
    wf = jkoh.create_workflow(name=name)
    wf.initialize(device="cpu")
    return wf


def torch_kohonen_run(max_epochs, n_samples, name="Koh"):
    configure(kohonen={"decision": {"max_epochs": max_epochs},
                       "loader": {"n_samples": n_samples}})
    tprng.seed_all(77)
    return tkoh.create_workflow(name=name).initialize(device="cpu")


def quantization_error(x, w):
    d = ((x[:, None, :] - w[None, :, :]) ** 2).sum(axis=-1)
    return float(numpy.sqrt(d.min(axis=1)).mean())


def test_kohonen_run_matches_reference(unsupervised_config):
    """The reference test's run (seed 77, 600 points, 10 epochs) on both
    packages: the same points bit for bit, every epoch's train metric
    within KOHONEN_RUN_RTOL and its loss 0 (the trainer exports none), the
    final weights within KOHONEN_RUN_ATOL of their largest, and the map
    converged as the reference test requires (quantization error
    < 0.3)."""
    jw = jax_kohonen_run(10, 600)
    jw.run()
    tw = torch_kohonen_run(10, 600)
    tw.run()
    x = jw.loader.original_data.mem
    assert numpy.array_equal(tw.loader.original_data, x)
    jh, th = jw.decision.history, tw.decision.history
    assert len(jh) == len(th) == 10
    for want, got in zip(jh, th):
        assert sorted(got) == sorted(want) == ["epoch", "train"]
        assert got["train"]["loss"] == want["train"]["loss"] == 0.0
        assert got["train"]["samples"] == want["train"]["samples"] == 600
        assert abs(got["train"]["metric"] - want["train"]["metric"]) \
            <= KOHONEN_RUN_RTOL * want["train"]["metric"]
    want_w = jw.forwards[0].weights.map_read().mem
    got_w = tw.forwards[0].weights.numpy()
    close(got_w, want_w, KOHONEN_RUN_ATOL, "final weights")
    assert float(tw.trainer.time_step) == 120.0
    assert quantization_error(x, got_w) < 0.3
    assert th[-1]["train"]["metric"] < th[0]["train"]["metric"]


# -- the RBM units ----------------------------------------------------------


class _Uniforms:
    """Stands in for a Binarization's generator: hands out ``u``."""

    def __init__(self, u):
        self.u = u

    def random_sample(self, shape):
        assert tuple(shape) == self.u.shape
        return self.u


@pytest.fixture(scope="module")
def rbm_chain():
    """The reference's CD-1 chain (6 valid rows of 8, 12 visible, 5
    hidden) run once by numpy_run with injected uniforms and nonzero
    biases: {name: unit}, plus the inputs."""
    rng = numpy.random.default_rng(9)
    v = rng.random((8, 12)).astype(numpy.float32)
    u = rng.random((8, 5))
    wf = Workflow(None, name="wf")
    feed = FeedUnit(wf, v)
    jprng.seed_all(3)
    h_pos = JA.All2AllSigmoid(wf, name="h_pos", output_sample_shape=5,
                              weights_stddev=0.5)
    h_pos.link_attrs(feed, ("input", "minibatch_data"))
    h_pos.initialize(device=None)
    h_pos.bias.mem[...] = rng.normal(0.0, 0.3, 5)
    h_pos.numpy_run()
    binarize = JR.Binarization(wf, name="binarize")
    binarize.link_attrs(h_pos, ("input", "output"))
    binarize.initialize(device=None)
    binarize.rand = _Uniforms(u)
    binarize.numpy_run()
    v_neg = JR.TiedAll2AllSigmoid(wf, name="v_neg", weights_source=h_pos,
                                  transposed=True, output_sample_shape=12)
    v_neg.link_attrs(binarize, ("input", "output"))
    v_neg.initialize(device=None)
    v_neg.bias.mem[...] = rng.normal(0.0, 0.3, 12)
    v_neg.numpy_run()
    h_neg = JR.TiedAll2AllSigmoid(wf, name="h_neg", weights_source=h_pos,
                                  bias_source=h_pos, output_sample_shape=5)
    h_neg.link_attrs(v_neg, ("input", "output"))
    h_neg.initialize(device=None)
    h_neg.numpy_run()
    stats = {}
    for name, (vsrc, hsrc) in (("pos_stats", ((feed, "minibatch_data"),
                                               (h_pos, "output"))),
                               ("neg_stats", ((v_neg, "output"),
                                              (h_neg, "output")))):
        bw = JR.BatchWeights(wf, name=name)
        bw.link_attrs(vsrc[0], ("v", vsrc[1]))
        bw.link_attrs(hsrc[0], ("h", hsrc[1]))
        bw.batch_size = 6
        bw.initialize(device=None)
        bw.numpy_run()
        stats[name] = bw
    evaluator = JR.EvaluatorRBM(wf, name="evaluator")
    evaluator.link_attrs(feed, ("v", "minibatch_data"))
    evaluator.link_attrs(v_neg, ("v_neg", "output"))
    evaluator.batch_size = 6
    evaluator.numpy_run()
    before = {"w": h_pos.weights.mem.copy(), "hb": h_pos.bias.mem.copy(),
              "vb": v_neg.bias.mem.copy()}
    grad = JR.GradientRBM(wf, name="gradient_rbm", learning_rate=0.05)
    grad.hidden_layer, grad.visible_layer = h_pos, v_neg
    grad.pos_stats, grad.neg_stats = stats["pos_stats"], stats["neg_stats"]
    grad.numpy_run()
    return dict(v=v, u=u, before=before, h_pos=h_pos, binarize=binarize,
                v_neg=v_neg, h_neg=h_neg, evaluator=evaluator, **stats)


def port_layers(before):
    """The port's h_pos and v_neg holding the reference's parameters as
    they were before the update."""
    dev = TorchDevice("cpu")
    h_pos = TA.All2AllSigmoid(name="h_pos", output_sample_shape=5)
    h_pos.initialize((8, 12), dev)
    h_pos.weights = torch.as_tensor(before["w"])
    h_pos.bias = torch.as_tensor(before["hb"])
    v_neg = TR.TiedAll2AllSigmoid(name="v_neg", weights_source=h_pos,
                                  transposed=True, output_sample_shape=12)
    v_neg.initialize((8, 5), dev)
    v_neg.bias = torch.as_tensor(before["vb"])
    return dev, h_pos, v_neg


def mem(unit, attr="output"):
    return torch.as_tensor(getattr(unit, attr).mem)


def test_rbm_binarization_matches_reference(rbm_chain):
    """``u < p`` on the reference's probabilities and injected uniforms
    (float64, as its numpy_run draws them), bit for bit."""
    c = rbm_chain
    got = TR.Binarization.sample(mem(c["h_pos"]), torch.as_tensor(c["u"]))
    assert got.dtype == torch.float32
    assert numpy.array_equal(got.numpy(), c["binarize"].output.mem)
    assert 0 < got.sum() < got.numel()


@pytest.mark.parametrize("which", ["v_neg", "h_neg"])
def test_rbm_tied_layer_matches_reference(rbm_chain, which):
    """The tied layers on the reference's inputs: v_neg reads h_pos's
    weights transposed and owns its bias; h_neg reads h_pos's weights and
    bias and owns no parameter."""
    c = rbm_chain
    _, h_pos, v_neg = port_layers(c["before"])
    if which == "v_neg":
        unit, x = v_neg, mem(c["binarize"])
        assert sorted(unit.export_params()) == ["bias"]
    else:
        unit = TR.TiedAll2AllSigmoid(name="h_neg", weights_source=h_pos,
                                     bias_source=h_pos,
                                     output_sample_shape=5)
        unit.initialize((8, 12), h_pos.device)
        x = mem(c["v_neg"])
        assert unit.export_params() == {} and unit.bias is None
    got = unit(x)
    assert got.dtype == torch.float32
    close(got, c[which].output.mem, RBM_ATOL, which)


@pytest.mark.parametrize("which", ["pos_stats", "neg_stats"])
def test_rbm_batch_weights_match_reference(rbm_chain, which):
    """vᵀh/n, Σv/n and Σh/n over the 6 valid of 8 rows."""
    c = rbm_chain
    ref = c[which]
    v = mem(ref, "v") if which == "neg_stats" else torch.as_tensor(c["v"])
    h = mem(ref, "h")
    bw = TR.BatchWeights(name=which)
    got = bw(v, h, torch.tensor(6))
    for value, attr in zip(got, ("vh", "v_sum", "h_sum")):
        close(value, getattr(ref, attr).mem, RBM_ATOL, attr)


def test_rbm_gradient_and_evaluator_match_reference(rbm_chain):
    """One GradientRBM update from the reference's statistics moves the
    one W, the hidden bias and the visible bias as the reference's; the
    evaluator's masked MSE equals the reference's (metrics row (mse, 0,
    0, 0))."""
    c = rbm_chain
    _, h_pos, v_neg = port_layers(c["before"])
    grad = TR.GradientRBM(learning_rate=0.05)
    grad.hidden_layer, grad.visible_layer = h_pos, v_neg
    pos = tuple(mem(c["pos_stats"], a) for a in ("vh", "v_sum", "h_sum"))
    neg = tuple(mem(c["neg_stats"], a) for a in ("vh", "v_sum", "h_sum"))
    grad.run(pos, neg)
    close(h_pos.weights, c["h_pos"].weights.mem, RBM_ATOL, "W")
    close(h_pos.bias, c["h_pos"].bias.mem, RBM_ATOL, "hidden bias")
    close(v_neg.bias, c["v_neg"].bias.mem, RBM_ATOL, "visible bias")
    row = TR.EvaluatorRBM().run(torch.as_tensor(c["v"]), mem(c["v_neg"]),
                                torch.tensor(6))
    assert row[1:].tolist() == [0.0, 0.0, 0.0]
    assert abs(float(row[0]) - c["evaluator"].mse) <= 1e-6 * c["evaluator"].mse


# -- the RBM run ------------------------------------------------------------


def rbm_config(max_epochs=6):
    configure(mnist_rbm={"loader": {"n_train": 800, "n_valid": 200},
                         "decision": {"max_epochs": max_epochs}})


def valid_metrics(wf):
    return [h["validation"]["metric"] for h in wf.decision.history]


def test_rbm_run_matches_reference_statistically(unsupervised_config):
    """The reference test's run (seed 88, 800/200, 6 epochs): the port's
    initial weights equal the reference's; its validation error falls by
    RBM_FALL and ends within RBM_CROSS_RTOL of the reference's traced
    run's, the reference's own bounds between its two backends."""
    rbm_config()
    jprng.seed_all(88)
    jw = jrbm.create_workflow(name="RBM")
    jw.initialize(device="cpu")
    w0 = jw.forwards[0].weights.map_read().mem.copy()
    jw.run()
    tprng.seed_all(88)
    tw = trbm.create_workflow(name="RBM").initialize(device="cpu")
    assert numpy.array_equal(tw.h_pos.weights.numpy(), w0)
    assert tw.v_neg.neurons == 784
    tw.run()
    want, got = valid_metrics(jw), valid_metrics(tw)
    assert len(got) == len(want) == 6
    assert got[-1] < got[0] * RBM_FALL, got
    assert abs(got[-1] - want[-1]) / want[-1] < RBM_CROSS_RTOL, (want, got)
    assert tw.step.train_steps == 6 * 8 and tw.step.eval_steps == 6 * 2


# -- checkpoints ------------------------------------------------------------


def build(package, sample, max_epochs, name):
    """A fresh initialized workflow of ``sample`` in ``package`` at the
    tests' small size and seed."""
    if sample == "kohonen":
        make = jax_kohonen_run if package == "reference" \
            else torch_kohonen_run
        return make(max_epochs, 300, name=name)
    rbm_config(max_epochs)
    if package == "reference":
        jprng.seed_all(88)
        wf = jrbm.create_workflow(name=name)
        wf.initialize(device="cpu")
        return wf
    tprng.seed_all(88)
    return trbm.create_workflow(name=name).initialize(device="cpu")


def flat_keys(tree, sections=("params", "state")):
    return sorted("%s/%s/%s" % (s, u, k) for s in sections
                  for u, sub in tree.get(s, {}).items() for k in sub)


LAYOUT = {
    "kohonen": ["params/kohonen_forward/weights",
                "state/kohonen_trainer/time_step"],
    "mnist_rbm": ["params/h_pos/bias", "params/h_pos/weights",
                  "params/v_neg/bias"],
}


def param_arrays(package, wf):
    if package == "reference":
        return {k: numpy.asarray(v) for u in wf._stateful_units()
                for k, v in ((u.name + "/" + n, getattr(u, n).map_read().mem)
                             for n in u.PARAMS + u.STATE)}
    tree = wf.export_tree()
    return {u + "/" + k: v.cpu().numpy() for u, sub in tree.items()
            for k, v in sub.items()}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("sample", ["kohonen", "mnist_rbm"])
def test_checkpoint_resumes_across_packages(unsupervised_config, tmp_path,
                                            sample, writer):
    """The writer trains 2 epochs and writes its checkpoint (the
    reference's layout: the forwards' params and the trainers' state
    that exist, ``LAYOUT``); each package restores it into a fresh
    workflow, holds every array of it bit for bit and trains a third
    epoch. Kohonen's resumed runs agree within KOHONEN_RUN_ATOL; the
    RBM's finish their epoch with the restored history."""
    wf = build(writer, sample, 2, "W")
    wf.run()
    tree = wf.checkpoint_state()
    assert flat_keys(tree) == LAYOUT[sample]
    mod = JS if writer == "reference" else TS
    uri, _ = mod.write_checkpoint(mod.FileSnapshotStore(str(tmp_path)),
                                  "w_initial.ckpt.npz", tree,
                                  compression="")
    saved = param_arrays(writer, wf)
    resumed = {}
    for package, load in (("reference", JS.load_snapshot),
                          ("port", TS.load_snapshot)):
        fresh = build(package, sample, 3, "W")
        fresh.restore_state(load(uri))
        got = param_arrays(package, fresh)
        assert sorted(got) == sorted(saved)
        for key, value in saved.items():
            assert numpy.array_equal(got[key], value), (package, key)
        fresh.run()
        assert len(fresh.decision.history) == 3
        resumed[package] = fresh
    if sample == "kohonen":
        close(resumed["port"].forwards[0].weights.numpy(),
              resumed["reference"].forwards[0].weights.map_read().mem,
              KOHONEN_RUN_ATOL, "resumed weights")
    else:
        want, got = (valid_metrics(resumed[p])
                     for p in ("reference", "port"))
        assert got[:2] == want[:2]
        assert abs(got[-1] - want[-1]) / want[-1] < RBM_CROSS_RTOL


SIZES = {"kohonen": ["root.kohonen.loader.n_samples=300"],
         "mnist_rbm": ["root.mnist_rbm.loader.n_train=800",
                       "root.mnist_rbm.loader.n_valid=200"]}
SEEDS = {"kohonen": 77, "mnist_rbm": 88}


@pytest.mark.parametrize("sample", ["kohonen", "mnist_rbm"])
def test_cli_resumes_reference_checkpoint(unsupervised_config, tmp_path,
                                          sample):
    """The port's CLI resumes the reference's 2-epoch checkpoint with
    ``--snapshot FILE`` (its history carried over, one more epoch), and
    its own with ``--snapshots DIR --snapshot auto``."""
    ref = build("reference", sample, 2, "W")
    ref.run()
    uri, _ = JS.write_checkpoint(JS.FileSnapshotStore(str(tmp_path)),
                                 "ref_initial.ckpt.npz",
                                 ref.checkpoint_state(), compression="")
    base = [os.path.join(MODELS, sample + ".py"), *SIZES[sample], "-d",
            "cpu", "--seed", str(SEEDS[sample])]
    wf = torch_main(base + ["--snapshot", uri,
                            "root.%s.decision.max_epochs=3" % sample])
    assert wf.decision.history[:2] == ref.decision.history
    assert len(wf.decision.history) == 3
    snaps = str(tmp_path / "snaps")
    torch_main(base + ["--snapshots", snaps,
                       "root.%s.decision.max_epochs=2" % sample])
    again = torch_main(base + ["--snapshots", snaps, "--snapshot", "auto",
                               "root.%s.decision.max_epochs=3" % sample])
    assert len(again.decision.history) == 3


def test_rbm_resume_equals_uninterrupted(unsupervised_config, tmp_path):
    """The port's RBM resumed from its epoch-2 checkpoint (the
    binarization generator's state in its ``units`` section) equals the
    uninterrupted 3-epoch run bit for bit."""
    whole = build("port", "mnist_rbm", 3, "R")
    whole.run()
    first = build("port", "mnist_rbm", 2, "R")
    first.run()
    tree = first.checkpoint_state()
    assert sorted(tree["units"]) == ["binarize"]
    uri, _ = TS.write_checkpoint(TS.FileSnapshotStore(str(tmp_path)),
                                 "r_initial.ckpt.npz", tree, compression="")
    resumed = build("port", "mnist_rbm", 3, "R")
    resumed.restore_state(TS.load_snapshot(uri))
    resumed.run()
    assert resumed.decision.history == whole.decision.history
    for a, b in ((resumed.h_pos, whole.h_pos), (resumed.v_neg, whole.v_neg)):
        for key, value in a.export_params().items():
            assert torch.equal(value, b.export_params()[key]), key


def test_rbm_resumes_another_devices_generator_state(
        unsupervised_config, tmp_path, caplog):
    """A checkpoint written on another device carries the Binarization
    generator's state of that device (a card's is 16 bytes, the CPU's
    5056): the restore loads everything else, warns, and the generator
    goes on from its own state; the run trains on."""
    wf = build("port", "mnist_rbm", 1, "G")
    wf.run()
    tree = wf.checkpoint_state()
    tree["units"]["binarize"]["generator"] = numpy.arange(16, dtype=numpy.uint8)
    uri, _ = TS.write_checkpoint(TS.FileSnapshotStore(str(tmp_path)),
                                 "g_initial.ckpt.npz", tree, compression="")
    fresh = build("port", "mnist_rbm", 2, "G")
    own = fresh.binarize.generator.get_state()
    logger = logging.getLogger("veles_torch")
    propagate, logger.propagate = logger.propagate, True
    try:
        with caplog.at_level(logging.WARNING, logger="veles_torch.prng"):
            fresh.restore_state(TS.load_snapshot(uri))
    finally:
        logger.propagate = propagate
    assert "does not fit this cpu generator" in caplog.text
    assert torch.equal(fresh.binarize.generator.get_state(), own)
    assert numpy.array_equal(fresh.h_pos.weights.numpy(),
                             tree["params"]["h_pos"]["weights"])
    fresh.run()
    assert len(fresh.decision.history) == 2


# -- the model-health plane and the CLI --------------------------------------


@pytest.mark.parametrize("sample", ["kohonen", "mnist_rbm"])
def test_cli_model_stats_see_no_layers(unsupervised_config, sample):
    """``python -m veles_torch <sample> -d cpu --model-stats on
    --stats-interval 1`` (the acceptance command, at the tests' size):
    no stat row and no error, as on the reference's traced path (same
    size, seed and stride), whose monitor also sees no layer; the
    decision's losses reach the monitor, for Kohonen equal to the
    reference's (0, the trainer exports none), for the RBM one an
    epoch, healthy."""
    if sample == "kohonen":
        overrides = ["root.kohonen.decision.max_epochs=4",
                     "root.kohonen.loader.n_samples=300"]
    else:
        overrides = ["root.mnist_rbm.decision.max_epochs=3",
                     "root.mnist_rbm.loader.n_train=400",
                     "root.mnist_rbm.loader.n_valid=100"]
    with JMH.scoped(JaxRecording()) as jm:
        for o in overrides:
            jroot.apply_override(o)
        jprng.seed_all(21)
        mod = jkoh if sample == "kohonen" else jrbm
        jw = mod.create_workflow(name="S")
        jw.initialize(device="cpu")
        jw.xla_step.stats_interval = jw.xla_step.compiler.stats_stride = 1
        jw.run()
    with TMH.scoped(TorchRecording()) as tm:
        tw = torch_main([os.path.join(MODELS, sample + ".py"), *overrides,
                         "-d", "cpu", "--seed", "21", "--model-stats", "on",
                         "--stats-interval", "1"])
    assert tw.step.stat_units == [] and tw.step.train_steps > 0
    assert jm.seen == [] and tm.seen == []
    jdoc, tdoc = jm.snapshot(), tm.snapshot()
    assert jdoc["layers"] == tdoc["layers"] == {}
    assert tdoc["verdict"] == "healthy"
    epochs = len(tw.decision.history)
    assert [e for e, _ in tm._loss_history] == list(range(epochs))
    assert [e for e, _ in jm._loss_history] == list(range(epochs))
    if sample == "kohonen":
        assert_docs_equal(jdoc, tdoc)
        assert [loss for _, loss in tm._loss_history] == [0.0] * epochs


def test_prng_draws_match_reference():
    """The port's ``uniform`` and ``random_sample`` draw the reference's
    numbers at the same seed."""
    seed(12)
    for key in ("a", "b"):
        j, t = jprng.get(key), tprng.get(key)
        assert numpy.array_equal(j.uniform(-1.0, 1.0, (6, 2)),
                                 t.uniform(-1.0, 1.0, (6, 2)))
        want, got = j.random_sample((3, 4)), t.random_sample((3, 4))
        assert got.dtype == numpy.float64 and numpy.array_equal(got, want)
