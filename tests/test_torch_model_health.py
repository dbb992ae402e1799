"""The port's model-health plane (veles_torch/model_health.py, the layer
stats of znicz/nn_units.py and their cadence in znicz/step.py, the
decision's loss feed, NNRollback's divergence tick, the checkpoint stamp
and the CLI's options) against the JAX package's (veles/model_health.py,
XLAStep's traced stats) on the CPU.

Each package runs under its own scoped monitor: the port's is its own
process-global, never the reference's."""

import logging
import math
import os

import numpy
import pytest
import torch

import veles.model_health as JMH
import veles.prng as jprng
from veles.config import root as jroot
import veles_torch.model_health as TMH
import veles_torch.prng as tprng
import veles_torch.snapshotter as TS
from veles.znicz_tpu.lr_adjust import ArbitraryStepPolicy as JaxArbitrary
from veles.znicz_tpu.models.mnist import MnistLoader as JaxMnistLoader
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_torch.__main__ import main as torch_main
from veles_torch.znicz.lr_adjust import ArbitraryStepPolicy

from tests.test_service import make_wf as jax_make_wf
from tests.test_torch_cifar_alexnet import (
    cifar_pair, configs, set_cifar)  # noqa: F401  (configs: a fixture)
from tests.test_torch_cifar_alexnet import one_step as cifar_one_step
from tests.test_torch_lm import jax_lm, lm_config, torch_lm
from tests.test_torch_lm import one_step as lm_one_step
from tests.test_torch_resume import SMALL, _layers, torch_mnist
from tests.torch_monitor import port_model_health_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_MNIST = os.path.join(REPO, "veles_torch", "znicz", "models",
                           "mnist.py")
#: stat norms of the two packages from the same state: f32 sums in
#: another order (observed on this CPU: 9.3e-7 over three MNIST epochs)
STATS_RTOL = 1e-6
#: the docs' floats: the port's decision sums its losses in float64, the
#: reference's in f32 products (observed 5e-8)
DOC_RTOL = 1e-6


def assert_docs_equal(want, got, rtol=DOC_RTOL, path="doc"):
    """Equal documents: keys, strings, ints and None exactly; floats
    within ``rtol`` (``updated`` and the slaves' ``seen`` left out)."""
    if isinstance(want, dict):
        skip = {"updated", "seen"}
        assert sorted(set(want) - skip) == sorted(set(got) - skip), path
        for key in set(want) - skip:
            assert_docs_equal(want[key], got[key], rtol,
                              "%s.%s" % (path, key))
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_docs_equal(a, b, rtol, "%s[%d]" % (path, i))
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, (int, float)), path
        if math.isfinite(want):
            assert abs(got - want) <= rtol * max(abs(want), 1e-30), \
                (path, want, got)
        else:
            assert want == got or (math.isnan(want) and math.isnan(got))
    else:
        assert want == got, (path, want, got)


# -- the detector, fed identical scripted observations ------------------


def _stats(*vec):
    return {"fc": numpy.array(vec)}


def nonfinite_diverge_then_recover(M, wf=None):
    mon = M.ModelHealthMonitor(recover_after=2)
    seq = []
    for nf in (0.0, 3.0, 0.0, 0.0):
        mon.observe_stats(_stats(1.0, 5.0, 0.01, nf), step_index=7)
        seq.append(mon.verdict_state())
    return mon, seq


def nonfinite_norm(M, wf=None):
    mon = M.ModelHealthMonitor()
    mon.observe_stats(_stats(numpy.nan, 5.0, 0.01, 0.0))
    mon.observe_stats({"fc": numpy.array([1.0, numpy.inf, 0.01, 0.0]),
                       "short": numpy.array([1.0, 2.0])})
    return mon, [mon.verdict_state()]


def loss_z_suspect_and_diverged(M, wf=None):
    mon = M.ModelHealthMonitor(suspect_z=4.0, diverged_z=8.0,
                               ewma_alpha=0.2, recover_after=3)
    rng = numpy.random.Generator(numpy.random.PCG64(7))
    seq = []
    for i in range(20):
        mon.observe_loss(1.0 + 0.01 * rng.standard_normal(), epoch=i)
    seq.append(mon.verdict_state())
    mon.observe_loss(1.05, epoch=20)        # a few sigma: suspect
    seq.append(mon.verdict_state())
    mon.observe_loss(1.3, epoch=21)         # far above: diverged
    seq.append(mon.verdict_state())
    for i in range(22, 26):
        mon.observe_loss(1.0, epoch=i)
        seq.append(mon.verdict_state())
    return mon, seq


def loss_blowup_second_tick(M, wf=None):
    mon = M.ModelHealthMonitor()
    mon.observe_loss(0.5, epoch=0)
    mon.observe_loss(1.0e6, epoch=1)
    return mon, [mon.verdict_state()]


def nonfinite_loss(M, wf=None):
    mon = M.ModelHealthMonitor()
    mon.observe_loss(float("nan"), epoch=0)
    return mon, [mon.verdict_state()]


def grad_explosion(M, wf=None):
    mon = M.ModelHealthMonitor(explosion_factor=10.0)
    for _ in range(5):
        mon.observe_stats(_stats(1.0, 5.0, 0.01, 0.0))
    mon.observe_stats(_stats(50.0, 5.0, 0.01, 0.0))
    return mon, [mon.verdict_state()]


def disabled_plane(M, wf=None):
    mon = M.ModelHealthMonitor()
    mon.enabled = False
    mon.observe_loss(float("nan"), epoch=0)
    mon.note_wire_nonfinite("fc", 9)
    mon.observe_stats(_stats(1.0, 5.0, 0.01, 2.0))
    return mon, [mon.verdict_state(), mon.manifest_stamp()["verdict"]]


def serving_drift(M, wf=None):
    mon = M.ModelHealthMonitor()
    mon.observe_serving("mnist", numpy.array([[0.8, 0.1, 0.1],
                                              [0.6, 0.3, 0.1]]))
    mon.observe_serving("lm", numpy.array([[5.0, 1.0, 0.0]]))
    mon.observe_serving("reg", numpy.array([1.0, 2.0]))
    mon.serving_stride = 2
    for i in range(3):
        mon.observe_serving("strided", numpy.array([[float(i), 0.0]]))
    return mon, [sorted(mon.snapshot()["serving"])]


def wire_notes_and_slaves(M, wf=None):
    mon = M.ModelHealthMonitor(recover_after=2)
    mon.note_wire_nonfinite("gd2", 4, slave=7)
    seq = [mon.verdict_state()]
    for _ in range(20):
        mon.note_wire_nonfinite("gd1", 0)
    mon.absorb_slave({"loss": 0.4, "verdict": "healthy", "layers": {
        "fc": {"grad_norm": 1.5, "weight_norm": 4.0}}}, 2)
    seq.append(mon.verdict_state())
    mon.wire_recovery_interval = 0.0
    for _ in range(3):
        mon.note_wire_nonfinite("gd1", 0)
    seq.append(mon.verdict_state())
    mon.absorb_slave({"loss": 9.9, "verdict": "diverged", "layers": {}}, 4)
    seq.append(mon.verdict_state())
    mon.evict_slave(4)
    mon.note_rollback()
    seq.append(mon.verdict_state())
    return mon, seq


def weight_guard_not_stashing_while_suspect(M, wf):
    """The guard keeps the pre-spike stash through a suspect window and
    restores it once the verdict reads diverged."""
    mon = M.ModelHealthMonitor()
    guard = M.WeightGuard(wf, monitor=mon, stash_interval=1)
    guard.tick()                            # healthy: the stash
    good = _weights(wf).copy()
    for _ in range(4):
        mon.observe_stats(_stats(1.0, 5.0, 0.01, 0.0))
    mon.observe_stats(_stats(99.0, 5.0, 0.01, 0.0))
    seq = [mon.verdict_state()]
    _set_weights(wf, _weights(wf) + 100.0)  # drift while suspect
    guard.tick()
    mon.note_wire_nonfinite("fc", 1)
    restored = guard.tick()
    seq.append(mon.verdict_state())
    assert numpy.array_equal(_weights(wf), good)
    return mon, seq + [restored, guard.rollback_count]


def manifest_stamp(M, wf=None):
    mon = M.ModelHealthMonitor()
    mon.observe_stats({"a": numpy.array([1.0, 2.0, 0.1, 0.0]),
                       "b": numpy.array([3.0, 4.0, 0.2, 0.0])},
                      step_index=9)
    mon.observe_loss(0.7, epoch=3)
    stamp = mon.manifest_stamp()
    mon.note_wire_nonfinite("b", 2)
    return mon, [stamp, mon.manifest_stamp(), mon.push_summary()]


def _weights(wf):
    w = wf.forwards[0].weights
    if isinstance(w, torch.Tensor):
        return w.numpy()
    return numpy.array(w.map_read().mem)


def _set_weights(wf, value):
    w = wf.forwards[0].weights
    if isinstance(w, torch.Tensor):
        wf.forwards[0].weights = torch.from_numpy(value)
    else:
        w.map_write().mem[...] = value


SCENARIOS = [nonfinite_diverge_then_recover, nonfinite_norm,
             loss_z_suspect_and_diverged, loss_blowup_second_tick,
             nonfinite_loss, grad_explosion, disabled_plane, serving_drift,
             wire_notes_and_slaves, weight_guard_not_stashing_while_suspect,
             manifest_stamp]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_monitor_matches_reference(scenario):
    """The same observations give the same verdicts, reasons and
    document in both monitors."""
    jwf = twf = None
    if scenario is weight_guard_not_stashing_while_suspect:
        # the reference's helper sets root.mnist's sizes for its own
        # tests; a later test in this process reads the defaults
        saved = jroot.mnist.to_dict()
        try:
            jwf = jax_make_wf("MHGuardRef", max_epochs=2)
        finally:
            jroot.mnist.update(saved)
        twf = torch_mnist(2)
    jmon, jseq = scenario(JMH, jwf)
    tmon, tseq = scenario(TMH, twf)
    assert_docs_equal(jseq, tseq, rtol=0.0, path="sequence")
    assert_docs_equal(jmon.snapshot(), tmon.snapshot(), rtol=0.0)
    assert_docs_equal(jmon.manifest_stamp(), tmon.manifest_stamp(),
                      rtol=0.0, path="stamp")


def test_metrics_carry_the_reference_instruments():
    """The port's plain series hold what the reference's instruments
    read, under their names."""
    mon = TMH.ModelHealthMonitor()
    mon.observe_stats(_stats(1.5, 4.0, 0.01, 0.0))
    mon.observe_stats({"gd": numpy.array([1.0, 2.0, 0.1, 3.0])})
    mon.observe_loss(0.25, epoch=0)
    mon.observe_serving("m", numpy.array([[0.8, 0.2]]))
    m = mon.metrics()
    assert m["veles_model_grad_norm"] == {'layer="fc"': 1.5}
    assert m["veles_model_nonfinite_total"] == {'layer="gd"': 3.0}
    assert m["veles_model_nonfinite_step"] == {"": 3.0}
    assert m["veles_model_loss"] == {"": 0.25}
    assert m["veles_model_verdict"] == {"": 2.0}
    assert m["veles_serving_top1_margin"]['model="m"'] == \
        pytest.approx(0.6)


def test_scoped_monitors_are_the_ports_own():
    """The port's active monitor is its own global: swapping one
    package's leaves the other's in place."""
    with TMH.scoped() as tm, JMH.scoped() as jm:
        assert TMH.get_model_monitor() is tm
        assert JMH.get_model_monitor() is jm
        assert TMH.debug_model_doc() is tm.snapshot()
    assert TMH.get_model_monitor() is not tm


# -- layer stats on the training path ------------------------------------


class _Recording:
    """Records every observe_stats call: (step index, layers, vectors)."""

    def __init__(self):
        self.seen = []
        self.verdicts = []

    def observe_stats(self, stats, step_index=None):
        self.seen.append((step_index, list(stats), numpy.array(
            [numpy.asarray(v, numpy.float64) for v in stats.values()])))
        super().observe_stats(stats, step_index)
        self.verdicts.append(self.verdict_state()[0])


class JaxRecording(_Recording, JMH.ModelHealthMonitor):
    def __init__(self):
        _Recording.__init__(self)
        JMH.ModelHealthMonitor.__init__(self)


class TorchRecording(_Recording, TMH.ModelHealthMonitor):
    def __init__(self):
        _Recording.__init__(self)
        TMH.ModelHealthMonitor.__init__(self)


def jax_mnist(max_epochs, stride, lr_policy=None, image_dir=None,
              limit=64, seed=1337):
    """The reference's MNIST at the size of tests/test_torch_resume.py on
    ``-d cpu``, one epoch a dispatch, its stats every ``stride`` steps."""
    jprng.seed_all(seed)
    wf = JaxStandardWorkflow(
        None, name="Mnist", layers=_layers(),
        loader_factory=lambda w: JaxMnistLoader(
            w, name="loader", minibatch_size=SMALL["minibatch_size"],
            n_train=SMALL["n_train"], n_valid=SMALL["n_valid"]),
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50})
    if lr_policy is not None:
        for gd in wf.gds:
            gd.lr_policy = gd.lr_policy_bias = lr_policy
    if image_dir is not None:
        wf.link_image_saver(image_dir, limit_per_epoch=limit)
    wf.initialize(device="cpu")
    # the stride as the reference's launcher sets it after initialize
    wf.xla_step.stats_interval = wf.xla_step.compiler.stats_stride = stride
    wf.xla_step.epochs_per_dispatch = 1
    return wf


def assert_sequences_match(jseq, tseq):
    assert [(s, n) for s, n, _ in jseq] == [(s, n) for s, n, _ in tseq]
    for (_, _, want), (_, _, got) in zip(jseq, tseq):
        fin = numpy.isfinite(want)
        assert numpy.array_equal(fin, numpy.isfinite(got))
        assert numpy.array_equal(want[:, 3], got[:, 3])      # nonfinite
        rel = numpy.abs(got[fin] - want[fin]) / numpy.maximum(
            numpy.abs(want[fin]), 1e-30)
        assert rel.max(initial=0.0) <= STATS_RTOL, rel.max()


@pytest.mark.parametrize("stride", [1, 8, 3])
def test_mnist_stats_match_reference(stride):
    """Three MNIST epochs (5 train steps each): the same (step index,
    layers, vector) sequence as the reference's XLAStep, norms within
    STATS_RTOL, non-finite counts exact, and equal final documents."""
    with JMH.scoped(JaxRecording()) as jm:
        jax_mnist(3, stride).run()
    with TMH.scoped(TorchRecording()) as tm:
        tw = torch_mnist(3)
        tw.step.stats_interval = stride
        tw.run()
    assert len(tm.seen) == len(range(0, 15, stride))
    assert_sequences_match(jm.seen, tm.seen)
    doc = tm.snapshot()
    assert doc["verdict"] == "healthy" and doc["epoch"] == 2
    for stats in doc["layers"].values():
        assert 0.0 < stats["update_ratio"] < 1.0
    assert_docs_equal(jm.snapshot(), doc)


def test_stats_off_computes_nothing():
    """``set_stats_enabled(False)``: no stat work, no layers in the
    document; the loss still reaches the monitor through the decision."""
    with TMH.scoped() as tm:
        tw = torch_mnist(1)
        tw.step.set_stats_enabled(False)
        tw.run()
        assert tw.step.stat_names is None and tw.step.last_stats is None
        assert tm.snapshot()["layers"] == {}
        assert tm.snapshot()["loss"] is not None


def _step_stats_match(outs, step):
    """The reference's traced stat outputs of one step against the port's
    last stats, by layer."""
    stats, _ = JMH.take_stats(outs)
    assert sorted(stats) == step.stat_names
    got = step.last_stats.numpy()
    for row, name in zip(got, step.stat_names):
        want = numpy.asarray(stats[name], numpy.float64)
        assert want[3] == row[3] == 0.0, name
        rel = numpy.abs(row[:3] - want[:3]) / numpy.abs(want[:3])
        assert rel.max() <= STATS_RTOL, (name, rel)
    return len(stats)


def test_lm_step_stats_match_reference():
    """One LM-sample step (embedding, layer norms, attention, FFN, head):
    every unit's vector within STATS_RTOL of the reference's."""
    with lm_config():
        jw, tw = jax_lm(), torch_lm()
    _, _, outs, _ = lm_one_step(jw, tw)
    assert _step_stats_match(outs, tw.step) == len(tw.step.stat_units) >= 5


def test_cifar_step_stats_match_reference(configs):  # noqa: F811
    """One CIFAR step (the conv GDs): every vector within STATS_RTOL."""
    set_cifar(1)
    jw, tw = cifar_pair(1)
    idx_mat, valids = jw.loader.class_schedule(2)
    data = jw.loader.original_data.mem[idx_mat[0]]
    labels = jw.loader.original_labels.mem[idx_mat[0]]
    _, _, outs, _ = cifar_one_step(jw, tw, data, torch.from_numpy(data),
                                   labels, valids[0])
    assert _step_stats_match(outs, tw.step) == len(tw.step.stat_units) == 3


# -- divergence --------------------------------------------------------------


#: a NaN learning rate on train step 7 (epoch 1's third): the weights turn
#: NaN in that update
NAN_SCHEDULE = [(0.02, 7), (float("nan"), 1), (0.02, 1)]


def test_injected_nan_diverges_at_the_same_step():
    """The NaN step's weight norm is non-finite: both packages judge
    ``diverged`` on that step's stats (stride 1) with the same reasons."""
    with JMH.scoped(JaxRecording()) as jm:
        jax_mnist(2, 1, lr_policy=JaxArbitrary(NAN_SCHEDULE)).run()
    with TMH.scoped(TorchRecording()) as tm:
        tw = torch_mnist(2)
        tw.link_lr_adjuster({"name": "arbitrary_step",
                             "schedule": NAN_SCHEDULE})
        tw.step.stats_interval = 1
        tw.run()
    assert tm.verdicts == jm.verdicts
    assert tm.verdicts.index("diverged") == 7
    assert_sequences_match(jm.seen, tm.seen)
    assert tm.verdict_state() == jm.verdict_state()
    assert "nonfinite:GDSoftmax" in tm.verdict_state()[1]


def test_rollback_on_divergence_restores(tmp_path):
    """The port's rollback restores its stash at the end of the class
    whose stats diverged (a checkpoint written there is stamped diverged
    and skipped by ``resolve_auto``); the restored weights train on and
    re-earn healthy."""
    with TMH.scoped(TorchRecording()) as tm:
        tw = torch_mnist(3, snapdir=str(tmp_path), interval=1e-9,
                         keep_interval=100)
        tw.link_lr_adjuster(ArbitraryStepPolicy(NAN_SCHEDULE))
        tw.step.stats_interval = 1
        rb = tw.link_rollback(rollback_on_divergence=True)
        tw.run()
        assert rb.rollback_count == 1 and tm.snapshot()["rollbacks"] == 1
        assert all(gd.lr_scale == 0.5 for gd in tw.gds)
        w = tw.forwards[0].weights
        assert torch.isfinite(w).all()
        assert tm.verdicts[7] == "diverged"
        assert tm.verdict_state() == ("healthy", [])
    infos = TS.scan_checkpoints(str(tmp_path))
    verdicts = {i.name: i.health_verdict for i in infos}
    assert "diverged" in verdicts.values(), verdicts
    _, name, _ = TS.resolve_auto(str(tmp_path))
    assert verdicts[name] != "diverged"


def test_restore_syncs_the_stats_cadence():
    """``restore_stash`` rolls the GD units' iteration back, and the
    step's host mirror with it, so the stride counts from there."""
    with TMH.scoped():
        tw = torch_mnist(1)
        stash = tw.stash_state()
        tw.run()
        assert tw.step.iteration == 5
        tw.restore_stash(stash)
        assert tw.step.iteration == 0
        assert tw.step.stats_due() and not tw.step.stats_due(3)


# -- the ImageSaver -----------------------------------------------------


def _dumps(out):
    found = {}
    for d, _, files in os.walk(out):
        for f in files:
            found[os.path.relpath(os.path.join(d, f), out)] = \
                numpy.load(os.path.join(d, f))
    return found


def test_image_saver_matches_reference(tmp_path):
    """Both packages dump each minibatch's worst sample under the same
    names, with the same arrays, within the per-epoch limit; the counters
    ride a checkpoint."""
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    with JMH.scoped():
        jax_mnist(2, 8, image_dir=jout, limit=5).run()
    with TMH.scoped():
        tw = torch_mnist(2)
        saver = tw.link_image_saver(tout, limit_per_epoch=5)
        tw.run()
    want, got = _dumps(jout), _dumps(tout)
    assert sorted(want) == sorted(got) and len(got) == 10
    assert all(n.split(os.sep)[1].startswith(("c1_", "c2_")) for n in got)
    for name, arr in want.items():
        assert numpy.array_equal(arr, got[name]), name
        gidx = int(name.split("_i")[1].split("_")[0])
        assert numpy.array_equal(got[name],
                                 tw.loader.original_data[gidx])
    assert saver.get_state() == {"epoch": 2, "saved_this_epoch": 0,
                                 "total_saved": 10}
    tree = tw.checkpoint_state()
    fresh = torch_mnist(2)
    saver2 = fresh.link_image_saver(tout)
    fresh.restore_state(tree)
    assert saver2.get_state() == saver.get_state()
