"""Workflow state of the port (veles_torch/znicz/standard_workflow.py:
checkpoint_state / restore_state, the snapshotter, NNRollback,
ArchiveModel.load_checkpoint) against the JAX package run on the CPU.

The reference takes its improvement-gated checkpoint at the
valid/train boundary of the epoch (valid is served before train, and the
decision flags ``improved`` on the last valid minibatch): the params and
solver state the validation metric was measured on, the decision inside
that epoch, and the loader's generator state AFTER the epoch's shuffle
was drawn. A restore restarts the loader's epoch and draws its shuffle
again from the restored generator state. The port checkpoints the state
of the last class boundary it passed, with the loader's generator state
from BEFORE that epoch's shuffle, and restores as the reference does. So
either package resumes either package's file identically, and in the
port a resumed run equals the uninterrupted one bit for bit; the
reference's own resume draws the next epoch's shuffle instead."""

import logging
import os

import numpy
import pytest
import torch

import veles.model_health as JMH
import veles.prng as jprng
import veles.snapshotter as JS
from veles.config import root as jroot
from veles.serving.model import ArchiveModel as JaxArchiveModel
from veles.znicz_tpu.generate import generate as jax_generate
from veles.znicz_tpu.lr_adjust import ArbitraryStepPolicy
from veles.znicz_tpu.models import mnist as jmnist
from veles.znicz_tpu.models.mnist import MnistLoader as JaxMnistLoader
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
import veles_torch.model_health as TMH
import veles_torch.prng as tprng
import veles_torch.snapshotter as TS
from veles_torch.config import root as troot
from veles_torch.convert import params_to_numpy
from veles_torch.serving.model import ArchiveModel
from veles_torch.znicz.generate import generate
from veles_torch.znicz.models import mnist as tmnist
from veles_torch.znicz.models.mnist import MnistLoader as TorchMnistLoader
from veles_torch.znicz.standard_workflow import \
    StandardWorkflow as TorchStandardWorkflow

from tests.test_torch_lm import lm_config
from tests.test_torch_solvers import (
    ADAM, EPOCHS_RTOL, assert_close_rel, jax_tree)
from tests.torch_monitor import port_model_health_isolation  # noqa: F401
from tests.torch_threads import one_intra_op_thread  # noqa: F401

#: MNIST at the size of tests/test_torch_mnist.py: 5 train and 2
#: validation minibatches an epoch
SMALL = dict(minibatch_size=20, n_train=100, n_valid=40)
#: MNIST's parity bound (ROADMAP): params of a resumed run within this
#: of the reference's, absolute
MNIST_ATOL = 1e-7
#: the LM's AdamW resume, as tests/test_torch_solvers.py holds AdamW
#: epochs: every tensor within this share of its largest element
LM_RTOL = EPOCHS_RTOL
#: serving predictions of a refreshed archive (the serving bound)
SERVE_ATOL = 1.5e-7


def _layers(gd=None):
    gd = dict({"learning_rate": 0.02, "weights_decay": 0.0,
               "gradient_moment": 0.5}, **(gd or {}))
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
             "<-": dict(gd)},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": dict(gd)}]


def jax_mnist(max_epochs, snapdir=None, seed=1337, name="Mnist"):
    """The reference's MNIST chain, initialized on ``-d cpu``; with
    ``snapdir`` its snapshotter writes uncompressed checkpoints there."""
    jprng.seed_all(seed)
    cfg = {} if snapdir is None else {"snapshotter_config": {
        "directory": snapdir, "compression": ""}}
    wf = JaxStandardWorkflow(
        None, name=name, layers=_layers(),
        loader_factory=lambda w: JaxMnistLoader(
            w, name="loader", minibatch_size=SMALL["minibatch_size"],
            n_train=SMALL["n_train"], n_valid=SMALL["n_valid"]),
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50},
        **cfg)
    wf.initialize(device="cpu")
    return wf


def torch_mnist(max_epochs, snapdir=None, seed=1337, name="Mnist",
                layers=None, fail_iterations=50, **snapshotter):
    """The port's MNIST chain (or ``layers``) on the CPU, initialized;
    with ``snapdir`` its snapshotter (``snapshotter`` kwargs) writes
    uncompressed checkpoints there."""
    tprng.seed_all(seed)
    cfg = {} if snapdir is None else {"snapshotter_config": dict(
        snapshotter, directory=snapdir, compression="")}
    wf = TorchStandardWorkflow(
        name=name, layers=layers or _layers(),
        loader_factory=lambda w: TorchMnistLoader(
            w, name="loader", minibatch_size=SMALL["minibatch_size"],
            n_train=SMALL["n_train"], n_valid=SMALL["n_valid"]),
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": fail_iterations},
        **cfg)
    return wf.initialize(device="cpu")


def port_tree(wf):
    return params_to_numpy(wf.export_tree())


def assert_atol(want, got, atol):
    assert sorted(want) == sorted(got)
    for unit in want:
        assert sorted(want[unit]) == sorted(got[unit]), unit
        for key, value in want[unit].items():
            diff = numpy.abs(numpy.asarray(got[unit][key], numpy.float64)
                             - numpy.asarray(value, numpy.float64)).max()
            assert diff <= atol, (unit, key, diff)


def valid_errors(wf):
    return [h["validation"]["metric"] for h in wf.decision.history]


def best_checkpoint(directory, epoch):
    """The best-slot checkpoint whose decision is in ``epoch``."""
    for name in sorted(os.listdir(directory)):
        if "=" in name:
            tree = TS.load_snapshot(os.path.join(directory, name))
            if tree["decision"]["epoch_number"] == epoch:
                return os.path.join(directory, name)
    raise AssertionError("no best checkpoint of epoch %d in %s"
                         % (epoch, sorted(os.listdir(directory))))


# -- the same state, the same digests ---------------------------------------


def one_shuffle_later(prng_state):
    """The loader generator's state after it draws one train shuffle
    from ``prng_state``."""
    gen = numpy.random.Generator(numpy.random.PCG64())
    gen.bit_generator.state = prng_state
    gen.permutation(SMALL["n_train"])
    return gen.bit_generator.state


def _flat_arrays(tree):
    flat = TS._flatten_tree(tree)
    del flat["__json__"]
    return flat


def test_fresh_state_same_keys_dtypes_digests():
    """A freshly initialized MNIST workflow of each package under one
    seed: the same flat keys of ``checkpoint_state``, the same dtypes and
    equal sha256 for every param and solver array; the same JSON
    sections."""
    jw = jax_mnist(2)
    tw = torch_mnist(2)
    want = _flat_arrays(jw.checkpoint_state())
    got = _flat_arrays(tw.checkpoint_state())
    assert sorted(want) == sorted(got)
    for key in want:
        assert want[key].dtype == got[key].dtype, key
        assert TS._array_digest(got[key]) == JS._array_digest(want[key]), key
    jt, tt = jw.checkpoint_state(), tw.checkpoint_state()
    assert jt["decision"] == tt["decision"]
    assert jt["lr_scales"] == tt["lr_scales"]
    assert jt["loader"]["epoch_number"] == tt["loader"]["epoch_number"]
    assert jt["loader"]["normalizer"] == tt["loader"]["normalizer"]
    assert one_shuffle_later(tt["loader"]["prng_state"]) == \
        jt["loader"]["prng_state"]
    assert jt["meta"] == dict(tt["meta"], workflow="Mnist")


# -- cross-resume -----------------------------------------------------------


@pytest.fixture(scope="module")
def mnist_checkpoints(tmp_path_factory):
    """Each package trains MNIST 3 epochs with a snapshotter at the same
    seed; -> {package: path of its best checkpoint taken in epoch 1}.
    Module-scoped, so it runs before the per-test model-health isolation:
    each run gets fresh monitors of both packages here, or the losses an
    earlier test of the process left in a process-global monitor judge
    this run's (a stamped ``diverged`` checkpoint is refused on load)."""
    out = {}
    for package, build in (("reference", jax_mnist), ("port", torch_mnist)):
        d = str(tmp_path_factory.mktemp(package))
        with JMH.scoped(), TMH.scoped():
            build(3, snapdir=d).run()
        out[package] = best_checkpoint(d, 1)
    return out


def resume_both(path, max_epochs):
    """Both packages restore the checkpoint at ``path`` into a fresh
    workflow (the seed makes the same synthetic data) and run to
    ``max_epochs``; -> (reference, port)."""
    jw = jax_mnist(max_epochs)
    jw.restore_state(JS.load_snapshot(path))
    jw.run()
    tw = torch_mnist(max_epochs)
    tw.restore_state(TS.load_snapshot(path))
    tw.run()
    return jw, tw


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mnist_cross_resume(mnist_checkpoints, writer):
    """A checkpoint of epoch 1 written by ``writer``: the reference and
    the port each restore it into a fresh workflow and run two more
    epochs (the restarted epoch 1 and epoch 2); params within
    MNIST_ATOL, equal validation errors, equal histories' lengths."""
    jw, tw = resume_both(mnist_checkpoints[writer], 3)
    assert len(jw.decision.history) == len(tw.decision.history) == 3
    assert valid_errors(jw) == valid_errors(tw)
    assert_atol(jax_tree(jw), port_tree(tw), MNIST_ATOL)


def test_port_checkpoint_is_the_references(mnist_checkpoints):
    """The port's epoch-1 checkpoint holds what the reference's does: the
    params and solver state of the valid/train boundary (within
    MNIST_ATOL), the same loader epoch, step counter and history; its
    generator state is the reference's one shuffle earlier (drawing
    epoch 1's permutation from it gives the reference's), and its
    decision is the one of epoch 1's entry, where the reference's has
    already judged epoch 1's validation class (a new best: the checkpoint
    is the best slot's)."""
    want = JS.load_snapshot(mnist_checkpoints["reference"])
    got = TS.load_snapshot(mnist_checkpoints["port"])
    for section in ("params", "state"):
        assert_atol(want[section], got[section], MNIST_ATOL)
    jd, td = want["decision"], got["decision"]
    for key in ("epoch_number", "epochs_since_best"):
        assert td[key] == jd[key], key
    assert [h["validation"]["metric"] for h in td["history"]] \
        == [h["validation"]["metric"] for h in jd["history"]]
    assert (jd["best_epoch"], td["best_epoch"]) == (1, 0)
    assert td["best_metric"] == td["history"][0]["validation"]["metric"] \
        > jd["best_metric"]
    valid_minibatches = SMALL["n_valid"] // SMALL["minibatch_size"]
    assert td["minibatch_count"] == jd["minibatch_count"] - valid_minibatches
    assert got["loader"]["epoch_number"] == want["loader"]["epoch_number"]
    # the reference counts every served minibatch, the port train steps
    assert got["meta"]["step_index"] == 5
    assert want["meta"]["step_index"] == 7
    assert one_shuffle_later(got["loader"]["prng_state"]) == \
        want["loader"]["prng_state"]


def test_reference_resume_replays_another_shuffle(mnist_checkpoints):
    """The departure the port repairs: the reference's own checkpoint,
    resumed, differs from its uninterrupted run (the restarted epoch
    trains on the next epoch's shuffle); the port's resumed by the
    reference equals the reference's uninterrupted run within
    MNIST_ATOL."""
    straight = jax_mnist(3)
    straight.run()
    jw, _ = resume_both(mnist_checkpoints["reference"], 3)
    diff = numpy.abs(jw.forwards[0].weights.map_read().mem
                     - straight.forwards[0].weights.map_read().mem).max()
    assert diff > 1e-4
    jw, _ = resume_both(mnist_checkpoints["port"], 3)
    assert_atol(jax_tree(straight), jax_tree(jw), MNIST_ATOL)


# -- the LM under AdamW -----------------------------------------------------

#: AdamW with accumulation 2 and warmup-cosine, the conditioned adam_eps
#: of tests/test_torch_solvers.py
LM_TRAIN = dict(ADAM, learning_rate=0.01, accumulate_gradient=2,
                lr_policy={"name": "warmup_cosine", "warmup": 4,
                           "total": 24})


def lm_build(package, snapdir=None, max_epochs=3):
    """The small LM of tests/test_torch_lm.py in ``package``, its
    snapshotter writing to ``snapdir``; initialized."""
    if package == "reference":
        jprng.seed_all(1337)
        from veles.znicz_tpu.models import transformer_lm as jlm
        wf = jlm.create_workflow(name="LM")
        if snapdir:
            wf.link_snapshotter(directory=snapdir, compression="")
        wf.decision.max_epochs = max_epochs
        wf.initialize(device="cpu")
        return wf
    tprng.seed_all(1337)
    from veles_torch.znicz.models import transformer_lm as tlm
    wf = tlm.create_workflow(name="LM")
    if snapdir:
        wf.link_snapshotter(directory=snapdir, compression="")
    wf.decision.max_epochs = max_epochs
    return wf.initialize(device="cpu")


@pytest.fixture
def lm_adam():
    saved = [(r, r.lm.train.to_dict()) for r in (jroot, troot)]
    try:
        with lm_config(model={"attn_impl": None}):
            for r in (jroot, troot):
                r.lm.train.update(LM_TRAIN)
            yield
    finally:
        for r, tree in saved:
            r.lm.train = tree


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_lm_adam_cross_resume(lm_adam, tmp_path, writer):
    """The LM under AdamW, accumulation 2 and warmup-cosine: ``writer``
    trains 2 epochs with a snapshotter; both packages resume its epoch-1
    checkpoint and run to 3 epochs. Every parameter, ``vel_*``, ``sq_*``,
    ``acc_*`` and counter within LM_RTOL of the reference's (the AdamW
    epochs' bound), the validation losses within LM_RTOL."""
    lm_build(writer, snapdir=str(tmp_path), max_epochs=2).run()
    path = best_checkpoint(str(tmp_path), 1)
    jw = lm_build("reference")
    jw.restore_state(JS.load_snapshot(path))
    jw.run()
    tw = lm_build("port")
    tw.restore_state(TS.load_snapshot(path))
    tw.run()
    tree = TS.load_snapshot(path)
    assert any("sq_weights" in sub for sub in tree["state"].values())
    assert any("acc_weights" in sub for sub in tree["state"].values())
    jh, th = jw.decision.history, tw.decision.history
    assert len(jh) == len(th) == 3
    for j, t in zip(jh, th):
        assert abs(j["validation"]["loss"] - t["validation"]["loss"]) <= \
            LM_RTOL * j["validation"]["loss"]
    assert_close_rel(jax_tree(jw), port_tree(tw), LM_RTOL)


# -- a resumed run equals the uninterrupted one ------------------------------

DROPOUT_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.5}},
    {"type": "dropout", "->": {"dropout_ratio": 0.3}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.5}}]


def decision_point(path):
    """(epoch, minibatches accounted) of a checkpoint's decision."""
    d = TS.load_snapshot(path)["decision"]
    return d["epoch_number"], d["minibatch_count"]


def _stop_in_train(wf, after):
    """Make ``wf`` stop after ``after`` train steps of epoch 1 (the
    preemption path: the class in flight is not accounted)."""
    step = wf.step
    train = step.train_minibatch

    def counted(*args):
        out = train(*args)
        if wf.decision.epoch_number == 1 and step.train_steps == 5 + after:
            step.stop_requested = True
        return out

    step.train_minibatch = counted


@pytest.mark.parametrize("layers,fail_iterations",
                         [(None, 1), (DROPOUT_LAYERS, 2)],
                         ids=["mnist", "dropout"])
@pytest.mark.parametrize("where", ["valid_train", "epoch_end", "in_train"])
def test_resume_equals_uninterrupted(tmp_path, layers, fail_iterations,
                                     where):
    """4 epochs in one go against a checkpoint taken in or after epoch 1,
    a fresh workflow and the rest: every tensor, the history and the
    decision's state bit for bit. The checkpoint is the one of epoch 1's
    valid/train boundary (MNIST's best, the dropout model's rolling one),
    the rolling one after epoch 1's train class, or the preemption one of
    a run stopped 2 steps into epoch 1's train class (the epoch-entry
    copy). Inside the epoch the checkpoint holds the decision of the
    epoch's entry, so the resumed run judges epoch 1's validation metric
    once: ``fail_iterations`` is small enough (MNIST improves every epoch,
    the dropout model not in epoch 1) that a second judgement would end
    the resumed run early. The dropout model's masks continue from the
    checkpointed generator state."""
    straight = torch_mnist(4, layers=layers,
                           fail_iterations=fail_iterations)
    straight.run()
    assert len(straight.decision.history) == 4
    d = str(tmp_path)
    first = torch_mnist(4 if where == "in_train" else 2, snapdir=d,
                        layers=layers, fail_iterations=fail_iterations,
                        interval=1e-9, keep_interval=8)
    if where == "in_train":
        _stop_in_train(first, 2)
        first.run()
        path = first.snapshotter.preempt_snapshot()
        assert first.step.in_train and first.step.train_steps == 7
    else:
        first.run()
        # every class boundary wrote one checkpoint, oldest first: epoch
        # 0's valid/train boundary and end, then epoch 1's
        written = [i.name for i in reversed(TS.scan_checkpoints(d))]
        assert len(written) == 4
        path = os.path.join(
            d, written[2 if where == "valid_train" else 3])
    # (epoch, minibatches accounted): inside epoch 1 the decision of its
    # entry (epoch 0's 2 + 5), after it 14
    want = (2, 14) if where == "epoch_end" else (1, 7)
    tree = TS.load_snapshot(path)
    assert decision_point(path) == want
    assert ("units" in tree) == (layers is not None)
    resumed = torch_mnist(4, layers=layers, fail_iterations=fail_iterations)
    resumed.restore_state(tree)
    resumed.run()
    assert resumed.decision.history == straight.decision.history
    for key in ("best_metric", "best_epoch", "_epochs_since_best",
                "complete", "epoch_number", "minibatch_count"):
        assert getattr(resumed.decision, key) == \
            getattr(straight.decision, key), key
    want, got = straight.export_tree(), resumed.export_tree()
    for unit in want:
        for key in want[unit]:
            assert torch.equal(want[unit][key], got[unit][key]), (unit, key)


def test_restore_refuses_what_does_not_fit(tmp_path, caplog, monkeypatch):
    """A shape the unit lacks, or a key, raises CorruptCheckpointError;
    an unknown unit name is warned and skipped (the reference's rule)."""
    tw = torch_mnist(1)
    tree = tw.checkpoint_state()
    bad = dict(tree, params=dict(tree["params"], All2AllTanh={
        "weights": numpy.zeros((3, 3), numpy.float32)}))
    with pytest.raises(TS.CorruptCheckpointError, match="shape"):
        torch_mnist(1).restore_state(bad)
    bad = dict(tree, state=dict(tree["state"], GDTanh={
        "sq_weights": numpy.zeros((784, 100), numpy.float32)}))
    with pytest.raises(TS.CorruptCheckpointError, match="no such"):
        torch_mnist(1).restore_state(bad)
    ghost = dict(tree, params=dict(tree["params"], Ghost={
        "weights": numpy.zeros(3, numpy.float32)}),
        units={"ghost": {"generator": numpy.zeros(3, numpy.uint8)}})
    # a CLI run earlier in the process stops the port's records from
    # propagating to caplog's handler
    monkeypatch.setattr(logging.getLogger("veles_torch"), "propagate", True)
    torch_mnist(1).restore_state(ghost)
    assert caplog.text.count("unknown unit") == 2
    # outside a resume (a tree of export_tree's shape) an unknown unit
    # raises like the rest
    with pytest.raises(TS.CorruptCheckpointError, match="Ghost"):
        torch_mnist(1).import_tree(ghost["params"])


# -- the user journey: AdamW, snapshot, resume, generate --------------------

CORPUS = "the quick brown fox jumps over the lazy dog. " * 60


def _text_lm(package, path, epochs):
    """tests/test_text_lm.py's _train_text_lm in ``package``."""
    from tests.test_torch_text_lm import text_config
    cfg = {"loader": {"minibatch_size": 32, "seq_len": 24},
           "train": {"solver": "adam", "learning_rate": 0.01,
                     "gradient_moment": 0.9, "weights_decay": 0.0}}
    with text_config(path, epochs=epochs):
        for r in (jroot, troot):
            r.lm.loader.update(cfg["loader"])
            r.lm.train.update(cfg["train"])
        if package == "reference":
            jprng.seed_all(321)
            from veles.znicz_tpu.models import transformer_lm as jlm
            wf = jlm.create_workflow(name="SnapTextLM")
            wf.initialize(device="cpu")
        else:
            tprng.seed_all(321)
            from veles_torch.znicz.models import transformer_lm as tlm
            wf = tlm.create_workflow(name="SnapTextLM").initialize(
                device="cpu")
        wf.run()
    return wf


def test_adam_lm_snapshot_resume_generate(tmp_path):
    """The twin of tests/test_text_lm.py::test_adam_lm_snapshot_resume_
    generate: train under AdamW, snapshot, restore into a fresh workflow
    (the second moments in the snapshot are non-zero); greedy generation
    from the resumed model equals the original's and the reference's."""
    path = str(tmp_path / "corpus.txt")
    with open(path, "w") as f:
        f.write(CORPUS)
    tw = _text_lm("port", path, 10)
    snap = tw.link_snapshotter(directory=str(tmp_path / "snaps"))
    ckpt = snap.export_snapshot()
    assert os.path.exists(ckpt)
    prompt = tw.loader.encode("the quick brown ")
    want = generate(tw, prompt, 10, temperature=0.0)
    state = TS.load_snapshot(ckpt)
    sq = [v["sq_weights"] for v in state["state"].values()
          if "sq_weights" in v]
    assert sq and any(numpy.abs(v).max() > 0 for v in sq)
    fresh = _text_lm("port", path, 1)
    fresh.restore_state(state)
    assert all(g.sq_weights is None or g.sq_weights.any()
               for g in fresh.gds)
    got = generate(fresh, prompt, 10, temperature=0.0)
    assert (got == want).all(), (got, want)
    jw = _text_lm("reference", path, 10)
    jw.xla_step.sync_host()
    assert (jax_generate(jw, prompt, 10, temperature=0.0) == want).all()
    # the reference resumes the port's snapshot to the same tokens
    jw2 = _text_lm("reference", path, 1)
    jw2.restore_state(JS.load_snapshot(ckpt))
    jw2.xla_step.refresh_device()
    assert (jax_generate(jw2, prompt, 10, temperature=0.0) == want).all()


# -- NNRollback -------------------------------------------------------------


def _rollback_mnist(package):
    """tests/test_lr_rollback.py::test_rollback_on_blowup's run in
    ``package``: lr 0.02 for 5 steps, then 60 (a schedule step)."""
    mnist = jmnist if package == "reference" else tmnist
    root = jroot if package == "reference" else troot
    (jprng if package == "reference" else tprng).seed_all(31337)
    saved = root.mnist.to_dict()
    root.mnist.loader.update({"minibatch_size": 20, "n_train": 100,
                              "n_valid": 40})
    root.mnist.decision.max_epochs = 6
    try:
        wf = mnist.create_workflow(name="Rollback")
        if package == "reference":
            wf.link_lr_adjuster(ArbitraryStepPolicy([(0.02, 5), (60.0, 1)]))
        else:
            wf.link_lr_adjuster({"name": "arbitrary_step",
                                 "schedule": [(0.02, 5), (60.0, 1)]})
        rb = wf.link_rollback(lr_cut=0.25, blowup_factor=2.0)
        wf.initialize(device="cpu")
        with numpy.errstate(all="ignore"):
            wf.run()
    finally:
        root.mnist.update(saved)
    return wf, rb


def test_rollback_on_blowup_matches_reference():
    """The same seed and blow-up lr in both packages: the same
    rollback_count (at least 1), the same lr_scale (0.25 per rollback),
    finite params within 1e-6 of the reference's."""
    jw, jrb = _rollback_mnist("reference")
    tw, trb = _rollback_mnist("port")
    assert trb.rollback_count == jrb.rollback_count >= 1
    assert [g.lr_scale for g in tw.gds] == [g.lr_scale for g in jw.gds] \
        == [0.25 ** trb.rollback_count] * 2
    assert tw.gds[0].learning_rate == pytest.approx(0.02)
    got = port_tree(tw)
    assert all(numpy.isfinite(v).all() for sub in got.values()
               for v in sub.values())
    assert_atol({u: {k: v for k, v in sub.items() if k != "iteration"}
                 for u, sub in jax_tree(jw).items()},
                {u: {k: v for k, v in sub.items() if k != "iteration"}
                 for u, sub in got.items()}, 1e-6)


def test_rollback_restore_copies():
    """restore_stash copies: the stash survives the updates after a
    rollback, so a second blow-up restores the same values."""
    tw = torch_mnist(2)
    tw.link_rollback()
    tw.run()
    stash = tw.stash_state(at_valid=True)
    kept = stash["params"]["All2AllTanh"]["weights"].clone()
    tw.restore_stash(stash)
    tw.forwards[0].weights.add_(1.0)
    assert torch.equal(stash["params"]["All2AllTanh"]["weights"], kept)
    # the divergence tick: a NaN in the live weights and a diverged
    # verdict restore the stash (copied) and cut the rates
    rb = tw.link_rollback(rollback_on_divergence=True)
    rb._stash = stash
    tw.forwards[0].weights[0, 0] = float("nan")
    monitor = TMH.get_model_monitor()
    monitor.note_wire_nonfinite("GDTanh", 1)
    rb.run()
    assert rb.rollback_count == 1
    assert torch.equal(tw.forwards[0].weights, kept)
    assert tw.forwards[0].weights is not kept
    assert all(gd.lr_scale == 0.5 for gd in tw.gds)
    assert monitor.verdict_state() == ("suspect", ["rolled_back"])
    rb.run()                            # no longer diverged: no restore
    assert rb.rollback_count == 1
    # the check runs at every epoch's end: an interval is refused, never
    # stored unread
    with pytest.raises(TypeError, match="interval"):
        tw.link_rollback(interval=2)


def test_rollback_and_generator_state_survive_a_checkpoint(tmp_path):
    """NNRollback's count, best loss and lr cuts, and a dropout unit's
    generator, round-trip a checkpoint into a fresh workflow; the
    reference restores the same rollback state from the port's file and
    skips the generator state (its units keep none)."""
    tw = torch_mnist(1, snapdir=str(tmp_path), layers=DROPOUT_LAYERS)
    rb = tw.link_rollback()
    rb.rollback_count, rb._best_loss = 2, 0.321
    for gd in tw.gds:
        gd.lr_scale = 0.25
    path = tw.snapshotter.export_snapshot()
    fresh = torch_mnist(3, layers=DROPOUT_LAYERS)
    rb2 = fresh.link_rollback()
    fresh.restore_state(TS.load_snapshot(path))
    assert rb2.get_state() == {"rollback_count": 2, "best_loss": 0.321}
    assert all(gd.lr_scale == 0.25 for gd in fresh.gds)
    drop = fresh.forwards[1]
    assert numpy.array_equal(tprng.generator_state(drop.generator),
                             tprng.generator_state(tw.forwards[1].generator))
    fresh.run()
    assert fresh.decision.epoch_number == 3
    jw = jax_mnist(3)
    jrb = jw.link_rollback()
    tree = JS.load_snapshot(path)
    tree["params"] = {}              # the port's dropout model's shapes
    tree["state"] = {}
    jw.restore_state(tree)
    assert jrb.get_state() == {"rollback_count": 2, "best_loss": 0.321}


# -- ArchiveModel.load_checkpoint --------------------------------------------


def test_load_checkpoint_matches_reference(tmp_path, mnist_checkpoints):
    """The reference's MNIST archive, refreshed from the reference's
    epoch-1 checkpoint in both packages: predictions within SERVE_ATOL;
    a diverged manifest, a shape mismatch and a checkpoint that shares
    nothing are refused."""
    jw = jax_mnist(1)
    archive = str(tmp_path / "archive")
    jw.export_inference(archive)
    ckpt = mnist_checkpoints["reference"]
    jm = JaxArchiveModel.from_dir(archive)
    tm = ArchiveModel.from_dir(archive, device="cpu")
    assert jm.load_checkpoint(ckpt) == tm.load_checkpoint(ckpt) == 4
    rows = jw.loader.original_data.mem[:16].astype(numpy.float32)
    want = numpy.asarray(jm(rows))
    got = tm(rows).numpy()
    assert numpy.abs(got - want).max() <= SERVE_ATOL
    state = JS.load_snapshot(ckpt)
    want_w = state["params"]["All2AllTanh"]["weights"]
    assert numpy.array_equal(tm.params["All2AllTanh"]["weights"].numpy(),
                             want_w)
    store = JS.FileSnapshotStore(str(tmp_path / "bad"))
    uri, _ = JS.write_checkpoint(
        store, "m_=0.5.ckpt.npz", state, compression="",
        extra_meta={"model_health": {"verdict": "diverged"}})
    for model in (jm, tm):
        with pytest.raises(ValueError, match="diverged"):
            model.load_checkpoint(uri)
    state["params"]["All2AllTanh"]["bias"] = numpy.zeros(3, numpy.float32)
    uri, _ = TS.write_checkpoint(TS.FileSnapshotStore(str(tmp_path / "s")),
                                 "m_=0.4.ckpt.npz", state, compression="")
    with pytest.raises(ValueError, match="shape"):
        tm.load_checkpoint(uri)
    uri, _ = TS.write_checkpoint(TS.FileSnapshotStore(str(tmp_path / "n")),
                                 "m_=0.3.ckpt.npz", {"params": {"X": {
                                     "w": numpy.ones(2)}}}, compression="")
    with pytest.raises(ValueError, match="shares no parameters"):
        tm.load_checkpoint(uri)
