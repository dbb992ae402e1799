"""The port's autoencoder samples (veles_torch/znicz/models/mnist_ae.py
and video_ae.py) against the JAX package's on ``-d cpu``: the same seed
gives the same images and initial weights bit for bit; one train step
from the same state (``tree_from_jax``: the conv's and the deconv's
weights and velocities) agrees within 1e-6 of each tensor's largest
element; the reference test's MnistAE run (400/100 images, minibatch 50,
3 epochs, seed 7) reads the same validation MSE every epoch within 1e-5
relative, and so does VideoAE at 12 clips. The CLI trains the sample on
the CPU and exports its archive, and asks for a card without ``-d
cpu``."""

import copy
import json
import os

import jax
import numpy
import pytest
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.znicz_tpu.models import mnist_ae as jmnist_ae
from veles.znicz_tpu.models import video_ae as jvideo_ae
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax, params_to_numpy, \
    tree_from_jax
from veles_torch.serving import ArchiveModel
from veles_torch.znicz.decision import DecisionMSE
from veles_torch.znicz.models import mnist_ae as tmnist_ae
from veles_torch.znicz.models import video_ae as tvideo_ae
from veles_torch.znicz.ops.evaluator import EvaluatorMSE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_AE = os.path.join(REPO, "veles_torch", "znicz", "models",
                        "mnist_ae.py")
#: the reference test's run (tests/test_mnist_ae.py)
SMALL = {"n_train": 400, "n_valid": 100, "minibatch_size": 50}
#: one step, each tensor against its largest element (f32 sums in
#: another order); observed at most 5.7e-7
STEP_RTOL = 1e-6
#: the conv's bias and its velocity: a sum over the minibatch's 28800
#: (B·oy·ox) rows, with cancellation (the largest of the 9 sums is some
#: 1/30 of the sum of its terms' sizes). The reference's f32 reduction on
#: the XLA CPU backend lands 4.8e-6 of the largest element from the
#: float64 sum of the port's own terms, the port's 4.6e-8: the gap is the
#: reference's rounding (PERF.md §6, PR 10)
BIAS_SUM_RTOL = 1e-5
#: every epoch's validation MSE, relative
EPOCH_RTOL = 1e-5


@pytest.fixture
def configs():
    saved = [(r, k, copy.deepcopy(getattr(r, k).to_dict()))
             for r in (jroot, troot) for k in ("mnist_ae", "video_ae")]
    yield
    for r, k, tree in saved:
        getattr(r, k).update(tree)


def ae_pair(jmod, tmod, key, seed, loader=None, max_epochs=3):
    """(reference workflow on -d cpu, port workflow on the CPU) of one AE
    sample at ``seed`` with ``loader`` overrides, both initialized."""
    for r in (jroot, troot):
        cfg = getattr(r, key)
        cfg.loader.update(dict(loader or {}))
        cfg.decision.max_epochs = max_epochs
    jprng.seed_all(seed)
    jw = jmod.create_workflow(name="AEJax")
    jw.initialize(device="cpu")
    tprng.seed_all(seed)
    tw = tmod.create_workflow(name="AETorch")
    return jw, tw.initialize(device="cpu")


def test_same_seed_same_data_and_weights(configs):
    jw, tw = ae_pair(jmnist_ae, tmnist_ae, "mnist_ae", 7, SMALL)
    assert numpy.array_equal(jw.loader.original_data.mem,
                             tw.loader.original_data)
    assert tw.loader.original_targets is tw.loader.original_data
    want = tree_from_jax(jw)
    got = params_to_numpy(tw.export_tree())
    for unit in ("ConvTanh", "Deconv"):
        for key, value in want[unit].items():
            assert numpy.array_equal(got[unit][key], value), (unit, key)
    assert tw.forwards[3].weights.shape == (9, 25 * 1)
    assert isinstance(tw.evaluator, EvaluatorMSE)
    assert isinstance(tw.decision, DecisionMSE)
    assert [f.out_shape for f in tw.forwards[2:]] == [(24, 24, 9),
                                                      (28, 28, 1)]


def test_one_train_step_matches_reference(configs):
    """One train step from the reference's state: every weight and
    velocity within STEP_RTOL of its largest element (the conv's bias
    sums within BIAS_SUM_RTOL), the same MSE."""
    jw, tw = ae_pair(jmnist_ae, tmnist_ae, "mnist_ae", 7, SMALL)
    tw.import_tree(params_from_jax(tree_from_jax(jw)))
    idx_mat, valids = jw.loader.class_schedule(2)
    data = jw.loader.original_data.mem[idx_mat[0]]
    step = jw.xla_step
    fn = step.compiler.compile(step._batch_spec, train=True)
    params, state, outs = fn(
        step.params, step.state,
        {"data": data, "targets": data,
         "batch_size": numpy.int32(valids[0])},
        step._gather_hyper(), jax.random.PRNGKey(0))
    x = torch.from_numpy(data)
    metrics = tw.step.train_minibatch(x, x, torch.tensor(int(valids[0])))
    got = params_to_numpy(tw.export_tree())
    for unit, sub in {**params, **state}.items():
        for key, value in sub.items():
            value = numpy.asarray(value, numpy.float64)
            scale = max(numpy.abs(value).max(), 1e-30)
            diff = numpy.abs(got[unit][key] - value).max() / scale
            rtol = BIAS_SUM_RTOL if key in ("bias", "vel_bias") \
                else STEP_RTOL
            assert diff <= rtol, (unit, key, diff)
    assert abs(float(metrics[0]) - float(outs["loss"])) <= \
        1e-6 * float(outs["loss"])
    assert float(metrics[1]) == 0.0


def _valid_mse(wf):
    return [h["validation"]["metric"] for h in wf.decision.history]


def test_mnist_ae_epochs_match_reference(configs):
    """The reference test's run: every epoch's validation MSE within
    EPOCH_RTOL, falling."""
    jw, tw = ae_pair(jmnist_ae, tmnist_ae, "mnist_ae", 7, SMALL)
    jw.run()
    tw.run()
    want, got = _valid_mse(jw), _valid_mse(tw)
    assert len(got) == 3 and got[-1] < got[0]
    numpy.testing.assert_allclose(got, want, rtol=EPOCH_RTOL)
    assert tw.step.train_steps == 3 * 8 and tw.step.eval_steps == 3 * 2


def test_video_ae_matches_reference(configs):
    """VideoAE at 12 clips (the reference test's size; 2 clips held out),
    3 epochs at seed 21: the same frames, every epoch's validation MSE
    within EPOCH_RTOL, falling."""
    jw, tw = ae_pair(jvideo_ae, tvideo_ae, "video_ae", 21,
                     {"n_clips": 12})
    assert numpy.array_equal(jw.loader.original_data.mem,
                             tw.loader.original_data)
    assert tw.loader.class_lengths == [0, 2 * 16, 10 * 16]
    jw.run()
    tw.run()
    want, got = _valid_mse(jw), _valid_mse(tw)
    assert got[-1] < got[0]
    numpy.testing.assert_allclose(got, want, rtol=EPOCH_RTOL)


def test_cli_trains_and_exports_on_cpu(configs, tmp_path, capsys):
    """``python -m veles_torch mnist_ae.py -d cpu --export-inference DIR``
    trains (the MSE falls) and writes an archive that serves the trained
    forward."""
    out = tmp_path / "archive"
    wf = torch_main([MNIST_AE, "root.mnist_ae.loader.n_train=200",
                     "root.mnist_ae.loader.n_valid=50",
                     "root.mnist_ae.decision.max_epochs=2", "-d", "cpu",
                     "--seed", "5", "--export-inference", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "inference archive -> %s" % out
    last = json.loads(lines[-1])
    mse = [h["validation"]["metric"] for h in last["history"]]
    assert last["device"] == "cpu" and mse[-1] < mse[0]
    rows = wf.loader.original_data[:4]
    served = ArchiveModel.from_dir(str(out), device="cpu")(rows)
    _, want = wf.step._forward(torch.from_numpy(rows), False)
    assert served.shape == (4, 28, 28, 1)
    assert torch.allclose(served, want, rtol=0, atol=1e-6)


def test_cli_asks_for_a_card(configs):
    """Without -d the sample asks for cuda, which a card-less host
    refuses; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main([MNIST_AE, "root.mnist_ae.decision.max_epochs=1"])
