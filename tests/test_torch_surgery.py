"""The port's autoencoder-path units and their satellites against the JAX
package on the CPU: Cutter, Deconv, Depooling (veles_torch/znicz/ops/
cutter.py, deconv.py) and MeanDispNormalizer, built as
tests/test_conv_stack.py builds the reference's (the same seeded numpy
input and error, the reference's initial weights carried across);
``EvaluatorMSE`` with a short last minibatch; the loader normalizers
(veles_torch/normalization.py) and the full-batch loader's use of them;
the ZeroFiller mask through two epochs of MNIST; and the confusion
matrix over two epochs of MNIST."""

import jax.numpy as jnp
import numpy
import pytest
import torch

import veles.prng as jprng
from veles import normalization as JNORM
from veles.accelerated_units import StepCompiler
from veles.backends import XLADevice
from veles.config import root as jroot
from veles.loader.fullbatch import FullBatchLoader as JaxFullBatchLoader
from veles.workflow import Workflow
from veles.znicz_tpu.models import mnist as jmnist
from veles.znicz_tpu.ops import cutter as JCUT
from veles.znicz_tpu.ops import deconv as JDC
from veles.znicz_tpu.ops import evaluator as JE
from veles.znicz_tpu.ops import mean_disp_normalizer as JMD
import veles_torch.prng as tprng
from veles_torch import normalization as TNORM
from veles_torch.backends import TorchDevice
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax, params_to_numpy, \
    tree_from_jax
from veles_torch.loader.base import Loader as TorchLoader
from veles_torch.loader.fullbatch import FullBatchLoader as \
    TorchFullBatchLoader
from veles_torch.znicz.models import mnist as tmnist
from veles_torch.znicz.ops import cutter as TCUT
from veles_torch.znicz.ops import deconv as TDC
from veles_torch.znicz.ops import evaluator as TE
from veles_torch.znicz.ops import mean_disp_normalizer as TMD
from veles_torch.znicz.standard_workflow import StandardWorkflow

from tests.test_all2all import FeedUnit
from tests.test_conv_stack import build, grad_oracle, xla_backward, \
    xla_forward
from tests.test_mnist_ae import _run_mnist as jax_confusion_run
from tests.test_torch_conv import close, port_pair

#: the reference's FWD_CASES of these units (tests/test_conv_stack.py),
#: then a window crop, a strided deconvolution with unequal padding and
#: fewer output channels than kernels, one pinned by
#: ``output_shape_source`` where the stride leaves a remainder row, and
#: depooling with overlapping windows (sliding < k), a cropped output and
#: unequal strides. Input (2, 7, 6, 3): the deconvolutions take K = 3.
CASES = [
    ("Cutter", dict(padding=(1, 1, 2, 1))),
    ("Deconv", dict(n_kernels=3, kx=2, ky=2, sliding=2)),
    ("Depooling", dict(kx=2, ky=2)),
    ("Cutter", dict(y=1, x=2, h=3, w=2)),
    ("Deconv", dict(n_kernels=3, kx=3, ky=2, sliding=(2, 3),
                    padding=(1, 0, 2, 1), n_channels=2)),
    ("Deconv", dict(n_kernels=3, kx=3, ky=3, sliding=2, padding=1,
                    output_shape_source=(2, 14, 12, 4))),
    ("Depooling", dict(kx=3, ky=3, sliding=2)),
    ("Depooling", dict(kx=2, ky=2, output_shape_source=(2, 13, 11, 3))),
    ("Depooling", dict(kx=3, ky=2, sliding=(1, 2))),
]
_MODULES = ((JCUT, TCUT), (JDC, TDC))


def _classes(name):
    for jmod, tmod in _MODULES:
        if hasattr(jmod, name):
            return getattr(jmod, name), getattr(tmod, name)
    raise KeyError(name)


def _ids(case):
    name, kwargs = case
    return "%s-%s" % (name, "-".join("%s=%s" % kv
                                     for kv in sorted(kwargs.items())))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_unit_matches_reference(case):
    """Forward output, err_input and the updated weights (learning rate
    1: ``w − grad``) against the reference's traced units, within ATOL
    (2e-5, f32 summation order)."""
    name, kwargs = case
    jcls, tcls = _classes(name)
    wf, feed, jf, jg, x, err, comp = build(jcls, gd_kwargs={}, **kwargs)
    params0 = comp.gather_params()
    want_y = xla_forward(comp, feed, jf, params0, x)
    want_ei, params1 = xla_backward(comp, feed, jf, jg, params0,
                                    comp.gather_state(), x, err)
    fwd, gd = port_pair(tcls, kwargs, x.shape, params0.get(jf.name, {}))
    xt = torch.from_numpy(x.astype(numpy.float32))
    y = fwd(xt)
    close(y, want_y)
    ei = gd.run(xt, y, torch.from_numpy(err.astype(numpy.float32)))
    close(ei, want_ei)
    assert set(params1.get(jf.name, {})) == set(fwd.export_params())
    for key, value in params1.get(jf.name, {}).items():
        close(getattr(fwd, key), value)


def test_deconv_refuses_a_shape_that_does_not_convolve_back():
    f = TDC.Deconv(n_kernels=3, kx=3, ky=3, sliding=2,
                   output_shape_source=(2, 20, 12, 4))
    with pytest.raises(ValueError, match="convolve back"):
        f.initialize((2, 7, 6, 3), TorchDevice("cpu"))
    with pytest.raises(ValueError, match="no bias"):
        TDC.Deconv(n_kernels=3, kx=2, ky=2, include_bias=True)


def _mean_disp_pair():
    """The reference's MeanDispNormalizer on a seeded (2, 7, 6, 3) input,
    per-feature mean and rdisp, traced on the CPU; -> (comp, feed, unit,
    x, err, mean, rdisp)."""
    jprng.seed_all(31)
    wf = Workflow(None, name="wf")
    gen = jprng.get("cs")
    x = gen.normal(0, 1.0, (2, 7, 6, 3))
    mean = gen.normal(0, 1.0, (7, 6, 3)).astype(numpy.float32)
    rdisp = gen.uniform(0.5, 2.0, (7, 6, 3)).astype(numpy.float32)
    feed = FeedUnit(wf, x)
    fwd = JMD.MeanDispNormalizer(wf)
    fwd.mean.reset(mean)
    fwd.rdisp.reset(rdisp)
    fwd.link_attrs(feed, ("input", "minibatch_data"))
    fwd.initialize(device=None)
    # upload mean and rdisp outside any trace: their first upload inside
    # one would cache a tracer in the Array
    fwd.mean.devmem, fwd.rdisp.devmem
    err = gen.normal(0, 1.0, x.shape)
    comp = StepCompiler([fwd], XLADevice(platform="cpu"))
    return comp, feed, fwd, x, err, mean, rdisp


def test_mean_disp_normalizer_matches_reference():
    """Forward against the reference's traced unit; the backward (the
    reference has no GD unit for it) against jax.grad of that forward;
    no parameters; refused without mean/rdisp."""
    comp, feed, jf, x, err, mean, rdisp = _mean_disp_pair()
    params = comp.gather_params()
    want_y = xla_forward(comp, feed, jf, params, x)
    _, want_ei = grad_oracle(comp, feed, jf, params, x, err)
    fwd, gd = port_pair(TMD.MeanDispNormalizer,
                        dict(mean=mean, rdisp=rdisp), x.shape, {})
    xt = torch.from_numpy(x.astype(numpy.float32))
    y = fwd(xt)
    close(y, want_y)
    close(gd.run(xt, y, torch.from_numpy(err.astype(numpy.float32))),
          want_ei)
    assert fwd.export_params() == {}
    with pytest.raises(ValueError, match="mean and rdisp"):
        TMD.MeanDispNormalizer().initialize(x.shape, TorchDevice("cpu"))


def test_gd_cutter_without_err_input():
    """The first unit of a stack passes nothing back."""
    fwd, gd = port_pair(TCUT.Cutter, dict(y=1, x=1), (2, 5, 5, 3), {},
                        gd_kwargs={"need_err_input": False})
    x = torch.ones(2, 5, 5, 3)
    assert gd.run(x, fwd(x), torch.ones(2, 4, 4, 3)) is None


# -- EvaluatorMSE ---------------------------------------------------------


def test_evaluator_mse_short_minibatch():
    """6 rows of which 4 are valid: err = 2·(y − t)/4 on the valid rows
    and 0 on the pad rows, the MSE over the valid rows, the worst valid
    row and its index — against the reference's traced math, within 1e-6
    (f32, the same operations)."""
    rng = numpy.random.default_rng(12)
    y = rng.normal(0, 1, (6, 4, 4, 2)).astype(numpy.float32)
    t = rng.normal(0, 1, (6, 4, 4, 2)).astype(numpy.float32)
    y[5] += 10.0          # a pad row with the largest error: never seen
    ref = JE.EvaluatorMSE.__new__(JE.EvaluatorMSE)
    w_err, w_mse, w_max, w_idx = (numpy.asarray(v) for v in ref._compute(
        jnp, jnp.asarray(y), jnp.asarray(t), jnp.float32(4)))
    err, metrics = TE.EvaluatorMSE().run(
        torch.from_numpy(y), torch.from_numpy(t), torch.tensor(4),
        torch.float32)
    assert err.shape == y.shape and err.dtype == torch.float32
    close(err.reshape(6, -1), w_err, 1e-6)
    assert not err[4:].any()
    loss, n_err, max_err, max_idx = metrics.tolist()
    assert abs(loss - float(w_mse)) <= 1e-6 * abs(float(w_mse))
    assert n_err == 0.0
    assert abs(max_err - float(w_max)) <= 1e-6 * abs(float(w_max))
    assert int(max_idx) == int(w_idx) < 4
    assert TE.EvaluatorMSE.TARGET == "targets"
    assert TE.EvaluatorSoftmax.TARGET == TE.EvaluatorLM.TARGET == "labels"


# -- normalizers ----------------------------------------------------------

NORMALIZERS = [
    ("none", {}), ("linear", {"interval": (-2.0, 3.0)}),
    ("range_linear", {"source_range": (0.0, 10.0)}), ("mean_disp", {}),
    ("pointwise", {}),
    ("external_mean", {"mean": numpy.linspace(0, 1, 12), "scale": 0.5})]


@pytest.mark.parametrize("name,kwargs", NORMALIZERS,
                         ids=[n for n, _ in NORMALIZERS])
def test_normalizer_matches_reference(name, kwargs):
    """Analyzed in two batches, each normalizer gives the reference's
    array bit for bit (the same numpy operations), and so does its
    (mean, rdisp) form; its state restores in the port and in the
    reference."""
    rng = numpy.random.default_rng(3)
    data = rng.normal(3.0, 2.0, (50, 12)).astype(numpy.float32)
    data[:, 0] = 7.0                    # a constant feature
    jn = JNORM.factory(name, **kwargs)
    tn = TNORM.factory(name, **kwargs)
    assert type(tn).NAME == name and set(TNORM.NORMALIZERS) == \
        set(JNORM.NORMALIZERS)
    for part in (data[:25], data[25:]):
        jn.analyze(part)
        tn.analyze(part)
    want = jn.normalize(data)
    assert numpy.array_equal(tn.normalize(data), want)
    if name != "pointwise":             # not affine at constant features
        for a, b in zip(tn.mean_rdisp(data.shape[1:]),
                        jn.mean_rdisp(data.shape[1:])):
            assert numpy.array_equal(a, b)
    state = tn.state()
    assert state["__name__"] == name
    for restored in (TNORM.from_state(state), JNORM.from_state(state)):
        assert numpy.array_equal(restored.normalize(data), want)
    assert numpy.array_equal(
        TNORM.from_state(jn.state()).normalize(data), want)


def _port_loader(data, targets=None, **kwargs):
    ld = TorchFullBatchLoader(minibatch_size=10, **kwargs)
    ld.original_data = data
    ld.original_targets = data if targets is None else targets
    ld.class_lengths = [0, 10, 20]
    return ld


def test_full_batch_loader_normalizes_like_reference():
    """``normalization_type`` on the full-batch loader: fitted on the
    train rows, the resident data equal to the reference's; targets that
    alias the data follow it and are uploaded once (one device tensor
    under both keys), separate targets keep their scale."""
    rng = numpy.random.default_rng(8)
    data = rng.uniform(0, 255, (30, 8)).astype(numpy.float32)
    jld = JaxFullBatchLoader(Workflow(None, name="w"), name="loader",
                             minibatch_size=10,
                             normalization_type="mean_disp")
    jld.original_data.mem = data.copy()
    jld.original_targets.mem = jld.original_data.mem
    jld.class_lengths = [0, 10, 20]
    jld.initialize()
    ld = _port_loader(data.copy(), normalization_type="mean_disp")
    ld.initialize()
    assert numpy.array_equal(ld.original_data, jld.original_data.mem)
    assert ld.original_targets is ld.original_data
    full = ld.device_full_arrays("cpu")
    assert full["targets"] is full["data"]
    targets = rng.normal(0, 1, (30, 2)).astype(numpy.float32)
    ld2 = _port_loader(data.copy(), targets=targets,
                       normalization_type="linear")
    ld2.initialize()
    assert ld2.original_targets is targets
    assert ld2.original_data[10:].min() == pytest.approx(-1.0, abs=1e-5)
    ld2.initialize()                    # applied once
    assert ld2.original_data[10:].max() == pytest.approx(1.0, abs=1e-5)


def test_loader_without_normalization_refuses_it():
    """A loader that cannot apply a normalizer fails loudly, as the
    reference's does; an unknown name is refused at construction."""
    class Plain(TorchLoader):
        def load_data(self):
            self.class_lengths = [0, 2, 4]

    with pytest.raises(NotImplementedError, match="normalization"):
        Plain(normalization_type="mean_disp").initialize()
    Plain().initialize()
    with pytest.raises(KeyError, match="unknown normalization_type"):
        Plain(normalization_type="bogus")


# -- ZeroFiller and the confusion matrix on MNIST -------------------------

#: the reference test's MNIST run (tests/test_mnist_functional.py:
#: test_zerofiller_pins_weights): minibatch 20, 100/40 samples, 2 epochs
ZF_SIZES = {"minibatch_size": 20, "n_train": 100, "n_valid": 40}


@pytest.fixture
def mnist_configs():
    saved = [(r, r.mnist.to_dict()) for r in (jroot, troot)]
    yield
    for r, tree in saved:
        r.mnist.update(tree)


def test_zero_filler_matches_reference(mnist_configs):
    """A ZeroFiller on the first layer, its mask (every other row 0) set
    after initialize in both packages, carried across by
    ``tree_from_jax``: after two epochs the masked entries are exactly 0
    in both, and every parameter and velocity agrees within 1e-4 (as the
    one-epoch MNIST test)."""
    for r in (jroot, troot):
        r.mnist.loader.update(ZF_SIZES)
        r.mnist.decision.max_epochs = 2
    jprng.seed_all(11)
    jw = jmnist.create_workflow(name="ZeroFillJax")
    zf = JCUT.ZeroFiller(jw, target=jw.forwards[0], name="zerofiller")
    zf.link_from(jw.gds[0])
    jw.initialize(device="cpu")
    mask = numpy.ones_like(jw.forwards[0].weights.mem)
    mask[::2, :] = 0.0
    zf.mask.map_write()
    zf.mask.mem[...] = mask
    tprng.seed_all(11)
    tw = tmnist.create_workflow(name="ZeroFillTorch")
    tzf = tw.link_zero_filler(0)
    tw.initialize(device="cpu")
    tw.import_tree(params_from_jax(tree_from_jax(jw)))
    assert torch.equal(tzf.mask, torch.from_numpy(mask))
    jw.run()
    tw.run()
    want = tree_from_jax(jw)
    got = params_to_numpy(tw.export_tree())
    assert sorted(want) == sorted(got)
    for unit, sub in want.items():
        assert sorted(sub) == sorted(got[unit]), unit
        for key, value in sub.items():
            diff = numpy.abs(got[unit][key] - numpy.asarray(value)).max()
            assert diff <= 1e-4, (unit, key, diff)
    w = got["All2AllTanh"]["weights"]
    assert numpy.all(w[::2, :] == 0.0) and numpy.any(w[1::2, :] != 0.0)
    assert numpy.all(numpy.asarray(want["All2AllTanh"]["weights"])[::2]
                     == 0.0)


def test_zero_filler_masks_the_initial_weights():
    """Given before initialize, the mask applies to the initial weights
    too; an edit in place reaches the next update."""
    tprng.seed_all(2)
    tw = tmnist.create_workflow(name="ZeroFillInit")
    mask = numpy.ones((784, 100), numpy.float32)
    mask[:, ::3] = 0.0
    zf = tw.link_zero_filler(tw.forwards[0], mask=mask)
    tw.initialize(device="cpu")
    w = tw.forwards[0].weights
    assert not w[:, ::3].any() and w[:, 1::3].all()
    zf.mask[0] = 0.0
    gd = tw.gds[0]
    gd.update_weights(torch.ones_like(w), None)
    assert not tw.forwards[0].weights[0].any()


def test_confusion_matrix_matches_reference(mnist_configs):
    """EvaluatorSoftmax(compute_confusion=True) over two epochs of MNIST
    (the reference test's run: 300/100, minibatch 50, seed 31): the
    matrix accumulated on the device equals the reference's traced one
    cell for cell, over every served minibatch of both classes."""
    jw = jax_confusion_run("cpu", "EvJax")
    want = jw.evaluator.confusion_matrix.map_read().mem
    tprng.seed_all(31)
    tw = StandardWorkflow(
        name="EvTorch", layers=troot.mnist.layers,
        loader_factory=lambda w: tmnist.MnistLoader(
            w, name="loader", minibatch_size=50, n_train=300, n_valid=100),
        evaluator_factory=lambda w: TE.EvaluatorSoftmax(
            compute_confusion=True),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    tw.initialize(device="cpu").run()
    got = tw.evaluator.confusion_matrix
    assert got.dtype == torch.int32
    assert int(got.sum()) == int(want.sum()) == 2 * 400
    assert numpy.array_equal(got.numpy(), want)
