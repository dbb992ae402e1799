"""The port's conv samples (veles_torch/znicz/models: cifar10, imagenet)
against the JAX package's on the CPU.

CIFAR-10 (the reference's sample, BASELINE config #2): the same seed
gives the same normalized images, initial weights and shuffle bit for
bit; one train step from the reference's state lands within
``STEP_ATOL`` of its parameters and velocities; 3 epochs at the
reference test's settings (tests/test_cifar_functional.py: 600/200
images, minibatch 50, lr 0.01, moment 0.5) end within
``CIFAR_EPOCHS_TOL`` of its validation error.

AlexNet at the reference's reduced geometry (tests/test_grad_end_to_end.py:
scale 75, crop 67, minibatch 8, 4 classes, dropout 0, every width in
full): the synthetic bank and the transformed batches (train and eval)
bit for bit against the reference's ``_augment``, and one train step
within ``ALEX_RTOL`` of each parameter's and velocity's largest element.

Both samples also run through the port's CLI on ``-d cpu``, and without
``-d`` they ask for a card, which a card-less host refuses. Trees of
PNG, baseline/progressive JPEG and arithmetic-coded JPEG files stream
AlexNet through the file loader; on the arithmetic-coded tree the
reference's streamed conv net trains as the reference's does."""

import copy
import json
import os

import jax
import numpy
import pytest
import torch

import veles.prng as jprng
from veles.config import root as jroot
from veles.znicz_tpu.models import cifar10 as jcifar
from veles.znicz_tpu.models import imagenet as jimagenet
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.znicz.models import cifar10 as tcifar
from veles_torch.znicz.models import imagenet as timagenet
from veles_torch.znicz.standard_workflow import \
    StandardWorkflow as TorchStandardWorkflow
from tests.torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "veles_torch", "znicz", "models")
#: one CIFAR train step: parameters and velocities in absolute terms
#: (f32 convolutions summed in another order; observed 1.5e-8)
STEP_ATOL = 1e-6
#: final validation error after 3 epochs, port against reference (the
#: reference's own numpy-vs-XLA bar is 0.08; observed 0.0)
CIFAR_EPOCHS_TOL = 0.02
#: one AlexNet step: each parameter and velocity against its largest
#: element (f32 sums in another order through 8 layers; observed 2.5e-6,
#: on a velocity)
ALEX_RTOL = 1e-4
#: one CIFAR step under the card's bf16 policy, against each tensor's
#: largest element. Two things set it apart from f32: (1) the reference's
#: default conv bias gradient sums dz rounded to bf16 (``ones @ dz`` of
#: bf16 operands), the port's kernel sums the f32 products, as the
#: reference's ``fused_bias_grad`` hatch (the Pallas kernel) does, so the
#: reference runs with that hatch on here; (2) bf16 rounding of the
#: activations turns f32 summation-order differences into whole bf16
#: steps on a few elements. Perturbing only the port's convolution sums
#: (float64, then rounded) moves its own step by 4.9e-3 of a velocity's
#: largest element, more than its gap to the reference (2.5e-3, on the
#: first conv's bias), which the test also holds; with the hatch off the
#: second conv's bias reads 1.15e-3 against 1.1e-4 with it on (printed by
#: the test with -s)
BF16_STEP_RTOL = 1e-2
#: the reference test's CIFAR settings
CIFAR_SMALL = {"n_train": 600, "n_valid": 200, "minibatch_size": 50}
#: the reference test's reduced AlexNet geometry
ALEX_SMALL = {"minibatch_size": 8, "n_train": 32, "n_valid": 16,
              "n_classes": 4, "scale": (75, 75), "crop": (67, 67)}


@pytest.fixture
def configs():
    """Save and restore ``root.cifar`` / ``root.imagenet`` of both
    packages."""
    saved = [(r, copy.deepcopy(getattr(r, k).to_dict()))
             for r in (jroot, troot) for k in ("cifar", "imagenet")]
    yield
    for (r, tree), key in zip(saved, ("cifar", "imagenet") * 2):
        getattr(r, key).update(tree)


def set_cifar(epochs, lr=0.01, moment=0.5):
    for r in (jroot, troot):
        r.cifar.loader.update(CIFAR_SMALL)
        r.cifar.decision.max_epochs = epochs
        for layer in r.cifar.layers:
            if "<-" in layer:
                layer["<-"]["learning_rate"] = lr
                layer["<-"]["gradient_moment"] = moment


def cifar_pair(epochs, seed=2024):
    jprng.seed_all(seed)
    jw = jcifar.create_workflow(name="JaxCifar")
    jw.initialize(device="cpu")
    tprng.seed_all(seed)
    tw = tcifar.create_workflow(name="TorchCifar").initialize(device="cpu")
    return jw, tw


def alex_layers():
    layers = jimagenet.alexnet_layers(ALEX_SMALL["n_classes"])
    for layer in layers:
        if layer["type"] == "dropout":
            layer["->"]["dropout_ratio"] = 0.0
    return layers


def alex_pair(seed=2929):
    for r in (jroot, troot):
        r.imagenet.loader.update(ALEX_SMALL)
    jprng.seed_all(seed)
    jw = JaxStandardWorkflow(
        None, name="JaxAlex", layers=alex_layers(),
        loader_factory=jimagenet.make_loader,
        decision_config={"max_epochs": 1})
    jw.initialize(device="cpu")
    tprng.seed_all(seed)
    tw = TorchStandardWorkflow(
        name="TorchAlex", layers=alex_layers(),
        loader_factory=timagenet.make_loader,
        decision_config={"max_epochs": 1})
    return jw, tw.initialize(device="cpu")


def jax_tree(wf):
    """{unit: {key: ndarray}} of the reference's params and state (units
    without either left out)."""
    tree = {u.name: {**u.export_params(), **u.export_state()}
            for u in wf.forwards + wf.gds}
    return {u: sub for u, sub in tree.items() if sub}


def one_step(jw, tw, data, torch_data, labels, valid):
    """One train step of both from the reference's state -> (reference
    tree, port tree, reference outputs, port metrics)."""
    tw.import_tree(params_from_jax(jax_tree(jw)))
    step = jw.xla_step
    fn = step.compiler.compile(step._batch_spec, train=True)
    params, state, outs = fn(
        step.params, step.state,
        {"data": data, "labels": labels, "batch_size": numpy.int32(valid)},
        step._gather_hyper(), jax.random.PRNGKey(0))
    metrics = tw.step.train_minibatch(
        torch_data, torch.from_numpy(labels.astype(numpy.int64)),
        torch.tensor(int(valid)))
    want = {u: {k: numpy.asarray(v) for k, v in
                {**params.get(u, {}), **state.get(u, {})}.items()}
            for u in set(params) | set(state)}
    return ({u: s for u, s in want.items() if s},
            params_to_numpy(tw.export_tree()), outs, metrics)


def worst(want, got, relative):
    """Largest difference over every tensor (relative: to the tensor's
    largest element); -> (diff, unit, key)."""
    assert sorted(want) == sorted(got)
    out = (0.0, "", "")
    for unit, sub in want.items():
        assert sorted(sub) == sorted(got[unit]), unit
        for key, value in sub.items():
            value = numpy.asarray(value, numpy.float64)
            d = numpy.abs(got[unit][key] - value).max()
            if relative:
                d /= max(numpy.abs(value).max(), 1e-30)
            out = max(out, (d, unit, key))
    return out


def test_cifar_same_data_weights_and_shuffle(configs):
    set_cifar(1)
    jw, tw = cifar_pair(1)
    assert numpy.array_equal(jw.loader.original_data.mem,
                             tw.loader.original_data)
    assert numpy.array_equal(jw.loader.original_labels.mem,
                             tw.loader.original_labels)
    jt, tt = jax_tree(jw), params_to_numpy(tw.export_tree())
    for unit in ("ConvRELU", "ConvRELU_2", "All2AllSoftmax"):
        for key in ("weights", "bias"):
            assert numpy.array_equal(jt[unit][key], tt[unit][key])
    assert numpy.array_equal(jw.loader.class_schedule(2)[0],
                             tw.loader.class_schedule(2)[0])


def test_cifar_one_train_step(configs):
    """Weights, biases and velocities within STEP_ATOL; the step's loss
    to 1e-5 and the same error count."""
    set_cifar(1)
    jw, tw = cifar_pair(1)
    idx_mat, valids = jw.loader.class_schedule(2)
    data = jw.loader.original_data.mem[idx_mat[0]]
    labels = jw.loader.original_labels.mem[idx_mat[0]]
    want, got, outs, metrics = one_step(
        jw, tw, data, torch.from_numpy(data), labels, valids[0])
    diff = worst(want, got, relative=False)
    assert diff[0] <= STEP_ATOL, diff
    assert abs(float(outs["loss"]) - float(metrics[0])) < 1e-5
    assert int(outs["n_err"]) == int(metrics[1])


def bf16_cifar_step(monkeypatch, fused, f64_convs=False):
    """One CIFAR step of both packages under ``amp = compute_dtype =
    bfloat16``, the reference's GD units with ``fused_bias_grad=fused``,
    the port's convolutions summed in float64 (then rounded) with
    ``f64_convs``; -> :func:`one_step`'s result."""
    set_cifar(1)
    for layer in jroot.cifar.layers:
        if "<-" in layer:
            layer["<-"]["fused_bias_grad"] = fused
    try:
        for r in (jroot, troot):
            r.common.engine.amp = r.common.engine.compute_dtype = "bfloat16"
        jw, tw = cifar_pair(1)
        if f64_convs:
            def conv2d_f64(self, x, w, stride, padding):
                x, w = self._conv_operands(x, w)
                return torch.nn.functional.conv2d(
                    x.double(), w.double(), stride=stride,
                    padding=padding).float()
            monkeypatch.setattr(type(tw.device), "conv2d", conv2d_f64)
        idx_mat, valids = jw.loader.class_schedule(2)
        data = jw.loader.original_data.mem[idx_mat[0]]
        labels = jw.loader.original_labels.mem[idx_mat[0]]
        return one_step(jw, tw, data, torch.from_numpy(data), labels,
                        valids[0])
    finally:
        for r in (jroot, troot):
            r.common.engine.amp = r.common.engine.compute_dtype = None
        monkeypatch.undo()


def test_cifar_one_train_step_bf16_policy(configs, monkeypatch):
    """Under the bf16 policy in both packages, against the reference with
    ``fused_bias_grad=True`` (the form of the port's kernel): every
    parameter and velocity within BF16_STEP_RTOL of its largest element;
    the gap no larger than the port's own move when only its convolution
    sums change order; the loss to 1e-4 and the same error count. Without
    the hatch the reference's second conv bias (a sum of bf16-rounded dz)
    lies at least 5 times further from the port's."""
    want, got, outs, metrics = bf16_cifar_step(monkeypatch, True)
    _, moved, _, _ = bf16_cifar_step(monkeypatch, True, f64_convs=True)
    unfused, got2, _, _ = bf16_cifar_step(monkeypatch, False)
    gap = worst(want, got, relative=True)
    floor = max(
        numpy.abs(moved[u][k] - got[u][k]).max()
        / max(numpy.abs(numpy.asarray(want[u][k])).max(), 1e-30)
        for u in want for k in want[u])

    def bias_gap(ref, port):
        b = numpy.asarray(ref["ConvRELU_2"]["bias"], numpy.float64)
        return numpy.abs(port["ConvRELU_2"]["bias"] - b).max() \
            / numpy.abs(b).max()

    fused_bias, unfused_bias = bias_gap(want, got), bias_gap(unfused, got2)
    print("bf16 CIFAR step: gap %.3g (%s.%s), floor %.3g, second conv "
          "bias %.3g fused / %.3g unfused" % (gap[0], gap[1], gap[2],
                                              floor, fused_bias,
                                              unfused_bias))
    assert gap[0] <= BF16_STEP_RTOL, gap
    assert gap[0] <= floor, (gap, floor)
    assert unfused_bias >= 5 * fused_bias, (unfused_bias, fused_bias)
    assert abs(float(outs["loss"]) - float(metrics[0])) < 1e-4
    assert int(outs["n_err"]) == int(metrics[1])


def test_cifar_three_epochs(configs):
    """The reference test's settings for 3 epochs: the port's validation
    error falls, stays below the reference's 0.55 bar and ends within
    CIFAR_EPOCHS_TOL of the JAX package's."""
    set_cifar(3)
    jw, tw = cifar_pair(3)
    jw.run()
    tw.run()
    hist = [h["validation"]["metric"] for h in tw.decision.history]
    err_j = jw.decision.history[-1]["validation"]["metric"]
    assert len(hist) == 3 and hist[-1] < hist[0] and hist[-1] < 0.55, hist
    assert abs(hist[-1] - err_j) <= CIFAR_EPOCHS_TOL, (hist, err_j)


def test_alexnet_bank_and_transform_bit_for_bit(configs):
    """The uint8 bank, its labels and the train/eval transforms of a
    minibatch equal the reference's (``_augment`` in numpy)."""
    jw, tw = alex_pair()
    bank = jw.loader.original_data.mem
    assert bank.dtype == numpy.uint8
    assert numpy.array_equal(bank, tw.loader.original_data)
    assert numpy.array_equal(jw.loader.original_labels.mem,
                             tw.loader.original_labels)
    full = tw.loader.device_full_arrays("cpu")["data"]
    assert full.dtype == torch.uint8
    idx = jw.loader.class_schedule(2)[0][0]
    for train in (True, False):
        want = jw.loader._augment(numpy, bank[idx], train=train)
        got = tw.loader.batch_transform(
            torch.index_select(full, 0, torch.from_numpy(idx).long()), train)
        assert got.dtype == torch.float32
        assert numpy.array_equal(got.numpy(), want), train
    assert tw.loader.sample_shape() == (67, 67, 3)


def test_alexnet_one_train_step(configs):
    """The whole stack — conv/s4, LRN, overlapping pools, dropout 0, FC
    4096 — one train step from the reference's state: every parameter
    and velocity within ALEX_RTOL of its largest element; the same loss
    to 1e-5."""
    jw, tw = alex_pair()
    idx_mat, valids = jw.loader.class_schedule(2)
    bank = jw.loader.original_data.mem
    data = jw.loader._augment(numpy, bank[idx_mat[0]], train=True)
    torch_data = tw.loader.batch_transform(
        torch.from_numpy(bank[idx_mat[0]]), True)
    labels = jw.loader.original_labels.mem[idx_mat[0]]
    want, got, outs, metrics = one_step(jw, tw, data, torch_data, labels,
                                        valids[0])
    assert "MaxPooling_3" in [f.name for f in tw.forwards]
    diff = worst(want, got, relative=True)
    assert diff[0] <= ALEX_RTOL, diff
    assert abs(float(outs["loss"]) - float(metrics[0])) < 1e-5


@pytest.mark.parametrize("sample,overrides", [
    ("cifar10.py", ["root.cifar.loader.n_train=100",
                    "root.cifar.loader.n_valid=50",
                    "root.cifar.loader.minibatch_size=50",
                    "root.cifar.decision.max_epochs=2"]),
    ("imagenet.py", ["root.imagenet.loader.n_train=16",
                     "root.imagenet.loader.n_valid=8",
                     "root.imagenet.loader.minibatch_size=8",
                     "root.imagenet.loader.n_classes=4",
                     "root.imagenet.loader.scale=(75, 75)",
                     "root.imagenet.loader.crop=(67, 67)",
                     "root.imagenet.decision.max_epochs=2"])],
    ids=["cifar10", "imagenet"])
def test_entry_point(configs, capsys, sample, overrides):
    """The sample trains through ``python -m veles_torch ... -d cpu``
    (the last stdout line is the JSON history); without ``-d`` it asks
    for a card, which a card-less host refuses."""
    path = os.path.join(MODELS, sample)
    wf = torch_main([path, *overrides, "-d", "cpu", "--seed", "5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"] == "cpu" and len(last["history"]) == 2
    assert all(numpy.isfinite(h["train"]["loss"]) for h in last["history"])
    assert wf.step.train_steps == 2 * (
        wf.loader.class_lengths[2] // wf.loader.max_minibatch_size)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main([path, *overrides])


def _image_tree(base, n_classes, per_class, fmt, shape=(80, 90, 3)):
    """``base/c<k>/i<j>.<fmt>``: noisy solid colours, one per class."""
    from PIL import Image
    gen = numpy.random.Generator(numpy.random.PCG64(41))
    for k in range(n_classes):
        d = base / ("c%d" % k)
        d.mkdir()
        colour = gen.integers(0, 256, 3)
        for j in range(per_class):
            arr = numpy.clip(colour + gen.normal(0, 20, shape), 0,
                             255).astype(numpy.uint8)
            Image.fromarray(arr).save(d / ("i%02d.%s" % (j, fmt)))


TREE_OVERRIDES = ["root.imagenet.loader.minibatch_size=8",
                  "root.imagenet.loader.scale=(75, 75)",
                  "root.imagenet.loader.crop=(67, 67)",
                  "root.imagenet.decision.max_epochs=2"]


#: the committed arithmetic-coded tree images (tests/data/jpeg: SOF9 and
#: SOF10 files holding the coefficients of tree_NN.jpg)
JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")


def _arith_tree(base, n_classes, per_class):
    """``base/n<k>/n<k>_<j>.JPEG``: the arithmetic-coded tree fixtures,
    ``per_class`` distinct images a class."""
    import shutil
    for k in range(n_classes):
        d = base / ("n%08d" % k)
        d.mkdir()
        for j in range(per_class):
            shutil.copyfile(
                os.path.join(JPEG_FIXTURES, "arith_tree_%02d.jpg"
                             % (k * per_class + j)),
                d / ("n%08d_%d.JPEG" % (k, j)))


@pytest.fixture
def native_decode(tmp_path_factory, monkeypatch):
    """The image loaders on the native decode routines (g++-built), as
    on the card: the tree images are not the twins' to decode."""
    from veles_torch.loader import image, jpeg
    from tests.torch_native import build_image_decode
    lib = build_image_decode(tmp_path_factory.mktemp("image_decode"))
    monkeypatch.setattr(jpeg, "native_library", lambda: lib)
    monkeypatch.setattr(image.ImageLoaderBase, "native_decode",
                        property(lambda self: True))
    return jpeg


def test_real_imagenet_tree_is_refused(configs, tmp_path, native_decode,
                                       capsys):
    """The name is kept from the test this one replaced, which held that
    the port refused such a tree; what it checks now is that the tree
    streams. A tree of arithmetic-coded JPEG files, sequential and
    progressive, streams through the file loader, decoded natively with
    no twin scan: the reference test's conv net trains 2 epochs on it as
    the reference trains (tests/test_torch_image_loader.py's
    ``CONV_RTOL``, the same error counts), and the AlexNet sample trains
    on it through the CLI on ``-d cpu``, the softmax width from the
    tree."""
    from tests.test_torch_image_loader import CONV_RTOL, LAYERS
    from veles.loader.image import AutoLabelFileImageLoader as JaxAuto
    from veles_torch.loader.image import AutoLabelFileImageLoader
    jpeg = native_decode
    _arith_tree(tmp_path, 3, 5)

    def loader_kw():
        return dict(base_dir=str(tmp_path), name="loader", scale=(32, 32),
                    crop=(28, 28), mirror="random", minibatch_size=4)
    jprng.seed_all(11)
    jw = JaxStandardWorkflow(
        None, name="JaxArithTree", layers=LAYERS,
        loader_factory=lambda w: JaxAuto(w, **loader_kw()),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    jw.initialize(device="cpu")
    tprng.seed_all(11)
    tw = TorchStandardWorkflow(
        name="TorchArithTree", layers=LAYERS,
        loader_factory=lambda w: AutoLabelFileImageLoader(w, **loader_kw()),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    tw.initialize(device="cpu")
    before = dict(jpeg.scans)
    try:
        start = {u.name: {**u.export_params(), **u.export_state()}
                 for u in jw.forwards + jw.gds}
        tw.import_tree(params_from_jax(
            {u: s for u, s in start.items() if s}))
        jw.run()
        tw.run()
        assert tw.loader.supports_streaming and tw.loader.native_decode
        got = params_to_numpy(tw.export_tree())
        for u in jw.forwards + jw.gds:
            for key, value in {**u.export_params(),
                               **u.export_state()}.items():
                value = numpy.asarray(value, numpy.float64)
                rel = numpy.abs(got[u.name][key] - value).max() \
                    / max(numpy.abs(value).max(), 1e-30)
                assert rel <= CONV_RTOL, (u.name, key, rel)
        for jh, th in zip(jw.decision.history, tw.decision.history):
            for cls in ("validation", "train"):
                assert round(jh[cls]["metric"] * jh[cls]["samples"]) == \
                    round(th[cls]["metric"] * th[cls]["samples"]), cls
    finally:
        tw.close()
        jw.loader.stop()
    scans = {k: jpeg.scans[k] - before[k] for k in jpeg.scans}
    assert scans["python"] == 0 and scans["native_arithmetic"] > 0, scans
    assert scans["native_huffman"] == scans["native_lossless"] == 0, scans
    # at the sample's learning rate AlexNet's loss spikes on so small a
    # tree, and the health monitor's SLO alert would log past the test
    wf = torch_main([os.path.join(MODELS, "imagenet.py"),
                     "root.imagenet.loader.base_dir=%s" % tmp_path,
                     *TREE_OVERRIDES, "root.imagenet.lr=0.001", "-d", "cpu",
                     "--seed", "5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert type(wf.loader).__name__ == "AutoLabelFileImageLoader"
    assert wf.forwards[-1].output_sample_shape in (3, (3,))
    assert all(numpy.isfinite(h["train"]["loss"]) for h in last["history"])
    assert jpeg.scans["python"] == before["python"]


def test_jpeg_imagenet_tree_trains_in_stream_mode(configs, tmp_path,
                                                  capsys):
    """A staged tree of ``*.JPEG`` files (4 classes × 10 images of 80×90)
    trains AlexNet through AutoLabelFileImageLoader in stream mode on
    ``-d cpu``, as a PNG tree does: the split, finite losses, uint8
    windows."""
    _image_tree(tmp_path, 4, 10, "JPEG")
    wf = torch_main([os.path.join(MODELS, "imagenet.py"),
                     "root.imagenet.loader.base_dir=%s" % tmp_path,
                     *TREE_OVERRIDES, "-d", "cpu", "--seed", "5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not wf.loader.native_decode      # the twins on -d cpu
    assert wf.loader.class_lengths == [0, 4, 36]
    assert all(numpy.isfinite(h["train"]["loss"]) for h in last["history"])
    assert wf.step.train_steps == 2 * 5 and wf.step.eval_steps == 2
    assert wf.step.uploader.bytes == 2 * (8 + 40) * (67 * 67 * 3 + 4)


def test_png_imagenet_tree_trains_in_stream_mode(configs, tmp_path,
                                                 capsys):
    """A PNG tree (4 classes × 10 images of 80×90, resized to 75×75 and
    cropped to 67) trains AlexNet through AutoLabelFileImageLoader in
    stream mode on ``-d cpu``: the stride split (1 in 10 held out), the
    softmax width from the tree, finite losses, uint8 windows uploaded."""
    _image_tree(tmp_path, 4, 10, "png")
    wf = torch_main([os.path.join(MODELS, "imagenet.py"),
                     "root.imagenet.loader.base_dir=%s" % tmp_path,
                     *TREE_OVERRIDES, "-d", "cpu", "--seed", "5"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert wf.loader.supports_streaming
    assert wf.loader.class_lengths == [0, 4, 36]
    assert wf.loader.n_classes == 4
    assert len(last["history"]) == 2
    assert all(numpy.isfinite(h["train"]["loss"]) for h in last["history"])
    assert wf.step.train_steps == 2 * 5 and wf.step.eval_steps == 2
    # every window is uint8 at the crop, labels int32: one padded
    # validation minibatch and 5 train minibatches of 8 rows an epoch
    assert wf.step.uploader.bytes == 2 * (8 + 40) * (67 * 67 * 3 + 4)
    assert len(wf.step.stream_wait_seconds["train"]) == 2
