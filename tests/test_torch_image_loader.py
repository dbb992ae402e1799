"""The port's image loaders (veles_torch/loader/image.py) against the JAX
package's (veles/loader/image.py) on the reference's fixture
(tests/test_image_loader.py: 3 class directories × 12 noisy PNGs written
by Pillow): the split, the labels, the augmentation draws over two
epochs and ``materialize_window`` for a train and an eval class, bit for
bit; ``FileImageLoader`` with explicit labels; and the reference test's
conv net (``test_label_colors_learnable``) trained 2 epochs through both
packages' stream paths from the same weights, within ``CONV_RTOL``; the
windows of a tree of arithmetic-coded and lossless JPEG files; a file
Pillow refuses raising with its path."""

import os

import numpy
import pytest

import veles.prng as jprng
from veles.loader.base import CLASS_TRAIN, CLASS_VALID
from veles.loader.image import AutoLabelFileImageLoader as JaxAutoLoader
from veles.loader.image import FileImageLoader as JaxFileLoader
from veles.workflow import Workflow
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
import veles_torch.prng as tprng
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.loader.image import AutoLabelFileImageLoader
from veles_torch.loader.image import FileImageLoader
from veles_torch.znicz.standard_workflow import StandardWorkflow

#: the streamed conv net after 2 epochs, each parameter and velocity
#: against its largest element: f32 convolutions summed in another order,
#: the conv tolerance of the port's conv tests (observed 9.0e-7, the
#: softmax bias)
CONV_RTOL = 2e-5
LAYERS = [
    {"type": "conv_relu",
     "->": {"n_kernels": 8, "kx": 5, "ky": 5, "sliding": 2},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.5}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.02, "gradient_moment": 0.5}},
]


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """The reference's fixture: 3 class dirs × 12 PNGs of noisy solid
    colours."""
    from PIL import Image
    base = tmp_path_factory.mktemp("imgs")
    colors = {"apple": (200, 30, 30), "pear": (30, 200, 30),
              "plum": (30, 30, 200)}
    gen = numpy.random.Generator(numpy.random.PCG64(7))
    for cls, color in colors.items():
        d = base / cls
        d.mkdir()
        for i in range(12):
            arr = numpy.clip(
                numpy.asarray(color)[None, None]
                + gen.normal(0, 12, (40, 48, 3)), 0, 255).astype(numpy.uint8)
            Image.fromarray(arr).save(d / ("img%02d.png" % i))
    return str(base)


def _pair(image_tree, seed=5, **kw):
    kw.setdefault("scale", (32, 32))
    kw.setdefault("crop", (28, 28))
    kw.setdefault("mirror", "random")
    kw.setdefault("minibatch_size", 8)
    jprng.seed_all(seed)
    ref = JaxAutoLoader(Workflow(None, name="ImgWF"), base_dir=image_tree,
                        name="loader", **kw)
    ref.initialize()
    tprng.seed_all(seed)
    port = AutoLabelFileImageLoader(base_dir=image_tree, name="loader", **kw)
    port.initialize()
    return ref, port


@pytest.fixture
def loaders(image_tree):
    ref, port = _pair(image_tree)
    yield ref, port
    port.stop()
    ref.stop()


def test_split_labels_and_spec(loaders):
    ref, port = loaders
    assert port.class_lengths == ref.class_lengths == [0, 6, 30]
    assert port._paths == ref._paths
    n = sum(port.class_lengths)
    assert [port.label_of(i) for i in range(n)] == \
        [ref.label_of(i) for i in range(n)]
    assert port.n_classes == ref.n_classes == 3
    assert port.aug_seed == ref.aug_seed
    assert port.sample_spec() == ref.sample_spec()


def test_augmentation_draws_over_two_epochs(loaders):
    ref, port = loaders
    for epoch in (0, 1):
        ref.epoch_number = port.epoch_number = epoch
        for i in range(sum(port.class_lengths)):
            numpy.testing.assert_array_equal(port._aug_draws(i),
                                             ref._aug_draws(i))
    assert not numpy.array_equal(port._aug_draws(3), _draws_at(port, 3, 0))


def _draws_at(loader, index, epoch):
    saved, loader.epoch_number = loader.epoch_number, epoch
    try:
        return loader._aug_draws(index)
    finally:
        loader.epoch_number = saved


def test_windows_equal_the_reference(loaders):
    """materialize_window of the epoch plan's train and validation rows,
    two epochs: the same uint8 images (decode, resize, crop, mirror) and
    labels; train windows differ from eval's centre crops."""
    ref, port = loaders
    rows = numpy.arange(8, 16).reshape(2, 4)
    for epoch in (0, 1):
        ref.epoch_number = port.epoch_number = epoch
        for cls in (CLASS_TRAIN, CLASS_VALID):
            want = ref.materialize_window(cls, rows)
            got = port.materialize_window(cls, rows)
            assert sorted(got) == sorted(want) == ["data", "labels"]
            for key in want:
                assert got[key].dtype == want[key].dtype
                numpy.testing.assert_array_equal(got[key], want[key])
        train = port.materialize_window(CLASS_TRAIN, rows)["data"]
        ev = port.materialize_window(CLASS_VALID, rows)["data"]
        assert not numpy.array_equal(train, ev)


def test_epoch_plan_windows_equal_the_reference(loaders):
    """The whole first epoch as the step stages it: every class's index
    matrix (the same shuffle) and its windows."""
    ref, port = loaders
    want_plan = ref.epoch_plan()
    got_plan = port.epoch_plan()
    assert [c for c, _, _ in got_plan] == [c for c, _, _ in want_plan]
    for (cls, idx, valids), (_, ridx, rvalids) in zip(got_plan, want_plan):
        numpy.testing.assert_array_equal(idx, ridx)
        numpy.testing.assert_array_equal(valids, rvalids)
        got = port.materialize_window(cls, idx)
        want = ref.materialize_window(cls, ridx)
        for key in want:
            numpy.testing.assert_array_equal(got[key], want[key])


def test_batch_transform_is_the_reference_normalization(loaders):
    import torch
    ref, port = loaders
    data = port.materialize_window(CLASS_TRAIN, numpy.arange(8)[None])
    x = data["data"][0]
    want = (x.astype(numpy.float32) / 255.0 - 0.5) / 0.5
    got = port.batch_transform(torch.from_numpy(x), True)
    assert got.dtype == torch.float32
    numpy.testing.assert_array_equal(got.numpy(), want)


def test_file_image_loader_explicit_labels(image_tree):
    paths = []
    for cls in sorted(os.listdir(image_tree)):
        d = os.path.join(image_tree, cls)
        paths += [os.path.join(d, f) for f in sorted(os.listdir(d))[:3]]
    kw = dict(name="loader", train_paths=paths[3:], valid_paths=paths[:3],
              train_labels=list(range(len(paths) - 3)),
              valid_labels=[0, 1, 2], scale=(16, 16), minibatch_size=4)
    jprng.seed_all(3)
    ref = JaxFileLoader(Workflow(None, name="FileWF"), **kw)
    ref.initialize()
    tprng.seed_all(3)
    port = FileImageLoader(**kw)
    port.initialize()
    try:
        assert port.class_lengths == ref.class_lengths == \
            [0, 3, len(paths) - 3]
        idx = numpy.asarray([0, 1, 2, 5])
        want = ref.materialize_samples(idx, train=False)
        got = port.materialize_samples(idx, False)
        assert list(got["labels"]) == [0, 1, 2, 2]
        assert got["data"].shape == (4, 16, 16, 3)
        for key in want:
            numpy.testing.assert_array_equal(got[key], want[key])
    finally:
        port.stop()
        ref.stop()


def test_undecodable_file_raises_with_its_path(tmp_path):
    """A JPEG of a process Pillow refuses (arithmetic-coded lossless,
    SOF11: libjpeg-turbo has no decoder for it) raises naming the file
    when its window is built; nothing is skipped."""
    import io
    from PIL import Image
    d = tmp_path / "cls"
    d.mkdir()
    for i in range(3):
        Image.fromarray(numpy.full((8, 8, 3), 40 * i, numpy.uint8)).save(
            d / ("a%d.png" % i))
    buf = io.BytesIO()
    Image.fromarray(numpy.zeros((8, 8, 3), numpy.uint8)).save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    data[data.index(b"\xff\xc0") + 1] = 0xCB     # SOF11
    with pytest.raises(OSError):
        with Image.open(io.BytesIO(bytes(data))) as img:
            img.load()
    (d / "b.jpg").write_bytes(bytes(data))
    tprng.seed_all(1)
    port = AutoLabelFileImageLoader(base_dir=str(tmp_path), scale=(8, 8),
                                    minibatch_size=2, valid_ratio=0)
    port.initialize()
    try:
        with pytest.raises(ValueError, match="b.jpg.*SOF11"):
            port.materialize_window(CLASS_TRAIN, numpy.arange(4)[None])
    finally:
        port.stop()


#: the committed fixtures of the arithmetic-coded and lossless processes
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")


@pytest.fixture(scope="module")
def process_tree(tmp_path_factory):
    """A staged tree of the small arithmetic-coded (SOF9, SOF10) and
    lossless (SOF3) fixtures: 3 class dirs of ``*.JPEG`` files."""
    import shutil
    base = tmp_path_factory.mktemp("processes")
    names = sorted(n for n in os.listdir(FIXTURES)
                   if n.startswith(("arith_", "lossless_"))
                   and "tree_" not in n)
    for k, wnid in enumerate(("n01440764", "n01443537", "n01484850")):
        (base / wnid).mkdir()
        for i, name in enumerate(names[k::3]):
            shutil.copyfile(os.path.join(FIXTURES, name),
                            base / wnid / ("%s_%d.JPEG" % (wnid, i)))
    return str(base)


def test_arithmetic_and_lossless_windows_equal_the_reference(process_tree):
    """A tree of arithmetic-coded and lossless JPEG files through
    AutoLabelFileImageLoader (the Python twins, as on ``-d cpu``): the
    same split, labels and uint8 windows (decode, resize, crop, mirror)
    as the reference's Pillow loader, two epochs."""
    ref, port = _pair(process_tree, minibatch_size=4)
    try:
        assert port._paths == ref._paths
        assert not port.native_decode
        rows = numpy.arange(0, 4).reshape(1, 4)
        for epoch in (0, 1):
            ref.epoch_number = port.epoch_number = epoch
            for cls in (CLASS_TRAIN, CLASS_VALID):
                n = port.class_lengths[cls]
                idx = rows % max(n, 1)
                want = ref.materialize_window(cls, idx)
                got = port.materialize_window(cls, idx)
                for key in want:
                    numpy.testing.assert_array_equal(got[key], want[key])
    finally:
        port.stop()
        ref.stop()


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    """An ImageNet-style staged tree: 3 ``<wnid>/*.JPEG`` class dirs × 8
    images (baseline 4:2:0 and progressive)."""
    from PIL import Image
    base = tmp_path_factory.mktemp("jpegs")
    gen = numpy.random.Generator(numpy.random.PCG64(11))
    for k, wnid in enumerate(("n01440764", "n01443537", "n01484850")):
        d = base / wnid
        d.mkdir()
        for i in range(8):
            arr = numpy.clip(numpy.asarray((60 * k + 40, 120, 200 - 50 * k))
                             [None, None] + gen.normal(0, 20, (37, 45, 3)),
                             0, 255).astype(numpy.uint8)
            Image.fromarray(arr).save(d / ("%s_%d.JPEG" % (wnid, i)),
                                      "JPEG", progressive=bool(i % 2))
    return str(base)


def test_jpeg_tree_windows_equal_the_reference(jpeg_tree):
    """A staged ``*.JPEG`` tree through AutoLabelFileImageLoader: the same
    split, labels and uint8 windows (decode, resize, crop, mirror) as the
    reference's Pillow loader, two epochs."""
    ref, port = _pair(jpeg_tree)
    try:
        assert port._paths == ref._paths
        assert all(p.endswith(".JPEG") for p in port._paths)
        rows = numpy.arange(0, 8).reshape(2, 4)
        for epoch in (0, 1):
            ref.epoch_number = port.epoch_number = epoch
            for cls in (CLASS_TRAIN, CLASS_VALID):
                want = ref.materialize_window(cls, rows)
                got = port.materialize_window(cls, rows)
                for key in want:
                    numpy.testing.assert_array_equal(got[key], want[key])
    finally:
        port.stop()
        ref.stop()


def _jax_conv(image_tree):
    jprng.seed_all(11)
    wf = JaxStandardWorkflow(
        None, name="JaxImgTrain", layers=LAYERS,
        loader_factory=lambda w: JaxAutoLoader(
            w, base_dir=image_tree, name="loader", scale=(32, 32),
            crop=(28, 28), mirror="random", minibatch_size=8),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    wf.initialize(device="cpu")
    assert wf.xla_step.stream_mode
    return wf


def test_streamed_conv_net_matches_the_reference(image_tree):
    """The reference test's conv net, 2 epochs through both stream paths
    from the reference's initial weights: the same per-class error counts
    and each parameter and velocity within CONV_RTOL of its largest
    element."""
    jw = _jax_conv(image_tree)
    tprng.seed_all(11)
    tw = StandardWorkflow(
        name="TorchImgTrain", layers=LAYERS,
        loader_factory=lambda w: AutoLabelFileImageLoader(
            w, base_dir=image_tree, name="loader", scale=(32, 32),
            crop=(28, 28), mirror="random", minibatch_size=8),
        decision_config={"max_epochs": 2, "fail_iterations": 50})
    tw.initialize(device="cpu")
    try:
        start = {u.name: {**u.export_params(), **u.export_state()}
                 for u in jw.forwards + jw.gds}
        tw.import_tree(params_from_jax(
            {u: s for u, s in start.items() if s}))
        jw.run()
        tw.run()
        assert tw.loader.supports_streaming
        got = params_to_numpy(tw.export_tree())
        for u in jw.forwards + jw.gds:
            for key, value in {**u.export_params(),
                               **u.export_state()}.items():
                value = numpy.asarray(value, numpy.float64)
                rel = numpy.abs(got[u.name][key] - value).max() \
                    / max(numpy.abs(value).max(), 1e-30)
                assert rel <= CONV_RTOL, (u.name, key, rel)
        assert len(tw.decision.history) == 2
        for jh, th in zip(jw.decision.history, tw.decision.history):
            for cls in ("validation", "train"):
                assert round(jh[cls]["metric"] * jh[cls]["samples"]) == \
                    round(th[cls]["metric"] * th[cls]["samples"]), cls
                assert abs(jh[cls]["loss"] - th[cls]["loss"]) < 1e-4
    finally:
        tw.close()
        jw.loader.stop()
