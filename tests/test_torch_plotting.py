"""The port's plotting plane (veles_torch/graphics.py, graphics_client.py,
znicz/nn_plotting_units.py, znicz/diversity.py, ``link_plotters`` and the
CLI's ``--graphics-dir``) against the JAX package on the CPU: every
plotter's payload equal to the reference's on the same weights and
history (MNIST's curves, weights and confusion matrix, the CIFAR-10 conv
layer's weights, the Kohonen maps); the wire each way between the
packages (frames, and each package's server feeding the other's
renderer); the port's dependency-free renderer (decodable PNGs, the
reference's file names and ``plots.json``); the diversity statistics;
the CLI leaving no renderer process behind, SIGTERM's exit included."""

import copy
import json
import os
import socket
import struct
import subprocess
import sys
import time

import numpy
import pytest
import torch

import veles.graphics as JG
import veles.prng as jprng
from veles.config import root as jroot
from veles.znicz_tpu import diversity as JD
from veles.znicz_tpu import nn_plotting_units as JP
from veles.znicz_tpu.models import kohonen as jkoh
import veles_torch.graphics as TG
import veles_torch.prng as tprng
from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.convert import params_from_jax, tree_from_jax
from veles_torch.graphics_client import read_png, render_payload
from veles_torch.launcher import EXIT_PREEMPTED
from veles_torch.znicz import diversity as TD
from veles_torch.znicz import nn_plotting_units as TP
from veles_torch.znicz.models import kohonen as tkoh
from veles_torch.znicz.models import mnist as tmnist
from veles_torch.znicz.ops import evaluator as TE
from veles_torch.znicz.standard_workflow import StandardWorkflow

from tests.test_mnist_ae import _run_mnist as jax_confusion_run
from tests.test_torch_cifar_alexnet import (  # noqa: F401 (fixtures)
    cifar_pair, configs, set_cifar)
from tests.test_torch_launcher import signal_after_epoch  # noqa: F401
from tests.torch_monitor import port_model_health_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_MNIST = os.path.join(REPO, "veles_torch", "znicz", "models",
                           "mnist.py")
SMALL = ["root.mnist.loader.n_train=200", "root.mnist.loader.n_valid=50",
         "root.mnist.loader.minibatch_size=50"]


def assert_payloads_equal(want, got):
    """The same meta, the same array names, shapes, dtypes and values."""
    (wmeta, warrays), (gmeta, garrays) = want, got
    assert gmeta == wmeta
    assert sorted(garrays) == sorted(warrays)
    for key, value in warrays.items():
        value = numpy.asarray(value)
        assert garrays[key].dtype == value.dtype, key
        assert numpy.array_equal(garrays[key], value), key


def child_pids():
    """This process's children (zombies included), from /proc."""
    me = str(os.getpid())
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % pid) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me:
            found.append(int(pid))
    return sorted(found)


@pytest.fixture
def mnist_root():
    """Put back both packages' root.mnist after a test, dropping an
    ``evaluator`` node the test made."""
    saved = [(r, copy.deepcopy(r.mnist.to_dict()),
              "evaluator" in r.mnist) for r in (jroot, troot)]
    yield
    for r, tree, had in saved:
        if not had and "evaluator" in r.mnist:
            del object.__getattribute__(r.mnist, "_items")["evaluator"]
        r.mnist.update(tree)


# -- payloads ---------------------------------------------------------------


@pytest.fixture(scope="module")
def mnist_pair():
    """The reference's MNIST with a confusion matrix trained 2 epochs
    (300/100, minibatch 50, seed 31), and the port's workflow holding its
    weights, history and confusion matrix."""
    jw = jax_confusion_run("cpu", "PlotJax")
    tw = StandardWorkflow(
        name="PlotTorch", layers=troot.mnist.layers,
        loader_factory=lambda w: tmnist.MnistLoader(
            w, name="loader", minibatch_size=50, n_train=300, n_valid=100),
        evaluator_factory=lambda w: TE.EvaluatorSoftmax(
            compute_confusion=True),
        decision_config={"max_epochs": 2})
    tw.initialize(device="cpu")
    tw.import_tree(params_from_jax(tree_from_jax(jw)))
    tw.decision.history = copy.deepcopy(jw.decision.history)
    tw.evaluator.confusion_matrix = torch.as_tensor(
        jw.evaluator.confusion_matrix.map_read().mem)
    return jw, tw


@pytest.mark.parametrize("kind", ["metric", "loss", "weights", "confusion"])
def test_mnist_payloads_match_reference(mnist_pair, kind):
    """AccumulatingPlotter (both fields), Weights2D of the dense first
    layer (the (fan_in, neurons) layout transposed into rows) and the
    confusion matrix: the reference's meta and arrays."""
    jw, tw = mnist_pair
    if kind in ("metric", "loss"):
        want = JP.AccumulatingPlotter(jw, field=kind).make_payload()
        got = TP.AccumulatingPlotter(tw, field=kind).make_payload()
    elif kind == "weights":
        want = JP.Weights2D(jw).make_payload()
        got = TP.Weights2D(tw).make_payload()
        assert got[1]["tiles"].shape == (64, 28, 28)
    else:
        want = JP.ConfusionMatrixPlotter(jw).make_payload()
        got = TP.ConfusionMatrixPlotter(tw).make_payload()
        assert got[1]["matrix"].sum() == 2 * 400
    assert_payloads_equal(want, got)


def test_link_plotters_matches_reference(mnist_pair, tmp_path):
    """``link_plotters``: the reference's names in its order, confusion
    on when the evaluator computes one, off when asked; each renders in
    process into ``out_dir`` without a graphics server."""
    jw, tw = mnist_pair
    out = str(tmp_path)
    names = [p.name for p in tw.link_plotters(out_dir=out)]
    assert names == ["plot_metric", "plot_weights", "plot_confusion"]
    for p in tw.plotters:
        p.run()
    for name in names:
        assert read_png(os.path.join(out, name + ".png")).std() > 0
    assert [p.name for p in tw.link_plotters(confusion=False)] == \
        ["plot_metric", "plot_weights"]


def test_conv_weights2d_matches_reference(configs):  # noqa: F811
    """Weights2D of the CIFAR-10 conv layer ((n_kernels, fan_in) rows
    as they are, each kernel's first channel) on both packages' initial
    weights, which are equal at the same seed."""
    set_cifar(1)
    jw, tw = cifar_pair(1)
    want = JP.Weights2D(jw).make_payload()
    got = TP.Weights2D(tw).make_payload()
    assert got[1]["tiles"].shape == (32, 5, 5)
    assert_payloads_equal(want, got)


@pytest.fixture
def kohonen_root():
    saved = [(r, copy.deepcopy(r.kohonen.to_dict())) for r in (jroot, troot)]
    for r in (jroot, troot):
        r.kohonen.update({"decision": {"max_epochs": 2},
                          "loader": {"n_samples": 200}})
    yield
    for r, tree in saved:
        r.kohonen.update(tree)


def test_kohonen_maps_match_reference(kohonen_root, tmp_path):
    """KohonenHits and KohonenNeighborMap on the reference's trained map
    (200 points, 2 epochs, seed 11): the reference's payloads; the port's
    own run draws both each epoch into ``out_dir``."""
    jprng.seed_all(11)
    jw = jkoh.create_workflow(name="SomJax")
    jw.initialize(device="cpu")
    jw.run()
    tprng.seed_all(11)
    tw = tkoh.create_workflow(name="SomTorch").initialize(device="cpu")
    tw.import_tree(params_from_jax(tree_from_jax(jw)))
    for jcls, tcls in ((JP.KohonenHits, TP.KohonenHits),
                       (JP.KohonenNeighborMap, TP.KohonenNeighborMap)):
        want = jcls(jw, forward=jw.forwards[0]).make_payload()
        got = tcls(tw, forward=tw.forwards[0]).make_payload()
        assert_payloads_equal(want, got)
    assert got[1]["image"].shape == (8, 8)
    out = str(tmp_path)
    tprng.seed_all(11)
    run = tkoh.create_workflow(name="SomRun")
    run.plotters += [TP.KohonenHits(run, forward=run.forwards[0],
                                    name="som_hits", out_dir=out),
                     TP.KohonenNeighborMap(run, forward=run.forwards[0],
                                           name="som_umatrix", out_dir=out)]
    run.initialize(device="cpu").run()
    hits = read_png(os.path.join(out, "som_hits.png"))
    assert hits.std() > 0
    assert read_png(os.path.join(out, "som_umatrix.png")).std() > 0


# -- diversity --------------------------------------------------------------


def test_diversity_stats_match_reference():
    """The reference test's weights (a duplicated direction, a dead row)
    and a random layer: similarity and stats equal to the reference's."""
    rng = numpy.random.default_rng(4)
    w = rng.normal(0, 1, (6, 20)).astype(numpy.float32)
    w[3] = w[0] * 2.0
    w[5] = 0.0
    for weights in (w, rng.normal(0, 1, (30, 7)).astype(numpy.float32)):
        assert numpy.array_equal(TD.similarity_matrix(weights),
                                 JD.similarity_matrix(weights))
        for threshold in (0.98, 0.5):
            assert TD.diversity_stats(weights, threshold) == \
                JD.diversity_stats(weights, threshold)
    stats = TD.diversity_stats(w)
    assert stats["similar_pairs"] >= 1 and stats["dead_units"] == 1


class WeightRecorder(TP.PlotterBase):
    """Keeps the first layer's weight rows each epoch; plots nothing."""

    def __init__(self, workflow):
        super().__init__(workflow)
        self.rows = []

    def make_payload(self):
        self.rows.append(TP.weight_rows(self.workflow.forwards[0]))


def test_weight_diversity_matches_reference(mnist_pair, tmp_path):
    """WeightDiversity on MNIST's first layer each epoch of a port run
    (the reference test's: 200/80, minibatch 40, seed 707, 2 epochs):
    every epoch's stats equal the reference's ``diversity_stats`` of that
    epoch's weights, and the similarity matrix renders; on the
    reference's trained weights (``mnist_pair``) its payload equals the
    reference unit's."""
    tprng.seed_all(707)
    tw = StandardWorkflow(
        name="DivTorch", layers=troot.mnist.layers,
        loader_factory=lambda w: tmnist.MnistLoader(
            w, name="loader", minibatch_size=40, n_train=200, n_valid=80),
        decision_config={"max_epochs": 2})
    recorder = WeightRecorder(tw)
    tdiv = TD.WeightDiversity(tw, name="diversity", out_dir=str(tmp_path))
    tw.plotters += [recorder, tdiv]
    tw.initialize(device="cpu").run()
    assert len(tdiv.history) == len(recorder.rows) == 2
    for rows, got in zip(recorder.rows, tdiv.history):
        assert got == JD.diversity_stats(rows, 0.98)
    assert tdiv.stats["n_units"] == 100
    assert read_png(str(tmp_path / "diversity.png")).std() > 0
    jw, pw = mnist_pair
    assert_payloads_equal(JD.WeightDiversity(jw).make_payload(),
                          TD.WeightDiversity(pw).make_payload())


# -- the wire ---------------------------------------------------------------


FRAMES = [
    ({"kind": "curves", "name": "curves", "title": "t",
      "series": ["train", "validation"]},
     {"train": numpy.linspace(1.0, 0.2, 5).astype(numpy.float32),
      "validation": numpy.linspace(1.2, 0.4, 5).astype(numpy.float32)}),
    ({"kind": "image", "name": "som hits", "title": "SOM hits",
      "cmap": "hot"},
     {"image": numpy.arange(64, dtype=numpy.float32).reshape(8, 8)}),
    ({"kind": "grid", "name": "grid", "title": "w"},
     {"tiles": numpy.random.default_rng(3).random((10, 5, 5))
      .astype(numpy.float32)}),
    ({"kind": "matrix", "name": "mat", "title": "confusion",
      "xlabel": "label", "ylabel": "prediction"},
     {"matrix": (numpy.arange(16).reshape(4, 4) * 7).astype(numpy.int32)}),
]


@pytest.mark.parametrize("packer", ["reference", "port"])
def test_frames_unpack_in_either_package(packer):
    pack = (JG if packer == "reference" else TG).pack_payload
    for meta, arrays in FRAMES:
        blob = pack(meta, arrays)
        for unpack in (JG.unpack_payload, TG.unpack_payload):
            assert_payloads_equal((meta, arrays), unpack(blob))


def test_oversized_frame_header_is_refused():
    """A length header over MAX_FRAME_BYTES raises before anything is
    allocated; a short stream is EOF."""
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", TG.MAX_FRAME_BYTES + 1))
        with pytest.raises(ConnectionError):
            TG.recv_frame(b)
        a.sendall(struct.pack(">I", 3) + b"ab")
        a.close()
        assert TG.recv_frame(b) is None
    finally:
        b.close()


def stream(server, renderer_module, out, frames, stderr=None):
    """Start ``renderer_module`` against ``server`` (spawn_client=False),
    publish ``frames`` once it connected, close both; -> the renderer's
    stderr."""
    client = subprocess.Popen(
        [sys.executable, "-m", renderer_module, "--connect",
         str(server.port), "--out", out], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=stderr or subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while not server.publish(*frames[0]):
            assert time.time() < deadline, "renderer never connected"
            time.sleep(0.05)
        for frame in frames[1:]:
            assert server.publish(*frame)
    finally:
        server.close()
        _, err = client.communicate(timeout=120)
    assert client.returncode == 0, err
    return err.decode()


def plots_index(out):
    with open(os.path.join(out, "plots.json")) as f:
        return json.load(f)


def test_servers_feed_each_others_renderer(tmp_path):
    """The port's GraphicsServer feeds the reference's renderer
    (matplotlib), and the reference's server feeds the port's: the same
    file names (``som hits`` sanitised to ``som_hits.png``) and equal
    ``plots.json`` indexes; every PNG decodes to a non-constant image."""
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    stream(TG.GraphicsServer(ref_out, spawn_client=False),
           "veles.graphics_client", ref_out, FRAMES)
    stream(JG.GraphicsServer(port_out, spawn_client=False),
           "veles_torch.graphics_client", port_out, FRAMES)
    want = plots_index(ref_out)
    assert plots_index(port_out) == want
    assert sorted(want) == ["curves", "grid", "mat", "som hits"]
    for entry in want.values():
        for out in (port_out, ref_out):
            img = read_png(os.path.join(out, entry["file"]))
            assert img.ndim == 3 and img.std() > 0, (out, entry)


def test_renderer_survives_a_bad_frame(tmp_path):
    """A frame of an unknown kind and one whose array has the wrong rank
    are reported on stderr; the frames after them still render."""
    out = str(tmp_path)
    bad = [({"kind": "bogus", "name": "x"}, {"image": numpy.eye(2)}),
           ({"kind": "image", "name": "flat"}, {"image": numpy.ones(5)})]
    err = stream(TG.GraphicsServer(out, spawn_client=False),
                 "veles_torch.graphics_client", out, bad + FRAMES[:1])
    assert err.count("render error") == 2, err
    assert sorted(plots_index(out)) == ["curves"]


@pytest.mark.parametrize("meta,arrays", FRAMES,
                         ids=[m["kind"] for m, _ in FRAMES])
def test_port_renderer_writes_decodable_pngs(tmp_path, meta, arrays):
    """Each renderer in process: ``render_payload``'s path and an RGB
    PNG that decodes to a non-constant image."""
    path = render_payload(meta, arrays, str(tmp_path))
    name = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in meta["name"])
    assert path == os.path.join(str(tmp_path), name + ".png")
    img = read_png(path)
    assert img.dtype == numpy.uint8 and img.shape[2] == 3
    assert img.std() > 0


def test_spawned_renderer_is_closed(tmp_path):
    """A GraphicsServer that spawns the port's renderer: connected when
    the constructor returns, frames drawn, and after ``close`` no child
    process is left."""
    before = child_pids()
    srv = TG.GraphicsServer(str(tmp_path))
    try:
        assert srv.client.pid in child_pids()
        for frame in FRAMES:
            assert srv.publish(*frame)
    finally:
        srv.close()
    assert child_pids() == before
    assert sorted(plots_index(str(tmp_path))) == [
        "curves", "grid", "mat", "som hits"]
    assert srv.dropped == 0


# -- the CLI ----------------------------------------------------------------


def test_cli_graphics_dir(mnist_root, tmp_path, capsys):
    """``--graphics-dir`` on a small MNIST run with the confusion matrix
    on: the renderer process writes plot_metric, plot_weights and
    plot_confusion and a plots.json naming them; the last stdout line is
    still the result; no child process is left."""
    out = str(tmp_path / "plots")
    before = child_pids()
    wf = torch_main([TORCH_MNIST, "-d", "cpu", "--seed", "5", *SMALL,
                     "root.mnist.decision.max_epochs=2",
                     "root.mnist.evaluator.compute_confusion=True",
                     "--graphics-dir", out])
    assert child_pids() == before
    assert wf.graphics is None
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["history"]
    index = plots_index(out)
    assert sorted(index) == ["plot_confusion", "plot_metric", "plot_weights"]
    for name, entry in index.items():
        assert entry["file"] == name + ".png"
        assert read_png(os.path.join(out, entry["file"])).std() > 0
    assert index["plot_confusion"]["kind"] == "matrix"


def test_cli_graphics_dir_closed_on_preemption(mnist_root, tmp_path,
                                               signal_after_epoch):  # noqa: F811
    """SIGTERM after epoch 1 of a long run with ``--graphics-dir``: exit
    75, the epoch's plots drawn, no child process left."""
    out = str(tmp_path / "plots")
    before = child_pids()
    signal_after_epoch(__import__("signal").SIGTERM, 1)
    with pytest.raises(SystemExit) as exit_info:
        torch_main([TORCH_MNIST, "-d", "cpu", *SMALL, "--graphics-dir", out,
                    "root.mnist.decision.max_epochs=500"])
    assert exit_info.value.code == EXIT_PREEMPTED
    assert child_pids() == before
    assert sorted(plots_index(out)) == ["plot_metric", "plot_weights"]
