"""The port stands alone: no module of ``veles_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``veles``, checked in the source and in a fresh interpreter; nor
matplotlib: the port's renderer draws its PNGs itself."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "veles", "matplotlib")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(REPO, "veles_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_or_veles(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, "%s imports %s" % (os.path.relpath(path, REPO), bad)


def test_importing_the_port_loads_no_jax_or_veles():
    """Import every module of the port (and chip_smoke) in a fresh
    interpreter; no jax or veles module may appear. Modules a site hook
    loaded before the imports are not counted."""
    script = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import importlib, pkgutil\n"
        "import veles_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(veles_torch.__path__, "
        "'veles_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in %r))\n"
        % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("module", [
    "znicz/ops/conv_math.py", "znicz/ops/conv.py", "znicz/ops/gd_conv.py",
    "znicz/ops/pooling.py", "znicz/ops/gd_pooling.py",
    "znicz/ops/normalization.py", "znicz/ops/dropout.py",
    "znicz/models/cifar10.py", "znicz/models/imagenet.py",
    "export_inference.py", "znicz/generate.py", "serving/__init__.py",
    "serving/quant.py", "serving/model.py", "serving/engine.py",
    "serving/batcher.py", "serving/decode.py", "normalization.py",
    "znicz/ops/cutter.py", "znicz/ops/deconv.py",
    "znicz/ops/mean_disp_normalizer.py", "znicz/models/mnist_ae.py",
    "znicz/models/video_ae.py"])
def test_conv_slice_modules_are_scanned(module):
    """The conv, serving and autoencoder slices' modules are among the
    files both checks above read (the package walk finds them, the fresh
    interpreter imports them)."""
    assert os.path.join(REPO, "veles_torch", module) in _port_files()


@pytest.mark.parametrize("module", [
    "znicz/lr_adjust.py", "znicz/ops/scan_attention.py",
    "znicz/parallel/__init__.py", "znicz/parallel/pipeline.py",
    "znicz/ops/transformer_stack.py", "znicz/ops/moe.py"])
def test_lm_slice_modules_are_scanned(module):
    """The LM slice's modules (solvers and schedules, the scan, the
    stacked block, the MoE FFN) are among the files both checks read."""
    assert os.path.join(REPO, "veles_torch", module) in _port_files()


def test_serving_stack_and_moe_archives_loads_no_jax_or_veles(tmp_path):
    """Train a tiny stacked LM and a tiny MoE LM for one epoch in a fresh
    interpreter, export both, load them with ArchiveModel and decode a
    step with GenerativeEngine on the CPU: no jax or veles module is
    loaded along the way."""
    script = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import numpy\n"
        "from veles_torch.config import root\n"
        "from veles_torch.serving import ArchiveModel, GenerativeEngine\n"
        "from veles_torch.znicz.models import transformer_lm as tlm\n"
        "root.lm.loader.update({'n_train': 64, 'n_valid': 16,\n"
        "                       'minibatch_size': 16})\n"
        "root.lm.decision.max_epochs = 1\n"
        "for i, model in enumerate(({'stacked': True, 'remat': True},\n"
        "                           {'moe_experts': 4})):\n"
        "    root.lm.model.update(dict({'stacked': False, 'remat': False,\n"
        "                               'moe_experts': 0}, **model))\n"
        "    wf = tlm.create_workflow().initialize(device='cpu')\n"
        "    wf.run()\n"
        "    path = %r + '/a%%d' %% i\n"
        "    wf.export_inference(path)\n"
        "    model = ArchiveModel.from_dir(path, device='cpu')\n"
        "    types = [u['type'] for u in model.units]\n"
        "    assert ('transformer_stack' if i == 0 else 'moe_ffn') in types\n"
        "    engine = GenerativeEngine(model, n_slots=2, max_len=64,\n"
        "                              device='cpu')\n"
        "    engine.prefill_into(0, [1, 2, 3], 0.0)\n"
        "    engine.step(numpy.array([1, 0]), numpy.array([3, 0]),\n"
        "                numpy.zeros(2, numpy.float32))\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in %r))\n"
        % (str(tmp_path), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_state_and_launcher_modules_are_checked():
    """The checkpoint, launcher and rollback modules are among the files
    the source check covers (each is also imported by the fresh
    interpreter above)."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {os.path.join("veles_torch", "snapshotter.py"),
            os.path.join("veles_torch", "launcher.py"),
            os.path.join("veles_torch", "znicz", "nn_rollback.py")} <= files


@pytest.mark.parametrize("module", [
    "graphics.py", "graphics_client.py", "znicz/nn_plotting_units.py",
    "znicz/diversity.py", "znicz/ops/kohonen.py", "znicz/ops/rbm.py",
    "znicz/models/kohonen.py", "znicz/models/mnist_rbm.py"])
def test_unsupervised_and_plotting_modules_are_scanned(module):
    """The unsupervised samples' and the plotting plane's modules are
    among the files both checks read (neither jax, veles nor
    matplotlib)."""
    assert os.path.join(REPO, "veles_torch", module) in _port_files()


def test_plots_and_unsupervised_runs_load_no_jax_veles_or_matplotlib(
        tmp_path):
    """In a fresh interpreter: a Kohonen epoch with its SOM maps and an
    RBM epoch, each drawn by the renderer process of a GraphicsServer, and
    the four renderers in process; no jax, veles or matplotlib module is
    loaded, and the PNGs are written."""
    script = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import numpy\n"
        "from veles_torch.config import root\n"
        "from veles_torch.graphics import GraphicsServer\n"
        "from veles_torch.graphics_client import render_payload\n"
        "from veles_torch.znicz import nn_plotting_units as P\n"
        "from veles_torch.znicz.models import kohonen, mnist_rbm\n"
        "root.kohonen.update({'decision': {'max_epochs': 1}})\n"
        "root.mnist_rbm.update({'decision': {'max_epochs': 1},\n"
        "                       'loader': {'n_train': 200, 'n_valid': 100}})\n"
        "out = %r\n"
        "wf = kohonen.create_workflow()\n"
        "wf.plotters += [P.KohonenHits(wf, forward=wf.forwards[0]),\n"
        "                P.KohonenNeighborMap(wf, forward=wf.forwards[0])]\n"
        "wf.graphics = GraphicsServer(out)\n"
        "wf.initialize(device='cpu').run()\n"
        "wf.graphics.close()\n"
        "mnist_rbm.create_workflow().initialize(device='cpu').run()\n"
        "for kind, arrays in (\n"
        "        ('curves', {'a': numpy.arange(3.0)}),\n"
        "        ('image', {'image': numpy.eye(3)}),\n"
        "        ('grid', {'tiles': numpy.ones((2, 3, 3))}),\n"
        "        ('matrix', {'matrix': numpy.eye(3, dtype=int)})):\n"
        "    render_payload({'kind': kind, 'name': kind}, arrays, out)\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in %r))\n"
        % (str(tmp_path), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert sorted(os.listdir(str(tmp_path))) == [
        "KohonenHits.png", "KohonenNeighborMap.png", "curves.png",
        "grid.png", "image.png", "matrix.png", "plots.json"]


@pytest.mark.parametrize("module", [
    "logger.py", "telemetry.py", "reactor.py", "health.py",
    "web_status.py", "serving/tenants.py", "serving/registry.py",
    "serving/frontend.py"])
def test_http_serving_plane_modules_are_scanned(module):
    """The HTTP serving plane's modules (the port's copies of the
    reference's telemetry, reactor, health, web status and tenants, and
    the registry and frontend) are among the files both checks read."""
    assert os.path.join(REPO, "veles_torch", module) in _port_files()


@pytest.mark.parametrize("module", [
    "config.py", "genetics.py", "ensemble.py", "interaction.py",
    "forge_client.py"])
def test_search_ensemble_shell_and_forge_modules_are_scanned(module):
    """The Tune config, the genetic search, the ensemble, the shell and
    the forge client are among the files both checks read."""
    assert os.path.join(REPO, "veles_torch", module) in _port_files()


def test_search_ensemble_shell_and_forge_load_no_jax_or_veles(tmp_path):
    """In a fresh interpreter: a genetic search over a Tune leaf in two
    spawned workers and an ensemble of two members, both through the CLI
    on the CPU, a headless shell stopping a run, and a forge round trip
    of a checkpoint; no jax or veles module is loaded (the workers import
    what the parent's pickles name: the port only)."""
    script = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import os, json\n"
        "from veles_torch.__main__ import main\n"
        "from veles_torch import forge_client\n"
        "from veles_torch.config import root\n"
        "from veles_torch.znicz.models import mnist\n"
        "out = %r\n"
        "cfg = os.path.join(out, 'cfg.py')\n"
        "small = ['root.mnist.loader.n_train=80', 'root.mnist.loader.n_valid=40',\n"
        "         'root.mnist.loader.minibatch_size=40',\n"
        "         'root.mnist.decision.max_epochs=1', '-d', 'cpu']\n"
        "path = mnist.__file__\n"
        "if __name__ == '__main__':\n"
        "    open(cfg, 'w').write('from veles_torch.config import root, Tune\\n'\n"
        "        'root.mnist.layers[1][\"<-\"][\"learning_rate\"] = '\n"
        "        'Tune(0.02, 0.005, 0.1)\\n')\n"
        "    main([path, cfg, *small, '--optimize', '1x3x2'])\n"
        "    main([path, *small, '--ensemble', '2'])\n"
        "    wf = mnist.create_workflow()\n"
        "    wf.link_shell(commands=['stop()'])\n"
        "    wf.link_snapshotter(directory=os.path.join(out, 's'))\n"
        "    wf.initialize(device='cpu').run()\n"
        "    ckpt = wf.snapshotter.export_snapshot(slot='current')\n"
        "    forge_client.upload('m', [ckpt], store=os.path.join(out, 'f'))\n"
        "    forge_client.fetch('m', os.path.join(out, 'g'),\n"
        "                       store=os.path.join(out, 'f'))\n"
        "    new = set(sys.modules) - before\n"
        "    print(sorted(m for m in new if m.split('.')[0] in %r))\n"
        % (str(tmp_path), FORBIDDEN))
    path = tmp_path / "drive.py"
    path.write_text(script)
    out = subprocess.run([sys.executable, str(path)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout[-2000:]


@pytest.mark.parametrize("module", ["perf.py", "profiling.py", "fleet.py"])
def test_profiling_plane_modules_are_scanned(module):
    """The per-step cost ledger, the profiling plane and the fleet view
    are among the files both checks read."""
    assert os.path.join(REPO, "veles_torch", module) in _port_files()


@pytest.mark.parametrize("module", [
    "loader/codecs.py", "loader/stream.py", "loader/image.py",
    "continual.py", "znicz/models/imagenet_prep.py", "znicz/step.py"])
def test_streaming_modules_are_scanned(module):
    """The streaming loader's, the continual loop's and the staging
    tool's modules are among the files both checks read."""
    assert os.path.join(REPO, "veles_torch", module) in _port_files()


def test_image_stream_and_continual_runs_load_no_jax_or_veles(tmp_path):
    """In a fresh interpreter: a PNG tree written by ``write_png``
    streamed through AutoLabelFileImageLoader for one conv epoch, then a
    continual round over HTTP (``stream_handler`` and HttpStreamSource);
    no jax or veles module is loaded."""
    script = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import os, numpy\n"
        "from veles_torch import continual\n"
        "from veles_torch.graphics_client import write_png\n"
        "from veles_torch.loader.image import AutoLabelFileImageLoader\n"
        "from veles_torch.loader.stream import (ArraySource,\n"
        "                                       ContinualStreamLoader)\n"
        "from veles_torch.reactor import HttpServer\n"
        "from veles_torch.znicz.standard_workflow import StandardWorkflow\n"
        "base = %r\n"
        "for k in range(2):\n"
        "    os.makedirs(os.path.join(base, 'c%%d' %% k))\n"
        "    for j in range(6):\n"
        "        write_png(os.path.join(base, 'c%%d' %% k, '%%d.png' %% j),\n"
        "                  numpy.full((12, 14, 3), 90 * k + j, numpy.uint8))\n"
        "conv = [{'type': 'conv_relu', '->': {'n_kernels': 2, 'kx': 3,\n"
        "         'ky': 3}, '<-': {'learning_rate': 0.01}},\n"
        "        {'type': 'softmax', '->': {'output_sample_shape': 2},\n"
        "         '<-': {'learning_rate': 0.01}}]\n"
        "wf = StandardWorkflow(name='w', layers=conv,\n"
        "    loader_factory=lambda w: AutoLabelFileImageLoader(\n"
        "        w, base_dir=base, scale=(10, 10), crop=(8, 8),\n"
        "        mirror='random', minibatch_size=4),\n"
        "    decision_config={'max_epochs': 1})\n"
        "wf.initialize(device='cpu').run()\n"
        "wf.close()\n"
        "rng = numpy.random.RandomState(1)\n"
        "src = ArraySource(rng.uniform(-1, 1, (64, 5)).astype('float32'),\n"
        "                  rng.randint(0, 3, 64).astype('int32'))\n"
        "srv = HttpServer('127.0.0.1', 0, continual.stream_handler(src))\n"
        "url = 'http://127.0.0.1:%%d' %% srv.port\n"
        "fc = [{'type': 'softmax', '->': {'output_sample_shape': 3},\n"
        "       '<-': {'learning_rate': 0.01}}]\n"
        "wf = StandardWorkflow(name='c', layers=fc,\n"
        "    loader_factory=lambda w: ContinualStreamLoader(\n"
        "        w, source=continual.HttpStreamSource(url),\n"
        "        minibatch_size=8, round_samples=16, valid_samples=8),\n"
        "    decision_config={'max_epochs': 1})\n"
        "wf.initialize(device='cpu')\n"
        "assert continual.continual_loop(wf, rounds=1) == 1\n"
        "wf.close()\n"
        "srv.close()\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in %r))\n"
        % (str(tmp_path), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
