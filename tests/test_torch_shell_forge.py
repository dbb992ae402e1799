"""The port's interactive shell unit (veles_torch/interaction.py,
``link_shell``) and forge client (veles_torch/forge_client.py) against
the JAX package's (veles/interaction.py, veles/forge_client.py), as
tests/test_shell_forge.py holds the reference: the shell's commands run
at each epoch's end with the workflow in scope, ``stop()`` ends the run
before its next minibatch, failures are recorded and never end training;
forge packages round-trip, order versions numerically and refuse unsafe
names in both clients, each client lists and fetches the other's
packages, and a checkpoint and an inference archive packaged by one
package load in the other."""

import json
import os
import subprocess
import sys

import numpy
import pytest

import veles.forge_client as JF
import veles.prng as jprng
import veles.snapshotter as JS
from veles.config import root as jroot
from veles.interaction import Shell as JShell
from veles.serving.model import ArchiveModel as JaxArchiveModel
from veles.znicz_tpu.models import mnist as jmnist
import veles_torch.forge_client as TF
import veles_torch.prng as tprng
import veles_torch.snapshotter as TS
from veles_torch.config import root as troot
from veles_torch.interaction import Shell as TShell
from veles_torch.serving.model import ArchiveModel
from veles_torch.znicz.models import mnist as tmnist
from veles_torch.znicz.standard_workflow import NNWorkflow

from tests.test_torch_mnist import jax_tree
from tests.test_torch_resume import (
    MNIST_ATOL, assert_atol, jax_mnist, port_tree, torch_mnist)
from tests.torch_monitor import port_model_health_isolation  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference test's shell runs (tests/test_shell_forge.py)
SHELL_SIZES = {"n_train": 200, "n_valid": 80, "minibatch_size": 40}
CLIENTS = {"reference": JF, "port": TF}


@pytest.fixture
def shell_mnist():
    """Both packages' ``root.mnist`` at SHELL_SIZES; restored after."""
    saved = []
    for r in (jroot, troot):
        saved.append((r, {k: r.mnist.loader.get(k) for k in SHELL_SIZES},
                      r.mnist.decision.max_epochs))
        r.mnist.loader.update(SHELL_SIZES)
    yield
    for r, loader, epochs in saved:
        r.mnist.loader.update(loader)
        r.mnist.decision.max_epochs = epochs


def ref_shell_run(commands, max_epochs, seed, name):
    """The reference test's run: the shell linked after the decision,
    gated on the epoch's end, on numpy."""
    jprng.seed_all(seed)
    jroot.mnist.decision.max_epochs = max_epochs
    wf = jmnist.create_workflow(name=name)
    sh = JShell(wf, name="shell", commands=commands)
    sh.link_from(wf.decision)
    sh.gate_skip = ~wf.decision.epoch_ended
    wf._end_point_last()
    wf.initialize(device="numpy")
    wf.run()
    return wf, sh


def port_shell_run(commands, max_epochs, seed, name):
    tprng.seed_all(seed)
    troot.mnist.decision.max_epochs = max_epochs
    wf = tmnist.create_workflow(name=name)
    sh = wf.link_shell(commands=commands)
    wf.initialize(device="cpu")
    wf.run()
    return wf, sh


def test_shell_commands_run_per_epoch(shell_mnist):
    """Two epochs: two activations, every command ran without an error,
    the decision had already counted the epoch when the shell ran (probe
    2), in both packages; the port's units are in scope by name."""
    commands = ["wf.shell_probe = wf.decision.epoch_number",
                "assert loader is wf.loader"]
    port_only = ["assert All2AllTanh is wf.forwards[0] "
                 "and GDSoftmax is wf.gds[1] and decision is wf.decision "
                 "and evaluator is wf.evaluator and shell is wf.shell",
                 "assert workflow is wf and numpy.pi > 3"]
    jw, jsh = ref_shell_run(commands, 2, 808, "ShellWF")
    tw, tsh = port_shell_run(commands + port_only, 2, 808, "ShellWF")
    assert tsh.activations == jsh.activations == 2
    assert all(exc is None for _, exc in jsh.results)
    assert tsh.results == [(c, None) for c in commands + port_only] * 2
    assert tw.shell_probe == jw.shell_probe == 2
    assert [h["validation"]["metric"] for h in tw.decision.history] == \
        [h["validation"]["metric"] for h in jw.decision.history]


def test_shell_stop_ends_run(shell_mnist):
    """``stop()`` at the first epoch's end: the reference stops within 2
    epochs of 50; the port's run ends before epoch 2's first minibatch:
    one epoch in the history, its 5 train and 2 validation minibatches
    and no more, one activation."""
    jw, _ = ref_shell_run(["stop()"], 50, 809, "ShellStop")
    tw, tsh = port_shell_run(["stop()"], 50, 809, "ShellStop")
    assert len(jw.decision.history) <= 2
    assert len(tw.decision.history) == 1 and tsh.activations == 1
    assert (tw.step.train_steps, tw.step.eval_steps) == (5, 2)
    assert not tw.decision.complete and tw.step.stop_requested


def test_shell_records_failures():
    """A failing command is recorded, not swallowed, and the later ones
    still run (both packages)."""
    from veles.workflow import Workflow
    commands = ["x = 1", "raise ValueError('boom')", "y = x"]
    shells = [JShell(Workflow(None, name="ShErr"), name="shell",
                     commands=commands),
              TShell(NNWorkflow("ShErr"), commands=commands)]
    for sh in shells:
        sh.run()
        assert sh.results[0][1] is None
        assert isinstance(sh.results[1][1], ValueError)
        assert sh.results[2][1] is None
    assert [str(e) for _, e in shells[1].results] == \
        [str(e) for _, e in shells[0].results]


def test_shell_without_commands_off_a_tty_does_nothing():
    """Headless and without commands (stdin is not a TTY under pytest):
    the activation is counted, nothing runs, nothing is recorded."""
    assert not sys.stdin.isatty()
    sh = TShell(NNWorkflow("Quiet"))
    sh.run()
    assert (sh.activations, sh.results) == (1, [])


def test_shell_on_a_tty_opens_a_console_with_the_workflow(monkeypatch):
    """Without commands on a TTY the shell hands ``code.interact`` the
    workflow's namespace: ``wf``, ``stop`` and the units by name."""
    import code
    seen = {}
    monkeypatch.setattr(sys, "stdin", type("Tty", (), {
        "isatty": staticmethod(lambda: True)})())
    monkeypatch.setattr(code, "interact",
                        lambda banner, local, exitmsg: seen.update(local))
    wf = tmnist.create_workflow(name="Tty")
    sh = wf.link_shell()
    sh.run()
    assert seen["wf"] is wf and seen["stop"] == wf.stop
    assert seen["loader"] is wf.loader and seen["shell"] is sh
    assert (sh.activations, sh.results) == (1, [])


# -- forge --------------------------------------------------------------


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_forge_roundtrip(tmp_path, client):
    forge = CLIENTS[client]
    store = str(tmp_path / "store")
    art = tmp_path / "weights.npy"
    numpy.save(art, numpy.arange(6.0))
    pkg = forge.upload("mlp", [str(art)], store=store, version="1",
                       description="test model")
    assert os.path.basename(pkg) == "mlp-1.forge.tar.gz"
    assert [m["name"] for m in forge.list_packages(store)] == ["mlp"]
    dest = str(tmp_path / "out")
    meta = forge.fetch("mlp", dest, store=store)
    assert meta["version"] == "1" and meta["files"] == ["weights.npy"]
    numpy.testing.assert_array_equal(
        numpy.load(os.path.join(dest, "weights.npy")), numpy.arange(6.0))


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_forge_versions_and_missing(tmp_path, client):
    """The numerically newest version wins (10 > 9), a pinned version is
    fetched, a missing name raises."""
    forge = CLIENTS[client]
    store = str(tmp_path / "store")
    art = tmp_path / "a.npy"
    numpy.save(art, numpy.zeros(2))
    forge.upload("m", [str(art)], store=store, version="9")
    numpy.save(art, numpy.ones(2))
    forge.upload("m", [str(art)], store=store, version="10")
    dest = str(tmp_path / "o")
    assert forge.fetch("m", dest, store=store)["version"] == "10"
    numpy.testing.assert_array_equal(
        numpy.load(os.path.join(dest, "a.npy")), numpy.ones(2))
    assert forge.fetch("m", str(tmp_path / "p"), store=store,
                       version="9")["version"] == "9"
    with pytest.raises(FileNotFoundError):
        forge.fetch("nope", dest, store=store)
    for v in ("1.10", "1.9", "1.a", "2", "0.5"):
        assert TF._version_key(v) == JF._version_key(v)


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_forge_rejects_unsafe_names(tmp_path, client):
    forge = CLIENTS[client]
    art = tmp_path / "a.npy"
    numpy.save(art, numpy.zeros(1))
    store = str(tmp_path / "store")
    for bad in ("../escape", "a/b", ".hidden"):
        with pytest.raises(ValueError, match="invalid package name"):
            forge.upload(bad, [str(art)], store=store, version="1")
    with pytest.raises(ValueError, match="invalid version"):
        forge.upload("ok", [str(art)], store=store, version="1/2")
    with pytest.raises(FileNotFoundError):
        forge.upload("ok", [str(tmp_path / "missing.npy")], store=store,
                     version="1")


def test_forge_cli(tmp_path):
    """``python -m veles_torch.forge_client`` upload, list and fetch, and
    the reference's CLI lists and fetches what it uploaded."""
    store = str(tmp_path / "store")
    art = str(tmp_path / "w.npy")
    numpy.save(art, numpy.arange(3.0))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")

    def run(module, *args):
        return subprocess.run(
            [sys.executable, "-m", module, "--store", store, *args],
            capture_output=True, text=True, env=env, check=True,
            timeout=300).stdout

    out = run("veles_torch.forge_client", "upload", "demo", art,
              "--version", "7", "--description", "a demo")
    assert out.strip().endswith("demo-7.forge.tar.gz")
    assert "demo" in run("veles_torch.forge_client", "list")
    listed = run("veles.forge_client", "list").split()
    assert listed[:2] == ["demo", "7"]
    for module, dest in (("veles_torch.forge_client", "f1"),
                         ("veles.forge_client", "f2")):
        meta = json.loads(run(module, "fetch", "demo",
                              str(tmp_path / dest)))
        assert (meta["version"], meta["description"]) == ("7", "a demo")
        assert os.path.exists(str(tmp_path / dest / "w.npy"))


@pytest.mark.parametrize("writer", sorted(CLIENTS))
def test_each_client_lists_and_fetches_the_others_packages(tmp_path,
                                                           writer):
    """One client uploads two versions of a package holding a file and a
    directory; the other lists the same metadata and fetches the newest
    with the same bytes."""
    up = CLIENTS[writer]
    down = CLIENTS["port" if writer == "reference" else "reference"]
    store = str(tmp_path / "store")
    d = tmp_path / "dir"
    d.mkdir()
    (d / "inner.json").write_text('{"a": 1}')
    art = tmp_path / "w.npy"
    for version in ("2", "11"):
        numpy.save(art, numpy.full(3, float(version)))
        up.upload("pkg", [str(art), str(d)], store=store, version=version,
                  workflow="Wf", description="v" + version)
    listed = down.list_packages(store)
    assert listed == up.list_packages(store)
    assert [m["version"] for m in listed] == ["11", "2"]
    assert listed[0]["files"] == ["w.npy", "dir"]
    meta = down.fetch("pkg", str(tmp_path / "out"), store=store)
    assert (meta["version"], meta["workflow"]) == ("11", "Wf")
    numpy.testing.assert_array_equal(
        numpy.load(str(tmp_path / "out" / "w.npy")), numpy.full(3, 11.0))
    assert (tmp_path / "out" / "dir" / "inner.json").read_text() == \
        '{"a": 1}'


def _artifacts(package, tmp_path):
    """MNIST (3 epochs at tests/test_torch_resume.py's size) trained by
    ``package`` with a snapshotter; -> (workflow, its newest best
    checkpoint, its exported inference archive)."""
    snaps = str(tmp_path / ("%s_snaps" % package))
    build = jax_mnist if package == "reference" else torch_mnist
    wf = build(3, snapdir=snaps)
    wf.run()
    ckpt = max((os.path.join(snaps, n) for n in os.listdir(snaps)),
               key=os.path.getmtime)
    archive = str(tmp_path / ("%s_archive" % package))
    wf.export_inference(archive)
    return wf, ckpt, archive


@pytest.mark.parametrize("writer", sorted(CLIENTS))
def test_packaged_checkpoint_and_archive_load_in_the_other_package(
        tmp_path, writer):
    """``writer`` trains, packages its checkpoint and inference archive
    with its own forge client; the other package's client fetches them:
    the reference and the port each restore the checkpoint into a fresh
    workflow (params within MNIST_ATOL of each other, the same
    decision), and both packages' ArchiveModels load the archive and
    predict the same rows within 1e-6 of the largest output."""
    wf, ckpt, archive = _artifacts(writer, tmp_path)
    up = CLIENTS[writer]
    down = CLIENTS["port" if writer == "reference" else "reference"]
    store = str(tmp_path / "store")
    up.upload("mnist", [ckpt, ("archive", archive)], store=store,
              version="1", workflow=wf.name)
    dest = tmp_path / "fetched"
    meta = down.fetch("mnist", str(dest), store=store)
    assert meta["files"] == [os.path.basename(ckpt), "archive"]
    fetched = str(dest / os.path.basename(ckpt))
    with open(fetched, "rb") as a, open(ckpt, "rb") as b:
        assert a.read() == b.read()
    jw = jax_mnist(3)
    jw.restore_state(JS.load_snapshot(fetched))
    tw = torch_mnist(3)
    tw.restore_state(TS.load_snapshot(fetched))
    assert_atol(jax_tree(jw), port_tree(tw), MNIST_ATOL)
    assert tw.decision.get_state()["history"] == \
        jw.decision.get_state()["history"]
    rows = numpy.asarray(tw.loader.original_data[:16], numpy.float32)
    want = JaxArchiveModel.from_dir(str(dest / "archive"))(rows)
    got = ArchiveModel.from_dir(str(dest / "archive"), device="cpu")(rows)
    assert numpy.abs(got.numpy() - want).max() <= \
        1e-6 * numpy.abs(want).max()
