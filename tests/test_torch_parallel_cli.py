"""The CLI modes under the LM's parallel axes (veles_torch/__main__.py,
genetics.py's ``SubprocessTrainer``, launcher.py's slave path,
``parallel.relay_job``/``follow_jobs``) on gloo ranks of this host:

* ``--generate`` under ``data=2`` and ``model=2`` and ``--generate-text``
  under ``data=2``: rank 0 decodes from the full weights the ranks
  gather; the tokens equal the reference CLI's and the port's one
  process;
* ``--ensemble 2`` under ``data=2`` and ``expert=2``, ``--optimize
  1x2`` in process and ``--optimize 1x2x2`` over worker processes under
  ``data=2``: the reports equal the one-process ones (members' errors,
  the search's values and fitness);
* a slave of 2 ranks under a port master and under a reference master:
  the master's final weights within 1e-5 of an all-reference run; and
  through the CLI a host master (``--listen-address``, no ranks) with a
  slave of 2 ranks (``--master-address``), the master's archive within
  1e-5 of a one-process slave's.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys

import numpy
import pytest

from veles.__main__ import main as jax_main
from veles.client import SlaveClient as JaxSlaveClient
from veles.config import root as jroot
from veles.server import MasterServer as JaxMasterServer
from veles_torch.__main__ import main as torch_main
from veles_torch.config import root as troot
from veles_torch.server import MasterServer
from veles_torch.znicz import parallel
from tests.torch_cluster import close_process_planes  # noqa: F401
from tests.torch_cluster import (
    max_diff, port_weights, port_wf, ref_weights, ref_wf, serving)
from tests.torch_monitor import port_model_health_isolation  # noqa: F401
from tests.torch_parallel_workers import RankGroup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_LM = os.path.join(REPO, "veles_torch", "znicz", "models",
                        "transformer_lm.py")
JAX_LM = os.path.join(REPO, "veles", "znicz_tpu", "models",
                      "transformer_lm.py")
SMALL = ["root.lm.loader.n_train=64", "root.lm.loader.n_valid=32",
         "root.lm.loader.minibatch_size=16", "root.lm.model.dim=32",
         "root.lm.model.ffn_hidden=64", "root.lm.model.layers=1",
         "root.lm.decision.max_epochs=2"]
TAIL = ["-d", "cpu", "--seed", "1337", "--no-stats"]
ONE_EPOCH = ["root.lm.decision.max_epochs=1"]
GENERATE = ["--generate", "1,2,3", "--gen-tokens", "8"]
CORPUS = "the quick brown fox jumps over the lazy dog. " * 40
TEXT = ["root.lm.loader.seq_len=16", "root.lm.loader.valid_ratio=0.1",
        "--generate-text", "the ", "--gen-tokens", "12"]
#: the master's final weights, a 2-rank slave against an all-reference
#: run and against a one-process slave (f32 sums of two shards)
SLAVE_ATOL = 1e-5
#: the search's fitness, data=2 against one process
FITNESS_RTOL = 1e-5
JOBS_2_EPOCHS = 2 * (500 // 50 + 100 // 50)


@pytest.fixture(autouse=True)
def lm_config():
    """Both packages' root.lm, put back after each test."""
    saved = [(r, copy.deepcopy(r.lm.to_dict())) for r in (jroot, troot)]
    yield
    for r, tree in saved:
        r.lm.update(tree)


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _generated(out):
    return [line for line in out.splitlines()
            if line.startswith("generated: ")]


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text(CORPUS, encoding="utf-8")
    return str(path)


#: {kind: (the reference CLI's line, the port's one process's)}
_ONE_DEVICE = {}


@pytest.mark.parametrize("mode", ["data_tokens", "model_tokens",
                                  "data_text"])
def test_generate_under_the_axes_equals_reference(mode, corpus, capfd):
    """Training under ``data=2`` or ``model=2`` (2 gloo ranks), then greedy
    decoding on rank 0 from the gathered weights: the same line as the
    reference CLI's one-process run and the port's."""
    axis, kind = mode.split("_")
    line = SMALL + (GENERATE if kind == "tokens" else [
        "root.lm.loader.text_file=%r" % corpus] + TEXT)
    if kind not in _ONE_DEVICE:
        jax_main([JAX_LM] + line + TAIL)
        ref = _generated(capfd.readouterr().out)
        torch_main([TORCH_LM] + line + TAIL)
        _ONE_DEVICE[kind] = ref, _generated(capfd.readouterr().out)
    want, one = _ONE_DEVICE[kind]
    assert torch_main([TORCH_LM, "root.lm.parallel.%s=2" % axis] + line
                      + TAIL) is not None
    got = _generated(capfd.readouterr().out)
    assert len(want) == 1 and got == one == want, (got, one, want)


@pytest.mark.parametrize("axis,model", [
    ("data", ()), ("expert", ("root.lm.model.moe_experts=4",))],
    ids=["data", "expert"])
def test_ensemble_under_the_axes_equals_one_process(axis, model, capfd):
    """``--ensemble 2``: every rank trains both members on the mesh from
    the same seeds and evaluates them (under ``expert`` each rank its
    rows of a validation minibatch, the outputs gathered); rank 0 prints
    the report, the one process's."""
    line = SMALL + list(model) + TAIL
    assert torch_main([TORCH_LM, "root.lm.parallel.%s=2" % axis,
                       "--ensemble", "2"] + line) == 0
    got = _last_json(capfd.readouterr().out)
    torch_main([TORCH_LM, "--ensemble", "2"] + line)
    want = _last_json(capfd.readouterr().out)
    assert got == want


@pytest.fixture
def tune_config(tmp_path):
    path = tmp_path / "tune.py"
    path.write_text("from veles_torch.config import Tune, root\n"
                    "root.lm.train.learning_rate = Tune(0.02, 0.005, "
                    "0.1)\n")
    return str(path)


def test_optimize_under_data2_in_process_and_in_workers(tune_config,
                                                         capfd):
    """``--optimize 1x2`` in process (the search on every rank, each
    individual trained on the mesh, rank 0 reports) and ``1x2x2`` (no
    ranks in this process; each worker's individual spawns a group of
    its own): the same values and evaluations as one process, the
    fitness within 1e-5."""
    torch_main([TORCH_LM, tune_config, "--optimize", "1x2"] + SMALL + TAIL)
    want = _last_json(capfd.readouterr().out)
    for spec in ("1x2", "1x2x2"):
        assert torch_main([TORCH_LM, tune_config, "root.lm.parallel.data=2",
                           "--optimize", spec] + SMALL + TAIL) is not None
        got = _last_json(capfd.readouterr().out)
        assert got["best_values"] == want["best_values"]
        assert got["evaluations"] == want["evaluations"] == 2
        assert abs(got["best_fitness"] - want["best_fitness"]) \
            <= FITNESS_RTOL * want["best_fitness"]
        assert got.get("workers") == (2 if spec == "1x2x2" else None)


@pytest.fixture(scope="module")
def all_reference():
    """A reference master's final weights after 2 epochs with one
    unshuffled reference slave."""
    from veles import model_health as jmodel_health
    from veles import telemetry as jtelemetry
    with jtelemetry.scoped(), jmodel_health.scoped():
        wf = ref_wf("AllRefMaster", shuffle=False)
        server = JaxMasterServer(wf, "127.0.0.1:0", max_epochs=2,
                                 drain_timeout=0.1)
        with serving(server) as addr:
            jobs = JaxSlaveClient(ref_wf("AllRefSlave", backend="cpu",
                                         slave=True, shuffle=False),
                                  addr, name="ref").run_forever()
    assert jobs == JOBS_2_EPOCHS
    return ref_weights(wf)


@pytest.mark.parametrize("master", ["port", "reference"])
def test_two_rank_slave_under_a_master(master, all_reference):
    """One slave of 2 gloo ranks (``data=2``): rank 0 pulls every job and
    relays it, both ranks run it on their rows, the update goes out as
    the full arrays; the master merges every job and ends within 1e-5 of
    the all-reference run."""
    if master == "port":
        wf = port_wf("PortMaster", role="master", shuffle=False)
        server = MasterServer(wf, "127.0.0.1:0", max_epochs=2,
                              drain_timeout=0.1)
    else:
        wf = ref_wf("RefMaster", shuffle=False)
        server = JaxMasterServer(wf, "127.0.0.1:0", max_epochs=2,
                                 drain_timeout=0.1)
    group = RankGroup(2)
    try:
        with serving(server) as addr:
            jobs = group.run("slave_dp", (("data", 2),), addr, 2)
            assert server.done.is_set()
    finally:
        group.close()
    assert jobs == [JOBS_2_EPOCHS, None]
    assert server.status()["faults"]["unmerged_updates"] == 0
    weights = port_weights(wf) if master == "port" else ref_weights(wf)
    assert max_diff(weights, all_reference) <= SLAVE_ATOL


@contextlib.contextmanager
def _master(tmp_path, tag, archive):
    """A CLI master of the LM on a free port (its own process, no
    ranks) -> its address; on exit it has finished (or is killed)."""
    port = parallel.free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_torch", TORCH_LM,
         "root.lm.parallel.data=2", "--listen-address",
         "127.0.0.1:%d" % port, "--export-inference", archive]
        + SMALL + ONE_EPOCH + TAIL, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        yield "127.0.0.1:%d" % port, proc
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out[-3000:]
        master = _last_json(out)
        assert master["mode"] == "master"
        assert master["cuda_initialized"] is False
        assert "parallel" not in master
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _archive(path):
    return {f: numpy.load(os.path.join(path, f))
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


def test_cli_host_master_with_a_two_rank_slave(tmp_path, capfd):
    """``--listen-address`` under ``root.lm.parallel.data=2`` runs here on
    the host without ranks; ``--master-address`` spawns the slave's 2
    ranks. The master's archive after every job of an epoch equals,
    within 1e-5, a master's served by a one-process slave."""
    got_dir, want_dir = str(tmp_path / "got"), str(tmp_path / "want")
    for archive, axes in ((got_dir, ["root.lm.parallel.data=2"]),
                          (want_dir, [])):
        with _master(tmp_path, "m", archive) as (addr, _):
            torch_main([TORCH_LM, *axes, "--master-address", addr,
                        "--slave-retries", "40"] + SMALL + ONE_EPOCH + TAIL)
        slave = _last_json(capfd.readouterr().out)
        assert slave["mode"] == "slave" and slave["slave"]["jobs"] == 6
        assert ("parallel" in slave) == bool(axes)
    got, want = _archive(got_dir), _archive(want_dir)
    assert sorted(got) == sorted(want) and got
    for name in want:
        numpy.testing.assert_allclose(got[name], want[name], rtol=0,
                                      atol=SLAVE_ATOL * max(
                                          1.0, numpy.abs(want[name]).max()))
