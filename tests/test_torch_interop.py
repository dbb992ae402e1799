"""The port's master and slaves work with the reference's over the wire:
a reference ``MasterServer`` trains with one unshuffled port slave, and a
port master with one unshuffled reference slave (the reference's fused
step on the CPU, per-step as its slaves run); each run's final master
weights equal an all-reference run's within INTEROP_ATOL. A port slave
in a subprocess under a reference master ends with no module of the
reference in ``sys.modules``: the frames it unpickled named only plain
data."""

import json
import os
import subprocess
import sys

import pytest

from tests.torch_cluster import close_process_planes  # noqa: F401
from tests.torch_cluster import (
    BOUND, max_diff, port_weights, port_wf, ref_weights, ref_wf, serving)
from tests.torch_monitor import port_model_health_isolation  # noqa: F401
from veles import model_health as jmodel_health
from veles import telemetry as jtelemetry
from veles.client import SlaveClient as JaxSlaveClient
from veles.server import MasterServer as JaxMasterServer
from veles_torch import telemetry as ttelemetry
from veles_torch.client import SlaveClient
from veles_torch.server import MasterServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "veles_torch", "znicz", "models", "mnist.py")
#: a mixed run's final master weights against the all-reference run's
#: (both slaves train the same float32 chain; the sums run in another
#: order)
INTEROP_ATOL = 1e-5
JOBS_2_EPOCHS = 2 * (500 // 50 + 100 // 50)


@pytest.fixture(autouse=True)
def port_telemetry_isolation():
    with ttelemetry.scoped():
        yield


def _ref_master(name):
    wf = ref_wf(name, shuffle=False)
    return wf, JaxMasterServer(wf, "127.0.0.1:0", max_epochs=2,
                               drain_timeout=0.1)


def _ref_slave(name):
    return ref_wf(name, backend="cpu", slave=True, shuffle=False)


@pytest.fixture(scope="module")
def all_reference():
    """Final master weights of a reference master with one unshuffled
    reference slave (the fused step on the CPU). Module-scoped, so it runs
    outside the per-test isolation: under fresh registries and model
    monitors of its own, leaving the process-global ones as it found
    them."""
    with jtelemetry.scoped(), jmodel_health.scoped():
        wf, server = _ref_master("AllRefMaster")
        with serving(server) as addr:
            jobs = JaxSlaveClient(_ref_slave("AllRefSlave"), addr,
                                  name="ref").run_forever()
            assert server.done.is_set()
    assert jobs == JOBS_2_EPOCHS
    return ref_weights(wf)


def test_port_slave_under_reference_master(all_reference):
    wf, server = _ref_master("RefMaster")
    with serving(server) as addr:
        slave = port_wf("PortSlave", role="slave", shuffle=False)
        jobs = SlaveClient(slave, addr, name="port").run_forever()
        assert server.done.is_set()
    assert jobs == JOBS_2_EPOCHS
    st = server.status()
    assert st["faults"]["unmerged_updates"] == 0, st
    assert st["faults"]["codec_fallbacks"] == 0, st
    assert max_diff(ref_weights(wf), all_reference) <= INTEROP_ATOL


def test_reference_slave_under_port_master(all_reference):
    wf = port_wf("PortMaster", role="master", shuffle=False)
    server = MasterServer(wf, "127.0.0.1:0", max_epochs=2,
                          drain_timeout=0.1)
    with serving(server) as addr:
        jobs = JaxSlaveClient(_ref_slave("RefSlave"), addr,
                              name="ref").run_forever()
        assert server.done.is_set()
    assert jobs == JOBS_2_EPOCHS
    assert server.status()["faults"]["unmerged_updates"] == 0
    assert max_diff(port_weights(wf), all_reference) <= INTEROP_ATOL


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_codec_negotiates_across_packages(codec):
    """A port slave offering the reference master's codec gets it: the
    welcome names it, no fallback is counted, and the master merges
    the slave's encoded deltas."""
    wf = ref_wf("CodecRefMaster", shuffle=False)
    server = JaxMasterServer(wf, "127.0.0.1:0", max_epochs=2,
                             grad_codec=codec, drain_timeout=0.1)
    with serving(server) as addr:
        slave = port_wf("CodecPortSlave", role="slave", shuffle=False)
        client = SlaveClient(slave, addr, name="port", grad_codec=codec)
        assert client.run_forever() == JOBS_2_EPOCHS
    assert client._codec_active == (codec, 1.0)
    st = server.status()
    assert st["faults"]["codec_fallbacks"] == 0
    assert st["faults"]["unmerged_updates"] == 0


def test_port_slave_process_loads_no_reference_module():
    """A port slave in its own process (the CLI on ``-d cpu``) under a
    reference master: it trains every job, and no ``veles`` module is
    in its ``sys.modules`` when it ends."""
    wf, server = _ref_master("ProcRefMaster")
    script = (
        "import json, sys\n"
        "from veles_torch.__main__ import main\n"
        "main(sys.argv[1:])\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] == 'veles')))\n")
    with serving(server) as addr:
        out = subprocess.run(
            [sys.executable, "-c", script, MNIST, "-d", "cpu",
             "--seed", "555", "--no-stats", "--master-address", addr,
             "root.mnist.loader.minibatch_size=50",
             "root.mnist.loader.n_train=500",
             "root.mnist.loader.n_valid=100"],
            cwd=REPO, capture_output=True, text=True, timeout=BOUND,
            env=dict(os.environ, PYTHONPATH=REPO))
        assert server.done.is_set(), out.stdout[-2000:] + out.stderr[-2000:]
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == []
    result = json.loads(lines[-2])
    assert result["mode"] == "slave"
    assert result["slave"]["jobs"] == JOBS_2_EPOCHS
    # the CPU twin ran: no kernel launches off the card
    assert result["launches"]["bias_grad"] == {"identity": 0, "masked": 0}
    assert server.status()["faults"]["unmerged_updates"] == 0
