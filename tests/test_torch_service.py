"""The port's master/slave wire in process (the counterparts of
``tests/test_service.py``'s protocol tests): a port master and two port
slaves over localhost TCP finish 2 epochs; one unshuffled slave equals
sequential SGD over the same order within 1e-6; the wire carries every
parameter the forward declares, attention's ``weights_out`` included;
``drop_slave`` requeues; the dashboard shows the slaves; and the port
master hands out the reference master's jobs, job for job."""

import json
import os
import socket
import subprocess
import sys
import urllib.request

import numpy
import pytest
import torch

from tests.torch_cluster import close_process_planes  # noqa: F401
from tests.torch_cluster import (
    BOUND, join_all, max_diff, port_weights, port_wf, ref_wf, run_thread,
    serving)
from tests.torch_monitor import port_model_health_isolation  # noqa: F401
from veles_torch import telemetry as ttelemetry
from veles_torch.backends import TorchDevice
from veles_torch.client import SlaveClient
from veles_torch.distributable import DistributionRegistry
from veles_torch.loader.base import CLASS_TRAIN
from veles_torch.server import MasterServer
from veles_torch.web_status import WebStatus

#: one unshuffled slave against the standalone run of the same order
SEQUENTIAL_ATOL = 1e-6
#: jobs of 2 epochs of 500 train / 100 valid samples in minibatches of 50
JOBS_2_EPOCHS = 2 * (500 // 50 + 100 // 50)


@pytest.fixture(autouse=True)
def port_telemetry_isolation():
    with ttelemetry.scoped():
        yield


def _master(name, **kwargs):
    wf = port_wf(name, role="master", shuffle=kwargs.pop("shuffle", True))
    kwargs.setdefault("drain_timeout", 0.1)
    return wf, MasterServer(wf, "127.0.0.1:0", max_epochs=2, **kwargs)


def test_master_slave_protocol():
    """A port master and 2 port slaves: every job of 2 epochs served and
    acknowledged, the master's weights moved, no fault counted."""
    master_wf, server = _master("MasterWf")
    w0 = port_weights(master_wf)
    with serving(server) as addr:
        slaves = [port_wf("SlaveWf%d" % i, role="slave") for i in range(2)]
        runs = [run_thread(SlaveClient(wf, addr, name=wf.name)
                           .run_forever) for wf in slaves]
        assert not join_all([t for t, _, _ in runs])
        assert server.done.is_set()
    assert not [e for _, _, errs in runs for e in errs]
    assert sum(out[0] for _, out, _ in runs) == JOBS_2_EPOCHS
    st = server.status()
    assert st["faults"]["joins"] == 2
    assert all(st["faults"][k] == 0 for k in
               ("drops", "fenced_updates", "requeued_jobs", "stale_jobs"))
    assert max_diff(w0, port_weights(master_wf)) > 1e-4
    assert all(numpy.isfinite(v).all() for u in
               port_weights(master_wf).values() for v in u.values())


def test_single_slave_matches_standalone():
    """Delta shipping makes one unshuffled slave sequential SGD: the
    master's final weights equal a standalone run (the class dispatch
    path, shuffle off) over the same 2 epochs within SEQUENTIAL_ATOL."""
    ref = port_wf("StandaloneRef", shuffle=False)
    ref.run()
    assert ref.decision.epoch_number == 2
    master_wf, server = _master("Master1", shuffle=False)
    with serving(server) as addr:
        slave = port_wf("Slave1", role="slave", shuffle=False)
        jobs = SlaveClient(slave, addr, name="s1").run_forever()
        assert server.done.is_set()
    assert jobs == JOBS_2_EPOCHS
    assert max_diff(port_weights(master_wf), port_weights(ref)) \
        <= SEQUENTIAL_ATOL


def test_slave_runs_each_job_through_one_packed_copy():
    """The slave's one-job entry: a train job updates the device
    parameters in place of the master's weights and hands every GD unit
    its trained parameters as host float32 arrays; an eval job leaves
    the weights alone."""
    master_wf, server = _master("PackMaster", shuffle=False)
    _, sid, lease, _ = server.handle(("hello", "pack", "none"))
    slave = port_wf("PackSlave", role="slave")
    reg = DistributionRegistry(slave)
    seen = set()
    while len(seen) < 2:
        resp = server.handle(("job", sid, lease))
        _, payload, job_id, epoch = resp[:4]
        cls = payload["loader"][0]
        reg.apply_job(payload)
        # the master's weights were written into the slave's tensors
        assert max_diff(port_weights(master_wf), port_weights(slave)) == 0
        row = slave.step.run_job()
        assert row.shape == (4,) and numpy.isfinite(row).all()
        for gd in slave.gds:
            assert set(gd.wire_host) == {"weights", "bias"}
            for name, value in gd.wire_host.items():
                assert value.dtype == numpy.float32
                numpy.testing.assert_array_equal(
                    value, getattr(gd.forward, name).numpy())
        update = reg.generate_update()
        moved = max(float(numpy.abs(v).max()) for u in slave.gds
                    for v in update[u.name].values())
        assert (moved > 0) == (cls == CLASS_TRAIN)
        assert server.handle(("update", sid, lease, job_id, epoch,
                              update)) == ("ok",)
        seen.add(cls == CLASS_TRAIN)


def test_wire_protocol_carries_all_params():
    """Every parameter the forward declares rides the wire: attention's
    ``weights_out`` and ``bias_out`` as well as ``weights``/``bias``;
    deltas apply verbatim on the master."""
    from veles_torch.znicz.ops.attention import (
        GDMultiHeadAttention, MultiHeadAttention)
    fwd = MultiHeadAttention(heads=2)
    fwd.initialize((2, 8, 8), TorchDevice("cpu"))
    gd = GDMultiHeadAttention().setup_forward(fwd)
    gd.initialize()
    payload = gd.generate_data_for_slave()
    assert set(payload) == set(MultiHeadAttention.PARAMS)
    gd.apply_data_from_master(payload)
    fwd.weights_out += 0.25
    update = gd.generate_data_for_master()
    assert set(update) == {"d" + p for p in MultiHeadAttention.PARAMS}
    numpy.testing.assert_allclose(update["dweights_out"], 0.25, atol=1e-6)
    numpy.testing.assert_allclose(update["dweights"], 0.0, atol=1e-6)
    before = fwd.weights_out.clone()
    gd.apply_data_from_slave(update)
    torch.testing.assert_close(fwd.weights_out, before + 0.25,
                               atol=1e-6, rtol=0)
    with pytest.raises(KeyError, match="missing 'weights_out'"):
        gd.apply_data_from_master({k: v for k, v in payload.items()
                                   if k != "weights_out"})


def test_reply_queue_cap_holds_the_models_job_frames(monkeypatch):
    """A job frame larger than the reactor's default write-queue cap
    (here shrunk to 64 KiB below MNIST's ~318 KB frame, as a 40M-parameter
    model's 160 MB frame is above the real 64 MiB) must not drop every
    slave at its first job: the master's cap holds 3 uncompressed job
    frames of its workflow, and the run completes with no backpressure
    drop."""
    from veles_torch import reactor
    from veles_torch.server import WRITE_BUFFER_JOBS, wire_nbytes
    monkeypatch.setattr(reactor, "DEFAULT_MAX_WRITE_BUFFER", 64 << 10)
    master_wf, server = _master("CapMaster")
    frame = wire_nbytes(master_wf)
    assert frame == 4 * (784 * 100 + 100 + 100 * 10 + 10)
    assert server.max_write_buffer == WRITE_BUFFER_JOBS * frame
    with serving(server) as addr:
        jobs = SlaveClient(port_wf("CapSlave", role="slave"), addr,
                           name="cap").run_forever()
        assert server.done.is_set()
    assert jobs == JOBS_2_EPOCHS
    assert server.faults["backpressure_drops"] == 0
    assert server.faults["drops"] == 0


def test_drop_slave_requeues():
    wf = port_wf("DropWf", role="master")
    loader = wf.loader
    loader.master_start_epoch()
    total = len(loader._pending_jobs)
    job = loader.generate_data_for_slave(slave=7)
    assert job is not None and len(loader._pending_jobs) == total - 1
    assert loader.drop_slave(7) == 1
    assert len(loader._pending_jobs) == total
    assert loader._pending_jobs[0] == job


def test_master_dashboard_shows_slaves():
    """The master's dashboard row, as the launcher registers it: the
    joined slave with its job count, the fault counters and its
    last-job timing."""
    master_wf, server = _master("DashMasterWf")
    status = WebStatus(port=0)
    try:
        status.register("cluster", server.status)
        with serving(server) as addr:
            slave_wf = port_wf("DashSlaveWf", role="slave")
            client = SlaveClient(slave_wf, addr, name="dash-slave")
            # one job by hand, then read the dashboard while the lease
            # is live
            client.connect()
            while client.jobs_done < 3:
                assert client.run_one()
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/status.json" % status.port,
                    timeout=10) as resp:
                seen = json.loads(resp.read().decode())["cluster"]
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/" % status.port, timeout=10) as r:
                page = r.read()
            client._close_sock()
    finally:
        status.close()
    assert seen["mode"] == "master" and seen["n_slaves"] == 1, seen
    row = next(iter(seen["slaves"].values()))
    assert row["name"] == "dash-slave" and row["jobs"] == 3, row
    assert row["last_rtt_s"] is not None and row["last_job_s"] is not None
    assert b"cluster" in page and b"dash-slave" in page


def _job_sequence(server, n_updates):
    """(cls, indices, job_id, epoch) of the jobs ``server`` (either
    package's master) serves one slave that acknowledges each with an
    empty update, until it says bye."""
    hello = server.handle(("hello", "seq", "none"))
    sid, lease = hello[1], hello[2]
    seq = []
    for _ in range(n_updates):
        resp = server.handle(("job", sid, lease))
        if resp[0] == "bye":
            return seq
        if resp[0] == "wait":
            continue
        _, payload, job_id, epoch = resp[:4]
        cls, idx = payload["loader"]
        seq.append((int(cls), list(idx), job_id, epoch))
        assert server.handle(("update", sid, lease, job_id, epoch,
                              {"loader": None}))[0] == "ok"
    raise AssertionError("master never said bye")


def test_job_sequence_equals_the_reference_masters():
    """Same seed, shuffled: the port master's jobs are the reference
    master's, job for job: class, indices, job id and epoch, over 3
    epochs (its own shuffle generator, seeded ``state_seed +
    0x9E3779B9``)."""
    from veles.server import MasterServer as JaxMasterServer
    jwf = ref_wf("SeqRef", max_epochs=3)
    jseq = _job_sequence(JaxMasterServer(jwf, "127.0.0.1:0", max_epochs=3),
                         200)
    twf = port_wf("SeqPort", role="master", max_epochs=3)
    tseq = _job_sequence(MasterServer(twf, "127.0.0.1:0", max_epochs=3),
                         200)
    assert len(tseq) == 3 * (500 // 50 + 100 // 50)
    assert tseq == jseq
    train = [tuple(idx) for cls, idx, _, ep in tseq if cls == CLASS_TRAIN
             and ep == 0]
    assert train != sorted(train)       # the train class was shuffled


# -- the CLI: master and slaves as processes ----------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "veles_torch", "znicz", "models", "mnist.py")
CLI_SIZES = ["--seed", "555", "root.mnist.loader.minibatch_size=50",
             "root.mnist.loader.n_train=500", "root.mnist.loader.n_valid=100",
             "root.mnist.decision.max_epochs=2"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(*args):
    """Start ``python -m veles_torch`` on the MNIST sample on ``-d cpu``
    with the small sizes; -> the process."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "veles_torch", MNIST, "-d", "cpu",
         "--no-stats", *CLI_SIZES, *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs):
    """Wait for every process within BOUND; -> their (rc, stdout,
    stderr); kills whatever is left on the way out."""
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=BOUND)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_cli_master_and_two_slaves_finish_two_epochs(tmp_path):
    """A master and two slaves as processes on ``-d cpu``, every wire
    flag given: the master serves every job of 2 epochs, the slaves'
    jobs add up to them, and the result lines carry the master's
    cluster status and wire bytes and each slave's counters."""
    addr = "127.0.0.1:%d" % _free_port()
    mres = tmp_path / "master.json"
    master = _cli("--listen-address", addr, "--slave-timeout", "30",
                  "--grad-codec", "int8", "--grad-topk-percent", "5",
                  "--rollback-on-divergence", "--stash-interval", "2",
                  "--result-file", str(mres))
    slaves = [_cli("--master-address", addr, "--slave-retries", "0",
                   "--grad-codec", "int8", "--result-file",
                   str(tmp_path / ("slave%d.json" % i)))
              for i in range(2)]
    for rc, so, se in _finish([master] + slaves):
        assert rc == 0, se[-3000:]
    m = json.loads(mres.read_text())
    assert m["mode"] == "master" and m["device"] == "cpu"
    cluster = m["cluster"]
    assert cluster["complete"] and cluster["epoch"] == 2
    assert cluster["grad_codec"] == "int8"
    assert cluster["faults"]["joins"] == 2
    assert cluster["faults"]["codec_fallbacks"] == 0
    assert m["wire_bytes"]["rx"] > 0 and m["wire_bytes"]["tx"] > 0
    jobs = 0
    for i in range(2):
        s = json.loads((tmp_path / ("slave%d.json" % i)).read_text())
        assert s["mode"] == "slave" and s["slave"]["codec"] == "int8"
        jobs += s["slave"]["jobs"]
    assert jobs == JOBS_2_EPOCHS


def test_cli_master_resumes_its_persisted_queue(tmp_path):
    """A master persisted mid-epoch (its queue with the in-flight job
    folded back) resumes through ``--snapshot auto:DIR`` as a process:
    one slave finishes the run with exactly the jobs left."""
    from veles_torch.snapshotter import FileSnapshotStore
    wf = port_wf("MnistWorkflow", role="master")
    store = FileSnapshotStore(str(tmp_path))
    server = MasterServer(wf, "127.0.0.1:0", max_epochs=2,
                          checkpoint_store=store)
    _, sid, lease, _ = server.handle(("hello", "first", "none"))
    merged = 0
    for _ in range(7):
        resp = server.handle(("job", sid, lease))
        assert resp[0] == "job"
        if merged < 5:
            assert server.handle(("update", sid, lease, resp[2], resp[3],
                                  {"loader": None}))[0] == "ok"
            merged += 1
    # 7 served, 5 merged: 2 in flight fold back into the queue
    assert server.persist_state("test")
    left = JOBS_2_EPOCHS - merged
    addr = "127.0.0.1:%d" % _free_port()
    mres, sres = tmp_path / "m.json", tmp_path / "s.json"
    master = _cli("--listen-address", addr, "--snapshot",
                  "auto:%s" % tmp_path, "--result-file", str(mres))
    slave = _cli("--master-address", addr, "--result-file", str(sres))
    for rc, so, se in _finish([master, slave]):
        assert rc == 0, se[-3000:]
    assert json.loads(sres.read_text())["slave"]["jobs"] == left
    cluster = json.loads(mres.read_text())["cluster"]
    assert cluster["complete"] and cluster["epoch"] == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_package_reads_the_others_master_tree(tmp_path, writer):
    """A master tree persisted by one package (weights, queue, epoch,
    counters, the shuffle generator) resumes a master of the other: the
    same queue, epoch and job numbering, and the same jobs after it."""
    from veles import snapshotter as jsnap
    from veles.server import MasterServer as JaxMasterServer
    from veles_torch import snapshotter as tsnap
    pkgs = {"port": (lambda n: port_wf(n, role="master"), MasterServer,
                     tsnap),
            "reference": (lambda n: ref_wf(n), JaxMasterServer, jsnap)}
    reader = "reference" if writer == "port" else "port"
    make_w, Server_w, snap_w = pkgs[writer]
    wf = make_w("MnistWorkflow")
    server = Server_w(wf, "127.0.0.1:0", max_epochs=3,
                      checkpoint_store=snap_w.FileSnapshotStore(
                          str(tmp_path)))
    hello = server.handle(("hello", "w", "none"))
    for _ in range(15):        # into the second epoch's shuffle
        resp = server.handle(("job", hello[1], hello[2]))
        if resp[0] == "job":
            server.handle(("update", hello[1], hello[2], resp[2], resp[3],
                           {"loader": None}))
    assert server.persist_state("test")
    name = [n for n in sorted(os.listdir(tmp_path))
            if "_master-" in n][-1]
    make_r, Server_r, snap_r = pkgs[reader]
    tree = snap_r.load_snapshot(str(tmp_path / name))
    assert set(tree) >= {"master", "workflow"}
    wf2 = make_r("MnistWorkflow")
    wf2.restore_state(tree["workflow"])
    resumed = Server_r(wf2, "127.0.0.1:0", max_epochs=3,
                       resume_state=tree["master"])
    assert resumed.epoch == server.epoch == 1
    assert resumed._next_job == server._next_job
    assert wf2.loader._pending_jobs == [
        (int(c), [int(i) for i in idx]) for c, idx in wf.loader._pending_jobs]

    assert _job_sequence(resumed, 200) == _job_sequence(server, 200)
