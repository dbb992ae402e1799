"""The port's master/slave wire under injected faults (the counterparts
of ``tests/test_chaos.py`` and of the master-side tests of
``tests/test_model_health.py``): lease fencing, a reconnect through a
connection kill, a silent slave dropped at ``slave_timeout`` with its
job requeued, a duplicated update fenced, two slaves converging through
a ``ChaosProxy`` under every codec, ``request_stop`` ending the retry
loop, absorbed slave summaries evicted with their slave, and a
``poison_update`` NaN rolled back by the master's ``WeightGuard`` at its
stash interval.

Every fault is placed by a plan or a seeded generator, never by timing;
waits are on events the code under test sets, each bounded by
``BOUND``."""

import socket
import struct
import threading

import numpy
import pytest

from tests.torch_cluster import close_process_planes  # noqa: F401
from tests.torch_cluster import (
    BOUND, join_all, max_diff, port_weights, port_wf, run_thread, serving)
from veles_torch import model_health, telemetry as ttelemetry
from veles_torch.chaos import (
    C2S, DUP, S2C, TRUNCATE, ChaosProxy, poison_update)
from veles_torch.client import SlaveClient
from veles_torch.distributable import DistributionRegistry
from veles_torch.loader.base import CLASS_TRAIN
from veles_torch.server import MasterServer, recv_frame, send_frame

#: the reference's chaos tolerance: two slaves interleave, so only the
#: order of the merges differs from the sequential run (and, under a
#: lossy codec, the bounded residual tail)
CHAOS_ATOL = 0.02


@pytest.fixture(autouse=True)
def port_isolation():
    with ttelemetry.scoped(), model_health.scoped():
        yield


def _master(name, **kwargs):
    wf = port_wf(name, role="master", shuffle=kwargs.pop("shuffle", True))
    kwargs.setdefault("drain_timeout", 0.1)
    return wf, MasterServer(wf, "127.0.0.1:0", max_epochs=2, **kwargs)


def _hook(obj, attr, event):
    """Wrap the bound method ``obj.attr`` so each call sets ``event``
    after it returns."""
    orig = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        try:
            return orig(*args, **kwargs)
        finally:
            event.set()
    setattr(obj, attr, wrapped)


def _train_job(server, sid, lease):
    """Pull jobs until a train one; -> (payload, job_id, epoch)."""
    for _ in range(64):
        resp = server.handle(("job", sid, lease))
        assert resp[0] == "job", resp
        if resp[1]["loader"][0] == CLASS_TRAIN:
            return resp[1], resp[2], resp[3]
        assert server.handle(("update", sid, lease, resp[2], resp[3],
                              {}))[0] == "ok"
    pytest.fail("no train job served")


def test_unknown_or_revoked_slave_is_fenced():
    _, server = _master("FenceUnknown")
    assert server.handle(("job", 999, "bogus")) == ("stale",)
    assert server.handle(("ping", 999, "bogus")) == ("stale",)
    assert server.handle(("update", 999, "bogus", 1, 0, {})) == ("stale",)
    assert server.faults["stale_jobs"] == 1
    assert server.faults["stale_pings"] == 1
    assert server.faults["fenced_updates"] == 1
    kind, sid, lease = server.handle(("hello", "zombie"))
    assert kind == "welcome" and lease
    assert server.handle(("job", sid, "not-the-lease")) == ("stale",)
    assert server.handle(("ping", sid, lease)) == ("pong", 0)
    server.drop_slave(sid)
    assert server.faults["drops"] == 1
    assert server.handle(("job", sid, lease)) == ("stale",)


def test_duplicate_update_fenced_weights_identical():
    """A replayed update leaves the master's weights bitwise identical:
    its job id was consumed."""
    master_wf, server = _master("FenceMaster")
    _, sid, lease = server.handle(("hello", "fence-slave"))
    slave = port_wf("FenceSlave", role="slave")
    sreg = DistributionRegistry(slave)
    payload, job_id, epoch = _train_job(server, sid, lease)
    sreg.apply_job(payload)
    slave.step.run_job()
    update = sreg.generate_update()
    assert server.handle(
        ("update", sid, lease, job_id, epoch, update)) == ("ok",)
    once = port_weights(master_wf)
    assert server.handle(
        ("update", sid, lease, job_id, epoch, update)) == ("stale",)
    assert server.faults["fenced_updates"] == 1
    assert max_diff(once, port_weights(master_wf)) == 0.0


def test_silent_slave_dropped_at_timeout_and_requeued():
    """A slave that takes a job and goes silent (no FIN, no frames) is
    swept within ``slave_timeout``: dropped, its job requeued at the head
    of the queue, and a healthy slave finishes the run."""
    master_wf, server = _master("SilentMaster", slave_timeout=2.0)
    dropped = threading.Event()
    _hook(server, "drop_slave", dropped)
    with serving(server) as addr:
        sock = socket.create_connection(server.bound_address, timeout=10)
        try:
            send_frame(sock, ("hello", "silent"))
            _, sid, lease = recv_frame(sock)
            send_frame(sock, ("job", sid, lease))
            resp = recv_frame(sock)
            assert resp[0] == "job"
            stolen = resp[1]["loader"]
            assert dropped.wait(BOUND), "the silent slave was never swept"
            st = server.status()
            assert st["faults"]["drops"] == 1, st
            assert st["faults"]["requeued_jobs"] == 1, st
            assert master_wf.loader._pending_jobs[0] == stolen
        finally:
            sock.close()
        # its heartbeat beats well inside the timeout, so the sweep
        # never takes it for silent while it computes
        healthy = port_wf("SilentHealthy", role="slave")
        SlaveClient(healthy, addr, name="healthy",
                    ping_interval=0.2).run_forever()
        assert server.done.is_set()


def test_mid_job_kill_requeues_and_completes():
    """A slave killed mid-job (RST, no update) is dropped at once and
    its job requeued; a healthy slave finishes the run."""
    master_wf, server = _master("KillMaster", slave_timeout=5.0)
    dropped = threading.Event()
    _hook(server, "drop_slave", dropped)
    with serving(server) as addr:
        sock = socket.create_connection(server.bound_address, timeout=10)
        send_frame(sock, ("hello", "doomed"))
        _, sid, lease = recv_frame(sock)
        send_frame(sock, ("job", sid, lease))
        stolen = recv_frame(sock)[1]["loader"]
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
        assert dropped.wait(BOUND)
        assert master_wf.loader._pending_jobs[0] == stolen
        SlaveClient(port_wf("KillHealthy", role="slave"), addr,
                    name="healthy").run_forever()
        assert server.done.is_set()
    st = server.status()
    assert st["faults"]["drops"] == 1 and st["faults"]["requeued_jobs"] == 1


def test_slave_reconnects_through_connection_kill():
    """The proxy holds the slave's third job reply until the test has
    severed every connection: the slave sees its connection die
    mid-request, re-hellos on a fresh lease and finishes the run."""
    master_wf, server = _master("ReconMaster", slave_timeout=5.0)
    held, killed = threading.Event(), threading.Event()
    count = {"jobs": 0}

    def plan(evt):
        if evt.direction == S2C and evt.kind == "job":
            count["jobs"] += 1
            if count["jobs"] == 3:
                held.set()
                killed.wait(BOUND)
        return None

    with serving(server) as addr:
        with ChaosProxy(("127.0.0.1", server.bound_address[1]),
                        plan=plan) as proxy:
            client = SlaveClient(port_wf("ReconSlave", role="slave"),
                                 proxy.address, name="recon",
                                 io_timeout=5.0, retry_base=0.02,
                                 retry_max=0.2, max_retries=20)
            t, out, errors = run_thread(client.run_forever)
            assert held.wait(BOUND), "the slave never got going"
            assert proxy.kill_all() == 1
            killed.set()
            assert not join_all([t])
        assert not errors, errors
        assert server.done.is_set()
    assert client.reconnects >= 1
    assert server.status()["faults"]["drops"] >= 1
    assert out[0] >= 2 * (500 // 50 + 100 // 50) - 1


def _sequential_reference():
    """The fault-free single-process run over the master's unshuffled
    order: the port's class dispatch, 2 epochs."""
    ref = port_wf("ChaosRef", shuffle=False)
    ref.run()
    return port_weights(ref)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "topk"])
def test_two_slaves_converge_through_chaos(codec):
    """2 slaves through a ChaosProxy that duplicates one update frame,
    truncates one job reply (a mid-job death) and drops and delays
    frames from a seeded generator: the run completes, a drop and a
    fenced update are counted, the codec ran (its payloads shrank), and
    the master's first-layer weights lie within CHAOS_ATOL of the
    fault-free sequential run's (the reference's check)."""
    w_ref = _sequential_reference()
    master_wf, server = _master("ChaosMaster-%s" % codec, shuffle=False,
                                slave_timeout=5.0, grad_codec=codec,
                                grad_topk_percent=25.0)
    lock = threading.Lock()
    seen = {"updates": 0, "jobs": 0, "dup": False, "cut": False}

    def plan(evt):
        with lock:
            if evt.direction == C2S and evt.kind == "update":
                seen["updates"] += 1
                if seen["updates"] == 3 and not seen["dup"]:
                    seen["dup"] = True
                    return DUP
            if evt.direction == S2C and evt.kind == "job":
                seen["jobs"] += 1
                if seen["jobs"] == 5 and not seen["cut"]:
                    seen["cut"] = True
                    return TRUNCATE
        return None

    with serving(server) as addr:
        with ChaosProxy(("127.0.0.1", server.bound_address[1]), seed=1337,
                        plan=plan, drop_rate=0.01, delay_rate=0.10,
                        delay_s=0.01) as proxy:
            errors = []

            def run_slave(idx):
                client = SlaveClient(
                    port_wf("ChaosSlave%d" % idx, role="slave"),
                    proxy.address, name="chaos-%d" % idx, io_timeout=2.0,
                    retry_base=0.02, retry_max=0.25, max_retries=25,
                    grad_codec=codec, grad_topk_percent=25.0)
                try:
                    client.run_forever()
                except ConnectionError:
                    if not server.done.is_set():
                        errors.append("gave up before done")

            runs = [run_thread(run_slave, i) for i in range(2)]
            assert not join_all([t for t, _, _ in runs])
            assert not errors and not [e for _, _, es in runs for e in es]
            assert server.done.is_set(), server.status()
    st = server.status()
    assert seen["dup"] and seen["cut"], seen
    assert st["faults"]["drops"] >= 1, st
    assert st["faults"]["fenced_updates"] >= 1, st
    assert st["faults"]["codec_fallbacks"] == 0, st
    w = port_weights(master_wf)
    assert all(numpy.isfinite(v).all() for u in w.values()
               for v in u.values())
    # the reference's check: the first layer's weights
    first = master_wf.forwards[0].name
    assert float(numpy.abs(w[first]["weights"]
                           - w_ref[first]["weights"]).max()) <= CHAOS_ATOL
    if codec != "none":
        reg = ttelemetry.get_registry()
        raw = reg.counter_total("veles_grad_codec_raw_bytes_total",
                                codec=codec)
        enc = reg.counter_total("veles_grad_codec_encoded_bytes_total",
                                codec=codec)
        assert raw > 0 and enc < raw * 0.55, (enc, raw)


def test_clean_completion_counts_no_faults():
    _, server = _master("CleanMaster")
    with serving(server) as addr:
        SlaveClient(port_wf("CleanSlave", role="slave"), addr,
                    name="clean").run_forever()
        assert server.done.is_set()
    st = server.status()
    assert st["faults"]["drops"] == 0, st
    assert st["faults"]["fenced_updates"] == 0, st
    assert st["faults"]["requeued_jobs"] == 0, st


def test_request_stop_ends_the_retry_forever_loop():
    """With nothing listening and ``max_retries=None``, the slave sits in
    reconnect backoff; ``request_stop`` ends ``run_forever`` at once."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = probe.getsockname()[1]
    probe.close()
    client = SlaveClient(port_wf("StopWf", role="slave"),
                         "127.0.0.1:%d" % dead, io_timeout=0.5,
                         retry_base=30.0, retry_max=60.0, max_retries=None)
    backing_off = threading.Event()
    _hook(client, "_backoff", backing_off)
    t, out, errors = run_thread(client.run_forever)
    assert backing_off.wait(BOUND)
    client.request_stop()
    assert not join_all([t], bound=10.0)
    assert out == [0] and not errors


def test_client_gives_up_after_max_retries():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = probe.getsockname()[1]
    probe.close()
    client = SlaveClient(port_wf("GiveUpWf", role="slave"),
                         "127.0.0.1:%d" % dead, io_timeout=0.5,
                         retry_base=0.01, retry_max=0.05, max_retries=3)
    with pytest.raises(ConnectionError, match="giving up"):
        client.run_forever()
    assert client.reconnects == 3


def test_absorbed_slave_summary_rides_and_is_evicted():
    """The ``__telemetry__`` side channel: a pushed model summary lands
    slave-labelled on the master's monitor; dropping the slave evicts it
    and its series."""
    _, server = _master("MHAbsorb")
    _, sid, _lease = server.handle(("hello", "evict-slave"))
    server._absorb_telemetry(
        {"model": {"loss": 0.7, "verdict": "healthy",
                   "layers": {"fc": {"grad_norm": 2.0, "weight_norm": 3.0,
                                     "update_ratio": 0.02,
                                     "nonfinite": 0}}}}, sid)
    mon = model_health.get_model_monitor()
    assert str(sid) in mon.snapshot()["slaves"]
    values = {items: c.value for items, c in
              ttelemetry.get_registry().gauge("veles_model_loss").children()}
    assert values[(("slave", str(sid)),)] == 0.7
    server.drop_slave(sid)
    assert str(sid) not in mon.snapshot()["slaves"]
    for name in ("veles_model_loss", "veles_model_grad_norm"):
        fam = ttelemetry.get_registry().gauge(name)
        assert not any(("slave", str(sid)) in items
                       for items, _ in fam.children()), name


def test_slave_pushes_its_summary_and_counters():
    """A port slave's update frames carry its counter state, job seconds
    and model summary; the master absorbs the counters slave-labelled
    and the summary under the slave's id."""
    _, server = _master("PushMaster")
    with serving(server) as addr:
        client = SlaveClient(port_wf("PushSlave", role="slave"), addr,
                             name="push")
        client.run_forever()
    reg = ttelemetry.get_registry()
    assert reg.counter_total("veles_slave_jobs_done_total") > 0
    assert any(("slave", "1") in items for items, _ in
               reg.counter("veles_slave_jobs_done_total").children())
    assert server.faults["drops"] == 0


def test_poison_update_rolls_back_at_the_stash_interval():
    """``--rollback-on-divergence --stash-interval 3`` on a port master:
    a NaN-poisoned delta merged on the 5th update flips the verdict to
    diverged, and the WeightGuard's tick restores the stash of the 3rd
    merge (the last multiple of the interval), exactly, once."""
    master_wf, server = _master("PoisonMaster", shuffle=False,
                                rollback_on_divergence=True,
                                stash_interval=3)
    _, sid, lease = server.handle(("hello", "poison"))
    slave = port_wf("PoisonSlave", role="slave")
    sreg = DistributionRegistry(slave)
    after = []
    for n in range(1, 6):
        payload, job_id, epoch = _train_job(server, sid, lease)
        sreg.apply_job(payload)
        slave.step.run_job()
        update = sreg.generate_update()
        if n == 5:
            uname, entry = poison_update(update)
            assert entry.startswith("d")
        before = server._weight_guard.rollback_count
        assert server.handle(("update", sid, lease, job_id, epoch,
                              update)) == ("ok",)
        after.append(port_weights(master_wf))
        assert server._weight_guard.rollback_count == before + (n == 5)
    # every train update merges (and ticks the guard); the eval jobs
    # were acknowledged empty and merged nothing: the 5 merges stashed
    # at the 1st and the 3rd, and the 5th restored the 3rd's exactly
    guard = server._weight_guard
    assert guard._merges == 5 and guard.rollback_count == 1
    w = port_weights(master_wf)
    assert max_diff(w, after[2]) == 0.0
    assert max_diff(after[2], after[3]) > 0.0
    assert model_health.get_model_monitor().snapshot()["verdict"] \
        != "diverged"
