"""The port's continual training (veles_torch/continual.py, the
ContinualStreamLoader of veles_torch/loader/stream.py) against the JAX
package's (veles/continual.py, veles/loader/stream.py): the round order
and cursor, resume with no replay and no skip, a loader state of either
package resumed by the other at the same cursor, fetch failures counted
and retried, the int32 guard, the HTTP ingest wire between the packages,
``continual_loop`` over 2 rounds against the reference's (same data order,
parameters within float32 order error) publishing the trainer's staleness,
checkpoints stamped with ``ingest_wall``, the serving registry's
``veles_staleness_seconds{point="serving:<model>"}`` reading it, and the
staleness SLO firing on a black-holed source (the reference's
BrownoutProxy in front of the port's ``stream_handler``) and resolving."""

import os
import threading
import time

import numpy
import pytest

import veles.prng as jprng
from veles import continual as jcontinual
from veles import snapshotter as jsnap
from veles.loader.stream import ArraySource as JaxArraySource
from veles.loader.stream import ContinualStreamLoader as JaxContinual
from veles.workflow import Workflow
from veles.znicz_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
import veles_torch.prng as tprng
from veles_torch import continual, health, snapshotter, telemetry
from veles_torch.convert import params_from_jax, params_to_numpy
from veles_torch.loader.stream import ArraySource, ContinualStreamLoader
from veles_torch.reactor import HttpServer
from veles_torch.serving.registry import ModelRegistry
from veles_torch.znicz.standard_workflow import StandardWorkflow

from tests.torch_monitor import port_model_health_isolation  # noqa: F401

#: continual_loop's parameters against the reference's after 2 rounds
#: (f32 products in another order)
LOOP_ATOL = 1e-4


def wait_until(fn, timeout=30.0, interval=0.02, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError("timed out waiting for %s" % what)


@pytest.fixture(autouse=True)
def isolated():
    """A fresh registry for the port's series, and no ingest clock left
    registered in either package (a later checkpoint would carry it)."""
    with telemetry.scoped():
        yield
    continual.register_ingest_clock(None)
    jcontinual.register_ingest_clock(None)


def _arrays(n=256, dim=16, seed=5):
    rng = numpy.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, dim)).astype(numpy.float32),
            rng.randint(0, 4, n).astype(numpy.int32))


def _loader(name="loader", source=None, **kwargs):
    kwargs.setdefault("minibatch_size", 32)
    kwargs.setdefault("round_samples", 128)
    kwargs.setdefault("valid_samples", 32)
    ld = ContinualStreamLoader(name=name,
                               source=source or ArraySource(*_arrays()),
                               **kwargs)
    ld.initialize()
    return ld


def _jax_loader(name="loader", source=None, **kwargs):
    kwargs.setdefault("minibatch_size", 32)
    kwargs.setdefault("round_samples", 128)
    kwargs.setdefault("valid_samples", 32)
    ld = JaxContinual(Workflow(None, name="CW_" + name), name=name,
                      source=source or JaxArraySource(*_arrays()), **kwargs)
    ld.initialize()
    return ld


def _serve_round(ld):
    """One round as the step serves it: every class's windows, then the
    epoch's end. -> (train indices, train data)."""
    idx, data = [], []
    for cls, idx_mat, valids in ld.epoch_plan():
        win = ld.materialize_window(cls, idx_mat)
        if cls == 2:
            for row, rows, v in zip(idx_mat, win["data"], valids):
                idx.extend(row[:v].tolist())
                data.append(rows[:v])
    ld.next_epoch()
    return idx, numpy.concatenate(data)


def _jax_round(ld):
    idx, data = [], []
    while True:
        ld.run()
        if int(ld.minibatch_class) == 2:
            size = int(ld.minibatch_size)
            idx.extend(ld.minibatch_indices.mem[:size].tolist())
            data.append(numpy.array(ld.minibatch_data.mem[:size]))
        if bool(ld.epoch_ended):
            return idx, numpy.concatenate(data)


def test_rounds_advance_cursor_and_serve_stream_order():
    """Round after round: the cursor, the train indices and the data equal
    the reference loader's; the buffer stays under its cap."""
    src = ArraySource(*_arrays())
    ld, ref = _loader(source=src), _jax_loader()
    try:
        assert ld.cursor_base == ref.cursor_base == 32
        off = ld.class_offset(2)
        for r in range(3):
            got_idx, got = _serve_round(ld)
            want_idx, want = _jax_round(ref)
            assert got_idx == want_idx == list(
                range(off + 32 + 128 * r, off + 160 + 128 * r))
            numpy.testing.assert_array_equal(got, want)
            assert ld.cursor_base == ref.cursor_base == 160 + 128 * r
        numpy.testing.assert_array_equal(
            _serve_round(ld)[1][:32], src.fetch(416, 32)["data"])
        assert len(ld._blocks) <= ld.prefetch_blocks
        assert ld.last_ingest_wall > 0
        assert ld.get_state()["stream_cursor"]["cursor_base"] == 544
    finally:
        ld.stop()
        ref.stop()
    assert not ld._producer.is_alive()


def test_checkpoint_cursor_resume_no_replay_no_skip():
    a = _loader(name="a")
    try:
        _serve_round(a)
        state = a.get_state()
        assert state["stream_cursor"]["cursor_base"] == 160
        next_round = _serve_round(a)[0]
    finally:
        a.stop()
    b = _loader(name="b")
    try:
        b.set_state(state)
        assert _serve_round(b)[0] == next_round
    finally:
        b.stop()


def test_either_package_resumes_the_others_cursor():
    """A loader state of each package, restored into the other, serves the
    round the original would have served next, with the same data."""
    port, ref = _loader(name="p"), _jax_loader(name="r")
    try:
        _serve_round(port)
        _serve_round(port)
        _jax_round(ref)
        port_state, ref_state = port.get_state(), ref.get_state()
        assert port_state["stream_cursor"]["cursor_base"] == 288
        assert sorted(ref_state["stream_cursor"]) == \
            sorted(port_state["stream_cursor"])
        want_port_next = _serve_round(port)
        want_ref_next = _jax_round(ref)
    finally:
        port.stop()
        ref.stop()
    port2, ref2 = _loader(name="p2"), _jax_loader(name="r2")
    try:
        ref2.set_state(port_state)
        port2.set_state(ref_state)
        got_ref = _jax_round(ref2)
        got_port = _serve_round(port2)
    finally:
        port2.stop()
        ref2.stop()
    assert got_ref[0] == want_port_next[0]
    numpy.testing.assert_array_equal(got_ref[1], want_port_next[1])
    assert got_port[0] == want_ref_next[0]
    numpy.testing.assert_array_equal(got_port[1], want_ref_next[1])


def test_shard_assignment_is_sticky_and_steals_orphans():
    """The master's shards (the reference's ``test_continual.py``
    counterpart): each slave pulls only its own shard while both live;
    a dead slave's shard is stolen, so the round drains; the queue
    filled claims the round."""
    ld = _loader(shards=2, valid_samples=0, round_samples=128)
    try:
        ld.master_start_epoch()
        assert ld.cursor_base == 128
        mb = ld.max_minibatch_size

        def shard_of(job):
            return (int(job[1][0]) // mb) % 2

        j1 = ld.generate_data_for_slave("s1")
        j2 = ld.generate_data_for_slave("s2")
        assert shard_of(j1) == ld._slave_shards["s1"]
        assert shard_of(j2) == ld._slave_shards["s2"]
        assert shard_of(j1) != shard_of(j2)
        j1b = ld.generate_data_for_slave("s1")
        assert shard_of(j1b) == shard_of(j1)
        ld.drop_slave("s2")
        served = {tuple(j[1]) for j in (j1, j1b)}
        while True:
            job = ld.generate_data_for_slave("s1")
            if job is None:
                break
            assert tuple(job[1]) not in served
            served.add(tuple(job[1]))
        assert not ld._pending_jobs
        assert len(served) == 128 // mb
    finally:
        ld.stop()


def test_sharded_jobs_equal_the_references():
    """The same calls on both packages' loaders (3 slaves on 2 shards, a
    wait, a drop, 2 rounds) hand out the same jobs in the same order."""
    port = _loader(name="p", shards=2, valid_samples=32)
    ref = _jax_loader(name="r", shards=2, valid_samples=32)
    calls = ["a", "b", "c", "a", "b", "c", "drop:b", "a", "c", "a", "c",
             "a", "c", "a", "c", "a", "c"]
    try:
        got = {"p": [], "r": []}
        for key, ld in (("p", port), ("r", ref)):
            for _ in range(2):
                ld.master_start_epoch()
                for call in calls:
                    if call.startswith("drop:"):
                        got[key].append(("drop", ld.drop_slave(call[5:])))
                        continue
                    job = ld.generate_data_for_slave(call)
                    got[key].append(None if job is None else
                                    (int(job[0]), list(job[1])))
                    if job is not None:
                        ld.apply_data_from_slave({}, call)
            got[key].append(("cursor", int(ld.cursor_base)))
    finally:
        port.stop()
        ref.stop()
    assert got["p"] == got["r"]
    assert None in got["p"]               # a slave was told to wait


def test_fetch_failures_counted_and_retried():
    class Flaky(ArraySource):
        def __init__(self, *args):
            super().__init__(*args)
            self.failures = 2

        def fetch(self, start, count):
            if start >= 32 and self.failures:
                self.failures -= 1
                raise OSError("synthetic ingest outage")
            return super().fetch(start, count)

    rng = numpy.random.RandomState(3)
    src = Flaky(rng.uniform(-1, 1, (64, 8)).astype(numpy.float32),
                rng.randint(0, 4, 64).astype(numpy.int32))
    ld = _loader(source=src, fetch_retry_s=0.01)
    try:
        idx, data = _serve_round(ld)
        assert src.failures == 0
        assert len(idx) == 128
        assert telemetry.get_registry().counter_total(
            "veles_stream_fetch_failures_total") == 2.0
    finally:
        ld.stop()


def test_int32_guard_refuses_the_same_stream_position():
    """Both packages accept the last round below int32's bound and refuse
    the next position (the reference draws the order as it restores, the
    port when the epoch is planned)."""
    top = numpy.iinfo(numpy.int32).max
    last_ok = top - 128 - 32          # + round_samples + the train offset
    for cursor, refused in ((last_ok, False), (last_ok + 1, True)):
        ld, ref = _loader(), _jax_loader()
        try:
            state = ld.get_state()
            state["stream_cursor"]["cursor_base"] = cursor
            ld.set_state(state)
            if refused:
                with pytest.raises(OverflowError, match="int32"):
                    ld.epoch_plan()
                with pytest.raises(OverflowError, match="int32"):
                    ref.set_state(state)
            else:
                assert ld.epoch_plan()[-1][1].max() == top - 1
                ref.set_state(state)
        finally:
            ld.stop()
            ref.stop()


def test_http_wire_between_the_packages():
    """The port's stream_handler serves the reference's HttpStreamSource
    and the reference's handler serves the port's: the same spec and
    bytes."""
    from veles.reactor import HttpServer as JaxHttpServer
    data, labels = _arrays(n=40, dim=6)
    servers = [HttpServer("127.0.0.1", 0, continual.stream_handler(
                   ArraySource(data, labels)), name="ingest"),
               JaxHttpServer("127.0.0.1", 0, jcontinual.stream_handler(
                   JaxArraySource(data, labels)), name="ingest")]
    try:
        port_srv, ref_srv = ("http://127.0.0.1:%d" % s.port
                             for s in servers)
        for src in (jcontinual.HttpStreamSource(port_srv),
                    continual.HttpStreamSource(ref_srv),
                    continual.HttpStreamSource(port_srv)):
            assert src.spec() == {"data": ((6,), numpy.dtype("float32")),
                                  "labels": ((), numpy.dtype("int32"))}
            got = src.fetch(35, 10)
            rows = numpy.arange(35, 45) % 40
            numpy.testing.assert_array_equal(got["data"], data[rows])
            numpy.testing.assert_array_equal(got["labels"], labels[rows])
    finally:
        for s in servers:
            s.close()


# -- the trainer loop ------------------------------------------------------


def _layers():
    gd = {"learning_rate": 0.02, "weights_decay": 0.0,
          "gradient_moment": 0.5}
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 100},
             "<-": dict(gd)},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": dict(gd)}]


def _mnist_like(n=1024):
    rng = numpy.random.RandomState(7)
    return (rng.uniform(-1, 1, (n, 784)).astype(numpy.float32),
            rng.randint(0, 10, n).astype(numpy.int32))


def _continual_workflow(name, snapdir=None):
    tprng.seed_all(1313)
    data, labels = _mnist_like()
    extra = {}
    if snapdir:
        extra["snapshotter_config"] = {"directory": snapdir}
    wf = StandardWorkflow(
        name=name, layers=_layers(),
        loader_factory=lambda w: ContinualStreamLoader(
            w, name="loader", minibatch_size=32,
            source=ArraySource(data, labels), round_samples=128,
            valid_samples=64),
        decision_config={"max_epochs": 1, "fail_iterations": 50}, **extra)
    return wf.initialize(device="cpu")


def _jax_continual_workflow(name):
    jprng.seed_all(1313)
    data, labels = _mnist_like()
    wf = JaxStandardWorkflow(
        None, name=name, layers=_layers(),
        loader_factory=lambda w: JaxContinual(
            w, name="loader", minibatch_size=32,
            source=JaxArraySource(data, labels), round_samples=128,
            valid_samples=64),
        decision_config={"max_epochs": 1, "fail_iterations": 50})
    wf.initialize(device="cpu")
    return wf


def test_continual_loop_runs_rounds_and_publishes_staleness():
    """2 rounds over successive stream windows, the ingest clock and the
    trainer's staleness gauge published, patience disarmed; the
    parameters equal the reference loop's within LOOP_ATOL."""
    wf = _continual_workflow("ContinualRounds")
    jw = _jax_continual_workflow("JaxContinualRounds")
    try:
        start = {u.name: {**u.export_params(), **u.export_state()}
                 for u in jw.forwards + jw.gds}
        wf.import_tree(params_from_jax(
            {u: s for u, s in start.items() if s}))
        assert continual.continual_loop(wf, rounds=2) == 2
        assert jcontinual.continual_loop(jw, rounds=2) == 2
        assert wf.decision.epoch_number == 2
        assert wf.loader.cursor_base == jw.loader.cursor_base == 64 + 256
        wall = continual.ingest_wall()
        assert wall and time.time() - wall < 60.0
        reg = telemetry.get_registry()
        assert reg.counter_total("veles_continual_rounds_total") == 2.0
        stale = reg.gauge(continual.STALENESS_FAMILY,
                          labels=("point",)).labels("trainer").value
        assert 0.0 <= stale < 60.0
        assert wf.decision.fail_iterations == float("inf")
        events = [e for e in telemetry.tracer.recent_events()
                  if e["event"] == "continual_round"
                  and e.get("workflow") == "ContinualRounds"]
        assert [e["round"] for e in events[-2:]] == [1, 2]
        got = params_to_numpy(wf.export_tree())
        for u in jw.forwards + jw.gds:
            for key, value in {**u.export_params(),
                               **u.export_state()}.items():
                diff = numpy.abs(numpy.asarray(value, numpy.float64)
                                 - got[u.name][key]).max()
                assert diff <= LOOP_ATOL, (u.name, key, diff)
        for jh, th in zip(jw.decision.history, wf.decision.history):
            assert jh["train"]["samples"] == th["train"]["samples"] == 128
            assert abs(jh["train"]["loss"] - th["train"]["loss"]) < 1e-4
    finally:
        wf.close()
        jw.loader.stop()


def test_checkpoints_carry_ingest_wall(tmp_path):
    """A checkpoint written in a continual run carries the loader's
    ingest wall in its manifest, read the same by both packages' scans;
    the serving registry's point gauge reads it."""
    wf = _continual_workflow("ContinualSnap", snapdir=str(tmp_path))
    try:
        continual.continual_loop(wf, rounds=1)
        path = wf.snapshotter.export_snapshot(slot="current")
        assert path
        archive = wf.export_inference(str(tmp_path / "archive"))
    finally:
        wf.close()
    infos = [i for i in snapshotter.scan_checkpoints(str(tmp_path))
             if i.status == "valid"]
    newest = infos[0]
    assert newest.ingest_wall is not None
    assert abs(newest.ingest_wall - wf.loader.last_ingest_wall) < 1e-6
    assert newest.health_verdict == "healthy"
    ref_info = [i for i in jsnap.scan_checkpoints(str(tmp_path))
                if i.name == newest.name][0]
    assert ref_info.ingest_wall == newest.ingest_wall
    reg = ModelRegistry(device="cpu")
    try:
        reg.load("mnist", os.path.dirname(archive),
                 refresh_store=str(tmp_path))
        stale = telemetry.get_registry().gauge(
            continual.STALENESS_FAMILY, labels=("point",)).labels(
                "serving:mnist")
        assert stale.value == 0.0          # the archive: no stamp
        assert reg.refresh_newest("mnist") is not None
        meta = reg.get("mnist").model.checkpoint_meta
        assert meta["ingest_wall"] == newest.ingest_wall
        age = time.time() - newest.ingest_wall
        assert 0.0 <= stale.value and abs(stale.value - age) < 5.0
    finally:
        reg.close()


def test_blackhole_ingest_fires_staleness_slo_and_resolves():
    """The reference's BrownoutProxy black-holes the port's HTTP ingest
    wire: the round stalls, staleness climbs past the objective, the
    alert fires and /readyz names it; restoring the wire finishes the
    round and the alert resolves."""
    from veles.chaos import BrownoutProxy
    data, labels = _arrays(n=64, dim=8)
    server = HttpServer("127.0.0.1", 0, continual.stream_handler(
        ArraySource(data, labels)), name="ingest")
    proxy = BrownoutProxy("127.0.0.1:%d" % server.port)
    mon = health.HealthMonitor(interval=3600)     # ticked here
    ld = None
    runner = None
    try:
        src = continual.HttpStreamSource(proxy.url, timeout=0.3)
        ld = _loader(source=src, minibatch_size=16, round_samples=64,
                     valid_samples=16, fetch_retry_s=0.05,
                     prefetch_blocks=2)
        continual.register_ingest_clock(lambda: ld.last_ingest_wall)
        continual.install_point_gauge("trainer", continual.ingest_wall)
        assert continual.install_staleness_slo(
            threshold=0.3, monitor=mon, fast_window=0.5,
            slow_window=1.0) == 1
        assert continual.install_staleness_slo(
            threshold=0.3, monitor=mon) == 0
        _serve_round(ld)
        mon.tick()
        assert not mon.slos()[0].firing

        def tick_firing():
            mon.tick()
            return mon.slos()[0].firing

        proxy.set_black_hole(True)
        rounds, stop_evt = [0], threading.Event()

        def round_pump():
            try:
                while not stop_evt.is_set():
                    _serve_round(ld)
                    rounds[0] += 1
            except RuntimeError:
                pass    # the loader stopped under it

        runner = threading.Thread(target=round_pump, daemon=True)
        runner.start()
        wait_until(tick_firing, timeout=30.0, interval=0.1,
                   what="staleness alert to fire")
        assert rounds[0] == 0, "a round finished through a black hole"
        ok, reasons = mon.ready_state()
        assert ok is False
        assert any("staleness" in r for r in reasons)
        # the alert can fire before the first fetch's 0.3 s timeout ends
        wait_until(lambda: telemetry.get_registry().counter_total(
            "veles_stream_fetch_failures_total") >= 1.0,
            what="a failed fetch to be counted")
        proxy.restore()
        wait_until(lambda: rounds[0] > 0, timeout=30.0,
                   what="the wedged round to complete")
        wait_until(lambda: not tick_firing(), timeout=30.0, interval=0.1,
                   what="staleness alert to resolve")
        assert mon.ready_state()[0] is True
        stop_evt.set()
    finally:
        if ld is not None:
            ld.stop()
        if runner is not None:
            runner.join(10)
        proxy.kill_all()
        mon.close()
        server.close()
    assert runner is None or not runner.is_alive()


def test_windows_grabbed_out_of_order_both_complete():
    """The step stages two windows at once, so the higher one may be
    materialized first: the lower one's blocks stay buffered until it is
    served (evicting up to the higher window's top would leave it
    waiting forever), then both windows' blocks go."""
    src = ArraySource(*_arrays())
    ld = _loader(source=src, valid_samples=0, round_samples=256)
    try:
        (cls, idx_mat, _), = ld.epoch_plan()
        low, high = idx_mat[:4], idx_mat[4:]
        got_high = ld.materialize_window(cls, high)
        result = {}
        worker = threading.Thread(
            target=lambda: result.update(
                low=ld.materialize_window(cls, low)), daemon=True)
        worker.start()
        worker.join(10)
        assert not worker.is_alive(), "the lower window never completed"
        numpy.testing.assert_array_equal(
            result["low"]["data"].reshape(-1, 16), src.fetch(0, 128)["data"])
        numpy.testing.assert_array_equal(
            got_high["data"].reshape(-1, 16), src.fetch(128, 128)["data"])
        assert ld._served_floor == 256 and not ld._grabbed
        assert all(b >= 256 // 32 for b in ld._blocks)
    finally:
        ld.stop()


def test_concurrent_windows_stress():
    """16 threads (more than the cores) materialize a round's 16 windows
    in a shuffled order under a short switch interval: every window holds
    its own stream positions, all complete, and the floor reaches the
    round's end."""
    import random
    import sys
    src = ArraySource(*_arrays(n=1024))
    ld = _loader(source=src, valid_samples=0, round_samples=512,
                 minibatch_size=8, prefetch_blocks=4)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        (cls, idx_mat, _), = ld.epoch_plan()
        windows = [idx_mat[i:i + 4] for i in range(0, len(idx_mat), 4)]
        order = list(range(len(windows)))
        random.Random(3).shuffle(order)
        got = {}
        threads = [threading.Thread(
            target=lambda k=k: got.update(
                {k: ld.materialize_window(cls, windows[k])}), daemon=True)
            for k in order]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
        ld.stop()
    assert sorted(got) == list(range(16))
    for k, win in got.items():
        numpy.testing.assert_array_equal(
            win["data"].reshape(-1, 16), src.fetch(32 * k, 32)["data"])
    assert ld._served_floor == 512 and not ld._grabbed
