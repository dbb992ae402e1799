"""The port's health plane (veles_torch/health.py) against the JAX
package's (veles/health.py): the same SLO file over the same scripted
series, ticked at the same injected clock, gives the same burn rates,
the same firing and resolved alerts (and ``slo_alert`` events), the same
``/readyz`` reasons from the same checks, and ``/metrics/history`` with
the same keys; the model-health plane's ``register_health`` and
``install_model_slos`` flip readiness on a diverged verdict in both."""

import json
import types

import pytest

from veles import health as JH
from veles import model_health as JMH
from veles import reactor as JR
from veles import telemetry as JT
from veles_torch import health as TH
from veles_torch import model_health as TMH
from veles_torch import reactor as TR
from veles_torch import telemetry as TT

SLOS = [
    {"name": "p99",
     "series": 'veles_serving_latency_seconds{model="m"}:p99',
     "op": "<=", "threshold": 0.1, "target": 0.9, "fast_window": 5,
     "slow_window": 20},
    {"name": "errors", "kind": "ratio", "bad": "veles_serving_errors_total",
     "total": "veles_serving_requests_total", "target": 0.99,
     "fast_window": 5, "slow_window": 20},
]

#: per tick: (latency observations, requests, errors)
SCRIPT = [([0.01] * 5, 5, 0)] * 4 + [([0.5] * 5, 5, 3)] * 6 + \
    [([0.01] * 5, 5, 0)] * 30


class _Clock:
    """The one clock of a run: every tick (the monitor's own at
    construction, ``add_slo`` and ``add_check``, and the scripted ones)
    and ``history_doc``'s read see ``now``, never the wall clock."""

    def __init__(self, now):
        self.now = float(now)

    def time(self):
        return self.now


@pytest.fixture(autouse=True)
def quiet_process_threads():
    """Threads that outlive a test write into whatever registry is active:
    the port's process-global health monitor, when an earlier test's
    training run in this process started it, samples and evaluates its
    SLOs on a thread of its own, and each package's process-global
    reactor (started by an earlier frontend or web status) sets its loop
    lag gauge every 0.25 s. Either lands in the scoped registry of a run
    below, at times the machine's load decides. Close the port's monitor
    and stop both reactors (their threads joined) for this test; the next
    ``get_monitor()`` / ``get_reactor()`` makes fresh ones. The port's
    process-global tracer is cleared too: its event log holds earlier
    tests' ``slo_alert`` events (the frontend tests' ``always_bad``),
    which the comparison of the runs' last events would read. The
    reference's monitor is closed and its tracer cleared after every
    test by ``tests/conftest.py``."""
    previous = TH.set_monitor(None)
    if previous is not None:
        previous.close()
    for reactor in (TR, JR):
        previous = reactor.set_reactor(None)
        if previous is not None:
            previous.stop()
    TT.tracer.clear()
    yield


@pytest.fixture(scope="module")
def lagging_port_reactor():
    """The port's process-global reactor started with a 1 ms lag probe,
    as an earlier test in this process would leave it; module-scoped, so
    it is started before the function-scoped isolation fixture runs."""
    reactor = TR.Reactor()
    reactor.LAG_PROBE_INTERVAL = 0.001
    TR.set_reactor(reactor)
    reactor.ensure_started()
    yield reactor
    reactor.stop()


def _run(health, telemetry, tmp_path, monkeypatch):
    path = tmp_path / "slos.json"
    path.write_text(json.dumps(SLOS))
    clock = _Clock(999.0)
    monkeypatch.setattr(health, "time", types.SimpleNamespace(
        time=clock.time))
    with telemetry.scoped():
        mon = health.HealthMonitor(interval=3600.0)
        try:
            assert mon.load_slo_file(str(path)) == 2
            flag = {"ok": True}
            mon.add_check("gate", lambda: (flag["ok"], None if flag["ok"]
                                           else "gate closed"))
            h = telemetry.histogram("veles_serving_latency_seconds", "",
                                    ("model",)).labels("m")
            req = telemetry.counter("veles_serving_requests_total", "",
                                    ("model",)).labels("m")
            err = telemetry.counter("veles_serving_errors_total", "",
                                    ("model",)).labels("m")
            trail = []
            for i, (lat, n, bad) in enumerate(SCRIPT):
                for v in lat:
                    h.observe(v)
                req.inc(n)
                err.inc(bad)
                flag["ok"] = i != 12
                clock.now = 1000.0 + i
                mon.tick(now=1000.0 + i)
                ready, reasons = mon.ready_state()
                doc = mon.probe("/readyz")[1]
                trail.append((ready, reasons, {
                    k: (v["firing"], round(v["burn_fast"], 9),
                        round(v["burn_slow"], 9))
                    for k, v in doc["slos"].items()}))
            history = set(mon.history_doc()["series"])
            events = [(e["event"], e.get("objective"), e.get("state"))
                      for e in telemetry.tracer.recent_events()
                      if e["event"] == "slo_alert"]
            return trail, sorted(history), events
        finally:
            mon.close()


def test_same_series_same_alerts_reasons_and_history(tmp_path, monkeypatch):
    ref = _run(JH, JT, tmp_path, monkeypatch)
    port = _run(TH, TT, tmp_path, monkeypatch)
    # the memory gauges (veles_host_*, veles_perf_ledger_*) are in both
    # histories; neither package has device memory to report here
    assert {"veles_host_rss_bytes", "veles_host_open_fds",
            "veles_perf_ledger_programs"} <= set(port[1])
    assert ref[0] == port[0]
    assert ref[1] == port[1]
    assert ref[2][-4:] == port[2][-4:]
    fired = [t for t in ref[0] if not t[0]]
    assert any("slo:p99 firing" in " ".join(r) for _, r, _ in fired)
    assert any("gate: gate closed" in r for _, rs, _ in fired for r in rs)
    # the error ratio's alert resolves once the window holds clean
    # deltas again
    assert ref[0][12][2]["errors"][0] and not ref[0][-1][2]["errors"][0]


@pytest.mark.parametrize("health,mh,telemetry", [(JH, JMH, JT),
                                                 (TH, TMH, TT)],
                         ids=["ref", "port"])
def test_divergence_check_and_model_slos(health, mh, telemetry):
    with telemetry.scoped(), mh.scoped() as monitor:
        mon = health.HealthMonitor(interval=3600.0)
        try:
            monitor.register_health(mon)
            assert mh.install_model_slos(mon) == 3
            assert mh.install_model_slos(mon) == 0
            mon.tick()
            assert mon.ready_state() == (True, [])
            monitor.observe_loss(float("nan"), epoch=0)
            mon.tick()
            ready, reasons = mon.ready_state()
            assert not ready
            assert reasons[0] == \
                "model:divergence: model diverged: loss_nonfinite"
            assert any(r.startswith("slo:model_divergence firing")
                       for r in reasons)
            assert mh.debug_model_doc()["verdict"] == "diverged"
            assert telemetry.get_registry().counter_total(
                "veles_model_nonfinite_total") == 1
            assert "model_divergence" in [
                e["event"] for e in telemetry.tracer.recent_events()]
        finally:
            mon.close()


def test_a_running_reactor_writes_into_neither_history(
        lagging_port_reactor, tmp_path, monkeypatch):
    """A port reactor left running by an earlier test (here with a 1 ms lag
    probe) is stopped before the run: the two histories stay equal, with
    no ``veles_reactor_loop_lag_seconds`` on the port's side."""
    assert not lagging_port_reactor.alive
    ref = _run(JH, JT, tmp_path, monkeypatch)
    port = _run(TH, TT, tmp_path, monkeypatch)
    assert ref[1] == port[1]
    assert "veles_reactor_loop_lag_seconds" not in port[1]
