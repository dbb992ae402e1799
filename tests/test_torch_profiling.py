"""The port's profiling plane (veles_torch/profiling.py) against the JAX
package's (veles/profiling.py) on the CPU: the same folded stacks render
the same speedscope and collapsed documents; the same injected spans give
the same critical-path document through both tracers (training legs with
a straggler, serving legs, the window); the memory gauges register the
same families in both packages' registries and ride the health ring, and
an RSS threshold fires an SLO; ``/debug/profile`` (200, 400 on bad
parameters, ``format=collapsed``) and ``/debug/critical_path`` answer on
both of the port's HTTP planes, the probes answering mid-capture; and
``device_memory()`` on a host without CUDA reads nothing and leaves CUDA
uninitialized, also through a health tick."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from veles import health as JH
from veles import profiling as JP
from veles import telemetry as JT
from veles_torch import health as TH
from veles_torch import profiling as TP
from veles_torch import telemetry as TT

PACKAGES = [(JP, JT), (TP, TT)]
IDS = ["ref", "port"]

#: a folded aggregate: (thread, root-first stack) -> samples
STACKS = {
    ("MainThread", (("main", "a.py", 1), ("run", "a.py", 9))): 7,
    ("MainThread", (("main", "a.py", 1), ("wait", "b.py", 3))): 2,
    ("reactor", (("_run", "r.py", 40), ("select", "s.py", 5))): 11,
    ("http-worker", ((JP._TRUNCATED_FRAME),)): 1,
}


def test_renders_equal_the_references_document_for_document():
    args = (STACKS, 21, 97.0, 0.2165, 0.0031)
    ref, port = JP.Profile(*args, truncated=1), TP.Profile(*args,
                                                           truncated=1)
    assert port.to_speedscope("cap") == ref.to_speedscope("cap")
    assert port.to_collapsed() == ref.to_collapsed()
    assert port.thread_names() == ref.thread_names()
    assert port.overhead_fraction == ref.overhead_fraction
    empty = (JP.Profile({}, 0, 97, 0, 0), TP.Profile({}, 0, 97, 0, 0))
    assert empty[0].to_speedscope() == empty[1].to_speedscope()
    assert empty[0].to_collapsed() == empty[1].to_collapsed() == ""


def test_the_sampler_names_threads_and_folds_its_overflow():
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    threads = [threading.Thread(target=spin, daemon=True, name=n)
               for n in ("busy-a", "busy-b")]
    for t in threads:
        t.start()
    try:
        prof = TP.capture_profile(0.3, hz=200)
        bounded = TP.SamplingProfiler(hz=300, max_stacks=1).start()
        time.sleep(0.2)
        bounded.stop()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    names = prof.thread_names()
    assert {"busy-a", "busy-b", "MainThread"} <= set(names)
    assert "profiler-sampler" not in names
    assert prof.ticks > 10
    assert sum(int(line.rsplit(" ", 1)[1]) for line in
               prof.to_collapsed().splitlines()) == prof.ticks
    folded = bounded.profile()
    assert folded.truncated > 0
    assert folded.to_speedscope()["veles"]["truncated_samples"] > 0


@pytest.mark.parametrize("prof", [JP, TP], ids=IDS)
def test_profile_endpoint_params_and_formats(prof):
    code, body, ctype = prof.profile_endpoint(
        "/debug/profile?seconds=0.05&hz=200")
    assert code == 200 and ctype.startswith("application/json")
    doc = json.loads(body)
    assert doc["$schema"].startswith("https://www.speedscope.app/")
    code, body, ctype = prof.profile_endpoint(
        "/debug/profile?seconds=0.05&format=collapsed")
    assert code == 200 and ctype.startswith("text/plain")
    for q in ("seconds=banana", "hz=x", "format=zorp", "hz=nan",
              "hz=inf", "seconds=nan"):
        code, body, _ = prof.profile_endpoint("/debug/profile?" + q)
        assert code == 400 and "error" in json.loads(body), q
    assert prof.SamplingProfiler(hz=float("nan")).hz == prof.DEFAULT_HZ


# -- critical path ------------------------------------------------------------


def _inject(telemetry, now):
    """Two training jobs (slave 2 the compute straggler), one serving
    request, and an old one outside a 60 s window, wall-anchored."""
    tracer = telemetry.tracer
    tracer.clear()
    ctx = [telemetry.TraceContext.from_traceparent(
        "00-%032x-%016x-01" % (i + 1, i + 1)) for i in range(4)]

    def span(name, wall, dur, c, **args):
        tracer.absorb_remote([{"name": name, "wall": wall, "dur": dur,
                               "pid": 1, "tid": 1,
                               "args": dict(c.span_args(), **args)}])

    span("job.dispatch", now - 10.0, 0.010, ctx[0], slave=1)
    span("job.wire", now - 9.99, 0.020, ctx[0], slave=1)
    span("slave.compute", now - 9.97, 0.060, ctx[0], slave=1)
    span("job.merge", now - 9.91, 0.010, ctx[0], slave=1)
    span("job.dispatch", now - 5.0, 0.010, ctx[1], slave=2)
    span("job.wire", now - 4.99, 0.020, ctx[1], slave=2)
    span("slave.compute", now - 4.97, 0.180, ctx[1], slave=2)
    span("job.merge", now - 4.79, 0.010, ctx[1], slave=2)
    span("serving.queue", now - 2.0, 0.004, ctx[2], model="m")
    span("serving.execute", now - 1.996, 0.016, ctx[2], model="m")
    span("http.predict", now - 2.0, 0.020, ctx[2], model="m")
    span("serving.execute", now - 500.0, 0.5, ctx[3], model="m")


def test_critical_path_equal_through_both_tracers():
    now = time.time()
    docs = []
    for prof, telemetry in PACKAGES:
        _inject(telemetry, now)
        doc = prof.critical_path_doc(60.0)
        routed = telemetry.debug_endpoint("/debug/critical_path?window=60")
        telemetry.tracer.clear()
        for d in (doc, routed):
            d.pop("now")
        assert doc == routed
        docs.append(doc)
    ref, port = docs
    assert port == ref
    assert port["train"]["jobs"] == 2 and port["serving"]["jobs"] == 1
    assert port["train"]["straggler"] == {"slave": "2", "mean_job_s": 0.22,
                                          "leg": "compute"}
    assert port["train"]["legs"]["compute"]["total_s"] == pytest.approx(0.24)
    assert port["serving"]["attributed_fraction"] >= 0.99


# -- memory -------------------------------------------------------------------


def _memory_families(prof, telemetry):
    with telemetry.scoped() as registry:
        prof.register_memory_gauges(registry)
        text = registry.render_prometheus()
    return sorted({line.split("{")[0].split(" ")[0]
                   for line in text.splitlines()
                   if line.startswith("veles_")}), \
        sorted(line.split(" ")[2] for line in text.splitlines()
               if line.startswith("# TYPE"))


def test_memory_gauges_register_the_same_families():
    """Host RSS and fds, the ledger's programs and bytes in both packages;
    no device kind on a host where neither has a device to read."""
    ref = _memory_families(JP, JT)
    port = _memory_families(TP, TT)
    assert port == ref
    assert ref[0] == ["veles_host_open_fds", "veles_host_rss_bytes",
                      "veles_perf_ledger_est_bytes",
                      "veles_perf_ledger_programs"]
    assert TP.host_memory()["rss_bytes"] > 1 << 20


def test_no_cuda_no_device_memory_and_no_context():
    assert not torch.cuda.is_initialized()
    assert TP.device_memory() == {}
    with TT.scoped(), TH.scoped(TH.HealthMonitor(interval=3600.0)) as mon:
        mon.tick()
        series = mon.history_doc()["series"]
    assert series["veles_host_rss_bytes"][-1][1] > 1 << 20
    assert "veles_perf_ledger_programs" in series
    assert not any(k.startswith("veles_device_") for k in series)
    assert not torch.cuda.is_initialized()


def test_device_memory_maps_the_allocator_stats(monkeypatch):
    """With CUDA initialized (stubbed here): the reference's kinds from
    torch.cuda's allocator statistics, summed over the cards."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 10 + i,
        "allocated_bytes.all.peak": 20 + i,
        "reserved_bytes.all.current": 30 + i, "num_alloc_retries": 5})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (1, 100))
    assert TP.device_memory() == {
        "bytes_in_use": 21, "peak_bytes_in_use": 41, "bytes_reserved": 61,
        "bytes_limit": 200}


def test_rss_slo_fires_on_memory_threshold():
    with TT.scoped(), TH.scoped(TH.HealthMonitor(interval=3600.0)) as mon:
        now = time.time()
        mon.tick(now=now)
        slo = mon.add_slo({
            "name": "rss_leak", "series": "veles_host_rss_bytes",
            "op": "<=", "threshold": 1.0, "target": 0.99,
            "fast_window": 30, "slow_window": 60})
        mon.tick(now=now + 1)
        assert slo.firing
        ready, reasons = mon.ready_state()
        assert not ready and any("rss_leak" in r for r in reasons)


# -- the HTTP planes ------------------------------------------------------------


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), exc.headers["Content-Type"]


@pytest.fixture(params=["web_status", "frontend"])
def plane(request):
    """A port web status or serving frontend (empty registry) on port 0,
    under scoped telemetry and an unstarted health monitor."""
    with TT.scoped(), TH.scoped(TH.HealthMonitor(interval=3600.0)):
        if request.param == "web_status":
            from veles_torch.web_status import WebStatus
            server, registry = WebStatus(port=0), None
        else:
            from veles_torch.serving.frontend import ServingFrontend
            from veles_torch.serving.registry import ModelRegistry
            registry = ModelRegistry(device="cpu")
            server = ServingFrontend(registry, port=0)
        try:
            yield "http://127.0.0.1:%d" % server.port
        finally:
            server.close()
            if registry is not None:
                registry.close()


def test_profile_and_critical_path_over_http(plane):
    code, body, ctype = _get(plane + "/debug/profile?seconds=0.3&hz=200")
    assert code == 200 and ctype.startswith("application/json")
    names = [p["name"] for p in json.loads(body)["profiles"]]
    assert "reactor" in names and "http-worker" in names, names
    code, body, ctype = _get(
        plane + "/debug/profile?seconds=0.1&format=collapsed")
    assert code == 200 and ctype.startswith("text/plain")
    assert all(";" in line for line in body.decode().splitlines())
    code, body, _ = _get(plane + "/debug/profile?hz=nan")
    assert code == 400 and "error" in json.loads(body)
    code, body, _ = _get(plane + "/debug/critical_path?window=60")
    assert code == 200
    assert set(json.loads(body)) >= {"window_s", "train", "serving",
                                     "traces"}
    # the capture runs on a worker thread: probes answer meanwhile
    capture = threading.Thread(target=_get, daemon=True, args=(
        plane + "/debug/profile?seconds=1.2",))
    capture.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    code, _, _ = _get(plane + "/healthz")
    assert code == 200 and time.perf_counter() - t0 < 0.5
    capture.join(timeout=30)
    assert not capture.is_alive()
