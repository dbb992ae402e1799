"""The port's fleet view and CLI tooling (veles_torch/fleet.py,
``python -m veles_torch top|profile``, ``--workflow-graph``,
``--dump-unit-sizes``, ``--no-stats``, ``--background --log-file``)
against the JAX package's on the CPU: ``parse_prometheus`` and
``metric_total`` read the same texts alike; ``top --once --json`` of
either package scrapes a port web status and a reference one into rows
with the same keys; ``profile`` exits 0 with a summary and 2 when the
target is unreachable or garbled, as ``top`` exits 2 when no target is
reachable; the MNIST sample's unit graph has the reference's nodes and
edges; the three run flags work in a subprocess."""

import contextlib
import http.server
import json
import os
import re
import socketserver
import subprocess
import sys
import threading
import time

import pytest

from veles import fleet as JF
from veles import health as JH
from veles import telemetry as JT
from veles.__main__ import main as jax_main
from veles.__main__ import profile_main as jax_profile_main
from veles.web_status import WebStatus as JaxWebStatus
from veles_torch import fleet as TF
from veles_torch import health as TH
from veles_torch import telemetry as TT
from veles_torch.__main__ import main as torch_main
from veles_torch.__main__ import profile_main
from veles_torch.web_status import WebStatus as TorchWebStatus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_MNIST = os.path.join(REPO, "veles_torch", "znicz", "models",
                           "mnist.py")
JAX_MNIST = os.path.join(REPO, "veles", "znicz_tpu", "models", "mnist.py")
SMALL = ["root.mnist.loader.n_train=200", "root.mnist.loader.n_valid=50",
         "root.mnist.decision.max_epochs=1"]

TEXT = "\n".join([
    "# HELP veles_x_total a counter",
    "# TYPE veles_x_total counter",
    'veles_x_total{kind="train",model="a"} 3',
    'veles_x_total{kind="valid",model="a"} 4.5',
    'veles_x_total{kind="train",model="b"} 1e3',
    'veles_path{p="C:\\\\new",q="say \\"hi\\"\\nthere"} 2',
    "veles_plain 7",
    "veles_bad{ 1",
    "veles_nan NaN",
    "garbage line here",
    'veles_lat_bucket{le="0.1"} 2',
    'veles_lat_bucket{le="+Inf"} 5',
])


def _rendered_text():
    with TT.scoped() as registry:
        TT.counter("veles_serving_requests_total", "r",
                   ("model", "tenant")).labels("m", 'a"b').inc(3)
        TT.gauge("veles_host_rss_bytes", "rss").set(123456789)
        h = TT.histogram("veles_serving_latency_seconds", "l", ("model",))
        for v in (0.01, 0.02, 0.5):
            h.labels("m").observe(v)
        return registry.render_prometheus()


@pytest.mark.parametrize("text", [TEXT, "render"], ids=["hand", "render"])
def test_parse_prometheus_and_metric_total_agree(text):
    text = _rendered_text() if text == "render" else text
    ref, port = JF.parse_prometheus(text), TF.parse_prometheus(text)
    assert repr(sorted(port.items())) == repr(sorted(ref.items()))
    names = {name for name, _ in ref}
    for name in names | {"absent"}:
        assert repr(TF.metric_total(port, name)) == \
            repr(JF.metric_total(ref, name))
    for name in ("veles_lat", "veles_serving_latency_seconds"):
        assert TF.histogram_quantile(port, name, 0.5) == \
            JF.histogram_quantile(ref, name, 0.5)
    if text == TEXT:
        assert TF.metric_total(port, "veles_x_total", kind="train") == \
            JF.metric_total(ref, "veles_x_total", kind="train") == 1003.0


@contextlib.contextmanager
def dashboards():
    """A reference and a port web status, each on its own registry and
    ticked health monitor (memory gauges sampled), a run registered, and
    each package's reactor loop lag already in its registry (the lag
    probe sets it every 0.25 s, so a scrape would otherwise find it or
    not by the clock)."""
    jm = JH.HealthMonitor(interval=3600.0)
    tm = TH.HealthMonitor(interval=3600.0)
    with JT.scoped() as jreg, TT.scoped() as treg, JH.scoped(jm), \
            TH.scoped(tm):
        ref, port = JaxWebStatus(port=0), TorchWebStatus(port=0)
        try:
            for ws in (ref, port):
                ws.register("run", lambda: {"workflow": "w", "epoch": 1})
            jm.tick()
            tm.tick()
            deadline = time.monotonic() + 10
            while not all("veles_reactor_loop_lag_seconds"
                          in reg.render_prometheus() for reg in (jreg, treg)):
                assert time.monotonic() < deadline, "no reactor lag probe"
                time.sleep(0.05)
            yield ["http://127.0.0.1:%d" % ws.port for ws in (ref, port)]
        finally:
            ref.close()
            port.close()


def _snapshot(top_main, url, capsys):
    assert top_main([url, "--once", "--json", "--timeout", "10"]) == 0
    return json.loads(capsys.readouterr().out)


def _keys(row):
    return sorted(row), sorted(row.get("metrics", {}))


def test_top_json_rows_have_the_same_keys_across_packages(capsys):
    with dashboards() as (ref_url, port_url):
        rows = {(scraper, target): _snapshot(top, url, capsys)
                for scraper, top in (("ref", JF.top_main),
                                     ("port", TF.top_main))
                for target, url in (("ref", ref_url), ("port", port_url))}
    for (scraper, target), snap in rows.items():
        assert snap["fleet"]["reachable"] == snap["fleet"]["ready"] == 1
        row, = snap["targets"]
        assert row["ready"] and row["role"] == "process"
        assert row["metrics"]["host_rss_bytes"] > 1 << 20
        assert "critical_path" in row
    want = _keys(rows["ref", "ref"]["targets"][0])
    for snap in rows.values():
        assert _keys(snap["targets"][0]) == want
    port_row = rows["port", "port"]["targets"][0]
    assert "device_memory_bytes" not in port_row["metrics"]   # no CUDA
    # the dashboard frame renders RSS beside the reactor lag
    with dashboards() as (_, port_url):
        assert TF.top_main([port_url, "--once"]) == 0
    assert re.search(r"rss [\d.]+MB", capsys.readouterr().out)


def test_top_renders_device_memory_beside_rss():
    snap = {"ts": 0.0, "fleet": {"targets": 1, "reachable": 1, "ready": 1,
                                 "slaves": 0, "firing_slos": [],
                                 "degraded": []},
            "targets": [{"url": "http://a:1", "reachable": True,
                         "ready": True, "role": "process",
                         "metrics": {"host_rss_bytes": 191889408,
                                     "device_memory_bytes": 1048576 * 3,
                                     "reactor_lag_s": 0.0004}}]}
    assert "rss 183.0MB, device 3.0MB, reactor lag 0.4ms" in \
        TF.render_snapshot(snap)


@pytest.mark.parametrize("top", [JF.top_main, TF.top_main],
                         ids=["ref", "port"])
def test_top_exits_2_when_no_target_is_reachable(top, capsys):
    assert top(["http://127.0.0.1:1", "--json", "--timeout", "1"]) == 2
    assert json.loads(capsys.readouterr().out)["fleet"]["reachable"] == 0


@contextlib.contextmanager
def _serving(body):
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = socketserver.TCPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d" % httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def test_profile_exit_codes(tmp_path, capsys):
    """0 with a per-thread summary (and the speedscope file) against a
    port and a reference dashboard, as the reference's CLI against the
    port's; 2 against a wrong shape, out-of-range frame indices and an
    unreachable port."""
    out = tmp_path / "p.json"
    with dashboards() as (ref_url, port_url):
        assert profile_main([port_url, "--seconds", "0.3", "--hz", "200",
                             "--out", str(out)]) == 0
        printed = capsys.readouterr().out
        assert "thread(s)" in printed and "reactor" in printed
        assert json.loads(out.read_text())["profiles"]
        assert profile_main([ref_url, "--seconds", "0.2"]) == 0
        assert jax_profile_main([port_url, "--seconds", "0.2"]) == 0
        assert profile_main([port_url + "/status.json"]) == 2
    evil = json.dumps({
        "shared": {"frames": [{"name": "f", "file": "", "line": 1}]},
        "profiles": [{"type": "sampled", "name": "t", "unit": "seconds",
                      "startValue": 0, "endValue": 1.0,
                      "samples": [[0, 99]], "weights": [1.0]}]}).encode()
    with _serving(evil) as url:
        assert profile_main([url, "--seconds", "0.1"]) == 2
    assert profile_main(["http://127.0.0.1:1", "--seconds", "0.1"]) == 2
    assert "error:" in capsys.readouterr().err


def _graph(path):
    text = open(path).read()
    labels = dict(re.findall(r'(u\d+) \[label="([^"]+)"', text))
    edges = sorted((labels[a], labels[b])
                   for a, b in re.findall(r"(u\d+) -> (u\d+);", text))
    return sorted(labels.values()), edges


def test_workflow_graph_has_the_references_nodes_and_edges(tmp_path,
                                                            capsys):
    """The MNIST sample's graph. Every node of the reference's unit graph
    is in the port's: the control points (start, repeater, end) are the
    port's run loop, the units between them its fused step."""
    from veles.config import root as jroot
    saved = jroot.mnist.to_dict()
    try:
        jax_main([JAX_MNIST, "--workflow-graph", str(tmp_path / "j.dot")])
    finally:
        jroot.mnist.update(saved)
    wf = torch_main([TORCH_MNIST, "-d", "cpu", "--workflow-graph",
                     str(tmp_path / "t.dot")])
    assert wf.step is None                   # written, not run
    assert "workflow graph ->" in capsys.readouterr().out
    ref, port = _graph(tmp_path / "j.dot"), _graph(tmp_path / "t.dot")
    lacking = sorted(set(ref[0]) - set(port[0]))
    assert lacking == []
    assert port == ref


def _run_cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "veles_torch", TORCH_MNIST, "-d", "cpu",
         *SMALL, *args], cwd=REPO, capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, PYTHONPATH=REPO))


def test_dump_unit_sizes_and_the_stats_table_in_a_subprocess():
    run = _run_cli("--dump-unit-sizes")
    assert run.returncode == 0, run.stderr[-3000:]
    sizes = re.search(r"unit +bytes\n(.*?)\nTOTAL +(\d+)", run.stderr, re.S)
    rows = {line.split()[0]: int(line.split()[1])
            for line in sizes.group(1).splitlines()}
    # 784x100 + 100 f32 weights and as much momentum; the dataset
    assert rows["All2AllTanh"] == rows["GDTanh"] - 4 == 4 * (78400 + 100)
    assert rows["loader"] >= 250 * 784 * 4
    assert int(sizes.group(2)) == sum(rows.values())
    assert re.search(r"step\.train +[\d.]+ +1 ", run.stderr)
    assert json.loads(run.stdout.splitlines()[-1])["device"] == "cpu"


def test_background_no_stats_and_log_file_in_a_subprocess(tmp_path):
    log = tmp_path / "daemon.log"
    run = _run_cli("--no-stats", "--background", "--log-file", str(log),
                   timeout=60)
    assert run.returncode == 0, run.stderr[-3000:]
    pid = json.loads(run.stdout.splitlines()[-1])["daemon_pid"]
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.2)
    else:
        os.kill(pid, 9)
        pytest.fail("the daemon did not finish")
    text = log.read_text()
    assert json.loads(text.strip().splitlines()[-1])["device"] == "cpu"
    assert "time(s)" not in text             # --no-stats
    assert "epoch 0 |" in text
