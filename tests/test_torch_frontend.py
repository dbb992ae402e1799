"""The port's HTTP serving plane (veles_torch/serving/frontend.py and
registry.py) against the JAX package's (veles/serving), on the CPU.

The same archives, exported by the reference (the MNIST MLP and a small
LM, seeded weights), are served by both frontends in one process, each
package on its own telemetry registry, health monitor and model monitor.
For the same requests they answer: ``/v1/models`` equal but for the
``backend`` field; predict outputs within ``PREDICT_ATOL`` (1e-5, the
reference's numpy executor against the port's torch CPU forward); greedy
``/v1/generate`` tokens equal, streamed over a raw socket and not
streamed; the same status codes for a shed, an expired, an over-quota
request and a bad prompt; the same ``/metrics`` family names and
``/metrics.json`` key shape (the port's decode view adds its
``shed_total`` and ``expired_total``); the same ``/readyz`` reasons with
no model, an open store breaker, shedding, a firing SLO and a diverged
model. A disconnect mid-stream frees the port's KV slot and counts
``veles_serving_rejected_total{reason="disconnect"}``; ``reload`` and
``refresh_newest`` over an HTTP store (a ``ThreadingHTTPServer``) bump
the version and skip a diverged checkpoint; each package's
``HTTPSnapshotStore`` reads what the other's wrote. The reference's
router (``veles/router.py``) fronts two port replicas, and its load
generator (``veles/loadgen.py``) drives one. ``python -m veles_torch
serve -d cpu`` answers predict from a subprocess, and a CPU MNIST run
under ``--web-status 0 --trace-out --slo-config`` serves ``/readyz`` and
writes the dispatch spans. Every server binds port 0 and is closed in a
``finally``.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy
import pytest

import veles.prng as jprng
from veles import health as jhealth
from veles import model_health as jmh
from veles import snapshotter as jsnap
from veles import telemetry as jtel
from veles.config import root as jroot
from veles.serving import frontend as jfront
from veles.serving import tenants as jtenants
from veles.serving.registry import ModelRegistry as JaxRegistry
from veles.znicz_tpu.models import mnist as jmnist
from veles.znicz_tpu.models import transformer_lm as jlm
from veles_torch import health as thealth
from veles_torch import model_health as tmh
from veles_torch import snapshotter as tsnap
from veles_torch import telemetry as ttel
from veles_torch.serving import frontend as tfront
from veles_torch.serving import tenants as ttenants
from veles_torch.serving.registry import ModelRegistry as TorchRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_MNIST = os.path.join(REPO, "veles_torch", "znicz", "models",
                           "mnist.py")

#: the port's torch CPU forward against the reference's numpy executor
#: on the same archive (observed 3e-8 on the MNIST MLP's softmax)
PREDICT_ATOL = 1e-5

MNIST = {"loader": {"minibatch_size": 25, "n_train": 100, "n_valid": 25}}
LM = {"loader": {"minibatch_size": 16, "n_train": 64, "n_valid": 16,
                 "seq_len": 32, "vocab": 16, "max_period": 6},
      "model": {"dim": 32, "heads": 2, "layers": 2, "ffn_hidden": 64,
                "attn_block": None, "attn_impl": None, "moe_experts": 0,
                "stacked": False},
      "parallel": {"seq": 1, "model": 1, "data": 1, "expert": 1,
                   "pipe": 1}}


def _export(mod, key, overrides, path, seed):
    saved = getattr(jroot, key).to_dict()
    try:
        for sub, values in overrides.items():
            getattr(getattr(jroot, key), sub).update(values)
        jprng.seed_all(seed)
        wf = mod.create_workflow(name="Front_" + key)
        wf.initialize(device="numpy")
        wf.export_inference(str(path))
        return wf
    finally:
        getattr(jroot, key).update(saved)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    base = tmp_path_factory.mktemp("front")
    wf = _export(jmnist, "mnist", MNIST, base / "mnist", 5)
    rows = numpy.asarray(wf.loader.original_data.mem[:12], numpy.float32)
    _export(jlm, "lm", LM, base / "lm", 6)
    return {"mnist": str(base / "mnist"), "lm": str(base / "lm"),
            "rows": rows, "base": base}


@contextlib.contextmanager
def planes():
    """Fresh telemetry registries, health monitors (not started: the
    tests tick them) and model monitors for both packages."""
    jm = jhealth.HealthMonitor(interval=3600.0)
    tm = thealth.HealthMonitor(interval=3600.0)
    with jtel.scoped(), ttel.scoped(), jhealth.scoped(jm), \
            thealth.scoped(tm), jmh.scoped(), tmh.scoped():
        try:
            yield jm, tm
        finally:
            jm.close()
            tm.close()
            jtenants.set_table(None)
            ttenants.set_table(None)


@contextlib.contextmanager
def served(archives, models=("mnist", "lm"), **kwargs):
    """Both packages' registries with ``models`` loaded, each behind its
    frontend; -> ((ref registry, ref front), (port registry, port
    front))."""
    pairs = []
    try:
        for registry_cls, front_cls, extra in (
                (JaxRegistry, jfront.ServingFrontend, {"backend": "numpy"}),
                (TorchRegistry, tfront.ServingFrontend, {"device": "cpu"})):
            reg = registry_cls(**dict(kwargs, **extra))
            pairs.append([reg, None])
            for name in models:
                reg.load(name, archives[name])
            pairs[-1][1] = front_cls(reg, port=0)
        yield pairs
    finally:
        for reg, front in pairs:
            if front is not None:
                front.close()
            reg.close()


def url(front, path):
    return "http://127.0.0.1:%d%s" % (front.port, path)


def post(front, path, doc, headers=None, timeout=30):
    req = urllib.request.Request(url(front, path),
                                 data=json.dumps(doc).encode(),
                                 headers=dict(headers or {}),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}"), dict(exc.headers)


def get(front, path, timeout=30):
    try:
        with urllib.request.urlopen(url(front, path),
                                    timeout=timeout) as resp:
            body = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            return resp.status, (json.loads(body) if "json" in ctype
                                 else body.decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def stream_generate(front, doc, stop_after=None):
    """POST /v1/generate over a raw socket; -> the ndjson lines read (all
    of them, or the first ``stop_after`` before the socket is closed)."""
    body = json.dumps(doc).encode()
    sock = socket.create_connection(("127.0.0.1", front.port), timeout=30)
    try:
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += sock.recv(65536)
        head, buf = buf.split(b"\r\n\r\n", 1)
        assert b" 200 " in head.split(b"\r\n")[0], head
        assert b"transfer-encoding: chunked" in head.lower()
        lines = []
        while True:
            while b"\r\n" not in buf:
                more = sock.recv(65536)
                if not more:
                    return lines
                buf += more
            size_s, buf = buf.split(b"\r\n", 1)
            size = int(size_s, 16)
            if size == 0:
                return lines
            while len(buf) < size + 2:
                buf += sock.recv(65536)
            chunk, buf = buf[:size], buf[size + 2:]
            for line in chunk.decode().splitlines():
                lines.append(json.loads(line))
                if stop_after is not None and len(lines) >= stop_after:
                    return lines
    finally:
        sock.close()


def wait_until(fn, timeout=20.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.01)
    raise AssertionError("timed out waiting for %s" % what)


# -- the HTTP API ---------------------------------------------------------


def test_models_predict_and_generate_agree(archives):
    with planes(), served(archives) as ((_, jf), (_, tf)):
        codes = [get(f, "/v1/models") for f in (jf, tf)]
        assert [c for c, _ in codes] == [200, 200]
        ref, port = (d["models"] for _, d in codes)
        for r, p in zip(ref, port):
            assert p.pop("backend") == "torch:cpu"
            r.pop("backend")
            for doc in (r, p):
                doc.pop("loaded_at")
            r["input_sample_shape"] = list(r["input_sample_shape"] or ()) \
                or None
            p["input_sample_shape"] = list(p["input_sample_shape"] or ()) \
                or None
            assert r == p
        rows = archives["rows"]
        tp = "00-%s-%s-01" % ("ab" * 16, "cd" * 8)
        outs = []
        for f in (jf, tf):
            code, doc, headers = post(
                f, "/v1/predict", {"model": "mnist",
                                   "inputs": rows.tolist()},
                headers={"traceparent": tp})
            assert code == 200 and doc["version"] == 1
            echoed = jtel.TraceContext.from_traceparent(
                headers["traceparent"])
            assert echoed.trace_id == "ab" * 16
            outs.append(numpy.asarray(doc["outputs"], numpy.float32))
        assert numpy.abs(outs[0] - outs[1]).max() <= PREDICT_ATOL
        prompt = {"model": "lm", "prompt": [3, 1, 4, 1, 5],
                  "max_tokens": 12}
        greedy = []
        for f in (jf, tf):
            code, doc, _ = post(f, "/v1/generate",
                                dict(prompt, stream=False))
            assert code == 200 and doc["n"] == 12
            lines = stream_generate(f, prompt)
            assert lines[0] == {"model": "lm", "version": 1}
            toks = [ln["token"] for ln in lines[1:-1]]
            assert lines[-1]["done"] and lines[-1]["tokens"] == toks
            assert toks == doc["tokens"]
            greedy.append(toks)
        assert greedy[0] == greedy[1]
        # the port's spans carry the client's trace
        spans = ttel.tracer.flight_doc()["traceEvents"]
        assert any(e.get("name") == "http.predict"
                   and e["args"].get("trace_id") == "ab" * 16
                   for e in spans)


def _blocked(front):
    """Park the front's MNIST batcher worker inside a batch until the
    returned event is set."""
    release = threading.Event()
    entry = front.registry.get("mnist")
    run = entry.batcher._run_batch

    def slow(rows):
        release.wait(10)
        return run(rows)

    entry.batcher._run_batch = slow
    return release


def test_status_codes_agree(archives, tmp_path):
    rows = archives["rows"][:1].tolist()
    got = {}
    with planes(), served(archives, max_queue=2,
                          max_wait_ms=1.0) as ((_, jf), (_, tf)):
        for tag, f in (("ref", jf), ("port", tf)):
            codes = []
            release = _blocked(f)
            try:
                first = threading.Thread(target=post, args=(
                    f, "/v1/predict", {"model": "mnist", "inputs": rows,
                                       "timeout_ms": 5000}))
                first.start()
                wait_until(lambda: f.registry.get("mnist").batcher
                           .metrics()["queue_depth"] == 0
                           and f.registry.get("mnist").batcher.metrics()
                           ["requests_total"] == 1, what="first batch")
                late = []
                for timeout in (30, 5000):
                    t = threading.Thread(target=lambda to=timeout: late.append(
                        post(f, "/v1/predict", {"model": "mnist",
                                                "inputs": rows,
                                                "timeout_ms": to})[0]))
                    t.start()
                    late.append(t)
                wait_until(lambda: f.registry.get("mnist").batcher
                           .metrics()["queue_depth"] == 2, what="queued")
                codes.append(post(f, "/v1/predict",
                                  {"model": "mnist", "inputs": rows})[0])
                time.sleep(0.05)         # the 30 ms deadline passes
            finally:
                release.set()
            first.join(10)
            for t in [x for x in late if isinstance(x, threading.Thread)]:
                t.join(10)
            codes.append(sorted(x for x in late if isinstance(x, int)))
            codes.append(post(f, "/v1/generate",
                              {"model": "lm", "prompt": "nope"})[0])
            codes.append(post(f, "/v1/generate",
                              {"model": "lm", "prompt": [1] * 300,
                               "stream": False})[0])
            codes.append(post(f, "/v1/generate",
                              {"model": "mnist", "prompt": [1],
                               "stream": False})[0])
            codes.append(post(f, "/v1/predict",
                              {"model": "nope", "inputs": rows})[0])
            codes.append(post(f, "/v1/predict", {"model": "mnist",
                                                 "inputs": [[1, 2]]})[0])
            codes.append(get(f, "/debug/nope")[0])
            got[tag] = codes
    assert got["ref"] == got["port"] == [
        503, [200, 504], 400, 400, 400, 404, 400, 404]
    # over quota: the same 429s for the same tenant file and sequence
    tenants = tmp_path / "tenants.json"
    tenants.write_text(json.dumps({
        "default": "anon", "tenants": {
            "acme": {"rps": 0.001, "burst": 2, "priority": "gold"},
            "anon": {"priority": "bronze"}}}))
    decisions = {}
    with planes(), served(archives, models=("mnist",)) as \
            ((_, jf), (_, tf)):
        for tag, f, mod in (("ref", jf, jtenants), ("port", tf, ttenants)):
            mod.set_table(mod.TenantTable.from_file(str(tenants)))
            seq = []
            for who in ("acme", "acme", "acme", None, "acme"):
                headers = {"x-veles-tenant": who} if who else {}
                code, doc, hdr = post(f, "/v1/predict",
                                      {"model": "mnist", "inputs": rows},
                                      headers=headers)
                seq.append((code, "Retry-After" in hdr))
            decisions[tag] = seq
            assert get(f, "/debug/tenants")[0] == 200
    assert decisions["ref"] == decisions["port"] == [
        (200, False), (200, False), (429, True), (200, False), (429, True)]


def _families(text):
    return sorted({line.split()[2] for line in text.splitlines()
                   if line.startswith("# TYPE")})


def _shape(doc):
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    return type(doc).__name__ if not isinstance(doc, (int, float)) \
        else "number"


def test_metrics_families_and_json_shape_agree(archives):
    rows = archives["rows"][:2].tolist()
    with planes(), served(archives) as ((_, jf), (_, tf)):
        for f in (jf, tf):
            assert post(f, "/v1/predict",
                        {"model": "mnist", "inputs": rows})[0] == 200
            assert post(f, "/v1/generate", {"model": "lm", "prompt": [1, 2],
                                            "max_tokens": 3,
                                            "stream": False})[0] == 200
        (jc, jtext), (tc, ttext) = get(jf, "/metrics"), get(tf, "/metrics")
        assert jc == tc == 200
        serving = [n for n in _families(jtext)
                   if n.startswith("veles_serving_")]
        assert serving and [n for n in _families(ttext)
                            if n.startswith("veles_serving_")] == serving
        jdoc, tdoc = get(jf, "/metrics.json")[1], get(tf, "/metrics.json")[1]
        jshape, tshape = _shape(jdoc), _shape(tdoc)
        extra = tshape["models"]["lm"]["decode"]
        for key in ("shed_total", "expired_total"):
            assert extra.pop(key) == "number"
        assert jshape == tshape


# -- readiness --------------------------------------------------------------


def _reasons(monitor):
    monitor.tick()
    ready, reasons = monitor.ready_state()
    return ready, sorted(r.split(": ", 1)[1] if ": " in r else r
                         for r in reasons)


def test_readyz_reasons_agree(archives):
    with planes() as (jm, tm):
        verdicts = {}
        regs = [(JaxRegistry(backend="numpy"), jfront, jmh, jm, "ref"),
                (TorchRegistry(device="cpu"), tfront, tmh, tm, "port")]
        fronts = []
        try:
            for reg, mod, mh, mon, tag in regs:
                front = mod.ServingFrontend(reg, port=0)
                fronts.append(front)
                out = [_reasons(mon)]              # no model
                reg.load("mnist", archives["mnist"], warmup=True)
                out.append(_reasons(mon))          # ready
                code, doc = get(front, "/readyz")
                out.append((code, doc["ready"]))
                # an open store breaker on the served checkpoint's store
                entry = reg.get("mnist")
                entry.checkpoint = "http://127.0.0.1:9/b%s/x.ckpt.npz" % tag
                store = reg.checkpoint_store(entry.checkpoint) \
                    if tag == "port" else \
                    reg._checkpoint_store(entry.checkpoint)
                store._breaker_open_until = time.monotonic() + 60
                out.append(_reasons(mon))
                store._breaker_open_until = 0.0
                entry.checkpoint = None
                # shedding: 20 sheds since the last tick
                reg_t = (ttel if tag == "port" else jtel).get_registry()
                reg_t.counter("veles_serving_shed_total", "",
                              ("model",)).labels("mnist").inc(20)
                out.append(_reasons(mon))
                out.append(_reasons(mon))          # recovered
                # a firing SLO
                mon.add_slo({"name": "always_bad", "series":
                             "veles_serving_model_version", "op": "<",
                             "threshold": -1.0, "fast_window": 60,
                             "slow_window": 60})
                out.append(_reasons(mon))
                mon.remove_slo("always_bad") if hasattr(
                    mon, "remove_slo") else None
                verdicts[tag] = out
                # a diverged model
                monitor = mh.get_model_monitor()
                monitor.register_health(mon)
                monitor.observe_loss(float("nan"), epoch=0)
                verdicts[tag].append(_reasons(mon))
                mon.remove_check("model:divergence")
        finally:
            for front in fronts:
                front.close()
            for reg, *_ in regs:
                reg.close()
    assert verdicts["ref"] == verdicts["port"]
    ref = verdicts["ref"]
    assert ref[0] == (False, ["no models loaded"]) and ref[1] == (True, [])
    assert ref[2] == (200, True)
    assert "breaker open" in ref[3][1][0]
    assert ref[4][1][0].startswith("shedding 20/20")
    assert "always_bad" in " ".join(ref[6][1])
    assert "model diverged" in " ".join(ref[7][1])


def test_stream_disconnect_frees_the_slot(archives):
    with planes(), served(archives, models=("lm",),
                          decode_slots=2) as (_, (reg, tf)):
        lines = stream_generate(tf, {"model": "lm", "prompt": [1, 2, 3],
                                     "max_tokens": 200}, stop_after=3)
        assert lines[0]["model"] == "lm" and "token" in lines[2]
        decoder = reg.decoder("lm")
        wait_until(lambda: decoder.metrics()["kv_slots_in_use"] == 0,
                   what="the slot back")
        reject = ttel.get_registry().counter_total(
            "veles_serving_rejected_total", reason="disconnect")
        wait_until(lambda: ttel.get_registry().counter_total(
            "veles_serving_rejected_total", reason="disconnect") == 1,
            what="the disconnect count")
        assert reject in (0, 1)


# -- refresh over an HTTP store ----------------------------------------------


@contextlib.contextmanager
def http_store(directory):
    """A ThreadingHTTPServer speaking the store protocol over
    ``directory``: GET/PUT/DELETE <base>/<name>, GET <base>/ lists."""
    os.makedirs(directory, exist_ok=True)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _name(self):
            return self.path.rstrip("/").rsplit("/", 1)[-1] \
                if self.path.rstrip("/") != "/store" else ""

        def do_GET(self):
            name = self._name()
            if not name:
                body = json.dumps(sorted(os.listdir(directory))).encode()
            else:
                try:
                    with open(os.path.join(directory, name), "rb") as f:
                        body = f.read()
                except OSError:
                    self.send_response(404)
                    self.end_headers()
                    return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_PUT(self):
            data = self.rfile.read(int(self.headers["Content-Length"]))
            with open(os.path.join(directory, self._name()), "wb") as f:
                f.write(data)
            self.send_response(201)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_DELETE(self):
            try:
                os.remove(os.path.join(directory, self._name()))
            except OSError:
                pass
            self.send_response(204)
            self.end_headers()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:%d/store" % httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()


def _mnist_params(archive, scale):
    """A checkpoint tree for the MNIST archive: its params times
    ``scale``."""
    doc = json.load(open(os.path.join(archive, "contents.json")))
    tree = {}
    for spec in doc["units"]:
        for key in ("weights", "bias"):
            if key in spec:
                arr = numpy.load(os.path.join(archive, spec[key]))
                tree.setdefault(spec["name"], {})[key] = \
                    (arr * scale).astype(numpy.float32)
    return {"params": tree}


def test_refresh_over_an_http_store(archives, tmp_path):
    rows = archives["rows"][:3]
    with planes(), http_store(str(tmp_path / "blobs")) as base:
        jstore = jsnap.store_for_base(base)
        tstore = tsnap.store_for_base(base)
        # each package's store reads what the other's wrote
        tsnap.write_checkpoint(tstore, "m_=1.ckpt.npz.gz",
                               _mnist_params(archives["mnist"], 0.5),
                               extra_meta={"model_health":
                                           {"verdict": "healthy"}})
        assert jsnap.load_snapshot(base + "/m_=1.ckpt.npz.gz")["params"]
        time.sleep(0.01)
        jsnap.write_checkpoint(jstore, "m_=2.ckpt.npz.gz",
                               _mnist_params(archives["mnist"], 0.25),
                               extra_meta={"model_health":
                                           {"verdict": "healthy"}})
        assert sorted(tstore.list()) == sorted(jstore.list())
        got = {}
        for tag, reg in (("ref", JaxRegistry(backend="numpy")),
                         ("port", TorchRegistry(device="cpu"))):
            try:
                entry = reg.load("mnist", archives["mnist"],
                                 checkpoint=base + "/m_=1.ckpt.npz.gz")
                v1 = numpy.asarray(entry.predict(rows))
                assert entry.version == 1
                assert reg.refresh_newest("mnist").endswith("m_=2.ckpt.npz.gz")
                assert reg.get("mnist").version == 2
                v2 = numpy.asarray(reg.get("mnist").predict(rows))
                reg.reload("mnist")
                assert reg.get("mnist").version == 3
                got[tag] = (v1, v2)
            finally:
                reg.close()
        for a, b in zip(got["ref"], got["port"]):
            assert numpy.abs(a - b).max() <= PREDICT_ATOL
        assert numpy.abs(got["port"][0] - got["port"][1]).max() > 1e-4
        # a newer diverged checkpoint is skipped and counted
        time.sleep(0.01)
        tsnap.write_checkpoint(tstore, "m_=3.ckpt.npz.gz",
                               _mnist_params(archives["mnist"], 9.0),
                               extra_meta={"model_health":
                                           {"verdict": "diverged"}})
        reg = TorchRegistry(device="cpu")
        try:
            reg.load("mnist", archives["mnist"],
                     checkpoint=base + "/m_=1.ckpt.npz.gz")
            skips = tsnap.COUNTERS.diverged_skips
            assert reg.refresh_newest("mnist").endswith("m_=2.ckpt.npz.gz")
            assert tsnap.COUNTERS.diverged_skips == skips + 1
            assert reg.get("mnist").version == 2
            assert ttel.get_registry().counter_total(
                "veles_checkpoint_diverged_skips_total") == 1
            events = [e["event"] for e in ttel.tracer.recent_events()]
            assert "refresh_skipped_diverged" in events
        finally:
            reg.close()


# -- the reference's router and load generator in front of port replicas -----


@contextlib.contextmanager
def serve_proc(*args):
    """``python -m veles_torch serve -d cpu --port 0 ARGS`` in a
    subprocess; -> (its first JSON line, a stub with ``.port``). On exit
    it gets SIGTERM and must exit 0 (it is killed when the body
    failed)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_torch", "serve", "-d", "cpu",
         "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    try:
        first = None
        for line in proc.stdout:
            if line.startswith("{"):
                first = json.loads(line)
                break
        assert first is not None, "no JSON line (rc %s)" % proc.poll()
        # keep draining the pipe so a chatty server never blocks on it
        threading.Thread(target=proc.stdout.read, daemon=True).start()

        class Front:
            port = int(first["serving"].rsplit(":", 1)[1])
        yield first, Front
        # SIGTERM is a clean stop: frontend and registry closed, exit 0
        proc.terminate()
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_reference_router_fronts_port_replicas(archives, tmp_path,
                                               capsys):
    """Two port replicas in their own processes (each has its own health
    plane) behind the reference's router; replica A's SLO fires once it
    has served the test's own request, so its /readyz flips and the
    router ejects it. That request is a predict of a model only A serves
    and the router never asks for (``probe``, the MNIST archive again):
    the flip objective counts its requests alone, so the router's
    traffic, which may land on A, cannot flip A before the test's
    request, and the monitor's next tick after it does."""
    from veles.loadgen import loadgen_main
    from veles.router import FleetController, RouterFrontend
    flip = tmp_path / "flip.json"
    flip.write_text(json.dumps([{
        "name": "flip",
        "series": 'veles_serving_requests_total{model="probe"}',
        "op": "<=", "threshold": 0.0, "target": 0.5,
        "fast_window": 30, "slow_window": 30}]))
    models = ["--model", "mnist=" + archives["mnist"],
              "--model", "lm=" + archives["lm"], "--max-batch", "8"]

    def admitted(front, n):
        doc = get(front, "/router/status")[1]
        return doc["ticks"] >= 1 and doc["admitted"] == n

    rows = archives["rows"][:2].tolist()
    with planes(), serve_proc(*models, "--model", "probe=" + archives[
            "mnist"], "--slo-config", str(flip)) as (_, a), \
            serve_proc(*models) as (_, b):
        controller = FleetController([url(a, ""), url(b, "")],
                                     interval=0.1, scrape_timeout=2.0)
        router = RouterFrontend(controller, port=0)
        try:
            wait_until(lambda: admitted(router, 2),
                       what="both replicas admitted")
            code, doc, _ = post(router, "/v1/predict",
                                {"model": "mnist", "inputs": rows})
            assert code == 200 and len(doc["outputs"]) == 2
            code, doc, _ = post(router, "/v1/generate",
                                {"model": "lm", "prompt": [1, 2],
                                 "max_tokens": 4, "stream": False})
            assert code == 200 and doc["n"] == 4
            assert post(a, "/v1/predict", {"model": "probe",
                                           "inputs": rows})[0] == 200
            wait_until(lambda: get(a, "/readyz")[0] == 503,
                       what="replica A's /readyz to flip")
            assert get(b, "/readyz")[0] == 200
            wait_until(lambda: admitted(router, 1),
                       what="the unready replica ejected")
            status = get(router, "/router/status")[1]
            states = {x["url"]: x["state"] for x in status["backends"]}
            assert states[url(a, "")] == "ejected"
            assert post(router, "/v1/predict",
                        {"model": "mnist", "inputs": rows})[0] == 200
        finally:
            router.close()
            controller.close()
        capsys.readouterr()
        assert loadgen_main([url(b, ""), "--model", "mnist", "--rps",
                             "20", "--duration", "1", "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["extra"]["stages"][0]["tenants"]["anon"][
            "goodput_rps"] > 0


def test_serve_subprocess_answers_predict(archives):
    with serve_proc("--model", "mnist=" + archives["mnist"],
                    "--max-batch", "8") as (first, front):
        assert first["models"] == [{"name": "mnist", "version": 1,
                                    "backend": "torch:cpu",
                                    "compiled_buckets": [1, 2, 4, 8]}]
        code, doc, _ = post(front, "/v1/predict", {
            "model": "mnist", "inputs": archives["rows"][:2].tolist()})
        assert code == 200 and len(doc["outputs"]) == 2


def test_training_cli_serves_readyz_and_writes_dispatch_spans(
        tmp_path, monkeypatch):
    """``--web-status 0 --trace-out --slo-config`` on a CPU MNIST run:
    the dashboard answers while the run trains, the SLO file is loaded,
    and the trace holds a dispatch span per class."""
    from veles_torch import launcher as tlauncher
    from veles_torch.__main__ import main as torch_main
    slos = tmp_path / "slos.json"
    slos.write_text(json.dumps([{"name": "queue_ok", "series":
                                 "veles_serving_queue_rows", "op": "<=",
                                 "threshold": 1e9}]))
    trace = tmp_path / "t.json"
    seen = {}
    run = tlauncher.Launcher.run

    def probing_run(self):
        class Front:
            port = self.web_status.port
        seen["status"] = get(Front, "/status.json")[1]
        thealth.get_monitor().tick()
        seen["readyz"] = get(Front, "/readyz")
        return run(self)

    monkeypatch.setattr(tlauncher.Launcher, "run", probing_run)
    with planes():
        torch_main([TORCH_MNIST, "-d", "cpu", "--web-status", "0",
                    "--trace-out", str(trace), "--slo-config", str(slos),
                    "root.mnist.loader.n_train=200",
                    "root.mnist.loader.n_valid=50",
                    "root.mnist.decision.max_epochs=1"])
        assert "queue_ok" in [s.name for s in thealth.get_monitor().slos()]
    assert seen["readyz"][0] == 200 and seen["readyz"][1]["ready"]
    assert seen["status"]["MnistWorkflow"]["mode"] == "standalone"
    doc = json.load(open(trace))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"torch.dispatch.train", "torch.dispatch.valid"} <= names
