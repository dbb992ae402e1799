"""Run-status web dashboard of the PyTorch port.

The port's own copy of ``veles/web_status.py`` (it imports nothing of the
JAX package), on the process's shared selector reactor
(``reactor.py``):

* ``GET /``              — an HTML table of every registered run (a
  master's ``cluster`` row with its slaves, faults and each slave's
  last-job timing);
* ``GET /status.json``   — the same as JSON;
* ``POST /update``       — a remote launcher pushes its status;
* ``GET /healthz``, ``/readyz``, ``/metrics/history`` — the health
  plane's cached probes (``health.py``);
* ``GET /metrics``       — Prometheus text of the telemetry registry;
* ``GET /debug/trace``, ``/debug/events`` — the flight recorder;
  ``GET /debug/model`` — the model-health snapshot;
  ``GET /debug/critical_path`` — the flight-recorder window as a per-leg
  step-time breakdown; ``GET /debug/profile?seconds=N&hz=H`` — a live
  sampling-profiler capture (speedscope JSON, or ``format=collapsed``),
  captured on a worker thread (``request.defer``). Both from
  ``profiling.py``.

``python -m veles_torch <workflow> --web-status PORT`` registers the run
with :func:`workflow_status`; ``python -m veles_torch serve --web-status
PORT`` registers the serving frontend's metrics.
"""

import html
import json
import threading

from veles_torch import health, model_health, reactor, telemetry
from veles_torch.logger import Logger

#: admission bound for ``POST /update``: distinct status names one
#: dashboard will hold (each novel name is a dict kept forever, and
#: the name is the POSTER's choice) — beyond this, novel names get 413
_MAX_PUSHED = 256

_PAGE = """<!DOCTYPE html>
<html><head><title>veles status</title>
<meta http-equiv="refresh" content="5">
<style>
 body { font-family: monospace; margin: 2em; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #999; padding: 4px 10px; text-align: left; }
 th { background: #eee; }
</style></head>
<body><h2>veles_torch — run status</h2>%s
<p>raw: <a href="/status.json">status.json</a></p></body></html>
"""


def _row(cells, tag="td"):
    # escape everything: /update accepts JSON from remote launchers,
    # so names/values are untrusted page content
    return "<tr>" + "".join("<%s>%s</%s>" % (tag, html.escape(str(c)),
                                             tag)
                            for c in cells) + "</tr>"


def _slave_cells(slaves):
    """A master's per-slave rows as one cell: name, jobs, and the last
    job's round trip, compute and wire seconds."""
    return "; ".join(
        "%s %s: %s jobs, rtt %s s, job %s s, wire %s s" % (
            sid, row.get("name"), row.get("jobs"), row.get("last_rtt_s"),
            row.get("last_job_s"), row.get("last_wire_s"))
        for sid, row in sorted(slaves.items()))


class WebStatus(Logger):
    """Serves run status on ``http://127.0.0.1:port``; port=0 picks a
    free one (see ``.port``)."""

    def __init__(self, port=0, host="127.0.0.1"):
        self.name = "web_status"
        self._providers = {}      # name -> callable() -> dict
        self._pushed = {}         # name -> dict (remote POSTs)
        self._lock = threading.Lock()
        # the dashboard is the training side's health surface: make
        # sure the monitor's sampler is running so /metrics/history
        # accumulates and /readyz reflects registered checks
        health.get_monitor()
        self._server = reactor.HttpServer(host, port, self._route,
                                          name="web-status")
        self.port = self._server.port
        self.info("dashboard on http://%s:%d/", host, self.port)

    # -- routing (reactor loop; inline routes must not block) ----------

    def _route(self, request):
        path = request.path
        if request.method == "POST":
            if not path.startswith("/update"):
                request.reply(404, b"not found")
                return
            try:
                doc = json.loads(request.body)
                name = str(doc["name"])
            except (ValueError, KeyError):
                request.reply(400, b"bad status json")
                return
            with self._lock:
                # the poster chooses the name: cap the distinct-name
                # universe or any client can grow this dict forever
                if name not in self._pushed \
                        and len(self._pushed) >= _MAX_PUSHED:
                    request.reply(413, b"too many distinct status "
                                  b"names")
                    return
                self._pushed[name] = doc
            request.reply(200, b"ok")
            return
        if path.startswith(("/healthz", "/readyz",
                            "/metrics/history")):
            # the monitor's cached verdict only: no provider pulls,
            # no locks, no network, answered inline on the loop
            code, payload = health.health_endpoint(path)
            request.reply_json(code, payload)
        elif path.startswith("/metrics"):
            reg = telemetry.get_registry()
            request.reply(200, reg.render_prometheus().encode(),
                          reg.CONTENT_TYPE)
        elif path.startswith("/debug/profile"):
            # the sampling profiler BLOCKS for the requested capture
            # window — the one /debug surface that must never answer
            # on the loop: a worker thread captures and replies via
            # call_soon
            request.defer(self._serve_profile, request)
        elif path.startswith("/debug/model"):
            # model-health plane (model_health.py): the cached
            # verdict + per-layer training-dynamics snapshot — one
            # attribute read, safe inline on the loop
            request.reply_json(200, model_health.debug_model_doc())
        elif path.startswith("/debug/"):
            # flight-recorder surfaces: /debug/trace (Perfetto JSON
            # of the retained span window), /debug/events (recent
            # structured events) and /debug/critical_path (per-leg
            # step-time breakdown), the serving frontend's protocol
            payload = telemetry.debug_endpoint(path)
            if payload is None:
                request.reply(404, b"not found")
            else:
                request.reply_json(200, payload)
        elif path == "/" or path.startswith("/status.json"):
            # provider pulls run arbitrary registered callables: off
            # the loop
            request.defer(self._serve_status, request)
        else:
            request.reply(404, b"not found")

    def _serve_profile(self, request):
        # worker thread (request.defer): the capture sleeps out the
        # requested window while the loop keeps serving probes
        from veles_torch import profiling
        code, body, ctype = profiling.profile_endpoint(request.path)
        request.reply(code, body, ctype)

    def _serve_status(self, request):
        if request.path == "/":
            request.reply(200, self.render_page().encode(),
                          "text/html")
        else:
            request.reply(200,
                          json.dumps(self.snapshot(),
                                     indent=1).encode(),
                          "application/json")

    # -- providers -----------------------------------------------------

    def register(self, name, provider):
        """``provider()`` -> status dict, called at page-load time."""
        with self._lock:
            self._providers[name] = provider

    def snapshot(self):
        out = {}
        with self._lock:
            providers = dict(self._providers)
            out.update(self._pushed)
        for name, fn in providers.items():
            try:
                out[name] = fn()
            except Exception as exc:
                out[name] = {"error": str(exc)}
        return out

    def render_page(self):
        snap = self.snapshot()
        if not snap:
            return _PAGE % "<p>no runs registered</p>"
        # n_slaves/faults/slaves render a master's cluster row: its
        # topology, the fault counters and each slave's last job;
        # standalone rows leave them empty
        keys = ["mode", "workflow", "epoch", "best_metric",
                "last_metrics", "complete", "n_slaves", "faults",
                "slaves"]
        rows = [_row(["run"] + keys, "th")]
        for name, st in sorted(snap.items()):
            cells = [st.get(k, "") for k in keys]
            if isinstance(cells[-1], dict):
                cells[-1] = _slave_cells(cells[-1])
            rows.append(_row([name] + cells))
        return _PAGE % ("<table>%s</table>" % "".join(rows))

    def close(self):
        self._server.close()


def workflow_status(workflow, mode="standalone"):
    """Standard provider for a port ``NNWorkflow`` (what the launcher
    registers): its decision's epoch, best metric, last epoch's
    metrics and completion."""
    def provider():
        d = getattr(workflow, "decision", None)
        st = {"workflow": workflow.name, "mode": mode}
        if d is not None:
            st["epoch"] = d.epoch_number
            st["best_metric"] = (None if d.best_metric in (None, float("inf"))
                                 else round(float(d.best_metric), 6))
            if d.history:
                last = d.history[-1]
                st["last_metrics"] = {
                    k: (round(v["metric"], 6)
                        if isinstance(v, dict) else v)
                    for k, v in last.items() if k != "epoch"}
            st["complete"] = bool(d.complete)
        return st
    return provider
