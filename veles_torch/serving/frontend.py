"""HTTP/JSON serving frontend of the port + ``python -m veles_torch serve``.

Counterpart of ``veles/serving/frontend.py``: the same HTTP API, status
codes, probes and metric names, so the reference's router
(``veles/router.py``) and load generator (``veles/loadgen.py``) front a
port replica unchanged. The listener lives on the process's shared
selector reactor (``reactor.py``): probe and metrics routes answer
inline on the loop, each ``POST /v1/predict`` is handed to a worker
thread that parks in the micro-batcher until its batch completes, so
concurrent requests become batch fill on the device.

Endpoints:

* ``GET  /v1/models``  — the registry listing;
* ``POST /v1/predict`` — ``{"model": name, "inputs": [[...], ...],
  "timeout_ms": 250}`` -> ``{"outputs": [...], "version": n}``; 503 when
  shed, 504 past the deadline, 429 over a tenant's quota; the W3C
  ``traceparent`` header is honoured and echoed;
* ``POST /v1/generate`` — ``{"model", "prompt": [ids], "max_tokens",
  "temperature", "eos", "stream"}``: streamed (the default) as chunked
  ndjson through the reactor loop, one ``{"token": t}`` line per token
  and a ``{"done": true, ...}`` line; a client that disconnects (or
  stalls past the write-queue bound) frees its KV slot and counts
  ``veles_serving_rejected_total{reason="disconnect"}``; ``stream:
  false`` answers once;
* ``POST /v1/models/<name>/refresh`` — load the checkpoint the body
  names, or the newest healthy one of the model's store;
* ``GET  /healthz``, ``/readyz``, ``/metrics/history`` — the health
  plane (``health.py``): ready while a model is warm, no store breaker
  is open, the batcher is not shedding, the decode loops live and no SLO
  fires;
* ``GET  /metrics`` — Prometheus text of the telemetry registry;
  ``GET /metrics.json`` — the per-model JSON view;
* ``GET  /debug/trace``, ``/debug/events`` (flight recorder),
  ``/debug/model`` (model-health snapshot), ``/debug/tenants`` (the
  tenant table); ``GET /debug/critical_path`` — the flight-recorder
  window as a per-leg breakdown (``?window=SECS``); ``GET
  /debug/profile?seconds=N&hz=H`` — a live sampling-profiler capture
  (speedscope JSON; captured on a worker thread via ``request.defer``,
  ``python -m veles_torch profile``). Both from ``profiling.py``.

The registry, and so every forward and decode step, runs on ``cuda``
unless ``-d cpu`` (or ``--backend numpy``) is given.
"""

import json
import signal
import threading
import time

import numpy

from veles_torch import health, model_health, reactor, telemetry
from veles_torch.logger import Logger
from veles_torch.serving import tenants
from veles_torch.serving.batcher import DeadlineExceeded, QueueFull

#: overload rejections by reason and tenant: "shed" = the micro-batcher's queue was full,
#: "not_ready" = readiness was false (no warm model / breaker open /
#: SLO firing), "disconnect" = a streaming /v1/generate client
#: dropped (or overflowed its write queue) mid-decode and its KV slot
#: was reclaimed, "quota" = the tenant's token bucket was
#: dry (429), "priority" = a best-effort tenant shed first while the
#: process was under pressure (503)
_REJECTED = telemetry.LazyChild(
    lambda: telemetry.counter(
        "veles_serving_rejected_total",
        "Requests rejected with 429/503 before any forward compute, "
        "by reason and tenant", ("reason", "tenant")))

#: tenant label used before any table is installed / outside HTTP —
#: keeps the label set bounded without a resolver in the loop
_NO_TENANT = tenants.DEFAULT_TENANT


def _count_rejected(reason, tenant):
    _REJECTED.get().labels(reason, tenant or _NO_TENANT).inc()


#: per-tenant request/latency attribution. Tenant values are resolver
#: output only (a bounded label set).
#: Latency is observed for ANSWERED (2xx) requests — goodput latency,
#: the series the per-tenant p99 burn-rate SLOs watch.
_T_REQUESTS = telemetry.LazyChild(
    lambda: telemetry.counter(
        "veles_serving_tenant_requests_total",
        "Serving requests by resolved tenant and route",
        ("tenant", "route")))
_T_LATENCY = telemetry.LazyChild(
    lambda: telemetry.histogram(
        "veles_serving_tenant_latency_seconds",
        "End-to-end answered-request latency by resolved tenant",
        ("tenant",)))

#: Retry-After (seconds) sent with 503s: shed queues drain within a
#: batching window; readiness usually needs a reload/recovery cycle
RETRY_AFTER_SHED = 1
RETRY_AFTER_NOT_READY = 5

#: batcher-shedding readiness threshold: the process reports NOT
#: ready when more than this fraction of recent submissions (between
#: two monitor ticks, with a minimum volume) was shed — a router can
#: then drain it instead of hammering a saturated queue
SHED_READY_RATIO = 0.9
SHED_READY_MIN = 16


class ServingFrontend(Logger):
    """HTTP face of a :class:`ModelRegistry`; port=0 picks a free
    one (see ``.port``)."""

    def __init__(self, registry, port=0, host="127.0.0.1"):
        self.name = "serving"
        self.registry = registry
        # bind first (check names carry the port), wire health, THEN
        # accept: the first request may arrive the instant the
        # acceptor registers, and the predict gate reads self._monitor
        self._server = reactor.HttpServer(host, port, self._route,
                                          name="serving-http",
                                          start=False)
        self.port = self._server.port
        self.host = host
        self._check_names = ()
        self._shed_seen = None
        self.register_health()
        self._server.start()
        self.info("serving on http://%s:%d/", host, self.port)

    # -- routing (reactor loop; inline routes must not block) ----------

    def _route(self, request):
        path = request.path
        if request.method == "POST":
            if path == "/v1/predict":
                # predict parks in the micro-batcher until its batch
                # completes — exactly the wait that must NOT happen
                # on the loop, so each predict gets a worker thread
                # (that thread-count IS the batch fill, as before)
                request.defer(self._serve_predict, request)
            elif path == "/v1/generate":
                # generate SUBMITS (non-blocking) and then streams
                # from decode-thread callbacks, but the first-use
                # decoder build and a non-streaming wait do block —
                # worker thread, replies posted back to the loop
                request.defer(self._serve_generate, request)
            elif (path.startswith("/v1/models/")
                    and path.endswith("/refresh")):
                # the rolling-refresh hook: store scan + checkpoint
                # load both block — worker thread
                request.defer(self._serve_refresh, request,
                              path[len("/v1/models/"):-len("/refresh")])
            else:
                request.reply_json(404, {"error": "not found"})
            return
        if path.startswith(("/healthz", "/readyz",
                            "/metrics/history")):
            # the probe contract: serve the
            # monitor's CACHED verdict — no locks, no registry
            # scans, no network, inline on the loop
            code, payload = health.health_endpoint(path)
            request.reply_json(code, payload)
        elif path.startswith("/metrics.json"):
            # the pre-registry JSON shape, now a view over the
            # telemetry registry
            request.reply_json(200, self.metrics())
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
            # model-health plane (model_health.py): the cached snapshot
            # incl. per-model serving drift gauges — one attribute
            # read, safe inline on the loop
            request.reply_json(200, model_health.debug_model_doc())
        elif path.startswith("/debug/tenants"):
            # tenant table + live bucket levels: a short
            # lock around a dict walk, no I/O — loop-safe
            table = tenants.get_table()
            if table is None:
                request.reply_json(
                    404, {"error": "no tenant table (--tenants)"})
            else:
                request.reply_json(200, table.describe())
        elif path.startswith("/debug/"):
            payload = telemetry.debug_endpoint(path)
            if payload is None:
                request.reply_json(404, {"error": "not found"})
            else:
                request.reply_json(200, payload)
        elif path.startswith("/v1/models"):
            request.reply_json(200,
                               {"models": self.registry.describe()})
        else:
            request.reply_json(404, {"error": "not found"})

    def _serve_profile(self, request):
        from veles_torch import profiling
        code, body, ctype = profiling.profile_endpoint(request.path)
        request.reply(code, body, ctype)

    def _serve_refresh(self, request, name):
        """Worker-thread half of ``POST /v1/models/<name>/refresh``:
        hot-load either the explicit checkpoint in the
        body (``{"checkpoint": ...}`` — what the router's rolling
        refresh sends after its own health gate) or the newest
        healthy one the refresh poll finds (``{"store": ...}``
        optionally naming where to scan)."""
        try:
            doc = json.loads(request.body) if request.body else {}
        except ValueError:
            request.reply_json(400, {"error": "bad json"})
            return
        try:
            entry = self.registry.get(name)
        except KeyError:
            request.reply_json(404, {"error": "no model %r" % name})
            return
        # the body names filesystem/store targets: admit only paths
        # inside the stores this entry was configured with server-side
        # — the HTTP plane must not get to
        # point the registry at arbitrary directories
        try:
            checkpoint, store = self.registry.resolve_refresh_target(
                entry, checkpoint=doc.get("checkpoint"),
                store=doc.get("store"))
        except ValueError as exc:
            request.reply_json(400, {"error": str(exc)})
            return
        try:
            if checkpoint:
                entry = self.registry.load(
                    name, entry.source, checkpoint=checkpoint,
                    refresh_store=store)
                loaded = checkpoint
            else:
                loaded = self.registry.refresh_newest(
                    name, store_target=store)
                entry = self.registry.get(name)
        except (ValueError, OSError) as exc:
            request.reply_json(409, {"error": str(exc)})
            return
        request.reply_json(200, {
            "model": name, "version": entry.version,
            "loaded": loaded,
            "checkpoint_meta": dict(entry.model.checkpoint_meta)})

    @staticmethod
    def _reply_headers(code, reply, tp_header):
        """Response headers for one JSON reply: the traceparent echo
        always; on 429/503 also Retry-After — an overload/quota/
        readiness rejection tells the caller WHEN to come back
        instead of a generic failure."""
        if code in (429, 503):
            return tp_header + (
                ("Retry-After",
                 str(reply.get("retry_after_s", RETRY_AFTER_SHED))),)
        return tp_header

    @staticmethod
    def _tenant_of(request):
        """Resolve the request's ``x-veles-tenant`` header to a
        BOUNDED tenant name (known key, configured default, or the
        ``other`` fold). With no table installed every caller is the
        default tenant — raw header values never reach a label."""
        table = tenants.get_table()
        if table is None:
            return _NO_TENANT
        return table.resolve(request.headers.get("x-veles-tenant"))

    def _serve_predict(self, request):
        # join the caller's distributed trace, or root a new one:
        # either way the response names the context so the caller
        # can correlate
        trace = telemetry.TraceContext.from_traceparent(
            request.headers.get("traceparent"))
        if trace is None:
            trace = telemetry.TraceContext.new()
        tp_header = (("traceparent", trace.to_traceparent()),)
        try:
            doc = json.loads(request.body)
        except ValueError:
            # the 400 carries the echo too: callers correlate
            # failures by the same header as successes
            request.reply_json(400, {"error": "bad json"},
                               headers=tp_header)
            return
        code, reply = self.predict_request(
            doc, trace=trace, tenant=self._tenant_of(request))
        request.reply_json(code, reply,
                           headers=self._reply_headers(
                               code, reply, tp_header))

    # -- generative decode ---------------------------------------------

    def _serve_generate(self, request):
        """Worker-thread half of ``POST /v1/generate``: validate +
        submit to the continuous batcher, then either stream tokens
        as chunked ndjson (written through the reactor loop by the
        decode thread's callbacks) or wait and answer once."""
        trace = telemetry.TraceContext.from_traceparent(
            request.headers.get("traceparent"))
        if trace is None:
            trace = telemetry.TraceContext.new()
        tp_header = (("traceparent", trace.to_traceparent()),)
        try:
            doc = json.loads(request.body)
        except ValueError:
            request.reply_json(400, {"error": "bad json"},
                               headers=tp_header)
            return
        stream_mode = bool(doc.get("stream", True)) \
            if isinstance(doc, dict) else True
        tenant = self._tenant_of(request)
        if not stream_mode:
            code, reply = self.generate_request(doc, trace=trace,
                                                tenant=tenant)
            request.reply_json(code, reply,
                               headers=self._reply_headers(
                                   code, reply, tp_header))
            return
        t0 = time.perf_counter()
        code, reply, handle, entry = self._submit_generate(
            doc, trace, tenant)
        if handle is None:
            request.reply_json(code, reply,
                               headers=self._reply_headers(
                                   code, reply, tp_header))
            return
        stream = request.begin_stream(
            200, "application/x-ndjson", headers=tp_header,
            on_close=lambda reason: self._generate_disconnect(
                handle, reason, tenant))
        stream.write(json.dumps(
            {"model": entry.name, "version": entry.version}) + "\n")

        def on_token(tok):
            stream.write(json.dumps({"token": int(tok)}) + "\n")

        def on_done(req):
            if req.error is not None:
                stream.write(json.dumps(
                    {"error": str(req.error)}) + "\n")
            else:
                stream.write(json.dumps(
                    {"done": True, "n": len(req.tokens),
                     "tokens": [int(t) for t in req.tokens],
                     "finish_reason": req.finish_reason}) + "\n")
                _T_LATENCY.get().labels(tenant or _NO_TENANT) \
                    .observe(time.perf_counter() - t0)
            stream.end()

        handle.set_on_token(on_token)
        handle.set_on_done(on_done)

    def _generate_disconnect(self, handle, reason, tenant=None):
        """The stream's connection died before the terminal chunk
        (client gone, or its bounded write queue overflowed): stop
        decoding and give the KV slot back. Runs on the reactor loop
        — flag flips and a counter only, nothing blocking."""
        if handle.done.is_set():
            return                   # raced a normal finish: no-op
        _count_rejected("disconnect", tenant)
        handle.cancel("disconnect")

    def _submit_generate(self, doc, trace, tenant=None):
        """Validate + submit one generation; -> (code, error_reply,
        handle|None, entry|None). Shared by the streaming and
        one-shot paths."""
        _T_REQUESTS.get().labels(tenant or _NO_TENANT,
                                 "generate").inc()
        blocked = self._admission_block((":shedding",), tenant)
        if blocked:
            return blocked[0], blocked[1], None, None
        try:
            name = doc["model"]
            prompt = doc["prompt"]
            if not isinstance(prompt, (list, tuple)):
                raise TypeError("prompt must be a list of token ids")
        except (KeyError, TypeError) as exc:
            return 400, {"error": "bad request: %s" % exc}, \
                None, None
        try:
            entry = self.registry.get(name)
            decoder = self.registry.decoder(name)
        except KeyError as exc:
            return 404, {"error": str(exc)}, None, None
        except ValueError as exc:
            # loaded, but not an LM archive — client-fixable
            return 400, {"error": str(exc)}, None, None
        try:
            handle = decoder.submit(
                prompt, max_tokens=doc.get("max_tokens"),
                temperature=float(doc.get("temperature", 0.0)),
                eos=doc.get("eos"),
                timeout_ms=doc.get("timeout_ms"), trace=trace,
                tenant=tenant)
        except QueueFull as exc:
            _count_rejected("shed", tenant)
            return 503, {"error": str(exc),
                         "retry_after_s": RETRY_AFTER_SHED}, \
                None, None
        except (ValueError, TypeError) as exc:
            return 400, {"error": str(exc)}, None, None
        return 200, None, handle, entry

    def generate_request(self, doc, trace=None, wait_s=120.0,
                         tenant=None):
        """One-shot (non-streaming) generate: -> (code, reply dict).
        Shared by the HTTP handler and tests (no socket needed)."""
        t0 = time.perf_counter()
        with telemetry.context(trace):
            code, reply, handle, entry = self._submit_generate(
                doc, trace, tenant)
            if handle is not None:
                try:
                    tokens = handle.wait(wait_s)
                    code, reply = 200, {
                        "model": entry.name,
                        "version": entry.version,
                        "tokens": [int(t) for t in tokens],
                        "n": len(tokens),
                        "finish_reason": handle.finish_reason}
                    _T_LATENCY.get().labels(tenant or _NO_TENANT) \
                        .observe(time.perf_counter() - t0)
                except DeadlineExceeded as exc:
                    # the client hears failure — the generation must
                    # not keep decoding into an answer nobody reads
                    # (its KV slot frees at the next step boundary)
                    handle.cancel("wait timeout")
                    code, reply = 504, {"error": str(exc)}
                except Exception as exc:
                    handle.cancel("request failed")
                    code, reply = 500, {"error": "%s: %s"
                                        % (type(exc).__name__, exc)}
        if telemetry.tracer.active:
            args = {"code": code, "model": str(doc.get("model"))
                    if isinstance(doc, dict) else "?"}
            if trace is not None:
                args.update(trace.span_args())
            telemetry.tracer.add_complete(
                "http.generate", t0, time.perf_counter() - t0,
                **args)
        return code, reply

    # -- readiness (veles/health.py) -----------------------------------

    def register_health(self, monitor=None):
        """Wire this frontend's readiness into the health monitor.
        The checks run on the MONITOR thread (they may take the
        registry lock and read breaker state); ``/readyz`` serves the
        cached verdict. Names carry the port so several frontends in
        one process (tests) keep distinct checks."""
        monitor = monitor or health.get_monitor()
        self._monitor = monitor
        prefix = "serving:%d" % self.port
        self._check_names = (prefix + ":models",
                             prefix + ":snapshot_store",
                             prefix + ":shedding",
                             prefix + ":decode")
        # one tick for the batch, not one per check
        monitor.add_check(self._check_names[0], self._check_models,
                          tick=False)
        monitor.add_check(self._check_names[1], self._check_stores,
                          tick=False)
        monitor.add_check(self._check_names[2], self._check_shedding,
                          tick=False)
        monitor.add_check(self._check_names[3], self._check_decode)
        return monitor

    def _check_models(self):
        """Ready iff the registry serves at least one model and no
        requested warmup is still running its bucket ladder."""
        names = self.registry.names()
        if not names:
            return False, "no models loaded"
        cold = [e.name for e in self._entries()
                if not getattr(e, "warm", True)]
        if cold:
            return False, "warmup in progress: %s" % ", ".join(cold)
        return True, None

    def _entries(self):
        out = []
        for name in self.registry.names():
            try:
                out.append(self.registry.get(name))
            except KeyError:       # unloaded between names() and get()
                continue
        return out

    def _check_stores(self):
        """Fail while any model's HTTP checkpoint store has its
        circuit breaker open (refreshes are fast-failing)."""
        broken = []
        for entry in self._entries():
            store = self.registry.checkpoint_store(entry.checkpoint)
            if store is not None and store.breaker_open():
                broken.append(entry.name)
        if broken:
            return False, ("snapshot-store breaker open for: %s"
                           % ", ".join(broken))
        return True, None

    def _check_shedding(self):
        """Fail while the micro-batcher shed more than
        :data:`SHED_READY_RATIO` of the submissions since the last
        tick (minimum :data:`SHED_READY_MIN` sheds — a lone 503 on an
        idle process must not flip readiness)."""
        reg = telemetry.get_registry()
        shed = reg.counter_total("veles_serving_shed_total")
        accepted = reg.counter_total("veles_serving_requests_total")
        prev = self._shed_seen
        self._shed_seen = (shed, accepted)
        if prev is None:
            return True, None
        d_shed = shed - prev[0]
        d_total = d_shed + max(accepted - prev[1], 0.0)
        if d_shed >= SHED_READY_MIN \
                and d_shed > SHED_READY_RATIO * d_total:
            return False, ("shedding %d/%d recent submissions"
                           % (int(d_shed), int(d_total)))
        return True, None

    def _check_decode(self):
        """Fail while any model's decode loop is dead or wedged
        (``ContinuousBatcher.healthy``): the worker thread must be
        alive and, with sequences in flight, keep completing steps.
        Models that never built a decoder (or aren't generative)
        don't participate."""
        bad = []
        for entry in self._entries():
            decoder = getattr(entry, "decoder", None)
            if decoder is not None:
                ok, why = decoder.healthy()
                if not ok:
                    bad.append("%s: %s" % (entry.name, why))
        if bad:
            return False, "; ".join(bad)
        return True, None

    # -- request handling ----------------------------------------------

    def predict_request(self, doc, trace=None, tenant=None):
        """-> (http_code, reply_dict); shared by the HTTP handler and
        tests (no socket needed to exercise the logic). ``trace`` is
        the request's :class:`veles_torch.telemetry.TraceContext` — threaded
        through batcher and engine so queue wait and batched execution
        appear as spans of the caller's trace. ``tenant`` is resolver
        output (bounded; see :meth:`_tenant_of`)."""
        t0 = time.perf_counter()
        _T_REQUESTS.get().labels(tenant or _NO_TENANT,
                                 "predict").inc()
        # bind the request's trace as the thread's active context so
        # every log line emitted on its behalf carries the ids
        # (structured-log/trace correlation)
        with telemetry.context(trace):
            code, reply = self._predict_request(doc, trace, tenant)
        if code == 200:
            _T_LATENCY.get().labels(tenant or _NO_TENANT) \
                .observe(time.perf_counter() - t0)
        if telemetry.tracer.active:
            args = {"code": code, "model": str(doc.get("model"))
                    if isinstance(doc, dict) else "?"}
            if trace is not None:
                args.update(trace.span_args())
            telemetry.tracer.add_complete(
                "http.predict", t0, time.perf_counter() - t0, **args)
        return code, reply

    def _admission_block(self, exclude, tenant=None):
        """The (code, reply) that should reject this admission, or
        None. Three gates, in order:

        * **readiness** — a not-ready process (cold registry, open
          breaker, firing SLO) must shed load with an honest retry
          hint, not half-serve it — EXCEPT the ``exclude`` check
          suffixes: shedding-only unreadiness would flap at the
          monitor interval (no admissions -> next tick sees zero
          sheds -> ready -> readmit the storm), and a wedged DECODE
          loop must not refuse plain predicts. /readyz still reports
          everything, so a router can drain. Reasons are keyed on
          the check NAME part of "name: reason" (several frontends
          may share this process's monitor). 503.
        * **priority** — while the shedding check fires,
          best-effort tenants (priority class ``batch``) are shed
          FIRST even though the check is excluded for everyone else:
          pressure relief starts with the traffic that asked to be
          preemptible. 503.
        * **quota** — the tenant's token bucket; a dry
          bucket answers 429 with the exact Retry-After the bucket
          computes.

        Every rejection is counted
        ``veles_serving_rejected_total{reason,tenant}``."""
        ready, reasons = self._monitor.ready_state()
        if not ready:
            blocking = [r for r in reasons
                        if not r.split(": ", 1)[0].endswith(exclude)]
            if blocking:
                _count_rejected("not_ready", tenant)
                return 503, {"error": "not ready",
                             "reasons": blocking,
                             "retry_after_s": RETRY_AFTER_NOT_READY}
        table = tenants.get_table()
        if table is None or tenant is None:
            return None
        if not ready and table.best_effort(tenant) \
                and any(r.split(": ", 1)[0].endswith(":shedding")
                        for r in reasons):
            _count_rejected("priority", tenant)
            return 503, {"error": "shed: best-effort tenant %r "
                         "under pressure" % tenant,
                         "retry_after_s": RETRY_AFTER_SHED}
        ok, retry_after = table.admit(tenant)
        if not ok:
            _count_rejected("quota", tenant)
            return 429, {"error": "quota exceeded for tenant %r"
                         % tenant,
                         "retry_after_s": round(retry_after, 3)}
        return None

    def _predict_request(self, doc, trace, tenant=None):
        blocked = self._admission_block((":shedding", ":decode"),
                                        tenant)
        if blocked:
            return blocked
        try:
            name = doc["model"]
            inputs = numpy.asarray(doc["inputs"], numpy.float32)
        except (KeyError, TypeError, ValueError) as exc:
            return 400, {"error": "bad request: %s" % exc}
        try:
            entry = self.registry.get(name)
        except KeyError as exc:
            return 404, {"error": str(exc)}
        sample = entry.model.input_sample_shape
        if inputs.ndim > 0 and sample is not None \
                and inputs.shape[1:] != sample:
            # accept a single un-batched sample by promoting it
            if inputs.shape == sample:
                inputs = inputs[None]
            else:
                return 400, {"error": "input shape %s != (n,)+%s"
                             % (inputs.shape, sample)}
        elif sample is None and inputs.ndim == 1:
            # no recorded sample shape to validate against: a flat
            # list is one sample, not N scalar rows
            inputs = inputs[None]
        if inputs.ndim == 0 or inputs.shape[0] == 0:
            return 400, {"error": "empty inputs"}
        try:
            out = entry.predict(inputs,
                                timeout_ms=doc.get("timeout_ms"),
                                trace=trace, tenant=tenant)
        except QueueFull as exc:
            _count_rejected("shed", tenant)
            return 503, {"error": str(exc),
                         "retry_after_s": RETRY_AFTER_SHED}
        except DeadlineExceeded as exc:
            return 504, {"error": str(exc)}
        except (ValueError, TypeError) as exc:
            # client-fixable: too many rows for max_batch, garbage
            # timeout_ms — a 4xx, not a server fault
            return 400, {"error": str(exc)}
        except Exception as exc:
            return 500, {"error": "%s: %s"
                         % (type(exc).__name__, exc)}
        return 200, {"model": name, "version": entry.version,
                     "outputs": numpy.asarray(out).tolist()}

    def metrics(self):
        return {"models": self.registry.metrics()}

    # -- dashboard integration -----------------------------------------

    def register_status(self, web_status):
        """Surface serving metrics in the web-status dashboard."""
        front = self

        def provider():
            per_model = front.registry.metrics()
            agg_rps = round(sum(m["requests_per_sec"]
                                for m in per_model.values()), 2)
            return {
                "mode": "serving",
                "workflow": ",".join(sorted(per_model) or ["-"]),
                "epoch": "",
                "best_metric": "",
                "last_metrics": {
                    name: {"rps": m["requests_per_sec"],
                           "fill": m["batch_fill_ratio"],
                           "p99_ms": m.get("latency_ms_p99"),
                           "queue": m["queue_depth"],
                           "shed": m["shed_total"]}
                    for name, m in per_model.items()},
                "complete": "rps=%s" % agg_rps,
            }

        web_status.register("serving:%d" % self.port, provider)

    def close(self):
        for name in self._check_names:
            self._monitor.remove_check(name, tick=False)
        if self._check_names:
            self._monitor.tick()
        self._check_names = ()
        self._server.close()


# -- python -m veles_torch serve ----------------------------------------


def build_serve_argparser():
    import argparse
    from veles_torch.serving.quant import MODES
    p = argparse.ArgumentParser(
        prog="python -m veles_torch serve",
        description="Serve exported models over HTTP with dynamic "
                    "batching, on the card")
    p.add_argument("--model", action="append", required=True,
                   metavar="NAME=DIR",
                   help="model name = export_inference archive directory "
                        "(repeatable)")
    p.add_argument("--checkpoint", action="append", default=[],
                   metavar="NAME=PATH",
                   help="refresh NAME's params from a checkpoint (local "
                        "path or http(s):// URI)")
    p.add_argument("--port", type=int, default=8080,
                   help="HTTP port (0 = pick a free one)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("-d", "--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "jit", "numpy"),
                   help="auto/jit: the port's engine on --device; numpy: "
                        "the engine on the CPU (the reference's host "
                        "executor)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="largest padded batch bucket")
    p.add_argument("--max-queue", type=int, default=256,
                   help="pending-row cap before requests are shed with "
                        "503")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="batching window from the oldest queued request")
    p.add_argument("--timeout-ms", type=float, default=1000.0,
                   help="default per-request deadline")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the bucket-ladder warmup")
    p.add_argument("--quantize-weights", default="none", choices=MODES,
                   help="store model weights quantized at rest "
                        "(dequantized at dispatch)")
    p.add_argument("--decode-slots", type=int, default=8,
                   help="KV pool slots = width of the shared continuous "
                        "decode batch (/v1/generate)")
    p.add_argument("--decode-max-len", type=int, default=256,
                   help="per-slot KV length: prompt + max_tokens must fit "
                        "(clamped to the exported positions table)")
    p.add_argument("--refresh-every", type=float, default=None,
                   metavar="SECS",
                   help="poll each model's snapshot store this often and "
                        "hot-load the newest HEALTHY checkpoint (diverged "
                        "ones are skipped and counted)")
    p.add_argument("--refresh-store", action="append", default=[],
                   metavar="NAME=TARGET",
                   help="snapshot store (dir or http base) the refresh "
                        "poll scans for NAME; defaults to the store of "
                        "--checkpoint")
    p.add_argument("--tenants", default=None, metavar="PATH",
                   help="per-tenant QoS config (JSON; see "
                        "veles_torch/serving/tenants.py): x-veles-tenant "
                        "resolution, 429 quotas, weighted-fair batching "
                        "and per-tenant p99 SLOs")
    p.add_argument("--slo-config", default=None, metavar="PATH",
                   help="JSON list of SLO objectives for the health "
                        "monitor (burn-rate alerts -> /readyz, "
                        "/debug/events, veles_slo_* gauges)")
    p.add_argument("--web-status", type=int, default=None, metavar="PORT",
                   help="also serve the status dashboard on this port "
                        "(0 = pick a free one)")
    return p


def _parse_kv(pairs, what):
    out = {}
    for pair in pairs:
        name, sep, value = pair.partition("=")
        if not sep or not name or not value:
            raise SystemExit("%s %r: expected NAME=VALUE" % (what, pair))
        out[name] = value
    return out


def serve_main(argv=None):
    """``python -m veles_torch serve ...``: build the registry, start the
    frontend, print one JSON line (the bound address and the models),
    serve until interrupted or SIGTERM'd (a clean stop: the frontend and
    the registry are closed), -> 0."""
    from veles_torch.serving.registry import ModelRegistry
    args = build_serve_argparser().parse_args(argv)
    models = _parse_kv(args.model, "--model")
    checkpoints = _parse_kv(args.checkpoint, "--checkpoint")
    refresh_stores = _parse_kv(args.refresh_store, "--refresh-store")
    unknown = sorted((set(checkpoints) | set(refresh_stores))
                     - set(models))
    if unknown:
        raise SystemExit("--checkpoint/--refresh-store for unloaded "
                         "model(s): %s" % ", ".join(unknown))
    telemetry.tracer.set_process_name("serving")
    if args.tenants:
        table = tenants.set_table(
            tenants.TenantTable.from_file(args.tenants))
        n = len(table.install_slos(health.get_monitor()))
        print("tenant table: %d tenant(s), %d p99 SLO(s)"
              % (len(table.names()), n), flush=True)
    registry = ModelRegistry(
        backend=args.backend, max_batch=args.max_batch,
        max_queue=args.max_queue, max_wait_ms=args.max_wait_ms,
        default_timeout_ms=args.timeout_ms,
        decode_slots=args.decode_slots,
        decode_max_len=args.decode_max_len,
        quantize_weights=args.quantize_weights, device=args.device)
    front = status = None
    poll_stop = threading.Event()
    try:
        # inside the guard from the first load on: a bad archive must
        # not strand the registry's batcher threads
        for name, source in sorted(models.items()):
            registry.load(name, source, checkpoint=checkpoints.get(name),
                          warmup=not args.no_warmup,
                          refresh_store=refresh_stores.get(name))
        front = ServingFrontend(registry, port=args.port, host=args.host)
        if args.refresh_every:
            def refresh_poll():
                while not poll_stop.wait(args.refresh_every):
                    for name in sorted(models):
                        try:
                            registry.refresh_newest(name)
                        except ValueError:
                            pass    # no store configured for it
            threading.Thread(target=refresh_poll, daemon=True,
                             name="RefreshPoll").start()
        if args.slo_config:
            n = health.get_monitor().load_slo_file(args.slo_config)
            front.info("%d SLO objective(s) loaded from %s", n,
                       args.slo_config)
        if args.web_status is not None:
            from veles_torch.web_status import WebStatus
            status = WebStatus(port=args.web_status, host=args.host)
            front.register_status(status)
        print(json.dumps({
            "serving": "http://%s:%d" % (front.host, front.port),
            "models": [{"name": d["name"], "version": d["version"],
                        "backend": d["backend"],
                        "compiled_buckets": d["compiled_buckets"]}
                       for d in registry.describe()],
        }), flush=True)
        stop = threading.Event()
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
        try:
            while not stop.wait(1.0):
                pass
        except KeyboardInterrupt:
            pass
    finally:
        poll_stop.set()
        if status is not None:
            status.close()
        if front is not None:
            front.close()
        registry.close()
    return 0
