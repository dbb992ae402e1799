"""Health plane of the port: metrics history, probes, SLO burn-rate
alerts.

The port's own copy of ``veles/health.py`` (it imports nothing of the
JAX package). :class:`HealthMonitor`, one per process
(:func:`get_monitor`), owns:

* a **time-series ring**: a background sampler copies the registry
  families under :data:`DEFAULT_PREFIXES` into bounded ``(wall,
  {series: value})`` snapshots at a fixed cadence, served as ``GET
  /metrics/history?window=SECS``;
* **readiness checks**: named callables evaluated on the sampler
  thread each tick; the results are cached into the probe document
  that ``GET /healthz`` / ``GET /readyz`` serve with one attribute
  read (a probe handler never blocks);
* an **SLO engine**: declarative objectives evaluated over the ring
  with the multi-window burn-rate method, ``burn = error_ratio / (1 -
  target)`` over a fast and a slow window, alerting while both exceed
  ``burn_threshold``. Transitions land in the flight recorder
  (``telemetry.record_event``, ``/debug/events``) and the
  ``veles_slo_*`` gauges; firing objectives flip ``/readyz`` with a
  reason naming them.

SLO config format (``--slo-config objectives.json``, a JSON list)::

    [{"name": "serving_p99_latency",
      "kind": "threshold",                      # default
      "series": "veles_serving_latency_seconds{model=\\"mnist\\"}:p99",
      "op": "<=", "threshold": 0.25,            # good sample iff
      "target": 0.99,                           # 99% of samples good
      "fast_window": 60, "slow_window": 300,
      "burn_threshold": 1.0},
     {"name": "predict_error_ratio",
      "kind": "ratio",                          # counter-delta ratio
      "bad": "veles_serving_error_total",
      "total": "veles_serving_requests_total",
      "target": 0.999}]

Series keys are ``family`` or ``family{label="v"}`` exactly as the ring
stores them; histograms add ``:p50``/``:p99``/``:count`` suffixes. A bare
family name matches the sum over its children. Every tick registers
the memory gauges of ``profiling.py`` (``veles_host_*``,
``veles_device_*`` once CUDA is initialized, ``veles_perf_*``) in the
active registry, so the ring samples them.
"""

import collections
import json
import threading
import time
from contextlib import contextmanager
from urllib.parse import parse_qs, urlparse

from veles_torch import telemetry
from veles_torch.logger import Logger

#: registry family prefixes the ring samples by default — the
#: operational families every surface exports (adding a prefix costs
#: one dict entry per child per tick, nothing on any hot path)
DEFAULT_PREFIXES = (
    "veles_serving_", "veles_cluster_", "veles_master_",
    "veles_slave_", "veles_wire_", "veles_step_", "veles_loader_",
    "veles_checkpoint_", "veles_slo_", "veles_grad_",
    "veles_reactor_",
    # memory accounting (the profiling module): host RSS/fds,
    # device allocator stats, perf-ledger + forward-cache estimates —
    # ring-sampled so /metrics/history carries memory TRAJECTORIES
    # and SLO objectives can fire on leaks
    "veles_host_", "veles_device_", "veles_perf_",
    # fleet control (the router, veles/router.py): routed-request
    # counters/latency and backend inflight — ring-sampled so SLO
    # objectives can fire on router-observed p99 and the autoscaler's
    # own decisions are trendable in /metrics/history
    "veles_router_",
    # model health (model_health.py): per-layer
    # grad/weight norms, loss z-score, non-finite step counts and the
    # verdict gauge — ring-sampled so the divergence SLOs
    # (install_model_slos) evaluate over them
    "veles_model_",
    # continual loop (veles/continual.py): the end-to-end
    # staleness gauge the burn-rate SLO evaluates over, round
    # progress, and stream-ingest prefetch/failure counters
    "veles_staleness_", "veles_continual_", "veles_stream_",
)

#: sampler cadence (seconds) and ring capacity: 1 Hz x 900 samples =
#: a 15-minute window, comfortably covering the default slow
#: burn-rate window with bounded memory
DEFAULT_INTERVAL = 1.0
DEFAULT_MAX_SAMPLES = 900

_OPS = {
    "<=": lambda v, t: v <= t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    ">": lambda v, t: v > t,
}


class SLObjective:
    """One declarative objective + its alert state (see the module
    docstring for the spec format)."""

    def __init__(self, spec):
        spec = dict(spec)
        self.name = str(spec.pop("name", "") or "")
        if not self.name:
            raise ValueError("SLO spec needs a 'name'")
        self.kind = str(spec.pop("kind", "threshold"))
        if self.kind not in ("threshold", "ratio"):
            raise ValueError("SLO %s: kind must be threshold|ratio, "
                             "not %r" % (self.name, self.kind))
        def required(key):
            value = spec.pop(key, None)
            if value is None:
                raise ValueError("SLO %s (kind %s): missing required "
                                 "key %r" % (self.name, self.kind,
                                             key))
            return value

        if self.kind == "threshold":
            self.series = str(required("series"))
            op = str(spec.pop("op", "<="))
            if op not in _OPS:
                raise ValueError("SLO %s: op must be one of %s"
                                 % (self.name, sorted(_OPS)))
            self.op_name = op
            self.op = _OPS[op]
            self.threshold = float(required("threshold"))
        else:
            self.bad = str(required("bad"))
            self.total = str(required("total"))
        self.target = float(spec.pop("target", 0.99))
        if not 0.0 < self.target < 1.0:
            raise ValueError("SLO %s: target must be in (0, 1)"
                             % self.name)
        self.fast_window = float(spec.pop("fast_window", 60.0))
        self.slow_window = float(spec.pop("slow_window", 300.0))
        self.burn_threshold = float(spec.pop("burn_threshold", 1.0))
        if spec:
            raise ValueError("SLO %s: unknown key(s) %s"
                             % (self.name, sorted(spec)))
        #: alert state (evaluated on the monitor thread only)
        self.firing = False
        self.fired_at = None
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.error_ratio = 0.0

    def describe(self):
        doc = {"kind": self.kind, "target": self.target,
               "fast_window": self.fast_window,
               "slow_window": self.slow_window,
               "burn_threshold": self.burn_threshold,
               "firing": self.firing,
               "burn_fast": round(self.burn_fast, 4),
               "burn_slow": round(self.burn_slow, 4),
               "error_ratio": round(self.error_ratio, 6)}
        if self.kind == "threshold":
            doc["series"] = self.series
            doc["op"] = self.op_name
            doc["threshold"] = self.threshold
        else:
            doc["bad"] = self.bad
            doc["total"] = self.total
        return doc


def _series_value(flat, key):
    """Resolve ``key`` against one ring sample: exact hit first, else
    the SUM over the family's labelled children (``key{...}``) — the
    natural reading for counters/gauges; percentile keys should be
    addressed exactly. None when nothing matches."""
    v = flat.get(key)
    if v is not None:
        return v
    prefix = key + "{"
    total, hit = 0.0, False
    for k, v in flat.items():
        # endswith("}") excludes the :p50/:p99/:count suffix keys
        # without also excluding label VALUES that contain a colon
        # (endpoint="host:8080")
        if k.startswith(prefix) and k.endswith("}"):
            total += v
            hit = True
    return total if hit else None


class HealthMonitor(Logger):
    """Per-process health plane: ring + readiness cache + SLO engine.

    One daemon sampler thread does ALL the work each tick (sample the
    registry, run the checks, evaluate the objectives, rebuild the
    probe cache); HTTP probe handlers only read
    :attr:`_probe_cache` — a dict replaced wholesale per tick, so the
    read is one attribute load and probes answer in microseconds even
    while a training step holds the master lock."""

    def __init__(self, interval=DEFAULT_INTERVAL,
                 max_samples=DEFAULT_MAX_SAMPLES,
                 prefixes=DEFAULT_PREFIXES):
        self.name = "health"
        self.interval = float(interval)
        self.prefixes = tuple(prefixes)
        self._lock = threading.Lock()
        #: serializes whole ticks (the sampler thread vs. the
        #: synchronous ticks add_check/add_slo trigger)
        self._tick_lock = threading.Lock()
        self._samples = collections.deque(maxlen=int(max_samples))
        self._checks = {}
        self._series_fns = {}
        self._slos = []
        self._slo_names = set()
        self._thread = None
        self._stop = threading.Event()
        self._closed = False
        self._shutting_down = False
        self._started_wall = time.time()
        # SLO gauge families (hoisted: children are resolved per
        # objective per tick, the families exactly once per registry)
        self._g_burn = telemetry.LazyChild(lambda: telemetry.gauge(
            "veles_slo_burn_rate",
            "SLO error-budget burn rate per objective and window "
            "(1.0 = burning exactly the budget)",
            ("objective", "window")))
        self._g_ratio = telemetry.LazyChild(lambda: telemetry.gauge(
            "veles_slo_error_ratio",
            "SLO error ratio over the fast window", ("objective",)))
        self._g_firing = telemetry.LazyChild(lambda: telemetry.gauge(
            "veles_slo_alert_firing",
            "1 while the objective's multi-window burn-rate alert "
            "fires", ("objective",)))
        self._probe_cache = {}
        self.tick()

    # -- lifecycle -----------------------------------------------------

    def ensure_started(self):
        """Start the sampler thread (idempotent; no-op once closed)."""
        if self._closed:
            return self
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="health-monitor")
                self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as exc:   # the plane must outlive a bad
                self.warning("health tick failed: %s: %s",
                             type(exc).__name__, exc)

    def mark_shutdown(self):
        """Flip liveness to 503 (draining/stopping process)."""
        self._shutting_down = True
        self.tick()

    def close(self):
        self._closed = True
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)

    # -- registration --------------------------------------------------

    def add_check(self, name, fn, tick=True):
        """Register readiness check ``fn() -> (ok, reason|None)`` (a
        bare bool is accepted). Evaluated on the SAMPLER thread each
        tick — it may take locks or scan state; probe handlers only
        ever read the cached verdict. ``tick=False`` defers the
        synchronous re-evaluation (batch registration: pass it for
        all but the last check)."""
        with self._lock:
            self._checks[str(name)] = fn
        if tick:
            self.tick()

    def remove_check(self, name, tick=True):
        with self._lock:
            self._checks.pop(str(name), None)
        if tick:
            self.tick()

    def add_series(self, key, fn):
        """Register a custom ring series: ``fn() -> float`` sampled
        each tick under key ``key`` (for derived quantities no gauge
        exports)."""
        with self._lock:
            self._series_fns[str(key)] = fn

    def add_slo(self, spec):
        """Register one objective (dict spec — module docstring)."""
        slo = SLObjective(spec)
        with self._lock:
            if slo.name in self._slo_names:
                raise ValueError("duplicate SLO %r" % slo.name)
            self._slo_names.add(slo.name)
            self._slos.append(slo)
        self.tick()
        return slo

    def load_slo_file(self, path):
        """Load a JSON list of objective specs; -> count added."""
        with open(path) as f:
            specs = json.load(f)
        if not isinstance(specs, list):
            raise ValueError("%s: SLO config must be a JSON list"
                             % path)
        for spec in specs:
            self.add_slo(spec)
        return len(specs)

    def slos(self):
        with self._lock:
            return list(self._slos)

    # -- the tick ------------------------------------------------------

    def tick(self, now=None):
        """One full evaluation: sample -> checks -> SLOs -> rebuild
        the probe cache. Runs on the sampler thread each interval and
        synchronously from add_check/add_slo (so registration is
        immediately visible to probes); ``now`` is injectable for
        deterministic tests."""
        with self._tick_lock:
            now = time.time() if now is None else float(now)
            flat = self._sample()
            with self._lock:
                self._samples.append((now, flat))
                samples = list(self._samples)
                checks = sorted(self._checks.items())
                slos = list(self._slos)
            checks_doc, reasons = self._run_checks(checks)
            slo_doc, slo_reasons = self._evaluate_slos(
                slos, samples, now)
            reasons.extend(slo_reasons)
            ready = not reasons and not self._shutting_down
            if self._shutting_down:
                reasons.insert(0, "shutting down")
            live_doc = {"status": "stopping" if self._shutting_down
                        else "ok",
                        "uptime_s": round(now - self._started_wall, 3)}
            ready_doc = {"ready": ready, "reasons": reasons,
                         "checks": checks_doc, "slos": slo_doc}
            with self._lock:
                self._probe_cache = {
                    "/healthz": (503 if self._shutting_down else 200,
                                 live_doc),
                    "/readyz": (200 if ready else 503, ready_doc),
                }
        return ready

    def _sample(self):
        """One flat ``{series_key: value}`` snapshot of the selected
        registry families (+ custom series fns)."""
        # memory accounting rides the tick: the set_function gauges are
        # (re-)registered against the ACTIVE registry, so registry swaps
        # (test isolation) re-acquire them, and the device kinds show up
        # once CUDA is initialized
        try:
            from veles_torch import profiling
            profiling.register_memory_gauges()
        except Exception as exc:
            self.warning("memory gauges unavailable: %s: %s",
                         type(exc).__name__, exc)
        flat = {}
        prefixes = self.prefixes
        for fam in telemetry.get_registry().families():
            if not fam.name.startswith(prefixes):
                continue
            for items, child in fam.children():
                key = fam.name + telemetry._fmt_labels(items)
                if fam.kind == "histogram":
                    p50 = child.percentile(0.5)
                    if p50 is not None:
                        flat[key + ":p50"] = float(p50)
                        flat[key + ":p99"] = float(
                            child.percentile(0.99))
                    flat[key + ":count"] = float(child.count)
                else:
                    v = float(child.value)
                    if v == v:          # skip NaN (broken gauge fns)
                        flat[key] = v
        with self._lock:
            fns = list(self._series_fns.items())
        for key, fn in fns:
            try:
                v = float(fn())
            except Exception:
                continue
            if v == v:
                flat[key] = v
        return flat

    @staticmethod
    def _run_checks(checks):
        doc, reasons = {}, []
        for name, fn in checks:
            try:
                result = fn()
            except Exception as exc:
                result = (False, "check raised %s: %s"
                          % (type(exc).__name__, exc))
            if isinstance(result, tuple):
                ok, reason = result
            else:
                ok, reason = bool(result), None
            doc[name] = {"ok": bool(ok)}
            if reason:
                doc[name]["reason"] = str(reason)
            if not ok:
                reasons.append("%s: %s" % (name, reason or "not ready"))
        return doc, reasons

    # -- SLO evaluation ------------------------------------------------

    def _evaluate_slos(self, slos, samples, now):
        doc, reasons = {}, []
        burn_g = self._g_burn.get()
        ratio_g = self._g_ratio.get()
        firing_g = self._g_firing.get()
        for slo in slos:
            fast = self._error_ratio(slo, samples, now,
                                     slo.fast_window)
            slow = self._error_ratio(slo, samples, now,
                                     slo.slow_window)
            budget = 1.0 - slo.target
            slo.error_ratio = fast
            slo.burn_fast = fast / budget
            slo.burn_slow = slow / budget
            should_fire = slo.burn_fast >= slo.burn_threshold \
                and slo.burn_slow >= slo.burn_threshold
            if should_fire and not slo.firing:
                slo.firing = True
                slo.fired_at = now
                telemetry.record_event(
                    "slo_alert", objective=slo.name, state="firing",
                    burn_fast=round(slo.burn_fast, 3),
                    burn_slow=round(slo.burn_slow, 3),
                    error_ratio=round(fast, 6))
                self.warning(
                    "SLO %s alert FIRING (burn fast=%.2f slow=%.2f, "
                    "error ratio %.4f)", slo.name, slo.burn_fast,
                    slo.burn_slow, fast)
            elif slo.firing and not should_fire:
                slo.firing = False
                telemetry.record_event(
                    "slo_alert", objective=slo.name, state="resolved",
                    burn_fast=round(slo.burn_fast, 3),
                    burn_slow=round(slo.burn_slow, 3))
                self.info("SLO %s alert resolved", slo.name)
            burn_g.labels(slo.name, "fast").set(slo.burn_fast)
            burn_g.labels(slo.name, "slow").set(slo.burn_slow)
            ratio_g.labels(slo.name).set(fast)
            firing_g.labels(slo.name).set(1.0 if slo.firing else 0.0)
            doc[slo.name] = slo.describe()
            if slo.firing:
                reasons.append(
                    "slo:%s firing (burn fast=%.2f slow=%.2f)"
                    % (slo.name, slo.burn_fast, slo.burn_slow))
        return doc, reasons

    def _error_ratio(self, slo, samples, now, window):
        kept = [flat for wall, flat in samples
                if wall >= now - window]
        if slo.kind == "threshold":
            vals = []
            for flat in kept:
                v = _series_value(flat, slo.series)
                if v is not None:
                    vals.append(v)
            if not vals:
                return 0.0              # no data is not an outage
            bad = sum(1 for v in vals
                      if not slo.op(v, slo.threshold))
            return bad / len(vals)
        # ratio kind: counter deltas across the window
        pts = []
        for flat in kept:
            b = _series_value(flat, slo.bad)
            t = _series_value(flat, slo.total)
            if b is not None or t is not None:
                pts.append((b or 0.0, t or 0.0))
        if len(pts) < 2:
            return 0.0
        dbad = max(pts[-1][0] - pts[0][0], 0.0)
        dtot = max(pts[-1][1] - pts[0][1], 0.0)
        denom = max(dtot, dbad)
        return dbad / denom if denom > 0 else 0.0

    # -- reads ---------------------------------------------------------

    def probe(self, path):
        """Cached (code, doc) for ``/healthz`` / ``/readyz`` — ONE
        attribute read, no locks, never blocks."""
        cache = self._probe_cache
        return cache.get(path, (404, {"error": "not found"}))

    def ready_state(self):
        """(ready, reasons) from the cached readiness verdict — the
        cheap gate hot request paths consult before doing work."""
        code, doc = self.probe("/readyz")
        return code == 200, list(doc.get("reasons", ()))

    @property
    def max_window(self):
        return self.interval * (self._samples.maxlen or 0)

    def history_doc(self, window=None):
        """The ring as ``{series: [[wall, value], ...]}`` within
        ``window`` seconds (default: everything retained) — what
        ``GET /metrics/history`` serves."""
        now = time.time()
        window = self.max_window if window is None \
            else max(float(window), 0.0)
        with self._lock:
            kept = [(w, f) for w, f in self._samples
                    if w >= now - window]
        series = {}
        for wall, flat in kept:
            t = round(wall, 3)
            for key, value in flat.items():
                series.setdefault(key, []).append([t, value])
        return {"interval_s": self.interval,
                "window_s": round(window, 3),
                "samples": len(kept), "now": round(now, 3),
                "series": series}


# -- active-monitor plumbing -------------------------------------------

_active_lock = threading.Lock()
_active = None


def get_monitor() -> HealthMonitor:
    """The process's active monitor, created (and its sampler thread
    started) on first use."""
    global _active
    with _active_lock:
        if _active is None:
            _active = HealthMonitor()
        monitor = _active
    return monitor.ensure_started()


def set_monitor(monitor):
    """Swap the active monitor (-> the previous one, NOT closed)."""
    global _active
    with _active_lock:
        previous = _active
        _active = monitor
    return previous


@contextmanager
def scoped(monitor=None):
    """``with scoped():`` — run under a fresh (or given) monitor,
    restoring and closing on exit (the per-test isolation hook)."""
    monitor = monitor if monitor is not None else HealthMonitor()
    previous = set_monitor(monitor)
    try:
        yield monitor
    finally:
        set_monitor(previous)
        monitor.close()


def health_endpoint(path):
    """Route a health HTTP path to ``(code, payload_dict)`` — always
    a reply, (404, ...) for anything that is not a health surface
    (handlers route by prefix and just serve what this returns).
    Shared by web-status and the serving frontend so both speak the
    same probe protocol:

    * ``/healthz``                    — liveness (cached, non-blocking)
    * ``/readyz``                     — readiness + reasons (cached)
    * ``/metrics/history[?window=S]`` — the time-series ring
    """
    parsed = urlparse(path)
    if parsed.path in ("/healthz", "/readyz"):
        return get_monitor().probe(parsed.path)
    if parsed.path == "/metrics/history":
        query = parse_qs(parsed.query)
        try:
            window = float(query["window"][0])
        except (KeyError, IndexError, ValueError):
            window = None
        return 200, get_monitor().history_doc(window)
    # handlers route by prefix, so a pathological "/healthzfoo" still
    # lands here — answer 404 instead of making the caller unpack None
    return 404, {"error": "not found"}
