"""Telemetry core of the PyTorch port: metrics registry + span tracer.

The port's own copy of ``veles/telemetry.py`` (it imports nothing of the
JAX package), so the port's HTTP planes export the reference's series
under the reference's names and a Prometheus scrape, a router or an
autoscaler reads a port replica as it reads a reference one.

Registry: one process-wide registry (:func:`get_registry`; tests swap in
a fresh one with :func:`scoped`) of **Counter / Gauge / Histogram**
families created idempotently by name (:func:`counter`, :func:`gauge`,
:func:`histogram`); a family with declared ``labels`` hands out
per-label children through ``.labels(...)``; hot paths hold a
:class:`LazyChild`, which re-resolves its child only when the active
registry changes. Histograms keep Prometheus cumulative buckets and a
bounded reservoir of raw observations for percentile queries.
:meth:`Registry.render_prometheus` writes the text exposition
(:attr:`Registry.CONTENT_TYPE`).

Tracing: :class:`TraceContext` is a W3C ``traceparent`` identity
(``from_traceparent`` / ``to_traceparent``). The :class:`Tracer` records
complete spans (``add_complete``, :func:`span`) into two surfaces: the
full-run buffer (``start``/``stop``/``dump``: ``--trace-out``, Chrome
trace / Perfetto JSON) and the always-on flight ring (``flight_doc``,
``GET /debug/trace``), plus a short log of structured operational events
(:func:`record_event`, ``GET /debug/events``). :func:`debug_endpoint`
routes both, and ``/debug/critical_path`` (``profiling.py``), for web
status and the serving frontend.
"""

import bisect
import collections
import json
import os
import secrets
import threading
import time
from contextlib import contextmanager

#: default histogram buckets (seconds) — spans sub-ms unit runs up to
#: multi-second dispatches
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: raw observations kept per histogram child for percentile queries
#: (same window the serving batcher kept before the registry existed)
RESERVOIR_SIZE = 2048


# -- instruments -------------------------------------------------------


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters only go up (inc %r)" % (n,))
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class _GaugeChild:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = None

    def set(self, v):
        with self._lock:
            self._fn = None
            self._value = float(v)

    def set_function(self, fn):
        """Evaluate ``fn()`` at read/scrape time instead of storing a
        value — for gauges that are an AGE or other now-relative
        quantity (e.g. seconds since the last checkpoint), which a
        stored value would freeze at whatever it was when set."""
        with self._lock:
            self._fn = fn

    def inc(self, n=1):
        with self._lock:
            self._fn = None
            self._value += n

    def dec(self, n=1):
        self.inc(-n)

    @property
    def value(self):
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        return self._value


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count",
                 "_reservoir")

    def __init__(self, buckets):
        self._lock = threading.Lock()
        self.buckets = buckets
        self._counts = [0] * (len(buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        # sliding window over the NEWEST observations; deque(maxlen)
        # evicts in O(1) on the hot path
        self._reservoir = collections.deque(maxlen=RESERVOIR_SIZE)

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._sum += v
            self._count += 1
            self._reservoir.append(v)

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, q):
        """Value at quantile ``q`` of the reservoir window, using the
        EXACT index convention the serving metrics always used
        (``sorted[min(n-1, int(n*q))]``) so the JSON view over the
        registry is bit-identical to the pre-registry dicts. None when
        nothing has been observed."""
        with self._lock:
            lat = sorted(self._reservoir)
        if not lat:
            return None
        return lat[min(len(lat) - 1, int(len(lat) * q))]

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count), ...] ending at +Inf."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for ub, c in zip(self.buckets, counts):
            acc += c
            out.append((ub, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out


class _Family:
    """One named instrument: metadata + the per-label-value children.

    ``labelnames`` is the declared label schema for the ``.labels()``
    convenience; internally children are keyed by sorted label-item
    tuples, and :meth:`Registry.absorb_counters` may add children with
    EXTRA labels (the master's per-slave aggregation) — legal in the
    exposition format, merely unidiomatic for a client library."""

    def __init__(self, name, kind, help, labelnames, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children = {}

    def _make_child(self):
        if self.kind == "counter":
            return _CounterChild()
        if self.kind == "gauge":
            return _GaugeChild()
        return _HistogramChild(self.buckets)

    def child(self, items=()):
        items = tuple(sorted(items))
        with self._lock:
            c = self._children.get(items)
            if c is None:
                c = self._children[items] = self._make_child()
            return c

    def labels(self, *values, **kv):
        if values and kv:
            raise ValueError("pass label values either positionally "
                             "or by name, not both")
        if kv:
            if set(kv) != set(self.labelnames):
                raise ValueError(
                    "%s expects labels %r, got %r"
                    % (self.name, self.labelnames, tuple(kv)))
            items = tuple((k, str(v)) for k, v in kv.items())
        else:
            if len(values) != len(self.labelnames):
                raise ValueError(
                    "%s expects %d label value(s) %r, got %d"
                    % (self.name, len(self.labelnames),
                       self.labelnames, len(values)))
            items = tuple(zip(self.labelnames,
                              (str(v) for v in values)))
        return self.child(items)

    def children(self):
        with self._lock:
            return sorted(self._children.items())

    def remove_children(self, match_items):
        """Drop every child whose label items contain all of
        ``match_items`` (e.g. ``(("slave", "3"),)`` evicts a departed
        slave's absorbed series); -> how many were removed. The series
        disappears from exposition and ring sampling — the right
        answer for per-peer gauges whose last value would otherwise
        read as current forever."""
        want = set(match_items)
        with self._lock:
            stale = [k for k in self._children if want <= set(k)]
            for k in stale:
                del self._children[k]
        return len(stale)

    # label-less families act as their own child ----------------------

    def _default(self):
        if self.labelnames:
            raise ValueError(
                "%s has labels %r — use .labels(...)"
                % (self.name, self.labelnames))
        return self.child(())

    def inc(self, n=1):
        self._default().inc(n)

    def set(self, v):
        self._default().set(v)

    def set_function(self, fn):
        self._default().set_function(fn)

    def dec(self, n=1):
        self._default().dec(n)

    def observe(self, v):
        self._default().observe(v)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    def percentile(self, q):
        return self._default().percentile(q)


def _escape_label(value):
    return value.replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(items, extra=()):
    pairs = list(items) + list(extra)
    if not pairs:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, _escape_label(str(v))) for k, v in pairs)


def _fmt_value(v):
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Registry:
    """Thread-safe family container + Prometheus renderer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}

    def _family(self, name, kind, help, labels, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    name, kind, help, labels, buckets=buckets)
            elif fam.kind != kind:
                raise ValueError(
                    "instrument %r already registered as %s, not %s"
                    % (name, fam.kind, kind))
            else:
                # adopt a label schema (and help) the first declared
                # use provides: absorb_counters may have registered
                # the family schema-less before the local instrumented
                # path declared it, and .labels() must keep working
                if not fam.labelnames and labels:
                    fam.labelnames = tuple(labels)
                if not fam.help and help:
                    fam.help = help
            return fam

    def counter(self, name, help="", labels=()):
        return self._family(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()):
        return self._family(name, "gauge", help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS):
        return self._family(name, "histogram", help, labels,
                            buckets=tuple(buckets))

    def families(self):
        with self._lock:
            return [self._families[k]
                    for k in sorted(self._families)]

    # -- queries -------------------------------------------------------

    def counter_total(self, name, **match):
        """Sum of a counter family's children whose labels contain
        every ``match`` item; 0.0 when the family does not exist (a
        scrape-side convenience, e.g. bench rows)."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None:
            return 0.0
        want = {(k, str(v)) for k, v in match.items()}
        total = 0.0
        for items, child in fam.children():
            if want <= set(items):
                total += child.value
        return total

    def counter_state(self, exclude_prefixes=(),
                      exclude_label_keys=()):
        """{(name, label_items): value} for every counter child —
        the wire-shippable absolute state a slave diffs against its
        last push (see ``SlaveClient``). ``exclude_label_keys`` skips
        children carrying those labels: a co-located master+slave pair
        shares one registry, and already-absorbed ``slave="N"`` series
        must never be pushed back (they would re-absorb forever)."""
        out = {}
        skip = set(exclude_label_keys)
        for fam in self.families():
            if fam.kind != "counter":
                continue
            if any(fam.name.startswith(p) for p in exclude_prefixes):
                continue
            for items, child in fam.children():
                if skip and any(k in skip for k, _ in items):
                    continue
                out[(fam.name, items)] = child.value
        return out

    def absorb_counters(self, deltas, extra_labels=()):
        """Merge counter deltas pushed by a peer (the master
        aggregating slave counters carried on update messages). Each
        child lands under its original name + labels with
        ``extra_labels`` appended (e.g. ``("slave", "3")``), so one
        scrape shows the whole cluster without colliding with this
        process's own series."""
        extra = tuple(extra_labels)
        for (name, items), v in deltas.items():
            if v <= 0:
                continue
            fam = self.counter(name)
            fam.child(tuple(items) + extra).inc(v)

    # -- exposition ----------------------------------------------------

    def render_prometheus(self):
        """The registry in Prometheus text exposition format 0.0.4."""
        lines = []
        for fam in self.families():
            # HELP escaping per the 0.0.4 format: backslash and
            # newline (label VALUES additionally escape the double
            # quote — see _escape_label)
            lines.append("# HELP %s %s"
                         % (fam.name,
                            (fam.help or fam.name)
                            .replace("\\", "\\\\").replace("\n", "\\n")))
            lines.append("# TYPE %s %s" % (fam.name, fam.kind))
            for items, child in fam.children():
                if fam.kind in ("counter", "gauge"):
                    lines.append("%s%s %s" % (
                        fam.name, _fmt_labels(items),
                        _fmt_value(child.value)))
                    continue
                for ub, acc in child.cumulative_buckets():
                    lines.append("%s_bucket%s %d" % (
                        fam.name,
                        _fmt_labels(items, (("le", _fmt_value(ub)),)),
                        acc))
                lines.append("%s_sum%s %s" % (
                    fam.name, _fmt_labels(items),
                    repr(float(child.sum))))
                lines.append("%s_count%s %d" % (
                    fam.name, _fmt_labels(items), child.count))
        return "\n".join(lines) + "\n"

    #: content type a /metrics endpoint should reply with
    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- active-registry plumbing ------------------------------------------

_swap_lock = threading.Lock()
_active = Registry()
_generation = 0


def get_registry() -> Registry:
    return _active


def set_registry(registry: Registry) -> Registry:
    """Swap the active registry (-> the previous one). Bumps the
    generation so every :class:`LazyChild` re-resolves."""
    global _active, _generation
    with _swap_lock:
        previous = _active
        _active = registry
        _generation += 1
    return previous


def generation() -> int:
    return _generation


@contextmanager
def scoped(registry: Registry = None):
    """``with scoped():`` — run under a fresh (or given) registry,
    restoring the previous one on exit. The per-test isolation hook
    (autouse fixture in ``tests/conftest.py``)."""
    registry = registry if registry is not None else Registry()
    previous = set_registry(registry)
    try:
        yield registry
    finally:
        set_registry(previous)


def counter(name, help="", labels=()):
    return _active.counter(name, help=help, labels=labels)


def gauge(name, help="", labels=()):
    return _active.gauge(name, help=help, labels=labels)


def histogram(name, help="", labels=(), buckets=DEFAULT_BUCKETS):
    return _active.histogram(name, help=help, labels=labels,
                             buckets=buckets)


class LazyChild:
    """A call-site instrument handle for hot paths: ``factory`` is
    invoked on first use and again only when the active registry has
    been swapped (test isolation), so the steady-state cost of
    ``handle.get().observe(dt)`` is one int compare + the child op."""

    __slots__ = ("_factory", "_gen", "_child")

    def __init__(self, factory):
        self._factory = factory
        self._gen = -1
        self._child = None

    def get(self):
        g = _generation
        if g != self._gen:
            self._child = self._factory()
            self._gen = g
        return self._child


# -- trace context -----------------------------------------------------


class TraceContext:
    """W3C-traceparent-style identity of one causal chain.

    ``trace_id`` (32 hex chars) names the whole request/minibatch
    job; ``span_id`` (16 hex chars) names one hop; ``parent_id`` is
    the span this one descends from. Contexts ride the master↔slave
    pickle frames (:meth:`to_wire`) and HTTP ``traceparent`` headers
    (:meth:`to_traceparent`); spans tagged with :meth:`span_args`
    can be stitched back into one cross-process timeline."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new(cls):
        return cls(secrets.token_hex(16), secrets.token_hex(8))

    def child(self):
        """A new span in the SAME trace, parented on this one."""
        return TraceContext(self.trace_id, secrets.token_hex(8),
                            self.span_id)

    # -- serialization -------------------------------------------------

    def to_wire(self):
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_wire(cls, doc):
        """Rebuild from a frame payload; None on anything malformed —
        a peer speaking an older protocol must not kill the run."""
        if not isinstance(doc, dict):
            return None
        trace_id, span_id = doc.get("trace_id"), doc.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        return cls(trace_id, span_id, doc.get("parent_id"))

    def to_traceparent(self):
        return "00-%s-%s-01" % (self.trace_id, self.span_id)

    @classmethod
    def from_traceparent(cls, header):
        """Parse a ``traceparent`` header; None when malformed."""
        if not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        _, trace_id, span_id, _ = parts
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        return cls(trace_id, span_id)

    def span_args(self):
        """The ids as span ``args`` (what links events in the dump)."""
        out = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            out["parent_id"] = self.parent_id
        return out


#: thread-local holder of the ACTIVE trace context: the one the code
#: currently executing on this thread works on behalf of. Set with
#: :func:`context`; read by anything that wants to correlate its
#: output with the distributed trace — most importantly the JSONL log
#: handler (``veles/logger.py``), which stamps every structured log
#: line with the active ``trace_id``/``span_id`` so ``/debug/trace``
#: spans and log lines join on one key.
_context_tls = threading.local()


def current_context():
    """The :class:`TraceContext` bound to THIS thread (via
    :func:`context`), or None when the thread is not working on
    behalf of any traced request/job."""
    return getattr(_context_tls, "ctx", None)


@contextmanager
def context(ctx):
    """``with telemetry.context(trace):`` — bind ``ctx`` as the
    thread's active trace context for the duration of the block
    (restoring whatever was active before, so nesting works). Log
    lines emitted inside the block carry the ids (JSONL sink);
    ``ctx`` may be None, which reads as "no active trace"."""
    prev = getattr(_context_tls, "ctx", None)
    _context_tls.ctx = ctx
    try:
        yield ctx
    finally:
        _context_tls.ctx = prev


# -- span tracer -------------------------------------------------------


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_start")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.add_complete(
            self._name, self._start,
            time.perf_counter() - self._start, **self._args)
        return False


def _jsonable(v):
    return v if isinstance(v, (int, float, str, bool, type(None))) \
        else str(v)


class Tracer:
    """Wall-time span recorder dumping Chrome-trace JSON.

    Two recording surfaces share one ``add_complete`` entry point:

    * the **full-run buffer** (``enabled``, off by default) — every
      span since :meth:`start`, dumped by ``--trace-out``;
    * the **flight recorder** (``flight``, ON by default) — a bounded
      ring of the newest spans, readable any time via
      :meth:`flight_doc` (``GET /debug/trace``). Always-on postmortem
      coverage for a live cluster at the cost of one dict build +
      ring append per span.

    Callers guard hot paths with ``if tracer.active`` (one attribute
    read); ``span()`` returns a shared no-op context manager when
    neither surface records."""

    #: full-run event-buffer cap (~200MB of dicts; multi-GB traces
    #: don't load in chrome://tracing anyway). Oldest events are
    #: dropped first — for a crash postmortem the tail is what
    #: matters — and the drop count lands in the dump's otherData AND
    #: the veles_trace_dropped_events_total counter, so a scrape can
    #: see that a trace window is incomplete.
    max_events = 1_000_000
    #: flight-recorder ring cap (newest spans win)
    flight_max_events = 16384
    #: default time window flight_doc() serves
    flight_window = 300.0
    #: structured operational events retained (record_event)
    max_log_events = 1024

    def __init__(self):
        self.enabled = False
        #: continuous bounded-ring recording (the flight recorder);
        #: on by default — this is what makes /debug/trace useful on
        #: a cluster that was never started with tracing
        self.flight = True
        self._lock = threading.Lock()
        self._events = collections.deque()
        self._ring = collections.deque(maxlen=self.flight_max_events)
        self._log = collections.deque(maxlen=self.max_log_events)
        self._dropped = 0
        # ring WRAP is normal operation (bounded window by design),
        # so it is counted separately from full-buffer drops and
        # reported as coverage honesty in flight_doc, not as the
        # scraped incomplete-trace counter
        self._ring_evicted = 0
        # one (perf_counter, wall) anchor pair: every event's ts is
        # perf-based (monotonic), and wall = _wall0 + (perf - _t0)
        # is what lets spans from DIFFERENT processes merge onto one
        # timeline (NTP-level skew applies)
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._proc_names = {}
        self._drop_counter = LazyChild(lambda: counter(
            "veles_trace_dropped_events_total",
            "Span events dropped from the tracer's bounded buffers "
            "(a growing count means trace windows are incomplete)"))

    @property
    def active(self):
        """True when add_complete records ANYTHING (full buffer or
        flight ring) — the one cheap guard for instrumentation sites
        that do extra work to build a span."""
        return self.enabled or self.flight

    def start(self):
        with self._lock:
            self._events = collections.deque()
            self._dropped = 0
            self._t0 = time.perf_counter()
            self._wall0 = time.time()
            self.enabled = True

    def stop(self):
        self.enabled = False

    def clear(self):
        with self._lock:
            self._events = collections.deque()
            self._ring.clear()
            self._log.clear()
            self._proc_names.clear()
            self._dropped = 0
            self._ring_evicted = 0

    def set_process_name(self, name, pid=None):
        """Name a pid's track in the dumps (Chrome ``process_name``
        metadata). Used for "master" / "slave:N" / "serving" so the
        merged cluster timeline reads as processes, not pids."""
        with self._lock:
            self._proc_names[int(pid if pid is not None
                                 else os.getpid())] = str(name)

    def span(self, name, **args):
        if not (self.enabled or self.flight):
            return _NULL_SPAN
        return _Span(self, name, args)

    def add_complete(self, name, start, duration, **args):
        """Record one complete ('ph: X') event; ``start`` is a
        ``time.perf_counter()`` reading, ``duration`` seconds."""
        if not (self.enabled or self.flight):
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": (start - self._t0) * 1e6,       # Chrome wants µs
            "dur": duration * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._record(ev, self._wall0 + (start - self._t0))

    def _record(self, ev, wall):
        dropped = False
        with self._lock:
            if self.enabled:
                if len(self._events) >= self.max_events:
                    self._events.popleft()
                    self._dropped += 1
                    dropped = True
                self._events.append(ev)
            if self.flight:
                if len(self._ring) == self._ring.maxlen:
                    self._ring_evicted += 1
                self._ring.append((wall, ev))
        if dropped:
            # outside the tracer lock: the counter has its own
            self._drop_counter.get().inc()

    def absorb_remote(self, spans, process_name=None):
        """Merge completed spans a peer process shipped over the wire
        (the master absorbing slave spans off update frames). Each
        span dict carries an absolute ``wall`` start (``time.time``
        seconds), ``dur`` seconds, ``name``, ``pid``/``tid`` and
        optional ``args`` (incl. trace-context ids); wall-clock
        anchoring is what lets one merged timeline span processes.
        Malformed entries are skipped — a bad peer must not kill the
        absorbing side."""
        if not (self.enabled or self.flight):
            return 0
        absorbed = 0
        named = set()
        for s in spans:
            try:
                wall = float(s["wall"])
                ev = {"name": str(s["name"]), "ph": "X",
                      "ts": (wall - self._wall0) * 1e6,
                      "dur": float(s["dur"]) * 1e6,
                      "pid": int(s.get("pid", 0)),
                      "tid": int(s.get("tid", 0)) & 0x7FFFFFFF}
            except (KeyError, TypeError, ValueError):
                continue
            args = s.get("args")
            if isinstance(args, dict) and args:
                ev["args"] = {str(k): _jsonable(v)
                              for k, v in args.items()}
            if process_name and ev["pid"] not in named:
                # once per distinct pid, not per span: the name is
                # constant and this runs on the master's update path
                named.add(ev["pid"])
                self.set_process_name(process_name, pid=ev["pid"])
            self._record(ev, wall)
            absorbed += 1
        return absorbed

    # -- structured events (the /debug/events log) ----------------------

    def record_event(self, event, **fields):
        """Append one structured operational event (job fenced, lease
        revoked, checkpoint written, reconnect, ...) to the bounded
        postmortem log. Always on: these are rare by construction.
        ``fields`` may use any names except ``wall``/``event``."""
        ev = {"wall": time.time(), "event": str(event)}
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        with self._lock:
            self._log.append(ev)

    def recent_events(self, limit=None):
        """Newest-last structured events (``GET /debug/events``).
        ``limit`` is clamped defensively: it arrives straight from a
        query string, so 0/negative means none and inf/nan means
        unlimited rather than an exception in the HTTP handler."""
        with self._lock:
            out = list(self._log)
        if limit is None:
            return out
        try:
            n = int(limit)
        except (ValueError, OverflowError):
            return out
        return out[-n:] if n > 0 else []

    # -- reads -----------------------------------------------------------

    def events(self):
        with self._lock:
            return list(self._events)

    def _metadata_events(self):
        # caller holds no lock requirement: _proc_names is snapshotted
        with self._lock:
            names = dict(self._proc_names)
        return [{"name": "process_name", "ph": "M", "pid": pid,
                 "args": {"name": name}}
                for pid, name in sorted(names.items())]

    def flight_spans(self, window=None):
        """The raw flight-recorder window as ``(wall, event)`` pairs
        (newest-last, event dicts copied) — the feed the critical-path
        analyzer (``veles/profiling.py``) consumes. ``window`` in
        seconds, default :attr:`flight_window`."""
        now = time.time()
        window = self.flight_window if window is None \
            else max(float(window), 0.0)
        cutoff = now - window
        with self._lock:
            return [(w, dict(ev)) for w, ev in self._ring
                    if w >= cutoff]

    def flight_doc(self, window=None):
        """Perfetto/Chrome-trace JSON document of the flight-recorder
        window: the newest spans within ``window`` seconds (default
        :attr:`flight_window`), timestamps re-based to the window
        start. This is what ``GET /debug/trace`` serves — a live,
        bounded postmortem view with zero restart required."""
        now = time.time()
        window = self.flight_window if window is None \
            else max(float(window), 0.0)
        cutoff = now - window
        with self._lock:
            kept = [(w, ev) for w, ev in self._ring if w >= cutoff]
            evicted = self._ring_evicted
        base = min(w for w, _ in kept) if kept else now
        events = []
        for w, ev in kept:
            ev = dict(ev)
            ev["ts"] = (w - base) * 1e6
            events.append(ev)
        return {
            "traceEvents": self._metadata_events() + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "window_s": "%g" % window,
                # coverage honesty: under span pressure the bounded
                # ring holds LESS than the requested window — readers
                # compare covered_s against window_s and see
                # ring_evicted grow instead of trusting a silently
                # truncated view
                "covered_s": "%g" % round(now - base, 3),
                "ring_evicted": str(evicted),
                "base_unix_s": repr(base),
                "spans": str(len(events)),
                "dropped_events": str(self._dropped),
            },
        }

    def dump(self, path):
        """Write the recorded events as Chrome-trace JSON (loadable by
        chrome://tracing and Perfetto); -> ``path``."""
        doc = {"traceEvents": self._metadata_events() + self.events(),
               "displayTimeUnit": "ms"}
        if self._dropped:
            doc["otherData"] = {"dropped_events": str(self._dropped)}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


tracer = Tracer()


def span(name, **args):
    """``with telemetry.span("conv.forward", unit=u):`` — module-level
    convenience over the process tracer."""
    return tracer.span(name, **args)


def record_event(event, **fields):
    """Module-level convenience over :meth:`Tracer.record_event`."""
    tracer.record_event(event, **fields)


def debug_endpoint(path):
    """Route a ``/debug/*`` HTTP path to its payload dict, or None
    when the path is not a debug surface. Shared by ``web_status.py``
    and the serving frontend so both speak the same debug protocol
    (and ``python -m veles_torch debug`` works against either):

    * ``/debug/trace[?window=SECS]`` — Perfetto JSON of the flight-
      recorder window;
    * ``/debug/events[?limit=N]``    — recent structured events;
    * ``/debug/critical_path[?window=SECS]`` — the flight-recorder
      window aggregated into the per-leg "where the step time goes"
      document (``profiling.py``).

    ``/debug/profile`` is deliberately NOT here: its capture blocks for
    the requested window, so both frontends route it through
    ``request.defer`` to ``profiling.profile_endpoint`` instead of an
    inline reply.
    """
    from urllib.parse import parse_qs, urlparse
    parsed = urlparse(path)
    query = parse_qs(parsed.query)

    def _num(key):
        try:
            return float(query[key][0])
        except (KeyError, IndexError, ValueError):
            return None

    if parsed.path == "/debug/trace":
        return tracer.flight_doc(_num("window"))
    if parsed.path == "/debug/events":
        return {"events": tracer.recent_events(_num("limit"))}
    if parsed.path == "/debug/critical_path":
        from veles_torch import profiling
        return profiling.critical_path_doc(_num("window"))
    return None
