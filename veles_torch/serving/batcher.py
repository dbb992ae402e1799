"""Dynamic micro-batching with deadlines and backpressure (the port's).

Counterpart of ``veles/serving/batcher.py``. Concurrent requests (one or
a few rows each) coalesce into one forward per dispatch: the worker
drains whatever is queued, up to ``max_batch`` rows, waiting at most
``max_wait_ms`` from the arrival of the oldest request, so a lone
request still answers promptly while a burst fills the batch; the
engine pads the batch up to its power-of-two bucket. A request whose
rows have another sample shape than the batch's first starts its own
batch.

Overload policy, in order:

* **shedding** — :meth:`MicroBatcher.submit` raises :class:`QueueFull`
  once ``max_queue`` rows are pending;
* **deadlines** — each request carries an absolute deadline; one
  already expired when the worker takes it gets
  :class:`DeadlineExceeded` without a forward.

After each dispatched batch the model-health monitor sees its outputs
(``observe_serving``: entropy and top-1 margin, every 16th batch).

Weighted-fair queuing (``tenants.py``): one FIFO per tenant, dequeued by
least virtual finish tag (rows over the tenant's weight past the queue's
virtual time), so one tenant's burst interleaves with everyone else's
requests; with one tenant, or no tenant table, the order is first in
first out.

Instruments: the reference's ``veles_serving_*`` families on the port's
telemetry registry (``telemetry.py``), labelled by ``model`` (counters,
``veles_serving_latency_seconds``, ``veles_serving_queue_rows``), and the
``serving.queue`` / ``serving.execute`` spans of each dispatched batch in
the caller's trace. :meth:`MicroBatcher.metrics` is this batcher's own
JSON view (its own ``counts``, the latency histogram's percentiles).
"""

import collections
import logging
import math
import threading
import time

import numpy

from veles_torch import model_health, telemetry
from veles_torch.serving import tenants

log = logging.getLogger("veles_torch.serving")


class QueueFull(Exception):
    """Backpressure: the pending queue is at capacity — shed."""


class DeadlineExceeded(Exception):
    """The request expired before a batch slot reached it."""


def timeout_seconds(timeout_ms, default_s):
    """A client's ``timeout_ms`` -> seconds (``default_s`` for None).
    Raises ValueError for anything but a finite number >= 0: a NaN or
    infinite deadline would never expire and pin its queue slot."""
    if timeout_ms is None:
        return default_s
    try:
        t = float(timeout_ms)
    except (TypeError, ValueError):
        raise ValueError("timeout_ms must be a number, got %r"
                         % (timeout_ms,))
    if not math.isfinite(t) or t < 0:
        raise ValueError("timeout_ms must be finite and >= 0, got %r"
                         % (timeout_ms,))
    return t / 1000.0


class _Request:
    __slots__ = ("rows", "deadline", "t_enqueue", "t_perf", "event",
                 "result", "error", "trace", "tenant", "vft")

    def __init__(self, rows, deadline, trace=None, tenant=None):
        self.rows = rows
        self.deadline = deadline
        self.t_enqueue = time.monotonic()
        # the tracer's clock is perf_counter
        self.t_perf = time.perf_counter()
        self.event = threading.Event()
        self.result = None
        self.error = None
        #: the caller's telemetry.TraceContext
        self.trace = trace
        #: the resolved tenant: the weighted-fair queue's key
        self.tenant = tenant
        #: virtual finish tag: the dequeue order under fairness
        self.vft = 0.0


class MicroBatcher:
    """Coalesces concurrent :meth:`submit` calls into batched
    ``run_batch(rows) -> (outputs, bucket)`` dispatches (an
    ``InferenceEngine.predict``), on one worker thread."""

    #: (metrics key, registry counter suffix, help): the counters
    #: :meth:`metrics` reports, each also ``veles_serving_<suffix>_total``
    COUNTERS = (
        ("requests_total", "requests", "Requests submitted"),
        ("shed_total", "shed", "Requests shed on a full queue (503)"),
        ("expired_total", "expired",
         "Requests expired before dispatch (504)"),
        ("error_total", "errors", "Requests failed by batch errors"),
        ("batches_total", "batches", "Batches dispatched"),
        ("batched_requests_total", "batched_requests",
         "Requests served inside batches"),
        ("batched_rows_total", "batched_rows",
         "Rows dispatched (pre-padding)"),
        ("bucket_rows_total", "bucket_rows",
         "Rows incl. bucket padding"),
    )

    def __init__(self, run_batch, max_batch=64, max_queue=256,
                 max_wait_ms=2.0, default_timeout_ms=1000.0,
                 name="batcher", model=None):
        self.name = name
        #: the ``model`` label of this batcher's series (the registry
        #: entry's name)
        self.model = model or name
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.default_timeout = float(default_timeout_ms) / 1000.0
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._queues = {}              # tenant -> deque of _Request
        self._vtime = 0.0              # the queue's virtual time
        self._vfinish = {}             # tenant -> its last finish tag
        self._queued_rows = 0
        self._running = True
        self.counts = dict.fromkeys((key for key, _, _ in self.COUNTERS),
                                    0)
        self._c = {
            key: telemetry.LazyChild(
                lambda s=suffix, h=help: telemetry.counter(
                    "veles_serving_%s_total" % s, h,
                    ("model",)).labels(self.model))
            for key, suffix, help in self.COUNTERS}
        self._h_latency = telemetry.LazyChild(
            lambda: telemetry.histogram(
                "veles_serving_latency_seconds",
                "Request latency enqueue -> batch completion",
                ("model",)).labels(self.model))
        self._g_queue = telemetry.LazyChild(
            lambda: telemetry.gauge(
                "veles_serving_queue_rows",
                "Rows pending in the batcher queue",
                ("model",)).labels(self.model))
        self._completions = collections.deque(maxlen=4096)
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="%s-worker" % name)
        self._thread.start()

    def _count(self, key, n=1):
        """One counter: this batcher's view and the registry series.
        Lock held."""
        self.counts[key] += n
        self._c[key].get().inc(n)

    # -- client side ---------------------------------------------------

    def submit(self, rows, timeout_ms=None, trace=None, tenant=None):
        """Enqueue ``rows`` (n, *sample); -> a handle with ``event``,
        ``result`` and ``error``. Raises :class:`QueueFull` when the
        queue is at capacity. ``trace`` tags the request's spans with
        the caller's trace; ``tenant`` (resolver output) keys the
        weighted-fair queue."""
        n = int(rows.shape[0])
        if n < 1 or n > self.max_batch:
            raise ValueError("request rows %d outside [1, %d]"
                             % (n, self.max_batch))
        timeout = timeout_seconds(timeout_ms, self.default_timeout)
        req = _Request(rows, time.monotonic() + timeout, trace=trace,
                       tenant=tenant)
        with self._lock:
            if not self._running:
                raise RuntimeError("batcher is closed")
            if self._queued_rows + n > self.max_queue:
                self._count("shed_total")
                raise QueueFull("queue full (%d rows pending, max %d)"
                                % (self._queued_rows, self.max_queue))
            self._count("requests_total")
            start = max(self._vtime, self._vfinish.get(tenant, 0.0))
            req.vft = start + n / tenants.weight(tenant)
            self._vfinish[tenant] = req.vft
            self._queues.setdefault(tenant, collections.deque()).append(req)
            self._queued_rows += n
            self._g_queue.get().set(self._queued_rows)
            self._have_work.notify()
        return req

    def predict(self, rows, timeout_ms=None, trace=None, tenant=None):
        """submit + wait; raises DeadlineExceeded or the batch's error."""
        req = self.submit(rows, timeout_ms=timeout_ms, trace=trace,
                          tenant=tenant)
        req.event.wait(timeout=(req.deadline - time.monotonic())
                       + self.max_wait + 30.0)
        if req.error is not None:
            raise req.error
        if not req.event.is_set():
            raise DeadlineExceeded("no result before deadline")
        return req.result

    # -- worker --------------------------------------------------------

    def _head_locked(self):
        """The next request under weighted fairness: the least virtual
        finish tag among the tenants' FIFO heads (ties broken by tenant
        name). Lock held; some queue is not empty."""
        return min((q[0] for q in self._queues.values() if q),
                   key=lambda r: (r.vft, r.tenant or ""))

    def _collect(self):
        """Wait for work, then drain up to ``max_batch`` rows, holding the
        batch open at most ``max_wait`` past the oldest request's
        arrival; -> the batch (None once closed and drained)."""
        with self._lock:
            while self._running and not self._queued_rows:
                self._have_work.wait()
            if not self._running and not self._queued_rows:
                return None
            oldest = min(q[0].t_enqueue for q in self._queues.values() if q)
            close_at = oldest + self.max_wait
            while self._running:
                left = close_at - time.monotonic()
                if self._queued_rows >= self.max_batch or left <= 0:
                    break
                self._have_work.wait(timeout=left)
            batch, total = [], 0
            while self._queued_rows:
                head = self._head_locked()
                n = head.rows.shape[0]
                if batch and total + n > self.max_batch:
                    break
                if batch and head.rows.shape[1:] != batch[0].rows.shape[1:]:
                    # another sample shape starts its own batch
                    break
                q = self._queues[head.tenant]
                q.popleft()
                if not q:
                    del self._queues[head.tenant]
                self._vtime = max(self._vtime, head.vft)
                self._queued_rows -= n
                batch.append(head)
                total += n
            self._g_queue.get().set(self._queued_rows)
            return batch

    def _worker(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            now = time.monotonic()
            live = []
            for req in batch:
                if req.deadline < now:
                    req.error = DeadlineExceeded(
                        "expired %.0fms before dispatch"
                        % ((now - req.deadline) * 1000))
                    with self._lock:
                        self._count("expired_total")
                    req.event.set()
                else:
                    live.append(req)
            if not live:
                continue
            rows = numpy.concatenate([r.rows for r in live], axis=0) \
                if len(live) > 1 else live[0].rows
            t_dispatch = time.perf_counter()
            try:
                outputs, bucket = self._run_batch(rows)
            except Exception as exc:
                log.warning("%s: batch of %d failed: %s: %s", self.name,
                            len(live), type(exc).__name__, exc)
                with self._lock:
                    self._count("error_total", len(live))
                for req in live:
                    req.error = exc
                    req.event.set()
                continue
            done = time.monotonic()
            done_perf = time.perf_counter()
            off = 0
            for req in live:
                n = req.rows.shape[0]
                req.result = outputs[off:off + n]
                off += n
                req.event.set()
            if telemetry.tracer.active:
                self._trace_batch(live, t_dispatch, done_perf, bucket)
            # the model-health plane's drift gauges, labelled by the
            # batcher's model: the monitor computes them on every
            # serving_stride-th batch of that model
            model_health.get_model_monitor().observe_serving(
                self.model, outputs)
            latency = self._h_latency.get()
            with self._lock:
                self._count("batches_total")
                self._count("batched_requests_total", len(live))
                self._count("batched_rows_total", rows.shape[0])
                self._count("bucket_rows_total", bucket)
                for req in live:
                    latency.observe(done - req.t_enqueue)
                    self._completions.append(done)

    def _trace_batch(self, live, t_dispatch, done_perf, bucket):
        """The spans of one dispatched batch: each request's queue wait
        in its own trace, and ONE execute span for the shared forward,
        parented on the first traced request."""
        parent = next((r.trace for r in live if r.trace is not None),
                      None)
        args = {"model": self.model, "requests": len(live),
                "bucket": bucket}
        if parent is not None:
            args.update(parent.child().span_args())
        telemetry.tracer.add_complete(
            "serving.execute", t_dispatch, done_perf - t_dispatch, **args)
        for req in live:
            qargs = {"model": self.model, "rows": int(req.rows.shape[0])}
            if req.trace is not None:
                qargs.update(req.trace.child().span_args())
            telemetry.tracer.add_complete(
                "serving.queue", req.t_perf, t_dispatch - req.t_perf,
                **qargs)

    def close(self, zero_gauge=True):
        """Stop the worker; requests still queued fail with a closed
        error. ``zero_gauge=False`` is the hot-reload path: the
        replacement batcher already owns the model's queue gauge."""
        with self._lock:
            self._running = False
            self._have_work.notify_all()
        self._thread.join(timeout=5)
        with self._lock:
            for q in self._queues.values():
                while q:
                    req = q.popleft()
                    req.error = RuntimeError("batcher closed")
                    req.event.set()
            self._queues.clear()
            self._queued_rows = 0
            if zero_gauge:
                self._g_queue.get().set(0)

    # -- metrics -------------------------------------------------------

    def metrics(self, rps_window=10.0):
        """Queue depth, counters, batch fill (requests per batch), bucket
        padding (bucket rows per real row), requests/s over the window
        and the latency percentiles (of the model's latency histogram)."""
        latency = self._h_latency.get()
        with self._lock:
            c = dict(self.counts)
            queued = self._queued_rows
            now = time.monotonic()
            recent = [t for t in self._completions if t > now - rps_window]
        m = {
            "queue_depth": queued,
            "requests_total": c["requests_total"],
            "shed_total": c["shed_total"],
            "expired_total": c["expired_total"],
            "error_total": c["error_total"],
            "batches_total": c["batches_total"],
            "batch_fill_ratio": round(c["batched_requests_total"]
                                      / max(c["batches_total"], 1), 3),
            "bucket_pad_ratio": round(c["bucket_rows_total"]
                                      / max(c["batched_rows_total"], 1), 3),
            "requests_per_sec": round(len(recent) / rps_window, 2),
        }
        p50 = latency.percentile(0.5)
        if p50 is not None:
            m["latency_ms_p50"] = round(p50 * 1000, 3)
            m["latency_ms_p99"] = round(latency.percentile(0.99) * 1000, 3)
        return m
