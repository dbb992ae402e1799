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

It serves the single default tenant (weight 1, first in first out), as
the reference does when no tenant table is installed; the counters are
plain attributes read by :meth:`MicroBatcher.metrics` (the reference's
``telemetry`` instruments and tenant table wait for the port's frontend
slice).
"""

import collections
import logging
import math
import threading
import time

import numpy

from veles_torch import model_health

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


def percentile(values, q):
    """The ``q`` quantile (0..1) of ``values`` (None when empty)."""
    if not values:
        return None
    return float(numpy.percentile(numpy.asarray(values), 100.0 * q))


class _Request:
    __slots__ = ("rows", "deadline", "t_enqueue", "event", "result",
                 "error")

    def __init__(self, rows, deadline):
        self.rows = rows
        self.deadline = deadline
        self.t_enqueue = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error = None


class MicroBatcher:
    """Coalesces concurrent :meth:`submit` calls into batched
    ``run_batch(rows) -> (outputs, bucket)`` dispatches (an
    ``InferenceEngine.predict``), on one worker thread."""

    #: the counters :meth:`metrics` reports
    COUNTERS = ("requests_total", "shed_total", "expired_total",
                "error_total", "batches_total", "batched_requests_total",
                "batched_rows_total", "bucket_rows_total")

    def __init__(self, run_batch, max_batch=64, max_queue=256,
                 max_wait_ms=2.0, default_timeout_ms=1000.0,
                 name="batcher"):
        self.name = name
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_wait = float(max_wait_ms) / 1000.0
        self.default_timeout = float(default_timeout_ms) / 1000.0
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._queued_rows = 0
        self._running = True
        self.counts = dict.fromkeys(self.COUNTERS, 0)
        self._latencies = collections.deque(maxlen=4096)
        self._completions = collections.deque(maxlen=4096)
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="%s-worker" % name)
        self._thread.start()

    # -- client side ---------------------------------------------------

    def submit(self, rows, timeout_ms=None):
        """Enqueue ``rows`` (n, *sample); -> a handle with ``event``,
        ``result`` and ``error``. Raises :class:`QueueFull` when the
        queue is at capacity."""
        n = int(rows.shape[0])
        if n < 1 or n > self.max_batch:
            raise ValueError("request rows %d outside [1, %d]"
                             % (n, self.max_batch))
        timeout = timeout_seconds(timeout_ms, self.default_timeout)
        req = _Request(rows, time.monotonic() + timeout)
        with self._lock:
            if not self._running:
                raise RuntimeError("batcher is closed")
            if self._queued_rows + n > self.max_queue:
                self.counts["shed_total"] += 1
                raise QueueFull("queue full (%d rows pending, max %d)"
                                % (self._queued_rows, self.max_queue))
            self.counts["requests_total"] += 1
            self._queue.append(req)
            self._queued_rows += n
            self._have_work.notify()
        return req

    def predict(self, rows, timeout_ms=None):
        """submit + wait; raises DeadlineExceeded or the batch's error."""
        req = self.submit(rows, timeout_ms=timeout_ms)
        req.event.wait(timeout=(req.deadline - time.monotonic())
                       + self.max_wait + 30.0)
        if req.error is not None:
            raise req.error
        if not req.event.is_set():
            raise DeadlineExceeded("no result before deadline")
        return req.result

    # -- worker --------------------------------------------------------

    def _collect(self):
        """Wait for work, then drain up to ``max_batch`` rows, holding the
        batch open at most ``max_wait`` past the oldest request's
        arrival; -> the batch (None once closed and drained)."""
        with self._lock:
            while self._running and not self._queued_rows:
                self._have_work.wait()
            if not self._running and not self._queued_rows:
                return None
            close_at = self._queue[0].t_enqueue + self.max_wait
            while self._running:
                left = close_at - time.monotonic()
                if self._queued_rows >= self.max_batch or left <= 0:
                    break
                self._have_work.wait(timeout=left)
            batch, total = [], 0
            while self._queue:
                head = self._queue[0]
                n = head.rows.shape[0]
                if batch and total + n > self.max_batch:
                    break
                if batch and head.rows.shape[1:] != batch[0].rows.shape[1:]:
                    # another sample shape starts its own batch
                    break
                self._queue.popleft()
                self._queued_rows -= n
                batch.append(head)
                total += n
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
                        self.counts["expired_total"] += 1
                    req.event.set()
                else:
                    live.append(req)
            if not live:
                continue
            rows = numpy.concatenate([r.rows for r in live], axis=0) \
                if len(live) > 1 else live[0].rows
            try:
                outputs, bucket = self._run_batch(rows)
            except Exception as exc:
                log.warning("%s: batch of %d failed: %s: %s", self.name,
                            len(live), type(exc).__name__, exc)
                with self._lock:
                    self.counts["error_total"] += len(live)
                for req in live:
                    req.error = exc
                    req.event.set()
                continue
            done = time.monotonic()
            off = 0
            for req in live:
                n = req.rows.shape[0]
                req.result = outputs[off:off + n]
                off += n
                req.event.set()
            # the model-health plane's drift gauges, labelled by the
            # batcher's name: the monitor computes them on every
            # serving_stride-th batch of that name
            model_health.get_model_monitor().observe_serving(
                self.name, outputs)
            with self._lock:
                c = self.counts
                c["batches_total"] += 1
                c["batched_requests_total"] += len(live)
                c["batched_rows_total"] += rows.shape[0]
                c["bucket_rows_total"] += bucket
                for req in live:
                    self._latencies.append(done - req.t_enqueue)
                    self._completions.append(done)

    def close(self):
        """Stop the worker; requests still queued fail with a closed
        error."""
        with self._lock:
            self._running = False
            self._have_work.notify_all()
        self._thread.join(timeout=5)
        with self._lock:
            while self._queue:
                req = self._queue.popleft()
                req.error = RuntimeError("batcher closed")
                req.event.set()
            self._queued_rows = 0

    # -- metrics -------------------------------------------------------

    def metrics(self, rps_window=10.0):
        """Queue depth, counters, batch fill (requests per batch), bucket
        padding (bucket rows per real row), requests/s over the window
        and the latency percentiles."""
        with self._lock:
            c = dict(self.counts)
            queued = self._queued_rows
            now = time.monotonic()
            recent = [t for t in self._completions if t > now - rps_window]
            lat = list(self._latencies)
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
        if lat:
            m["latency_ms_p50"] = round(percentile(lat, 0.5) * 1000, 3)
            m["latency_ms_p99"] = round(percentile(lat, 0.99) * 1000, 3)
        return m
