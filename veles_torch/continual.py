"""Closed-loop continual training of the PyTorch port.

Counterpart of ``veles/continual.py``. The loop: an ingest source over
HTTP (:func:`stream_handler`, :class:`HttpStreamSource`) feeds a
:class:`~veles_torch.loader.stream.ContinualStreamLoader`; ``--continual``
runs the workflow in rounds (:func:`continual_loop`); the snapshotter
stamps each checkpoint's manifest with ``ingest_wall``, the wall time of
the newest sample behind its weights (:func:`ingest_wall`); a serving
registry that loads the checkpoint publishes its staleness.

**Staleness** is the loop's objective: ``veles_staleness_seconds{point}``
is now minus the ingest wall time of the newest sample behind what that
point runs: the trainer's live ingest clock, or the ``ingest_wall`` of
the checkpoint a serving replica loaded (``point="serving:<model>"``).
A stalled source, a stopped trainer or a refused checkpoint all show the
same way: the gauge climbs and the staleness objective
(:func:`install_staleness_slo`) fires.
"""

import io
import json
import logging
import threading
import time
import urllib.request
from urllib.parse import parse_qs, urlparse

import numpy

from veles_torch import telemetry
from veles_torch.loader.stream import StreamSource

logger = logging.getLogger("veles_torch.continual")

#: the staleness gauge family: one labelled child per observation point
STALENESS_FAMILY = "veles_staleness_seconds"

_clock_lock = threading.Lock()
_ingest_clock = None


def register_ingest_clock(fn):
    """Register the process's ingest clock: a callable -> the wall time of
    the newest sample the trainer ingested (None or 0 before the first).
    The snapshotter stamps it into every checkpoint as ``ingest_wall``."""
    global _ingest_clock
    with _clock_lock:
        _ingest_clock = fn


def ingest_wall():
    """Wall time of the newest ingested sample, or None when no clock is
    registered or nothing was ingested yet."""
    with _clock_lock:
        fn = _ingest_clock
    if fn is None:
        return None
    try:
        wall = fn()
    except Exception:
        return None
    return float(wall) if wall else None


def staleness_gauge():
    return telemetry.gauge(
        STALENESS_FAMILY,
        "End-to-end staleness: now minus the ingest wall time of the "
        "newest sample behind this observation point (0 until the "
        "point has an ingest clock)", ("point",))


def staleness_of(wall):
    """Seconds of staleness of an ingest wall time (0 when unknown)."""
    if not wall:
        return 0.0
    return max(0.0, time.time() - float(wall))


def install_point_gauge(point, wall_fn):
    """Publish ``veles_staleness_seconds{point=...}``, evaluated at scrape
    time from ``wall_fn`` (-> an ingest wall or None)."""
    staleness_gauge().labels(point).set_function(
        lambda: staleness_of(wall_fn()))


def install_staleness_slo(threshold=120.0, point="trainer", monitor=None,
                          target=0.9, fast_window=60.0, slow_window=300.0,
                          burn_threshold=1.0):
    """Arm the staleness burn-rate objective on the port's health monitor
    (``health.py``): samples over ``threshold`` burn error budget and a
    stalled loop makes ``/readyz`` name ``staleness``. -> 1 when
    installed, 0 when it already was."""
    from veles_torch import health
    monitor = monitor if monitor is not None else health.get_monitor()
    name = "staleness" if point == "trainer" else "staleness_%s" % point
    if name in monitor._slo_names:
        return 0
    monitor.add_slo({
        "name": name,
        "kind": "threshold",
        "series": '%s{point="%s"}' % (STALENESS_FAMILY, point),
        "op": "<=",
        "threshold": float(threshold),
        "target": float(target),
        "fast_window": float(fast_window),
        "slow_window": float(slow_window),
        "burn_threshold": float(burn_threshold),
    })
    return 1


# -- the HTTP ingest transport --------------------------------------------


def stream_handler(source):
    """A handler of the port's reactor ``HttpServer`` serving a
    :class:`StreamSource`:

    * ``GET /stream/spec`` -> ``{"spec": {name: [shape, dtype]}}``
    * ``GET /stream/fetch?start=N&count=M`` -> npz bytes, fetched on
      ``request.defer`` (a fetch may block; the reactor loop never does).
    """

    def handler(request):
        url = urlparse(request.path)
        if url.path == "/stream/spec":
            request.reply_json(200, {"spec": {
                name: [list(shape), numpy.dtype(dtype).str]
                for name, (shape, dtype) in source.spec().items()}})
            return
        if url.path == "/stream/fetch":
            q = parse_qs(url.query)
            try:
                start = int(q["start"][0])
                count = int(q["count"][0])
            except (KeyError, ValueError, IndexError):
                request.reply_json(400, {"error": "need start=N&count=M"})
                return

            def produce():
                arrays = source.fetch(start, count)
                buf = io.BytesIO()
                numpy.savez(buf, **arrays)
                request.reply(200, buf.getvalue(),
                              ctype="application/octet-stream")
            request.defer(produce)
            return
        request.reply_json(404, {"error": "no route %s" % url.path})

    return handler


class HttpStreamSource(StreamSource):
    """A seekable source over the :func:`stream_handler` wire. A failed
    fetch raises: the loader's producer owns the retry, and a black-holed
    connection shows here as a socket timeout."""

    def __init__(self, base, timeout=5.0):
        self.base = str(base).rstrip("/")
        self.timeout = float(timeout)
        self._spec = None

    def spec(self):
        if self._spec is None:
            with urllib.request.urlopen(self.base + "/stream/spec",
                                        timeout=self.timeout) as resp:
                doc = json.load(resp)
            self._spec = {name: (tuple(shape), numpy.dtype(dtype))
                          for name, (shape, dtype) in doc["spec"].items()}
        return self._spec

    def fetch(self, start, count):
        url = "%s/stream/fetch?start=%d&count=%d" % (
            self.base, int(start), int(count))
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            raw = resp.read()
        with numpy.load(io.BytesIO(raw), allow_pickle=False) as npz:
            return {name: npz[name] for name in npz.files}


# -- the trainer's round loop -----------------------------------------------


def continual_loop(workflow, rounds=None, launcher=None):
    """Run ``workflow.run()`` in rounds of the decision's ``max_epochs``
    epochs, reopening the decision between rounds, until ``launcher`` is
    interrupted or preempted, or for ``rounds`` rounds.

    The loader's ingest clock (``last_ingest_wall``) becomes the process's
    (so checkpoints carry ``ingest_wall``), the trainer's staleness gauge
    is published, and the no-improvement stop is disarmed (patience means
    nothing against a shifting stream). A round that a stop ended does not
    count. -> the rounds completed."""
    decision = getattr(workflow, "decision", None)
    if decision is None:
        raise ValueError("--continual needs a workflow with a decision "
                         "unit (the round boundary is decision.max_epochs)")
    loader = getattr(workflow, "loader", None)
    if loader is not None and hasattr(loader, "last_ingest_wall"):
        register_ingest_clock(
            lambda: getattr(loader, "last_ingest_wall", 0.0))
    install_point_gauge("trainer", ingest_wall)
    round_epochs = max(1, int(decision.max_epochs or 1)
                       - int(decision.epoch_number))
    decision.fail_iterations = float("inf")
    tele_rounds = telemetry.counter(
        "veles_continual_rounds_total",
        "Completed continual-training rounds", ("workflow",)).labels(
            workflow.name)
    tele_round = telemetry.gauge(
        "veles_continual_round",
        "Rounds completed by this continual run", ("workflow",)).labels(
            workflow.name)
    logger.info("continual mode: %s rounds of %d epoch(s) each",
                "endless" if rounds is None else str(rounds), round_epochs)
    done = 0
    while rounds is None or done < rounds:
        if launcher is not None and (launcher.interrupted
                                     or launcher.preempted):
            break
        decision.complete = False
        decision.max_epochs = int(decision.epoch_number) + round_epochs
        workflow.run()
        if workflow.step.stop_requested and not decision.complete:
            break           # a stop landed mid-round: it does not count
        done += 1
        tele_rounds.inc()
        tele_round.set(done)
        telemetry.record_event(
            "continual_round", workflow=workflow.name, round=done,
            epoch=int(decision.epoch_number), ingest_wall=ingest_wall())
    logger.info("continual run ended after %d round(s) (epoch %d)", done,
                int(decision.epoch_number))
    return done
