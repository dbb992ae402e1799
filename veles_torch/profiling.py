"""Continuous profiling plane of the port: sampling profiler, memory
accounting, trace critical-path analysis.

The port's own copy of ``veles/profiling.py`` (it imports nothing of the
JAX package). Three "why" questions, answered on a live process:

* **where does CPU time go?** — :class:`SamplingProfiler`: a daemon
  thread walks ``sys._current_frames()`` at a configurable rate
  (default 97 Hz, co-prime with the tree's 100 Hz/250 ms timers so
  sampling never phase-locks to them), folds stacks PER NAMED THREAD
  (the reactor loop, ``http-worker`` threads, the health monitor,
  batcher workers) into a bounded aggregate, and renders both
  collapsed-stack text and speedscope JSON. Served as ``GET
  /debug/profile?seconds=N&hz=H[&format=collapsed]`` on the web status
  and the serving frontend, always through ``request.defer`` (the
  capture blocks for its window; nothing captures on the reactor loop),
  and read by ``python -m veles_torch profile URL``;

* **who holds the memory?** — :func:`register_memory_gauges`:
  ``veles_host_rss_bytes`` / ``veles_host_open_fds`` from ``/proc/self``,
  ``veles_device_memory_bytes{kind}`` from ``torch.cuda.memory_stats()``
  once CUDA is initialized (:func:`device_memory`), and the perf
  ledger's size estimates (``perf.py``). The health monitor registers
  them on every tick (``health.py``), so ``/metrics/history`` carries
  memory trajectories and SLO objectives can fire on leaks;

* **which leg is the critical path?** — :func:`critical_path_doc`:
  groups the flight recorder's spans (``telemetry.tracer.flight_spans``)
  by ``trace_id``, computes each job's breakdown (dispatch → wire →
  slave compute → merge for training; queue → execute for serving) and
  aggregates a window into a "where the step time goes" document with
  straggler attribution. Served as ``GET
  /debug/critical_path?window=SECS`` on both HTTP planes
  (``telemetry.debug_endpoint``) and rendered by ``python -m veles_torch
  top`` as a per-target breakdown line.
"""

import json
import math
import os
import sys
import threading
import time
from urllib.parse import parse_qs, urlparse

import torch

from veles_torch import telemetry

#: default sampling rate (Hz). 97 is prime: it cannot phase-lock with
#: the tree's 100 Hz pollers or the reactor's 250 ms lag probe, so a
#: periodic callback is sampled across its whole body, not always at
#: the same instruction.
DEFAULT_HZ = 97

#: capture bounds: the HTTP surface takes these straight from a query
#: string, so they are clamped, never trusted
MAX_SECONDS = 60.0
MIN_SECONDS = 0.05
MAX_HZ = 999
DEFAULT_SECONDS = 2.0

#: bounded aggregate: distinct (thread, stack) entries retained; the
#: overflow folds into a per-thread <truncated> bucket so the profile
#: stays honest about what it could not keep
MAX_STACKS = 20000
#: frames kept per stack (deeper tails are cut at the root end)
MAX_DEPTH = 128

_TRUNCATED_FRAME = ("<truncated>", "", 0)


def _clamp(value, lo, hi, default):
    """min/max clamp that survives NaN/inf: both query params feed
    straight into loop periods and sleep durations, and
    ``min(max(nan, lo), hi)`` is ``nan`` (every NaN comparison is
    False) — which would turn the sampler into a zero-delay busy
    loop for the whole capture window."""
    try:
        value = float(value)
    except (TypeError, ValueError):
        return default
    if not math.isfinite(value):
        return default
    return min(max(value, lo), hi)


class Profile:
    """One finished capture: folded stacks + capture metadata.

    ``stacks`` maps ``(thread_name, stack_tuple)`` to sample counts,
    each stack a root-first tuple of ``(func, file, line)`` frames."""

    def __init__(self, stacks, ticks, hz, wall_seconds, self_seconds,
                 truncated=0):
        self.stacks = stacks
        self.ticks = int(ticks)
        self.hz = float(hz)
        self.wall_seconds = float(wall_seconds)
        self.self_seconds = float(self_seconds)
        self.truncated = int(truncated)

    @property
    def overhead_fraction(self):
        """Self-measured sampling cost: seconds spent inside the
        sampler over the capture wall time."""
        if self.wall_seconds <= 0:
            return 0.0
        return self.self_seconds / self.wall_seconds

    def thread_names(self):
        return sorted({name for name, _ in self.stacks})

    # -- renders -------------------------------------------------------

    def to_collapsed(self):
        """Brendan-Gregg collapsed-stack text: one
        ``thread;root;...;leaf count`` line per distinct stack (the
        flamegraph.pl / speedscope import format)."""
        lines = []
        for (name, stack), count in sorted(self.stacks.items()):
            frames = ";".join([name] + [f[0] for f in stack])
            lines.append("%s %d" % (frames, count))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_speedscope(self, name="veles profile"):
        """The capture as a speedscope file document (one ``sampled``
        profile per thread, frames interned in ``shared.frames``) —
        loadable at https://www.speedscope.app. Sample weight is the
        sampling period, so per-thread ``endValue`` reads as seconds
        of observed on-CPU-or-blocked wall time."""
        frames = []
        index = {}

        def intern(frame):
            i = index.get(frame)
            if i is None:
                i = index[frame] = len(frames)
                fn, path, line = frame
                frames.append({"name": fn, "file": path, "line": line})
            return i

        by_thread = {}
        for (tname, stack), count in sorted(self.stacks.items()):
            by_thread.setdefault(tname, []).append((stack, count))
        weight = 1.0 / self.hz if self.hz > 0 else 0.0
        profiles = []
        for tname in sorted(by_thread):
            samples, weights, total = [], [], 0.0
            for stack, count in by_thread[tname]:
                samples.append([intern(f) for f in stack])
                w = count * weight
                weights.append(round(w, 6))
                total += w
            profiles.append({
                "type": "sampled", "name": tname, "unit": "seconds",
                "startValue": 0, "endValue": round(total, 6),
                "samples": samples, "weights": weights,
            })
        return {
            "$schema": "https://www.speedscope.app/"
                       "file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": profiles,
            "name": name,
            "exporter": "veles-profiling",
            "activeProfileIndex": 0,
            # capture honesty: rate, tick count, what the bounded
            # aggregate dropped, and the sampler's own measured cost
            "veles": {
                "hz": self.hz,
                "seconds": round(self.wall_seconds, 3),
                "ticks": self.ticks,
                "truncated_samples": self.truncated,
                "overhead_fraction": round(self.overhead_fraction, 5),
            },
        }


class SamplingProfiler:
    """The sampler: one daemon thread, a bounded folded aggregate.

    ``start()``/``stop()`` bracket a capture; :meth:`profile`
    snapshots the aggregate at any point. Blocking by nature once you
    wait out a capture window — which is why the HTTP surface reaches
    it only through ``request.defer``."""

    def __init__(self, hz=DEFAULT_HZ, max_stacks=MAX_STACKS):
        self.hz = _clamp(hz, 1.0, float(MAX_HZ), float(DEFAULT_HZ))
        self.max_stacks = int(max_stacks)
        self._lock = threading.Lock()
        self._stacks = {}
        self._ticks = 0
        self._truncated = 0
        self._self_seconds = 0.0
        self._stop = threading.Event()
        self._thread = None
        self._started_perf = None
        self._wall_seconds = 0.0

    # -- lifecycle -----------------------------------------------------

    def start(self):
        """Start the sampler thread (no-op while already running)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._started_perf = time.perf_counter()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="profiler-sampler")
            self._thread.start()
        return self

    def stop(self):
        """Stop sampling; the aggregate stays readable."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        with self._lock:
            if self._started_perf is not None:
                self._wall_seconds += \
                    time.perf_counter() - self._started_perf
                self._started_perf = None
        return self

    def _loop(self):
        period = 1.0 / self.hz
        next_due = time.monotonic() + period
        while True:
            delay = next_due - time.monotonic()
            if self._stop.wait(delay if delay > 0 else 0.0):
                return
            next_due += period
            t0 = time.perf_counter()
            self._sample()
            dt = time.perf_counter() - t0
            with self._lock:
                self._self_seconds += dt
            if next_due < time.monotonic() - 1.0:
                # sampling fell >1s behind (a long GC pause, a
                # debugger): resynchronize instead of firing a burst
                next_due = time.monotonic() + period

    # -- the sample ----------------------------------------------------

    def _sample(self):
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        folded = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue                 # never profile the profiler
            stack = []
            f = frame
            while f is not None and len(stack) < MAX_DEPTH:
                code = f.f_code
                stack.append((code.co_name, code.co_filename,
                              f.f_lineno))
                f = f.f_back
            stack.reverse()              # speedscope wants root first
            folded.append((names.get(tid, "tid-%d" % tid),
                           tuple(stack)))
        with self._lock:
            for key in folded:
                if key not in self._stacks \
                        and len(self._stacks) >= self.max_stacks:
                    self._truncated += 1
                    key = (key[0], (_TRUNCATED_FRAME,))
                self._stacks[key] = self._stacks.get(key, 0) + 1
                self._ticks += 1

    # -- reads ---------------------------------------------------------

    def profile(self):
        """Snapshot the aggregate as a :class:`Profile`."""
        with self._lock:
            wall = self._wall_seconds
            if self._started_perf is not None:
                wall += time.perf_counter() - self._started_perf
            return Profile(dict(self._stacks), self._ticks, self.hz,
                           wall, self._self_seconds,
                           truncated=self._truncated)


def capture_profile(seconds, hz=DEFAULT_HZ):
    """Blocking convenience: sample every thread for ``seconds`` at
    ``hz`` and return the :class:`Profile`. Bounds are clamped — the
    HTTP surface feeds this straight from a query string. MUST run on
    a worker thread, never the reactor loop."""
    seconds = _clamp(seconds, MIN_SECONDS, MAX_SECONDS,
                     DEFAULT_SECONDS)
    profiler = SamplingProfiler(hz=hz)
    profiler.start()
    try:
        time.sleep(seconds)
    finally:
        profiler.stop()
    return profiler.profile()


def profile_endpoint(path):
    """Route ``/debug/profile[?seconds=N&hz=H&format=F]`` to its HTTP
    reply; -> ``(code, body_str, content_type)``. BLOCKS for the
    capture window — both frontends hand this to ``request.defer``,
    never the loop. ``format``: ``speedscope``
    (default, JSON) or ``collapsed`` (text)."""
    parsed = urlparse(path)
    query = parse_qs(parsed.query)

    def _num(key, default):
        raw = query.get(key, [None])[0]
        if raw is None:
            return default, None
        try:
            value = float(raw)
        except ValueError:
            value = float("nan")
        if not math.isfinite(value):
            # nan/inf would defeat the min/max clamps downstream
            # (nan compares False to everything) — reject, never
            # let a query string pick a zero-delay sampling loop
            return None, "bad %s=%r (want a finite number)" \
                % (key, raw)
        return value, None

    seconds, err = _num("seconds", DEFAULT_SECONDS)
    hz, err2 = _num("hz", DEFAULT_HZ)
    fmt = query.get("format", ["speedscope"])[0]
    err = err or err2 or (None if fmt in ("speedscope", "collapsed")
                          else "bad format=%r (want speedscope|"
                               "collapsed)" % fmt)
    if err:
        return 400, json.dumps({"error": err}), "application/json"
    prof = capture_profile(seconds, hz=hz)
    if fmt == "collapsed":
        return 200, prof.to_collapsed(), "text/plain; charset=utf-8"
    doc = prof.to_speedscope(
        name="veles pid %d (%gs @ %gHz)" % (os.getpid(),
                                            prof.wall_seconds,
                                            prof.hz))
    return 200, json.dumps(doc), "application/json"


# -- memory accounting --------------------------------------------------


def host_memory():
    """``{"rss_bytes": int, "open_fds": int}`` for THIS process from
    ``/proc/self`` (zeros where the platform lacks procfs)."""
    rss = 0
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    fds = 0
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    return {"rss_bytes": rss, "open_fds": fds}


def device_memory():
    """``{kind: bytes}`` of the CUDA caching allocator, summed over the
    cards, in the reference's kinds: ``bytes_in_use`` (allocated now),
    ``peak_bytes_in_use`` (allocated at the peak), ``bytes_reserved``
    (held by the allocator) and ``bytes_limit`` (the cards' total
    memory). Empty until CUDA is initialized: a process that never
    touched the card (the tests, ``serve -d cpu``) must not have its
    health monitor create a CUDA context."""
    if not torch.cuda.is_initialized():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            _, total = torch.cuda.mem_get_info(i)
        except RuntimeError:
            continue
        for kind, value in (
                ("bytes_in_use", stats.get("allocated_bytes.all.current")),
                ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak")),
                ("bytes_reserved", stats.get("reserved_bytes.all.current")),
                ("bytes_limit", total)):
            if value is not None:
                out[kind] = out.get(kind, 0) + int(value)
    return out


#: short-TTL shared snapshot for the set_function gauges: one scrape
#: reads SEVERAL of them back to back (rss + fds + K device kinds),
#: and each raw read costs /proc I/O or a per-device memory_stats
#: sweep — one snapshot per scrape, not one per gauge
_MEM_TTL = 0.5
_mem_lock = threading.Lock()
_mem_cache = (0.0, None, None)         # (monotonic, host, device)


def _mem_snapshot():
    global _mem_cache
    now = time.monotonic()
    with _mem_lock:
        stamp, host, device = _mem_cache
        if host is not None and now - stamp < _MEM_TTL:
            return host, device
    host, device = host_memory(), device_memory()
    with _mem_lock:
        _mem_cache = (now, host, device)
    return host, device


def register_memory_gauges(registry=None):
    """Create the memory-accounting gauges in ``registry`` (default:
    the active one). Every gauge is a ``set_function`` — evaluated at
    scrape/ring-sample time, so the health ring's 1 Hz tick is what
    turns them into trajectories. Idempotent (families are)."""
    registry = registry or telemetry.get_registry()
    registry.gauge(
        "veles_host_rss_bytes",
        "Resident set size of this process (/proc/self/statm)"
    ).set_function(lambda: _mem_snapshot()[0]["rss_bytes"])
    registry.gauge(
        "veles_host_open_fds",
        "Open file descriptors of this process (/proc/self/fd)"
    ).set_function(lambda: _mem_snapshot()[0]["open_fds"])
    from veles_torch import perf
    ledger_g = registry.gauge(
        "veles_perf_ledger_programs",
        "Compiled step programs currently held by the perf ledger")
    ledger_g.set_function(lambda: perf.ledger.sizes()["programs"])
    registry.gauge(
        "veles_perf_ledger_est_bytes",
        "Summed per-program I/O footprint estimate of the ledger's "
        "live costed signatures (counted, not an allocator meter)"
    ).set_function(lambda: perf.ledger.sizes()["est_bytes"])
    dev_fam = registry.gauge(
        "veles_device_memory_bytes",
        "Accelerator memory by allocator statistic, summed over "
        "devices (torch.cuda memory_stats; absent until CUDA is "
        "initialized)", ("kind",))
    _, device = _mem_snapshot()
    for kind in sorted(device):
        dev_fam.labels(kind).set_function(
            lambda k=kind: _mem_snapshot()[1].get(k, 0))
    return registry


# -- critical-path analysis over the flight recorder --------------------

#: training-job span names -> leg (the dispatch→wire→compute→merge
#: decomposition of one minibatch job's wall time; the master/slave
#: wire mints these, the reference's ``veles/server.py`` and
#: ``veles/client.py`` today)
_TRAIN_LEGS = {
    "job.dispatch": "dispatch",
    "job.wire": "wire",
    "slave.apply": "compute",
    "slave.compute": "compute",
    "slave.update_build": "compute",
    "job.merge": "merge",
}
_TRAIN_ORDER = ("dispatch", "wire", "compute", "merge")

#: serving-request span names -> leg (queue→execute; batcher.py)
_SERVE_LEGS = {
    "serving.queue": "queue",
    "serving.execute": "execute",
}
_SERVE_ORDER = ("queue", "execute")

#: spans that bound a trace's wall extent without being a leg
_ENVELOPES = frozenset(("http.predict",))


def _aggregate(kind, order, traces):
    """Fold per-trace ``(wall_extent, legs, slave)`` tuples into the
    per-side document (legs totals/means/fractions, straggler)."""
    jobs = len(traces)
    wall = sum(t[0] for t in traces)
    legs = {}
    slaves = {}
    for extent, tlegs, slave in traces:
        for leg, secs in tlegs.items():
            legs[leg] = legs.get(leg, 0.0) + secs
        if slave is not None:
            row = slaves.setdefault(slave, {
                "jobs": 0, "wall_s": 0.0,
                "legs": {k: 0.0 for k in order}})
            row["jobs"] += 1
            row["wall_s"] += extent
            for leg, secs in tlegs.items():
                row["legs"][leg] = row["legs"].get(leg, 0.0) + secs
    attributed = sum(legs.values())
    doc = {
        "kind": kind, "jobs": jobs,
        "wall_s": round(wall, 6),
        "attributed_s": round(attributed, 6),
        "attributed_fraction": round(attributed / wall, 4)
        if wall > 0 else 0.0,
        "legs": {
            leg: {
                "total_s": round(legs.get(leg, 0.0), 6),
                "mean_s": round(legs.get(leg, 0.0) / jobs, 6)
                if jobs else 0.0,
                "fraction": round(legs.get(leg, 0.0) / wall, 4)
                if wall > 0 else 0.0,
            }
            for leg in order
        },
    }
    if slaves:
        per_slave = {}
        straggler = None
        for sid, row in slaves.items():
            mean = row["wall_s"] / row["jobs"] if row["jobs"] else 0.0
            hot = max(row["legs"].items(), key=lambda kv: kv[1])
            per_slave[sid] = {
                "jobs": row["jobs"],
                "mean_job_s": round(mean, 6),
                "legs_s": {k: round(v, 6)
                           for k, v in row["legs"].items() if v},
            }
            if straggler is None or mean > straggler[1]:
                straggler = (sid, mean, hot[0])
        doc["slaves"] = per_slave
        if straggler is not None and len(slaves) > 0:
            doc["straggler"] = {"slave": straggler[0],
                                "mean_job_s": round(straggler[1], 6),
                                "leg": straggler[2]}
    return doc


def critical_path_doc(window=None, tracer=None):
    """Aggregate the flight-recorder window into the "where does the
    step time go" document (``GET /debug/critical_path?window=S``).

    Spans are grouped by their ``trace_id``; each trace's wall extent
    is ``max(end) - min(start)`` over its spans, its legs the summed
    span durations per leg. ``attributed_fraction`` is the honesty
    number: how much of the summed wall extents the known legs
    explain (≥ 0.9 on a healthy cluster).
    Straggler attribution keys on the ``slave`` arg the master stamps
    on dispatch/wire/merge spans (and the slave on its own legs)."""
    tracer = tracer or telemetry.tracer
    spans = tracer.flight_spans(window)
    groups = {}
    for wall, ev in spans:
        args = ev.get("args") or {}
        trace_id = args.get("trace_id")
        name = ev.get("name")
        if not trace_id or (name not in _TRAIN_LEGS
                            and name not in _SERVE_LEGS
                            and name not in _ENVELOPES):
            continue
        groups.setdefault(trace_id, []).append((wall, ev))
    train, serve = [], []
    for trace_id, evs in groups.items():
        names = {ev["name"] for _, ev in evs}
        is_train = bool(names & set(_TRAIN_LEGS))
        leg_map = _TRAIN_LEGS if is_train else _SERVE_LEGS
        start = min(w for w, _ in evs)
        end = max(w + float(ev.get("dur", 0.0)) / 1e6
                  for w, ev in evs)
        legs = {}
        slave = None
        for _, ev in evs:
            leg = leg_map.get(ev["name"])
            if leg is not None:
                legs[leg] = legs.get(leg, 0.0) \
                    + float(ev.get("dur", 0.0)) / 1e6
            s = (ev.get("args") or {}).get("slave")
            if s is not None:
                slave = str(s)
        row = (max(end - start, 0.0), legs, slave if is_train else None)
        (train if is_train else serve).append(row)
    window_s = tracer.flight_window if window is None \
        else max(float(window), 0.0)
    doc = {
        "window_s": round(window_s, 3),
        "now": round(time.time(), 3),
        "traces": len(groups),
        "spans": len(spans),
    }
    doc["train"] = _aggregate("train", _TRAIN_ORDER, train) \
        if train else None
    doc["serving"] = _aggregate("serving", _SERVE_ORDER, serve) \
        if serve else None
    return doc
