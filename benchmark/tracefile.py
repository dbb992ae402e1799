"""Reading the profiler's trace of a traced run.

``torch.profiler`` writes a Chrome trace: device work (kernels, copies,
fills) on the card's streams, the host's CUDA runtime and driver calls
that launched it (linked by ``correlation``), and the spans the
benchmark opens around calls (``user_annotation``). The traced window is
the benchmark's own ``bench.traced_window`` span, which closes after the
card has finished. Per-layer readers (``metrics/<name>.py``) get a
:class:`Context` and take their numbers from it.
"""

import bisect
import collections
import json
import math

import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: host calls that put work on the card: kernel and graph launches, copies
#: and fills
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperative",
                   "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                   "cuMemcpy", "cudaMemset", "cuMemset")
WINDOW = "bench.traced_window"
STEP = "bench.train_step"
#: entries of each breakdown list
TOP = 10
#: host operations looked through, latest first, for one covering a gap
SCAN = 4096


class Events:
    """The trace's events by kind, times in microseconds."""

    def __init__(self, raw):
        self.device = []        # (ts, end, name, correlation)
        self.launches = []      # (ts, end, name, correlation, tid)
        self.spans = []         # (ts, end, name, tid)
        self.host = []          # (ts, end, name, tid): host operations
        for e in raw:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, end, e["name"], corr))
            elif cat in LAUNCH_CATS:
                self.launches.append((ts, end, e["name"], corr, e.get("tid")))
            elif cat == "user_annotation":
                self.spans.append((ts, end, e["name"], e.get("tid")))
            elif cat in ("cpu_op", "python_function"):
                self.host.append((ts, end, e["name"], e.get("tid")))
        self.device.sort()
        windows = [s for s in self.spans if s[2] == WINDOW]
        self.window = (windows[0][0], windows[0][1]) if windows else (
            (self.device[0][0], self.device[-1][1]) if self.device
            else (0.0, 0.0))

    def spans_named(self, name):
        return sorted(s for s in self.spans if s[2] == name)

    def launches_in(self, name):
        """The launch calls made inside the spans called ``name`` (on the
        span's thread) within a train step's span."""
        spans = self.spans_named(name)
        steps = self.spans_named(STEP)
        out = []
        for ts, end, lname, corr, tid in self.launches:
            if not lname.startswith(LAUNCH_PREFIXES):
                continue
            if _inside(ts, tid, spans) and (
                    name == STEP or _inside(ts, tid, steps)):
                out.append((ts, end, lname, corr, tid))
        return out

    def device_seconds_of(self, name):
        """Seconds of device work launched inside the spans ``name``
        (matched by correlation), or None when no work is matched."""
        corrs = {c for _, _, _, c, _ in self.launches_in(name)
                 if c is not None}
        total = sum(end - ts for ts, end, _, c in self.device if c in corrs)
        return total * 1e-6 if corrs and total > 0 else None


def _inside(ts, tid, spans):
    """Whether a span of ``spans`` (sorted by start, none nested in
    another of the same name) on thread ``tid`` covers ``ts``."""
    i = bisect.bisect_right(spans, (ts, math.inf)) - 1
    while i >= 0:
        s0, s1, _, stid = spans[i]
        if stid == tid:
            return s1 >= ts
        i -= 1
    return False


def load(path):
    with open(path) as f:
        raw = json.load(f)
    return Events(raw["traceEvents"] if isinstance(raw, dict) else raw)


def _merged(intervals):
    out = []
    for ts, end in sorted(intervals):
        if out and ts <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([ts, end])
    return out


def busy_intervals(ev):
    w0, w1 = ev.window
    return _merged((max(ts, w0), min(end, w1)) for ts, end, _, _ in ev.device
                   if end > w0 and ts < w1)


def busy_seconds(ev):
    """(seconds some device work ran inside the traced window, the
    window's seconds)."""
    busy = sum(b - a for a, b in busy_intervals(ev))
    w0, w1 = ev.window
    return busy * 1e-6, (w1 - w0) * 1e-6


def breakdown(ev):
    """{"device_ops": the device operations that took most time,
    "idle_gaps": the device's idle time by what the host was doing
    meanwhile}, [[name, seconds], ...] each, longest first."""
    w0, w1 = ev.window
    ops = collections.Counter()
    for ts, end, name, _ in ev.device:
        if end > w0 and ts < w1:
            ops[name] += (min(end, w1) - max(ts, w0)) * 1e-6
    busy = busy_intervals(ev)
    gaps = []
    edge = w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    threads = collections.Counter(t for _, _, _, t in ev.host)
    main = threads.most_common(1)[0][0] if threads else None
    host = sorted((ts, end, name) for ts, end, name, tid in
                  ev.host + [s for s in ev.spans if s[2] != WINDOW]
                  if tid == main)
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "(no host operation)"
        # the innermost host operation covering the gap's middle: the
        # latest to start of those still running
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - SCAN, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] += (b - a) * 1e-6
    return {"device_ops": [[n, s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}


class Context:
    """What a per-layer reader may read: the cell, the trace, the CUDA
    events' step times (ms) after the traced steps, and the train steps and
    seconds of that untraced rest of the window."""

    def __init__(self, cell, events, traced_steps, step_ms, rest_steps,
                 rest_seconds, device_name):
        self.cell = cell
        self.events = events
        self.traced_steps = traced_steps
        self.step_ms = step_ms
        self.rest_steps = rest_steps
        self.rest_seconds = rest_seconds
        self.device_name = device_name

    def peaks(self):
        return yardstick.peaks(self.device_name)

    def mfu_pct(self):
        """The model's train FLOPs of the untraced rest of the window over
        its seconds, as a share of the chips' bf16 dense peak."""
        if not self.rest_steps or self.rest_seconds <= 0:
            return None
        fam = self.cell.family
        flops = fam.step_flops(self.cell.config, self.cell.traffic) \
            * self.rest_steps * self.cell.chips
        return 100.0 * flops / self.rest_seconds / (
            self.cell.chips * self.peaks()["bf16"])

    def launches_per_step(self):
        steps = self.events.spans_named(STEP)
        if not steps:
            return None
        return len(self.events.launches_in(STEP)) / len(steps)

    def idle_pct(self):
        busy, window = busy_seconds(self.events)
        return 100.0 * (1.0 - busy / window) if window > 0 else None

    def roofline_pct(self, span, flops, nbytes):
        """The least time of ``flops`` and ``nbytes`` per traced step over
        the device time of the work launched inside the spans ``span``,
        per traced step, in %."""
        seconds = self.events.device_seconds_of(span)
        if seconds is None or not self.traced_steps:
            return None
        least = yardstick.roofline_seconds(flops, nbytes, self.peaks())
        return 100.0 * least / (seconds / self.traced_steps)
