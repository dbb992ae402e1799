"""One run of one benchmark cell: set-up, the measured window, the check.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its correctness limits are in
``workloads/<cell>.json``, and the configuration's ``family`` names the
module (``families/<family>.py``) that maps both onto the program and
the plain reference (``reference/<family>.py``). Nothing here names a
cell.

A run builds the workflow that ``python -m veles_torch <model file> -d
cuda`` builds (the CLI's own ``run_workflow``, with its default
options), with the data and parameters made from the seed. Set-up then
drives the run's own epoch loop through its first train steps: the first
minibatch of each signature (the cost counter's), and the train steps
the first check reads (the loss of each, the solver's velocity after the
first, the parameters after the last). The window runs the same
workflow's ``run`` epoch after epoch until ``--seconds`` have passed,
stopping through the step's ``stop_requested`` between minibatches, and
ends when the card has finished. A traced run profiles the window's first
``trace_steps`` train steps and times the rest with CUDA events.

Once the window has closed, the same ``run`` takes three more train
steps, the second check: the state they start from (parameters,
velocities, the units' generator states) is kept, and the rows the
loader gathers for them are recorded. Then the program's state is freed
and the reference trains twice: from the seed's inputs through set-up's
rows (the start), and from the kept state through the recorded rows
(the steady state the window ran in); :mod:`compare` holds the program
to both.
"""

import gc
import importlib
import json
import math
import os
import subprocess
import sys
import time
import types

import compare
import inputs

HERE = os.path.dirname(os.path.abspath(__file__))
#: train steps whose readings the check compares
CHECK_STEPS = 3
#: top-level module names the measured process may not hold: JAX and the
#: JAX package the program was ported from (compared as whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "veles")


class Check:
    """The readings of :data:`CHECK_STEPS` train steps from a known state:
    the parameters ``params0`` ({leaf: tensor}) and velocities ``vel0``
    (None: zeros), the units' generator ``states`` and the ``rows``
    gathered (set once the steps are done; None where the reference works
    the rows and states out from the seed)."""

    def __init__(self, params0, vel0=None, states=None):
        self.params0 = params0
        self.vel0 = vel0
        self.states = states
        self.rows = None
        self.losses = []
        self.grad_norms = None
        self.update_norms = None


class Cell:
    """A benchmark cell: its configuration, traffic, limits and family."""

    def __init__(self, name, config, traffic, limits, chips, family):
        self.name = name
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.chips = chips
        self.family = family


def _load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(bench, name):
    """The cell ``name`` of the parsed ``BENCHMARK.json`` ``bench``, its
    files found by the names it gives."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    config = _load_json("configs", entry["config"] + ".json")
    traffic = _load_json("traffic", entry["traffic"] + ".json")
    cell_file = _load_json("workloads", name + ".json")
    family = importlib.import_module("families." + config["family"])
    if int(traffic["n_train"]) % int(traffic["minibatch_size"]):
        raise ValueError("%s: n_train is not a whole number of minibatches"
                         % name)
    return Cell(name, config, traffic, cell_file["limits"],
                int(entry["chips"]), family)


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(torch, chips):
    name = torch.cuda.get_device_name(0)
    info = {"platform": "gpu", "kind": name, "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


class Run:
    """The state of one run: the wrappers it puts around the step, what
    they record, and the window's clock."""

    def __init__(self, cell, seconds, trace, device, out_dir):
        import torch
        self.torch = torch
        self.cell = cell
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.cuda = device.startswith("cuda")
        self.out_dir = out_dir
        self.wf = None
        self.leaves = None
        # the check in progress: set-up's (from the seed), then the one
        # after the window (from the state the window left)
        self.check = None
        self.readings = {}
        self.late = None
        self.memory_peak = 0
        # the window
        self.phase = "setup"
        self.deadline = None
        self.t_window = None
        self.t_end = None
        self.train_steps = 0
        self.step_metrics = []
        self.prof = None
        self.traced_steps = 0
        self.t_after_trace = None
        self.after_trace_steps = 0
        self.step_events = []
        self.annotate = None

    # -- the step's wrappers ------------------------------------------------

    def wrap(self, wf):
        step = wf.step
        train, evaluate, run = step.train_minibatch, step.eval_minibatch, \
            wf.run
        one, gather = step._minibatch, step.gather

        def train_minibatch(data, target, valid):
            if self.phase == "late" and self.check is None:
                self.check = self.snapshot()
            if self.phase == "after_trace" and self.cuda:
                ev = self.torch.cuda.Event(enable_timing=True)
                ev.record()
                self.step_events.append(ev)
            metrics = train(data, target, valid)
            self.after_train(step, metrics)
            return metrics

        def minibatch(*args):
            # (step, fetch, train, ...): the whole minibatch, its gather
            # and its metrics row included
            if self.phase == "trace" and args[2]:
                with self.torch.profiler.record_function("bench.train_step"):
                    return one(*args)
            return one(*args)

        def gathered(full, idx, train):
            # the rows of the check's steps after the window
            if self.phase == "late" and train:
                self.late_rows.append(idx.detach().clone())
            return gather(full, idx, train)

        def eval_minibatch(data, target, valid):
            metrics = evaluate(data, target, valid)
            if self.phase == "after_trace":
                self.step_events.append(None)      # a break between steps
            self.check_deadline(step)
            return metrics

        def timed_run():
            out = run()
            self.sync()
            self.t_end = time.perf_counter()
            if self.phase == "trace":
                self.end_trace()
            if self.cuda:
                self.memory_peak = self.torch.cuda.max_memory_allocated()
            self.late_check(run)
            return out

        step.train_minibatch = train_minibatch
        step.eval_minibatch = eval_minibatch
        step._minibatch = minibatch
        step.gather = gathered
        wf.run = timed_run

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def after_train(self, step, metrics):
        if self.phase in ("setup", "late"):
            self.check_step(step, metrics)
            return
        self.train_steps += 1
        self.step_metrics.append(metrics)
        if self.phase == "trace":
            self.traced_steps += 1
            if self.traced_steps >= int(self.cell.traffic["trace_steps"]):
                self.end_trace()
        elif self.phase == "after_trace":
            self.after_trace_steps += 1
        self.check_deadline(step)

    def check_step(self, step, metrics):
        """A check's train steps: its readings, then a stop. The first
        gradient is ``(moment·vel0 − vel1) / lr``; its norm is divided by
        the rate in :meth:`readings_of`."""
        torch = self.torch
        c = self.check
        k = len(c.losses)
        c.losses.append(metrics[0].detach().clone())
        if k == 0:
            vel = [getattr(gd, "vel_" + attr)
                   for _, _, attr, gd in self.leaves]
            if c.vel0 is not None:
                vel = [v - self.rates[name][1] * c.vel0[name]
                       for v, (name, _, _, _) in zip(vel, self.leaves)]
            c.grad_norms = torch.stack(torch._foreach_norm(vel))
        if k == CHECK_STEPS - 1:
            now = [getattr(unit, attr) for _, unit, attr, _ in self.leaves]
            before = [c.params0[name] for name, _, _, _ in self.leaves]
            c.update_norms = torch.stack(torch._foreach_norm(
                torch._foreach_sub(now, before)))
            step.stop_requested = True

    def readings_of(self, c):
        """A finished check's readings as the comparison takes them."""
        if len(c.losses) < CHECK_STEPS:
            raise RuntimeError("the check ran %d train steps of %d"
                               % (len(c.losses), CHECK_STEPS))
        return {"losses": self.torch.stack(c.losses).tolist(),
                "grad_norms": [v / self.rates[name][0] for v, (
                    name, _, _, _) in zip(c.grad_norms.tolist(),
                                          self.leaves)],
                "update_norms": c.update_norms.tolist()}

    def snapshot(self):
        """The check after the window: the state its first step starts
        from (a float32 copy of each leaf and velocity, the units'
        generator states)."""
        params, vel = {}, {}
        for name, unit, attr, gd in self.leaves:
            params[name] = getattr(unit, attr).detach().float().clone()
            vel[name] = getattr(gd, "vel_" + attr).detach().float().clone()
        return Check(params, vel, self.cell.family.unit_states(self.wf))

    def late_check(self, run):
        """Three more train steps through the window's own ``run``, once
        the window has closed: the epoch in flight starts again (its
        validation class first) and the check stops it."""
        self.phase = "late"
        self.check, self.late_rows = None, []
        self.wf.step.stop_requested = False
        run()
        self.sync()
        if self.check is None:
            raise RuntimeError("no train step ran after the window")
        self.readings["late"] = self.readings_of(self.check)
        self.check.rows = [r.cpu().numpy() for r in self.late_rows]
        self.late, self.check, self.late_rows = self.check, None, None

    def check_deadline(self, step):
        if self.phase in ("window", "trace", "after_trace") \
                and time.perf_counter() >= self.deadline:
            step.stop_requested = True

    # -- tracing ------------------------------------------------------------

    def start_trace(self):
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.annotate = torch.profiler.record_function("bench.traced_window")
        self.annotate.__enter__()
        self.phase = "trace"

    def end_trace(self):
        self.sync()
        self.annotate.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.t_after_trace = time.perf_counter()
        self.phase = "after_trace"

    # -- set-up and the window ------------------------------------------------

    def before_run(self, wf, params, sd):
        """The CLI's hook once the workflow is initialized: hand the
        program the benchmark's inputs, run set-up's train steps through
        the epoch loop, and open the window."""
        torch = self.torch
        fam = self.cell.family
        self.wf = wf
        self.leaves = fam.install(wf, params, sd, self.cell.config)
        self.rates = fam.hyper(self.cell.config)
        self.check = Check(params)
        self.wrap(wf)
        if self.trace:
            wrap_units(self, wf)
        wf.step.run_epoch(wf._after_decision)
        self.readings["start"] = self.readings_of(self.check)
        self.check = None
        wf.step.stop_requested = False
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.t_window = time.perf_counter()
        self.deadline = self.t_window + self.seconds
        if self.trace:
            self.start_trace()
        else:
            self.phase = "window"


def wrap_units(run, wf):
    """Spans, from the benchmark's own code, around the calls whose kernels
    the per-layer readers time: every attention unit's forward and GD
    call (``attn``), and every bias-gradient sum (``bias_grad``)."""
    record = run.torch.profiler.record_function

    def spanned(fn, name):
        def call(*a, **kw):
            if run.phase != "trace":
                return fn(*a, **kw)
            with record(name):
                return fn(*a, **kw)
        return call

    for fwd, gd in zip(wf.forwards, wf.gds):
        if type(fwd).MAPPING == "attention":
            fwd.forward = spanned(fwd.forward, "bench.attn")
            gd.run = spanned(gd.run, "bench.attn")
    from veles_torch.znicz.ops import bias_grad as bg
    original = bg.bias_grad
    for mod in list(sys.modules.values()):
        if mod is not bg \
                and getattr(mod, "__name__", "").startswith("veles_torch.") \
                and getattr(mod, "bias_grad", None) is original:
            mod.bias_grad = spanned(original, "bench.bias_grad")


def free_program(run):
    """Drop every reference the benchmark holds to the program's state and
    return the card's memory to the allocator's pool."""
    torch = run.torch
    run.wf = run.leaves = run.step_metrics = None
    gc.collect()
    if run.cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_readings(cell, seed, device, precision="f32", half=False,
                       late=None):
    """The reference's readings, from the inputs made again from
    ``seed``: over set-up's first train rows from the seed's parameters,
    or, given the :class:`Check` ``late``, over its rows from its kept
    state. ``precision`` and ``half`` make the control and the planted
    fault."""
    from reference.common import Precision
    from reference.common import train_readings
    fam = cell.family
    params, data, sd = fam.make_inputs(cell.config, cell.traffic, seed,
                                       device)
    vel0 = states = None
    if late is None:
        rows = inputs.train_rows(cell.traffic, sd["shuffle"], CHECK_STEPS)
    else:
        params, vel0, rows, states = late.params0, late.vel0, late.rows, \
            late.states
    batches = fam.reference_batches(data, rows, device, cell.config, sd,
                                    states)
    out = train_readings(params, batches,
                         fam.reference_loss(cell.config,
                                            Precision(precision), half),
                         fam.hyper(cell.config), vel0)
    names = [name for name, _, _, _, _ in
             importlib.import_module("reference." + cell.config["family"])
             .leaves(cell.config["model"])]
    return {"losses": out["losses"],
            "grad_norms": [out["grad_norms"][n] for n in names],
            "update_norms": [out["update_norms"][n] for n in names]}


def both_checks(cell, seed, device, late, **kw):
    """{"start", "late"}: the reference's readings of both checks (the
    control's or the fault's, given ``kw``)."""
    return {"start": reference_readings(cell, seed, device, **kw),
            "late": reference_readings(cell, seed, device, late=late, **kw)}


def check_numbers(readings, ref):
    """The compared numbers of ``readings`` against ``ref`` (each
    {"start", "late"}): the start's under their own names, the second
    check's with ``late_`` before them."""
    out = compare.numbers(readings["start"], ref["start"])
    out.update(("late_" + k, v) for k, v in
               compare.numbers(readings["late"], ref["late"]).items())
    return out


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None,
             out_dir=None, fault=None, controls=False):
    """One run of ``cell``; -> the result dict (the last line's keys, and
    ``check`` last). ``fault`` (a test's) is called with the workflow
    once it is initialized, to break the timed path underneath.
    ``controls`` (the calibration's) adds ``calibration``: the numbers
    that the fp8 control and the half-batch fault, each put in the
    program's place, read against the reference."""
    import torch
    t_start = time.time() if t_start is None else t_start
    from veles_torch import __main__ as cli
    from veles_torch import prng
    from veles_torch.config import root
    fam = cell.family
    if device.startswith("cuda"):
        from veles_torch import kernels
        kernels.build()
    prng.seed_all(int(seed))
    module = importlib.import_module(fam.MODEL_MODULE)
    fam.configure(root, cell.config, cell.traffic)
    params, data, sd = fam.make_inputs(cell.config, cell.traffic, seed,
                                       device)
    shim = types.SimpleNamespace(
        create_workflow=lambda: fam.attach(module.create_workflow(), data,
                                           cell.traffic))
    args = cli.build_argparser().parse_intermixed_args(
        [fam.MODEL_FILE, "-d", device])
    run = Run(cell, seconds, trace, device, out_dir)

    def before_run(wf):
        if fault is not None:
            fault(wf)
        run.before_run(wf, params, sd)

    cli.run_workflow(args, shim, before_run=before_run)
    shim = params = data = None
    setup_s = (run.t_window - time.perf_counter()) + time.time() - t_start
    window_s = run.t_end - run.t_window
    memory_peak = run.memory_peak
    metrics_rows = torch.stack(run.step_metrics).cpu() \
        if run.step_metrics else torch.zeros((0, 4))
    failed = int((~torch.isfinite(metrics_rows[:, 0])).sum())
    traced = None
    if trace:
        traced = read_trace(run)
    free_program(run)
    ref = both_checks(cell, seed, device, run.late)
    numbers = check_numbers(run.readings, ref)
    check = compare.verdict(numbers, cell.limits)
    correct = all(v["ok"] for v in check.values()) and failed == 0
    result = {"correct": correct, "attempted": run.train_steps,
              "failed": failed}
    units = fam.units_per_sample(cell.traffic)
    per_step = int(cell.traffic["minibatch_size"]) * units * cell.chips
    if trace:
        result["metrics"] = traced.pop("metrics")
    else:
        result["metrics"] = {
            fam.RATE: {"value": run.train_steps * per_step / window_s,
                       "unit": fam.UNIT},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = device_info(torch, cell.chips) if run.cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    result["device"]["memory_peak_bytes"] = int(memory_peak)
    if trace:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["check"] = {k: {"value": _number(v["value"]),
                           "limit": _number(v["limit"])}
                       for k, v in check.items()}
    result["window_s"] = window_s
    result["losses"] = {k: {"program": run.readings[k]["losses"],
                            "reference": ref[k]["losses"]} for k in ref}
    if controls:
        result["calibration"] = {
            name: check_numbers(both_checks(cell, seed, device, run.late,
                                            **kw), ref)
            for name, kw in (("control", {"precision": "fp8"}),
                             ("half_batch", {"half": True}))}
    return result


def read_trace(run):
    """The traced run's per-layer metrics, device busy time and breakdown
    from the profiler's trace and the CUDA events after it."""
    import tracefile as tr
    torch = run.torch
    os.makedirs(run.out_dir, exist_ok=True)
    path = os.path.join(run.out_dir, "trace.json")
    run.prof.export_chrome_trace(path)
    events = tr.load(path)
    ms = []
    evs = run.step_events
    for a, b in zip(evs, evs[1:]):
        if a is not None and b is not None:
            ms.append(a.elapsed_time(b))
    after_s = run.t_end - run.t_after_trace
    ctx = tr.Context(run.cell, events, run.traced_steps, ms,
                     run.after_trace_steps, after_s,
                     torch.cuda.get_device_name(0) if run.cuda else "cpu")
    metrics = {}
    for m in per_layer_metrics(run.cell):
        value = load_reader(m["name"]).read(ctx)
        if value is None:
            print("per-layer metric %s read nothing in this run" % m["name"],
                  file=sys.stderr, flush=True)
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy, window = tr.busy_seconds(events)
    return {"metrics": metrics, "busy_s": busy, "window_s": window,
            "breakdown": tr.breakdown(events)}


def per_layer_metrics(cell):
    """The ``per_layer`` entries of ``BENCHMARK.json`` that this cell
    reports: those listing it, or with no list, those moving an
    end-to-end metric the cell reports."""
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        bench = json.load(f)
    rate = cell.family.RATE
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cells is not None and cell.name in cells) \
                or (cells is None and m["moves"] == rate):
            out.append(m)
    return out


def load_reader(name):
    """The reader ``metrics/<name>.py`` (its file name is the metric's
    name, dots and all)."""
    import importlib.util
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _number(x):
    """``x``, or None where it is not finite (JSON has no infinity)."""
    return x if math.isfinite(x) else None


def emit(result):
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, v in result.get("losses", {}).items():
        print("losses %s program %s reference %s" % (
            name, v["program"], v["reference"]), file=sys.stderr)
    for name, v in result["check"].items():
        print("check %s %s limit %s" % (name, v["value"], v["limit"]),
              file=sys.stderr, flush=True)
    out = {k: result[k] for k in ("correct", "attempted", "failed",
                                  "metrics", "device")}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["check"] = result["check"]
    print(json.dumps(out), flush=True)
