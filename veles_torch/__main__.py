"""Command-line entry point of the PyTorch port.

    python -m veles_torch <workflow.py> [<config.py>] [root.x.y=v ...]
                          [-d cuda|cpu] [--seed N] [--result-file PATH]
                          [--dump-config]
                          [--snapshots DIR] [--checkpoint-every SECS]
                          [--snapshot FILE|auto|auto:DIR]
                          [--profile-dir DIR]
                          [--model-stats on|off] [--stats-interval N]
                          [--rollback-on-divergence]
                          [--graphics-dir DIR]
                          [--web-status PORT] [--trace-out PATH]
                          [--slo-config PATH]
                          [--export-inference DIR]
                          [--generate IDS | --generate-text PROMPT
                           [--gen-tokens N] [--gen-temperature T]]
    python -m veles_torch checkpoints <DIR|URL> [--json]
    python -m veles_torch serve --model NAME=DIR [...] [-d cuda|cpu]
    python -m veles_torch debug URL [--window SECS] [--trace-out PATH]

Counterpart of ``python -m veles`` for the samples ported so far: the
workflow module is imported first (its ``root`` defaults land), then the
config file (python mutating ``root``; a lone ``a.b=c`` in its place is
an override), then the dot-path overrides, then ``--seed`` re-seeds every
named generator; the module's ``create_workflow()`` is built and run by
the launcher (``launcher.py``): initialized on the device, resumed from
``--snapshot`` (a checkpoint file, or ``auto``: the newest checkpoint
that verifies in the ``--snapshots`` store, ``auto:DIR`` another store),
trained. ``--snapshots DIR`` links a snapshotter when the workflow has
none (improvement-gated checkpoints in the reference's format);
``--checkpoint-every SECS`` adds rolling ``current`` checkpoints. SIGTERM
stops the run before its next minibatch, writes a final ``current``
checkpoint and exits with code 75; ``--snapshot auto`` picks it up.
``--profile-dir DIR`` writes a ``torch.profiler`` trace of the run there.
The model-health plane is on: layer stats every ``--stats-interval``
(8) train steps, the loss of each epoch, a verdict stamped into every
checkpoint; ``--model-stats off`` turns it off (checkpoints stamped
``unknown``), ``--rollback-on-divergence`` restores the workflow's
rollback stash when the verdict reads ``diverged``.
``--graphics-dir DIR`` links the reference's standard plotters when the
workflow has none and can (``link_plotters``), and the launcher streams
their frames to a renderer process that writes ``DIR/<name>.png`` and
``DIR/plots.json`` (``graphics.py``, ``graphics_client.py``; no
plotting library needed).
``--web-status PORT`` serves the run's status dashboard (``web_status.py``:
``/``, ``/status.json``, the health probes, ``/metrics``, ``/debug/*``)
while it trains; ``--slo-config PATH`` loads SLO objectives into the
health monitor (``health.py``); ``--trace-out PATH`` starts the span
tracer before the workflow is initialized and dumps it (Chrome trace /
Perfetto JSON, ``telemetry.py``) when the run ends, also when it fails:
every class of an epoch is a ``torch.dispatch.<kind>`` span there.
Each finished epoch prints its summary line; the last line of standard
output is one JSON object with the decision history. The device is
``cuda`` unless ``-d cpu`` is given; asking for ``cuda`` on a host
without a card fails.

After training, ``--export-inference DIR`` writes the inference archive
(``contents.json`` + ``.npy``, the reference's format) and prints
``inference archive -> DIR``; ``--generate 1,2,3`` decodes
``--gen-tokens`` tokens from the trained LM (``znicz/generate.py``;
greedy, or sampled at ``--gen-temperature``) and prints ``generated:
...``; ``--generate-text "The "`` does the same from text through a
text-corpus LM's character vocabulary (``root.lm.loader.text_file``) and
prints the prompt with its continuation. These lines come before the
final JSON line.

``checkpoints DIR`` audits a snapshot store (a directory or an
``http(s)://`` base): every checkpoint with its manifest verdict (valid,
legacy, corrupt), slot, schema, health verdict and age, or ``--json``
rows; exit 1 when one is corrupt, 2 when the store cannot be read.
``serve`` is the reference's ``velescli serve`` on the port
(``serving/frontend.py``), on ``cuda`` unless ``-d cpu`` is given.
``debug URL`` reads the ``/debug/events`` and ``/debug/trace`` surfaces
of a live dashboard or serving frontend (exit 2 when unreachable). The
reference CLI's options the port has not ported raise
``NotImplementedError`` naming their ROADMAP item.
"""

import argparse
import importlib.util
import json
import logging
import os
import sys

import numpy

from veles_torch import prng, telemetry
from veles_torch.config import root
from veles_torch.launcher import Launcher
from veles_torch.snapshotter import scan_checkpoints
from veles_torch.znicz.generate import generate

#: the reference CLI's options not ported yet: (flag, argparse kwargs,
#: ROADMAP Queue 1 item)
UNPORTED = (
    ("--listen-address", {}, 10),
    ("--master-address", {}, 10),
    ("--slave-timeout", {"type": float}, 10),
    ("--slave-retries", {"type": int}, 10),
    ("--grad-codec", {}, 10),
    ("--grad-topk-percent", {"type": float}, 10),
    ("--stash-interval", {"type": int}, 10),
    ("--continual", {"type": int, "nargs": "?", "const": 0}, 6),
    ("--ensemble", {"type": int}, 13),
    ("--optimize", {}, 13),
    ("--workflow-graph", {}, 11),
    ("--dump-unit-sizes", {"action": "store_true"}, 11),
    ("--no-stats", {"action": "store_true"}, 11),
    ("--background", {"action": "store_true"}, 11),
    ("--log-file", {}, 11),
)


def build_argparser():
    p = argparse.ArgumentParser(
        prog="python -m veles_torch",
        description="Train a workflow of the PyTorch/CUDA port")
    p.add_argument("workflow", help="path to the workflow python module")
    p.add_argument("config", nargs="?", default=None,
                   help="python config file mutating root.*")
    p.add_argument("overrides", nargs="*", default=[],
                   help="root.x.y=value dot-path overrides")
    p.add_argument("-d", "--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--seed", type=int, default=None,
                   help="master seed for every named generator")
    p.add_argument("--result-file", default=None,
                   help="also write the final JSON here")
    p.add_argument("--dump-config", action="store_true",
                   help="print the effective config before running")
    p.add_argument("--snapshot", default=None,
                   help="checkpoint to resume from: a file, 'auto' (the "
                        "newest checkpoint that verifies in the --snapshots "
                        "store) or 'auto:DIR'")
    p.add_argument("--snapshots", default=None, metavar="DIR",
                   help="write improvement-gated checkpoints to DIR (links "
                        "a snapshotter when the workflow has none)")
    p.add_argument("--checkpoint-every", type=float, default=None,
                   metavar="SECS",
                   help="also write rolling 'current' checkpoints at the "
                        "first class boundary after every SECS seconds")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
    p.add_argument("--model-stats", choices=("on", "off"), default="on",
                   help="the model-health plane: layer stats, loss "
                        "z-score and the divergence verdict stamped into "
                        "checkpoints (off: the whole plane, checkpoints "
                        "stamped 'unknown')")
    p.add_argument("--stats-interval", type=int, default=None,
                   metavar="N",
                   help="take the layer stats every N train steps "
                        "(default 8)")
    p.add_argument("--rollback-on-divergence", action="store_true",
                   help="restore the rollback unit's last good weights "
                        "when the model-health verdict reads diverged")
    p.add_argument("--graphics-dir", default=None, metavar="DIR",
                   help="render the workflow's plots into DIR (links the "
                        "standard plotters when the workflow has none)")
    p.add_argument("--web-status", type=int, default=None, metavar="PORT",
                   help="serve the run's status dashboard on this port "
                        "(0 = pick a free one)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record spans from initialize on and write them "
                        "here as Chrome-trace/Perfetto JSON when the run "
                        "ends")
    p.add_argument("--slo-config", default=None, metavar="PATH",
                   help="JSON list of SLO objectives for the health "
                        "monitor (burn-rate alerts -> /readyz)")
    p.add_argument("--export-inference", default=None, metavar="DIR",
                   help="after the run, export the inference archive "
                        "(contents.json + .npy) to DIR")
    p.add_argument("--generate", default=None, metavar="IDS",
                   help="after the run, decode from the trained LM: "
                        "comma-separated prompt token ids (e.g. "
                        "'1,2,3'); prints the continuation")
    p.add_argument("--generate-text", default=None, metavar="PROMPT",
                   help="like --generate but with TEXT through the "
                        "loader's character vocabulary (text-corpus "
                        "LMs: root.lm.loader.text_file)")
    p.add_argument("--gen-tokens", type=int, default=32,
                   help="tokens to generate with --generate")
    p.add_argument("--gen-temperature", type=float, default=0.0,
                   help="sampling temperature for --generate "
                        "(0 = greedy)")
    for flag, kwargs, item in UNPORTED:
        p.add_argument(flag, default=None,
                       help="not ported yet (ROADMAP Queue 1 item %d)" % item,
                       **kwargs)
    return p


def refuse_unported(args):
    for flag, kwargs, item in UNPORTED:
        value = getattr(args, flag[2:].replace("-", "_"))
        if value is not None and value is not False:
            raise NotImplementedError(
                "%s is not ported yet (ROADMAP Queue 1 item %d)"
                % (flag, item))


def _log_to_stdout():
    """The ``veles_torch`` logger's own stdout handler (once)."""
    logger = logging.getLogger("veles_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False


def import_file(path, name=None):
    name = name or os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError("cannot import %s" % path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def checkpoints_main(argv):
    """``checkpoints DIR [--json]``: the store audit; -> the exit code (0,
    1 when a checkpoint is corrupt, 2 when the store cannot be read)."""
    import time
    p = argparse.ArgumentParser(
        prog="python -m veles_torch checkpoints",
        description="List checkpoints in a store with their manifest "
                    "verification status")
    p.add_argument("store", help="snapshot directory or http(s) base URL")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    args = p.parse_args(argv)
    try:
        infos = scan_checkpoints(args.store)
    except (OSError, ValueError) as exc:
        print("error: %s: %s" % (type(exc).__name__, exc), file=sys.stderr)
        return 2
    rows = []
    for info in infos:
        m = info.manifest or {}
        age = None
        if info.wall_time:
            age = round(time.time() - info.wall_time, 1)
        rows.append({"name": info.name, "status": info.status,
                     "slot": m.get("slot"), "schema": m.get("schema"),
                     "age_s": age, "error": info.error,
                     "verdict": info.health_verdict})
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        print("%-8s %-9s %-7s %-9s %12s  %s"
              % ("STATUS", "SLOT", "SCHEMA", "VERDICT", "AGE(s)", "NAME"))
        for r in rows:
            print("%-8s %-9s %-7s %-9s %12s  %s"
                  % (r["status"], r["slot"] or "-",
                     r["schema"] if r["schema"] is not None else "-",
                     r["verdict"] or "-",
                     r["age_s"] if r["age_s"] is not None else "-",
                     r["name"]))
            if r["error"]:
                print("         !! %s" % r["error"])
        print("%d checkpoint(s): %d valid, %d legacy, %d corrupt"
              % (len(rows), sum(r["status"] == "valid" for r in rows),
                 sum(r["status"] == "legacy" for r in rows),
                 sum(r["status"] == "corrupt" for r in rows)))
    return 1 if any(r["status"] == "corrupt" for r in rows) else 0


def debug_main(argv):
    """``debug URL``: fetch the flight-recorder surfaces of a live
    process, ``/debug/events`` as a table (or ``--json``) and
    ``/debug/trace`` (saved with ``--trace-out``); -> 0, or 2 when the
    endpoint is unreachable or answers another shape."""
    import time
    import urllib.request
    p = argparse.ArgumentParser(
        prog="python -m veles_torch debug",
        description="Postmortem view of a live dashboard or serving "
                    "process through its /debug endpoints")
    p.add_argument("url", help="base URL of a --web-status dashboard or "
                               "serving frontend (http://host:port)")
    p.add_argument("--window", type=float, default=None, metavar="SECS",
                   help="trace window to fetch (default: the recorder's "
                        "whole retained window)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the Perfetto JSON trace window here")
    p.add_argument("--json", action="store_true",
                   help="print the raw events JSON instead of the table")
    args = p.parse_args(argv)
    base = args.url.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    trace_url = base + "/debug/trace"
    if args.window is not None:
        trace_url += "?window=%g" % args.window
    try:
        with urllib.request.urlopen(base + "/debug/events",
                                    timeout=10) as resp:
            events = json.load(resp)["events"]
        with urllib.request.urlopen(trace_url, timeout=10) as resp:
            trace = json.load(resp)
        if not isinstance(events, list) \
                or not all(isinstance(e, dict)
                           and isinstance(e.get("wall", 0.0), (int, float))
                           for e in events) \
                or not isinstance(trace, dict) \
                or not isinstance(trace.get("traceEvents", []), list) \
                or not all(isinstance(e, dict)
                           for e in trace.get("traceEvents", [])):
            raise ValueError("endpoint answered 200 but not the /debug "
                             "payload shape")
    except (OSError, ValueError, KeyError, TypeError) as exc:
        print("error: %s: %s" % (type(exc).__name__, exc), file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(events, indent=2))
    else:
        print("%-12s %-20s %s" % ("AGE(s)", "EVENT", "FIELDS"))
        now = time.time()
        for ev in events:
            fields = " ".join("%s=%s" % (k, v) for k, v in sorted(ev.items())
                              if k not in ("wall", "event"))
            print("%-12s %-20s %s" % (round(now - ev.get("wall", now), 1),
                                      ev.get("event", "?"), fields))
        print("%d event(s)" % len(events))
    spans = sum(1 for e in trace.get("traceEvents", ()) if e.get("ph") == "X")
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        print("trace window (%d span(s)) -> %s" % (spans, args.trace_out))
    else:
        print("trace window holds %d span(s); re-run with --trace-out PATH "
              "to save the Perfetto JSON" % spans)
    return 0


def main(argv=None):
    """Run the CLI; -> the trained workflow (the exit code for
    ``checkpoints``, ``serve`` and ``debug``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "checkpoints":
        return checkpoints_main(argv[1:])
    if argv and argv[0] == "serve":
        from veles_torch.serving.frontend import serve_main
        _log_to_stdout()
        return serve_main(argv[1:])
    if argv and argv[0] == "debug":
        return debug_main(argv[1:])
    args = build_argparser().parse_intermixed_args(argv)
    refuse_unported(args)
    prompt = None
    if args.generate:
        try:
            prompt = numpy.array(
                [[int(t) for t in args.generate.split(",")]], numpy.int32)
        except ValueError:
            raise SystemExit("--generate: expected comma-separated integer "
                             "token ids, got %r" % args.generate)
    _log_to_stdout()
    module = import_file(args.workflow, "veles_torch_workflow_module")
    # a lone "a.b=c" positional is an override, not a config file
    if args.config and "=" in args.config \
            and not os.path.exists(args.config):
        args.overrides.insert(0, args.config)
        args.config = None
    if args.config:
        import_file(args.config, "veles_torch_config_module")
    for override in args.overrides:
        root.apply_override(override)
    if args.seed is not None:
        prng.seed_all(args.seed)
    if args.dump_config:
        json.dump(root.to_dict(), sys.stderr, indent=2, sort_keys=True,
                  default=str)
        print(file=sys.stderr)
    wf = module.create_workflow()
    if args.generate_text and not hasattr(wf.loader, "encode"):
        raise SystemExit("--generate-text needs a text-corpus loader "
                         "(root.lm.loader.text_file)")
    if args.graphics_dir and not wf.plotters \
            and hasattr(wf, "link_plotters"):
        wf.link_plotters(out_dir=args.graphics_dir)
    if args.snapshots and wf.snapshotter is None:
        wf.link_snapshotter(directory=args.snapshots)
    launcher = Launcher(device=args.device, snapshot=args.snapshot,
                        checkpoint_every=args.checkpoint_every,
                        profile_dir=args.profile_dir,
                        model_stats=args.model_stats != "off",
                        stats_interval=args.stats_interval,
                        rollback_on_divergence=args.rollback_on_divergence,
                        graphics_dir=args.graphics_dir,
                        web_status_port=args.web_status,
                        slo_config=args.slo_config)
    if args.trace_out:
        # from before initialize on, dumped in the finally: a failed
        # run's spans are the postmortem the trace is for
        telemetry.tracer.start()
    try:
        launcher.initialize(wf)
        if args.generate_text:
            try:
                prompt = wf.loader.encode(args.generate_text)
            except ValueError as exc:
                raise SystemExit("--generate-text: %s" % exc)
        launcher.run()
    finally:
        launcher.close()
        if args.trace_out:
            telemetry.tracer.stop()
            try:
                telemetry.tracer.dump(args.trace_out)
                print("trace -> %s" % args.trace_out, flush=True)
            except OSError as exc:
                print("trace dump failed: %s" % exc, file=sys.stderr)
    if args.export_inference:
        wf.export_inference(args.export_inference)
        print("inference archive -> %s" % args.export_inference, flush=True)
    if prompt is not None:
        out = generate(wf, prompt, args.gen_tokens,
                       temperature=args.gen_temperature)
        if args.generate_text:
            text = args.generate_text + wf.loader.decode(out[0])
            print("generated: %s" % text, flush=True)
        else:
            print("generated: %s" % ",".join(str(t) for t in
                                             out[0].tolist()), flush=True)
    result = {"workflow": wf.name, "device": str(wf.device.device),
              "history": wf.decision.history,
              "best_metric": float(wf.decision.best_metric)}
    if args.result_file:
        with open(args.result_file, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return wf


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
