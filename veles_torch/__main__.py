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
                          [--ensemble N | --optimize GENSxPOP[xWORKERS]]
                          [--listen-address HOST:PORT |
                           --master-address HOST:PORT]
                          [--slave-timeout SECS] [--slave-retries N]
                          [--grad-codec none|bf16|int8|topk]
                          [--grad-topk-percent P] [--stash-interval N]
                          [--transport nccl|gloo-host]
                          [--workflow-graph PATH] [--dump-unit-sizes]
                          [--no-stats] [--background [--log-file PATH]]
    python -m veles_torch checkpoints <DIR|URL> [--json]
    python -m veles_torch serve --model NAME=DIR [...] [-d cuda|cpu]
    python -m veles_torch debug URL [--window SECS] [--trace-out PATH]
    python -m veles_torch top URL [URL...] [--interval S|--once|--json]
    python -m veles_torch profile URL [--seconds N] [--hz H] [--out PATH]

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
``/``, ``/status.json``, the health probes, ``/metrics`` with the
``veles_step_*`` families of ``perf.py``, ``/debug/*`` with
``/debug/profile`` and ``/debug/critical_path`` of ``profiling.py``)
while it trains; ``--slo-config PATH`` loads SLO objectives into the
health monitor (``health.py``); ``--trace-out PATH`` starts the span
tracer before the workflow is initialized and dumps it (Chrome trace /
Perfetto JSON, ``telemetry.py``) when the run ends, also when it fails:
every class of an epoch is a ``torch.dispatch.<kind>`` span there.
Each finished epoch prints its summary line; the last line of standard
output is one JSON object with the decision history. The run's per-unit
timing table (``print_stats``) goes to standard error at its end unless
``--no-stats`` is given; ``--dump-unit-sizes`` prints the tensor bytes
each unit holds after initialize (``print_unit_sizes``, to standard
error); ``--workflow-graph PATH`` writes the workflow's unit graph as
graphviz dot (``generate_graph``) and exits without running it;
``--background`` detaches (a double fork), prints ``{"daemon_pid": N}``
and returns at once, the daemon appending its output to ``--log-file``
(default /dev/null). The device is
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

``--ensemble N`` trains N members of the workflow, member ``i`` after
``prng.seed_all(base + i)`` (base: ``--seed``, else 1000), and prints
their validation errors and the error of their mean output
(``ensemble.py``). ``--optimize GENSxPOP`` runs the genetic search over
every ``Tune`` leaf of the config (``genetics.py``; POP defaults to 12),
each individual one training run in this process through the launcher,
after ``prng.seed_all(seed)`` (``--seed``, else 1); ``GENSxPOPxWORKERS``
evaluates each generation in WORKERS spawned processes
(``ProcessPoolMap``, ``SubprocessTrainer``), which share the card; the
kernels are built once before they start. Both print the reference's
report as the last line of standard output (``ensemble_error``,
``member_errors``, ``n_valid``; ``best_fitness``, ``best_values``,
``evaluations`` and, with workers, ``workers``) and write it to
``--result-file``. The inner runs of ``--optimize`` write no result
file, export, plots or dashboard.

The master/slave mode (``launcher.py``, ``server.py``, ``client.py``):
``--listen-address HOST:PORT`` runs a master that owns the canonical
weights on the host and the job queue and never computes (no CUDA);
``--master-address HOST:PORT`` runs a slave that pulls minibatch jobs,
trains them on the device and pushes deltas. The wire is the
reference's, so either package's slaves work under either package's
master. A non-loopback address needs ``$VELES_CLUSTER_SECRET`` set to
the same value on every node. ``--slave-timeout`` bounds a silent slave
(master), ``--slave-retries N`` the consecutive reconnects of a slave (0:
forever), ``--grad-codec`` / ``--grad-topk-percent`` pick the gradient
wire codec (the master's wins), ``--stash-interval N`` the merges between
the master's rollback stashes (``--rollback-on-divergence``). The master's
result line adds ``cluster`` (its status: slaves, faults) and
``wire_bytes``; a slave's adds ``slave`` (jobs, reconnects, the codec)
and ``launches``, the hand-written kernels' launch counts in that
process. ``--optimize GENSxPOP --listen-address HOST:PORT`` farms the
genetic search's individuals out to registered slaves, which run
``--optimize slave --master-address HOST:PORT`` (``genetics.py``'s
``GATaskServer`` and ``ga_slave_loop``); a GA slave's last line holds
``ga_slave_tasks`` and its ``launches``.

A workflow module with ``parallel_ranks()`` (the LM: ``root.lm.parallel``
with ``data``, ``seq`` or ``model`` above 1) runs as that many ranks,
one process each (``veles_torch/znicz/parallel``). Without ``RANK`` and
``WORLD_SIZE`` in the environment the CLI builds the kernels once (on
the card) and spawns the ranks itself on a free localhost port; under a
``torchrun``-style environment it joins as one rank. The transport is
declared, never swapped: ``-d cpu`` takes gloo; on the card
``--transport nccl`` (the default) needs one card per rank, and
``--transport gloo-host`` lets the ranks share a card, the collectives
copying through the host. Rank 0 prints the epoch lines and the result
line, which gains ``parallel`` (the mesh, the transport, the last train
step's ``collective_counts``, ``grad_sync_bytes`` and the collectives'
bytes and host seconds), and writes the snapshots and the inference
archive (TP's shards gathered into the full tensors); the other ranks
print nothing and exit 0. A rank
that fails fails the run with its error text; the others are torn down
within seconds. ``--generate``, ``--ensemble``, ``--optimize`` and the
master/slave roles do not combine with the parallel axes.

``checkpoints DIR`` audits a snapshot store (a directory or an
``http(s)://`` base): every checkpoint with its manifest verdict (valid,
legacy, corrupt), slot, schema, health verdict and age, or ``--json``
rows; exit 1 when one is corrupt, 2 when the store cannot be read.
``serve`` is the reference's ``velescli serve`` on the port
(``serving/frontend.py``), on ``cuda`` unless ``-d cpu`` is given.
``debug URL`` reads the ``/debug/events`` and ``/debug/trace`` surfaces
of a live dashboard or serving frontend (exit 2 when unreachable).
``top URL...`` renders a live dashboard of N such targets, or one frame
(``--once``) or snapshot document (``--json``) of them (``fleet.py``;
exit 2 when none is reachable); ``profile URL`` captures a sampling
profile off one (``/debug/profile``) and prints its per-thread summary,
or saves the speedscope JSON (``--out``; exit 2 when unreachable or
garbled).
"""

import argparse
import gc
import importlib.util
import json
import logging
import os
import sys

import numpy

from veles_torch import model_health, prng, telemetry
from veles_torch.config import root
from veles_torch.launcher import Launcher, rank_main
from veles_torch.snapshotter import scan_checkpoints
from veles_torch.znicz.generate import generate


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
    p.add_argument("--ensemble", type=int, default=None, metavar="N",
                   help="train N members under consecutive seeds and "
                        "report the ensemble's and each member's "
                        "validation error")
    p.add_argument("--optimize", default=None, metavar="GENSxPOP[xWORKERS]",
                   help="genetic search over the config's Tune leaves: "
                        "GENS generations of POP individuals (default "
                        "12), in WORKERS spawned processes when given")
    p.add_argument("--continual", type=int, nargs="?", const=0,
                   default=None, metavar="ROUNDS",
                   help="continual training: run the workflow over its "
                        "(streaming) loader in rounds of max_epochs, "
                        "reopening the decision between rounds, until "
                        "interrupted, or for ROUNDS rounds; checkpoints "
                        "carry the ingest wall time, so serving "
                        "staleness is measurable end to end")
    p.add_argument("--workflow-graph", default=None, metavar="PATH",
                   help="write the unit DAG as graphviz dot and exit")
    p.add_argument("--dump-unit-sizes", action="store_true",
                   help="print per-unit tensor footprints after "
                        "initialize")
    p.add_argument("--no-stats", action="store_true",
                   help="skip the per-unit timing report")
    p.add_argument("--background", action="store_true",
                   help="daemonize before running: fork, detach from "
                        "the terminal (setsid), redirect stdio to "
                        "--log-file (default /dev/null), print the "
                        "daemon pid and return immediately")
    p.add_argument("--log-file", default=None, metavar="PATH",
                   help="with --background: append stdout/stderr here")
    p.add_argument("--listen-address", default=None, metavar="HOST:PORT",
                   help="run as the master of the master/slave mode "
                        "(weights and job queue on the host, no compute)")
    p.add_argument("--master-address", default=None, metavar="HOST:PORT",
                   help="run as a slave of the master at HOST:PORT")
    p.add_argument("--slave-timeout", type=float, default=None,
                   metavar="SECS",
                   help="master modes: drop a silent slave and requeue its "
                        "work after SECS (default 60 for training, 3600 "
                        "for the genetic search)")
    p.add_argument("--slave-retries", type=int, default=None, metavar="N",
                   help="slave mode: give up after N consecutive failed "
                        "reconnects (0 = retry forever; default 8)")
    p.add_argument("--grad-codec", default=None,
                   choices=("none", "bf16", "int8", "topk"),
                   help="gradient wire codec of the master/slave sync "
                        "(negotiated at hello; the master's wins)")
    p.add_argument("--grad-topk-percent", type=float, default=None,
                   metavar="P",
                   help="--grad-codec topk: the percent of delta entries "
                        "shipped (default 1.0)")
    p.add_argument("--transport", default=None, choices=("nccl", "gloo-host"),
                   help="the collectives of a parallel run on the card: "
                        "nccl (default; one card per rank) or gloo-host "
                        "(ranks sharing a card; copies through the host)")
    p.add_argument("--stash-interval", type=int, default=None,
                   metavar="N",
                   help="master mode, with --rollback-on-divergence: "
                        "refresh the rollback stash every Nth merge "
                        "(default 1)")
    return p


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


def daemonize(log_file=None):
    """Classic double-fork detach (``--background``): the caller's
    process prints the daemon pid and returns False; the grandchild
    returns True and runs the workflow with stdin from /dev/null and
    stdout/stderr appended to ``log_file`` (default /dev/null). Called
    before CUDA or any thread starts."""
    pid = os.fork()
    if pid > 0:
        # wait for the intermediate child so it never zombifies, then
        # report the daemon from the original foreground process
        os.waitpid(pid, 0)
        return False
    os.setsid()
    pid2 = os.fork()
    if pid2 > 0:
        print(json.dumps({"daemon_pid": pid2}), flush=True)
        os._exit(0)
    sys.stdout.flush()
    sys.stderr.flush()
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)
    os.close(devnull)
    out = os.open(log_file, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                  0o644) if log_file else os.open(os.devnull,
                                                  os.O_WRONLY)
    os.dup2(out, 1)
    os.dup2(out, 2)
    os.close(out)
    return True


def profile_main(argv):
    """``profile URL``: capture a sampling-profiler window off a LIVE
    process through ``GET /debug/profile`` and either save the speedscope
    JSON (``--out``) or print a per-thread summary of the hottest
    functions; -> 0, or 2 when the endpoint is unreachable or answers
    something that is not a speedscope document (as ``debug``)."""
    import urllib.request
    p = argparse.ArgumentParser(
        prog="python -m veles_torch profile",
        description="Sampling CPU profile of a live master/serving "
                    "process via its /debug/profile endpoint "
                    "(profiling.py)")
    p.add_argument("url",
                   help="base URL of a --web-status dashboard or "
                        "serving frontend (http://host:port)")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="capture window (server clamps to its own "
                        "bounds; default 2)")
    p.add_argument("--hz", type=float, default=None,
                   help="sampling rate (default: the server's 97)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the speedscope JSON here (load at "
                        "https://www.speedscope.app)")
    p.add_argument("--top", type=int, default=5,
                   help="hot functions listed per thread in the "
                        "summary (default 5)")
    args = p.parse_args(argv)
    base = args.url.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    url = base + "/debug/profile?seconds=%g" % args.seconds
    if args.hz is not None:
        url += "&hz=%g" % args.hz
    try:
        with urllib.request.urlopen(
                url, timeout=args.seconds + 30) as resp:
            doc = json.load(resp)
        # shape validation INSIDE the guard (as checkpoints and debug):
        # a 200 from a non-profiling server must exit 2, never a
        # traceback or a garbage artifact written to --out
        frames = doc["shared"]["frames"]
        profiles = doc["profiles"]
        if not isinstance(frames, list) \
                or not all(isinstance(f, dict) for f in frames) \
                or not isinstance(profiles, list) \
                or not all(isinstance(pr, dict)
                           and isinstance(pr.get("samples"), list)
                           and isinstance(pr.get("weights"), list)
                           and len(pr["samples"]) == len(pr["weights"])
                           and all(isinstance(w, (int, float))
                                   for w in pr["weights"])
                           and isinstance(pr.get("endValue", 0.0),
                                          (int, float))
                           for pr in profiles) \
                or not all(isinstance(i, int) and 0 <= i < len(frames)
                           for pr in profiles
                           for sample in pr["samples"]
                           for i in (sample if isinstance(sample, list)
                                     else [None])):
            # frame-index bounds checked HERE too: the summary loop
            # below indexes frames[sample[-1]], and a shape-valid doc
            # with garbage indices must exit 2, not traceback
            raise ValueError("endpoint answered 200 but not a "
                             "speedscope profile document")
    except (OSError, ValueError, KeyError, TypeError) as exc:
        print("error: %s: %s" % (type(exc).__name__, exc),
              file=sys.stderr)
        return 2
    meta = doc.get("veles") or {}
    print("profile: %d thread(s), %s tick(s) @ %sHz over %ss "
          "(sampler overhead %.2f%%)"
          % (len(profiles), meta.get("ticks", "?"),
             meta.get("hz", "?"), meta.get("seconds", "?"),
             float(meta.get("overhead_fraction", 0.0)) * 100.0))
    for pr in profiles:
        # leaf-frame self time: the "where is this thread" view
        leaf = {}
        for sample, weight in zip(pr["samples"], pr["weights"]):
            if not sample:
                continue
            frame = frames[sample[-1]]
            leaf[frame.get("name", "?")] = \
                leaf.get(frame.get("name", "?"), 0.0) + float(weight)
        hot = sorted(leaf.items(), key=lambda kv: -kv[1])[:args.top]
        total = max(float(pr.get("endValue", 0.0)), 1e-9)
        print("  %-24s %8.3fs  %s"
              % (pr.get("name", "?"), float(pr.get("endValue", 0.0)),
                 ", ".join("%s %.0f%%" % (name, 100.0 * w / total)
                           for name, w in hot) or "-"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f)
        print("speedscope profile -> %s" % args.out)
    return 0


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
    """Run the CLI; -> the trained workflow (the :class:`Ensemble` for
    ``--ensemble``, the :class:`GeneticOptimizer` for ``--optimize``, the
    unrun workflow for ``--workflow-graph``, the exit code for
    ``checkpoints``, ``serve``, ``debug``, ``top``, ``profile`` and the
    foreground process of ``--background``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "checkpoints":
        return checkpoints_main(argv[1:])
    if argv and argv[0] == "serve":
        from veles_torch.serving.frontend import serve_main
        _log_to_stdout()
        return serve_main(argv[1:])
    if argv and argv[0] == "debug":
        return debug_main(argv[1:])
    if argv and argv[0] == "top":
        from veles_torch.fleet import top_main
        return top_main(argv[1:])
    if argv and argv[0] == "profile":
        return profile_main(argv[1:])
    args = build_argparser().parse_intermixed_args(argv)
    if args.optimize == "slave" and not args.master_address:
        raise SystemExit("--optimize slave requires --master-address "
                         "HOST:PORT (the GA master to join)")
    if args.background and not daemonize(args.log_file):
        return 0        # the foreground process: the daemon pid printed
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
    ranks = module.parallel_ranks() \
        if hasattr(module, "parallel_ranks") and not args.workflow_graph \
        else 1
    rank = 0
    if ranks > 1:
        if args.optimize or args.ensemble or args.listen_address \
                or args.master_address or args.generate \
                or args.generate_text:
            raise SystemExit(
                "%d parallel ranks: --generate, --ensemble, --optimize and "
                "the master/slave roles do not combine with the parallel "
                "axes" % ranks)
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return spawn_ranks(args, argv, ranks)
        rank = join_ranks(args, ranks)
    if args.optimize or args.ensemble:
        result_file = args.result_file
        if args.optimize:
            # the inner runs write no result file, export, plots or
            # dashboard
            args.result_file = args.export_inference = None
            args.graphics_dir = args.web_status = None
            outcome, report = optimize(args, module)
        else:
            outcome, report = ensemble(args, module)
        if result_file:
            with open(result_file, "w") as f:
                json.dump(report, f, indent=2)
        print(json.dumps(report), flush=True)
        return outcome

    if args.workflow_graph:
        wf = module.create_workflow()
        with open(args.workflow_graph, "w") as f:
            f.write(wf.generate_graph())
        print("workflow graph -> %s" % args.workflow_graph, flush=True)
        return wf

    def encode_prompt(wf):
        nonlocal prompt
        if args.generate_text:
            try:
                prompt = wf.loader.encode(args.generate_text)
            except ValueError as exc:
                raise SystemExit("--generate-text: %s" % exc)

    role = {}
    wf = run_workflow(args, module, before_run=encode_prompt, report=role)
    if ranks > 1:
        role["parallel"] = parallel_report(wf)
        if rank != 0:
            if args.export_inference:
                # its part of the gathers of TP's shards; rank 0 writes
                wf.export_inference(args.export_inference)
            return 0
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
    result.update(role)
    if args.result_file:
        with open(args.result_file, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return wf


def run_workflow(args, module, before_run=None, report=None):
    """One training run of ``module.create_workflow()`` under the CLI's
    options, through the launcher; ``before_run(wf)`` is called once the
    workflow is initialized; ``report`` (a dict) receives the master's or
    the slave's keys of the result line (:func:`role_report`). -> the
    trained workflow."""
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
                        slo_config=args.slo_config,
                        stats=not args.no_stats,
                        continual=args.continual,
                        listen_address=args.listen_address,
                        master_address=args.master_address,
                        slave_timeout=args.slave_timeout,
                        slave_options=slave_options(args),
                        grad_codec=args.grad_codec,
                        grad_topk_percent=args.grad_topk_percent,
                        stash_interval=args.stash_interval)
    if args.trace_out:
        # from before initialize on, dumped in the finally: a failed
        # run's spans are the postmortem the trace is for
        telemetry.tracer.start()
    try:
        launcher.initialize(wf)
        if args.dump_unit_sizes:
            wf.print_unit_sizes(sys.stderr)
        if before_run is not None:
            before_run(wf)
        launcher.run()
        if report is not None:
            report.update(role_report(launcher))
    finally:
        launcher.close()
        if args.trace_out:
            telemetry.tracer.stop()
            try:
                telemetry.tracer.dump(args.trace_out)
                print("trace -> %s" % args.trace_out, flush=True)
            except OSError as exc:
                print("trace dump failed: %s" % exc, file=sys.stderr)
    return wf


def transport_for(args, local_ranks):
    """The declared transport of a parallel run
    (``parallel.declared_transport``); a refusal exits with its text."""
    from veles_torch.znicz import parallel
    try:
        return parallel.declared_transport(args.device, args.transport,
                                           local_ranks)
    except ValueError as exc:
        raise SystemExit(str(exc))


def spawn_ranks(args, argv, ranks):
    """Spawn the ranks of a parallel run on this host (the kernels built
    once first, on the card); -> the exit code (1 with the failing rank's
    error text on standard error)."""
    from veles_torch.znicz import parallel
    transport_for(args, ranks)
    if not str(args.device).startswith("cpu"):
        from veles_torch import kernels
        kernels.build()
    try:
        parallel.spawn(rank_main, ranks, args=(list(argv),))
    except RuntimeError as exc:
        print("parallel run failed: %s" % exc, file=sys.stderr, flush=True)
        return 1
    return 0


def join_ranks(args, ranks):
    """Join the process group of the ``torchrun``-style environment as one
    rank; -> this rank. The other ranks than 0 print nothing and write no
    file; they take their part in the gathers of the snapshots and the
    inference archive."""
    import torch
    from veles_torch.znicz import parallel
    world = int(os.environ["WORLD_SIZE"])
    if world != ranks:
        raise SystemExit("root.lm.parallel asks for %d ranks; WORLD_SIZE "
                         "is %d" % (ranks, world))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    transport = transport_for(args, local_ranks)
    rank, _ = parallel.init_multihost(transport=transport)
    if transport == "gloo":
        # the host's cores shared out: ranks that each spin every core
        # wait on each other's threads
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_ranks))
    if transport == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        args.device = "cuda:%d" % local
    if rank != 0:
        logging.getLogger("veles_torch").setLevel(logging.WARNING)
        args.result_file = args.trace_out = None
        args.graphics_dir = args.web_status = args.profile_dir = None
        args.no_stats = True
    return rank


def parallel_report(wf):
    """The ``parallel`` key of a parallel run's result line."""
    from veles_torch.znicz import parallel
    from veles_torch.znicz.parallel import collectives
    mesh, step = wf.mesh, wf.step
    full = {}
    for f in wf.forwards:
        for key, t in f.export_params().items():
            n = mesh.axis_size(step.model_axis) \
                if (f.name, key) in wf.shard_specs else 1
            full["%s/%s" % (f.name, key)] = t.numel() * n * t.element_size()
    # every rank's kernel launches, gathered (one all-gather over the
    # mesh, after the run's own collectives were read)
    mine = rank_launches()
    report = {"mesh": dict(mesh.shape), "rank": mesh.rank,
              "transport": collectives.transport(),
              "collective_counts": parallel.collective_counts(step),
              "grad_sync_bytes": int(sum(full.values())),
              "collective_calls": dict(collectives.counts),
              "collective_bytes": dict(collectives.nbytes),
              "collective_seconds": dict(collectives.seconds),
              "train_steps": step.train_steps,
              "eval_steps": step.eval_steps,
              "step_seconds": step.dispatch_seconds}
    import torch
    row = torch.tensor([mine[k] for k in sorted(mine)], dtype=torch.int64,
                       device=wf.device.device)
    every = collectives.all_gather(row, mesh, mesh.axis_names)
    report["launches_by_rank"] = [
        dict(zip(sorted(mine), (int(v) for v in r.cpu().tolist())))
        for r in every]
    train = step.dispatch_seconds.get("train", [0.0, 0])
    times = torch.tensor([train[0], float(step.train_steps),
                          sum(collectives.seconds.values()),
                          float(sum(collectives.nbytes.values()))],
                         dtype=torch.float64, device=wf.device.device)
    keys = ("train_seconds", "train_steps", "collective_seconds",
            "collective_bytes")
    report["stats_by_rank"] = [
        dict(zip(keys, r.cpu().tolist()))
        for r in collectives.all_gather(times, mesh, mesh.axis_names)]
    return report


def rank_launches():
    """This process's hand-written kernel launches as one flat dict: the
    flash kernels by variant and by mask, the bias gradient by form."""
    from veles_torch.znicz.ops.bias_grad import bias_grad
    from veles_torch.znicz.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    out = {}
    for name, fn in (("flash_fwd", flash_attention_fwd),
                     ("flash_bwd", flash_attention_bwd)):
        for key, n in fn.variant_launches.items():
            out["%s[%s]" % (name, key)] = n
        for key, n in fn.mask_launches.items():
            out["%s[%s]" % (name, key)] = n
    for key, n in bias_grad.form_launches.items():
        out["bias_grad[%s]" % key] = n
    return out


def slave_options(args):
    """The SlaveClient options of the CLI: ``--slave-retries`` (0 retries
    forever)."""
    if args.slave_retries is None:
        return {}
    return {"max_retries": None if args.slave_retries == 0
            else args.slave_retries}


def role_report(launcher):
    """The master's or the slave's keys of the result line: the master's
    ``cluster`` status, its own ``wire_bytes`` by direction and whether CUDA
    was initialized in its process (never); a slave's
    ``slave`` counters and the hand-written kernels' ``launches`` in
    this process ({} for a standalone run)."""
    if launcher.master_server is not None:
        import torch
        return {"mode": "master",
                # the master never computes: CUDA stays uninitialized
                "cuda_initialized": torch.cuda.is_initialized(),
                "cluster": launcher.master_server.status(),
                "wire_bytes": own_wire_bytes()}
    client = launcher.slave_client
    if client is None:
        return {}
    step = launcher.workflow.step
    return {"mode": "slave",
            "slave": {"jobs": client.jobs_done,
                      "reconnects": client.reconnects,
                      "stale_resyncs": client.stale_resyncs,
                      "codec": (client._codec_active or ("none",))[0],
                      "job_seconds": {k: v for k, v in
                                      step.dispatch_seconds.items()
                                      if k.startswith("job.")}},
            "launches": kernel_launches()}


def own_wire_bytes():
    """{"rx", "tx"}: the bytes this process moved over the wire, by
    direction (the slaves' pushed counters, absorbed with a ``slave``
    label, left out)."""
    out = {"rx": 0.0, "tx": 0.0}
    for fam in telemetry.get_registry().families():
        if fam.name != "veles_wire_bytes_total":
            continue
        for items, child in fam.children():
            labels = dict(items)
            if "slave" not in labels and labels.get("direction") in out:
                out[labels["direction"]] += child.value
    return out


def kernel_launches():
    """The hand-written kernels' launches in this process, by form and
    variant."""
    from veles_torch.znicz.ops.bias_grad import bias_grad
    from veles_torch.znicz.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    return {"bias_grad": dict(bias_grad.form_launches),
            "flash_fwd": dict(flash_attention_fwd.variant_launches),
            "flash_bwd": dict(flash_attention_bwd.variant_launches)}


def optimize(args, module):
    """``--optimize GENSxPOP[xWORKERS]``: the genetic search over every
    Tune leaf of ``root``, in process, in WORKERS spawned processes, or
    over the slaves registered at ``--listen-address``; -> (the
    optimizer, the report). ``--optimize slave``: evaluate a GA master's
    tasks until it says bye; -> (None, {"ga_slave_tasks": N, "launches":
    ...})."""
    from veles_torch.genetics import (
        GATaskServer, GeneticOptimizer, ProcessPoolMap, SubprocessTrainer,
        apply_values, find_tunables, ga_slave_loop, optimize_config)
    seed = args.seed if args.seed is not None else 1
    if args.optimize == "slave":
        # the fitness callables ride inside the task frames
        served = ga_slave_loop(args.master_address,
                               name="ga-%s" % os.getpid())
        return None, {"ga_slave_tasks": served,
                      "launches": kernel_launches()}
    if args.master_address:
        raise SystemExit(
            "--optimize %r conflicts with --master-address: a GA master "
            "uses --listen-address; to JOIN a master, use --optimize "
            "slave" % args.optimize)
    parts = args.optimize.split("x")
    gens = int(parts[0])
    pop = int(parts[1]) if len(parts) > 1 and parts[1] else 12
    workers = int(parts[2]) if len(parts) > 2 else 1
    if args.listen_address and workers > 1:
        raise SystemExit(
            "--optimize %r combines a workers count with --listen-address: "
            "registered slaves evaluate the individuals, so local workers "
            "would be ignored — drop the x%d or the --listen-address"
            % (args.optimize, workers))
    if workers > 1 or args.listen_address:
        evaluate = SubprocessTrainer(args.workflow, args.config,
                                     overrides=args.overrides, seed=seed,
                                     device=args.device)
        if args.listen_address:
            pool_cm = GATaskServer(
                args.listen_address,
                slave_timeout=3600.0 if args.slave_timeout is None
                else args.slave_timeout)
            print(json.dumps({"ga_master_listen":
                              "%s:%d" % pool_cm.bound_address[:2]}),
                  flush=True)
        else:
            if args.device != "cpu":
                # the workers load these libraries; none of them builds
                from veles_torch import kernels
                kernels.build()
            pool_cm = ProcessPoolMap(workers)
        with pool_cm as pool:
            opt = GeneticOptimizer(evaluate, find_tunables(root),
                                   generations=gens, population_size=pop,
                                   seed=seed, map_fn=pool)
            best_values, _ = opt.run()
        if best_values is not None:
            apply_values(root, best_values)
    else:
        def run_one():
            prng.seed_all(seed)   # the same universe for every individual
            with model_health.scoped():
                metric = float(run_workflow(args, module).decision.best_metric)
            gc.collect()   # the run's cycles, as SubprocessTrainer does
            return metric

        opt = optimize_config(root, run_one, generations=gens,
                              population_size=pop, seed=seed)
    report = {"best_fitness": opt.best_fitness,
              "best_values": opt.best_values,
              "evaluations": opt.evaluations}
    if workers > 1:
        report["workers"] = workers
    return opt, report


def ensemble(args, module):
    """``--ensemble N``: N members from consecutive seeds; -> (the
    Ensemble, its report)."""
    from veles_torch.ensemble import Ensemble
    ens = Ensemble(lambda name: module.create_workflow(),
                   n_models=args.ensemble, base_seed=args.seed or 1000,
                   device=args.device)
    ens.train()
    return ens, ens.evaluate_classification()


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
