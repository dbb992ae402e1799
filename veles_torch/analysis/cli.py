"""``python -m veles_torch lint`` — run zlint over files/directories.

Exit codes follow the gate contract: **0** clean, **1** findings,
**2** usage error (bad path, unknown rule). ``--format json`` (alias
``--json``) emits the findings as a JSON array sorted by (file, line,
rule) with repo-relative paths; ``--format sarif`` emits a SARIF
2.1.0 log for CI annotation surfaces and editors. Both are
byte-stable for identical inputs — CI can diff them. ``--changed-only
[REF]`` lints only files changed vs a git ref (default HEAD, plus
untracked files) for fast pre-commit runs, falling back to the full
tree with a warning when git is unavailable.
"""

import argparse
import json
import os
import subprocess
import sys

_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                 "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def _default_paths():
    """With no paths given, lint the installed veles_torch package."""
    import veles_torch
    return [os.path.dirname(os.path.abspath(veles_torch.__file__))]


class BadRefError(ValueError):
    """--changed-only named a ref git cannot resolve. A distinct type
    so a typo'd ref is a LOUD usage error (exit 2), never a silent
    full-tree fallback behind a misleading warning."""


def _changed_files(ref):
    """Absolute paths of .py files changed vs ``ref`` (tracked diff +
    untracked), or None when git cannot answer (no git binary, not a
    repository — the caller falls back to the full tree). A bad
    ``ref`` in a working repository raises :class:`BadRefError`."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30)
        if top.returncode != 0:
            return None
        root = top.stdout.strip()
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"],
            capture_output=True, text=True, timeout=30, cwd=root)
        if diff.returncode != 0:
            raise BadRefError(
                "cannot resolve ref %r: %s"
                % (ref, diff.stderr.strip().splitlines()[0]
                   if diff.stderr.strip() else "git diff failed"))
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, timeout=30, cwd=root)
        names = diff.stdout.splitlines()
        if untracked.returncode == 0:
            names += untracked.stdout.splitlines()
        return {os.path.abspath(os.path.join(root, n))
                for n in names if n.endswith(".py")}
    except (OSError, subprocess.SubprocessError):
        return None


def _sarif_doc(findings):
    """Findings -> a SARIF 2.1.0 log dict (stable ordering: findings
    arrive sorted, the rule table is sorted by id)."""
    from veles_torch.analysis.core import RULES
    seen_rules = sorted({f.rule for f in findings})
    rules = []
    for rule_id in seen_rules:
        _fn, severity, doc = RULES.get(rule_id, (None, "error", ""))
        rules.append({
            "id": rule_id,
            "shortDescription": {"text": doc},
            "defaultConfiguration": {
                "level": "error" if severity == "error"
                else "warning"},
        })
    results = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "level": f.severity,
            "message": {"text": "%s (hint: %s)" % (f.message,
                                                   f.hint)},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.file.replace(os.sep, "/")},
                    "region": {"startLine": f.line},
                },
            }],
        })
    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {"name": "zlint",
                                "rules": rules}},
            "results": results,
        }],
    }


def _stats_table(stats):
    """``--stats`` rows -> an aligned text table (slowest first) with
    a totals line."""
    lines = ["%-24s %8s %9s %7s %7s"
             % ("rule", "seconds", "findings", "fresh", "cached")]
    for row in sorted(stats, key=lambda r: -r["seconds"]):
        lines.append("%-24s %8.4f %9d %7d %7d"
                     % (row["rule"], row["seconds"],
                        row["findings"], row["fresh_modules"],
                        row["cached_modules"]))
    lines.append("%-24s %8.4f %9d"
                 % ("total", sum(r["seconds"] for r in stats),
                    sum(r["findings"] for r in stats)))
    return "\n".join(lines)


def lint_main(argv=None):
    from veles_torch.analysis.core import (
        RULES, UnknownRuleError, _load_rules, analyze_paths,
        iter_py_files)
    p = argparse.ArgumentParser(
        prog="python -m veles_torch lint",
        description="Framework-aware static analysis (zlint): tracer "
                    "purity (the unit bodies a CUDA graph captures), "
                    "lock order, checkpoint completeness, "
                    "telemetry hygiene, thread lifecycle, wire-frame "
                    "schemas, resource leaks, loop exception safety "
                    "+ generic hygiene. Suppress a finding with "
                    "`# zlint: disable=RULE (reason)` on its line.")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories (default: the "
                        "veles_torch package)")
    p.add_argument("--format", default=None, metavar="FMT",
                   choices=("text", "json", "sarif"),
                   help="output format: text (default), json "
                        "(sorted array), sarif (SARIF 2.1.0 for CI/"
                        "editor ingestion); all byte-stable")
    p.add_argument("--json", action="store_true",
                   help="alias for --format json")
    p.add_argument("--select", default=None, metavar="RULES",
                   help="comma-separated rule ids to run (default: "
                        "all)")
    p.add_argument("--changed-only", nargs="?", const="HEAD",
                   default=None, metavar="REF",
                   help="lint only files changed vs REF (default "
                        "HEAD; untracked files included) — the fast "
                        "pre-commit mode. Falls back to the full "
                        "tree with a warning when git is "
                        "unavailable. Note: cross-file context "
                        "shrinks to the changed set — combine with "
                        "--cache to keep the FULL tree and let "
                        "unchanged modules answer from cache instead")
    p.add_argument("--cache", default=None, metavar="DIR",
                   help="incremental analysis cache directory: "
                        "per-rule results keyed by content hashes "
                        "over each module's import closure (see "
                        "veles_torch/analysis/cache.py) — warm full-tree "
                        "runs re-analyze only what changed, with "
                        "byte-identical output")
    p.add_argument("--stats", action="store_true",
                   help="per-rule wall time, finding counts and "
                        "fresh/cached module counts; text appends a "
                        "table, json wraps the array as {findings, "
                        "stats}, sarif prints the table to stderr")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    try:
        args = p.parse_args(argv)
    except SystemExit as exc:
        # argparse exits 2 on usage errors already; normalize others
        return int(exc.code or 0)
    if args.list_rules:
        _load_rules()
        for rule_id in sorted(RULES):
            _fn, sev, doc = RULES[rule_id]
            print("%-24s %-8s %s" % (rule_id, sev, doc))
        return 0
    fmt = args.format or ("json" if args.json else "text")
    select = None
    if args.select:
        select = [r.strip() for r in args.select.split(",")
                  if r.strip()]
    paths = args.paths or _default_paths()
    cache = None
    if args.cache:
        from veles_torch.analysis.cache import AnalysisCache
        try:
            cache = AnalysisCache(args.cache)
        except OSError as exc:
            print("error: cannot use cache dir %s: %s"
                  % (args.cache, exc), file=sys.stderr)
            return 2
    stats = [] if args.stats else None
    try:
        if args.changed_only is not None:
            try:
                changed = _changed_files(args.changed_only)
            except BadRefError as exc:
                print("error: --changed-only: %s" % exc,
                      file=sys.stderr)
                return 2
            if changed is None:
                print("warning: --changed-only: git unavailable — "
                      "linting the full tree", file=sys.stderr)
            elif cache is not None:
                # with a cache the full tree IS the fast path:
                # unchanged modules answer from cache, and the lint
                # keeps its complete cross-file view instead of
                # narrowing context to the changed set
                pass
            else:
                paths = [f for f in iter_py_files(paths)
                         if os.path.abspath(f) in changed]
        findings = analyze_paths(paths, select=select, cache=cache,
                                 stats=stats)
    except FileNotFoundError as exc:
        print("error: no such file or directory: %s" % exc,
              file=sys.stderr)
        return 2
    except UnknownRuleError as exc:
        print("error: %s" % exc, file=sys.stderr)
        return 2
    except (SyntaxError, UnicodeDecodeError) as exc:
        # an unparseable input is a usage error (2), NOT "findings"
        # (1): CI diffing on exit codes must never read a crashed
        # lint as a lint verdict
        print("error: cannot parse %s: %s"
              % (getattr(exc, "filename", "input"), exc),
              file=sys.stderr)
        return 2
    except OSError as exc:
        # unreadable input (permissions, transient FS trouble) is an
        # environment error, same contract as above
        print("error: cannot read input: %s" % exc, file=sys.stderr)
        return 2
    if fmt == "json":
        if stats is not None:
            print(json.dumps({"findings": [f.as_dict()
                                           for f in findings],
                              "stats": stats}, indent=2))
        else:
            print(json.dumps([f.as_dict() for f in findings],
                             indent=2))
    elif fmt == "sarif":
        _load_rules()
        print(json.dumps(_sarif_doc(findings), indent=2,
                         sort_keys=True))
        if stats is not None:
            # the SARIF document must stay pure: the human-facing
            # table goes to stderr
            print(_stats_table(stats), file=sys.stderr)
    else:
        for f in findings:
            print(f.render())
        print("%d finding(s)" % len(findings))
        if stats is not None:
            print(_stats_table(stats))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(lint_main())
