"""probe-purity: /healthz and /readyz handlers must never block.

Kubernetes-style probes are only useful if they answer while the
process is BUSY — a liveness check that queues behind the master
request lock times out exactly when the operator most needs it, and a
readiness handler that scans a registry or touches the network turns
every prober into load. The health plane's contract
(``veles_torch/health.py``) is therefore: all real evaluation happens on
the monitor's sampler thread, and the HTTP probe branch reads ONE
cached attribute.

This rule finds the probe branches — any ``if``/``elif`` whose test
mentions a ``"/healthz"`` or ``"/readyz"`` string constant — and
flags blocking work inside them:

* ``with`` statements (lock acquisition, file/socket context
  managers: anything context-managed is a resource wait);
* explicit ``.acquire()`` / ``.wait()`` / ``.join()`` calls;
* network/file primitives (``urlopen``, ``create_connection``,
  ``connect``, ``recv*``, ``open``, ``sleep``);
* live state pulls (``.status()``, ``.snapshot()``, ``.metrics()``,
  ``.describe()``) — the pull belongs on the monitor thread, the
  handler serves the cached verdict.
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

_PROBE_MARKERS = ("/healthz", "/readyz")

#: attribute/function call names that block or pull live state
_BLOCKING_CALLS = frozenset((
    "acquire", "wait", "join", "sleep",
    "urlopen", "urlretrieve", "create_connection", "connect",
    "getaddrinfo", "recv", "recv_into", "makefile", "open",
    "status", "snapshot", "metrics", "describe",
))


def _scan_branch(mod, body, findings):
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                findings.append(Finding(
                    mod.relpath, node.lineno, "probe-purity", "error",
                    "context-managed resource acquisition inside a "
                    "/healthz// readyz branch — a probe that waits "
                    "on a lock or I/O times out exactly when the "
                    "process is busiest",
                    "serve the health monitor's cached verdict "
                    "(HealthMonitor.probe reads one attribute); do "
                    "the real work on the monitor's sampler thread"))
            elif isinstance(node, ast.Call):
                name = engine.call_name(node)
                if name in _BLOCKING_CALLS:
                    findings.append(Finding(
                        mod.relpath, node.lineno, "probe-purity",
                        "error",
                        "blocking or live-state call %r inside a "
                        "/healthz//readyz branch — probes must read "
                        "cached state only, never take the master "
                        "lock or touch the network" % name,
                        "move the %s() evaluation into a readiness "
                        "check on the health monitor's sampler "
                        "thread and serve the cached result here"
                        % name))


@register("probe-purity", "error",
          "/healthz and /readyz handler branches read cached state "
          "only — no locks, no network, no live state pulls",
          scope="module")
def check_probe_purity(project):
    findings = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.If) \
                    and engine.test_mentions(node.test,
                                             _PROBE_MARKERS):
                _scan_branch(mod, node.body, findings)
    return findings
