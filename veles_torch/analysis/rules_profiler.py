"""profiler-safety: profile captures must stay off the reactor loop.

The sampling profiler (``veles_torch/profiling.py``) BLOCKS for the whole
requested capture window — ``capture_profile``/``profile_endpoint``
sleep out ``seconds`` of wall time while the sampler thread walks
stacks. Run on the shared reactor loop, one profile request would
park every connection, probe and timer for seconds (exactly the
failure the loop-lag gauge exists to catch). This rule statically
checks the two places that could make that mistake:

* **``/debug/profile`` route branches**: any ``if``/``elif`` branch
  whose test mentions the ``"/debug/profile"`` string constant (the
  routing convention in ``web_status.py`` and the serving frontend)
  must hand the work to a worker thread — the branch has to contain a
  ``.defer(...)`` call, and must not call a capture primitive
  directly (``capture_profile``/``profile_endpoint``, or
  ``.start()``/``.stop()``/``.capture()`` on a profiler-named
  receiver). Calls inside a nested ``def``/``lambda`` are exempt:
  that is the deferred body itself.
* **reactor callbacks**: the same capture primitives are banned
  inside the shared :func:`veles_torch.analysis.engine.reactor_callbacks`
  contexts (``on_frame``/``on_timer`` methods,
  ``call_soon``/``call_later``/``every``/``post`` targets).
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

#: module-level capture primitives (veles_torch/profiling.py public API)
_CAPTURE_CALLS = frozenset(("capture_profile", "profile_endpoint"))

#: methods that start/stop/collect a capture when the receiver is
#: profiler-shaped (``profiler.start()``, ``self._profiler.stop()``)
_PROFILER_METHODS = frozenset(("start", "stop", "capture"))

#: the route string this rule keys branch detection on (a module
#: constant, not an inline literal: the rule must not fire on its own
#: matcher)
_ROUTE_MARK = "/debug" + "/profile"


def _capture_call(node):
    """The capture primitive ``node`` invokes, or None."""
    name = engine.call_name(node)
    if name in _CAPTURE_CALLS:
        return name
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _PROFILER_METHODS \
            and "profil" in engine.receiver_name(
                node.func.value).lower():
        return "%s.%s" % (engine.receiver_name(node.func.value),
                          node.func.attr)
    return None


def _scan_route_branch(mod, test, body, findings):
    """Calls inside nested def/lambda bodies are exempt via the
    shared scoped walk: a deferred closure's body runs on a worker
    thread — the compliant escape, not a violation."""
    has_defer = []
    captures = []
    for stmt in body:
        for call in engine.iter_calls(stmt):
            if engine.call_name(call) == "defer":
                has_defer.append(call)
            cap = _capture_call(call)
            if cap is not None:
                captures.append((call, cap))
    for call, cap in captures:
        findings.append(Finding(
            mod.relpath, call.lineno, "profiler-safety", "error",
            "capture primitive %r called directly in a "
            "/debug/profile route branch — the capture blocks for "
            "the whole requested window on the reactor loop" % cap,
            "hand the capture to a worker thread: "
            "request.defer(handler, request), reply from there"))
    if not has_defer and not captures:
        findings.append(Finding(
            mod.relpath, test.lineno, "profiler-safety", "error",
            "/debug/profile route branch contains no .defer(...) "
            "call — the profile capture blocks for seconds and must "
            "never answer inline on the reactor loop",
            "route the branch through request.defer(...) and run "
            "profile_endpoint on the worker thread"))


def _scan_callback(mod, node, where, findings, seen):
    for sub, cap in engine.novel_calls(mod, node, seen,
                                       _capture_call):
        findings.append(Finding(
            mod.relpath, sub.lineno, "profiler-safety", "error",
            "profiler capture %r inside reactor callback %s — the "
            "capture blocks for its whole window and parks every "
            "connection, probe and timer with it" % (cap, where),
            "move the capture to a worker thread (request.defer / "
            "a plain Thread) and reply via call_soon"))


@register("profiler-safety", "error",
          "/debug/profile route branches must request.defer their "
          "capture, and profiler start/stop/capture_profile are "
          "banned inside reactor callbacks — a capture blocks for "
          "its whole window")
def check_profiler_safety(project):
    findings = []
    seen = set()
    for mod in project.modules:
        # 1) /debug/profile route branches
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.If) \
                    and engine.test_mentions(node.test,
                                             (_ROUTE_MARK,)):
                _scan_route_branch(mod, node.test, node.body,
                                   findings)
    # 2) reactor callbacks (the shared loop-context enumeration)
    for mod, _cls, func, where in engine.reactor_callbacks(project):
        _scan_callback(mod, func, where, findings, seen)
    return findings
