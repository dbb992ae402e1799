"""stats-cadence: in-graph model stats materialize only behind the
cadence gate.

The model-health plane (``veles_torch/model_health.py``) rides a
per-layer stat vector on the train step's outputs. The whole design is
ONE extra output with host materialization at a configurable cadence —
``TorchStep`` checks ``stats_due()`` (``veles_torch/znicz/step.py``)
before it takes or reads the vectors. A call site that materializes
stat outputs per step (``float()``/``int()``/``.item()``/
``numpy.asarray()``/``.tolist()``) silently reintroduces a
device→host sync on every step — exactly the per-step host round-trip
the fused step exists to avoid, and invisible in tests because the
values come back correct.

This rule finds **stat-handling functions** — any function that

* mentions the stat-key marker (the ``"stat/"`` string constant or a
  ``STAT_KEY_PREFIX`` name/attribute reference), or
* calls the monitor sink ``observe_stats``

— and, when such a function also calls a materializer, requires it to
consult the cadence gate: reference something whose name contains
``stats_due`` (the gate method/helper), or carry a
``# zlint: disable=stats-cadence (reason)`` pragma. Pure key routing
(``model_health.take_stats``) has no materializers and stays quiet;
the monitor's own ``observe_stats`` body is the sanctioned sink behind
the gate and is exempt by name.
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

#: split so the rule's own source can never match the marker it scans
#: for (same trick as rules_profiler)
_MARKER = "st" + "at/"

#: names whose reference marks a function as stat-handling
_PREFIX_NAMES = frozenset(("STAT_KEY_PREFIX",))

#: the monitor sink: calling it means the function feeds stat vectors
_SINK_CALLS = frozenset(("observe_stats",))

#: host-materialization calls banned outside the cadence gate
_MATERIALIZERS = frozenset((
    "float", "int", "item", "asarray", "array", "tolist", "ravel"))

#: a name/attr containing this fragment counts as consulting the gate
_GATE_FRAGMENT = "stats_due"


def _functions(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _is_stat_handler(fn):
    for node in ast.walk(fn):
        if isinstance(node, ast.Constant) \
                and isinstance(node.value, str) \
                and _MARKER in node.value:
            return True
        if isinstance(node, ast.Name) and node.id in _PREFIX_NAMES:
            return True
        if isinstance(node, ast.Attribute) \
                and node.attr in _PREFIX_NAMES:
            return True
        if isinstance(node, ast.Call) \
                and engine.call_name(node) in _SINK_CALLS:
            return True
    return False


def _consults_gate(fn):
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and _GATE_FRAGMENT in node.id:
            return True
        if isinstance(node, ast.Attribute) \
                and _GATE_FRAGMENT in node.attr:
            return True
    return False


@register("stats-cadence", "error",
          "in-graph model-stat outputs materialize on the host only "
          "behind the cadence gate (stats_due), never per step",
          scope="module")
def check_stats_cadence(project):
    findings = []
    for mod in project.modules:
        for fn in _functions(mod.tree):
            if fn.name in _SINK_CALLS:
                # the monitor's own sink: every caller is already
                # forced through the gate by this rule
                continue
            if not _is_stat_handler(fn):
                continue
            if _consults_gate(fn):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and engine.call_name(node) in _MATERIALIZERS:
                    findings.append(Finding(
                        mod.relpath, node.lineno, "stats-cadence",
                        "error",
                        "%r materializes values in a stat-handling "
                        "function (%s) that never consults the "
                        "cadence gate — per-step host sync of "
                        "in-graph stat outputs is the round-trip the "
                        "fused step exists to avoid"
                        % (engine.call_name(node), fn.name),
                        "route the materialization through the "
                        "cadence-gated publish path (guard on "
                        "stats_due()), or pragma why this site is "
                        "not per-step"))
    return findings
