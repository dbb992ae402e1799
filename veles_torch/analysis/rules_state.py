"""checkpoint-state: units with mutable run-state must be resumable.

The durability layer (``Workflow.checkpoint_state`` →
``unit.get_state()`` per unit) silently drops any unit that
forgot to implement the protocol: the checkpoint writes fine, the
resume "works", and the unit restarts from its constructor defaults —
epoch counters reset, rollback history gone, save limits re-armed.
This rule closes that hole statically: every ``Unit`` subclass whose
``run()`` (directly or through ``self.*`` helpers) assigns instance
attributes must either implement ``get_state``/``checkpoint_state``
(its own or inherited) or carry a pragma stating why its state is
ephemeral::

    class EndPoint(TrivialUnit):   # zlint: disable=checkpoint-state
        ...
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

_STATE_METHODS = ("get_state", "checkpoint_state")


def _run_mutations(project, graph, cls):
    """Attributes ``run()`` assigns on self, following ``self.*``
    helper calls through the shared call graph (bounded depth)."""
    run = cls.methods.get("run")
    if run is None:
        return []
    writes = []
    seen = set()

    def scan(mod, owner, func, depth):
        if id(func) in seen or depth > 8:
            return
        seen.add(id(func))
        for node in ast.walk(func):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets \
                    if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        writes.append((t.attr, node.lineno))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                # only self.helper() calls: another object's method
                # writes ITS state, not this unit's
                target = graph.resolve(mod, owner, node)
                if target is not None \
                        and target.func.name not in (
                            "run", "initialize", "stop"):
                    scan(target.module, target.cls, target.func,
                         depth + 1)

    scan(cls.module, cls, run, 0)
    return writes


@register("checkpoint-state", "error",
          "Unit subclasses whose run() mutates instance state must "
          "implement get_state/checkpoint_state",
          scope="module")
def check_checkpoint_state(project):
    findings = []
    graph = engine.CallGraph(project)
    for mod in project.modules:
        for cls in mod.classes.values():
            if not project.is_subclass_of(cls, "Unit"):
                continue
            if "run" not in cls.methods:
                continue           # inherited run: the definer owns it
            writes = _run_mutations(project, graph, cls)
            if not writes:
                continue
            has_state = any(
                project.find_method(cls, m)[1] is not None
                for m in _STATE_METHODS)
            if has_state:
                continue
            attrs = sorted({a for a, _ in writes})
            findings.append(Finding(
                mod.relpath, cls.node.lineno, "checkpoint-state",
                "error",
                "%s.run() mutates %s but the unit implements no "
                "get_state/checkpoint_state — this state silently "
                "resets on resume" % (cls.name, ", ".join(
                    "self.%s" % a for a in attrs[:4])
                    + (", ..." if len(attrs) > 4 else "")),
                "implement get_state()/set_state() covering the "
                "mutated attributes, or pragma the class with the "
                "reason the state is ephemeral"))
    return findings
