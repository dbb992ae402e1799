"""loop-exception-safety: no handler chain may raise into the loop.

Everything the reactor dispatches — ``on_frame``/``on_timer``
methods, ``call_soon``/``call_later``/``every``/``post`` targets —
runs on the ONE loop thread carrying every connection, probe and
timer in the process. The loop's dispatch wraps callbacks in a
catch-all so a raising handler cannot kill the process, but the
recovery is blunt: the connection is closed, the frame is dropped,
and the peer re-syncs — an exception that escapes a handler chain is
a dropped slave or a severed stream, not a stack trace on someone's
terminal. The discipline is therefore: every ``raise`` reachable
from a loop callback must be caught by a ``try`` SOMEWHERE on the
chain before it reaches the reactor.

This rule runs the shared forward-dataflow fixpoint
(:class:`veles_torch.analysis.engine.ForwardDataflow`) over the
interprocedural call graph: the fact flowing caller→callee is the
set of exception names some frame on the chain is guaranteed to
catch. At each function the transfer walks the body tracking lexical
``try`` nesting (handler bodies and ``orelse`` are OUTSIDE their own
try's protection), records every explicit ``raise X`` whose type —
resolved through the project class hierarchy plus the builtin
exception tree, so ``raise StaleLease(...)`` knows it is a
``ConnectionError`` — is not covered, and propagates the enlarged
caught-set into every resolvable callee.

Exemptions: ``raise NotImplementedError`` (the abstract-stub
convention — a subclass is expected to override, and hitting the
stub IS the loudest correct outcome) and bare re-``raise`` (it can
only re-throw something an enclosing handler already caught).
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register


def _raise_type(node):
    """Simple type name of an explicit ``raise`` statement, or
    None (bare re-raise / unresolvable expression)."""
    exc = node.exc
    if exc is None:
        return None
    if isinstance(exc, ast.Call):
        exc = exc.func
    if isinstance(exc, ast.Attribute):
        return exc.attr
    if isinstance(exc, ast.Name):
        return exc.id
    return None


class _RaiseFlow(engine.ForwardDataflow):
    """Fact = frozenset of exception names guaranteed caught by some
    frame of the chain reaching this function."""

    def __init__(self, project):
        super().__init__(project)
        #: (relpath, lineno) -> (exc_name, chain) — first chain wins
        self.uncaught = {}

    def entries(self):
        for mod, cls_node, func, where in engine.reactor_callbacks(
                self.project):
            cls = mod.classes.get(cls_node.name) \
                if cls_node is not None else None
            yield mod, cls, func, frozenset(), where

    def transfer(self, mod, cls, func, caught, chain):
        out = []

        def walk(stmts, caught):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.Try):
                    names = set()
                    for h in stmt.handlers:
                        names |= engine.handler_names(h)
                    walk(stmt.body, caught | frozenset(names))
                    for h in stmt.handlers:
                        walk(h.body, caught)
                    walk(stmt.orelse, caught)
                    walk(stmt.finalbody, caught)
                    continue
                if isinstance(stmt, ast.Raise):
                    name = _raise_type(stmt)
                    if name is not None \
                            and name != "NotImplementedError" \
                            and not engine.exception_covered(
                                name, caught, self.project):
                        key = (mod.relpath, stmt.lineno)
                        self.uncaught.setdefault(
                            key, (name, chain))
                    continue
                for kind, child in engine.iter_stmt_children(stmt):
                    if kind == "stmt":
                        walk([child], caught)
                    else:
                        for call in engine.iter_calls(child):
                            out.append((call, caught))

        walk(func.body, caught)
        return out


@register("loop-exception-safety", "error",
          "call chains reachable from reactor callbacks must not "
          "raise exception types no frame on the chain catches — an "
          "escaped raise severs the connection/timer on the shared "
          "loop")
def check_loop_exception_safety(project):
    flow = _RaiseFlow(project)
    flow.run()
    findings = []
    for (relpath, lineno), (name, chain) in sorted(
            flow.uncaught.items()):
        findings.append(Finding(
            relpath, lineno, "loop-exception-safety", "error",
            "%s raised here can reach the reactor loop uncaught "
            "(via %s) — the loop's blanket recovery closes the "
            "connection and drops the frame" % (name,
                                                " -> ".join(chain)),
            "catch it in the handler chain and reply with an error "
            "frame (or log and degrade); only raise across the "
            "loop boundary when severing the peer IS the intent"))
    return findings
