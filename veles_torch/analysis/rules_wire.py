"""wire-schema: producers and consumers of one frame kind must agree.

The master/slave protocol is tuples-over-pickle: every frame is
``(kind, ...)`` with a string kind at element 0, produced by
``send_frame``/``send_obj``/handler returns and consumed by indexing,
slicing (``resp[:4]``) and tuple unpacking at the far end. Arity is
version-negotiated BY HAND — a 2-tuple hello marks a pre-codec peer,
``welcome`` grew from 3 to 5 elements over two protocol revisions, older
clients unpack ``resp[:4]`` and ignore the trace element — so nothing
but discipline stops a producer from growing a tuple its consumers
crash on (or a consumer from reading an element no producer ships).

This rule extracts the schema from both sides and cross-checks them
project-wide:

* **producers** — tuple literals with a string-constant head that are
  (a) arguments of a send-shaped call (``send_frame``/``send_obj``/
  ``_roundtrip``/``rpc``, including tuples built by a lambda handed
  to ``rpc``) or (b) returned from a handler-convention function
  (``handle``/``_handle``/``on_frame``). Each records
  ``(direction, kind) -> {arity: site}`` — request frames (client →
  server) and response frames (handler replies) are separate
  namespaces, because ``("job", sid, lease)`` and ``("job", payload,
  job_id, epoch, trace)`` share a kind but not a schema.
* **consumers** — any variable that is kind-tested (``V[0] ==
  "job"``, ``kind = V[0]; kind == "job"``, the negated early-exit
  spellings) and is either a handler-convention parameter (request
  side) or assigned from a call (response side). Inside the
  established kind context, ``V[i]`` reads, ``a, b = V`` exact
  unpacks and ``a, b, c, d = V[:4]`` slice unpacks each demand an
  arity — UNLESS guarded: a dominating ``len(V)`` comparison
  (positive branch, early-exit negation, or conditional expression),
  an exact-arity check (``len(V) != 5: break``), or a
  ``try/except (ValueError, TypeError)`` around the unpack (the
  mixed-version skew handler) all make the access version-safe.

A finding fires when an UNGUARDED consumer demand cannot be met by
every producer of that (direction, kind): an exact unpack of N while
a producer ships M != N, or an index/slice read past the smallest
produced arity. Kinds with no known producer are skipped — the rule
only judges schemas it can see both sides of.
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

#: calls whose tuple-literal argument is a frame leaving THIS side;
#: direction is which namespace the schema lands in
_REQUEST_SENDS = frozenset(("send_frame", "_roundtrip", "roundtrip",
                            "rpc"))
_RESPONSE_SENDS = frozenset(("send_obj",))

#: handler-convention function names: their returned tuples are
#: response frames, their non-self parameters are request frames
_HANDLER_NAMES = frozenset(("handle", "_handle", "on_frame"))

#: except types whose handler marks an unpack as skew-guarded (the
#: consumer explicitly survives an arity mismatch)
_SKEW_CATCHES = frozenset(("ValueError", "TypeError", "Exception",
                           "BaseException", ""))


def _frame_tuple(node):
    """(kind, arity) when ``node`` is a frame-shaped tuple literal —
    ``("job", a, b)`` — else None."""
    if isinstance(node, ast.Tuple) and node.elts \
            and isinstance(node.elts[0], ast.Constant) \
            and isinstance(node.elts[0].value, str):
        return node.elts[0].value, len(node.elts)
    return None


def _collect_producers(project):
    """{(direction, kind): {arity: (relpath, lineno)}} over the whole
    project."""
    out = {}

    def add(direction, kind, arity, mod, lineno):
        sites = out.setdefault((direction, kind), {})
        sites.setdefault(arity, (mod.relpath, lineno))

    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                name = engine.call_name(node)
                direction = ("request" if name in _REQUEST_SENDS
                             else "response"
                             if name in _RESPONSE_SENDS else None)
                if direction is None:
                    continue
                for arg in node.args:
                    got = _frame_tuple(arg)
                    if got is None and isinstance(arg, ast.Lambda):
                        # genetics-style ``rpc(lambda sid: ("task",
                        # sid))``: the lambda builds the frame
                        got = _frame_tuple(arg.body)
                    if got is not None:
                        add(direction, got[0], got[1], mod,
                            arg.lineno)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                    and node.name in _HANDLER_NAMES:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Return) \
                            and sub.value is not None:
                        got = _frame_tuple(sub.value)
                        if got is not None:
                            add("response", got[0], got[1], mod,
                                sub.lineno)
    return out


# -- consumer-side dataflow ---------------------------------------------


def _aliases(func):
    """{alias_name: frame_var} for ``kind = V[0]`` assignments."""
    out = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) \
                and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Subscript) \
                and isinstance(node.value.value, ast.Name) \
                and isinstance(node.value.slice, ast.Constant) \
                and node.value.slice.value == 0:
            out[node.targets[0].id] = node.value.value.id
    return out


def _kind_tested_vars(func, aliases):
    """Names compared ``V[0] ==/!= "str"`` anywhere in ``func``
    (directly or through a ``kind = V[0]`` alias)."""
    out = set()
    for node in ast.walk(func):
        if not (isinstance(node, ast.Compare) and node.comparators
                and isinstance(node.comparators[0], ast.Constant)
                and isinstance(node.comparators[0].value, str)):
            continue
        left = node.left
        if isinstance(left, ast.Subscript) \
                and isinstance(left.value, ast.Name) \
                and isinstance(left.slice, ast.Constant) \
                and left.slice.value == 0:
            out.add(left.value.id)
        elif isinstance(left, ast.Name) and left.id in aliases:
            out.add(aliases[left.id])
    return out


def _assigned_from_call(func):
    """Names bound from a bare call result (``resp = recv(...)``)."""
    out = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _constraints(test, frame_vars, aliases):
    """(pos, neg): constraints guaranteed when ``test`` is true /
    false. Each is ``(var, op, value)`` with op in {"kind", "floor",
    "exact"}. And-tests stack positives, or-tests stack the negated
    side (the early-exit spelling ``if V[0] != "job" or len(V) < 4:
    raise``)."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        pos, neg = _constraints(test.operand, frame_vars, aliases)
        return neg, pos
    if isinstance(test, ast.BoolOp):
        pos, neg = [], []
        for value in test.values:
            p, n = _constraints(value, frame_vars, aliases)
            if isinstance(test.op, ast.And):
                pos.extend(p)
            else:
                neg.extend(n)
        return pos, neg
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and len(test.comparators) == 1):
        return [], []
    left, op, right = test.left, test.ops[0], test.comparators[0]
    # V[0] == "kind" / alias == "kind"
    if isinstance(right, ast.Constant) and isinstance(right.value, str):
        var = None
        if isinstance(left, ast.Subscript) \
                and isinstance(left.value, ast.Name) \
                and isinstance(left.slice, ast.Constant) \
                and left.slice.value == 0:
            var = left.value.id
        elif isinstance(left, ast.Name):
            var = aliases.get(left.id)
        if var in frame_vars:
            if isinstance(op, ast.Eq):
                return [(var, "kind", right.value)], []
            if isinstance(op, ast.NotEq):
                return [], [(var, "kind", right.value)]
        return [], []
    # len(V) <op> n
    if isinstance(left, ast.Call) and engine.call_name(left) == "len" \
            and len(left.args) == 1 \
            and isinstance(left.args[0], ast.Name) \
            and left.args[0].id in frame_vars \
            and isinstance(right, ast.Constant) \
            and isinstance(right.value, int):
        var, n = left.args[0].id, right.value
        if isinstance(op, ast.Gt):
            return [(var, "floor", n + 1)], []
        if isinstance(op, ast.GtE):
            return [(var, "floor", n)], []
        if isinstance(op, ast.Lt):
            return [], [(var, "floor", n)]
        if isinstance(op, ast.LtE):
            return [], [(var, "floor", n + 1)]
        if isinstance(op, ast.Eq):
            return [(var, "exact", n)], []
        if isinstance(op, ast.NotEq):
            return [], [(var, "exact", n)]
    return [], []


def _apply(env, constraints):
    """New env dict with ``constraints`` folded in."""
    out = {v: dict(st) for v, st in env.items()}
    for var, op, value in constraints:
        st = out.setdefault(var, {"kind": None, "floor": 0,
                                  "exact": None})
        if op == "kind":
            st["kind"] = value
        elif op == "floor":
            st["floor"] = max(st["floor"], value)
        elif op == "exact":
            st["exact"] = value
            st["floor"] = max(st["floor"], value)
    return out


def _terminates(body):
    """True when a statement suite always leaves the enclosing suite
    (the early-exit guard shape)."""
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue))


class _ConsumerScan:
    """One function's consumer walk: tracks per-frame-var (kind,
    floor, exact) through branches and records unguarded demands."""

    def __init__(self, mod, func, frame_vars, aliases, directions,
                 records):
        self.mod = mod
        self.frame_vars = frame_vars
        self.aliases = aliases
        self.directions = directions    # var -> "request"|"response"
        self.records = records
        self.unpack_guard = 0
        env = {v: {"kind": None, "floor": 0, "exact": None}
               for v in frame_vars}
        self.walk_suite(func.body, env)

    # -- recording -----------------------------------------------------

    def _demand_index(self, var, i, env, lineno):
        st = env.get(var)
        if st is None or st["kind"] is None or i == 0:
            return
        if i < st["floor"]:
            return
        if st["exact"] is not None and i < st["exact"]:
            return
        self.records.append(
            (self.mod, lineno, self.directions[var],
             (var, st["kind"]), "index", i, st["floor"]))

    # -- expressions ---------------------------------------------------

    def scan_expr(self, expr, env):
        if expr is None or isinstance(
                expr, (ast.Lambda, ast.FunctionDef,
                       ast.AsyncFunctionDef)):
            return
        if isinstance(expr, ast.IfExp):
            pos, neg = _constraints(expr.test, self.frame_vars,
                                    self.aliases)
            self.scan_expr(expr.test, env)
            self.scan_expr(expr.body, _apply(env, pos))
            self.scan_expr(expr.orelse, _apply(env, neg))
            return
        if isinstance(expr, ast.BoolOp) \
                and isinstance(expr.op, ast.And):
            cur = env
            for value in expr.values:
                self.scan_expr(value, cur)
                pos, _ = _constraints(value, self.frame_vars,
                                      self.aliases)
                if pos:
                    cur = _apply(cur, pos)
            return
        if isinstance(expr, ast.Subscript) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id in self.frame_vars \
                and isinstance(expr.slice, ast.Constant) \
                and isinstance(expr.slice.value, int):
            self._demand_index(expr.value.id, expr.slice.value, env,
                               expr.lineno)
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self.scan_expr(child, env)

    # -- statements ----------------------------------------------------

    def _scan_unpack(self, stmt, env):
        """``a, b = V`` / ``a, b, c, d = V[:4]`` demands."""
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], (ast.Tuple, ast.List))):
            return False
        elts = stmt.targets[0].elts
        if any(isinstance(e, ast.Starred) for e in elts):
            return False
        value = stmt.value
        if isinstance(value, ast.Name) \
                and value.id in self.frame_vars:
            st = env.get(value.id)
            if st is None or st["kind"] is None:
                return True
            if st["exact"] == len(elts) or self.unpack_guard:
                return True
            self.records.append(
                (self.mod, stmt.lineno, self.directions[value.id],
                 (value.id, st["kind"]), "exact", len(elts),
                 st["floor"]))
            return True
        if isinstance(value, ast.Subscript) \
                and isinstance(value.value, ast.Name) \
                and value.value.id in self.frame_vars \
                and isinstance(value.slice, ast.Slice) \
                and value.slice.lower is None \
                and isinstance(value.slice.upper, ast.Constant) \
                and isinstance(value.slice.upper.value, int):
            var, n = value.value.id, value.slice.upper.value
            st = env.get(var)
            if st is None or st["kind"] is None:
                return True
            if st["floor"] >= n or self.unpack_guard:
                return True
            self.records.append(
                (self.mod, stmt.lineno, self.directions[var],
                 (var, st["kind"]), "slice", n, st["floor"]))
            return True
        return False

    def walk_suite(self, stmts, env):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                pos, neg = _constraints(stmt.test, self.frame_vars,
                                        self.aliases)
                self.scan_expr(stmt.test, env)
                self.walk_suite(stmt.body, _apply(env, pos))
                self.walk_suite(stmt.orelse, _apply(env, neg))
                if _terminates(stmt.body) and not stmt.orelse:
                    # the early-exit guard shape: its negation holds
                    # for the REST of this suite
                    for var, op, value in neg:
                        st = env.setdefault(
                            var, {"kind": None, "floor": 0,
                                  "exact": None})
                        if op == "kind":
                            st["kind"] = value
                        elif op == "floor":
                            st["floor"] = max(st["floor"], value)
                        elif op == "exact":
                            st["exact"] = value
                            st["floor"] = max(st["floor"], value)
                continue
            if isinstance(stmt, ast.Try):
                skew = any(engine.handler_names(h) & _SKEW_CATCHES
                           for h in stmt.handlers)
                self.unpack_guard += bool(skew)
                self.walk_suite(stmt.body, {v: dict(s)
                                            for v, s in env.items()})
                self.unpack_guard -= bool(skew)
                for h in stmt.handlers:
                    self.walk_suite(h.body, {v: dict(s)
                                             for v, s in env.items()})
                self.walk_suite(stmt.orelse, env)
                self.walk_suite(stmt.finalbody, env)
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                if isinstance(stmt, ast.While):
                    self.scan_expr(stmt.test, env)
                else:
                    self.scan_expr(stmt.iter, env)
                self.walk_suite(stmt.body, {v: dict(s)
                                            for v, s in env.items()})
                self.walk_suite(stmt.orelse, env)
                continue
            if self._scan_unpack(stmt, env):
                continue
            for kind, child in engine.iter_stmt_children(stmt):
                if kind == "stmt":
                    self.walk_suite([child], env)
                else:
                    self.scan_expr(child, env)


def _collect_consumers(project):
    """[(mod, lineno, direction, (var, kind), form, n, floor)] of
    unguarded consumer demands across the project; ``floor`` is the
    dominating len() lower bound at the site (shorter producer
    variants are unreachable there)."""
    records = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            aliases = _aliases(node)
            tested = _kind_tested_vars(node, aliases)
            if not tested:
                continue
            from_call = _assigned_from_call(node)
            params = set()
            if node.name in _HANDLER_NAMES:
                params = {a.arg for a in node.args.args
                          if a.arg != "self"}
            directions = {}
            for var in tested:
                if var in params:
                    directions[var] = "request"
                elif var in from_call:
                    directions[var] = "response"
            if not directions:
                continue
            _ConsumerScan(mod, node, set(directions), aliases,
                          directions, records)
    return records


@register("wire-schema", "error",
          "frame producers and consumers of one (direction, kind) "
          "must agree on arity — unguarded unpacks/index reads are "
          "checked against every tuple the other side ships")
def check_wire_schema(project):
    producers = _collect_producers(project)
    findings = []
    for mod, lineno, direction, (var, kind), form, n, floor \
            in _collect_consumers(project):
        all_sites = producers.get((direction, kind))
        if not all_sites:
            continue            # no visible producer: nothing to judge
        # a dominating len() floor already screens out shorter
        # producer variants — this consumer can only ever SEE frames
        # of at least ``floor`` elements, so judge it against those
        sites = {a: s for a, s in all_sites.items() if a >= floor}
        if not sites:
            continue            # every producer is guard-rejected
        min_arity = min(sites)
        if form == "index" and min_arity <= n:
            pfile, pline = sites[min_arity]
            findings.append(Finding(
                mod.relpath, lineno, "wire-schema", "error",
                "%s[%d] reads element %d of a %r %s frame, but the "
                "producer at %s:%d ships only a %d-tuple"
                % (var, n, n, kind, direction, pfile, pline,
                   min_arity),
                "guard the read with `if len(%s) > %d:` (mixed-"
                "version peers), or grow every producer of this "
                "frame kind" % (var, n)))
        elif form == "exact":
            for arity in sorted(sites):
                if arity != n:
                    pfile, pline = sites[arity]
                    findings.append(Finding(
                        mod.relpath, lineno, "wire-schema", "error",
                        "tuple-unpacking %d element(s) from a %r %s "
                        "frame, but the producer at %s:%d ships a "
                        "%d-tuple — this unpack raises ValueError "
                        "at runtime"
                        % (n, kind, direction, pfile, pline, arity),
                        "unpack through an arity guard (`%s[:%d]` "
                        "after a len check, or try/except "
                        "ValueError) so mixed-version peers "
                        "degrade instead of crash" % (var, n)))
                    break
        elif form == "slice" and min_arity < n:
            pfile, pline = sites[min_arity]
            findings.append(Finding(
                mod.relpath, lineno, "wire-schema", "error",
                "unpacking %s[:%d] needs a %d-element %r %s frame, "
                "but the producer at %s:%d ships only a %d-tuple"
                % (var, n, n, kind, direction, pfile, pline,
                   min_arity),
                "check `len(%s) >= %d` first, or ship the missing "
                "elements from every producer" % (var, n)))
    return sorted(findings)
