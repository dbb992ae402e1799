"""resource-leak: every acquisition needs a release on every path.

The runtime is built from acquire/release pairs — sockets
(``socket.create_connection``), serving registries and decode
batchers (``.close()``), KV slot grants (``pool.grant()`` /
``pool.release(slot)``), background masters
(``start_background()`` / ``request_stop()``) — and the failure mode
that actually bites is never the happy path: it is the EXCEPTION
path, where a constructor or helper between the acquire and the
``try/finally`` raises and the resource outlives the function (the
PR-7 bench ``MasterServer`` leak: slaves built between
``start_background()`` and the ``finally`` meant one failed build
leaked the master's serving thread and listener for the rest of the
process).

The rule is function-local and deliberately conservative. It tracks
a resource from its acquisition site when the handle is a plain
local name (``sock = socket.create_connection(...)``) or a bare
discarded call (``pool.grant()`` with no assignment — a slot nobody
can ever release). Acquisitions stored straight into attributes,
containers or ``with`` items are owned elsewhere and skipped.
Recognized acquisitions:

* module functions: ``socket.socket``, ``socket.create_connection``,
  ``socket.create_server``, ``open`` (outside ``with``);
* methods: ``.grant()`` (KV slot pools — released by
  ``.release(slot)``), ``.start_background()`` (the handle is the
  receiver; released by ``request_stop``/``shutdown``/``kill``);
* constructors with a close contract: ``ModelRegistry``,
  ``ContinuousBatcher``.

From the acquisition forward, events on the handle are classified as
**release** (``.close()``/``.shutdown()``/``.stop()``/
``.request_stop()``/``.kill()``/``.server_close()`` on the handle,
or the handle passed to a ``.release(...)`` call), **escape**
(returned/yielded, stored into an attribute/subscript/container,
aliased, handed to a CapWord constructor or an
``append``/``add``/``put``/``register``-shaped call — ownership
moved, this function is off the hook), or **risky** (any other call
that can raise; calls ON the handle itself and benign
logging/builtin calls are exempt). Findings:

* **never released** — no release and no escape anywhere after the
  acquisition;
* **leaked on the exception path** — a risky call sits between the
  acquisition and the first release/escape WITHOUT a ``try`` whose
  ``finally``/``except`` releases the handle: if that call raises,
  the resource leaks.

Deliberate gaps (documented, not bugs): ``.accept()``'d sockets (the
reactor owns their lifecycle), handles whose risky window consists
only of calls on the handle itself (``sock.bind`` raising leaks an
fd — tolerated for brevity), and cross-function ownership transfer
through plain argument passing (borrowing a handle is not owning
it).
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

#: canonical dotted module functions that acquire (via the shared
#: import canonicalization, so aliasing cannot dodge them)
_ACQUIRE_FUNCS = {
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "socket.create_server": "listening socket",
}

#: methods whose RESULT is the resource handle (``slot = pool.grant()``)
_RESULT_METHODS = {
    "grant": "KV slot",
}

#: methods that turn their RECEIVER into the resource handle
#: (``server.start_background()`` — release via request_stop on the
#: receiver, whatever the call returned)
_RECEIVER_METHODS = {
    "start_background": "background server",
}

#: CapWord constructors with a close contract in this tree
_ACQUIRE_CTORS = {
    "ModelRegistry": "model registry",
    "ContinuousBatcher": "decode batcher",
}

_RELEASE_VERBS = frozenset((
    "close", "shutdown", "stop", "request_stop", "kill",
    "server_close", "release", "disconnect", "terminate"))

#: call names that take ownership of an argument (container adds,
#: registrations)
_ESCAPE_VERBS = frozenset(("append", "add", "put", "insert",
                           "register", "setdefault", "track"))

#: calls that cannot meaningfully fail mid-window (logging, trivial
#: builtins, clock reads)
_BENIGN_CALLS = frozenset((
    "len", "isinstance", "int", "float", "str", "repr", "bool",
    "min", "max", "round", "getattr", "hasattr", "print", "format",
    "debug", "info", "warning", "error", "exception", "log",
    "perf_counter", "monotonic", "time", "range", "sorted", "list",
    "dict", "tuple", "set"))


def _root_name(expr):
    """The base Name of an attribute/call chain, or None."""
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = expr.value if not isinstance(expr, ast.Call) \
            else expr.func
    return expr.id if isinstance(expr, ast.Name) else None


def _acquisition(stmt, prefixes):
    """(handle_name_or_None, call, what) when ``stmt`` acquires a
    trackable resource, else None. handle None = a bare discarded
    acquisition (leak by construction)."""
    call = None
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.value, ast.Call):
        call = stmt.value
    elif isinstance(stmt, ast.Expr) \
            and isinstance(stmt.value, ast.Call):
        call = stmt.value
    if call is None:
        return None
    name = engine.call_name(call)
    if name in _RECEIVER_METHODS \
            and isinstance(call.func, ast.Attribute):
        # the handle is the RECEIVER: server.start_background() is
        # released by server.request_stop(), whatever it returned
        if isinstance(call.func.value, ast.Name):
            return (call.func.value.id, call,
                    _RECEIVER_METHODS[name])
        return None       # self.X.start_background(): owned elsewhere
    what = _classify(call, prefixes)
    if what is None:
        return None
    if isinstance(stmt, ast.Expr):
        return None, call, what        # discarded handle
    target = stmt.targets[0]
    if isinstance(target, ast.Name):
        return target.id, call, what
    return None           # attribute/subscript store: owned elsewhere


def _classify(call, prefixes):
    """What resource a call acquires through its RESULT, or None."""
    name = engine.call_name(call)
    if name == "open" and isinstance(call.func, ast.Name):
        return "file handle"
    if name in _ACQUIRE_CTORS:
        return _ACQUIRE_CTORS[name]
    if name in _RESULT_METHODS \
            and isinstance(call.func, ast.Attribute):
        return _RESULT_METHODS[name]
    chain = engine.attr_chain(call.func)
    if chain:
        parts = chain.split(".")
        root = prefixes.get(parts[0], parts[0])
        canonical = ".".join([root] + parts[1:])
        if canonical in _ACQUIRE_FUNCS:
            return _ACQUIRE_FUNCS[canonical]
    return None


def _linear_statements(func):
    """[(stmt, try_stack, handler_tries, branches)] in source order,
    skipping nested defs; try_stack is the chain of enclosing
    ``ast.Try`` nodes whose BODY contains the statement,
    handler_tries the set of tries in whose ``except`` handlers it
    lives (a handler of the try that performed an acquisition runs
    on a path where the resource may never have existed), and
    branches maps each enclosing ``ast.If`` to the arm ("body"/
    "orelse") the statement sits in — sibling arms are mutually
    exclusive, so an acquisition in one arm is never live in the
    other."""
    out = []

    def walk(stmts, stack, handlers, branches):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            out.append((stmt, list(stack), set(handlers),
                        dict(branches)))
            if isinstance(stmt, ast.Try):
                walk(stmt.body, stack + [stmt], handlers, branches)
                for h in stmt.handlers:
                    walk(h.body, stack, handlers | {id(stmt)},
                         branches)
                walk(stmt.orelse, stack, handlers, branches)
                walk(stmt.finalbody, stack, handlers, branches)
                continue
            if isinstance(stmt, ast.If):
                walk(stmt.body, stack, handlers,
                     {**branches, id(stmt): "body"})
                walk(stmt.orelse, stack, handlers,
                     {**branches, id(stmt): "orelse"})
                continue
            for kind, child in engine.iter_stmt_children(stmt):
                if kind == "stmt":
                    walk([child], stack, handlers, branches)
    walk(func.body, [], set(), {})
    return out


def _releases_handle(stmts, handle):
    """True when a statement list (a finally/except body) releases
    ``handle``."""
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and _is_release(node, handle):
                return True
    return False


def _is_release(call, handle):
    name = engine.call_name(call)
    if name not in _RELEASE_VERBS:
        return False
    if isinstance(call.func, ast.Attribute) \
            and _root_name(call.func.value) == handle:
        return True
    # pool.release(slot): the handle rides as an argument
    return any(isinstance(a, ast.Name) and a.id == handle
               for a in call.args)


def _is_escape(node, handle):
    """True when ``node`` (a statement or expression) transfers
    ownership of ``handle`` out of this function."""
    if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
        # only the HANDLE itself (or a container shipping it) is an
        # ownership transfer; `return sock.getpeername()[0]` returns
        # a derived value and still owes the close
        value = node.value
        if value is None:
            return False
        if isinstance(value, ast.Name) and value.id == handle:
            return True
        if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
            return any(isinstance(e, ast.Name) and e.id == handle
                       for e in value.elts)
        return False
    if isinstance(node, ast.Assign):
        used = any(isinstance(s, ast.Name) and s.id == handle
                   for s in ast.walk(node.value))
        if not used:
            return False
        bare = isinstance(node.value, ast.Name) \
            and node.value.id == handle
        for t in node.targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                return True          # stored: owned elsewhere now
            if bare and isinstance(t, ast.Name) and t.id != handle:
                return True          # plain alias: `other = handle`
            if isinstance(t, (ast.Tuple, ast.List)):
                # only a STORE-shaped element makes this an escape;
                # `a, b = f(handle), g()` is a use, not a transfer
                if any(isinstance(e, (ast.Attribute, ast.Subscript))
                       for e in t.elts):
                    return True
        return False
    if isinstance(node, ast.Call):
        if not any(isinstance(a, ast.Name) and a.id == handle
                   for a in list(node.args)
                   + [kw.value for kw in node.keywords]):
            return False
        name = engine.call_name(node)
        if name and (name[:1].isupper() or name in _ESCAPE_VERBS):
            return True              # constructor / container add
    return False


def _calls_in(stmt):
    """Call nodes lexically in one statement's own expressions,
    nested defs/lambdas excluded (the shared scoped walk)."""
    out = []
    for kind, child in engine.iter_stmt_children(stmt):
        if kind == "expr":
            out.extend(engine.iter_calls(child))
    return out


def _scan_function(mod, func, prefixes, findings):
    ordered = _linear_statements(func)
    for idx, (stmt, acq_stack, _h, acq_branches) in enumerate(ordered):
        got = _acquisition(stmt, prefixes)
        if got is None:
            continue
        handle, call, what = got
        acq_tries = {id(t) for t in acq_stack}
        # `with` items and `return socket.socket()` are not leaks
        if isinstance(stmt, ast.Return):
            continue
        if handle is None:
            findings.append(Finding(
                mod.relpath, call.lineno, "resource-leak", "error",
                "%s acquired and immediately discarded — nothing "
                "can ever release it" % what,
                "bind the handle and release it (or drop the call "
                "if the resource is not needed)"))
            continue
        first_safe = None          # (order idx, stmt)
        risky = []                 # [(lineno, name, try_stack)]
        for jdx in range(idx + 1, len(ordered)):
            nstmt, nstack, nhandlers, nbranches = ordered[jdx]
            if nhandlers & acq_tries:
                # a handler of the try the acquisition sits in: on
                # this path the acquisition may never have happened
                continue
            if any(nbranches.get(k) not in (None, arm)
                   for k, arm in acq_branches.items()):
                # the sibling arm of a conditional the acquisition
                # sits in: mutually exclusive, never the same path
                continue
            # a re-acquisition into the same name restarts tracking
            regot = _acquisition(nstmt, prefixes)
            if regot is not None and regot[0] == handle:
                break
            if _is_escape(nstmt, handle):
                first_safe = jdx
                break
            hit_safe = False
            for ncall in _calls_in(nstmt):
                if _is_release(ncall, handle) \
                        or _is_escape(ncall, handle):
                    hit_safe = True
                    break
                name = engine.call_name(ncall)
                if name in _BENIGN_CALLS:
                    continue
                root = _root_name(ncall.func)
                if root == handle:
                    continue       # calls on the handle itself
                risky.append((ncall.lineno, name or "?", nstack))
            if hit_safe:
                first_safe = jdx
                break
        if first_safe is None:
            findings.append(Finding(
                mod.relpath, call.lineno, "resource-leak", "error",
                "%s %r acquired here is never released on any path "
                "out of %s()" % (what, handle, func.name),
                "release it in a finally (or `with "
                "contextlib.closing(...)`), or return/store the "
                "handle so an owner can"))
            continue
        unprotected = [
            (line, name) for line, name, stack in risky
            if not any(
                _releases_handle(t.finalbody, handle)
                or any(_releases_handle(h.body, handle)
                       for h in t.handlers)
                for t in stack)]
        if unprotected:
            line, name = unprotected[0]
            findings.append(Finding(
                mod.relpath, call.lineno, "resource-leak", "error",
                "%s %r leaks if %s() at line %d raises — the "
                "release does not happen until line %d and no "
                "try/finally covers the gap"
                % (what, handle, name, line,
                   ordered[first_safe][0].lineno),
                "move the acquisition-to-release span into "
                "try/finally (acquire; try: ...; finally: "
                "release), or release in an except before "
                "re-raising"))
    return findings


@register("resource-leak", "error",
          "acquired resources (sockets, registries, KV slots, "
          "background servers) must be released on every path, "
          "exception edges included", scope="module")
def check_resource_leak(project):
    findings = []
    for mod in project.modules:
        prefixes = engine.canonical_import_prefixes(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                _scan_function(mod, node, prefixes, findings)
    return findings
