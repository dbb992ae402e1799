"""The shared whole-program analysis engine under every rule pack.

Before this module, each rule pack grew its own call resolution —
``rules_threads`` carried ~130 lines of ``self.method``/module-alias/
symbol-import resolution, ``rules_reactor`` its own callback-target
resolver, ``rules_purity`` a third copy specialized to ops helpers —
and none of them could see ACROSS functions in a principled way. This
module factors all of that into one place:

* **name helpers** — :func:`call_name`, :func:`attr_chain`,
  :func:`receiver_name`, :func:`assigned_name`,
  :func:`canonical_import_prefixes`: the small AST spellings every
  rule needs;
* **statement traversal** — :func:`iter_stmt_children` /
  :func:`walk_statements`: child iteration that descends the
  structural carriers (``ExceptHandler``, ``match_case``) whose
  bodies are exactly where retry/error paths live, so no rule grows a
  blind spot there again;
* **:class:`CallGraph`** — interprocedural call resolution over a
  :class:`~veles_torch.analysis.core.Project`: direct calls,
  ``self.method`` (hierarchy-merged), ``self.attr.method`` through
  ``__init__`` type bindings, module-alias and symbol-import calls,
  constructor calls, and module-level instance methods. One resolver,
  one behavior, every rule;
* **reactor-context enumeration** — :func:`reactor_callbacks` /
  :func:`schedule_sites` / :func:`resolve_callable`: the shared
  answer to "which functions run ON the loop" (``on_frame``/
  ``on_timer`` methods plus ``call_soon``/``call_later``/``every``/
  ``post`` targets), used by ``reactor-purity``,
  ``profiler-safety`` and ``loop-exception-safety`` alike;
* **:class:`ForwardDataflow`** — a generic forward fixpoint over the
  call graph: facts seed at entry functions and flow caller→callee
  through a rule-supplied transfer function until no new
  (function, fact) state appears. ``loop-exception-safety`` runs on
  it with caught-exception sets as the lattice;
* **graph utilities** — :func:`tarjan_sccs` (the lock-order cycle
  detector), exception-hierarchy queries (:func:`exception_covered`)
  shared by the dataflow rules.

Everything here is pure AST work over the already-parsed project —
the engine never re-reads a file.
"""

import ast

#: bound on interprocedural walk depth — cycles are caught by the
#: per-walk visited sets, this only caps pathological chains
MAX_DEPTH = 40

# -- name helpers -------------------------------------------------------


def call_name(node):
    """The rightmost simple name a call invokes (``a.b.f()`` -> 'f',
    ``f()`` -> 'f'), or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def attr_chain(expr):
    """Dotted name of an attribute chain (``a.b.c`` -> 'a.b.c'), or
    None when the chain does not root in a plain Name."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def receiver_name(node):
    """The rightmost name of a call receiver: ``a.b.profiler`` ->
    'profiler', ``profiler`` -> 'profiler', else ''."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return receiver_name(node.func)
    return ""


def target_key(t):
    """A comparable key for an assignment target: ``x`` -> "x",
    ``self.x`` -> "self.x", else None."""
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
        return "%s.%s" % (t.value.id, t.attr)
    return None


def assigned_name(mod, call):
    """The Name/self-attribute a constructor call is assigned to, as
    a comparable key ("x" or "self.x"), or None for a bare call."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and node.value is call:
            return target_key(node.targets[0])
    return None


def canonical_import_prefixes(mod):
    """local name -> canonical dotted path, resolving every import
    style (``import numpy as np``, ``from numpy import random``,
    ``from time import monotonic``) so namespace bans cannot be
    dodged by how a module was imported."""
    out = {}
    for local, target in mod.imports.items():
        if target[0] == "module":
            dotted = target[1]
            if "." in dotted and local == dotted.split(".")[0]:
                # plain ``import numpy.random`` binds the TOP package
                # name; the attribute chain spells out the rest
                dotted = local
        else:
            dotted = "%s.%s" % (target[1], target[2])
        out[local] = dotted
    return out


# -- statement traversal ------------------------------------------------


def iter_stmt_children(node):
    """Yield ``("stmt", s)`` / ``("expr", e)`` for the children of a
    statement, descending structural nodes that are neither stmt nor
    expr but CARRY statements (``ExceptHandler``, ``match_case``) —
    their bodies are exactly where retry/error paths live, so
    skipping them silently weakens every rule built on this."""
    for field in ast.iter_child_nodes(node):
        if isinstance(field, ast.stmt):
            yield "stmt", field
        elif isinstance(field, ast.expr):
            yield "expr", field
        else:
            for sub in ast.iter_child_nodes(field):
                if isinstance(sub, ast.stmt):
                    yield "stmt", sub
                elif isinstance(sub, ast.expr):
                    yield "expr", sub


def walk_statements(func):
    """Every statement in ``func``'s body, in source order, WITHOUT
    descending into nested function/class definitions (they execute
    later, not here)."""
    out = []

    def walk(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            out.append(stmt)
            for kind, child in iter_stmt_children(stmt):
                if kind == "stmt":
                    walk([child])
    walk(func.body)
    return out


def scoped_nodes(node):
    """Every node under ``node`` that executes in ITS scope — nested
    function/lambda/class subtrees are skipped (they run later,
    elsewhere). The shared spelling of the walk a half-dozen rules
    used to hand-roll."""
    out = []

    def walk(cur):
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda,
                                  ast.ClassDef)):
                continue
            out.append(child)
            walk(child)
    walk(node)
    return out


def iter_calls(node):
    """Call nodes at or under ``node`` that execute in its scope
    (nested def/lambda bodies excluded — a deferred closure's calls
    run on whatever thread runs IT, not here)."""
    out = [node] if isinstance(node, ast.Call) else []
    out.extend(n for n in scoped_nodes(node)
               if isinstance(n, ast.Call))
    return out


def novel_calls(mod, func, seen, classify):
    """Yield ``(call, label)`` for each call in ``func`` that
    ``classify`` recognizes and that has not been reported yet —
    the shared dedup shell of every scan-a-callback rule. ``seen``
    is keyed (relpath, lineno, label) across contexts, so a method
    that is both a conventional callback and a scheduled target is
    reported once."""
    for sub in ast.walk(func):
        if not isinstance(sub, ast.Call):
            continue
        label = classify(sub)
        if label is None:
            continue
        key = (mod.relpath, sub.lineno, label)
        if key in seen:
            continue
        seen.add(key)
        yield sub, label


def test_mentions(test, markers):
    """True when an if-test contains a string constant carrying any
    of ``markers`` — the branch-detection convention route rules key
    on (``==``, ``startswith``, tuple membership: any spelling)."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Constant) \
                and isinstance(sub.value, str) \
                and any(m in sub.value for m in markers):
            return True
    return False


def nested_functions(func):
    """{name: FunctionDef} of the function/async defs nested anywhere
    inside ``func`` (excluding ``func`` itself)."""
    out = {}
    for node in ast.walk(func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not func:
            out[node.name] = node
    return out


# -- the interprocedural call graph -------------------------------------


class Target:
    """One resolved callee: where it lives and what to call it in a
    diagnostic chain."""

    __slots__ = ("module", "cls", "func", "label")

    def __init__(self, module, cls, func, label):
        self.module = module    # Module the definition lives in
        self.cls = cls          # ClassInfo or None
        self.func = func        # FunctionDef / AsyncFunctionDef
        self.label = label      # "Class.meth" / "alias.func" / name


class CallGraph:
    """Interprocedural call resolution over a Project.

    One resolver for every rule pack: ``self.method(...)`` through
    the hierarchy-merged method table, ``self.attr.method(...)``
    through ``__init__`` type bindings (base-class bindings
    included), module-alias calls (``telemetry.counter(...)``),
    symbol imports (``from x import f``; also the ``from veles_torch
    import telemetry`` module-through-symbol form), module-level
    functions, constructor calls (resolved to ``__init__``) and
    methods on module-level typed instances. Unresolvable calls
    return None — every rule on this graph is conservative by
    construction."""

    def __init__(self, project):
        self.project = project

    def _module_for(self, dotted):
        return self.project.module_by_dotted(dotted)

    def resolve(self, ctx_mod, ctx_cls, call):
        """-> :class:`Target` or None for one ``ast.Call``."""
        fn = call.func
        # self.method(...)
        if isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Name):
            base = fn.value.id
            if base == "self" and ctx_cls is not None:
                cls, meth = self.project.find_method(ctx_cls, fn.attr)
                if meth is not None:
                    return Target(cls.module, cls, meth,
                                  "%s.%s" % (cls.name, fn.attr))
                return None
            # module_alias.func(...) / global_instance.method(...)
            target = ctx_mod.imports.get(base)
            if target and target[0] == "symbol":
                # ``from veles_torch import telemetry`` imports a MODULE
                # through the symbol form — resolve it as one
                if self._module_for("%s.%s" % (target[1], target[2])):
                    target = ("module",
                              "%s.%s" % (target[1], target[2]))
            if target and target[0] == "module":
                mod = self._module_for(target[1])
                if mod and fn.attr in mod.functions:
                    return Target(mod, None, mod.functions[fn.attr],
                                  "%s.%s" % (base, fn.attr))
                if mod and fn.attr in mod.classes:
                    cls = mod.classes[fn.attr]
                    ini = cls.methods.get("__init__")
                    if ini is not None:
                        return Target(mod, cls, ini,
                                      "%s.__init__" % fn.attr)
                return None
            tname = ctx_mod.global_types.get(base)
            if tname:
                for cls in self.project.class_index.get(tname, ()):
                    meth = cls.methods.get(fn.attr)
                    if meth is not None:
                        return Target(cls.module, cls, meth,
                                      "%s.%s" % (tname, fn.attr))
            return None
        # self.attr.method(...) via __init__ type binding (the attr
        # may be bound by a BASE class's __init__ — merge hierarchy)
        if isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Attribute) \
                and isinstance(fn.value.value, ast.Name) \
                and fn.value.value.id == "self" and ctx_cls is not None:
            tname = self.project.class_attr_types(ctx_cls) \
                .get(fn.value.attr)
            if tname:
                for cls in self.project.class_index.get(tname, ()):
                    meth = cls.methods.get(fn.attr)
                    if meth is not None:
                        return Target(cls.module, cls, meth,
                                      "%s.%s" % (tname, fn.attr))
            return None
        if isinstance(fn, ast.Name):
            name = fn.id
            if name in ctx_mod.functions:
                return Target(ctx_mod, None, ctx_mod.functions[name],
                              name)
            if name in ctx_mod.classes:
                cls = ctx_mod.classes[name]
                ini = cls.methods.get("__init__")
                if ini is not None:
                    return Target(ctx_mod, cls, ini,
                                  "%s.__init__" % name)
            target = ctx_mod.imports.get(name)
            if target and target[0] == "symbol":
                mod = self._module_for(target[1])
                if mod:
                    if target[2] in mod.functions:
                        return Target(mod, None,
                                      mod.functions[target[2]], name)
                    if target[2] in mod.classes:
                        cls = mod.classes[target[2]]
                        ini = cls.methods.get("__init__")
                        if ini is not None:
                            return Target(mod, cls, ini,
                                          "%s.__init__" % name)
        return None

    def iter_functions(self):
        """Every (module, cls_or_None, funcdef, label) definition in
        the project — the node set of the graph."""
        for mod in self.project.modules:
            for func in mod.functions.values():
                yield mod, None, func, func.name
            for cls in mod.classes.values():
                for mname, meth in cls.methods.items():
                    yield mod, cls, meth, "%s.%s" % (cls.name, mname)


# -- reactor-context enumeration ----------------------------------------

#: reactor scheduling API: the (position of the) callback argument
SCHEDULE_CALLS = {"call_soon": 0, "call_later": 1, "every": 1,
                  "post": 0}

#: conventional reactor callback method names. on_readable/on_writable
#: are excluded on purpose — they ARE the I/O layer (the one place
#: recv/send on the non-blocking socket is the job).
CALLBACK_METHODS = frozenset(("on_frame", "on_timer"))


def schedule_sites(mod):
    """[(call, enclosing ClassDef or None, enclosing function
    stack)] for every ``call_soon``/``call_later``/``every``/``post``
    call in the module, with scope tracked during the descent."""
    out = []

    def walk(node, cls_node, func_stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child, func_stack)
                continue
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                walk(child, cls_node, func_stack + [child])
                continue
            if isinstance(child, ast.Call) \
                    and call_name(child) in SCHEDULE_CALLS:
                out.append((child, cls_node, list(func_stack)))
            walk(child, cls_node, func_stack)

    walk(mod.tree, None, [])
    return out


def resolve_callable(cb, mod, cls_node, func_stack):
    """The FunctionDef/Lambda a callback REFERENCE names, resolved
    conservatively: a lambda inline, a Name through the enclosing
    function scopes then module functions, or a ``self.method`` on
    the enclosing class; -> (func, description) or (None, None)."""
    if isinstance(cb, ast.Lambda):
        return cb, "<lambda>"
    if isinstance(cb, ast.Name):
        for enclosing in reversed(func_stack):
            for sub in ast.walk(enclosing):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)) \
                        and sub.name == cb.id:
                    return sub, cb.id
        fn = mod.functions.get(cb.id)
        if fn is not None:
            return fn, cb.id
        return None, None
    if isinstance(cb, ast.Attribute) \
            and isinstance(cb.value, ast.Name) \
            and cb.value.id == "self" and cls_node is not None:
        info = mod.classes.get(cls_node.name)
        if info is not None and cb.attr in info.methods:
            return (info.methods[cb.attr],
                    "%s.%s" % (cls_node.name, cb.attr))
    return None, None


def reactor_callbacks(project):
    """Every function that runs ON the reactor loop, with its class
    context: ``on_frame``/``on_timer`` methods and the resolvable
    targets of ``call_soon``/``call_later``/``every``/``post`` calls;
    -> [(mod, cls_node_or_None, func, where-description)]. The same
    function may appear more than once (a method that is also
    scheduled) — consumers dedupe findings, not contexts."""
    cached = getattr(project, "_reactor_callbacks_cache", None)
    if cached is not None:
        return cached
    out = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and item.name in CALLBACK_METHODS:
                    out.append((mod, node, item,
                                "%s.%s" % (node.name, item.name)))
        for call, cls_node, func_stack in schedule_sites(mod):
            pos = SCHEDULE_CALLS[call_name(call)]
            if len(call.args) <= pos:
                continue
            target, desc = resolve_callable(
                call.args[pos], mod, cls_node, func_stack)
            if target is not None:
                out.append((mod, cls_node, target,
                            "%s (scheduled at line %d)"
                            % (desc, call.lineno)))
    # memoized per Project: three rule packs enumerate the same
    # loop contexts, and the project is immutable once built
    project._reactor_callbacks_cache = out
    return out


# -- exception hierarchy ------------------------------------------------

#: builtin exception -> direct base (enough of the stdlib tree for
#: coverage queries; anything unknown is assumed rooted at Exception)
_BUILTIN_BASES = {
    "ConnectionError": "OSError",
    "ConnectionResetError": "ConnectionError",
    "ConnectionAbortedError": "ConnectionError",
    "ConnectionRefusedError": "ConnectionError",
    "BrokenPipeError": "ConnectionError",
    "TimeoutError": "OSError",
    "InterruptedError": "OSError",
    "BlockingIOError": "OSError",
    "FileNotFoundError": "OSError",
    "FileExistsError": "OSError",
    "PermissionError": "OSError",
    "IsADirectoryError": "OSError",
    "NotADirectoryError": "OSError",
    "ChildProcessError": "OSError",
    "ProcessLookupError": "OSError",
    "IOError": "OSError",
    "KeyError": "LookupError",
    "IndexError": "LookupError",
    "ZeroDivisionError": "ArithmeticError",
    "OverflowError": "ArithmeticError",
    "FloatingPointError": "ArithmeticError",
    "UnicodeDecodeError": "UnicodeError",
    "UnicodeEncodeError": "UnicodeError",
    "UnicodeError": "ValueError",
    "NotImplementedError": "RuntimeError",
    "RecursionError": "RuntimeError",
    "IndentationError": "SyntaxError",
    "ModuleNotFoundError": "ImportError",
    "OSError": "Exception",
    "LookupError": "Exception",
    "ArithmeticError": "Exception",
    "ValueError": "Exception",
    "RuntimeError": "Exception",
    "SyntaxError": "Exception",
    "ImportError": "Exception",
    "TypeError": "Exception",
    "AttributeError": "Exception",
    "NameError": "Exception",
    "StopIteration": "Exception",
    "AssertionError": "Exception",
    "MemoryError": "Exception",
    "EOFError": "Exception",
    "BufferError": "Exception",
    "ReferenceError": "Exception",
    "Exception": "BaseException",
    "KeyboardInterrupt": "BaseException",
    "SystemExit": "BaseException",
    "GeneratorExit": "BaseException",
}


def exception_ancestors(name, project):
    """The simple-name ancestor set of exception type ``name``
    (itself included): project classes walk their ``bases`` into the
    builtin table; unknown names conservatively root at Exception."""
    out = set()
    stack = [name]
    while stack:
        cur = stack.pop()
        if cur in out:
            continue
        out.add(cur)
        infos = project.class_index.get(cur, ())
        if infos:
            for info in infos:
                stack.extend(info.bases)
        elif cur in _BUILTIN_BASES:
            stack.append(_BUILTIN_BASES[cur])
        elif cur not in ("BaseException",):
            stack.append("Exception")
    return out


def exception_covered(raised, caught_names, project):
    """True when an exception of simple-name type ``raised`` is
    caught by a handler naming any of ``caught_names`` ("" = a bare
    ``except:``)."""
    if "" in caught_names or "BaseException" in caught_names:
        return True
    return bool(exception_ancestors(raised, project) & caught_names)


def handler_names(handler):
    """The simple type names one ``except`` clause catches ("" for a
    bare ``except:``; tuples are flattened)."""
    t = handler.type
    if t is None:
        return {""}
    out = set()
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        if isinstance(e, ast.Attribute):
            out.add(e.attr)
        elif isinstance(e, ast.Name):
            out.add(e.id)
    return out


# -- generic forward dataflow -------------------------------------------


class ForwardDataflow:
    """Generic forward-dataflow fixpoint over the call graph.

    Facts attach to (function, fact) states and flow caller→callee: a
    rule seeds entry states (:meth:`entries`), and for each state the
    rule's :meth:`transfer` walks the function body — recording any
    findings it likes — and yields ``(call_node, fact)`` pairs for
    the calls it wants followed. The driver resolves each call
    through the shared :class:`CallGraph` and enqueues the callee
    with the transferred fact; a (function, fact) pair is processed
    at most once, so the iteration reaches a fixpoint whenever facts
    are drawn from a finite lattice (frozensets of names, small
    tuples). Each state carries the diagnostic ``chain`` of labels
    that reached it.

    Subclass hooks:

    * ``entries()`` -> iterable of (mod, cls, func, fact, label)
    * ``transfer(mod, cls, func, fact, chain)`` -> iterable of
      (call_node, fact_for_callee)
    """

    def __init__(self, project):
        self.project = project
        self.graph = CallGraph(project)

    def entries(self):
        raise NotImplementedError

    def transfer(self, mod, cls, func, fact, chain):
        raise NotImplementedError

    def run(self):
        seen = set()
        work = []
        for mod, cls, func, fact, label in self.entries():
            key = (id(func), fact)
            if key not in seen:
                seen.add(key)
                work.append((mod, cls, func, fact, (label,)))
        while work:
            mod, cls, func, fact, chain = work.pop()
            if len(chain) > MAX_DEPTH:
                continue
            for call, out_fact in self.transfer(mod, cls, func, fact,
                                                chain):
                target = self.graph.resolve(mod, cls, call)
                if target is None:
                    continue
                key = (id(target.func), out_fact)
                if key in seen:
                    continue
                seen.add(key)
                work.append((target.module, target.cls, target.func,
                             out_fact, chain + (target.label,)))


# -- taint analysis -----------------------------------------------------

#: taint kinds — where an untrusted value originally entered
TAINT_WIRE = "wire"    # pickled master<->slave frame payloads
TAINT_HTTP = "http"    # HTTP bodies/headers/paths, fetched JSON
TAINT_ENV = "env"      # process environment overrides
_CONCRETE_KINDS = frozenset((TAINT_WIRE, TAINT_HTTP, TAINT_ENV))

#: handler methods whose parameters ARE the wire payload: the frame
#: dispatch entry points (transport HMAC authenticates the PEER, it
#: does not bound what the payload asks for)
WIRE_HANDLER_NAMES = frozenset((
    "handle", "on_frame", "apply_data_from_master",
    "apply_data_from_slave"))

#: attribute reads that are HTTP input wherever they appear
_HTTP_ATTRS = frozenset(("headers", "body"))
#: request-only attributes (too generic to taint on any receiver)
_HTTP_REQ_ATTRS = frozenset(("path", "query"))
_REQUESTISH = frozenset(("request", "req"))

#: unresolvable call names that read raw bytes off a socket
_RECV_NAMES = frozenset(("recv", "recv_into", "recvfrom",
                         "recv_frame", "recv_raw_frame"))

#: substrings that mark a call a sanitizer by naming convention —
#: the telemetry-hygiene ``*resolve*`` escape hatch, generalized
_SANITIZER_MARKERS = ("resolve", "sanitize", "clamp", "validate")

#: allocation-geometry sinks: first argument / shape keyword sizes
#: the allocation
_GEOMETRY_CALLS = frozenset(("zeros", "ones", "empty", "full",
                             "arange", "bytearray", "range"))
_GEOMETRY_KWARGS = frozenset(("shape", "size", "maxlen"))

#: keyword names that denote a filesystem/store target at any call
_PATH_KEYWORDS = frozenset(("path", "filename", "directory",
                            "dirname", "checkpoint", "store",
                            "refresh_store", "store_target"))
#: os.* names that are NOT path sinks
_PATH_SAFE = frozenset(("getenv", "environ", "getpid", "cpu_count",
                        "urandom", "fspath", "getcwd", "strerror",
                        "dup", "close", "read", "write", "pipe",
                        "fork", "kill", "waitpid", "sched_getaffinity"))


class TaintHit:
    """One tainted value reaching a sink, with its diagnostic chain."""

    __slots__ = ("module", "lineno", "sink", "kinds", "chain",
                 "detail")

    def __init__(self, module, lineno, sink, kinds, chain, detail):
        self.module = module    # Module the sink statement lives in
        self.lineno = lineno
        self.sink = sink        # "geometry"|"cardinality"|"path"|...
        self.kinds = kinds      # frozenset of TAINT_* kinds involved
        self.chain = chain      # label tuple from the entry function
        self.detail = detail    # human fragment naming the sink


def _annotated_sanitizer(mod, node):
    """True when a def/class carries ``# zlint: sanitizer`` on its
    own line, the line above, or a decorator line."""
    lines = mod.sanitizer_lines
    if node.lineno in lines or (node.lineno - 1) in lines:
        return True
    return any(d.lineno in lines
               for d in getattr(node, "decorator_list", ()))


def _sanitizer_named(name):
    low = (name or "").lower()
    return any(m in low for m in _SANITIZER_MARKERS)


def _bounded_container(mod_of_class, cls_name, project):
    """True when a container's constructor class is bounded: the
    class name says so (``Bounded*``/``*LRU*``) or the class def is
    annotated ``# zlint: sanitizer`` (the recipe for custom capped
    mappings)."""
    low = (cls_name or "").lower()
    if "bounded" in low or "lru" in low:
        return True
    for info in project.class_index.get(cls_name, ()):
        if _annotated_sanitizer(info.module, info.node):
            return True
    return False


def _guard_names(test):
    """Names a test bounds by comparison, membership, or isinstance —
    the 'explicit range/type guard' sanitizer: after the programmer
    compared a value against anything, both branches are treated as
    examined."""
    out = set()
    for sub in ast.walk(test):
        if isinstance(sub, ast.Compare):
            for operand in [sub.left] + list(sub.comparators):
                for n in ast.walk(operand):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
        elif isinstance(sub, ast.Call) \
                and call_name(sub) == "isinstance" and sub.args \
                and isinstance(sub.args[0], ast.Name):
            out.add(sub.args[0].id)
    return out


def _calls_compare_digest(node):
    """True when the subtree performs an HMAC verification."""
    return any(isinstance(sub, ast.Call)
               and call_name(sub) == "compare_digest"
               for sub in ast.walk(node))


def _param_names(func, skip_self):
    a = func.args
    names = [p.arg for p in
             list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
    if skip_self and names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


def map_call_args(call, target):
    """{callee param name: caller arg expr} for one resolved call
    (self offset applied for methods/constructors; *args stops the
    positional map)."""
    func = target.func
    pos = list(func.args.posonlyargs) + list(func.args.args)
    names = [p.arg for p in pos]
    if target.cls is not None and names and names[0] in ("self", "cls"):
        names = names[1:]
    out = {}
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if i < len(names):
            out[names[i]] = arg
    allowed = set(names) | {p.arg for p in func.args.kwonlyargs}
    for kw in call.keywords:
        if kw.arg and kw.arg in allowed:
            out[kw.arg] = kw.value
    return out


def _merge_env(env, a, b):
    for key in set(a) | set(b):
        tags = a.get(key, frozenset()) | b.get(key, frozenset())
        if tags:
            env[key] = tags
        else:
            env.pop(key, None)


class _TaintScan:
    """One intraprocedural pass: statement-ordered taint tracking
    with sink checks, guard/sanitizer kills, nested-def inlining and
    per-call interprocedural hand-off facts."""

    def __init__(self, eng, mod, cls, func, chain, summary_mode):
        self.eng = eng
        self.mod = mod
        self.cls = cls
        self.func = func
        self.chain = chain
        self.summary = summary_mode
        self.ret_tags = set()
        self.calls_out = []       # (call node, fact frozenset)
        self.hmac_ok = False
        self._nested = None       # lazy {name: FunctionDef}
        self._nested_active = set()

    # -- driving ---------------------------------------------------

    def run(self, env, hmac_ok):
        self.hmac_ok = hmac_ok
        self._suite(self.func.body, env)

    def _suite(self, stmts, env):
        for stmt in stmts:
            self._stmt(stmt, env)

    def _stmt(self, stmt, env):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                     # inlined at call sites instead
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, env)
            if _calls_compare_digest(stmt.test):
                self.hmac_ok = True
            for name in _guard_names(stmt.test):
                env.pop(name, None)
            body_env, else_env = dict(env), dict(env)
            self._suite(stmt.body, body_env)
            self._suite(stmt.orelse, else_env)
            _merge_env(env, body_env, else_env)
            return
        if isinstance(stmt, (ast.While,)):
            self._expr(stmt.test, env)
            for name in _guard_names(stmt.test):
                env.pop(name, None)
            self._loop_body(stmt.body, env)
            self._suite(stmt.orelse, env)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, env)
            self._bind(stmt.target, self._taint_of(stmt.iter, env),
                       env)
            self._loop_body(stmt.body, env)
            self._suite(stmt.orelse, env)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars,
                               self._taint_of(item.context_expr, env),
                               env)
            self._suite(stmt.body, env)
            return
        if isinstance(stmt, ast.Try):
            self._suite(stmt.body, env)
            for handler in stmt.handlers:
                h_env = dict(env)
                self._suite(handler.body, h_env)
                _merge_env(env, env, h_env)
            self._suite(stmt.orelse, env)
            self._suite(stmt.finalbody, env)
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value, env)
            tags = self._taint_of(stmt.value, env)
            for tgt in stmt.targets:
                self._store(tgt, tags, env)
            if _calls_compare_digest(stmt.value):
                self.hmac_ok = True
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value, env)
                self._store(stmt.target,
                            self._taint_of(stmt.value, env), env)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, env)
            tags = self._taint_of(stmt.value, env)
            if isinstance(stmt.target, ast.Name):
                env[stmt.target.id] = \
                    env.get(stmt.target.id, frozenset()) | tags
            elif isinstance(stmt.target, ast.Subscript):
                self._growth(stmt.target, env)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._expr(stmt.value, env)
                if self.summary:
                    self.ret_tags |= self._taint_of(stmt.value, env)
            return
        for kind, child in iter_stmt_children(stmt):
            if kind == "expr":
                self._expr(child, env)
        if _calls_compare_digest(stmt):
            self.hmac_ok = True

    def _loop_body(self, body, env):
        # two passes so loop-carried taint (buf += chunk) reaches
        # uses textually above the assignment; sink dedup keeps the
        # second pass from double-reporting
        before = dict(env)
        self._suite(body, env)
        _merge_env(env, env, before)
        self._suite(body, env)

    def _bind(self, target, tags, env):
        if isinstance(target, ast.Name):
            if tags:
                env[target.id] = tags
            else:
                env.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tags, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tags, env)

    def _store(self, target, tags, env):
        if isinstance(target, ast.Subscript):
            self._growth(target, env)
            return
        self._bind(target, tags, env)

    # -- expression taint ------------------------------------------

    def _taint_of(self, expr, env):
        if expr is None or isinstance(expr, (ast.Constant, ast.Lambda)):
            return frozenset()
        if isinstance(expr, ast.Name):
            return env.get(expr.id, frozenset())
        if isinstance(expr, ast.Attribute):
            tags = set(self._taint_of(expr.value, env))
            if expr.attr in _HTTP_ATTRS:
                tags.add(TAINT_HTTP)
            elif expr.attr in _HTTP_REQ_ATTRS \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id in _REQUESTISH:
                tags.add(TAINT_HTTP)
            elif expr.attr == "environ":
                tags.add(TAINT_ENV)
            return frozenset(tags)
        if isinstance(expr, ast.Call):
            return self._call_taint(expr, env)
        if isinstance(expr, ast.Subscript):
            # value chosen BY a tainted key out of a trusted bounded
            # container is trusted; a tainted container's items are not
            return self._taint_of(expr.value, env)
        if isinstance(expr, ast.Compare):
            return frozenset()         # a bool is bounded
        if isinstance(expr, ast.IfExp):
            guarded = _guard_names(expr.test)
            inner = {k: v for k, v in env.items() if k not in guarded}
            return self._taint_of(expr.body, inner) \
                | self._taint_of(expr.orelse, inner)
        if isinstance(expr, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp, ast.DictComp)):
            env2 = self._comp_env(expr, env)
            if isinstance(expr, ast.DictComp):
                return self._taint_of(expr.key, env2) \
                    | self._taint_of(expr.value, env2)
            return self._taint_of(expr.elt, env2)
        out = set()
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                out |= self._taint_of(child, env)
        return frozenset(out)

    def _call_taint(self, call, env):
        name = call_name(call) or ""
        if _sanitizer_named(name):
            return frozenset()
        if name == "len":
            # a length is proportional to bytes the transport already
            # capped — not attacker amplification
            return frozenset()
        if name == "min" and len(call.args) >= 2:
            arg_tags = [self._taint_of(a, env) for a in call.args]
            if any(not t for t in arg_tags):
                return frozenset()     # clamped by an untainted bound
        if name == "getenv" or attr_chain(call.func) in (
                "os.environ.get",):
            return frozenset((TAINT_ENV,))
        if name == "urlopen":
            return frozenset((TAINT_HTTP,))
        if name in _RECV_NAMES:
            return frozenset((TAINT_WIRE,))
        target = self.eng.graph.resolve(self.mod, self.cls, call)
        if target is not None:
            if _sanitizer_named(target.label) or _annotated_sanitizer(
                    target.module, target.func):
                return frozenset()
            ret_kinds, ret_params = self.eng.summary_for(target.func)
            tags = set(ret_kinds)
            argmap = map_call_args(call, target)
            for pname in ret_params:
                if pname in argmap:
                    tags |= self._taint_of(argmap[pname], env)
            return frozenset(tags)
        if name == "get" and isinstance(call.func, ast.Attribute):
            # bounded-lookup shape: dict.get(tainted_key) returns a
            # value from the RECEIVER's universe
            return self._taint_of(call.func.value, env)
        out = set()
        if isinstance(call.func, ast.Attribute):
            out |= self._taint_of(call.func.value, env)
        for arg in call.args:
            out |= self._taint_of(arg, env)
        for kw in call.keywords:
            out |= self._taint_of(kw.value, env)
        return frozenset(out)

    def _comp_env(self, comp, env):
        env2 = dict(env)
        for gen in comp.generators:
            self._bind(gen.target, self._taint_of(gen.iter, env2),
                       env2)
            for cond in gen.ifs:
                for nm in _guard_names(cond):
                    env2.pop(nm, None)
        return env2

    # -- sink + propagation walk -----------------------------------

    def _expr(self, expr, env):
        if expr is None or not isinstance(expr, ast.expr) \
                or isinstance(expr, ast.Lambda):
            return
        if isinstance(expr, ast.Call):
            self._check_call(expr, env)
            self._expr(expr.func, env)
            for arg in expr.args:
                self._expr(arg, env)
            for kw in expr.keywords:
                self._expr(kw.value, env)
            return
        if isinstance(expr, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp, ast.DictComp)):
            env2 = self._comp_env(expr, env)
            for gen in expr.generators:
                self._expr(gen.iter, env)
                for cond in gen.ifs:
                    self._expr(cond, env2)
            if isinstance(expr, ast.DictComp):
                self._expr(expr.key, env2)
                self._expr(expr.value, env2)
            else:
                self._expr(expr.elt, env2)
            return
        if isinstance(expr, ast.BinOp) \
                and isinstance(expr.op, ast.Mult):
            self._check_mult(expr, env)
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self._expr(child, env)

    def _check_mult(self, binop, env):
        for side, other in ((binop.left, binop.right),
                            (binop.right, binop.left)):
            literal = isinstance(other, (ast.List, ast.Tuple)) or (
                isinstance(other, ast.Constant)
                and isinstance(other.value, (str, bytes)))
            if not literal:
                continue
            kinds = self._taint_of(side, env) \
                & frozenset((TAINT_WIRE, TAINT_HTTP))
            if kinds:
                self._hit(binop, "geometry", kinds,
                          "sequence repetition count")

    def _check_call(self, call, env):
        name = call_name(call) or ""
        target = self.eng.graph.resolve(self.mod, self.cls, call)
        if _sanitizer_named(name) or (target is not None and (
                _sanitizer_named(target.label)
                or _annotated_sanitizer(target.module, target.func))):
            # handing a tainted value TO a sanitizer is the
            # sanctioned pattern, never a sink — and taint does not
            # cross into it
            return
        wire_http = frozenset((TAINT_WIRE, TAINT_HTTP))
        if name in _GEOMETRY_CALLS:
            sized = list(call.args[:1]) + [
                kw.value for kw in call.keywords
                if kw.arg in _GEOMETRY_KWARGS]
            if name == "range":
                sized = list(call.args)
            for arg in sized:
                kinds = self._taint_of(arg, env) & wire_http
                if kinds:
                    self._hit(call, "geometry", kinds,
                              "%s(...) extent" % name)
                    break
        chain = attr_chain(call.func) or ""
        root = chain.split(".")[0] if chain else ""
        if (name == "open" and isinstance(call.func, ast.Name)) or (
                root in ("os", "shutil", "glob")
                and name not in _PATH_SAFE):
            for arg in call.args:
                kinds = self._taint_of(arg, env) & wire_http
                if kinds:
                    self._hit(call, "path", kinds,
                              "%s(...) filesystem argument"
                              % (chain or name))
                    break
        for kw in call.keywords:
            if kw.arg in _PATH_KEYWORDS:
                kinds = self._taint_of(kw.value, env) & wire_http
                if kinds:
                    self._hit(call, "path", kinds,
                              "%s=... store/filesystem target"
                              % kw.arg)
        if name in ("loads", "load") and root in ("pickle", "marshal") \
                and not self.hmac_ok and call.args:
            kinds = self._taint_of(call.args[0], env) \
                & _CONCRETE_KINDS
            if kinds:
                self._hit(call, "deserialize", kinds,
                          "%s.%s(...) of unverified input"
                          % (root, name))
        if name in ("setdefault", "add") \
                and isinstance(call.func, ast.Attribute) \
                and call.args:
            kinds = self._taint_of(call.args[0], env) \
                & _CONCRETE_KINDS
            if kinds:
                self._container_growth(call, call.func.value, kinds,
                                       env)
        self._propagate(call, env, target)

    def _growth(self, subscript, env):
        kinds = self._taint_of(subscript.slice, env) & _CONCRETE_KINDS
        if kinds:
            self._container_growth(subscript, subscript.value, kinds,
                                   env)

    def _container_growth(self, node, container, kinds, env):
        """Persistent container keyed by a tainted value: self-attr
        and module-global containers only — a function-local dict
        dies with the call and cannot accumulate."""
        project = self.eng.project
        if isinstance(container, ast.Attribute) \
                and isinstance(container.value, ast.Name) \
                and container.value.id == "self" \
                and self.cls is not None:
            cname = project.class_attr_types(self.cls) \
                .get(container.attr)
            if cname and _bounded_container(self.mod, cname, project):
                return
            self._hit(node, "cardinality", kinds,
                      "self.%s keyed by untrusted value"
                      % container.attr)
            return
        if isinstance(container, ast.Name) \
                and container.id in self.eng.module_globals(self.mod):
            cname = self.mod.global_types.get(container.id)
            if cname and _bounded_container(self.mod, cname, project):
                return
            self._hit(node, "cardinality", kinds,
                      "module-global %s keyed by untrusted value"
                      % container.id)

    def _propagate(self, call, env, target):
        if target is None:
            fn = call.func
            if isinstance(fn, ast.Name):
                if self._nested is None:
                    self._nested = nested_functions(self.func)
                nested = self._nested.get(fn.id)
                if nested is not None \
                        and id(nested) not in self._nested_active:
                    self._inline_nested(nested, call, env)
            return
        if self.summary:
            return
        argmap = map_call_args(call, target)
        fact = set()
        for pname, argexpr in argmap.items():
            for kind in self._taint_of(argexpr, env) \
                    & _CONCRETE_KINDS:
                fact.add("%s:%s" % (kind, pname))
        if not fact:
            return
        if self.hmac_ok:
            fact.add("<verified>")
        self.calls_out.append((call, frozenset(fact)))

    def _inline_nested(self, nested, call, env):
        """Scan a closure defined in this function with the caller's
        env — CallGraph cannot see nested defs, but loadgen-style
        recursive allocators live there."""
        env2 = dict(env)
        names = _param_names(nested, skip_self=False)
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(names):
                env2[names[i]] = self._taint_of(arg, env)
        for kw in call.keywords:
            if kw.arg:
                env2[kw.arg] = self._taint_of(kw.value, env)
        self._nested_active.add(id(nested))
        try:
            self._suite(nested.body, env2)
        finally:
            self._nested_active.discard(id(nested))

    def _hit(self, node, sink, kinds, detail):
        if self.summary:
            return
        self.eng.record(self.mod, node.lineno, sink, kinds,
                        self.chain, detail)


class _TaintFlow(ForwardDataflow):
    """The interprocedural driver: every function seeds with an empty
    fact (local source -> local sink), wire handlers seed with all
    parameters wire-tainted; facts are frozensets of ``kind:param``
    strings plus an optional ``<verified>`` HMAC marker."""

    def __init__(self, eng):
        ForwardDataflow.__init__(self, eng.project)
        self.eng = eng
        self.graph = eng.graph

    def entries(self):
        for mod, cls, func, label in self.eng.functions:
            yield mod, cls, func, frozenset(), label
            if func.name in WIRE_HANDLER_NAMES:
                fact = frozenset(
                    "%s:%s" % (TAINT_WIRE, p)
                    for p in _param_names(func,
                                          skip_self=cls is not None))
                if fact:
                    yield mod, cls, func, fact, label

    def transfer(self, mod, cls, func, fact, chain):
        env = {}
        hmac_ok = False
        for entry in fact:
            if entry == "<verified>":
                hmac_ok = True
                continue
            kind, _, pname = entry.partition(":")
            env[pname] = env.get(pname, frozenset()) | {kind}
        scan = _TaintScan(self.eng, mod, cls, func, chain,
                          summary_mode=False)
        scan.run(env, hmac_ok)
        return scan.calls_out


class TaintEngine:
    """Whole-program taint analysis over a Project.

    Sources: wire handler parameters and recv results, HTTP
    headers/bodies/paths and fetched JSON, ``os.environ`` reads.
    Sanitizers: ``*resolve*``/``*clamp*``/``*validate*``-named calls,
    ``# zlint: sanitizer``-annotated defs, explicit comparison/
    isinstance/membership guards, ``min()`` against an untainted
    bound, and ``hmac.compare_digest`` domination (deserialize only).
    Sinks: allocation geometry, persistent-container growth keyed by
    tainted values, filesystem/store targets, unverified
    ``pickle.loads``. Results are :class:`TaintHit` records the
    ``rules_taint`` pack turns into findings."""

    _SUMMARY_ROUNDS = 5

    def __init__(self, project):
        self.project = project
        self.graph = CallGraph(project)
        self.functions = list(self._iter_functions())
        self.hits = []
        self._hit_keys = set()
        self._summaries = {}
        self._globals = {}
        self._classinfo = {id(cls.node): cls
                           for mod in project.modules
                           for cls in mod.classes.values()}

    def _iter_functions(self):
        for mod in self.project.modules:
            for func in mod.functions.values():
                yield mod, None, func, func.name
            for cls in mod.classes.values():
                for mname, meth in cls.methods.items():
                    yield mod, cls, meth, "%s.%s" % (cls.name, mname)

    def module_globals(self, mod):
        names = self._globals.get(id(mod))
        if names is None:
            names = set(mod.global_types)
            for node in mod.tree.body:
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            names.add(tgt.id)
            self._globals[id(mod)] = names
        return names

    def summary_for(self, func):
        return self._summaries.get(id(func),
                                   (frozenset(), frozenset()))

    def record(self, mod, lineno, sink, kinds, chain, detail):
        key = (mod.relpath, lineno, sink)
        if key in self._hit_keys:
            return
        self._hit_keys.add(key)
        self.hits.append(TaintHit(mod, lineno, sink, kinds, chain,
                                  detail))

    def _compute_summaries(self):
        """Per-function return summaries (source kinds + parameter
        pass-through) to a cross-call fixpoint, so ``recv_frame``'s
        result and a JSON-fetch helper's result taint their callers."""
        for _ in range(self._SUMMARY_ROUNDS):
            changed = False
            for mod, cls, func, label in self.functions:
                env = {}
                for p in _param_names(func, skip_self=cls is not None):
                    env[p] = frozenset(("param:%s" % p,))
                scan = _TaintScan(self, mod, cls, func, (label,),
                                  summary_mode=True)
                scan.run(env, hmac_ok=False)
                kinds = frozenset(t for t in scan.ret_tags
                                  if not t.startswith("param:"))
                params = frozenset(t[6:] for t in scan.ret_tags
                                   if t.startswith("param:"))
                new = (kinds & _CONCRETE_KINDS, params)
                if self._summaries.get(id(func)) != new:
                    self._summaries[id(func)] = new
                    changed = True
            if not changed:
                break

    def run(self):
        self._compute_summaries()
        _TaintFlow(self).run()
        self.hits.sort(key=lambda h: (h.module.relpath, h.lineno,
                                      h.sink))
        return self.hits


def taint_hits(project):
    """Memoized whole-program taint pass — the four taint rules share
    one engine run exactly like the reactor rules share
    :func:`reactor_callbacks`."""
    cached = getattr(project, "_taint_hits_cache", None)
    if cached is None:
        cached = TaintEngine(project).run()
        project._taint_hits_cache = cached
    return cached


# -- graph utilities ----------------------------------------------------


def tarjan_sccs(edges):
    """Strongly connected components with more than one node, over an
    edge set/dict keyed ``(a, b)`` — the minimal cycle witness the
    lock-order rule reports."""
    graph = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index, low, on, stack = {}, {}, set(), []
    sccs, counter = [], [0]

    def strongconnect(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in graph[v]:
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                sccs.append(comp)
    for v in list(graph):
        if v not in index:
            strongconnect(v)
    return sccs
