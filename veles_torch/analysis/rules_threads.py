"""Concurrency rules: lock-order, unguarded-shared-state,
thread-lifecycle.

``lock-order`` builds an inter-procedural lock-acquisition graph: a
``with self._lock:`` (or a module-global lock) puts that lock on the
held stack, and every lock acquired while another is held records an
ordering edge. Calls are followed through the shared
:class:`veles_torch.analysis.engine.CallGraph` — ``self.method()``,
``self.attr.method()`` when ``__init__`` bound the attr to a project
class, module-level functions, imported symbols and constructor
calls — so a nesting like ``MasterServer.persist_state (holds
_persist_lock) -> checkpoint_state (takes lock)`` shows up as the
edge ``_persist_lock -> lock`` even though no single function
acquires both. Cycles in the merged graph are potential deadlocks;
re-entering a non-reentrant ``threading.Lock`` (directly or through
calls) is reported even without a cycle. ``threading.Condition(lock)``
aliases its lock; ``.wait()`` is not an acquisition.

``unguarded-shared-state`` flags instance attributes written both from
thread-side code (a ``Thread(target=...)`` method or a nested function
handed to a Thread) and from an unlocked public method — the classic
"constructor-started background thread vs. API caller" race.

``thread-lifecycle`` requires every started thread to be a daemon or
to have a visible ``.join()`` path, so interpreter shutdown can never
hang on a forgotten worker.
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

_MAX_DEPTH = engine.MAX_DEPTH


class _LockWalker:
    """Inter-procedural walk collecting lock-ordering edges; call
    resolution is the shared engine CallGraph."""

    def __init__(self, project):
        self.project = project
        self.graph = engine.CallGraph(project)
        #: (lock_a, lock_b) -> (module, lineno, "Class.meth -> ...")
        self.edges = {}
        #: re-entry of a non-reentrant lock: [(lock, module, lineno,
        #: chain)]
        self.reentries = []
        self._active = []      # call-stack guard: (id(func), lockset)
        self._cls_locks = {}   # id(ClassInfo) -> (locks, aliases)

    def _locks_for(self, cls):
        """Hierarchy-merged (locks, aliases) for a class, cached."""
        got = self._cls_locks.get(id(cls))
        if got is None:
            got = self._cls_locks[id(cls)] = \
                self.project.class_locks(cls)
        return got

    def _lock_id(self, ctx_mod, ctx_cls, expr):
        """The (owner, attr) lock node for a ``with`` context
        expression, or None when it is not a recognizable lock."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and ctx_cls is not None:
            locks, aliases = self._locks_for(ctx_cls)
            attr = expr.attr
            # chase Condition->lock aliases within the hierarchy
            seen = set()
            while attr in aliases and attr not in seen:
                seen.add(attr)
                attr = aliases[attr]
            if attr in locks:
                owner, kind = locks[attr]
                # key by the DEFINING class so Base and Child uses
                # of one inherited lock unify into one graph node
                return ((owner, attr), kind)
            return None
        if isinstance(expr, ast.Name) \
                and expr.id in ctx_mod.global_locks:
            return (("module:" + ctx_mod.relpath, expr.id),
                    ctx_mod.global_locks[expr.id])
        return None

    # -- the walk ------------------------------------------------------

    def walk_function(self, mod, cls, func, held, chain):
        key = (id(func), frozenset(lock for lock, _ in held))
        if key in self._active or len(self._active) > _MAX_DEPTH:
            return
        self._active.append(key)
        try:
            for stmt in func.body:
                self._walk_stmt(mod, cls, stmt, held, chain)
        finally:
            self._active.pop()

    def _walk_stmt(self, mod, cls, node, held, chain):
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                # earlier items of the SAME statement are already
                # held: `with self.a, self.b:` orders a before b, and
                # `with self.a, self.a:` deadlocks exactly like the
                # nested spelling
                cur_held = held + acquired
                got = self._lock_id(mod, cls, item.context_expr)
                if got is None:
                    self._walk_expr(mod, cls, item.context_expr,
                                    cur_held, chain)
                    continue
                lock, kind = got
                held_locks = [h for h, _ in cur_held]
                if lock in held_locks:
                    if kind == "lock":
                        self.reentries.append(
                            (lock, mod, node.lineno, list(chain)))
                else:
                    for h, _site in cur_held:
                        self.edges.setdefault(
                            (h, lock),
                            (mod, node.lineno, " -> ".join(chain)))
                    acquired.append((lock, (mod, node.lineno)))
            inner = held + acquired
            for stmt in node.body:
                self._walk_stmt(mod, cls, stmt, inner, chain)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return      # nested defs execute later, not here
        for kind, child in engine.iter_stmt_children(node):
            if kind == "stmt":
                self._walk_stmt(mod, cls, child, held, chain)
            else:
                self._walk_expr(mod, cls, child, held, chain)

    def _walk_expr(self, mod, cls, node, held, chain):
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            target = self.graph.resolve(mod, cls, sub)
            if target is None:
                continue
            self.walk_function(target.module, target.cls, target.func,
                               held, chain + [target.label])


def _fmt_lock(lock):
    owner, attr = lock
    return "%s.%s" % (owner, attr)


@register("lock-order", "error",
          "lock-acquisition-order cycles (potential deadlocks) and "
          "re-entry of non-reentrant locks")
def check_lock_order(project):
    walker = _LockWalker(project)
    for mod in project.modules:
        for func in mod.functions.values():
            walker.walk_function(mod, None, func, [], [func.name])
        for cls in mod.classes.values():
            for mname, meth in cls.methods.items():
                walker.walk_function(
                    mod, cls, meth, [], ["%s.%s" % (cls.name, mname)])
    findings = []
    for lock, mod, lineno, chain in walker.reentries:
        findings.append(Finding(
            mod.relpath, lineno, "lock-order", "error",
            "non-reentrant lock %s re-acquired while already held "
            "(via %s) — this deadlocks at runtime"
            % (_fmt_lock(lock), " -> ".join(chain)),
            "use threading.RLock, or split the locked region so the "
            "outer caller passes already-held state in"))
    for comp in engine.tarjan_sccs(walker.edges):
        comp_set = set(comp)
        sites = []
        for (a, b), (mod, lineno, chain) in sorted(
                walker.edges.items(),
                key=lambda kv: (kv[1][0].relpath, kv[1][1])):
            if a in comp_set and b in comp_set:
                sites.append((a, b, mod, lineno, chain))
        if not sites:
            continue
        a, b, mod, lineno, chain = sites[0]
        order = ", ".join(
            "%s -> %s (%s:%d)" % (_fmt_lock(x), _fmt_lock(y),
                                  m.relpath, ln)
            for x, y, m, ln, _ in sites)
        findings.append(Finding(
            mod.relpath, lineno, "lock-order", "error",
            "lock-order cycle between {%s}: %s"
            % (", ".join(sorted(_fmt_lock(c) for c in comp)), order),
            "pick one global acquisition order and restructure the "
            "calls (move work outside the lock, or hand off through "
            "a queue/event instead of calling back under the lock)"))
    return findings


# -- unguarded-shared-state --------------------------------------------


def _self_writes(func, lock_attrs, alias_attrs):
    """[(attr, lineno, under_lock)] for direct self.X writes in
    ``func`` (``with self.<lock>`` scopes tracked lexically)."""
    out = []

    def walk(node, locked):
        if isinstance(node, ast.With):
            inner = locked
            for item in node.items:
                e = item.context_expr
                if isinstance(e, ast.Attribute) \
                        and isinstance(e.value, ast.Name) \
                        and e.value.id == "self":
                    attr = e.attr
                    attr = alias_attrs.get(attr, attr)
                    if attr in lock_attrs:
                        inner = True
            for stmt in node.body:
                walk(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    out.append((t.attr, node.lineno, locked))
        for kind, child in engine.iter_stmt_children(node):
            if kind == "stmt":
                walk(child, locked)

    for stmt in func.body:
        walk(stmt, False)
    return out


def _thread_target_names(methods):
    """Names of methods / nested functions handed to
    ``threading.Thread(target=...)`` anywhere in ``methods`` (a
    hierarchy-merged {name: (owner, FunctionDef)} map — the thread
    may be started by a base class)."""
    targets = set()
    for _owner, meth in methods.values():
        for node in ast.walk(meth):
            if not isinstance(node, ast.Call):
                continue
            if engine.call_name(node) != "Thread":
                continue
            # target may be the keyword OR the second positional arg
            # (Thread(group, target, ...))
            values = [kw.value for kw in node.keywords
                      if kw.arg == "target"]
            if len(node.args) >= 2:
                values.append(node.args[1])
            for v in values:
                if isinstance(v, ast.Attribute) \
                        and isinstance(v.value, ast.Name) \
                        and v.value.id == "self":
                    targets.add(v.attr)
                elif isinstance(v, ast.Name):
                    targets.add(v.id)
    return targets


@register("unguarded-shared-state", "error",
          "instance attributes written both from a Thread target and "
          "from unlocked public methods", scope="module")
def check_unguarded_shared_state(project):
    findings = []
    seen = set()       # (file, line, attr): base races re-surface
    #                    when every subclass is scanned — report once
    for mod in project.modules:
        for cls in mod.classes.values():
            # hierarchy-merged view: the thread may be started by a
            # base class while the racing public method lives on the
            # subclass (or vice versa)
            methods = project.class_methods(cls)
            targets = _thread_target_names(methods)
            if not targets:
                continue
            locks, aliases = project.class_locks(cls)
            lock_attrs = set(locks)
            thread_writes = {}     # attr -> [(owner_mod, line, locked)]
            public_writes = {}     # attr -> [(owner_mod, line, locked, meth)]
            for mname, (owner, meth) in methods.items():
                omod = owner.module
                funcs = []
                nested = engine.nested_functions(meth)
                if mname in targets:
                    funcs.append(meth)
                funcs.extend(f for n, f in nested.items()
                             if n in targets)
                for func in funcs:
                    for attr, line, locked in _self_writes(
                            func, lock_attrs, aliases):
                        thread_writes.setdefault(attr, []).append(
                            (omod, line, locked))
                if mname in targets or mname.startswith("_"):
                    continue       # private / the thread body itself
                for attr, line, locked in _self_writes(
                        meth, lock_attrs, aliases):
                    public_writes.setdefault(attr, []).append(
                        (omod, line, locked, mname))
            for attr in sorted(set(thread_writes) & set(public_writes)):
                unlocked = [(om, ln, m) for om, ln, lk, m
                            in public_writes[attr] if not lk]
                unlocked_thread = [(om, ln) for om, ln, lk
                                   in thread_writes[attr] if not lk]
                if not unlocked and not unlocked_thread:
                    continue
                if unlocked:
                    omod, line, meth = unlocked[0]
                    where = "public method %s()" % meth
                else:
                    omod, line = unlocked_thread[0]
                    where = "the thread body"
                key = (omod.relpath, line, attr)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    omod.relpath, line, "unguarded-shared-state",
                    "error",
                    "%s.%s is written by a Thread target and by %s "
                    "without holding a lock" % (cls.name, attr, where),
                    "guard both writers with the owning lock (or "
                    "hand the value through a queue/Event)"))
    return findings


# -- thread-lifecycle --------------------------------------------------


def _joined_names(mod):
    """{key} of every ``<key>.join(...)`` call in the module — plus
    the ITERABLE's key when a for-loop joins its loop variable
    (``for t in threads: t.join()`` marks ``threads``), so the
    thread-pool idiom ``threads = [Thread(...) for ...]`` resolves."""
    out = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "join":
            key = engine.target_key(node.func.value)
            if key is not None:
                out.add(key)
        elif isinstance(node, ast.For) \
                and isinstance(node.target, ast.Name):
            var = node.target.id
            iter_key = engine.target_key(node.iter)
            if iter_key is None:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "join" \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == var:
                    out.add(iter_key)
                    break
    return out


def _comprehension_target(mod, call):
    """The name a comprehension-built pool is assigned to when
    ``call`` is a constructor inside it (``threads =
    [Thread(...) for ...]`` -> "threads"), or None."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, (ast.ListComp,
                                            ast.GeneratorExp)) \
                and any(sub is call for sub in ast.walk(node.value)):
            return engine.target_key(node.targets[0])
    return None


def _daemonized_names(mod):
    """{key} of every ``<key>.daemon = True`` assignment — the
    standard ``t = Thread(...); t.daemon = True; t.start()`` idiom is
    just as shutdown-safe as the constructor keyword."""
    out = set()
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and node.value.value is True):
            continue
        for t in node.targets:
            if not (isinstance(t, ast.Attribute)
                    and t.attr == "daemon"):
                continue
            key = engine.target_key(t.value)
            if key is not None:
                out.add(key)
    return out


@register("thread-lifecycle", "error",
          "started threads must be daemons or have a join path",
          scope="module")
def check_thread_lifecycle(project):
    findings = []
    for mod in project.modules:
        joined = None              # computed lazily per module
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if engine.call_name(node) != "Thread":
                continue
            # only the real constructor: threading.Thread (under any
            # import alias) / a bare imported Thread
            if isinstance(fn, ast.Attribute):
                base = fn.value
                if not isinstance(base, ast.Name):
                    continue
                if base.id != "threading" and mod.imports.get(
                        base.id) != ("module", "threading"):
                    continue
            daemon = None
            for kw in node.keywords:
                if kw.arg == "daemon":
                    daemon = kw.value
            if daemon is not None and not (
                    isinstance(daemon, ast.Constant)
                    and daemon.value is False):
                continue           # daemon=True (or dynamic): fine
            # non-daemon at construction: the handle must be kept AND
            # either .daemon = True'd or .join()ed in this module
            handle = engine.assigned_name(mod, node)
            if handle is None:
                handle = _comprehension_target(mod, node)
            if handle is not None:
                if joined is None:
                    joined = _joined_names(mod) \
                        | _daemonized_names(mod)
                if handle in joined:
                    continue
            findings.append(Finding(
                mod.relpath, node.lineno, "thread-lifecycle", "error",
                "thread started without daemon=True and without a "
                "join() on its handle — interpreter shutdown can "
                "hang on it",
                "pass daemon=True, or keep the handle and join() it "
                "in the owner's close()/stop()"))
    return findings
