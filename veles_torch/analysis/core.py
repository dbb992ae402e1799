"""zlint core: findings, pragmas, the project model, the rule engine.

The engine parses every target file once into a :class:`Module`
(AST + per-line pragma map + import map), assembles them into a
:class:`Project` (cross-module class hierarchy, global-variable type
bindings), and hands the project to each registered rule. Rules are
plain functions ``rule(project) -> [Finding]``; cross-module work
(subclass resolution, the lock graph) goes through the project's
indexes so a rule never re-parses anything.
"""

import ast
import os
import re
import time
import tokenize
from dataclasses import dataclass

#: pragma grammar: ``# zlint: disable=rule-a,rule-b (free-text reason)``
_PRAGMA_RE = re.compile(r"#\s*zlint:\s*disable=([A-Za-z0-9_,-]+)")

#: sanitizer annotation: ``# zlint: sanitizer (free-text reason)`` on
#: (or directly above) a def/class marks it a trusted bounding
#: function / bounded container for the taint rules
_SANITIZER_RE = re.compile(r"#\s*zlint:\s*sanitizer\b")

SEVERITIES = ("error", "warning")


class UnknownRuleError(ValueError):
    """--select named a rule id that is not registered. A dedicated
    type so the CLI's usage-error handling can never swallow a
    rule-internal KeyError as 'unknown rule'."""


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, anchored at file:line."""

    file: str          # repo-relative (stable for CI diffing)
    line: int
    rule: str
    severity: str
    message: str
    hint: str

    def as_dict(self):
        return {"file": self.file, "line": self.line,
                "rule": self.rule, "severity": self.severity,
                "message": self.message, "hint": self.hint}

    def render(self):
        return "%s:%d: [%s/%s] %s\n    hint: %s" % (
            self.file, self.line, self.severity, self.rule,
            self.message, self.hint)


class ClassInfo:
    """One class definition: bases (simple names), methods, and the
    attribute/lock bindings rules need for cheap type inference."""

    def __init__(self, module, node):
        self.module = module
        self.node = node
        self.name = node.name
        # base simple names: ``nn.Module`` -> ``Module``
        self.bases = []
        for b in node.bases:
            if isinstance(b, ast.Attribute):
                self.bases.append(b.attr)
            elif isinstance(b, ast.Name):
                self.bases.append(b.id)
        self.methods = {}
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
        #: ``self.X = threading.Lock()`` -> {"X": "lock"}; RLock ->
        #: "rlock"; ``Condition(self.Y)`` -> alias recorded separately
        self.locks = {}
        #: Condition built over an existing lock: attr -> aliased attr
        self.lock_aliases = {}
        #: ``self.X = SomeProjectClass(...)`` -> {"X": "SomeProjectClass"}
        self.attr_types = {}
        self._scan_attr_bindings()

    def _scan_attr_bindings(self):
        for meth in self.methods.values():
            for node in ast.walk(meth):
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    kind, arg = _lock_ctor(node.value)
                    if kind in ("lock", "rlock"):
                        self.locks[tgt.attr] = kind
                    elif kind == "condition":
                        if arg is not None:
                            self.lock_aliases[tgt.attr] = arg
                        else:
                            self.locks[tgt.attr] = "rlock"
                    elif isinstance(node.value, ast.Call):
                        cname = _call_class_name(node.value)
                        if cname:
                            self.attr_types[tgt.attr] = cname


def _lock_ctor(expr):
    """Classify ``threading.Lock()``-shaped constructor expressions.

    -> ("lock"|"rlock"|"condition", aliased_self_attr_or_None) or
    (None, None)."""
    if not isinstance(expr, ast.Call):
        return None, None
    fn = expr.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if name == "Lock":
        return "lock", None
    if name == "RLock":
        return "rlock", None
    if name == "Condition":
        if expr.args and isinstance(expr.args[0], ast.Attribute) \
                and isinstance(expr.args[0].value, ast.Name) \
                and expr.args[0].value.id == "self":
            return "condition", expr.args[0].attr
        return "condition", None
    return None, None


def _call_class_name(call):
    """CapWord constructor calls -> the class simple name."""
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    if name and name[:1].isupper():
        return name
    return None


class Module:
    """One parsed source file plus its pragma and import maps."""

    def __init__(self, path, relpath, source):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.pragmas = self._scan_pragmas(source)
        #: line numbers carrying ``# zlint: sanitizer`` annotations
        self.sanitizer_lines = self._scan_sanitizers(source)
        #: local name -> ("module", dotted) | ("symbol", dotted, name)
        self.imports = {}
        #: module-level classes by name
        self.classes = {}
        #: module-level functions by name
        self.functions = {}
        #: module-level ``name = SomeClass(...)`` type bindings and
        #: ``name = threading.Lock()`` global locks
        self.global_types = {}
        self.global_locks = {}
        for node in self.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    self.imports[local] = ("module", a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level:          # relative: not used in veles_torch
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.imports[a.asname or a.name] = (
                        "symbol", node.module or "", a.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = ClassInfo(self, node)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tname = node.targets[0].id
                kind, _ = _lock_ctor(node.value)
                if kind in ("lock", "rlock"):
                    self.global_locks[tname] = kind
                elif isinstance(node.value, ast.Call):
                    cname = _call_class_name(node.value)
                    if cname:
                        self.global_types[tname] = cname

    @staticmethod
    def _scan_pragmas(source):
        """{lineno: set(rule ids) | {"all"}} from zlint comments.

        Tokenize-based so a ``#`` inside a string literal can never
        read as a pragma; falls back to a line regex if tokenization
        chokes (it shouldn't on anything ast.parse accepted)."""
        pragmas = {}
        try:
            tokens = tokenize.generate_tokens(
                iter(source.splitlines(True)).__next__)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _PRAGMA_RE.search(tok.string)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")}
                    pragmas.setdefault(tok.start[0], set()).update(rules)
        except (tokenize.TokenError, IndentationError):
            for i, line in enumerate(source.splitlines(), 1):
                m = _PRAGMA_RE.search(line)
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")}
                    pragmas.setdefault(i, set()).update(rules)
        return pragmas

    @staticmethod
    def _scan_sanitizers(source):
        """Line numbers annotated ``# zlint: sanitizer`` — tokenize-
        based like the pragma scan, same string-literal immunity."""
        lines = set()
        try:
            tokens = tokenize.generate_tokens(
                iter(source.splitlines(True)).__next__)
            for tok in tokens:
                if tok.type == tokenize.COMMENT \
                        and _SANITIZER_RE.search(tok.string):
                    lines.add(tok.start[0])
        except (tokenize.TokenError, IndentationError):
            for i, line in enumerate(source.splitlines(), 1):
                if _SANITIZER_RE.search(line):
                    lines.add(i)
        return lines

    def suppressed(self, line, rule):
        rules = self.pragmas.get(line)
        return bool(rules) and (rule in rules or "all" in rules)


class Project:
    """All modules under analysis + cross-module indexes."""

    def __init__(self, modules):
        self.modules = modules
        #: simple class name -> [ClassInfo] (collisions kept — rules
        #: resolve conservatively over all of them)
        self.class_index = {}
        for mod in modules:
            for info in mod.classes.values():
                self.class_index.setdefault(info.name, []).append(info)
        #: dotted module path -> Module (veles_torch/foo/bar.py -> veles_torch.foo.bar)
        self.module_index = {}
        for mod in modules:
            rel = mod.relpath.replace("\\", "/")
            d = rel[:-3] if rel.endswith(".py") else rel
            d = d[:-9] if d.endswith("/__init__") else d
            self.module_index[d.replace("/", ".")] = mod

    def module_by_dotted(self, dotted):
        return self.module_index.get(dotted)

    def resolve_module_alias(self, mod, local):
        """The project Module a local name refers to, through either
        import form (``import veles_torch.telemetry`` / ``from veles_torch import
        telemetry`` / ``from x import y as z``), or None."""
        target = mod.imports.get(local)
        if target is None:
            return None
        if target[0] == "module":
            return self.module_by_dotted(target[1])
        return self.module_by_dotted("%s.%s" % (target[1], target[2]))

    def _merge_hierarchy(self, info, extract):
        """{key: nearest-definition value} walking ``info`` then its
        resolvable ancestors breadth-first (MRO-ish: own class wins)."""
        out = {}
        seen = set()
        queue = [info]
        while queue:
            cur = queue.pop(0)
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            for key, value in extract(cur).items():
                out.setdefault(key, value)
            for base in cur.bases:
                queue.extend(self.class_index.get(base, ()))
        return out

    def class_methods(self, info):
        """Hierarchy-merged {method name: (owner ClassInfo,
        FunctionDef)} — a thread started by a base class races with a
        subclass's public API exactly like a same-class pair does."""
        return self._merge_hierarchy(
            info, lambda c: {n: (c, f) for n, f in c.methods.items()})

    def class_attr_types(self, info):
        """Hierarchy-merged {attr: class simple name} for
        ``self.X = SomeClass(...)`` bindings."""
        return self._merge_hierarchy(info, lambda c: c.attr_types)

    def is_subclass_of(self, info, root_name):
        """True when ``info`` transitively names ``root_name`` among
        its bases (simple-name resolution — precise enough for one
        package; unresolvable bases end the chain)."""
        seen = set()
        stack = [info]
        while stack:
            cur = stack.pop()
            if cur.name == root_name:
                return True
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            for base in cur.bases:
                if base == root_name:
                    return True
                stack.extend(self.class_index.get(base, ()))
        return False

    def class_locks(self, info):
        """Merged lock bindings over ``info`` AND its resolvable
        ancestors (nearest definition wins): ``({attr: (owner_class,
        kind)}, {attr: aliased_attr})``. A subclass using a lock its
        base bound in ``__init__`` is the NORMAL shape here, so
        per-class-only lookup would blind the concurrency rules."""
        locks = self._merge_hierarchy(
            info, lambda c: {a: (c.name, k)
                             for a, k in c.locks.items()})
        aliases = self._merge_hierarchy(info, lambda c: c.lock_aliases)
        return locks, aliases

    def find_method(self, info, name):
        """The defining (ClassInfo, FunctionDef) for ``name`` on
        ``info`` or its project-resolvable ancestors."""
        seen = set()
        stack = [info]
        while stack:
            cur = stack.pop(0)           # MRO-ish: breadth first
            if id(cur) in seen:
                continue
            seen.add(id(cur))
            if name in cur.methods:
                return cur, cur.methods[name]
            for base in cur.bases:
                stack.extend(self.class_index.get(base, ()))
        return None, None


# -- rule registry -----------------------------------------------------

#: rule id -> (check(project) -> [Finding], severity, one-line doc).
#: Populated by the rules_* modules at import time via register().
RULES = {}

#: rule id -> "module" | "project". A module-scope rule's findings in
#: module M depend only on M plus its transitive imports (and same-
#:name classes) — the incremental cache re-runs it on just the edited
#: module's dependency closure. Project-scope rules (cross-module
#: dataflow: wire-schema, lock cycles, taint) re-run whenever any
#: module changed. Defaults to the conservative "project".
RULE_SCOPES = {}


def register(rule_id, severity, doc, scope="project"):
    if severity not in SEVERITIES:
        raise ValueError("severity must be one of %s" % (SEVERITIES,))
    if scope not in ("module", "project"):
        raise ValueError("scope must be 'module' or 'project'")

    def wrap(fn):
        RULES[rule_id] = (fn, severity, doc)
        RULE_SCOPES[rule_id] = scope
        return fn
    return wrap


def _load_rules():
    # import for registration side effects (keeps RULES the single
    # source the CLI, tests and docs iterate)
    from veles_torch.analysis import (        # noqa: F401
        rules_hygiene, rules_loop, rules_model_stats, rules_probes,
        rules_profiler, rules_purity, rules_reactor, rules_resources,
        rules_state, rules_taint, rules_telemetry, rules_threads,
        rules_wire)


def iter_py_files(paths):
    """Expand files/directories to sorted .py paths (skips caches)."""
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                out.extend(os.path.join(root, f)
                           for f in sorted(files) if f.endswith(".py"))
        else:
            raise FileNotFoundError(p)
    return sorted(set(out))


def _relpath(path, base):
    ap = os.path.abspath(path)
    if base and ap.startswith(base.rstrip(os.sep) + os.sep):
        return os.path.relpath(ap, base)
    return ap


def build_project(paths, base=None):
    """Parse ``paths`` (files or directories) into a Project.

    ``base`` anchors the repo-relative paths findings carry; default =
    the current directory when the files live under it (stable output
    for CI diffing), absolute paths otherwise."""
    base = os.path.abspath(base or os.getcwd())
    modules = []
    for path in iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        modules.append(Module(path, _relpath(path, base), source))
    return Project(modules)


def pragma_filtered(project, raw_findings):
    """Drop findings suppressed by a same-line pragma."""
    by_path = {m.relpath: m for m in project.modules}
    out = []
    for f in raw_findings:
        mod = by_path.get(f.file)
        if mod is not None and mod.suppressed(f.line, f.rule):
            continue
        out.append(f)
    return out


def analyze(project, select=None, cache=None, stats=None):
    """Run every (or the selected) registered rule; -> sorted,
    pragma-filtered findings.

    ``cache`` — an :class:`veles_torch.analysis.cache.AnalysisCache` —
    reuses stored per-rule results keyed by content hashes (see that
    module for the invalidation model). ``stats`` — a caller-supplied
    list — receives one dict per rule run: rule id, wall seconds,
    finding count and fresh/cached module counts (``--stats``)."""
    _load_rules()
    if select:
        unknown = set(select) - set(RULES)
        if unknown:
            raise UnknownRuleError("unknown rule(s): %s" % ", ".join(
                sorted(unknown)))
    findings = []
    for rule_id, (fn, _sev, _doc) in sorted(RULES.items()):
        if select and rule_id not in select:
            continue
        t0 = time.perf_counter()
        if cache is not None:
            got, fresh, cached = cache.run_rule(
                project, rule_id, fn,
                RULE_SCOPES.get(rule_id, "project"))
        else:
            got = pragma_filtered(project, fn(project))
            fresh, cached = len(project.modules), 0
        findings.extend(got)
        if stats is not None:
            stats.append({
                "rule": rule_id,
                "seconds": round(time.perf_counter() - t0, 4),
                "findings": len(got),
                "fresh_modules": fresh,
                "cached_modules": cached,
            })
    return sorted(findings)


def analyze_paths(paths, base=None, select=None, cache=None,
                  stats=None):
    """One-call surface: parse + analyze. -> sorted [Finding]."""
    return analyze(build_project(paths, base=base), select=select,
                   cache=cache, stats=stats)
