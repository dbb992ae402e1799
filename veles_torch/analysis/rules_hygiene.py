"""Generic hygiene rules mirroring the ruff baseline (pyflakes F401 /
F841 / pycodestyle E722) so the gate enforces them even where ruff is
not installed — one config surface (``pyproject.toml [tool.ruff]``),
two enforcers, same verdicts.

* ``unused-import`` — module-level imports never referenced anywhere
  in the file. Function-level imports are exempt (availability probes
  like ``import torch  # noqa`` and lazy heavy imports are idiomatic
  here); so are ``__init__.py`` re-export surfaces and names escaped
  with ``# noqa``.
* ``unused-variable`` — a local bound by a simple ``name = expr``
  assignment and never read afterwards anywhere in the function.
  Underscore-prefixed names, tuple unpacks, augmented targets and
  functions that call ``locals()``/``eval``/``exec`` are exempt
  (matching pyflakes F841's conservatism).
* ``bare-except`` — ``except:`` catches ``SystemExit`` and
  ``KeyboardInterrupt``, turning Ctrl-C into an infinite loop in any
  retry path. Name the exceptions (``except Exception:`` at the
  broadest).
"""

import ast
import os
import re

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

_NOQA_RE = re.compile(r"#\s*noqa\b", re.IGNORECASE)


@register("bare-except", "error",
          "except: swallows KeyboardInterrupt/SystemExit",
          scope="module")
def check_bare_except(project):
    findings = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                findings.append(Finding(
                    mod.relpath, node.lineno, "bare-except", "error",
                    "bare except: catches SystemExit and "
                    "KeyboardInterrupt — Ctrl-C and sys.exit() die "
                    "here",
                    "catch Exception (or the specific errors) "
                    "instead"))
    return findings


_DYNAMIC_SCOPE = ("locals", "vars", "eval", "exec")


@register("unused-variable", "warning",
          "locals assigned by simple statements and never read",
          scope="module")
def check_unused_variable(project):
    findings = []
    for mod in project.modules:
        funcs = []
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.append(node)
        for func in funcs:
            # anything that can read names dynamically defeats the
            # analysis — skip the whole function (pyflakes does too)
            if any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Name)
                   and n.func.id in _DYNAMIC_SCOPE
                   for n in ast.walk(func)):
                continue
            assigns = {}           # name -> first-assign lineno
            # nested scopes are scanned on their own (shared walk)
            for node in engine.scoped_nodes(func):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Name) \
                            and not t.id.startswith("_"):
                        assigns.setdefault(t.id, node.lineno)
            if not assigns:
                continue
            read = set()
            for node in ast.walk(func):
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, (ast.Load, ast.Del)):
                    read.add(node.id)
                elif isinstance(node, ast.AugAssign) \
                        and isinstance(node.target, ast.Name):
                    read.add(node.target.id)
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    read.update(node.names)
            # names nested functions close over count as read
            for node in ast.walk(func):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node is not func:
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Name):
                            read.add(sub.id)
            for name, lineno in sorted(assigns.items()):
                if name in read:
                    continue
                findings.append(Finding(
                    mod.relpath, lineno, "unused-variable", "warning",
                    "local %r is assigned but never read" % name,
                    "drop the binding (keep the right-hand side if "
                    "it has side effects), or name it _%s" % name))
    return findings


@register("unused-import", "warning",
          "dead module-level imports", scope="module")
def check_unused_import(project):
    findings = []
    for mod in project.modules:
        if os.path.basename(mod.path) == "__init__.py":
            continue               # re-export surface
        lines = mod.source.splitlines()
        imported = {}              # local name -> (lineno, display)
        for node in mod.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    imported[local] = (node.lineno, a.name)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    imported[a.asname or a.name] = (
                        node.lineno, "%s.%s" % (node.module or "",
                                                a.name))
        if not imported:
            continue
        used = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
        # names listed in __all__ count as used (export surface)
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "__all__"
                            for t in node.targets):
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str):
                        used.add(sub.value)
        for name, (lineno, display) in sorted(imported.items()):
            if name in used:
                continue
            if lineno <= len(lines) and _NOQA_RE.search(
                    lines[lineno - 1]):
                continue
            findings.append(Finding(
                mod.relpath, lineno, "unused-import", "warning",
                "%r imported but unused" % display,
                "delete the import (or mark an intentional "
                "re-export with `# noqa: F401`)"))
    return findings
