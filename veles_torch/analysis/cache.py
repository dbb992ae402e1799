"""zlint incremental analysis cache.

A warm full-tree lint should pay only for what changed. The unit of
reuse is a **(rule, content signature) -> findings** entry on disk;
the interesting part is what goes into the signature, because a stale
hit is a silently wrong lint verdict:

* every key is salted with a hash of the ANALYZER itself (every
  ``veles_torch/analysis/*.py`` source) — editing a rule invalidates the
  whole cache, so a rule change can never serve findings computed by
  its previous self;

* **module-scope** rules (``register(..., scope="module")``): a
  module's findings depend only on the module plus its transitive
  project-internal imports and any module defining a class with the
  same simple name as one in that closure (the project's
  ``class_index`` merges hierarchies by simple name, so a same-named
  class anywhere can contribute attr/lock/base facts). The key is the
  sorted (relpath, content-hash) list over that closure — editing one
  module re-analyzes only the modules whose closure contains it, and
  adding/removing an import CHANGES the closure and therefore the
  key (import-graph invalidation falls out of the signature, no
  separate dependency journal to keep honest);

* **project-scope** rules (cross-module dataflow: wire schemas, lock
  cycles, the taint engine): the key is the signature of the whole
  module set — any edit re-runs them. They are the minority; the
  module-scope majority is what makes the warm run cheap.

Findings are stored POST-pragma-filter (the pragma map is part of the
module's content, so a pragma edit re-keys the module) as JSON under
``DIR/<rule>/<key>.json`` and rebuilt into :class:`Finding` objects on
a hit — a warm run's output is byte-identical to a cold run's.
Entries are written atomically (tmp + rename) so concurrent lints
sharing a cache directory can only ever race to the same content.
"""

import hashlib
import json
import os

from veles_torch.analysis.core import Finding, Project, pragma_filtered

#: bump to orphan every existing entry on a format change
_FORMAT = 1

_analyzer_salt = None


def analyzer_salt():
    """Hash of every ``veles_torch/analysis/*.py`` source + the cache
    format version: the part of every key that says WHICH analyzer
    computed the entry."""
    global _analyzer_salt
    if _analyzer_salt is None:
        h = hashlib.sha256(b"zlint-cache-format-%d" % _FORMAT)
        pkg = os.path.dirname(os.path.abspath(__file__))
        for name in sorted(os.listdir(pkg)):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(pkg, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read() + b"\0")
        _analyzer_salt = h.hexdigest()
    return _analyzer_salt


def _module_hash(mod):
    return hashlib.sha256(mod.source.encode("utf-8")).hexdigest()


class AnalysisCache:
    """On-disk findings cache (``python -m veles_torch lint --cache DIR``)."""

    def __init__(self, directory):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # per-project memos (a cache object usually serves one
        # invocation, but tests reuse them across projects)
        self._memo_project = None
        self._hashes = {}          # relpath -> content hash
        self._closures = {}        # relpath -> frozenset(relpaths)

    # -- signatures ----------------------------------------------------

    def _prepare(self, project):
        if self._memo_project is project:
            return
        self._memo_project = project
        self._hashes = {m.relpath: _module_hash(m)
                        for m in project.modules}
        self._closures = {}

    def _import_targets(self, project, mod):
        """Project modules ``mod`` imports (either import form; a
        ``from pkg import symbol`` contributes both ``pkg.symbol``
        and ``pkg`` when they resolve — the binding reads through
        the package __init__)."""
        out = set()
        for target in mod.imports.values():
            if target[0] == "module":
                hit = project.module_by_dotted(target[1])
                if hit is not None:
                    out.add(hit)
            else:
                _, pkg, name = target
                hit = project.module_by_dotted(
                    "%s.%s" % (pkg, name) if pkg else name)
                if hit is not None:
                    out.add(hit)
                hit = project.module_by_dotted(pkg)
                if hit is not None:
                    out.add(hit)
        return out

    def closure(self, project, mod):
        """The relpath set a module-scope rule's findings in ``mod``
        may depend on: transitive imports, plus every module defining
        a class sharing a simple name with a class defined or named
        as a base anywhere in the closure (fixpoint — adding a module
        adds its imports and class names too)."""
        self._prepare(project)
        got = self._closures.get(mod.relpath)
        if got is not None:
            return got
        by_relpath = {m.relpath: m for m in project.modules}
        members = {mod.relpath}
        queue = [mod]
        seen_names = set()
        while queue:
            cur = queue.pop()
            for hit in self._import_targets(project, cur):
                if hit.relpath in by_relpath \
                        and hit.relpath not in members:
                    members.add(hit.relpath)
                    queue.append(hit)
            names = set(cur.classes)
            for info in cur.classes.values():
                names.update(info.bases)
            for name in names - seen_names:
                for info in project.class_index.get(name, ()):
                    rel = info.module.relpath
                    if rel in by_relpath and rel not in members:
                        members.add(rel)
                        queue.append(info.module)
            seen_names |= names
        got = frozenset(members)
        self._closures[mod.relpath] = got
        return got

    def _key(self, rule_id, relpaths):
        h = hashlib.sha256()
        h.update(analyzer_salt().encode())
        h.update(rule_id.encode() + b"\0")
        for rel in sorted(relpaths):
            h.update(rel.encode() + b"\0"
                     + self._hashes[rel].encode() + b"\0")
        return h.hexdigest()

    # -- storage -------------------------------------------------------

    def _path(self, rule_id, key):
        return os.path.join(self.directory, rule_id, key + ".json")

    def _load(self, rule_id, key):
        try:
            with open(self._path(rule_id, key),
                      encoding="utf-8") as f:
                return [Finding(**d) for d in json.load(f)]
        except (OSError, ValueError, TypeError):
            # missing, torn, or from an incompatible hand edit: a
            # miss, never an error
            return None

    def _store(self, rule_id, key, findings):
        path = self._path(rule_id, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump([fi.as_dict() for fi in sorted(findings)], f)
        os.replace(tmp, path)

    # -- the analyze() hook --------------------------------------------

    def run_rule(self, project, rule_id, fn, scope):
        """Run ``rule_id`` over ``project`` reusing stored results;
        -> (findings, fresh_module_count, cached_module_count)."""
        self._prepare(project)
        if scope != "module":
            key = self._key(rule_id,
                            [m.relpath for m in project.modules])
            got = self._load(rule_id, key)
            if got is not None:
                return got, 0, len(project.modules)
            got = pragma_filtered(project, fn(project))
            self._store(rule_id, key, got)
            return got, len(project.modules), 0
        findings = []
        missing = []
        keys = {}
        for mod in project.modules:
            keys[mod.relpath] = key = self._key(
                rule_id, self.closure(project, mod))
            got = self._load(rule_id, key)
            if got is None:
                missing.append(mod)
            else:
                findings.extend(got)
        if missing:
            # one sub-project covering every missing module's closure
            # (module-scope findings only need that much context);
            # findings for closure members that are themselves cached
            # are recomputed here but the CACHED copies win — both
            # were produced under the same closure signature
            by_relpath = {m.relpath: m for m in project.modules}
            need = set()
            for mod in missing:
                need |= self.closure(project, mod)
            sub = Project([by_relpath[rel] for rel in sorted(need)])
            raw = pragma_filtered(sub, fn(sub))
            wanted = {m.relpath for m in missing}
            per_module = {rel: [] for rel in wanted}
            for fi in raw:
                if fi.file in wanted:
                    per_module[fi.file].append(fi)
            for rel, got in per_module.items():
                self._store(rule_id, keys[rel], got)
                findings.extend(got)
        return (sorted(findings), len(missing),
                len(project.modules) - len(missing))
