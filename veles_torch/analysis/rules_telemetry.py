"""telemetry-hygiene: keep the metrics registry cheap and bounded.

Two failure modes the telemetry core cannot defend against at
runtime:

* **families created inside loops** — ``telemetry.counter(...)`` is
  idempotent-by-name but pays the registry lock + dict lookup every
  call; a creation inside a ``for``/``while`` body is either a hot
  path that should hold a :class:`veles_torch.telemetry.LazyChild`, or an
  unbounded family leak when the name is formatted per iteration;
* **label values minted from identities** — ``.labels(id(x))``,
  ``uuid4()``, ``token_hex()``, ``getpid()`` or a ``*_id`` loop
  variable create a new child per value; Prometheus series are
  forever, so identity-labelled series grow without bound (the
  cluster aggregation path deliberately bounds its ``slave`` label
  via per-token TTL eviction — see ``MasterServer._tele_states``);
* **span names minted from identities** — the tracing twin of the
  label failure mode: ``tracer.span("job-%s" % job_id)`` turns every
  request into its own timeline row (Perfetto groups by name) and an
  unbounded name universe in any aggregating backend. The identity
  belongs in the span's ``args`` (``span("job.serve",
  job_id=job_id)``), where it is per-event payload, not cardinality.
* **label values taken from the wire** — a ``.labels(...)``
  argument that reads ``request.headers``/``request.body`` hands the
  INTERNET the keys of your series dict: every novel header value is
  a new child that lives forever. Caller attribution must pass
  through a bounded resolver first (``TenantTable.resolve`` maps
  unknown keys to one ``other`` bucket — veles_torch/serving/tenants.py);
  a ``*resolve*``-named call wrapping the whole argument is the
  recognized escape hatch.
"""

import ast

from veles_torch.analysis import engine
from veles_torch.analysis.core import Finding, register

_FACTORIES = ("counter", "gauge", "histogram")

#: calls whose result is an unbounded identity when used as a label
_IDENTITY_CALLS = ("id", "uuid4", "uuid1", "token_hex", "token_urlsafe",
                   "getpid", "get_ident", "monotonic", "time",
                   "perf_counter")


def _is_factory_call(node, telemetry_aliases, registry_handles):
    """True for ``telemetry.counter(...)`` / ``registry.counter(...)``
    shaped calls carrying a metric-name first argument — literal OR
    computed: a name formatted per iteration is the worse failure
    mode (one leaked family per value), so it must not be exempt."""
    fn = node.func
    if not isinstance(fn, ast.Attribute) or fn.attr not in _FACTORIES:
        return False
    if not node.args:
        return False
    base = fn.value
    if isinstance(base, ast.Name) and (
            base.id in telemetry_aliases
            or base.id in registry_handles):
        return True
    # <anything>.get_registry().counter(...) or a var named *registry*
    if isinstance(base, ast.Call) and isinstance(
            base.func, ast.Attribute) \
            and base.func.attr == "get_registry":
        return True
    if isinstance(base, ast.Name) and "registry" in base.id.lower():
        return True
    return False


def _telemetry_aliases(mod):
    """Local names the telemetry module is imported under, through
    any import spelling (the shared canonicalization)."""
    return {local for local, dotted
            in engine.canonical_import_prefixes(mod).items()
            if dotted == "veles_torch.telemetry"}


def _registry_handles(mod):
    """Local names bound from a ``*.get_registry()`` call — the
    handle style the runtime actually uses (``reg =
    telemetry.get_registry()``), whatever the variable is called."""
    out = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Attribute) \
                and node.value.func.attr == "get_registry":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _loop_spans(tree):
    """[(start, end)] line spans of for/while bodies."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            end = getattr(node, "end_lineno", node.lineno)
            spans.append((node.lineno, end))
    return spans


def _has_identity(node):
    """True when the expression involves an identity-shaped value: a
    call to an id/uuid/token factory, or a name ending in
    ``_id``/named ``uuid``/``token``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if fname in _IDENTITY_CALLS:
                return True
        elif isinstance(sub, (ast.Name, ast.Attribute)):
            n = (sub.id if isinstance(sub, ast.Name)
                 else sub.attr).lower()
            if n.endswith("_id") or n in ("uuid", "token"):
                return True
    return False


def _identity_labelled(node):
    """True when a ``.labels(...)`` call passes an identity-shaped
    value."""
    return any(_has_identity(arg) for arg in
               list(node.args) + [kw.value for kw in node.keywords])


#: attribute names that read caller-controlled bytes off the wire
_WIRE_SOURCES = ("headers", "body")


def _resolver_wrapped(node):
    """True when the whole expression is a call to a ``*resolve*``
    function — the bounded escape hatch (``table.resolve(...)``,
    ``tenants.resolve(...)``, ``_resolve_tenant(...)``)."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    fname = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else "")
    return "resolve" in fname.lower()


def _wire_derived(node):
    """True when the expression reads ``*.headers``/``*.body``
    anywhere inside — ``request.headers.get("x-veles-tenant")``,
    ``req.headers["x-api-key"]``, ``request.body`` — i.e. the value
    universe is whatever callers choose to send."""
    if _resolver_wrapped(node):
        return False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _WIRE_SOURCES:
            return True
    return False


def _wire_labelled(node):
    """True when a ``.labels(...)`` call passes a header/body-derived
    value without the resolver escape."""
    return any(_wire_derived(arg) for arg in
               list(node.args) + [kw.value for kw in node.keywords])


def _is_span_call(node):
    """``*.span(name, ...)`` / ``*.add_complete(name, ...)`` calls on
    a telemetry/tracer-shaped receiver — ``telemetry.span(...)``,
    ``tracer.span(...)``, ``telemetry.tracer.add_complete(...)``, a
    ``self._tracer``-style attribute. Receiver-shape matching keeps
    unrelated ``.span`` methods out."""
    fn = node.func
    if not isinstance(fn, ast.Attribute) \
            or fn.attr not in ("span", "add_complete") \
            or not node.args:
        return False
    base = fn.value
    if isinstance(base, ast.Name):
        name = base.id.lower()
        return name == "telemetry" or "tracer" in name
    if isinstance(base, ast.Attribute):
        return "tracer" in base.attr.lower()
    return False


def _formatted_identity(node):
    """True when a string-building expression (``%``, f-string,
    ``.format``, ``+``) interpolates an identity-shaped value."""
    operands = []
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        operands.append(node.right)
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        operands.extend((node.left, node.right))
    elif isinstance(node, ast.JoinedStr):
        operands.extend(v.value for v in node.values
                        if isinstance(v, ast.FormattedValue))
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "format":
        operands.extend(node.args)
        operands.extend(kw.value for kw in node.keywords)
    return any(_has_identity(op) for op in operands)


@register("telemetry-hygiene", "error",
          "no instrument creation in loops; no unbounded identity "
          "label values or span names", scope="module")
def check_telemetry_hygiene(project):
    findings = []
    for mod in project.modules:
        aliases = _telemetry_aliases(mod)
        handles = _registry_handles(mod)
        spans = None
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_factory_call(node, aliases, handles):
                if spans is None:
                    spans = _loop_spans(mod.tree)
                if any(s <= node.lineno <= e for s, e in spans):
                    findings.append(Finding(
                        mod.relpath, node.lineno, "telemetry-hygiene",
                        "error",
                        "instrument family created inside a loop — "
                        "pays the registry lock per iteration (or "
                        "leaks families if the name varies)",
                        "hoist the creation out of the loop or hold "
                        "a telemetry.LazyChild at the call site"))
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "labels" \
                    and (node.args or node.keywords):
                if _identity_labelled(node):
                    findings.append(Finding(
                        mod.relpath, node.lineno, "telemetry-hygiene",
                        "error",
                        "label value minted from an identity (id/uuid/"
                        "token/pid) — every value is a new series that "
                        "lives forever",
                        "label by a bounded dimension (kind, model, "
                        "unit name); aggregate identities before "
                        "labelling or bound them with TTL eviction"))
                if _wire_labelled(node):
                    findings.append(Finding(
                        mod.relpath, node.lineno, "telemetry-hygiene",
                        "error",
                        "label value read from request headers/body "
                        "without a bounded resolver — callers mint "
                        "series at will (unbounded cardinality from "
                        "the wire)",
                        "pass the raw value through a bounded "
                        "resolver first, e.g. "
                        "tenants.TenantTable.resolve(...), which "
                        "folds unknown keys into one 'other' bucket"))
            if _is_span_call(node) \
                    and _formatted_identity(node.args[0]):
                findings.append(Finding(
                    mod.relpath, node.lineno, "telemetry-hygiene",
                    "error",
                    "span name minted from a per-request identity "
                    "(id/uuid/token/pid) — every request becomes its "
                    "own timeline row / unbounded name cardinality "
                    "(same failure mode as identity label values)",
                    "use a constant span name and carry the identity "
                    "in the span args: span(\"job.serve\", "
                    "job_id=job_id)"))
    return findings
