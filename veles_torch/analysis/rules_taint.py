"""Taint rules: untrusted wire/HTTP input must not steer resources.

The runtime is a trust-boundary factory — pickled master<->slave
frames, a public HTTP plane, environment overrides — and "validated
at admission" is a convention until something enforces it. These
rules sit on :func:`veles_torch.analysis.engine.taint_hits`, the shared
whole-program taint pass, and turn each sink category into a finding:

* ``untrusted-geometry`` — a wire/HTTP-derived value sizes an
  allocation (``zeros``/``empty``/``arange``/``bytearray`` extents,
  ``range`` trip counts, ``[x] * n`` repetition): a client-chosen
  integer becomes memory or iterations;
* ``unbounded-cardinality`` — a persistent container (``self.X`` /
  module global) is keyed by a wire/HTTP/env value without a bounded
  resolver: callers mint entries that live forever (the generalized
  form of telemetry-hygiene's wire-label check, for ANY dict/set);
* ``unsafe-deserialize`` — ``pickle.loads``/``marshal.loads`` of
  untrusted bytes not dominated by ``hmac.compare_digest``: code
  execution for whoever can reach the socket;
* ``untrusted-path`` — a wire/HTTP value reaches a filesystem call or
  a ``checkpoint=``/``store=``-style target keyword: clients choose
  what the server opens.

Sanitizers the engine recognizes (see the engine docstring):
``*resolve*``/``*clamp*``/``*validate*``/``*sanitize*``-named calls,
``# zlint: sanitizer``-annotated defs (and ``Bounded*``/annotated
container classes), explicit comparison/membership/isinstance guards,
``min()`` against an untainted bound, and HMAC-verify domination for
the deserialize sink.
"""

from veles_torch.analysis.core import Finding, register
from veles_torch.analysis.engine import taint_hits

#: sink category -> (rule id, message template, hint)
_SINKS = {
    "geometry": (
        "untrusted-geometry",
        "allocation geometry from %s input: %s — a client-chosen "
        "number becomes memory/iterations",
        "clamp against a server-side bound (min(x, CAP) or an "
        "explicit comparison guard) before it sizes anything, or "
        "route it through a *validate*/*clamp* helper"),
    "cardinality": (
        "unbounded-cardinality",
        "persistent container keyed by %s input: %s — every novel "
        "value is a new entry that lives forever",
        "fold keys through a bounded resolver (e.g. "
        "tenants.TenantTable.resolve) or store them in a capped "
        "container class (Bounded*/# zlint: sanitizer annotated)"),
    "deserialize": (
        "unsafe-deserialize",
        "%s-derived bytes reach %s without HMAC verification — "
        "arbitrary object construction for whoever reaches the "
        "socket",
        "verify hmac.compare_digest over the exact framed bytes "
        "before decoding (see server.recv_frame), or switch to a "
        "data-only codec"),
    "path": (
        "untrusted-path",
        "filesystem/store target from %s input: %s — clients choose "
        "what the server opens",
        "resolve the name against a server-side registry/allowlist "
        "(a *resolve*-named or # zlint: sanitizer helper) before it "
        "touches storage"),
}


def _chain_suffix(chain):
    if len(chain) <= 1:
        return ""
    return " (via %s)" % " -> ".join(chain)


def _findings_for(project, sink):
    rule_id, template, hint = _SINKS[sink]
    out = []
    for hit in taint_hits(project):
        if hit.sink != sink:
            continue
        kinds = "+".join(sorted(hit.kinds))
        out.append(Finding(
            hit.module.relpath, hit.lineno, rule_id, "error",
            (template % (kinds, hit.detail)) + _chain_suffix(
                hit.chain),
            hint))
    return out


@register("untrusted-geometry", "error",
          "no wire/HTTP-derived value may size an allocation or a "
          "loop without a clamp")
def check_untrusted_geometry(project):
    return _findings_for(project, "geometry")


@register("unbounded-cardinality", "error",
          "no persistent dict/set keyed by unresolved wire/HTTP/env "
          "values")
def check_unbounded_cardinality(project):
    return _findings_for(project, "cardinality")


@register("unsafe-deserialize", "error",
          "no pickle/marshal decode of untrusted bytes outside HMAC "
          "verification")
def check_unsafe_deserialize(project):
    return _findings_for(project, "deserialize")


@register("untrusted-path", "error",
          "no wire/HTTP-derived filesystem or checkpoint/store "
          "targets without registry resolution")
def check_untrusted_path(project):
    return _findings_for(project, "path")
