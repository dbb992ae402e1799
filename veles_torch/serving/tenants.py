"""Per-tenant identity, quotas and fair-share weights of the port's
serving plane.

The port's own copy of ``veles/serving/tenants.py`` (it imports nothing
of the JAX package):

* **bounded identity** — :meth:`TenantTable.resolve` maps the
  ``x-veles-tenant`` header to a known tenant name, the configured
  default for unkeyed callers, or the fixed ``"other"`` bucket for
  unknown keys; telemetry labels only ever see resolver output, so
  label cardinality is ``len(tenants) + 2``;
* **token-bucket quotas** — :meth:`TenantTable.admit` charges one
  request against the tenant's ``rps``/``burst`` budget and, when the
  bucket is dry, says how long until it is not (the 429's
  ``Retry-After``);
* **priority weights** — :meth:`TenantTable.weight` turns the tenant's
  priority class into the weight the micro-batcher's and the
  continuous batcher's weighted-fair (virtual-time) queues schedule by,
  and :meth:`TenantTable.best_effort` marks the classes shed first
  under pressure (503 before any compute).

Config is one JSON document (``python -m veles_torch serve --tenants
FILE``)::

    {"default": "anon",
     "slo": {"p99_ms": 250.0, "target": 0.001},
     "tenants": {
         "acme":  {"rps": 50, "burst": 100, "priority": "gold"},
         "anon":  {"rps": 5,  "burst": 10,  "priority": "bronze"},
         "batch": {"rps": 20, "burst": 20,  "priority": "batch"}}}

Omitted ``rps`` means unmetered; ``priority`` defaults to ``silver``.
The optional ``slo`` block templates one per-tenant p99 burn-rate
objective per configured tenant (:meth:`TenantTable.install_slos` ->
``health.add_slo``).

The table is installed process-wide (:func:`set_table`); with no table
installed every tenant weighs 1 and the virtual-time queues are first
in first out.
"""

import json
import threading
import time

#: the resolver's two synthetic tenants: unkeyed callers land on the
#: (configurable) default, unknown keys fold into one bounded bucket
DEFAULT_TENANT = "anon"
OTHER_TENANT = "other"

#: priority class -> fair-share weight. "batch" is best-effort: it
#: also sheds FIRST (503) while the process is under pressure.
PRIORITY_WEIGHTS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0,
                    "batch": 1.0}
BEST_EFFORT = frozenset(("batch",))

_DEFAULT_SLO_P99_MS = 250.0
_DEFAULT_SLO_TARGET = 0.001


class TenantQuota(object):
    """One tenant's token bucket + priority class."""

    __slots__ = ("name", "rps", "burst", "priority", "_tokens",
                 "_stamp")

    def __init__(self, name, rps=None, burst=None, priority="silver"):
        if priority not in PRIORITY_WEIGHTS:
            raise ValueError(
                "tenant %r: unknown priority %r (one of %s)"
                % (name, priority,
                   ", ".join(sorted(PRIORITY_WEIGHTS))))
        if rps is not None and rps <= 0:
            raise ValueError("tenant %r: rps must be > 0" % name)
        self.name = name
        self.rps = float(rps) if rps is not None else None
        self.burst = float(burst) if burst is not None else (
            self.rps if self.rps is not None else None)
        self.priority = priority
        self._tokens = self.burst
        self._stamp = time.monotonic()

    def admit(self, now, cost=1.0):
        """-> (admitted, retry_after_s). Caller holds the table
        lock."""
        if self.rps is None:
            return True, 0.0
        self._tokens = min(
            self.burst,
            self._tokens + (now - self._stamp) * self.rps)
        self._stamp = now
        if self._tokens >= cost:
            self._tokens -= cost
            return True, 0.0
        return False, max((cost - self._tokens) / self.rps, 0.001)


class TenantTable(object):
    """The per-tenant config: resolver + quotas + weights + the
    cached ``/debug/tenants`` document."""

    def __init__(self, tenants=None, default=DEFAULT_TENANT,
                 slo=None):
        self._lock = threading.Lock()
        self.default = default
        self.slo = dict(slo or {})
        self._quotas = {}
        for name, spec in sorted((tenants or {}).items()):
            spec = dict(spec or {})
            self._quotas[name] = TenantQuota(
                name, rps=spec.pop("rps", None),
                burst=spec.pop("burst", None),
                priority=spec.pop("priority", "silver"))
            if spec:
                raise ValueError(
                    "tenant %r: unknown key(s) %s"
                    % (name, ", ".join(sorted(spec))))
        # the default tenant always exists (unmetered unless listed)
        if default not in self._quotas:
            self._quotas[default] = TenantQuota(default)
        # ... and so does the unknown-key fold bucket
        if OTHER_TENANT not in self._quotas:
            self._quotas[OTHER_TENANT] = TenantQuota(OTHER_TENANT,
                                                     priority="bronze")

    @classmethod
    def from_file(cls, path):
        with open(path) as fin:
            doc = json.load(fin)
        return cls.from_dict(doc)

    @classmethod
    def from_dict(cls, doc):
        if not isinstance(doc, dict):
            raise ValueError("tenant config must be a JSON object")
        unknown = set(doc) - {"tenants", "default", "slo"}
        if unknown:
            raise ValueError("tenant config: unknown key(s) %s"
                             % ", ".join(sorted(unknown)))
        return cls(tenants=doc.get("tenants"),
                   default=doc.get("default", DEFAULT_TENANT),
                   slo=doc.get("slo"))

    # -- identity ------------------------------------------------------

    def resolve(self, key):
        """Bounded tenant name for one raw header value: the header's
        tenant if configured, the default for missing/empty keys, the
        ``other`` fold for everything else. THE only function whose
        output may reach a telemetry label."""
        if not key:
            return self.default
        return key if key in self._quotas else OTHER_TENANT

    def names(self):
        return sorted(self._quotas)

    # -- enforcement ---------------------------------------------------

    def admit(self, tenant, cost=1.0):
        """Charge ``cost`` requests against ``tenant``'s bucket ->
        (admitted, retry_after_s). Unknown tenants (resolver output
        only, so: the fold bucket) share ``other``'s bucket."""
        quota = self._quotas.get(tenant)
        if quota is None:
            quota = self._quotas[OTHER_TENANT]
        with self._lock:
            return quota.admit(time.monotonic(), cost)

    def weight(self, tenant):
        quota = self._quotas.get(tenant)
        if quota is None:
            return PRIORITY_WEIGHTS["bronze"]
        return PRIORITY_WEIGHTS[quota.priority]

    def best_effort(self, tenant):
        """True for tenants that shed FIRST while the process is
        under pressure (priority class ``batch``)."""
        quota = self._quotas.get(tenant)
        return quota is not None and quota.priority in BEST_EFFORT

    # -- observability -------------------------------------------------

    def describe(self):
        """The ``/debug/tenants`` document — config + live bucket
        levels. Cheap enough for the reactor loop: one small lock
        around a dict walk, no I/O."""
        now = time.monotonic()
        out = {}
        with self._lock:
            for name, q in sorted(self._quotas.items()):
                tokens = None
                if q.rps is not None:
                    tokens = min(q.burst, q._tokens
                                 + (now - q._stamp) * q.rps)
                out[name] = {
                    "priority": q.priority,
                    "weight": PRIORITY_WEIGHTS[q.priority],
                    "rps": q.rps, "burst": q.burst,
                    "tokens": (round(tokens, 3)
                               if tokens is not None else None),
                    "default": name == self.default}
        return {"default": self.default, "slo": self.slo,
                "tenants": out}

    def install_slos(self, monitor, series_tmpl=None):
        """One per-tenant p99 burn-rate objective per configured
        tenant (``health.add_slo`` "threshold" kind over the
        tenant-labelled serving latency histogram). -> names added."""
        p99_ms = float(self.slo.get("p99_ms", _DEFAULT_SLO_P99_MS))
        target = float(self.slo.get("target", _DEFAULT_SLO_TARGET))
        tmpl = series_tmpl or \
            'veles_serving_tenant_latency_seconds{tenant="%s"}:p99'
        names = []
        for tenant in self.names():
            name = "tenant_p99:%s" % tenant
            monitor.add_slo({
                "name": name, "kind": "threshold",
                "series": tmpl % tenant, "op": "<",
                "threshold": p99_ms / 1000.0, "target": target})
            names.append(name)
        return names


# -- the process-wide table ---------------------------------------------

_table = None
_table_lock = threading.Lock()


def set_table(table):
    """Install ``table`` process-wide (None uninstalls). The batchers
    read it for fair-share weights; the frontend for everything."""
    global _table
    with _table_lock:
        _table = table
    return table


def get_table():
    return _table


def weight(tenant):
    """Fair-share weight for ``tenant`` under the installed table
    (1.0 with no table — FIFO-equivalent scheduling)."""
    table = _table
    if table is None or tenant is None:
        return 1.0
    return table.weight(tenant)
