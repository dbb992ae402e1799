"""Fleet aggregator + ``python -m veles_torch top``: one view over N
processes.

The port's own copy of ``veles/fleet.py`` (it imports nothing of the JAX
package). The health plane (``health.py``) gives every process probes,
metrics history and SLO alerts; this module is the cluster side: a
scraper that polls N targets' ``/healthz`` + ``/readyz`` + ``/metrics`` +
``/status.json`` + ``/metrics.json`` + ``/debug/critical_path`` +
``/debug/model`` surfaces (a web status dashboard or a serving frontend
of either package, or the reference's router), and renders either a live
refreshing terminal dashboard (``top URL...``) or one machine-readable
snapshot (``--json``). Beside the reference's summary keys, a row
carries ``device_memory_bytes``, the target's
``veles_device_memory_bytes{kind="bytes_in_use"}`` (present once the
target's CUDA is initialized), rendered next to its RSS.

Every fetch is best-effort per endpoint: a serving frontend has no
``/status.json``, an old process has no ``/readyz`` — missing surfaces
degrade the row, never kill the scrape. Non-200 probe answers (a 503
``/readyz`` carries the reason JSON) are read, not treated as transport
errors.
"""

import argparse
import json
import re
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

#: scrape fan-out cap: enough to cover a rack of replicas in one
#: wave without spawning a thread herd for a 200-target fleet
MAX_SCRAPE_WORKERS = 16

#: one Prometheus exposition sample line: name{labels} value
_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


_ESCAPE_RE = re.compile(r"\\(.)")


def _unescape(value):
    # ONE left-to-right pass: sequential str.replace mis-decodes
    # values like 'C:\\\\new' (an escaped backslash followed by a
    # literal n must not become a newline)
    return _ESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), value)


def parse_prometheus(text):
    """Prometheus text exposition -> ``{(name, label_items): value}``
    with ``label_items`` a sorted tuple of (key, value) pairs.
    Comment/HELP/TYPE lines and malformed rows are skipped — a scrape
    must survive whatever a half-written exposition contains."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, value = m.groups()
        try:
            v = float(value)
        except ValueError:
            continue
        items = tuple(sorted(
            (k, _unescape(raw))
            for k, raw in _LABEL_RE.findall(labels or "")))
        out[(name, items)] = v
    return out


def metric_total(metrics, name, **match):
    """Sum of ``name`` samples whose labels contain every ``match``
    item (the scrape-side sibling of ``Registry.counter_total``)."""
    want = {(k, str(v)) for k, v in match.items()}
    total, hit = 0.0, False
    for (n, items), v in metrics.items():
        if n == name and want <= set(items):
            total += v
            hit = True
    return total if hit else None


def metric_max(metrics, name, **match):
    """Max over ``name``'s matching children — for staleness-style
    gauges where the fleet number is the WORST point (summing
    staleness across points would fabricate a worse loop than
    exists)."""
    want = {(k, str(v)) for k, v in match.items()}
    best = None
    for (n, items), v in metrics.items():
        if n == name and want <= set(items):
            best = v if best is None else max(best, v)
    return best


def metric_by_label(metrics, name, label):
    """``{label_value: sum}`` over ``name``'s children grouped by one
    label, or None when the family is absent. Children WITHOUT the
    label (an old exposition predating it) contribute nothing — the
    caller sees an empty dict, not fabricated zeros."""
    out, hit = {}, False
    for (n, items), v in metrics.items():
        if n != name:
            continue
        hit = True
        value = dict(items).get(label)
        if value is not None:
            out[value] = out.get(value, 0.0) + v
    return out if hit else None


def histogram_quantile(metrics, name, q, **match):
    """PromQL-style quantile over ``name``'s cumulative ``_bucket``
    samples (summed across matching children), with linear
    interpolation inside the winning bucket; -> seconds, or None
    when the histogram is absent or empty (a pre-traffic replica
    must read as 'unknown', never 'instant')."""
    want = {(k, str(v)) for k, v in match.items()}
    buckets = {}
    for (n, items), v in metrics.items():
        if n != name + "_bucket":
            continue
        d = dict(items)
        le = d.pop("le", None)
        if le is None or not want <= set(d.items()):
            continue
        try:
            bound = (float("inf") if le == "+Inf" else float(le))
        except ValueError:
            continue
        buckets[bound] = buckets.get(bound, 0.0) + v
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for b in bounds:
        cum = buckets[b]
        if cum >= rank:
            if b == float("inf") or cum == prev_cum:
                return prev_bound if b == float("inf") else b
            return prev_bound + (b - prev_bound) \
                * (rank - prev_cum) / (cum - prev_cum)
        prev_bound, prev_cum = b, cum
    return prev_bound


def _fetch(url, timeout):
    """(status_code, body_bytes) — HTTP error codes are ANSWERS here
    (a 503 /readyz carries the reason payload), only transport
    failures raise."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _fetch_json(url, timeout):
    code, body = _fetch(url, timeout)
    return code, json.loads(body)


def scrape_target(base, timeout=5.0, total=None, extras=True):
    """Poll one process's health surfaces; -> its merged row dict.
    ``base`` is ``http://host:port`` of a web-status dashboard, a
    serving frontend or a router.

    ``total`` caps the WHOLE scrape of this target (default
    ``2 x timeout``): every individual fetch waits at most the
    remaining budget, and once it is spent the later surfaces are
    skipped (``row["partial"] = True``) instead of queueing behind a
    wedged peer — the bound a router control loop on this path needs.
    ``extras=False`` skips the heavyweight optional
    surfaces (``/metrics.json``, ``/status.json``, critical path,
    router status) for tight control-loop scrapes."""
    base = base.rstrip("/")
    if "://" not in base:
        base = "http://" + base
    deadline = time.monotonic() + (2.0 * timeout if total is None
                                   else max(float(total), 0.05))

    def budget():
        """Remaining per-fetch wait: the request timeout, clamped to
        the target's whole-scrape budget (<= 0 once it is spent)."""
        return min(timeout, deadline - time.monotonic())

    row = {"url": base, "reachable": False}

    def spent():
        """True (and the row marked partial) once the whole-scrape
        budget is gone — 'slow target, scrape truncated' must stay
        distinguishable from 'target has no such surface'."""
        if budget() <= 0:
            row["partial"] = True
            return True
        return False

    try:
        code, body = _fetch(base + "/healthz", max(budget(), 0.05))
    except Exception as exc:
        row["error"] = "%s: %s" % (type(exc).__name__, exc)
        return row
    # ANY HTTP answer proves the process is up — a pre-health-plane
    # dashboard 404s /healthz with a text body, and must degrade the
    # row (live=False, no probe doc), never read as DOWN
    row["reachable"] = True
    row["live"] = code == 200
    try:
        row["healthz"] = json.loads(body)
    except ValueError:
        row["healthz"] = None
    try:
        if spent():
            raise TimeoutError("scrape budget spent")
        code, doc = _fetch_json(base + "/readyz", budget())
        row["ready"] = code == 200
        row["reasons"] = list(doc.get("reasons", ()))
        row["checks"] = doc.get("checks", {})
        row["slos"] = doc.get("slos", {})
    except Exception:
        spent()      # a fetch that DIED on the budget marks partial
        row["ready"] = None          # pre-health-plane process
        row["reasons"] = []
        row["slos"] = {}
    try:
        if spent():
            raise TimeoutError("scrape budget spent")
        _, body = _fetch(base + "/metrics", budget())
        metrics = parse_prometheus(body.decode("utf-8", "replace"))
    except Exception:
        # mark truncation when the budget died MID-fetch too: a
        # consumer must never read "metrics absent" (gauges reset)
        # for what was really "metrics unreadable in budget"
        spent()
        metrics = {}
    row["firing"] = sorted(
        dict(items).get("objective", "?")
        for (name, items), v in metrics.items()
        if name == "veles_slo_alert_firing" and v > 0)
    summary = {}
    tx = metric_total(metrics, "veles_wire_bytes_total",
                      direction="tx")
    if tx is not None:
        summary["wire_tx_bytes"] = tx
    # reactor loop lag: the "is the shared loop healthy"
    # number — sustained lag means a callback is blocking the wire
    # plane and every probe behind it
    lag = metric_total(metrics, "veles_reactor_loop_lag_seconds")
    if lag is not None:
        summary["reactor_lag_s"] = lag
    # memory accounting: host RSS rendered next to the
    # loop lag — absent on older targets, which must only degrade
    # the row
    rss = metric_total(metrics, "veles_host_rss_bytes")
    if rss is not None:
        summary["host_rss_bytes"] = rss
    fds = metric_total(metrics, "veles_host_open_fds")
    if fds is not None:
        summary["host_open_fds"] = fds
    dev = metric_total(metrics, "veles_device_memory_bytes",
                       kind="bytes_in_use")
    if dev is not None:
        summary["device_memory_bytes"] = dev
    for key, name in (("serving_requests",
                       "veles_serving_requests_total"),
                      ("serving_rejected",
                       "veles_serving_rejected_total"),
                      ("serving_queue_rows",
                       "veles_serving_queue_rows"),
                      # decode plane: cumulative tokens +
                      # KV occupancy — absent on older targets,
                      # which must only degrade the row
                      ("generated_tokens",
                       "veles_serving_generated_tokens_total"),
                      ("kv_slots_in_use",
                       "veles_serving_kv_slots_in_use"),
                      ("kv_pool_slots",
                       "veles_serving_kv_pool_slots"),
                      ("cluster_slaves", "veles_cluster_slaves"),
                      ("cluster_faults",
                       "veles_cluster_faults_total")):
        v = metric_total(metrics, name)
        if v is not None:
            summary[key] = v
    # continual loop: end-to-end staleness and the served
    # checkpoint's wall — MAX over label children, and absent on
    # older targets, which must only degrade the row
    stale = metric_max(metrics, "veles_staleness_seconds")
    if stale is not None:
        summary["staleness_seconds"] = stale
    wall = metric_max(metrics,
                      "veles_serving_checkpoint_wall_seconds")
    if wall is not None:
        summary["serving_ckpt_wall"] = wall
    # per-request serving p99 out of the Prometheus histogram buckets
    #: what the router's latency routing policy weighs —
    # absent (None) on pre-traffic or pre-histogram targets
    p99 = histogram_quantile(metrics,
                             "veles_serving_latency_seconds", 0.99)
    if p99 is not None:
        summary["serving_p99_s"] = round(p99, 6)
    # per-tenant attribution: requests/rejections on a
    # serving replica, routed requests on a router — families (or
    # their tenant label) absent on older targets, which must
    # only degrade the row
    by_tenant = {}
    for key, name in (("requests",
                       "veles_serving_tenant_requests_total"),
                      ("rejected", "veles_serving_rejected_total"),
                      ("tokens", "veles_serving_tenant_tokens_total"),
                      ("routed", "veles_router_requests_total")):
        grouped = metric_by_label(metrics, name, "tenant")
        for tenant, v in (grouped or {}).items():
            by_tenant.setdefault(tenant, {})[key] = v
    if by_tenant:
        summary["tenants"] = by_tenant
    row["metrics"] = summary
    if not extras:
        # control-loop scrapes target serving replicas: skip the
        # optional surfaces INCLUDING /router/status (a guaranteed
        # 404 round trip per replica per tick otherwise)
        row["role"] = "process"
        return row
    # the router tier: a routing process answers
    # /router/status with its per-backend control-plane state
    try:
        if spent():
            raise TimeoutError("scrape budget spent")
        code, doc = _fetch_json(base + "/router/status", budget())
        if code == 200 and isinstance(doc, dict) \
                and isinstance(doc.get("backends"), list):
            row["router"] = doc
    except Exception:
        pass
    # serving side: the per-model JSON view (rps, p99, queue, shed)
    try:
        if spent():
            raise TimeoutError("scrape budget spent")
        code, doc = _fetch_json(base + "/metrics.json", budget())
        if code == 200 and isinstance(doc, dict) \
                and isinstance(doc.get("models"), dict):
            row["serving"] = doc["models"]
    except Exception:
        pass
    # training side: the dashboard's status providers — the master's
    # row carries cluster topology + per-slave last-job timing
    try:
        if spent():
            raise TimeoutError("scrape budget spent")
        code, doc = _fetch_json(base + "/status.json", budget())
        if code == 200 and isinstance(doc, dict):
            row["status"] = doc
            for st in doc.values():
                if isinstance(st, dict) and "slaves" in st:
                    row["master"] = {
                        "epoch": st.get("epoch"),
                        "max_epochs": st.get("max_epochs"),
                        "n_slaves": st.get("n_slaves"),
                        "complete": st.get("complete"),
                        "faults": st.get("faults"),
                        "slaves": st.get("slaves"),
                    }
    except Exception:
        pass
    # critical-path breakdown: where the step/request time
    # goes, per leg — a 404 from an older target degrades the row,
    # never errors it
    try:
        if spent():
            raise TimeoutError("scrape budget spent")
        code, doc = _fetch_json(
            base + "/debug/critical_path?window=120", budget())
        if code == 200 and isinstance(doc, dict) \
                and ("train" in doc or "serving" in doc):
            row["critical_path"] = doc
    except Exception:
        pass
    # model health: the training-dynamics verdict +
    # loss/grad-norm snapshot — a 404/garbled answer from a target
    # that predates /debug/model degrades the row, never errors it
    try:
        if spent():
            raise TimeoutError("scrape budget spent")
        code, doc = _fetch_json(base + "/debug/model", budget())
        if code == 200 and isinstance(doc, dict) \
                and "verdict" in doc:
            row["model"] = doc
    except Exception:
        pass
    row["role"] = "router" if "router" in row else (
        "master" if "master" in row else (
            "serving" if "serving" in row else "process"))
    return row


def scrape_targets(targets, timeout=5.0, total=None, extras=True,
                   workers=None, pool=None):
    """Scrape every target CONCURRENTLY (thread-pool fan-out, one
    row per target in input order). With the per-target ``total``
    budget inside :func:`scrape_target` this bounds the whole wave
    by the slowest single target instead of the sum — one wedged
    replica used to stall every ``top`` refresh behind it,
    which is fatal for a router control loop on the same path.
    A periodic caller (the router's control
    loop) passes its own long-lived ``pool`` instead of paying
    thread churn every tick."""
    targets = list(targets)
    if not targets:
        return []

    def one(t):
        return scrape_target(t, timeout=timeout, total=total,
                             extras=extras)

    if pool is not None:
        return list(pool.map(one, targets))
    workers = workers or min(len(targets), MAX_SCRAPE_WORKERS)
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="fleet-scrape") as own:
        return list(own.map(one, targets))


def fleet_snapshot(targets, timeout=5.0):
    """Scrape every target; -> the merged fleet document (what
    ``top --json`` prints and an autoscaler consumes)."""
    rows = scrape_targets(targets, timeout=timeout)
    firing = sorted({name for r in rows
                     for name in r.get("firing", ())})
    degraded = sorted(
        r["url"] for r in rows
        if not r.get("reachable") or r.get("ready") is False)
    return {
        "ts": round(time.time(), 3),
        "targets": rows,
        "fleet": {
            "targets": len(rows),
            "reachable": sum(1 for r in rows if r.get("reachable")),
            "ready": sum(1 for r in rows if r.get("ready")),
            "firing_slos": firing,
            "degraded": degraded,
            "slaves": int(sum(
                r.get("metrics", {}).get("cluster_slaves", 0)
                for r in rows)),
        },
    }


# -- rendering ----------------------------------------------------------


def _fmt_critical_path(cp):
    """Per-target step/request breakdown lines out of a
    ``/debug/critical_path`` document — empty when the
    target has no such surface or no attributed traces."""
    if not isinstance(cp, dict):
        return []
    out = []
    for side, label, order in (
            ("train", "step", ("dispatch", "wire", "compute",
                               "merge")),
            ("serving", "serve", ("queue", "execute"))):
        doc = cp.get(side)
        if not isinstance(doc, dict) or not doc.get("jobs"):
            continue
        legs = doc.get("legs") or {}
        parts = [
            "%s %d%%" % (leg,
                         round(100.0 * legs[leg].get("fraction", 0.0)))
            for leg in order if isinstance(legs.get(leg), dict)]
        line = "%s: %s" % (label, " | ".join(parts) or "-")
        straggler = doc.get("straggler")
        if isinstance(straggler, dict) and straggler.get("slave"):
            line += " (straggler slave %s: %s)" \
                % (straggler["slave"], straggler.get("leg", "?"))
        out.append(line)
    return out


def _fmt_ready(row):
    if not row.get("reachable"):
        return "DOWN"
    if row.get("ready") is None:
        return "live"
    return "ready" if row["ready"] else "NOT-READY"


def render_snapshot(snap):
    """The terminal dashboard body for one fleet snapshot."""
    lines = []
    fleet = snap["fleet"]
    lines.append(
        "veles fleet — %d target(s), %d reachable, %d ready, "
        "%d slave(s)%s" % (
            fleet["targets"], fleet["reachable"], fleet["ready"],
            fleet["slaves"],
            "  !! SLO firing: %s" % ", ".join(fleet["firing_slos"])
            if fleet["firing_slos"] else ""))
    lines.append("")
    lines.append("%-28s %-9s %-8s %s"
                 % ("TARGET", "STATE", "ROLE", "DETAIL"))
    for row in snap["targets"]:
        detail = []
        if not row.get("reachable"):
            detail.append(row.get("error", "unreachable"))
        router = row.get("router")
        if isinstance(router, dict):
            backends = router.get("backends") or []
            admitted = sum(1 for b in backends
                           if b.get("state") == "admitted")
            detail.append("router: %d/%d backend(s) admitted"
                          % (admitted, len(backends)))
            bad = ["%s (%s)" % (b.get("url", "?").replace(
                       "http://", ""), b.get("reason") or b.get(
                       "state"))
                   for b in backends
                   if b.get("state") not in ("admitted", None)]
            if bad:
                detail.append("out: " + ", ".join(bad))
            scaler = router.get("autoscaler")
            if isinstance(scaler, dict) and scaler.get("last"):
                last = scaler["last"]
                detail.append("autoscale %s @%s"
                              % (last.get("direction"),
                                 last.get("url", "-")))
            # rolling refresh: which replica last rolled
            # to a fresh checkpoint — absent on older routers,
            # which must only degrade the row
            rolling = router.get("rolling_refresh")
            if isinstance(rolling, dict) \
                    and isinstance(rolling.get("last"), dict):
                last = rolling["last"]
                urls = [b.get("url") for b in backends]
                which = (
                    "replica %d" % urls.index(last.get("replica"))
                    if last.get("replica") in urls
                    else str(last.get("replica", "?")).replace(
                        "http://", ""))
                detail.append("last refresh: %s (%s)"
                              % (which, last.get("outcome", "?")))
        master = row.get("master")
        if master:
            detail.append("epoch %s/%s, %s slave(s)"
                          % (master.get("epoch"),
                             master.get("max_epochs"),
                             master.get("n_slaves")))
            faults = master.get("faults") or {}
            busy = {k: v for k, v in faults.items()
                    if v and k != "joins"}
            if busy:
                detail.append("faults " + ",".join(
                    "%s=%s" % kv for kv in sorted(busy.items())))
        for model, m in sorted((row.get("serving") or {}).items()):
            detail.append(
                "%s v%s: %s rps, p99 %sms, queue %s, shed %s"
                % (model, m.get("version"),
                   m.get("requests_per_sec"),
                   m.get("latency_ms_p99", "-"),
                   m.get("queue_depth"), m.get("shed_total")))
            # decode plane: tokens/s + KV occupancy next
            # to the predict figures — one glance per generative
            # model; absent on non-generative / older targets
            dec = m.get("decode")
            if isinstance(dec, dict):
                detail.append(
                    "%s decode: %s tok/s, kv %s/%s, queue %s"
                    % (model, dec.get("tokens_per_sec"),
                       dec.get("kv_slots_in_use"),
                       dec.get("kv_pool_slots"),
                       dec.get("queue_depth")))
        # model health: loss + trend, worst layer grad
        # norm and the divergence verdict in one glance — absent on
        # older targets or before any observation, which must
        # only degrade the row
        model = row.get("model")
        if isinstance(model, dict) and (
                model.get("loss") is not None
                or model.get("layers")
                or model.get("verdict") not in (None, "healthy")):
            # every scraped field is untrusted (version skew, or a
            # foreign service on that port): type-check before
            # formatting, so a garbled doc degrades this row instead
            # of crashing the whole render
            bits = []
            if isinstance(model.get("loss"), (int, float)):
                bits.append("loss %.5g (%s)"
                            % (model["loss"],
                               model.get("loss_trend", "flat")))
            gns = [d.get("grad_norm")
                   for d in (model.get("layers") or {}).values()
                   if isinstance(d, dict)
                   and isinstance(d.get("grad_norm"), (int, float))]
            if gns:
                bits.append("grad-norm %.3g" % max(gns))
            if isinstance(model.get("rollbacks"), (int, float)) \
                    and model["rollbacks"]:
                bits.append("rollbacks %d" % model["rollbacks"])
            bits.append("verdict %s" % model.get("verdict", "?"))
            detail.append("model: " + ", ".join(bits))
        # per-tenant goodput/shed columns: one line per
        # target naming each resolved tenant's request/routed/shed
        # counts — absent on older targets, which must only
        # degrade the row
        by_tenant = row.get("metrics", {}).get("tenants")
        if isinstance(by_tenant, dict):
            parts = []
            for tenant, d in sorted(by_tenant.items()):
                if not isinstance(d, dict):
                    continue
                bits = []
                if d.get("requests") is not None:
                    bits.append("req %d" % d["requests"])
                if d.get("routed") is not None:
                    bits.append("routed %d" % d["routed"])
                if d.get("tokens"):
                    bits.append("tok %d" % d["tokens"])
                if d.get("rejected"):
                    bits.append("shed %d" % d["rejected"])
                if bits:
                    parts.append("%s: %s" % (tenant, " ".join(bits)))
            if parts:
                detail.append("tenants " + " | ".join(parts))
        # host RSS and reactor lag side by side: one glance
        # gives "how much memory, how healthy the loop" per target —
        # either may be absent (older process) without a row
        # error
        health_bits = []
        # the loop SLO leads: "how far behind the stream
        # is what this target runs" — absent on older targets
        stale = row.get("metrics", {}).get("staleness_seconds")
        if stale is not None:
            health_bits.append("staleness %.0fs" % stale)
        rss = row.get("metrics", {}).get("host_rss_bytes")
        if rss is not None:
            health_bits.append("rss %.1fMB" % (rss / 1048576.0))
        dev = row.get("metrics", {}).get("device_memory_bytes")
        if dev is not None:
            health_bits.append("device %.1fMB" % (dev / 1048576.0))
        lag = row.get("metrics", {}).get("reactor_lag_s")
        if lag is not None:
            health_bits.append("reactor lag %.1fms" % (lag * 1e3))
        if health_bits:
            detail.append(", ".join(health_bits))
        detail.extend(_fmt_critical_path(row.get("critical_path")))
        if row.get("firing"):
            detail.append("SLO firing: " + ",".join(row["firing"]))
        if row.get("ready") is False:
            detail.extend(row.get("reasons", ()))
        lines.append("%-28s %-9s %-8s %s"
                     % (row["url"].replace("http://", ""),
                        _fmt_ready(row), row.get("role", "-"),
                        "; ".join(str(d) for d in detail) or "-"))
        for sid, srow in sorted(
                ((master or {}).get("slaves") or {}).items()):
            lines.append(
                "%-28s %-9s %-8s jobs %s, rtt %ss, compute %ss, "
                "wire %ss, idle %ss"
                % ("  slave %s (%s)" % (sid, srow.get("name")),
                   "", "", srow.get("jobs"), srow.get("last_rtt_s"),
                   srow.get("last_job_s"), srow.get("last_wire_s"),
                   srow.get("idle_s")))
    return "\n".join(lines)


def top_main(argv=None):
    """``python -m veles_torch top URL [URL...]`` — live fleet dashboard;
    with ``--json`` print ONE snapshot document and exit (0 when a target
    is reachable, 2 when none is)."""
    p = argparse.ArgumentParser(
        prog="python -m veles_torch top",
        description="Live cluster dashboard over /healthz + /readyz "
                    "+ /metrics + status surfaces of web-status "
                    "dashboards and serving frontends")
    p.add_argument("targets", nargs="+",
                   help="base URLs (http://host:port) of web-status "
                        "dashboards and/or serving frontends")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds (live mode)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-request HTTP timeout")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable snapshot and "
                        "exit (the autoscaler/router artifact)")
    p.add_argument("--once", action="store_true",
                   help="render one dashboard frame and exit")
    args = p.parse_args(argv)
    if args.json or args.once:
        snap = fleet_snapshot(args.targets, timeout=args.timeout)
        if args.json:
            print(json.dumps(snap, indent=2))
        else:
            print(render_snapshot(snap))
        return 0 if snap["fleet"]["reachable"] else 2
    try:
        while True:
            snap = fleet_snapshot(args.targets, timeout=args.timeout)
            # clear + home, then one frame (same trick real top uses)
            sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(render_snapshot(snap) + "\n")
            sys.stdout.write(
                "\n[%s] refreshing every %gs — ^C to quit\n"
                % (time.strftime("%H:%M:%S"), args.interval))
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
