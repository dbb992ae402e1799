"""Model-health plane of the PyTorch port: layer stats, the divergence
verdict and the rollback actuator.

The port's own copy of ``veles/model_health.py`` (it imports nothing of
the JAX package). A per-process :class:`ModelHealthMonitor` consumes

* **layer stats** — every GD unit's ``update_weights`` computes, on the
  steps the stride makes due, a ``STAT_FIELDS`` vector (gradient /
  weight L2 norms, the update ratio, the gradients' non-finite count)
  on the device; the step copies a class's vectors to the host in the
  class's one metrics copy and publishes them here in step order
  (``znicz/step.py``);
* **evaluation-tick losses** — the decision feeds each epoch's judged
  loss; an EWMA mean/variance pair turns it into a z-score;
* **wire-side non-finite counts**, **slave summaries** — the master's
  inputs (``server.py``: every merged delta's non-finite entries, each
  slave's pushed summary, evicted when the slave leaves);
* **serving drift** — per-batch output entropy and top-1 margin of a
  served model (``serving/batcher.py``).

From them it keeps a cached verdict, ``healthy`` / ``suspect`` /
``diverged``, with the reference's detector: thresholds, EWMA and
z-score arithmetic, recovery streak, the ``enabled`` switch (``--model-
stats off``) and the ``unknown`` stamp of a disabled plane. The
snapshotter stamps :meth:`ModelHealthMonitor.manifest_stamp` into every
checkpoint's manifest, so ``resolve_auto`` passes over ``diverged``
ones; ``NNRollback(rollback_on_divergence=True)`` and
:class:`WeightGuard` restore the last good weights when the verdict
flips.

The reference's ``veles_model_*`` / ``veles_serving_*`` instruments live
on the port's telemetry registry (``telemetry.py``) under the reference's
family names and labels; :meth:`ModelHealthMonitor.metrics` is the
monitor's own view of them (Prometheus-style label keys, ``layer="fc"``).
A verdict change is a ``model_divergence`` flight-recorder event, a
restore a ``model_rollback`` one. The HTTP half:
:meth:`ModelHealthMonitor.register_health` adds the ``model:divergence``
check to ``/readyz``, :func:`install_model_slos` the divergence SLOs
(:data:`MODEL_SLOS`) to the health plane (``health.py``), and
:func:`debug_model_doc` is ``GET /debug/model``. The monitor is this
package's own process-global, never the reference's: both packages can
run in one process.
"""

import logging
import math
import re
import threading
import time
from contextlib import contextmanager

import numpy
import torch

from veles_torch import telemetry

logger = logging.getLogger("veles_torch.model_health")

#: step-output key marker for layer stats: ``STAT_KEY_PREFIX + unit
#: name`` -> a float32 ``STAT_FIELDS`` vector
STAT_KEY_PREFIX = "stat/"

#: the per-layer stat vector layout
STAT_FIELDS = ("grad_norm", "weight_norm", "update_ratio", "nonfinite")

#: verdict ladder (gauge encoding: healthy=0, suspect=1, diverged=2)
VERDICTS = ("healthy", "suspect", "diverged")


def take_stats(outputs):
    """Split a step-output dict into ``(stats, rest)`` where ``stats``
    maps layer name -> stat vector."""
    stats, rest = {}, {}
    for key, value in outputs.items():
        if key.startswith(STAT_KEY_PREFIX):
            stats[key[len(STAT_KEY_PREFIX):]] = value
        else:
            rest[key] = value
    return stats, rest


def _labels(*items):
    """Prometheus-style label key: ``layer="fc",slave="3"``."""
    return ",".join('%s="%s"' % kv for kv in items)


_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')

#: the reference's instrument families: name -> (kind, help, labels)
FAMILIES = {
    "veles_model_grad_norm": (
        "gauge", "Per-layer in-graph training stat (grad_norm)",
        ("layer",)),
    "veles_model_weight_norm": (
        "gauge", "Per-layer in-graph training stat (weight_norm)",
        ("layer",)),
    "veles_model_update_ratio": (
        "gauge", "Per-layer in-graph training stat (update_ratio)",
        ("layer",)),
    "veles_model_nonfinite_total": (
        "counter", "Non-finite values observed in gradients, wire deltas "
        "or weights, by layer", ("layer",)),
    "veles_model_nonfinite_step": (
        "gauge", "Non-finite count in the LAST published observation (0 "
        "while training is clean — the ring series divergence SLOs fire "
        "on)", ()),
    "veles_model_loss": (
        "gauge", "Last evaluation-tick loss fed by the decision", ()),
    "veles_model_loss_zscore": (
        "gauge", "EWMA z-score of the last loss (the loss-spike detector "
        "input)", ()),
    "veles_model_verdict": (
        "gauge", "Model-health verdict: 0 healthy, 1 suspect, 2 diverged",
        ()),
    "veles_serving_logit_entropy": (
        "gauge", "Mean output-distribution entropy of the last served "
        "batch (drift gauge)", ("model",)),
    "veles_serving_top1_margin": (
        "gauge", "Mean top-1 minus top-2 probability of the last served "
        "batch (drift gauge)", ("model",)),
}


def _family(name):
    kind, help, labels = FAMILIES[name]
    return getattr(telemetry, kind)(name, help, labels)


class ModelHealthMonitor:
    """Per-process model-health state: layer stats, loss trajectory,
    divergence verdict.

    Detector policy (each observation contributes reasons):

    * any non-finite — stat vectors, wire deltas, weight scans, the loss
      itself — is **diverged** immediately;
    * loss EWMA z-score ≥ ``suspect_z`` is **suspect**, ≥
      ``diverged_z`` is **diverged**;
    * gradient-norm explosion: a layer's grad norm ≥
      ``explosion_factor ×`` its own EWMA is **suspect**;
    * ``recover_after`` consecutive clean observations clear the verdict
      back to healthy.
    """

    def __init__(self, suspect_z=4.0, diverged_z=8.0,
                 explosion_factor=10.0, ewma_alpha=0.2,
                 recover_after=3):
        self.suspect_z = float(suspect_z)
        self.diverged_z = float(diverged_z)
        self.explosion_factor = float(explosion_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.recover_after = int(recover_after)
        #: master switch (``--model-stats off`` clears it): a disabled
        #: plane still records its gauges but never judges, so the
        #: verdict stays healthy and checkpoints are stamped ``unknown``
        self.enabled = True
        #: after a non-finite wire observation, clean per-unit merge
        #: notes count as at most one healthy observation per this many
        #: seconds
        self.wire_recovery_interval = 1.5
        self._clean_wire_last = None
        #: serving drift is computed on every Nth dispatched batch of a
        #: model
        self.serving_stride = 16
        self._serving_ticks = {}
        self._lock = threading.Lock()
        #: layer name -> {field: float} (latest published stats)
        self._layers = {}
        #: layer name -> grad-norm EWMA (explosion baseline)
        self._grad_ewma = {}
        self._loss = None
        self._loss_ewma = None
        self._loss_var = None
        self._loss_z = 0.0
        self._loss_history = []       # (epoch, loss) tail, bounded
        self._epoch = None
        self._step = None
        self._verdict = "healthy"
        self._reasons = []
        self._healthy_streak = 0
        self._nonfinite_total = 0
        self._rollbacks = 0
        #: slave id -> last absorbed summary (master aggregation)
        self._slaves = {}
        #: served model -> {entropy, margin} drift snapshot
        self._serving = {}
        self._updated = None
        self._doc = self._build_doc()
        #: the reference's instruments: name -> {label key: value}
        self._series = {name: {} for name in FAMILIES}

    def _set(self, name, value, key=""):
        self._series[name][key] = float(value)
        _family(name).child(_LABEL_RE.findall(key)).set(float(value))

    def _inc(self, name, value, key=""):
        series = self._series[name]
        series[key] = series.get(key, 0.0) + float(value)
        _family(name).child(_LABEL_RE.findall(key)).inc(float(value))

    def metrics(self):
        """{instrument name: {label key: value}} — the reference's
        ``veles_model_*`` / ``veles_serving_*`` series (an unlabelled
        series under the key ``""``)."""
        with self._lock:
            return {name: dict(series)
                    for name, series in self._series.items()}

    # -- observations --------------------------------------------------

    def observe_stats(self, layer_stats, step_index=None):
        """Publish one cadence tick of layer stats: ``layer_stats`` maps
        layer name -> host ``STAT_FIELDS`` vector."""
        reasons = []
        nonfinite_now = 0
        with self._lock:
            for layer, vec in layer_stats.items():
                vec = numpy.asarray(vec, numpy.float64).reshape(-1)
                if vec.shape[0] < len(STAT_FIELDS):
                    continue
                doc = {}
                for i, field in enumerate(STAT_FIELDS):
                    v = float(vec[i])
                    doc[field] = v if math.isfinite(v) else None
                self._layers[layer] = doc
                gn = doc["grad_norm"]
                nf = int(doc["nonfinite"] or 0)
                # a non-finite NORM means the gradient carried NaN/inf
                # even when the count missed it (inf² overflow): count
                # it as at least one
                if gn is None or doc["weight_norm"] is None:
                    nf = max(nf, 1)
                if nf:
                    nonfinite_now += nf
                    self._nonfinite_total += nf
                    self._inc("veles_model_nonfinite_total", nf,
                              _labels(("layer", layer)))
                    reasons.append(
                        ("diverged", "nonfinite:%s" % layer))
                elif gn is not None:
                    ewma = self._grad_ewma.get(layer)
                    if ewma is not None and ewma > 0.0 and \
                            gn >= self.explosion_factor * ewma:
                        reasons.append((
                            "suspect",
                            "grad_explosion:%s (%.3g >= %gx %.3g)"
                            % (layer, gn, self.explosion_factor,
                               ewma)))
                    self._grad_ewma[layer] = gn if ewma is None else \
                        (1.0 - self.ewma_alpha) * ewma \
                        + self.ewma_alpha * gn
                    for field in ("grad_norm", "weight_norm",
                                  "update_ratio"):
                        if doc[field] is not None:
                            self._set("veles_model_" + field, doc[field],
                                      _labels(("layer", layer)))
            if step_index is not None:
                self._step = int(step_index)
            self._set("veles_model_nonfinite_step", nonfinite_now)
            self._judge(reasons)

    def observe_loss(self, loss, epoch=None):
        """One evaluation-tick loss (the decision's judged class)."""
        loss = float(loss)
        reasons = []
        with self._lock:
            self._loss = loss
            if epoch is not None:
                self._epoch = int(epoch)
            if not math.isfinite(loss):
                reasons.append(("diverged", "loss_nonfinite"))
                self._nonfinite_total += 1
                self._inc("veles_model_nonfinite_total", 1,
                          _labels(("layer", "loss")))
                self._loss_z = float("inf")
            else:
                if self._loss_ewma is None:
                    self._loss_ewma = loss
                    self._loss_var = 0.0
                    self._loss_z = 0.0
                else:
                    sigma = math.sqrt(max(self._loss_var, 0.0))
                    # z against the PRE-update baseline: the spike must
                    # not dilute the mean it is judged against
                    dev = loss - self._loss_ewma
                    if sigma > 1e-12:
                        self._loss_z = dev / sigma
                    elif dev > 3.0 * max(abs(self._loss_ewma),
                                         1e-12):
                        # no variance yet (second tick, or a flat
                        # history): the relative-jump test, loss > 4×
                        # the baseline, stands in for the z-score
                        self._loss_z = self.diverged_z
                    else:
                        self._loss_z = 0.0
                    if self._loss_z >= self.diverged_z:
                        reasons.append((
                            "diverged", "loss_spike (z=%.1f)"
                            % self._loss_z))
                    elif self._loss_z >= self.suspect_z:
                        reasons.append((
                            "suspect", "loss_spike (z=%.1f)"
                            % self._loss_z))
                    if self._loss_z < self.diverged_z:
                        # a diverged spike is not folded into the
                        # baseline: it would desensitize later z-scores
                        a = self.ewma_alpha
                        self._loss_ewma += a * dev
                        self._loss_var = (1.0 - a) * (
                            self._loss_var + a * dev * dev)
                self._set("veles_model_loss", loss)
                self._loss_history.append((self._epoch, loss))
                del self._loss_history[:-32]
            z = self._loss_z if math.isfinite(self._loss_z) else 1e9
            self._set("veles_model_loss_zscore", z)
            self._judge(reasons)

    def note_wire_nonfinite(self, layer, count, slave=None):
        """Master side: non-finite values seen in one decoded slave delta
        for ``layer`` (0 = a clean merge, still recorded so the step
        gauge recovers after a poisoned one)."""
        count = int(count)
        now = time.monotonic()
        with self._lock:
            if count:
                self._clean_wire_last = now
                self._nonfinite_total += count
                self._inc("veles_model_nonfinite_total", count,
                          _labels(("layer", layer)))
                self._set("veles_model_nonfinite_step", count)
                self._judge([(
                    "diverged", "nonfinite_wire:%s%s"
                    % (layer, "" if slave is None
                       else " (slave %s)" % slave))])
                return
            # clean merges arrive once per UNIT per update: at most one
            # healthy observation per wire_recovery_interval, so a wide
            # model's frame cannot clear a diverged latch at once
            if self._clean_wire_last is None:
                self._clean_wire_last = now
                return
            if now - self._clean_wire_last \
                    >= self.wire_recovery_interval:
                self._clean_wire_last = now
                self._set("veles_model_nonfinite_step", 0.0)
                self._judge([])

    def absorb_slave(self, summary, slave_id):
        """Master aggregation: republish a slave's model summary
        ``slave="N"``-labelled and fold its health into this process's
        detector (a diverged slave flips the master's verdict)."""
        if not isinstance(summary, dict):
            return
        sid = str(slave_id)
        reasons = []
        with self._lock:
            self._slaves[sid] = dict(summary, seen=round(
                time.time(), 3))
            loss = summary.get("loss")
            if isinstance(loss, (int, float)):
                self._set("veles_model_loss", loss, _labels(("slave", sid)))
            for layer, doc in (summary.get("layers") or {}).items():
                if not isinstance(doc, dict):
                    continue
                for field in ("grad_norm", "weight_norm",
                              "update_ratio"):
                    v = doc.get(field)
                    if isinstance(v, (int, float)):
                        self._set("veles_model_" + field, v, _labels(
                            ("layer", str(layer)), ("slave", sid)))
            if summary.get("verdict") == "diverged":
                reasons.append(
                    ("diverged", "slave_diverged:%s" % sid))
            if reasons:
                self._judge(reasons)
            else:
                # a healthy slave summary is no clean observation of
                # THIS process's model: it must not advance the streak
                self._doc = self._build_doc()

    def observe_serving(self, model, outputs):
        """Serving drift from one dispatched batch's outputs: the mean
        entropy of the (softmaxed) rows and the mean top-1 − top-2
        probability margin. Only 2-D multi-class outputs count; every
        ``serving_stride``-th batch of a model is computed."""
        name = str(model)
        # one worker thread per model's batcher: this unlocked
        # read-modify-write cannot race itself
        tick = self._serving_ticks.get(name, 0)
        self._serving_ticks[name] = tick + 1
        if tick % max(1, int(self.serving_stride)):
            return
        if isinstance(outputs, torch.Tensor):
            outputs = outputs.detach().cpu().numpy()
        out = numpy.asarray(outputs)
        if out.ndim != 2 or out.shape[1] < 2 or not out.shape[0]:
            return
        rows = out.astype(numpy.float64, copy=False)
        rowsum = rows.sum(axis=1, keepdims=True)
        if numpy.any(rows < 0) or not numpy.allclose(
                rowsum, 1.0, atol=1e-3):
            # logits, not a distribution: softmax first
            z = rows - rows.max(axis=1, keepdims=True)
            e = numpy.exp(z)
            rows = e / e.sum(axis=1, keepdims=True)
        ent = float(numpy.mean(
            -(rows * numpy.log(numpy.maximum(rows, 1e-12))).sum(
                axis=1)))
        part = numpy.partition(rows, rows.shape[1] - 2, axis=1)
        margin = float(numpy.mean(part[:, -1] - part[:, -2]))
        with self._lock:
            self._serving[name] = {
                "entropy": round(ent, 6), "top1_margin": round(
                    margin, 6)}
            self._set("veles_serving_logit_entropy", ent,
                      _labels(("model", name)))
            self._set("veles_serving_top1_margin", margin,
                      _labels(("model", name)))
            doc = dict(self._doc)
            doc["serving"] = {k: dict(v)
                              for k, v in self._serving.items()}
            self._doc = doc

    def evict_slave(self, slave_id):
        """A slave departed: drop its absorbed summary and its
        ``slave="N"``-labelled series."""
        sid = str(slave_id)
        match = 'slave="%s"' % sid
        with self._lock:
            if self._slaves.pop(sid, None) is None:
                return
            for series in self._series.values():
                for key in [k for k in series
                            if match in k.split(",")]:
                    del series[key]
            for name in FAMILIES:
                _family(name).remove_children((("slave", sid),))
            self._doc = self._build_doc()

    def note_rollback(self):
        """A divergence rollback restored the last healthy stash: count
        it and drop the diverged latch — the restored weights' clean
        observations re-earn healthy through the streak."""
        with self._lock:
            self._rollbacks += 1
            self._healthy_streak = 0
            if self._verdict == "diverged":
                self._verdict = "suspect"
                self._reasons = ["rolled_back"]
            self._set("veles_model_verdict",
                      VERDICTS.index(self._verdict))
            self._doc = self._build_doc()

    # -- the detector --------------------------------------------------

    def _judge(self, reasons):
        """Fold one observation's ``(severity, reason)`` list into the
        verdict state machine (called under the lock)."""
        if not self.enabled:
            self._updated = time.time()
            self._doc = self._build_doc()
            return
        bad = [r for r in reasons if r[0] == "diverged"]
        sus = [r for r in reasons if r[0] == "suspect"]
        previous = self._verdict
        if bad:
            self._verdict = "diverged"
            self._reasons = [r for _, r in bad]
            self._healthy_streak = 0
        elif sus:
            if self._verdict != "diverged":
                self._verdict = "suspect"
                self._reasons = [r for _, r in sus]
            self._healthy_streak = 0
        else:
            self._healthy_streak += 1
            if self._verdict != "healthy" \
                    and self._healthy_streak >= self.recover_after:
                self._verdict = "healthy"
                self._reasons = []
        if self._verdict != previous:
            telemetry.record_event(
                "model_divergence", verdict=self._verdict,
                previous=previous, reasons=list(self._reasons)[:4])
            log = logger.warning if self._verdict != "healthy" \
                else logger.info
            log("model_divergence: model verdict %s -> %s%s", previous,
                self._verdict, (" (%s)" % "; ".join(self._reasons)
                                if self._reasons else ""))
        self._set("veles_model_verdict", VERDICTS.index(self._verdict))
        self._updated = time.time()
        self._doc = self._build_doc()

    def verdict_state(self):
        """(verdict, reasons) — the cheap cached read."""
        doc = self._doc
        return doc["verdict"], list(doc["reasons"])

    def _loss_trend(self):
        tail = self._loss_history[-6:]
        if len(tail) < 2:
            return "flat"
        first, last = tail[0][1], tail[-1][1]
        span = max(abs(first), abs(last), 1e-12)
        if (first - last) / span > 0.01:
            return "improving"
        if (last - first) / span > 0.01:
            return "worsening"
        return "flat"

    def _build_doc(self):
        z = self._loss_z
        return {
            "verdict": self._verdict,
            "enabled": self.enabled,
            "reasons": list(self._reasons),
            "loss": self._loss,
            "loss_ewma": self._loss_ewma,
            "loss_zscore": (round(z, 3) if math.isfinite(z)
                            else None),
            "loss_trend": self._loss_trend(),
            "epoch": self._epoch,
            "step": self._step,
            "nonfinite_total": self._nonfinite_total,
            "rollbacks": self._rollbacks,
            "layers": {k: dict(v) for k, v in self._layers.items()},
            "slaves": {k: dict(v) for k, v in self._slaves.items()},
            "serving": {k: dict(v)
                        for k, v in self._serving.items()},
            "updated": self._updated,
        }

    # -- read surfaces -------------------------------------------------

    def snapshot(self):
        """The full cached document (the reference's ``/debug/model``)."""
        return self._doc

    def push_summary(self):
        """The compact summary a slave rides on its update frames:
        verdict, loss and the latest stats per layer."""
        doc = self._doc
        return {
            "verdict": doc["verdict"],
            "loss": doc["loss"],
            "loss_zscore": doc["loss_zscore"],
            "epoch": doc["epoch"],
            "step": doc["step"],
            "nonfinite_total": doc["nonfinite_total"],
            "layers": doc["layers"],
        }

    def manifest_stamp(self):
        """What the snapshotter embeds in each checkpoint manifest: the
        verdict plus the stats it was judged on. A disabled plane never
        judged, so it stamps ``unknown``, not ``healthy`` (only
        ``diverged`` is skipped on resume)."""
        doc = self._doc
        return {
            "verdict": doc["verdict"] if self.enabled else "unknown",
            "reasons": doc["reasons"],
            "loss": doc["loss"],
            "loss_zscore": doc["loss_zscore"],
            "epoch": doc["epoch"],
            "nonfinite_total": doc["nonfinite_total"],
            "layers": doc["layers"],
        }

    def register_health(self, monitor=None):
        """Add the ``model:divergence`` readiness check to the health
        plane (``health.py``): not ready while the verdict is diverged
        (suspect keeps serving); -> the health monitor."""
        from veles_torch import health
        monitor = monitor or health.get_monitor()

        def check():
            verdict, reasons = self.verdict_state()
            if verdict == "diverged":
                return False, "model diverged: %s" % (
                    "; ".join(reasons) or "?")
            return True, None
        monitor.add_check("model:divergence", check)
        return monitor


# -- active-monitor plumbing -------------------------------------------

_active_lock = threading.Lock()
_active = None


def get_model_monitor() -> ModelHealthMonitor:
    """The process's active model monitor, created on first use."""
    global _active
    with _active_lock:
        if _active is None:
            _active = ModelHealthMonitor()
        return _active


def set_model_monitor(monitor):
    """Swap the active monitor (-> the previous one)."""
    global _active
    with _active_lock:
        previous = _active
        _active = monitor
    return previous


@contextmanager
def scoped(monitor=None):
    """``with scoped():`` — run under a fresh (or given) monitor,
    restoring the previous one on exit."""
    monitor = monitor if monitor is not None else ModelHealthMonitor()
    previous = set_model_monitor(monitor)
    try:
        yield monitor
    finally:
        set_model_monitor(previous)


def debug_model_doc():
    """The active monitor's cached snapshot, the ``GET /debug/model``
    payload (one attribute read: a handler serves it inline on the
    reactor loop)."""
    return get_model_monitor().snapshot()


# -- SLO wiring ---------------------------------------------------------

#: the divergence objectives for the health plane's burn-rate engine:
#: short windows, so a divergence alerts within a couple of evaluation
#: ticks and clears once clean samples age the bad one out
MODEL_SLOS = (
    {"name": "model_nonfinite", "kind": "threshold",
     "series": "veles_model_nonfinite_step", "op": "<=",
     "threshold": 0.0, "target": 0.99,
     "fast_window": 30.0, "slow_window": 90.0,
     "burn_threshold": 1.0},
    {"name": "model_divergence", "kind": "threshold",
     "series": "veles_model_verdict", "op": "<",
     "threshold": 2.0, "target": 0.99,
     "fast_window": 30.0, "slow_window": 90.0,
     "burn_threshold": 1.0},
    {"name": "model_loss_spike", "kind": "threshold",
     "series": "veles_model_loss_zscore", "op": "<=",
     "threshold": 8.0, "target": 0.99,
     "fast_window": 30.0, "slow_window": 90.0,
     "burn_threshold": 1.0},
)


def install_model_slos(health_monitor=None):
    """Register :data:`MODEL_SLOS` on the health plane (objectives
    already present are skipped); -> how many were added."""
    from veles_torch import health
    monitor = health_monitor or health.get_monitor()
    have = {slo.name for slo in monitor.slos()}
    added = 0
    for spec in MODEL_SLOS:
        if spec["name"] in have:
            continue
        monitor.add_slo(dict(spec))
        added += 1
    return added


# -- master-side rollback actuator --------------------------------------


class WeightGuard:
    """The master-side ``--rollback-on-divergence`` actuator, ticked
    after every merge: while the verdict is healthy it keeps a copy of
    the workflow's params and solver state (every ``stash_interval``
    merges, checked finite so a diverged state never becomes the stash);
    the tick after the verdict flips to ``diverged`` it restores the
    stash. ``server.MasterServer`` ticks it (``--stash-interval``)."""

    def __init__(self, workflow, monitor=None, stash_interval=1):
        self.workflow = workflow
        self._monitor = monitor
        self.stash_interval = max(1, int(stash_interval))
        self._merges = 0
        self._stash = None
        self.rollback_count = 0

    @property
    def monitor(self):
        return self._monitor or get_model_monitor()

    def tick(self):
        """One post-merge evaluation; -> True when a restore
        happened."""
        self._merges += 1
        verdict, reasons = self.monitor.verdict_state()
        if verdict == "diverged":
            return self._restore(reasons)
        if verdict == "healthy" and (
                self._stash is None
                or self._merges % self.stash_interval == 0):
            # HEALTHY only: while suspect a finite blow-up may already
            # be in the weights, and the stash must stay pre-spike
            self._maybe_stash()
        return False

    def _maybe_stash(self):
        stash = self.workflow.stash_state()
        for section in ("params", "state"):
            for uname, tree in stash[section].items():
                for t in tree.values():
                    if not t.is_floating_point():
                        continue
                    bad = int((~torch.isfinite(t)).sum())
                    if bad:
                        # a blow-up the wire scan missed: feed the
                        # detector instead of stashing poison
                        self.monitor.note_wire_nonfinite(uname, bad)
                        return
        self._stash = stash

    def _restore(self, reasons):
        if self._stash is None:
            logger.warning("model diverged (%s) before any healthy "
                           "stash existed — nothing to restore",
                           "; ".join(reasons) or "?")
            self.monitor.note_rollback()
            return False
        self.workflow.restore_stash(self._stash)
        self.rollback_count += 1
        self.monitor.note_rollback()
        telemetry.record_event(
            "model_rollback", source="weight_guard",
            rollback=self.rollback_count, reasons=list(reasons)[:4])
        logger.warning(
            "model_rollback: model diverged (%s): restored last healthy "
            "weights (rollback #%d)", "; ".join(reasons) or "?",
            self.rollback_count)
        return True
