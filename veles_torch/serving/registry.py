"""Model registry of the port's serving plane: named models, versions,
hot reload, checkpoint refresh.

Counterpart of ``veles/serving/registry.py``. Each registered model is a
:class:`ServedModel` wiring one :class:`ArchiveModel` (an
``export_inference`` archive, either package's) into an
:class:`InferenceEngine` and a :class:`MicroBatcher`, on the registry's
device: ``cuda`` unless ``cpu`` is asked for (``backend="numpy"`` is the
CPU too, as the reference's host oracle is). A ``cuda`` registry on a
host without a card raises; nothing moves a model to the CPU.

A model may be refreshed from a checkpoint, a local file or an
``http(s)://`` URI (``snapshotter.HTTPSnapshotStore``).
:meth:`ModelRegistry.load` of a loaded name with an unchanged
architecture signature swaps the params in place under a bumped version:
the engine keeps its warm buckets and the batcher keeps running.
:meth:`ModelRegistry.refresh_newest` scans the model's store for the
newest healthy checkpoint, skipping (and counting) diverged ones; a
failing reload or refresh degrades (counted, logged) and the loaded
version keeps serving. :meth:`ModelRegistry.decoder` builds the
generative plane (``GenerativeEngine`` + ``ContinuousBatcher``) on the
first ``/v1/generate``.

Gauges: ``veles_serving_model_version``,
``veles_serving_checkpoint_wall_seconds``,
``veles_serving_checkpoint_ingest_wall_seconds`` and
``veles_serving_forward_cache_bytes``, labelled by model, evaluated at
scrape time; ``veles_serving_refresh_failures_total`` counts degraded
refreshes.
"""

import os
import threading
import time

from veles_torch import snapshotter, telemetry
from veles_torch.backends import torch_device
from veles_torch.logger import Logger
from veles_torch.serving.batcher import MicroBatcher
from veles_torch.serving.decode import (
    ContinuousBatcher, DecodePlan, GenerativeEngine)
from veles_torch.serving.engine import InferenceEngine
from veles_torch.serving.model import ArchiveModel
from veles_torch.serving.quant import tree_nbytes, validate_mode

_C_REFRESH_FAILURES = telemetry.LazyChild(lambda: telemetry.counter(
    "veles_serving_refresh_failures_total",
    "Hot reloads that failed and degraded to the loaded version",
    ("model",)))

#: the executors ``--backend`` names
BACKENDS = ("auto", "jit", "numpy")


def store_of(checkpoint):
    """The store location a checkpoint path or URI lives in."""
    ckpt = str(checkpoint)
    if snapshotter.is_http(ckpt):
        return ckpt.rsplit("/", 1)[0]
    return os.path.dirname(ckpt) or "."


class ServedModel:
    """One registry entry: model + engine + batcher + metadata."""

    def __init__(self, name, model, engine, batcher, source,
                 checkpoint=None, refresh_store=None):
        self.name = name
        self.model = model
        self.engine = engine
        self.batcher = batcher
        self.source = source
        self.checkpoint = checkpoint
        #: the store (directory or http base) refresh_newest scans;
        #: the loaded checkpoint's own store when unset
        self.refresh_store = refresh_store
        self.version = 1
        self.loaded_at = time.time()
        #: the decode plane, built on the first /v1/generate
        self.decoder = None
        self._decoder_lock = threading.Lock()
        self._closed = False
        #: False only while a requested warmup runs the bucket ladder
        self.warm = True

    def predict(self, rows, timeout_ms=None, trace=None, tenant=None):
        return self.batcher.predict(rows, timeout_ms=timeout_ms,
                                    trace=trace, tenant=tenant)

    def cache_bytes(self):
        """An estimate of the bytes this entry's forward holds: the
        params (once on the model's device, once more when the engine
        holds its own copy elsewhere), an input and an output buffer per
        warm bucket, and the decode plane's KV pool."""
        params = tree_nbytes(self.model.params)
        total = params * (1 if self.engine.device == self.model.device
                          else 2)
        sample = self.model.input_sample_shape
        if sample:
            row = 4
            for d in sample:
                row *= int(d)
            total += sum(b * row * 2 for b in self.engine.compiled_buckets)
        decoder = self.decoder
        if decoder is not None:
            total += decoder.engine.pool.nbytes()
        return total

    def describe(self):
        doc = {
            "name": self.name,
            "version": self.version,
            "workflow": self.model.workflow_name,
            "source": self.source,
            "checkpoint": self.checkpoint,
            "input_sample_shape": self.model.input_sample_shape,
            "units": [s["type"] for s in self.model.units],
            "backend": "torch:%s" % self.engine.device.type,
            "quantize": self.engine.quantize,
            "compiled_buckets": self.engine.compiled_buckets,
            "loaded_at": self.loaded_at,
            "generative": DecodePlan.probe(self.model),
        }
        decoder = self.decoder
        if decoder is not None:
            doc["decode"] = {
                "kv_pool_slots": decoder.engine.pool.n_slots,
                "max_len": decoder.engine.max_len,
            }
        return doc

    def close(self, zero_gauge=True):
        """Stop the batcher and the decode plane. ``zero_gauge=False``
        is the hot-reload path (see ``MicroBatcher.close``). The decoder
        is taken under its lock, so an unload racing a first
        /v1/generate never leaks a decode plane."""
        with self._decoder_lock:
            self._closed = True
            decoder = self.decoder
            self.decoder = None
        if decoder is not None:
            decoder.close()
        self.batcher.close(zero_gauge=zero_gauge)


class ModelRegistry(Logger):
    """Thread-safe name -> :class:`ServedModel` map on one device."""

    def __init__(self, backend="auto", max_batch=64, max_queue=256,
                 max_wait_ms=2.0, default_timeout_ms=1000.0,
                 decode_slots=8, decode_max_len=256,
                 decode_max_queue=64, quantize_weights="none",
                 device="cuda"):
        self.name = "registry"
        if backend not in BACKENDS:
            raise ValueError("backend must be auto|jit|numpy, got %r"
                             % (backend,))
        self.backend = backend
        #: ``numpy`` is the reference's host executor: the CPU here
        self.device = torch_device("cpu" if backend == "numpy"
                                   else device)
        validate_mode(quantize_weights, "quantize_weights")
        self.quantize_weights = quantize_weights
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_wait_ms = float(max_wait_ms)
        self.default_timeout_ms = float(default_timeout_ms)
        self.decode_slots = int(decode_slots)
        self.decode_max_len = int(decode_max_len)
        self.decode_max_queue = int(decode_max_queue)
        self._lock = threading.Lock()
        self._models = {}
        #: per-model count of failed hot reloads (the loaded version
        #: keeps serving)
        self._refresh_failures = {}

    # -- lifecycle -----------------------------------------------------

    def load(self, name, source, checkpoint=None, warmup=False,
             refresh_store=None):
        """Load (or replace) model ``name`` from archive directory
        ``source``; optionally refresh its params from ``checkpoint``
        and run the bucket ladder once. ``refresh_store`` is the store
        :meth:`refresh_newest` polls."""
        model = ArchiveModel.from_dir(source, device=self.device)
        if checkpoint:
            model.load_checkpoint(checkpoint)
        with self._lock:
            old = self._models.get(name)
            if old is not None and \
                    old.model.signature() == model.signature():
                # same architecture: swap the params, keep the warm
                # buckets and the running batcher
                old.model = model
                old.engine.set_model(model, params_only=True)
                if old.decoder is not None:
                    old.decoder.engine.set_params(model)
                old.source = source
                old.checkpoint = checkpoint
                if refresh_store:
                    old.refresh_store = refresh_store
                old.version += 1
                old.loaded_at = time.time()
                self._version_gauge(name).set(old.version)
                self.info("model %s reloaded in place -> v%d", name,
                          old.version)
                return old
            engine = InferenceEngine(model, max_batch=self.max_batch,
                                     quantize=self.quantize_weights,
                                     device=self.device)
            batcher = MicroBatcher(
                engine.predict, max_batch=self.max_batch,
                max_queue=self.max_queue, max_wait_ms=self.max_wait_ms,
                default_timeout_ms=self.default_timeout_ms,
                name="batcher-%s" % name, model=name)
            entry = ServedModel(name, model, engine, batcher, source,
                                checkpoint, refresh_store=refresh_store)
            if old is not None:
                entry.version = old.version + 1
                if refresh_store is None:
                    entry.refresh_store = old.refresh_store
            self._models[name] = entry
        self._version_gauge(name).set(entry.version)
        self._checkpoint_gauges(name)
        telemetry.gauge(
            "veles_serving_forward_cache_bytes",
            "Estimated bytes held by the model's forward cache (params + "
            "bucket buffers + KV pool)", ("model",)).labels(
                name).set_function(
                    lambda n=name: self._entry_cache_bytes(n))
        if old is not None:
            # outside the lock: draining the old batcher and decode
            # plane can take seconds; the new batcher owns the gauge
            old.close(zero_gauge=False)
        if warmup:
            entry.warm = False
            try:
                entry.engine.warmup()
            finally:
                entry.warm = True
        self.info("model %s v%d loaded from %s (%d units, %s)", name,
                  entry.version, source, len(model.units),
                  self.device)
        return entry

    def _count_refresh_failure(self, name):
        with self._lock:
            self._refresh_failures[name] = \
                self._refresh_failures.get(name, 0) + 1
            n = self._refresh_failures[name]
        _C_REFRESH_FAILURES.get().labels(name).inc()
        return n

    def reload(self, name):
        """Hot reload from the entry's recorded source and checkpoint. A
        failure (a store down or fast-failed by its breaker, a
        half-written archive) is counted and the current entry keeps
        serving; -> the entry that serves."""
        entry = self.get(name)
        try:
            return self.load(name, entry.source,
                             checkpoint=entry.checkpoint)
        except Exception as exc:
            n = self._count_refresh_failure(name)
            telemetry.record_event("reload_failed", model=name,
                                   error=str(exc))
            self.warning("hot reload of %s failed (%s: %s; failure #%d) "
                         "— still serving v%d", name, type(exc).__name__,
                         exc, n, entry.version)
            return entry

    def refresh_newest(self, name, store_target=None):
        """The refresh poll: load the newest healthy checkpoint of the
        model's store when it is newer than the served one. A diverged
        checkpoint on the way is skipped with its name in the log, a
        ``refresh_skipped_diverged`` event and a count in
        ``veles_checkpoint_diverged_skips_total``; store and load
        failures degrade like :meth:`reload`. -> the loaded checkpoint,
        or None."""
        entry = self.get(name)
        target = store_target or entry.refresh_store
        if target is None and entry.checkpoint:
            target = store_of(entry.checkpoint)
        if not target:
            raise ValueError(
                "model %r has no snapshot store to refresh from (pass "
                "store_target or load with refresh_store=)" % name)
        served_wall = entry.model.checkpoint_meta.get("wall_time")
        try:
            infos = snapshotter.scan_checkpoints(target)
        except Exception as exc:
            self._count_refresh_failure(name)
            self.warning("refresh poll of %s: store scan of %s failed "
                         "(%s: %s) — still serving v%d", name, target,
                         type(exc).__name__, exc, entry.version)
            return None
        for info in infos:
            if info.status != "valid":
                continue
            if info.wall_time is not None and served_wall \
                    and info.wall_time <= float(served_wall):
                break               # nothing newer than what we serve
            if info.health_verdict == "diverged":
                snapshotter.COUNTERS.count_diverged_skip()
                telemetry.record_event("refresh_skipped_diverged",
                                       model=name, checkpoint=info.name)
                self.warning("refresh poll of %s SKIPPED diverged "
                             "checkpoint %s — still serving v%d", name,
                             info.name, entry.version)
                continue
            path = ("%s/%s" % (str(target).rstrip("/"), info.name)
                    if snapshotter.is_http(target)
                    else os.path.join(str(target), info.name))
            try:
                self.load(name, entry.source, checkpoint=path,
                          refresh_store=target)
            except Exception as exc:
                self._count_refresh_failure(name)
                telemetry.record_event("reload_failed", model=name,
                                       error=str(exc))
                self.warning("refresh of %s from %s failed (%s: %s) — "
                             "still serving v%d", name, path,
                             type(exc).__name__, exc, entry.version)
                return None
            telemetry.record_event("refresh_loaded", model=name,
                                   checkpoint=info.name,
                                   wall_time=info.wall_time)
            return path
        return None

    def _checkpoint_gauges(self, name):
        """Scrape-time gauges over the served checkpoint's manifest: its
        wall times and the model's staleness point
        (``veles_staleness_seconds{point="serving:<model>"}``,
        ``continual.py``)."""
        from veles_torch.continual import install_point_gauge
        telemetry.gauge(
            "veles_serving_checkpoint_wall_seconds",
            "MANIFEST wall time of the served checkpoint (0 = serving "
            "the export archive, no checkpoint loaded)",
            ("model",)).labels(name).set_function(
                lambda n=name: self._ckpt_meta(n, "wall_time"))
        telemetry.gauge(
            "veles_serving_checkpoint_ingest_wall_seconds",
            "MANIFEST ingest_wall of the served checkpoint (0 = no "
            "continual stamp)", ("model",)).labels(name).set_function(
                lambda n=name: self._ckpt_meta(n, "ingest_wall"))
        install_point_gauge(
            "serving:%s" % name,
            lambda n=name: self._ckpt_meta(n, "ingest_wall") or None)

    def _ckpt_meta(self, name, key):
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            return 0.0
        try:
            return float(entry.model.checkpoint_meta.get(key))
        except (TypeError, ValueError):
            return 0.0

    def unload(self, name):
        with self._lock:
            entry = self._models.pop(name)
            self._refresh_failures.pop(name, None)
        entry.close()

    def close(self):
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
        for entry in entries:
            entry.close()

    def _entry_cache_bytes(self, name):
        with self._lock:
            entry = self._models.get(name)
        return entry.cache_bytes() if entry is not None else 0

    @staticmethod
    def _version_gauge(name):
        return telemetry.gauge(
            "veles_serving_model_version",
            "Currently served model version", ("model",)).labels(name)

    # -- refresh-target admission --------------------------------------

    @staticmethod
    def _within_store(root, target):
        """Whether ``target`` stays inside ``root`` (a URL prefix for an
        http store, a normalized path prefix for a directory)."""
        if snapshotter.is_http(root):
            root = root.rstrip("/")
            return target == root or target.startswith(root + "/")
        root_abs = os.path.normpath(os.path.abspath(root))
        t_abs = os.path.normpath(os.path.abspath(target))
        return t_abs == root_abs or t_abs.startswith(root_abs + os.sep)

    def resolve_refresh_target(self, entry, checkpoint=None, store=None):
        """The admission bound of client-named refresh targets: a path a
        ``POST .../refresh`` body names must stay inside a store the
        entry was configured with (its ``refresh_store``, its checkpoint's
        store, its archive source). -> ``(checkpoint, store)`` (None where
        absent); ValueError for anything outside."""
        roots = []
        if entry.refresh_store:
            roots.append(str(entry.refresh_store))
        if entry.checkpoint:
            roots.append(store_of(entry.checkpoint))
        if entry.source:
            roots.append(str(entry.source))
        admitted = []
        for target in (checkpoint, store):
            if target is None or target == "":
                admitted.append(None)
                continue
            if not isinstance(target, str):
                raise ValueError("refresh target must be a string path, "
                                 "got %s" % type(target).__name__)
            if not any(self._within_store(root, target) for root in roots):
                raise ValueError(
                    "refresh target %r is outside the model's configured "
                    "stores — load the entry with refresh_store= to allow "
                    "a new location" % target)
            admitted.append(target)
        return tuple(admitted)

    # -- lookup --------------------------------------------------------

    def get(self, name):
        with self._lock:
            try:
                return self._models[name]
            except KeyError:
                raise KeyError("no model %r (serving: %s)"
                               % (name, sorted(self._models) or "none"))

    def names(self):
        with self._lock:
            return sorted(self._models)

    def decoder(self, name):
        """The model's continuous-batching decode plane, built on first
        use. KeyError for an unknown name, ValueError for an archive
        that cannot generate."""
        entry = self.get(name)
        decoder = entry.decoder
        if decoder is not None:
            return decoder
        with entry._decoder_lock:
            if entry._closed:
                raise KeyError("model %r was unloaded" % name)
            if entry.decoder is None:
                engine = GenerativeEngine(
                    entry.model, n_slots=self.decode_slots,
                    max_len=self.decode_max_len, device=self.device)
                entry.decoder = ContinuousBatcher(
                    engine, max_queue=self.decode_max_queue,
                    name="decode-%s" % name, model=name)
                self.info("decode plane for %s: %d KV slots x %d tokens "
                          "(%.1f MB pool)", name, engine.pool.n_slots,
                          engine.max_len, engine.pool.nbytes() / 1048576.0)
            return entry.decoder

    def describe(self):
        with self._lock:
            entries = list(self._models.values())
        return [e.describe() for e in entries]

    def metrics(self):
        with self._lock:
            entries = list(self._models.items())
            failures = dict(self._refresh_failures)
        out = {}
        for name, e in entries:
            m = dict(e.batcher.metrics(), version=e.version,
                     compiled_buckets=e.engine.compiled_buckets,
                     refresh_failures=failures.get(name, 0))
            store = self.checkpoint_store(e.checkpoint)
            if store is not None:
                m["checkpoint_store"] = store.metrics()
            decoder = e.decoder
            if decoder is not None:
                m["decode"] = decoder.metrics()
            out[name] = m
        return out

    @staticmethod
    def checkpoint_store(checkpoint):
        """The HTTP store a checkpoint URI lives in (None for a file)."""
        if not checkpoint or not snapshotter.is_http(checkpoint):
            return None
        return snapshotter.store_for(str(checkpoint))[0]
