"""Checkpoints of the PyTorch port, in the reference's format.

The port's own copy of ``veles/snapshotter.py`` (it imports nothing of
the JAX package). A checkpoint is a structured state tree (weights,
solver state, decision, loader, rollback, lr scales, meta, other units'
state) written as one npz whose layout is the reference's:

* every array under its slash-joined tree path (``params/All2AllTanh/
  weights``); torch tensors come to host numpy first, bf16 ones as f32;
* the JSON-able leaves under ``__json__`` (uint8 bytes of one JSON
  object keyed by path);
* the integrity manifest under ``__manifest__``: schema version, wall
  time, slot, config hash and a sha256 per array over dtype + shape +
  bytes, plus the ``model_health`` stamp: the model-health monitor's
  verdict and the stats it was judged on (``unknown`` while the plane is
  off, ``--model-stats off``), and in a continual run ``ingest_wall``
  (``continual.py``; :func:`health_stamp_meta`).

So a blob written by either package verifies and loads in the other.
Compression is ``""``, ``gz``, ``bz2`` or ``xz``, read from the name's
suffix. :func:`parse_checkpoint` verifies on read and raises
:class:`CorruptCheckpointError` on a truncated, bit-flipped or
otherwise unreadable blob.

The durability layer is the reference's: :class:`FileSnapshotStore`
commits by fsync'd write-then-rename; :class:`RollingSlot` names and
prunes the rolling ``current`` checkpoints and rebuilds itself from
``store.list()``; :func:`scan_checkpoints` audits a store and
:func:`resolve_auto` (``--snapshot auto``) picks the newest checkpoint
that verifies, past corrupt ones, skipping ``diverged`` manifests and,
with ``prefixes``, another workflow's names. The read side never creates
a store (``create=False``). :class:`Snapshotter` is the writer a workflow
links: improvement-gated ``<prefix>_=<metric>`` snapshots (``initial``
before any metric), rolling ``current`` ones on a wall-clock
``interval``, each slot with its own retention rebuilt from the store, a
three-strike failure budget, and :meth:`Snapshotter.preempt_snapshot`.

An ``http(s)://`` location is an :class:`HTTPSnapshotStore` (``PUT/GET/
DELETE <base>/<name>``, ``GET <base>/`` -> a JSON name list) with the
reference's retries, backoff and circuit breaker, one per base URL
(:func:`store_for`, :func:`store_for_base`), so ``--snapshot``,
``--snapshots``, ``scan_checkpoints`` and the serving registry's refresh
take an HTTP URI. The reference's ``veles_checkpoint_*`` series live on
the port's telemetry registry (``telemetry.py``), each write is a
``checkpoint_written`` flight-recorder event, and :data:`COUNTERS`
keeps the process's plain view, ``COUNTERS.metrics()``.
"""

import bz2
import gzip
import hashlib
import io
import json
import logging
import lzma
import os
import re
import threading
import time

import numpy
import torch
import torch.distributed as dist

from veles_torch import model_health, telemetry
from veles_torch.config import root

logger = logging.getLogger("veles_torch.snapshotter")

_OPENERS = {"": open, "gz": gzip.open, "bz2": bz2.open, "xz": lzma.open}

#: bump when the checkpoint tree layout changes incompatibly
SCHEMA_VERSION = 1

#: npz entry holding the integrity manifest (JSON as uint8 bytes)
MANIFEST_KEY = "__manifest__"

class CorruptCheckpointError(Exception):
    """The checkpoint failed verification (unreadable container, digest
    mismatch, missing or extra array), or it does not fit the workflow it
    is restored into (a shape or key it lacks). Never resume it."""


_WRITE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
                  60.0)


class CheckpointCounters:
    """The process's checkpoint counters: each record also lands on the
    telemetry registry under the reference's ``veles_checkpoint_*``
    families; the attributes are the plain view :meth:`metrics` reads."""

    def __init__(self):
        self.writes_by_slot = {}
        self.bytes_total = 0
        self.write_seconds = []
        self.verify_failures = 0
        self.diverged_skips = 0
        self.last_success = None

    def record_write(self, slot, nbytes, seconds):
        self.writes_by_slot[slot] = self.writes_by_slot.get(slot, 0) + 1
        self.bytes_total += int(nbytes)
        self.write_seconds.append(float(seconds))
        self.last_success = time.time()
        telemetry.counter(
            "veles_checkpoint_writes_total",
            "Checkpoints committed to the store, by retention slot",
            ("slot",)).labels(slot).inc()
        telemetry.counter(
            "veles_checkpoint_bytes_total",
            "Bytes committed to the snapshot store").inc(nbytes)
        telemetry.histogram(
            "veles_checkpoint_write_seconds",
            "Wall time of one checkpoint serialize+commit", ("slot",),
            buckets=_WRITE_BUCKETS).labels(slot).observe(seconds)
        telemetry.gauge(
            "veles_checkpoint_last_success_age_seconds",
            "Seconds since a checkpoint last committed (-1: never)"
        ).set_function(self.last_success_age)

    def count_verify_failure(self):
        self.verify_failures += 1
        telemetry.counter(
            "veles_checkpoint_verify_failures_total",
            "Corrupt checkpoints observed (once per blob per store "
            "scan)").inc()

    def count_diverged_skip(self):
        self.diverged_skips += 1
        telemetry.counter(
            "veles_checkpoint_diverged_skips_total",
            "Checkpoints skipped by auto-resume/refresh because their "
            "MANIFEST carries model-health verdict 'diverged'").inc()

    def last_success_age(self):
        return -1.0 if self.last_success is None \
            else max(0.0, time.time() - self.last_success)

    def metrics(self):
        """{writes_by_slot, bytes_total, write_seconds, verify_failures,
        diverged_skips, last_success_age_seconds (-1: never)}."""
        age = self.last_success_age()
        return {"writes_by_slot": dict(self.writes_by_slot),
                "bytes_total": self.bytes_total,
                "write_seconds": list(self.write_seconds),
                "verify_failures": self.verify_failures,
                "diverged_skips": self.diverged_skips,
                "last_success_age_seconds": age}


#: the process's checkpoint counters (every writer and reader shares them,
#: as the reference's telemetry registry is process-wide)
COUNTERS = CheckpointCounters()


# -- stores ----------------------------------------------------------------


class _BufferedStream:
    """The default ``SnapshotStore.stream``: buffer, then one ``put`` on a
    clean exit (a remote store takes whole blobs); ``.uri`` after."""

    def __init__(self, store, name):
        self.store = store
        self.name = name
        self.uri = None

    def __enter__(self):
        self.buf = io.BytesIO()
        return self.buf

    def __exit__(self, et, ev, tb):
        if et is None:
            self.uri = self.store.put(self.name, self.buf.getvalue())
        return False


class _FileStream:
    """Write through to ``<name>.tmp``; on a clean exit fsync, rename
    over ``name`` and fsync the directory; otherwise remove the tmp."""

    def __init__(self, store, name):
        self.path = os.path.join(store.directory, name)
        self.uri = None

    def __enter__(self):
        self._f = open(self.path + ".tmp", "wb")
        return self._f

    def __exit__(self, et, ev, tb):
        committed = False
        try:
            try:
                if et is None:
                    # fsync BEFORE the rename: an unsynced rename can
                    # commit a zero-length checkpoint on power loss
                    self._f.flush()
                    os.fsync(self._f.fileno())
            finally:
                self._f.close()
            if et is None:
                os.replace(self.path + ".tmp", self.path)
                self._fsync_dir()
                self.uri = self.path
                committed = True
        finally:
            if not committed:
                try:
                    os.remove(self.path + ".tmp")
                except OSError:
                    pass
        return False

    def _fsync_dir(self):
        try:
            fd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)


class SnapshotStore:
    """Byte-blob store contract: flat names, opaque payloads."""

    def put(self, name, data):
        """Store ``data`` under ``name``; -> a resolvable path."""
        raise NotImplementedError

    def stream(self, name):
        """A context manager yielding a writable binary file whose
        contents commit to ``name`` on a clean exit (``.uri`` after);
        by default buffered and ``put``."""
        return _BufferedStream(self, name)

    def get(self, name):
        """-> the bytes under ``name`` (KeyError if absent)."""
        raise NotImplementedError

    def list(self):
        """-> sorted checkpoint names."""
        raise NotImplementedError

    def delete(self, name):
        """Remove ``name``; a missing name is ignored."""
        raise NotImplementedError


class FileSnapshotStore(SnapshotStore):
    """A local directory (created if missing)."""

    def __init__(self, directory):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def put(self, name, data):
        with self.stream(name) as f:
            f.write(data)
        return os.path.join(self.directory, name)

    def stream(self, name):
        return _FileStream(self, name)

    def get(self, name):
        # open directly: a blob pruned by a concurrent writer's retention
        # is a KeyError (raced retention), not a FileNotFoundError
        try:
            with open(os.path.join(self.directory, name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(name)

    def list(self):
        # in-flight or orphaned .tmp writes are never checkpoints
        return sorted(n for n in os.listdir(self.directory)
                      if ".ckpt." in n and not n.endswith(".tmp"))

    def delete(self, name):
        try:
            os.remove(os.path.join(self.directory, name))
        except OSError:
            pass


class CircuitOpenError(ConnectionError):
    """The HTTP store's circuit breaker is open: recent requests all
    failed, so callers fail fast instead of stacking timeouts against a
    dead endpoint. Retry after the breaker's reset window."""


class HTTPSnapshotStore(SnapshotStore):
    """A REST-style remote store: ``PUT/GET/DELETE <base>/<name>``, ``GET
    <base>/`` -> a JSON name list (an object store behind a signer, a
    WebDAV location, or the stdlib server of the tests), over urllib.

    Degradation policy: transport errors and 5xx answers retry
    ``retries`` times with exponential backoff; ``breaker_threshold``
    consecutive failed requests open a circuit breaker that fails every
    call at once (:class:`CircuitOpenError`) for ``breaker_reset``
    seconds, after which one probe request is let through (half-open):
    success closes the breaker, failure opens it again. :meth:`metrics`
    reports the counters."""

    def __init__(self, base_url, timeout=60, retries=2,
                 retry_backoff=0.1, breaker_threshold=4,
                 breaker_reset=30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.retry_backoff = float(retry_backoff)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset = float(breaker_reset)
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._breaker_open_until = 0.0
        self._probe_in_flight = False
        self.stats = {"requests": 0, "retries": 0, "failures": 0,
                      "breaker_trips": 0, "breaker_fast_fails": 0}

    # -- breaker bookkeeping -------------------------------------------

    def _gate(self):
        with self._lock:
            self.stats["requests"] += 1
            if not self._breaker_open_until:
                return
            now = time.monotonic()
            # half-open admits ONE probe; concurrent callers keep failing
            # fast instead of stacking their retry ladders
            if now < self._breaker_open_until or self._probe_in_flight:
                self.stats["breaker_fast_fails"] += 1
                raise CircuitOpenError(
                    "snapshot store %s: circuit open after %d consecutive "
                    "failures (retry in %.1fs)"
                    % (self.base_url, self._consecutive_failures,
                       max(0.0, self._breaker_open_until - now)))
            self._probe_in_flight = True

    def _record(self, ok):
        with self._lock:
            self._probe_in_flight = False
            if ok:
                self._consecutive_failures = 0
                self._breaker_open_until = 0.0
                return
            self._consecutive_failures += 1
            self.stats["failures"] += 1
            if self._consecutive_failures >= self.breaker_threshold:
                self._breaker_open_until = \
                    time.monotonic() + self.breaker_reset
                self.stats["breaker_trips"] += 1

    def breaker_open(self):
        with self._lock:
            return time.monotonic() < self._breaker_open_until

    def metrics(self):
        with self._lock:
            return dict(
                self.stats, base_url=self.base_url,
                consecutive_failures=self._consecutive_failures,
                breaker_open=time.monotonic() < self._breaker_open_until)

    def _request(self, method, name="", data=None):
        """One logical request -> the whole response body. The body is
        read inside the retry and breaker accounting: a connection that
        dies mid-body retries and counts like any transport failure."""
        import http.client
        import urllib.error
        import urllib.request
        self._gate()
        url = self.base_url + "/" + name
        last = None
        for attempt in range(self.retries + 1):
            req = urllib.request.Request(url, data=data, method=method)
            if data is not None:
                req.add_header("Content-Type", "application/octet-stream")
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    body = resp.read()
                self._record(ok=True)
                return body
            except urllib.error.HTTPError as exc:
                if exc.code < 500:
                    # the endpoint answered (404 etc.): not a store-health
                    # event, the caller maps the code
                    self._record(ok=True)
                    raise
                last = exc              # 5xx: a flapping backend
            except (urllib.error.URLError, OSError,
                    http.client.HTTPException) as exc:
                last = exc
            if attempt < self.retries:
                with self._lock:
                    self.stats["retries"] += 1
                time.sleep(self.retry_backoff * (2 ** attempt))
        self._record(ok=False)
        raise last

    def put(self, name, data):
        self._request("PUT", name, data)
        return self.base_url + "/" + name

    def get(self, name):
        import urllib.error
        try:
            return self._request("GET", name)
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise KeyError(name) from None
            raise

    def list(self):
        """``GET <base>/`` -> the JSON array, names relative to the base
        or full object paths (both accepted), filtered to ``.ckpt.``
        blobs as :meth:`FileSnapshotStore.list` does; names under
        another prefix of the same bucket are never ours."""
        from urllib.parse import urlsplit
        names = json.loads(self._request("GET").decode())
        prefix = urlsplit(self.base_url).path.lstrip("/")
        out = []
        for n in names:
            if "://" in n:
                n = urlsplit(n).path
            n = n.lstrip("/")
            if prefix and n.startswith(prefix + "/"):
                n = n[len(prefix) + 1:]
            if "/" in n:
                continue
            if ".ckpt." in n and not n.endswith(".tmp"):
                out.append(n)
        if names and not out:
            logger.warning("%s/: all %d listed names filtered out (first: "
                           "%r) — no checkpoints visible", self.base_url,
                           len(names), names[0])
        return sorted(out)

    def delete(self, name):
        import urllib.error
        try:
            self._request("DELETE", name)
        except urllib.error.HTTPError as exc:
            if exc.code != 404:
                raise


#: one HTTPSnapshotStore per base URL: every reader and writer of an
#: endpoint shares its circuit breaker
_STORE_CACHE = {}
_STORE_CACHE_LOCK = threading.Lock()


def _cached_http_store(base):
    with _STORE_CACHE_LOCK:
        store = _STORE_CACHE.get(base)
        if store is None:
            store = _STORE_CACHE[base] = HTTPSnapshotStore(base)
    return store


def is_http(target):
    return str(target).startswith(("http://", "https://"))


def store_for(target):
    """(store, name) of one blob TARGET: an http(s) URI maps to (the
    cached :class:`HTTPSnapshotStore` of its base, name), a local path to
    (None, path)."""
    if is_http(target):
        base, _, name = target.rpartition("/")
        return _cached_http_store(base), name
    return None, target


def store_for_base(target, create=True):
    """A :class:`SnapshotStore` over a checkpoint LOCATION: an
    ``http(s)://`` base URL (the cached store of :func:`store_for`) or a
    directory. ``create=False`` is the read side (auto-resume, audit): a
    missing directory raises FileNotFoundError instead of being created
    and read as an empty store."""
    if isinstance(target, SnapshotStore):
        return target
    if is_http(target):
        return _cached_http_store(target.rstrip("/"))
    if not create and not os.path.isdir(target):
        raise FileNotFoundError(
            "snapshot store directory %r does not exist — resuming or "
            "auditing a store never creates it (check the path, or mkdir "
            "it first)" % (target,))
    return FileSnapshotStore(target)


# -- the format ------------------------------------------------------------


def config_fingerprint():
    """sha256 over the effective ``root`` config (sorted keys), stamped
    into every manifest; a mismatch on resume is warned, not fatal."""
    try:
        blob = json.dumps(root.to_dict(), sort_keys=True, default=str)
    except (TypeError, ValueError):
        return None
    return hashlib.sha256(blob.encode()).hexdigest()


def _array_digest(arr):
    arr = numpy.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def host_copy(value):
    """A tensor (bf16 as f32: numpy has no bf16) or array -> a numpy
    copy on the host."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        if value.device.type != "cpu":
            return value.cpu().numpy()
        value = value.numpy()
    return numpy.array(value)


def _flatten_tree(tree, prefix=""):
    """Nested dicts -> {slash/path: ndarray}; JSON-able leaves ride
    under ``__json__``."""
    flat = {}
    meta = {}

    def rec(node, path):
        for key, value in node.items():
            sub = "%s/%s" % (path, key) if path else str(key)
            if isinstance(value, dict):
                rec(value, sub)
            elif isinstance(value, (numpy.ndarray, numpy.generic,
                                    torch.Tensor)):
                flat[sub] = host_copy(value)
            elif isinstance(value, (int, float, bool, str, type(None),
                                    list, tuple)):
                meta[sub] = value
            else:
                flat[sub] = numpy.asarray(value)

    rec(tree, prefix)
    flat["__json__"] = numpy.frombuffer(json.dumps(meta).encode(),
                                        dtype=numpy.uint8)
    return flat


def _unflatten_tree(flat):
    meta = {}
    if "__json__" in flat:
        meta = json.loads(bytes(flat.pop("__json__")).decode())
    tree = {}

    def insert(path, value):
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for key, value in flat.items():
        insert(key, value)
    for key, value in meta.items():
        insert(key, value)
    return tree


def dump_checkpoint(tree, slot="best", extra_meta=None):
    """State tree -> UNCOMPRESSED npz bytes with its manifest."""
    flat = _flatten_tree(tree)
    manifest = {
        "schema": SCHEMA_VERSION,
        "wall_time": time.time(),
        "slot": slot,
        "config_hash": config_fingerprint(),
        "arrays": {k: _array_digest(v) for k, v in flat.items()},
    }
    if extra_meta:
        manifest.update(extra_meta)
    flat[MANIFEST_KEY] = numpy.frombuffer(json.dumps(manifest).encode(),
                                          dtype=numpy.uint8)
    blob = io.BytesIO()
    numpy.savez(blob, **flat)
    return blob.getvalue()


def _verify_flat(flat, manifest, name):
    digests = manifest.get("arrays")
    if not isinstance(digests, dict):
        raise CorruptCheckpointError(
            "%s: manifest carries no array digests" % name)
    if set(digests) != set(flat):
        raise CorruptCheckpointError(
            "%s: manifest names %d arrays, payload has %d (missing: %s / "
            "extra: %s)" % (name, len(digests), len(flat),
                            sorted(set(digests) - set(flat))[:3],
                            sorted(set(flat) - set(digests))[:3]))
    for key, digest in digests.items():
        if _array_digest(flat[key]) != digest:
            raise CorruptCheckpointError(
                "%s: array %r fails its sha256 — bit rot or a torn write"
                % (name, key))


def _compression_of(name):
    base = os.path.basename(name)
    for suffix in _OPENERS:
        if suffix and base.endswith("." + suffix):
            return suffix
    return ""


def parse_checkpoint(raw, name=""):
    """Checkpoint bytes (compression from ``name``'s suffix) ->
    ``(flat_arrays, manifest)``, verified; ``manifest`` is None for a
    legacy blob without one. Raises :class:`CorruptCheckpointError`."""
    comp = _compression_of(name)
    try:
        data = raw if not comp else \
            _OPENERS[comp](io.BytesIO(raw), "rb").read()
        flat = dict(numpy.load(io.BytesIO(data), allow_pickle=False))
    except Exception as exc:
        # truncated gzip (EOFError), a torn zip, anything mid-container:
        # one fault class for a resume
        raise CorruptCheckpointError(
            "%s: unreadable checkpoint (%s: %s)"
            % (name or "<bytes>", type(exc).__name__, exc)) from exc
    manifest = None
    if MANIFEST_KEY in flat:
        try:
            manifest = json.loads(bytes(flat.pop(MANIFEST_KEY)).decode())
        except ValueError as exc:
            raise CorruptCheckpointError(
                "%s: undecodable manifest (%s)" % (name, exc)) from exc
        _verify_flat(flat, manifest, name or "<bytes>")
    return flat, manifest


class _CountingSink:
    """Write-through wrapper counting the (compressed) bytes stored."""

    def __init__(self, sink):
        self._sink = sink
        self.nbytes = 0

    def write(self, data):
        self.nbytes += len(data)
        return self._sink.write(data)

    def flush(self):
        self._sink.flush()


def write_checkpoint(store, name, tree, compression="gz", slot="best",
                     extra_meta=None):
    """Serialize ``tree`` with its manifest and commit it to ``store``
    under ``name`` -> ``(uri, nbytes)``; counted in :data:`COUNTERS`."""
    t0 = time.perf_counter()
    data = dump_checkpoint(tree, slot=slot, extra_meta=extra_meta)
    sp = store.stream(name)
    with sp as sink:
        counting = _CountingSink(sink)
        if compression:
            with _OPENERS[compression](counting, "wb") as f:
                f.write(data)
        else:
            counting.write(data)
    COUNTERS.record_write(slot, counting.nbytes, time.perf_counter() - t0)
    # the flight recorder's log: which checkpoint existed when
    telemetry.record_event("checkpoint_written", name=name, slot=slot,
                           bytes=counting.nbytes)
    return sp.uri, counting.nbytes


def load_snapshot(path):
    """A checkpoint file or ``http(s)://`` URI -> its state tree,
    verified (legacy blobs load unverified); raises
    :class:`CorruptCheckpointError`."""
    return load_snapshot_meta(path)[0]


def load_snapshot_meta(path):
    """:func:`load_snapshot` that also returns the manifest (None for a
    legacy blob)."""
    store, name = store_for(path)
    if store is not None:
        raw = store.get(name)
    else:
        with open(path, "rb") as f:
            raw = f.read()
    flat, manifest = parse_checkpoint(raw, name)
    return _unflatten_tree(flat), manifest


def is_diverged(manifest):
    """Whether a manifest carries the model-health verdict
    ``diverged``."""
    doc = (manifest or {}).get("model_health")
    return isinstance(doc, dict) and doc.get("verdict") == "diverged"


# -- retention and the store scan ------------------------------------------

#: any rolling-slot name (the snapshotter's ``current``, the reference
#: master's ``master``): never adopted as a metric-stamped snapshot
_ROLLING_RE = re.compile(r"_(current|master)-\d+\.ckpt\.")

#: what may follow ``<prefix>_`` in one of OUR names: the metric stamp,
#: ``initial`` or a rolling slot — not a sibling workflow whose name
#: merely extends ours ("mnist" vs "mnist_big")
_OWN_STAMP_RE = re.compile(
    r"(?:=[^/]*?|initial|(?:current|master)-\d+)\.ckpt\.")


def _under_prefix(name, prefixes):
    return any(p and name.startswith(p + "_")
               and _OWN_STAMP_RE.match(name[len(p) + 1:])
               for p in prefixes)


class RollingSlot:
    """Retention over ``<prefix>_<marker>-NNNNNNNN.ckpt.npz[.comp]``:
    keeps the last ``keep``; :meth:`rebuild` re-adopts the slot's names
    from the store, so a restarted process keeps pruning them and
    continues the sequence."""

    def __init__(self, store, prefix, marker="current", keep=2):
        self.store = store
        self.prefix = prefix
        self.marker = marker
        self.keep = int(keep)
        self._names = []
        self._seq = 0
        self._pattern = re.compile(
            re.escape(prefix) + "_" + re.escape(marker) + r"-(\d+)\.ckpt\.")

    def rebuild(self, names=None):
        """Re-adopt this slot's names (oldest first); -> how many. A
        failed listing is warned: the sequence then restarts at 0."""
        if names is None:
            try:
                names = self.store.list()
            except OSError as exc:
                logger.warning("%s-slot retention rebuild skipped: store "
                               "list failed (%s)", self.marker, exc)
                return 0
        found = sorted((int(m.group(1)), n) for n in names
                       for m in (self._pattern.match(n),) if m)
        self._names = [n for _, n in found]
        self._seq = found[-1][0] if found else 0
        return len(found)

    def next_name(self, compression="gz"):
        self._seq += 1
        return "%s_%s-%08d.ckpt.npz%s" % (
            self.prefix, self.marker, self._seq,
            "." + compression if compression else "")

    def commit(self, name):
        """Record a committed write, prune past ``keep``; -> the pruned
        names."""
        if name in self._names:
            self._names.remove(name)
        self._names.append(name)
        pruned = []
        while len(self._names) > self.keep:
            stale = self._names.pop(0)
            _delete(self.store, stale)
            pruned.append(stale)
        return pruned


def _delete(store, name):
    """A retention delete: a failure is warned (a store whose deletes
    always fail grows by one blob per write), never raised."""
    try:
        store.delete(name)
    except OSError as exc:
        logger.warning("retention delete of %s failed: %s", name, exc)


def health_stamp_meta():
    """The ``extra_meta`` of every checkpoint the snapshotter writes: the
    model monitor's verdict under ``model_health`` and, when a continual
    run registered an ingest clock (``continual.py``), ``ingest_wall``:
    the wall time of the newest sample behind these weights, what a
    serving replica's staleness is measured from."""
    from veles_torch import continual
    meta = {"model_health": model_health.get_model_monitor()
            .manifest_stamp()}
    wall = continual.ingest_wall()
    if wall:
        meta["ingest_wall"] = float(wall)
    return meta


class CheckpointInfo:
    """One store entry as :func:`scan_checkpoints` sees it."""

    __slots__ = ("name", "status", "manifest", "error")

    def __init__(self, name, status, manifest=None, error=None):
        self.name = name
        self.status = status          # "valid" | "corrupt" | "legacy"
        self.manifest = manifest
        self.error = error

    @property
    def wall_time(self):
        if self.manifest:
            try:
                return float(self.manifest.get("wall_time"))
            except (TypeError, ValueError):
                pass
        return None

    @property
    def health_verdict(self):
        if self.manifest:
            doc = self.manifest.get("model_health")
            if isinstance(doc, dict):
                return doc.get("verdict")
        return None

    @property
    def ingest_wall(self):
        """Wall time of the newest sample behind these weights (a
        continual run's), or None."""
        if self.manifest:
            try:
                return float(self.manifest.get("ingest_wall"))
            except (TypeError, ValueError):
                pass
        return None

    def __repr__(self):
        return "CheckpointInfo(%r, %s)" % (self.name, self.status)


def scan_checkpoints(target):
    """Audit every checkpoint of a store: -> ``[CheckpointInfo]``, valid
    ones first (newest leading), then legacy, then corrupt. A missing
    store or a failed listing raises (never "no checkpoints")."""
    store = store_for_base(target, create=False)
    infos = []
    for name in store.list():
        try:
            raw = store.get(name)
        except KeyError:
            continue                  # raced retention
        try:
            _, manifest = parse_checkpoint(raw, name)
        except CorruptCheckpointError as exc:
            infos.append(CheckpointInfo(name, "corrupt", error=str(exc)))
            continue
        infos.append(CheckpointInfo(
            name, "valid" if manifest else "legacy", manifest=manifest))
    rank = {"valid": 0, "legacy": 1, "corrupt": 2}
    # name DESC first, then a stable sort by (status, wall time): two
    # writes in one clock tick tie, and the zero-padded rolling names
    # then put the higher sequence first
    infos.sort(key=lambda i: i.name, reverse=True)
    infos.sort(key=lambda i: (rank[i.status], -(i.wall_time or 0.0)))
    return infos


def resolve_auto(target, prefixes=None):
    """``--snapshot auto``: the newest checkpoint of ``target`` whose
    manifest verifies, past corrupt ones (each counted in
    ``COUNTERS.verify_failures``); legacy blobs and ``diverged``
    manifests are skipped; with ``prefixes``, only names of the form
    ``<prefix>_<our stamp>``. -> ``(state_tree, name, n_corrupt)`` or
    None when nothing verifies. A missing store raises."""
    store = store_for_base(target, create=False)
    best = None                       # (wall_time, name, flat, manifest)
    corrupt = 0
    for name in store.list():
        if prefixes and not _under_prefix(name, prefixes):
            continue
        try:
            raw = store.get(name)
        except KeyError:
            continue
        try:
            flat, manifest = parse_checkpoint(raw, name)
        except CorruptCheckpointError as exc:
            corrupt += 1
            COUNTERS.count_verify_failure()
            logger.warning("checkpoint %s rejected: %s", name, exc)
            continue
        if manifest is None:
            continue                  # legacy: by explicit path only
        if is_diverged(manifest):
            COUNTERS.count_diverged_skip()
            logger.warning("checkpoint %s skipped: model-health verdict "
                           "'diverged'", name)
            continue
        try:
            wall = float(manifest.get("wall_time") or 0.0)
        except (TypeError, ValueError):
            wall = 0.0
        if best is None or (wall, name) > (best[0], best[1]):
            best = (wall, name, flat, manifest)
    if best is None:
        return None
    _, name, flat, manifest = best
    here, stamped = config_fingerprint(), manifest.get("config_hash")
    if here and stamped and here != stamped:
        logger.warning("checkpoint %s was written under a different config "
                       "(hash %s… vs current %s…) — resuming anyway",
                       name, stamped[:10], here[:10])
    return _unflatten_tree(flat), name, corrupt


# -- the writer ------------------------------------------------------------


class Snapshotter:
    """Checkpoint writer of a workflow (``link_snapshotter``), run by the
    workflow after the decision at each class boundary of an epoch.

    Without ``interval`` it writes only when ``decision.improved``
    (``<prefix>_=<metric>`` in the ``best`` slot, keeping ``keep``); with
    ``interval=SECS`` it also writes a rolling ``current`` checkpoint at
    the first boundary after SECS since the last write (keeping
    ``keep_interval``). Retention of both slots is rebuilt from the store
    at :meth:`initialize`. A failed write is warned and training goes on,
    until ``max_store_failures`` in a row, which raise. ``export_inference``
    (a directory) re-exports the inference archive of each improved
    snapshot, from the checkpoint's view."""

    def __init__(self, workflow, prefix="wf", compression="gz",
                 directory=None, keep=2, export_inference=None,
                 interval=None, keep_interval=2, name="snapshotter"):
        if compression not in _OPENERS:
            raise ValueError("compression must be one of %s"
                             % sorted(_OPENERS))
        self.workflow = workflow
        self.name = name
        self.prefix = prefix
        self.compression = compression
        self.directory = directory or root.common.dirs.snapshots
        self.interval = None if not interval else float(interval)
        self.keep_interval = int(keep_interval)
        self.keep = keep
        self._store = None
        self._current_slot = None
        self._last_write = time.monotonic()
        self.decision = None
        #: the last written path
        self.destination = None
        self._written = []
        self._store_failures = 0
        self.max_store_failures = 3
        self.export_inference_dir = export_inference

    @property
    def store(self):
        if self._store is None:
            self._store = store_for_base(self.directory)
        return self._store

    @property
    def writer(self):
        """Whether this process writes: one process, or rank 0 of a
        parallel run's group (the other ranks only take their part in a
        tensor-parallel checkpoint's gathers)."""
        return not dist.is_initialized() or dist.get_rank() == 0

    def initialize(self):
        """Materialize the store and rebuild both slots' retention (on
        the writer only)."""
        if not self.writer:
            return
        self._current_slot = RollingSlot(self.store, self.prefix,
                                         keep=self.keep_interval)
        try:
            names = self.store.list()
        except OSError as exc:
            logger.warning("retention rebuild skipped: store list failed "
                           "(%s)", exc)
            return
        self._current_slot.rebuild(names=names)
        best = []
        for name in names:
            if not name.startswith(self.prefix + "_") \
                    or _ROLLING_RE.search(name):
                continue
            rest = name[len(self.prefix) + 1:]
            if rest.startswith("initial.ckpt."):
                metric = numpy.inf      # "initial" prunes first
            elif rest.startswith("="):
                try:
                    metric = float(rest[1:rest.index(".ckpt.")])
                except ValueError:
                    continue
            else:
                continue
            best.append((metric, name))
        # pop(0) prunes the worst metric first: newest == best
        best.sort(key=lambda t: (-t[0], t[1]))
        self._written = [n for _, n in best]
        self._prune(self._written, self.keep)

    def _prune(self, written, keep):
        while len(written) > keep:
            _delete(self.store, written.pop(0))

    def suffix(self):
        metric = getattr(self.decision, "best_metric", None)
        if metric is None or not numpy.isfinite(metric):
            return "initial"
        return "=%.6g" % metric

    def run(self):
        """One boundary: an improved decision writes ``best``; past the
        interval, a ``current`` checkpoint. On a mesh rank 0's choice is
        broadcast (the interval is its clock's); the other ranks then
        only take their part in the checkpoint's gathers."""
        slot = None
        if self.decision is not None and self.decision.improved:
            slot = "best"
        elif self.interval is not None \
                and time.monotonic() - self._last_write >= self.interval:
            # re-arm BEFORE the attempt: a failed write waits a full
            # interval, so one store outage cannot burn the whole
            # failure budget at consecutive boundaries
            self._last_write = time.monotonic()
            slot = "current"
        mesh = getattr(self.workflow, "mesh", None)
        if mesh is not None:
            slot = self._agree(mesh, slot)
            if not self.writer:
                if slot is not None and self.workflow.shard_specs:
                    self.workflow.checkpoint_state()
                return
        if slot is not None:
            self.export_snapshot(slot=slot)

    def _agree(self, mesh, slot):
        """Rank 0's slot choice on every rank of the mesh."""
        from veles_torch.znicz.parallel import collectives
        slots = (None, "best", "current")
        flag = torch.tensor([slots.index(slot)], dtype=torch.int32,
                            device=self.workflow.device.device)
        return slots[int(collectives.broadcast(
            flag, mesh, mesh.axis_names).item())]

    def export_snapshot(self, slot="best"):
        """Write one checkpoint into ``slot``; -> its path, or None when
        the write failed within the failure budget (or this process is
        not the writer of a parallel run)."""
        if not self.writer:
            return None
        if slot == "best":
            name = "%s_%s.ckpt.npz%s" % (
                self.prefix, self.suffix(),
                "." + self.compression if self.compression else "")
        else:
            if self._current_slot is None:
                self._current_slot = RollingSlot(
                    self.store, self.prefix, keep=self.keep_interval)
                self._current_slot.rebuild()
            name = self._current_slot.next_name(self.compression)
        try:
            # the state build is inside the guard too: a transient
            # failure degrades this checkpoint, not the run
            path, _ = write_checkpoint(
                self.store, name, self.workflow.checkpoint_state(),
                compression=self.compression, slot=slot,
                extra_meta=health_stamp_meta())
        except Exception as exc:
            self._store_failures += 1
            if self._store_failures >= self.max_store_failures:
                logger.error("snapshot store failed %d times in a row — "
                             "checkpointing is effectively disabled",
                             self._store_failures)
                raise
            logger.warning("snapshot %s NOT written (%s: %s; failure "
                           "%d/%d) — training continues", name,
                           type(exc).__name__, exc, self._store_failures,
                           self.max_store_failures)
            return None
        self._store_failures = 0
        self.destination = path
        self._last_write = time.monotonic()
        if slot == "best":
            if name in self._written:
                self._written.remove(name)
            self._written.append(name)
            self._prune(self._written, self.keep)
            if self.export_inference_dir:
                # a best snapshot is taken at a class boundary, where
                # the live params are the checkpoint's
                self.workflow.export_inference(self.export_inference_dir)
                logger.info("inference archive -> %s",
                            self.export_inference_dir)
        else:
            self._current_slot.commit(name)
        logger.info("snapshot [%s] -> %s", slot, path)
        return path

    def preempt_snapshot(self):
        """The SIGTERM path: one forced ``current`` checkpoint; a failure
        is warned (the process is exiting anyway); -> path or None. On a
        mesh every rank calls it: rank 0 writes, the others take their
        part in a sharded checkpoint's gathers."""
        try:
            if getattr(self.workflow, "mesh", None) is not None \
                    and not self.writer:
                if self.workflow.shard_specs:
                    self.workflow.checkpoint_state()
                return None
            return self.export_snapshot(slot="current")
        except Exception as exc:
            logger.warning("preemption checkpoint failed: %s", exc)
            return None
