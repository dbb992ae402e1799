"""The master server of the port: the wire of the elastic master/slave
mode.

The port's own copy of ``veles/server.py``, byte for byte the same wire,
so a port slave trains under a reference master and a reference slave
under a port master. Plain TCP with length-prefixed pickle frames, each
authenticated by an HMAC-SHA256 tag keyed on ``$VELES_CLUSTER_SECRET``
(the same public dev key when unset, loopback only). The frames carry
plain data only: tuples, dicts, Python numbers and host
``numpy.float32`` arrays, never torch tensors.

Protocol (client-initiated, synchronous per connection):

* ``("hello", name[, codec])``
                            → ``("welcome", slave_id, lease_id
                              [, codec[, topk_percent]])``: the slave
                              offers its gradient wire codec
                              (``compression.py``), the master answers
                              the one it chose (master config wins; a
                              mismatch falls back to ``"none"`` with a
                              counted warning). A 2-tuple hello is a
                              pre-codec peer: the connection stays on
                              legacy monolithic frames and the welcome
                              stays a 3-tuple; a codec-aware slave that
                              receives a 3-tuple back knows its master
                              is old and sends legacy frames too.
* ``("job", sid, lease)``   → ``("job", payload, job_id, epoch,
                              trace)`` | ``("wait",)`` | ``("bye",)``
                              | ``("stale",)``
* ``("update", sid, lease, job_id, epoch, data)``
                            → ``("ok",)`` | ``("stale",)``
* ``("ping", sid, lease)``  → ``("pong", epoch)`` | ``("stale",)``

``payload`` is the per-unit dict of
:class:`~veles_torch.distributable.DistributionRegistry` (the loader
ships a minibatch index list, the GD units ship weights); ``data``
carries the GD units' deltas and, under the reserved key
``__telemetry__``, the slave's counter state, model-health summary and
job-phase spans.

Fault tolerance:

* every hello mints a **lease** ``(slave_id, lease_id)``; every served
  job carries a unique ``job_id`` plus the master ``epoch``. An update
  is merged ONLY while its lease is live, its job_id is outstanding and
  its epoch is current; anything else is **fenced** with ``("stale",)``
  (a dropped zombie must not double-count its gradients, a duplicated
  update frame must not be applied twice);
* ``slave_timeout`` bounds a SILENT peer: the connection is swept, the
  slave dropped and its in-flight minibatches requeued within the
  bound;
* every drop, fenced update, stale job and requeue is counted in
  ``MasterServer.faults`` and surfaced through :meth:`MasterServer.
  status` (and from there the web-status dashboard).

The master owns the canonical weights on the host and never computes:
its workflow is initialized without a step (``launcher.py``).
"""

import hashlib
import hmac
import json
import os
import pickle
import secrets
import struct
import threading
import time

from veles_torch import reactor, telemetry
from veles_torch.distributable import DistributionRegistry
from veles_torch.logger import Logger

#: SECURITY: frames are pickled Python objects — deserializing one is
#: arbitrary code execution, so every frame carries an HMAC-SHA256 tag
#: keyed on a cluster-shared secret and recv_frame REFUSES to unpickle
#: anything unauthenticated. The secret comes from
#: ``$VELES_CLUSTER_SECRET``; without it set, only loopback operation
#: is allowed (see require_secret_for) — the dev fallback key is
#: public knowledge and protects against accidents, not attackers.
_SECRET = None

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def _secret():
    global _SECRET
    if _SECRET is None:
        _SECRET = os.environ.get(
            "VELES_CLUSTER_SECRET", "veles-znicz-tpu-dev").encode()
    return _SECRET


def require_secret_for(host, role):
    """Fail closed: refuse non-loopback master/slave endpoints unless
    an explicit cluster secret is configured."""
    if host in _LOOPBACK:
        return
    if "VELES_CLUSTER_SECRET" not in os.environ:
        raise RuntimeError(
            "%s endpoint %r is not loopback and VELES_CLUSTER_SECRET "
            "is unset: the wire protocol deserializes pickle and the "
            "default HMAC key is public. Set VELES_CLUSTER_SECRET to "
            "the same random value on every node." % (role, host))


#: per-frame wire overhead: 4-byte length header + 32-byte HMAC tag
_FRAME_OVERHEAD = 36

#: process-level wire accounting (`veles_wire_bytes_total`): the
#: honest scraped view of what the protocol moves — the
#: wire cost as a first-class
#: metric instead of a bench-only number
_WIRE_TX = telemetry.LazyChild(lambda: telemetry.counter(
    "veles_wire_bytes_total",
    "Bytes moved over the framed master/slave protocol by direction "
    "(payload + length header + auth tag)", ("direction",)).labels("tx"))
_WIRE_RX = telemetry.LazyChild(lambda: telemetry.counter(
    "veles_wire_bytes_total",
    "Bytes moved over the framed master/slave protocol by direction "
    "(payload + length header + auth tag)", ("direction",)).labels("rx"))

#: the request kinds the master dispatches on — also the bounded
#: universe of the per-kind request-counter label
_REQUEST_KINDS = frozenset(("hello", "ping", "job", "update"))


def _resolve_request_kind(kind):
    """Bounded resolver for the wire-supplied request kind: the frame
    chooses the kind string, but the per-kind counter cache and its
    Prometheus label set must not be the wire's to grow (the
    TenantTable.resolve convention:
    unknown values fold into one ``other`` bucket)."""
    kind = str(kind)
    return kind if kind in _REQUEST_KINDS else "other"


#: first payload byte of the buffer-carrying frame format below; a
#: plain pickle starts with b"\x80" (the PROTO opcode), so the two
#: formats are distinguishable from byte 0 and old-format frames stay
#: decodable forever
_FRAME_MAGIC = b"\xf5"


def _frame_parts(obj):
    """Serialize ``obj`` into a list of buffer-ish payload parts.

    Pickle protocol 5 with OUT-OF-BAND ndarray buffers: the pickle
    stream carries only tensor metadata while each array's memory
    ships as its own part — a multi-MB weight frame is never copied
    into one monolithic blob. Payload layout when buffers exist::

        magic(1) | n_buffers(>I) | pickle_len(>I) | n x buf_len(>Q)
        | pickle stream | buffer bytes...

    Buffer-free frames (pings, acks) stay a bare pickle stream."""
    buffers = []
    blob = pickle.dumps(obj, protocol=5,
                        buffer_callback=buffers.append)
    if not buffers:
        return [blob]
    raws = [b.raw() for b in buffers]
    head = [_FRAME_MAGIC, struct.pack(">II", len(raws), len(blob))]
    head.extend(struct.pack(">Q", len(r)) for r in raws)
    return [b"".join(head), blob] + raws


def decode_frame_payload(blob):
    """Authenticated payload bytes -> object, both frame formats.
    Out-of-band buffers are reconstructed as ZERO-COPY views into
    ``blob`` (pass a bytearray for writable arrays)."""
    if blob[:1] != _FRAME_MAGIC:
        return pickle.loads(blob)
    try:
        nbuf, plen = struct.unpack_from(">II", blob, 1)
        sizes = struct.unpack_from(">%dQ" % nbuf, blob, 9)
    except struct.error:
        raise ConnectionError("garbled out-of-band frame header")
    off = 9 + 8 * nbuf
    if off + plen + sum(sizes) != len(blob):
        raise ConnectionError(
            "out-of-band frame buffer accounting mismatch "
            "(%d parts, %d bytes claimed, %d received)"
            % (nbuf, off + plen + sum(sizes), len(blob)))
    view = memoryview(blob)
    pos = off + plen
    bufs = []
    for size in sizes:
        bufs.append(view[pos:pos + size])
        pos += size
    return pickle.loads(view[off:off + plen], buffers=bufs)


def send_frame(sock, obj, legacy=False):
    # the frame is sent as a memoryview SEQUENCE (header, pickle
    # stream, raw tensor buffers) — sequential sendall, so the
    # multi-MB weight payload is never concatenated into a second
    # copy. ``legacy=True`` pins the payload to one monolithic bare
    # pickle for a pre-OOB peer (negotiated from the hello shape —
    # see the protocol docstring); a bare protocol-5 stream with no
    # out-of-band buffers is exactly what an old recv_frame's
    # pickle.loads expects.
    parts = [pickle.dumps(obj, protocol=5)] if legacy \
        else _frame_parts(obj)
    size = sum(len(p) for p in parts)
    mac = hmac.new(_secret(), digestmod=hashlib.sha256)
    for part in parts:
        mac.update(part)
    sock.sendall(struct.pack(">I", size) + mac.digest())
    for part in parts:
        sock.sendall(part)
    _WIRE_TX.get().inc(size + _FRAME_OVERHEAD)


#: The length header arrives BEFORE authentication, so it must not be
#: able to command huge allocations: cap it well above any real payload
#: (largest frames ship full model weights) but far below OOM territory.
MAX_FRAME_BYTES = 1 << 30


def recv_frame(sock):
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    size, = struct.unpack(">I", header)
    if size > MAX_FRAME_BYTES:
        raise ConnectionError(
            "frame header claims %d bytes (cap %d) — dropping peer"
            % (size, MAX_FRAME_BYTES))
    tag = _recv_exact(sock, 32)
    if tag is None:
        return None
    # into a bytearray (writable): out-of-band tensor payloads become
    # zero-copy WRITABLE views of this buffer instead of a second
    # allocation + copy per multi-MB weight frame
    blob = _recv_exact_into(sock, size)
    if blob is None:
        return None
    if not hmac.compare_digest(
            tag, hmac.new(_secret(), blob, hashlib.sha256).digest()):
        raise ConnectionError(
            "frame failed HMAC authentication (cluster secret mismatch "
            "or untrusted peer) — refusing to deserialize")
    _WIRE_RX.get().inc(size + _FRAME_OVERHEAD)
    return decode_frame_payload(blob)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_exact_into(sock, n):
    """Like :func:`_recv_exact` but receives straight into one
    preallocated WRITABLE buffer (``recv_into``) — no per-chunk
    concatenation, and the returned bytearray can back zero-copy
    ndarray views."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            return None
        got += r
    return buf


# -- raw (unauthenticated) framing -------------------------------------


def send_raw_frame(sock, blob):
    """Length-prefixed frame WITHOUT pickle or HMAC — for channels
    whose payloads are inert bytes (the graphics npz stream,
    ``graphics.py``). Sent as two parts so the payload is never
    copied into a concatenated frame."""
    sock.sendall(struct.pack(">I", len(blob)))
    sock.sendall(memoryview(blob))


def recv_raw_frame(sock, max_bytes=MAX_FRAME_BYTES):
    """Counterpart of :func:`send_raw_frame`: the hardened receive —
    length cap BEFORE allocation, exact recv — shared so no caller
    grows its own uncapped clone; ``None`` on EOF."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    size, = struct.unpack(">I", header)
    if size > max_bytes:
        raise ConnectionError(
            "frame header claims %d bytes (cap %d) — dropping peer"
            % (size, max_bytes))
    return _recv_exact(sock, size)


class FramedConnection(reactor.Connection):
    """One HMAC-framed peer on the reactor: incremental assembly of
    the ``length(4) | tag(32) | payload`` frames (both the
    out-of-band buffer format and legacy bare pickles — the shared
    :func:`decode_frame_payload` handles either), zero-copy payload
    receive into one preallocated bytearray, and :meth:`send_obj`
    emission through the bounded per-connection write queue. Loop
    thread only. Subclasses implement ``on_frame(obj)``."""

    def __init__(self, loop, sock, max_write_buffer=None):
        self._headbuf = bytearray()     # length + tag accumulation
        self._tag = None
        self._blob = None               # preallocated payload buffer
        self._got = 0
        super().__init__(loop, sock, max_write_buffer=max_write_buffer)

    def on_readable(self):
        # phase-aware recv_into instead of the generic chunked read:
        # multi-MB weight payloads land straight in their final
        # buffer, which then backs zero-copy ndarray views (the same
        # no-second-allocation contract _recv_exact_into gives the
        # blocking path)
        budget = reactor.READ_BUDGET
        while budget > 0 and not self.closed:
            if self._blob is None:
                try:
                    data = self.sock.recv(36 - len(self._headbuf))
                except (BlockingIOError, InterruptedError):
                    return
                except OSError as exc:
                    self.close(reason="recv: %s" % exc)
                    return
                if not data:
                    self.close(reason="eof")
                    return
                budget -= len(data)
                self.last_recv = time.monotonic()
                self._headbuf += data
                if len(self._headbuf) < 36:
                    continue
                size, = struct.unpack(">I", self._headbuf[:4])
                if size > MAX_FRAME_BYTES:
                    self.close(
                        reason="frame header claims %d bytes (cap %d)"
                               % (size, MAX_FRAME_BYTES))
                    return
                self._tag = bytes(self._headbuf[4:36])
                del self._headbuf[:]
                self._blob = bytearray(size)
                self._got = 0
                if size == 0:
                    self._frame_done()
                continue
            want = min(len(self._blob) - self._got, budget)
            try:
                n = self.sock.recv_into(
                    memoryview(self._blob)[self._got:], want)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self.close(reason="recv: %s" % exc)
                return
            if not n:
                self.close(reason="eof mid-frame")
                return
            self._got += n
            budget -= n
            self.last_recv = time.monotonic()
            if self._got == len(self._blob):
                self._frame_done()

    def _frame_done(self):
        blob, tag = self._blob, self._tag
        self._blob = self._tag = None
        if not hmac.compare_digest(
                tag, hmac.new(_secret(), blob,
                              hashlib.sha256).digest()):
            self.close(reason="frame failed HMAC authentication")
            return
        _WIRE_RX.get().inc(len(blob) + _FRAME_OVERHEAD)
        try:
            obj = decode_frame_payload(blob)
        except Exception as exc:
            self.close(reason="undecodable frame: %s" % exc)
            return
        self.on_frame(obj)

    def on_frame(self, obj):
        raise NotImplementedError

    def send_obj(self, obj, legacy=False):
        """Encode + enqueue one reply frame (same wire bytes and
        ``veles_wire_bytes_total`` accounting as :func:`send_frame`);
        ``legacy`` pins a monolithic bare pickle for pre-OOB peers."""
        parts = [pickle.dumps(obj, protocol=5)] if legacy \
            else _frame_parts(obj)
        size = sum(len(p) for p in parts)
        mac = hmac.new(_secret(), digestmod=hashlib.sha256)
        for part in parts:
            mac.update(part)
        self.send_parts(
            [struct.pack(">I", size) + mac.digest()] + parts)
        _WIRE_TX.get().inc(size + _FRAME_OVERHEAD)


class _FramedSession(FramedConnection):
    """framed_server's per-connection protocol state: hello capture
    (slave id, legacy arity, duplicate-hello revocation), polite-bye
    close, and the drop hook on teardown."""

    def __init__(self, server, sock):
        self._srv = server
        self.slave_id = None
        self.clean = False
        # a 2-tuple hello marks a pre-OOB peer: every reply on this
        # connection must stay a legacy monolithic frame or the first
        # array-carrying job payload would crash the old recv_frame
        # (see the protocol docstring)
        self.legacy = False
        super().__init__(server.reactor, sock,
                         max_write_buffer=server.max_write_buffer)

    def on_frame(self, req):
        srv = self._srv
        try:
            resp = srv._handle(req)
        except Exception as exc:
            srv.warning("handler failed on %r frame: %s: %s",
                        req[0] if isinstance(req, tuple) and req
                        else type(req).__name__,
                        type(exc).__name__, exc)
            self.close(reason="handler error")
            return
        if isinstance(req, tuple) and req and req[0] == "hello" \
                and resp and resp[0] == "welcome":
            self.legacy = len(req) < 3
            if self.slave_id is not None and self.slave_id != resp[1]:
                # a duplicated hello frame minted a second lease on
                # this connection: revoke the one we stop tracking or
                # it leaks forever
                srv._on_drop(self.slave_id)
            self.slave_id = resp[1]
        self.send_obj(resp, legacy=self.legacy)
        if resp and resp[0] == "bye":
            self.clean = True
            self.close_when_drained()
        elif resp == ("stale",) and isinstance(req, tuple) and req \
                and req[0] == "ping":
            # a fenced ping's sender may be a SEND-ONLY heartbeat
            # (client.py) that cannot see this answer: sever once the
            # reply drains, or a zombie's beat keeps inflating
            # stale_pings once per interval for a whole long local
            # compute. The main thread's next round-trip on the dead
            # socket reconnects exactly as reading the fence would —
            # and the lease behind this connection can never come
            # back, so nothing of value is lost.
            self.close_when_drained()

    def on_closed(self, reason):
        srv = self._srv
        srv.untrack(self)
        if reason == "overflow":
            srv.warning(
                "dropping peer %s: write queue exceeded %d bytes "
                "(stalled reader — backpressure cap)", self.slave_id,
                self.max_write_buffer)
            if srv._on_overflow is not None:
                try:
                    srv._on_overflow(self.slave_id)
                except Exception:
                    pass
        if self.slave_id is not None:
            srv._on_drop(self.slave_id, clean=self.clean)


class ReactorFramedServer(reactor.ListeningServer):
    """The framed request plane on the shared reactor (see
    :func:`framed_server` for the contract). Accepting starts at
    construction; ``shutdown()``/``server_close()`` tear down the
    listener and every live session — the listener/teardown plumbing
    itself is the shared :class:`veles.reactor.ListeningServer`."""

    def __init__(self, address, handle_request, done_event, on_drop,
                 timeout=None, max_write_buffer=None,
                 on_overflow=None):
        self._handle = handle_request
        self._on_drop = on_drop
        self._on_overflow = on_overflow
        self.done_event = done_event
        self.timeout = None if not timeout else float(timeout)
        self.max_write_buffer = max_write_buffer \
            or reactor.DEFAULT_MAX_WRITE_BUFFER
        self._shutdown_event = threading.Event()
        self._sweep_timer = None
        super().__init__(address, name="framed_server")
        if self.timeout:
            # the silent-peer bound: a host that vanishes without
            # FIN/RST stops producing frames; the sweep closes it
            # within ~timeout + interval so its work requeues
            interval = max(min(self.timeout / 4.0, 1.0), 0.05)
            self._sweep_timer = self.reactor.every(
                interval, self._sweep_idle)

    def build_connection(self, sock, _addr):
        return _FramedSession(self, sock)

    def write_queue_bytes(self):
        """{slave_id: queued-unsent reply bytes} for hello'ed
        sessions — the per-connection backpressure depth
        ``MasterServer.status()`` surfaces per slave."""
        out = {}
        for session in self.connections():
            if session.slave_id is not None and not session.closed:
                out[session.slave_id] = int(session.write_queued)
        return out

    def _sweep_idle(self):
        now = time.monotonic()
        for session in self.connections():
            if not session.closed \
                    and now - session.last_recv > self.timeout:
                session.close(
                    reason="silent peer (> slave_timeout %.1fs)"
                           % self.timeout)

    def on_close_loop(self):
        if self._sweep_timer is not None:
            self._sweep_timer.cancel()

    def serve_forever(self, poll_interval=0.5):
        """Compat shim: accepting starts at construction — this just
        parks until shutdown (callers historically ran the accept
        loop on a thread)."""
        self._shutdown_event.wait()

    def shutdown(self):
        self._shutdown_event.set()
        self.close()

    def server_close(self):
        self.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server_close()
        return False


def framed_server(address, handle_request, done_event, on_drop,
                  timeout=None, max_write_buffer=None,
                  on_overflow=None):
    """The framed request plane shared by the training master and the
    GA task master (``genetics.py``): a
    :class:`ReactorFramedServer` on the process's shared selector
    reactor (one loop thread total — previously a
    ``ThreadingTCPServer`` burned a blocking thread per connection).
    Frames pump through ``handle_request`` (which still runs under
    the caller's own lock discipline); the slave id is captured from
    the hello exchange and ``on_drop(slave_id, clean=...)`` fires
    when the connection ends — the drop->requeue elasticity hook;
    ``clean=True`` marks a polite ``("bye",)`` completion so it can
    be deregistered without counting as a fault. ``timeout``
    (seconds) bounds a silent peer: a slave whose host vanishes
    without FIN/RST is swept and its in-flight work requeued.
    ``max_write_buffer`` bounds each connection's reply queue — a
    stalled reader is dropped at the cap (``on_overflow(slave_id)``
    fires first) instead of ever blocking the loop or other peers.
    The caller owns shutdown + server_close (use ``with``)."""
    return ReactorFramedServer(address, handle_request, done_event,
                               on_drop, timeout=timeout,
                               max_write_buffer=max_write_buffer,
                               on_overflow=on_overflow)


#: default bound on a silent slave (seconds). Training jobs are one
#: minibatch, so a peer mute for a minute is dead, not busy — the GA
#: master (genetics.py), whose jobs are whole training runs,
#: overrides this with hours.
DEFAULT_SLAVE_TIMEOUT = 60.0

#: reactor loop lag (seconds) above which the master:reactor
#: readiness check reports NOT ready: probes still answer (the
#: monitor caches verdicts) but a loop this far behind is not
#: dispatching the wire plane at line rate
REACTOR_LAG_READY_S = 1.0

#: how long a COMPLETED master keeps its listener up answering
#: ``("bye",)`` before tearing it down. A slave mid-compute or
#: mid-reconnect-backoff when the run finishes misses the in-band
#: goodbye; with ``max_retries=None`` (the preemptible-master
#: setting) it would then retry a dead address forever. 5s covers the
#: default reconnect cycle (retry_max 2.0 × 1.25 jitter) and several
#: 1s heartbeat periods.
DEFAULT_DRAIN_TIMEOUT = 5.0


#: uncompressed job frames of its workflow a master's per-connection
#: reply queue holds before the reader is declared stalled
WRITE_BUFFER_JOBS = 3


def wire_nbytes(workflow):
    """Float32 bytes of every parameter the workflow's distributable
    units put on the wire (an upper bound of one job frame's tensors
    under any codec)."""
    return sum(4 * int(t.numel())
               for unit in DistributionRegistry(workflow).units()
               for _, t in getattr(unit, "_wire_params", list)())


class MasterServer(Logger):
    """Owns canonical weights + the job queue; never computes."""

    def __init__(self, workflow, address, max_epochs=None,
                 slave_timeout=DEFAULT_SLAVE_TIMEOUT,
                 checkpoint_store=None, checkpoint_every=None,
                 resume_state=None,
                 drain_timeout=DEFAULT_DRAIN_TIMEOUT,
                 grad_codec="none", grad_topk_percent=1.0,
                 max_write_buffer=None,
                 rollback_on_divergence=False, stash_interval=1):
        from veles_torch import compression
        self.name = "MasterServer"
        self.workflow = workflow
        #: model-health actuator (--rollback-on-divergence): keep a
        #: finiteness-checked RAM stash of the canonical weights and
        #: restore it the tick after the model-health verdict flips to
        #: diverged (a poisoned/blown-up slave delta merged into the
        #: canonical weights). None when disabled.
        self._weight_guard = None
        if rollback_on_divergence:
            from veles_torch.model_health import WeightGuard
            self._weight_guard = WeightGuard(
                workflow, stash_interval=stash_interval)
        #: gradient wire codec this master WANTS (compression.py)
        #: — negotiated per slave at hello: an agreeing slave gets it,
        #: anything else (old peer, different config) falls back to
        #: "none" with a counted warning
        self.grad_codec = str(grad_codec or "none")
        if self.grad_codec not in compression.CODEC_NAMES:
            raise ValueError(
                "unknown grad codec %r (known: %s)"
                % (grad_codec, ", ".join(compression.CODEC_NAMES)))
        self.grad_topk_percent = float(grad_topk_percent)
        #: slave_id -> GradCodec encoding that slave's job payloads
        #: (read by GradientDescentBase.generate_data_for_slave via
        #: the workflow; all access under self.lock)
        workflow.grad_codec_by_slave = {}
        host, _, port = str(address).rpartition(":")
        self.address = (host or "0.0.0.0", int(port))
        require_secret_for(self.address[0], "master listen")
        self.registry = DistributionRegistry(workflow)
        self.lock = threading.RLock()
        self.slaves = {}
        self._next_slave = 1
        self._next_job = 1
        self.epoch = 0
        #: durability: aggregated workflow state + the job journal are
        #: periodically persisted through this SnapshotStore, so a
        #: SIGKILLed master restarted with ``--snapshot auto`` rebuilds
        #: mid-run instead of being a single point of failure
        self.checkpoint_store = checkpoint_store
        self.checkpoint_every = None if not checkpoint_every \
            else float(checkpoint_every)
        self.drain_timeout = float(drain_timeout or 0.0)
        self._persist_lock = threading.Lock()
        self._persist_event = threading.Event()
        self._persist_slot = None
        self.persist_count = 0
        if checkpoint_store is not None:
            from veles_torch.snapshotter import RollingSlot
            self._persist_slot = RollingSlot(
                checkpoint_store, workflow.name, marker="master",
                keep=2)
            self._persist_slot.rebuild()
        #: finite by default — ``None``/0 disables the bound and
        #: restores the documented stranded-handler hazard, so only
        #: opt into that knowingly
        self.slave_timeout = slave_timeout
        #: robustness event counters (status()/dashboard): how often
        #: the cluster degraded and recovered, not just whether. The
        #: dict is the JSON view; every increment goes through
        #: _count_fault so the telemetry registry carries the same
        #: counters for the Prometheus scrape.
        self.faults = {"drops": 0, "requeued_jobs": 0,
                       "fenced_updates": 0, "stale_jobs": 0,
                       "stale_pings": 0, "unmerged_updates": 0,
                       "codec_fallbacks": 0,
                       "backpressure_drops": 0, "joins": 0}
        #: per-connection reply-queue cap (bytes): a slave that stops
        #: reading its broadcasts accumulates bounded queue on the
        #: reactor and is dropped at the cap with a counted fault —
        #: it can never stall the merge path or other slaves. The
        #: default holds WRITE_BUFFER_JOBS uncompressed job frames of
        #: this workflow (at least the reactor's default): a job frame
        #: larger than the cap would drop every healthy slave at its
        #: first job (a 40M-parameter model ships 160 MB in f32)
        self.max_write_buffer = max_write_buffer or max(
            reactor.DEFAULT_MAX_WRITE_BUFFER,
            WRITE_BUFFER_JOBS * wire_nbytes(workflow))
        #: loop-lag threshold for the master:reactor readiness check
        self.reactor_lag_ready_s = REACTOR_LAG_READY_S
        #: per-client-token (state, last_seen) of absorbed counter
        #: pushes (see _absorb_telemetry). One entry per SlaveClient
        #: instance; idle tokens are evicted after _TELE_TOKEN_TTL so
        #: days of slave churn cannot grow this unboundedly — the TTL
        #: comfortably outlives any reconnect/re-hello window, which
        #: is when the dedup baseline matters.
        self._tele_states = {}
        self._req_counters = {}
        if max_epochs is None:
            max_epochs = getattr(
                getattr(workflow, "decision", None), "max_epochs", None)
        if max_epochs is None:
            # the master never runs the decision unit, so patience-only
            # stopping cannot work here — demand an explicit bound
            raise ValueError(
                "MasterServer needs max_epochs (decision.max_epochs is "
                "None; early-stopping-only configs cannot drive a "
                "master)")
        self.max_epochs = int(max_epochs)
        self.done = threading.Event()
        #: set when serve_forever should stop — by done (run
        #: complete) OR abort (preemption/kill: the run is NOT
        #: complete, slaves must keep retrying for a restarted master
        #: instead of being told "bye")
        self._stop_serving = threading.Event()
        self._server = None
        loader = workflow.loader
        if resume_state is not None:
            self._restore_master_state(resume_state)
        else:
            loader.master_start_epoch()

    # -- restart recovery ----------------------------------------------

    def _restore_master_state(self, state):
        """Rebuild the job queue + journal from a persisted master
        checkpoint (the ``master`` section of the tree written by
        :meth:`persist_state`); the workflow part was already restored
        by the caller (Launcher ``--snapshot auto``). Pre-restart
        leases are NOT restored: reconnecting slaves re-hello against
        the fresh lease table and any zombie frame is fenced."""
        loader = self.workflow.loader
        self.epoch = int(state.get("epoch", 0))
        self._next_job = int(state.get("next_job", 1))
        self._next_slave = int(state.get("next_slave", 1))
        for kind, count in (state.get("faults") or {}).items():
            if kind in self.faults:
                self.faults[kind] = int(count)
        loader._pending_jobs = [
            (int(cls), [int(i) for i in idx])
            for cls, idx in state.get("pending", [])]
        loader._inflight = {}
        dist_prng = state.get("dist_prng")
        if dist_prng:
            # the master-side shuffle stream must CONTINUE, not
            # restart, or post-restart epochs repeat pre-restart
            # minibatch orders (the loader owns the derivation)
            gen = loader._ensure_dist_prng()
            gen._gen.bit_generator.state = json.loads(dist_prng)
        tele = state.get("tele")
        if tele:
            # re-adopt the per-token absorb baselines: slaves push
            # ABSOLUTE counter state, so a master that forgot the
            # baselines would re-absorb each slave's full history
            now = time.monotonic()
            self._tele_states = {
                token: ({(name, tuple(tuple(i) for i in items)): v
                         for name, items, v in entries}, now)
                for token, entries in json.loads(tele)}
        if self.epoch >= self.max_epochs:
            self.done.set()
            self._stop_serving.set()
        # an empty restored queue means epoch N was FULLY merged into
        # the restored weights (checkpoint_state folds in-flight back
        # into pending, so nothing can be outstanding): leave it empty
        # — the first job poll goes through _advance_epoch, which
        # increments the counter before refilling. Refilling here at
        # the stale counter would replay a whole already-merged epoch.
        self.info("restored master state: epoch %d, %d pending "
                  "job(s), %d journal token(s)", self.epoch,
                  len(loader._pending_jobs), len(self._tele_states))

    def checkpoint_state(self):
        """The persistable master tree: aggregated workflow state plus
        the job journal (queue position, epoch, counters, telemetry
        absorb baselines). In-flight jobs are folded back into pending
        — they are served-but-unmerged at snapshot time, so a restart
        re-serves them exactly once relative to the restored weights."""
        with self.lock:
            loader = self.workflow.loader
            pending = []
            for jobs in loader._inflight.values():
                pending.extend(jobs)
            pending.extend(loader._pending_jobs)
            pending = [(int(cls), [int(i) for i in idx])
                       for cls, idx in pending]
            dist_prng = None
            if hasattr(loader, "_dist_prng"):
                dist_prng = json.dumps(
                    loader._dist_prng._gen.bit_generator.state)
            tele = json.dumps([
                [token, [[name, list(items), value]
                         for (name, items), value in state.items()]]
                for token, (state, _) in self._tele_states.items()])
            return {
                "workflow": self.workflow.checkpoint_state(),
                "master": {
                    "epoch": self.epoch,
                    "next_job": self._next_job,
                    "next_slave": self._next_slave,
                    "pending": pending,
                    "faults": dict(self.faults),
                    "dist_prng": dist_prng,
                    "tele": tele,
                },
            }

    def persist_state(self, reason=""):
        """Write one master checkpoint through the snapshot store
        (same machinery, same ``veles_checkpoint_*`` telemetry as the
        Snapshotter unit; slot label ``master``); -> the URI or None
        (no store / store failure — persistence must degrade, never
        kill the cluster)."""
        store = self.checkpoint_store   # kill() may null it mid-call
        if store is None:
            return None
        from veles_torch.snapshotter import write_checkpoint
        with self._persist_lock:
            try:
                # checkpoint_state() is inside the guard too: a bad
                # slave-pushed telemetry entry or a transient device
                # error must degrade this persist, not kill the
                # persist thread (silently ending all durability) or
                # crash the shutdown path
                tree = self.checkpoint_state()
                name = self._persist_slot.next_name("gz")
                from veles_torch.snapshotter import health_stamp_meta
                # master checkpoints carry the model-health verdict
                # too: a restart's auto-resume must not adopt state
                # persisted while the canonical weights were diverged
                uri, _ = write_checkpoint(
                    store, name, tree, slot="master",
                    extra_meta=health_stamp_meta())
            except Exception as exc:
                self.warning("master state persist failed (%s): %s",
                             reason or "periodic", exc)
                return None
            self._persist_slot.commit(name)
            self.persist_count += 1
        self.debug("master state [%s] -> %s",
                   reason or "periodic", uri)
        return uri

    def _persist_loop(self):
        wait_s = self.checkpoint_every or 30.0
        while True:
            fired = self._persist_event.wait(wait_s)
            if self._stop_serving.is_set():
                return              # serve_forever writes the final one
            if fired:
                # clear only a CONFIRMED wakeup: clearing after a
                # timed-out wait could discard a set() that landed in
                # between, silently losing that epoch boundary's state
                self._persist_event.clear()
                self.persist_state()
            elif self.checkpoint_every:
                # explicit cadence: persist on the timer too. Without
                # one, epoch boundaries only — a timed-out wait would
                # re-serialize byte-identical state (stalling slaves
                # under the request lock) every 30s the operator
                # never asked for
                self.persist_state()

    def request_stop(self):
        """Signal-safe preemption stop: just flip the stop event —
        the serving thread's shutdown path writes the final persist,
        so no store I/O or lock acquisition happens in signal context.
        The run is NOT complete, so there is no drain and no ``bye``:
        slaves see a dead socket and keep retrying for the restarted
        master."""
        self._stop_serving.set()

    def kill(self):
        """Test/chaos hook — die like SIGKILL: stop serving with NO
        final persist, leaving only what the periodic loop already
        wrote."""
        self.checkpoint_store = None
        self._stop_serving.set()

    # -- health (health.py) --------------------------------------------

    def register_health(self, monitor=None):
        """Attach this master's readiness to the process health
        monitor (the Launcher does this in master mode; ``/readyz``
        on the web-status dashboard serves the cached verdict):

        * ``master:lease_table`` — the listener is bound and the
          serving loop has not stopped (completed or aborted runs
          report not-ready so a supervisor stops routing to them);
        * ``master:snapshot_store`` — the checkpoint store's circuit
          breaker is closed (persistence is not fast-failing);
        * ``master:reactor`` — the shared reactor loop is alive,
          accepting, and its loop lag is under
          :data:`REACTOR_LAG_READY_S` (a loop parked behind a
          blocking callback is not dispatching the wire plane).

        The checks run on the MONITOR thread and read plain
        attributes — never the master request lock."""
        from veles_torch import health
        monitor = monitor or health.get_monitor()

        def lease_table():
            if self.done.is_set():
                return False, "run complete"
            if self._stop_serving.is_set():
                return False, "serving stopped (preempted/killed)"
            if not hasattr(self, "bound_address"):
                return False, "listener not bound yet"
            return True, None

        def reactor_loop():
            # peek, never get_reactor(): the getter ensure_started()s
            # as a side effect, which would resurrect a dead/stopped
            # loop from inside a readiness CHECK and make the
            # not-running branch unreachable
            loop = reactor.peek_reactor()
            if loop is None or not loop.alive:
                return False, "reactor loop thread not running"
            # current_lag, not loop_lag_s: a WEDGED loop cannot
            # update its own self-measurement, but the overdue lag
            # probe is observable from this (monitor) thread
            lag = loop.current_lag()
            if lag > self.reactor_lag_ready_s:
                return False, ("reactor loop lag %.3fs over %.3fs "
                               "threshold" % (lag,
                                              self.reactor_lag_ready_s))
            server = self._server
            if server is None or not getattr(server, "accepting",
                                             True):
                return False, "wire listener not accepting"
            return True, None

        monitor.add_check("master:lease_table", lease_table,
                          tick=False)
        monitor.add_check("master:reactor", reactor_loop)
        store = self.checkpoint_store
        if store is not None and hasattr(store, "breaker_open"):
            def snapshot_store():
                if store.breaker_open():
                    return False, ("snapshot-store circuit breaker "
                                   "open (persists fast-failing)")
                return True, None
            monitor.add_check("master:snapshot_store", snapshot_store)
        return monitor

    # -- telemetry -----------------------------------------------------

    def _on_backpressure(self, slave_id):
        """framed_server overflow hook: a slave stopped reading its
        replies and hit the write-queue cap — count the drop class
        distinctly (the generic ``drops`` counter fires too, from the
        on_drop path that follows)."""
        with self.lock:
            self._count_fault("backpressure_drops")
        self.warning(
            "slave %s dropped at the write-queue cap (%d bytes of "
            "unread replies) — stalled reader", slave_id,
            self.max_write_buffer)

    def _count_fault(self, kind, n=1):
        self.faults[kind] += n
        telemetry.counter(
            "veles_cluster_faults_total",
            "Cluster degradation/recovery events by kind",
            ("kind",)).labels(kind).inc(n)
        if kind != "joins":
            # flight-recorder log: a postmortem on a degraded cluster
            # needs WHEN each fence/drop happened, not just how many
            telemetry.record_event("fault", kind=kind, n=n)

    def _set_slaves_gauge(self):
        telemetry.gauge(
            "veles_cluster_slaves",
            "Slaves currently holding a live lease").set(
            len(self.slaves))

    #: seconds an absorbed client token may stay idle before its
    #: dedup baseline is dropped (far beyond any reconnect window)
    _TELE_TOKEN_TTL = 6 * 3600.0

    def _absorb_telemetry(self, tele, slave_id):
        """Merge a slave's pushed counter state into the registry.

        The payload carries ABSOLUTE values plus a stable per-client
        token; this side increments by the per-token diff since the
        last absorbed state. Idempotent by construction: a retransmit
        after a lost ok-ack, a duplicated frame, or the same client
        re-helloing under a new slave_id can never double-count
        (called under self.lock)."""
        # model-health summary: republished slave-labelled
        # and folded into THIS process's detector, so one scrape of
        # the master sees cluster-wide training health and a slave
        # already diverged flips the master's verdict too. Before the
        # counter-state gate: a push may carry a summary with no
        # counter deltas.
        model = tele.get("model")
        if model is not None:
            from veles_torch import model_health
            model_health.get_model_monitor().absorb_slave(
                model, slave_id)
        token = tele.get("token")
        state = tele.get("state")
        if token is None or not isinstance(state, dict):
            return
        now = time.monotonic()
        last, _ = self._tele_states.get(token, ({}, now))
        self._tele_states[token] = (last, now)
        deltas = {}
        for key, value in state.items():
            dv = value - last.get(key, 0.0)
            if dv > 0:
                deltas[key] = dv
                last[key] = value
        if deltas:
            telemetry.get_registry().absorb_counters(
                deltas, extra_labels=(("slave", str(slave_id)),))
        if len(self._tele_states) > 64:
            for tok, (_, seen) in list(self._tele_states.items()):
                if now - seen > self._TELE_TOKEN_TTL:
                    del self._tele_states[tok]

    # -- job lifecycle -------------------------------------------------

    def _negotiate_codec(self, slave_id, name, offered):
        """Pick the gradient wire codec for one hello (called under
        self.lock). MASTER CONFIG WINS: a slave offering exactly the
        master's codec gets it; anything else — an old peer that
        offered nothing, a differently-configured one, or a codec
        name this build doesn't know — falls back to ``"none"`` with
        a counted warning, never a crash, so rolling upgrades and
        mixed configs keep training (uncompressed for that slave)."""
        from veles_torch import compression
        want = self.grad_codec
        if (offered or "none") == want:
            if want != "none":
                self.workflow.grad_codec_by_slave[slave_id] = \
                    compression.get_codec(want, self.grad_topk_percent)
            return want
        self._count_fault("codec_fallbacks")
        self.warning(
            "slave %d (%s) offered grad codec %r but master runs %r "
            "— falling back to 'none' for this slave", slave_id,
            name, offered, want)
        return "none"

    def _live_slave(self, request):
        """The (slave_id, info) behind ``request`` iff its lease is
        live: the id is registered AND the lease_id matches what the
        hello minted. A dropped-then-requeued slave, or one from a
        previous master incarnation, fails here and must re-hello."""
        slave_id = request[1]
        info = self.slaves.get(slave_id)
        if info is None:
            return slave_id, None
        lease = request[2] if len(request) > 2 else None
        if lease != info["lease"]:
            return slave_id, None
        info["last_seen"] = time.monotonic()
        return slave_id, info

    def handle(self, request):
        kind = request[0]
        kind_key = _resolve_request_kind(kind)
        req_counter = self._req_counters.get(kind_key)
        if req_counter is None:
            # per-kind LazyChild cache: idle slaves poll here every
            # 20ms, so the steady state must not pay family+child
            # resolution per frame
            req_counter = self._req_counters[kind_key] = \
                telemetry.LazyChild(
                    lambda k=kind_key: telemetry.counter(
                        "veles_master_requests_total",
                        "Frames handled by the master, by request "
                        "kind", ("kind",)).labels(k))
        req_counter.get().inc()
        with self.lock:
            if kind == "hello":
                slave_id = self._next_slave
                self._next_slave += 1
                lease = secrets.token_hex(8)
                codec = self._negotiate_codec(
                    slave_id, request[1],
                    request[2] if len(request) > 2 else None)
                self.slaves[slave_id] = {
                    "name": request[1], "jobs": 0, "lease": lease,
                    "codec": codec,
                    # job_id -> {trace, wall, perf} of the serve
                    # moment: the fencing set AND the per-hop latency
                    # anchor (wire round-trip = update arrival - wall)
                    "outstanding": {},
                    "last_seen": time.monotonic(),
                    "last_rtt_s": None, "last_job_s": None,
                    "last_wire_s": None}
                self._count_fault("joins")
                self._set_slaves_gauge()
                telemetry.record_event("slave_joined", slave=slave_id,
                                       name=str(request[1]),
                                       codec=codec)
                self.info("slave %d (%s) joined, lease %s, codec %s",
                          slave_id, request[1], lease, codec)
                # a 2-tuple hello is a pre-codec peer: it gets the
                # 3-tuple welcome it can unpack (absence == "none").
                # A codec-aware hello ALWAYS earns the 4-tuple (codec
                # possibly "none"): its presence is how the slave
                # learns this master speaks the out-of-band frame
                # format — a 3-tuple back means an OLD master, and
                # the slave pins its own sends to legacy frames
                if len(request) < 3:
                    return ("welcome", slave_id, lease)
                if codec == "topk":
                    # master config wins for the sparsity level too:
                    # K rides the welcome so a slave started with a
                    # different --grad-topk-percent cannot silently
                    # ship a different fraction of delta entries
                    return ("welcome", slave_id, lease, codec,
                            self.grad_topk_percent)
                return ("welcome", slave_id, lease, codec)
            if kind == "ping":
                _, info = self._live_slave(request)
                if info is None:
                    self._count_fault("stale_pings")
                    return ("stale",)
                return ("pong", self.epoch)
            if kind == "job":
                if self.done.is_set():
                    return ("bye",)
                t_serve = time.perf_counter()
                slave_id, info = self._live_slave(request)
                if info is None:
                    # never-helloed or dropped: serving it a job would
                    # leak work onto a revoked lease — make it re-sync
                    self._count_fault("stale_jobs")
                    return ("stale",)
                # cheap emptiness check BEFORE serializing weight
                # payloads — idle slaves poll here every 20ms
                if not self.workflow.loader._pending_jobs:
                    self._advance_epoch()
                    if self.done.is_set():
                        return ("bye",)
                    return ("wait",)
                job = self.registry.generate_job(slave_id)
                if job.get(self.workflow.loader.name) is None:
                    return ("wait",)
                job_id = self._next_job
                self._next_job += 1
                info["jobs"] += 1
                # one trace per minibatch job: every hop (dispatch /
                # wire / slave phases / merge) tags its span with this
                # context, so the merged dump reads as one timeline
                ctx = telemetry.TraceContext.new()
                info["outstanding"][job_id] = {
                    "trace": ctx, "wall": time.time(),
                    "perf": t_serve}
                if telemetry.tracer.active:
                    telemetry.tracer.add_complete(
                        "job.dispatch", t_serve,
                        time.perf_counter() - t_serve,
                        job_id=job_id, epoch=self.epoch,
                        slave=slave_id, **ctx.span_args())
                return ("job", job, job_id, self.epoch,
                        ctx.to_wire())
            if kind == "update":
                slave_id, info = self._live_slave(request)
                if len(request) < 6:       # pre-lease protocol frame
                    self._count_fault("fenced_updates")
                    return ("stale",)
                job_id, epoch, data = request[3], request[4], request[5]
                if info is None or job_id not in info["outstanding"] \
                        or epoch != self.epoch:
                    # fence: revoked lease (drop_slave already
                    # requeued this minibatch — merging would double-
                    # count it), duplicated frame (job_id already
                    # consumed) or a stale epoch
                    self._count_fault("fenced_updates")
                    self.warning(
                        "fenced update from slave %s (job %s, epoch "
                        "%s)", slave_id, job_id, epoch)
                    return ("stale",)
                served = info["outstanding"].pop(job_id)
                # slave-pushed telemetry counter state rides the update
                # frame under a reserved key: pop BEFORE the unit merge
                # (it is not a unit payload). One scrape of the master
                # then shows the whole cluster, each slave's series
                # tagged slave="<id>".
                tele = data.pop("__telemetry__", None) \
                    if isinstance(data, dict) else None
                job_seconds = None
                if tele:
                    self._absorb_telemetry(tele, slave_id)
                    job_seconds = tele.get("job_seconds")
                    spans = tele.get("spans")
                    if spans:
                        # the slave's per-phase spans, wall-anchored:
                        # merged here they complete the job's causal
                        # timeline in THIS process's dump/ring
                        telemetry.tracer.absorb_remote(
                            spans,
                            process_name="slave:%s" % info["name"])
                # per-hop latency attribution: round-trip measured
                # here, slave compute self-reported, wire = the rest
                rtt = time.time() - served["wall"]
                info["last_rtt_s"] = rtt
                wire = None
                if isinstance(job_seconds, (int, float)):
                    wire = max(rtt - float(job_seconds), 0.0)
                    info["last_job_s"] = float(job_seconds)
                    info["last_wire_s"] = wire
                ctx = served["trace"]
                t_merge = time.perf_counter()
                # merge under the job's trace context: any log line
                # the merge emits joins the distributed trace (the
                # JSONL sink stamps trace_id/span_id)
                with telemetry.context(ctx):
                    merged = self.registry.apply_update(data, slave_id)
                if self._weight_guard is not None and merged:
                    # post-merge model-health tick: stash the weights
                    # while healthy, restore them the moment the
                    # verdict (fed by the per-unit wire non-finite
                    # scan during the merge above) flips to diverged
                    self._weight_guard.tick()
                if telemetry.tracer.active:
                    if wire is not None:
                        telemetry.tracer.add_complete(
                            "job.wire", served["perf"], wire,
                            job_id=job_id, slave=slave_id,
                            **ctx.child().span_args())
                    telemetry.tracer.add_complete(
                        "job.merge", t_merge,
                        time.perf_counter() - t_merge, job_id=job_id,
                        slave=slave_id, merged=bool(merged),
                        **ctx.child().span_args())
                if not merged and data:
                    # the payload named no unit of this workflow — a
                    # config-mismatched peer silently burning jobs is
                    # a degradation the run owner must hear about
                    self._count_fault("unmerged_updates")
                    self.warning(
                        "update from slave %s named no unit of this "
                        "workflow (%d keys) — config mismatch?",
                        slave_id, len(data))
                return ("ok",)
        return ("error", "unknown request %r" % (kind,))

    def _advance_epoch(self):
        loader = self.workflow.loader
        if loader._pending_jobs or any(loader._inflight.values()):
            return
        self.epoch += 1
        if self.epoch >= self.max_epochs:
            self.done.set()
            self._stop_serving.set()
            return
        loader.master_start_epoch()
        # epoch boundaries are the natural consistency points: wake
        # the persist loop (writing here, under the request lock,
        # would stall every slave for the store round-trip)
        self._persist_event.set()

    def drop_slave(self, slave_id, clean=False):
        """Revoke ``slave_id``'s lease and requeue its in-flight
        minibatches — the connection-death hook (framed_server
        ``on_drop``) and the liveness bound's teeth. ``clean`` marks a
        polite bye after a completed run: deregistration only, not a
        fault (the counters must measure degradation, not goodbyes)."""
        with self.lock:
            if slave_id not in self.slaves:
                return
            requeued = self.registry.drop_slave(slave_id)
            del self.slaves[slave_id]
            self.workflow.grad_codec_by_slave.pop(slave_id, None)
            self._set_slaves_gauge()
            # evict its absorbed model-health summary + the
            # slave="N"-labelled gauge children: a departed slave's
            # last-known stats must not read as current forever
            from veles_torch import model_health
            model_health.get_model_monitor().evict_slave(slave_id)
            telemetry.record_event(
                "lease_revoked", slave=slave_id, clean=bool(clean),
                requeued=requeued)
            if clean and not requeued:
                self.info("slave %d left cleanly", slave_id)
                return
            self._count_fault("drops")
            if requeued:
                self._count_fault("requeued_jobs", requeued)
            self.info("slave %d dropped; %d job(s) requeued",
                      slave_id, requeued)

    def status(self):
        """Cluster topology snapshot for the dashboard: connected slaves with their served-job counts and lease
        liveness, master progress, plus the robustness counters."""
        now = time.monotonic()
        server = self._server
        # per-connection reply-queue depth (reactor backpressure):
        # read OUTSIDE self.lock — the depths are display-grade and
        # the server tracks sessions under its own small lock
        depths = server.write_queue_bytes() \
            if server is not None else {}
        with self.lock:
            slaves = {}
            for sid, info in self.slaves.items():
                row = {
                    "name": info["name"], "jobs": info["jobs"],
                    "codec": info.get("codec", "none"),
                    # prefix only: status.json is a dashboard surface,
                    # not a place to hand out whole fencing tokens
                    "lease": info["lease"][:6],
                    "outstanding": len(info["outstanding"]),
                    "write_queue_bytes": depths.get(sid, 0),
                    "idle_s": round(now - info["last_seen"], 3)}
                # last-job latency attribution (satellite: slow-slave
                # skew is visible on the dashboard without a trace
                # fetch): serve→merge round-trip, the slave's self-
                # reported compute, and the wire remainder
                for key in ("last_rtt_s", "last_job_s",
                            "last_wire_s"):
                    value = info.get(key)
                    row[key] = None if value is None \
                        else round(value, 4)
                slaves[str(sid)] = row
            return {
                "mode": "master",
                "epoch": self.epoch,
                "grad_codec": self.grad_codec,
                "max_epochs": self.max_epochs,
                "complete": self.done.is_set(),
                "slave_timeout": self.slave_timeout,
                "n_slaves": len(self.slaves),
                "slaves": slaves,
                "faults": dict(self.faults),
            }

    # -- socket plumbing ----------------------------------------------

    def serve_forever(self, poll=0.05):
        # the wire plane lives on the process's shared reactor:
        # accepting starts inside framed_server(), no per-connection
        # threads exist, and handle() runs on the loop (still under
        # self.lock — the same serialization the thread-per-connection
        # design had, minus the thread scheduling ceiling)
        with framed_server(self.address, self.handle, self.done,
                           self.drop_slave,
                           timeout=self.slave_timeout,
                           max_write_buffer=self.max_write_buffer,
                           on_overflow=self._on_backpressure) as server:
            self._server = server
            self.bound_address = server.server_address
            if self.checkpoint_store is not None:
                threading.Thread(target=self._persist_loop,
                                 daemon=True,
                                 name="master-persist").start()
            # poll BOTH events: done may be set directly (tests, the
            # drop-slave paths) without going through _advance_epoch
            while not self._stop_serving.is_set() \
                    and not self.done.is_set():
                self._stop_serving.wait(0.05)
            self._stop_serving.set()
            # final persist — the ONLY one on the request_stop
            # (SIGTERM preemption) path, and for a COMPLETED run it
            # leaves the store reflecting epoch == max_epochs so a
            # restart resumes straight to done instead of re-running
            # the last epoch
            self.persist_state("shutdown")
            if self.done.is_set() and self.drain_timeout:
                # completed runs only (an ABORTED master's slaves must
                # keep retrying, never hear bye): hold the listener up
                # so every straggler — mid-compute, mid-backoff — gets
                # its ("bye",) instead of a dead address to retry
                # forever under max_retries=None
                # no early exit on "no slaves registered": the drain
                # exists for exactly the slave the master CANNOT see —
                # mid-backoff or not-yet-connected (the straggler
                # test's contract) — so an empty lease table proves
                # nothing and the full window must be held
                deadline = time.monotonic() + self.drain_timeout
                while time.monotonic() < deadline:
                    time.sleep(poll)
            server.shutdown()
        return self

    def start_background(self):
        """Serve on a daemon thread (tests, co-located master)."""
        import time
        thread = threading.Thread(target=self.serve_forever, daemon=True)
        thread.start()
        for _ in range(500):
            if hasattr(self, "bound_address"):
                return thread
            if not thread.is_alive():
                break
            time.sleep(0.01)
        raise RuntimeError("master server failed to start")
