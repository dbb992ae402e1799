"""Deterministic fault injection for the port's master/slave wire and
its stores.

The port's own copy of ``veles/chaos.py``; the tests' fault injectors:

* :func:`poison_update` writes NaN or inf into one delta of a generated
  update payload (what a blown-up slave ships upstream);
  :func:`truncate_blob`, :func:`flip_bit` and
  :func:`corrupt_store_entry` damage checkpoint blobs;
* :class:`ChaosProxy` is a TCP proxy between a
  :class:`~veles_torch.client.SlaveClient` and a
  :class:`~veles_torch.server.MasterServer` that mutates traffic at
  FRAME granularity (the 4-byte length + 32-byte HMAC + pickle framing
  of ``server.py``). Every decision comes from an explicit ``plan``
  callable (exact frames: "duplicate the 2nd update on connection 0")
  or a per-(connection, direction) PRNG seeded from ``seed``, never
  from the wall clock or thread scheduling. Actions: ``pass``, ``drop``,
  ``dup``, ``delay``, ``truncate`` (a partial frame, then the
  connection severed); :meth:`ChaosProxy.kill_all` severs every live
  connection; the proxy peeks inside frames so plans target "the update
  frame", not "frame #7";
* :class:`BrownoutProxy` degrades a byte stream (an HTTP port): latency
  per chunk, a black hole, or severed connections.
"""

import random
import socket
import struct
import threading
import time

import numpy

from veles_torch.logger import Logger
from veles_torch.server import _recv_exact, decode_frame_payload


# -- checkpoint/blob corruption (the disk-side fault models) -----------


def poison_update(update, mode="nan", layer=None, key=None):
    """The model-divergence fault: poison ONE delta array
    of a generated update payload IN PLACE — the first float array of
    the first (sorted) unit section, or the named ``layer``/``key`` —
    by writing NaN/inf into its element 0. What a blown-up or
    bit-flipped slave ships upstream; the master's wire non-finite
    scan (``apply_data_from_slave`` →
    ``model_health.note_wire_nonfinite``) must catch it, fire the
    divergence SLO and trigger the rollback actuator.

    -> ``(unit_name, entry_key)`` of what was poisoned. Raises
    ValueError when the payload holds no poisonable float array (a
    test asking to poison an eval-only update must fail loudly, not
    silently pass a clean payload through)."""
    bad = float("nan") if mode == "nan" else float("inf")
    for uname in sorted(update):
        if layer is not None and uname != layer:
            continue
        payload = update[uname]
        if not isinstance(payload, dict):
            continue
        for entry in sorted(payload):
            if key is not None and entry != key:
                continue
            value = payload[entry]
            if isinstance(value, numpy.ndarray) \
                    and value.dtype.kind == "f" and value.size:
                # .flat writes through ANY memory layout; a
                # reshape(-1) assignment would land in a silent COPY
                # for non-contiguous arrays and the injection would
                # claim success against a clean payload
                value.flat[0] = bad
                return uname, entry
    raise ValueError(
        "no poisonable float delta in update payload (units: %s)"
        % sorted(update))


def truncate_blob(blob, frac=0.5):
    """The mid-write host death: keep the leading ``frac`` of the
    bytes (at least 1). A gzip/npz cut anywhere in the middle must
    read back as :class:`~veles_torch.snapshotter.CorruptCheckpointError`,
    never as a shorter-but-plausible checkpoint."""
    return bytes(blob[:max(1, int(len(blob) * frac))])


def flip_bit(blob, index=None, bit=0, seed=0):
    """The bit-rot fault: flip ONE bit, deterministically (seeded
    offset by default, exact ``index`` when given), so manifest
    verification — not compression luck — is what catches it."""
    data = bytearray(blob)
    if index is None:
        # stay away from the very start: corrupting the magic bytes
        # tests the container parser, not the sha256 manifest
        index = random.Random(seed).randrange(len(data) // 4,
                                              len(data))
    data[index] ^= 1 << (bit & 7)
    return bytes(data)


def corrupt_store_entry(store, name, mode="truncate", **kwargs):
    """Damage a stored checkpoint IN PLACE through the store's own
    put/get (works for any SnapshotStore backend): ``mode`` is
    ``truncate`` or ``bitflip``."""
    raw = store.get(name)
    if mode == "truncate":
        damaged = truncate_blob(raw, **kwargs)
    elif mode == "bitflip":
        damaged = flip_bit(raw, **kwargs)
    else:
        raise ValueError("mode must be truncate|bitflip, not %r"
                         % (mode,))
    store.put(name, damaged)
    return damaged

PASS = "pass"
DROP = "drop"
DUP = "dup"
DELAY = "delay"
TRUNCATE = "truncate"

ACTIONS = (PASS, DROP, DUP, DELAY, TRUNCATE)

#: client→server / server→client direction tags handed to plans
C2S = "c2s"
S2C = "s2c"


class ChaosEvent:
    """What the plan sees for one frame."""

    __slots__ = ("direction", "conn_id", "index", "kind", "nth")

    def __init__(self, direction, conn_id, index, kind, nth):
        self.direction = direction   # C2S | S2C
        self.conn_id = conn_id       # accept order, 0-based
        self.index = index           # frame number in this direction
        self.kind = kind             # request/response tuple tag
        self.nth = nth               # occurrence number of this kind

    def __repr__(self):
        return ("ChaosEvent(%s conn=%d #%d kind=%r nth=%d)"
                % (self.direction, self.conn_id, self.index,
                   self.kind, self.nth))


class _Pump(threading.Thread):
    """One direction of one proxied connection."""

    def __init__(self, proxy, src, dst, direction, conn_id):
        super().__init__(daemon=True,
                         name="chaos-%s-%d" % (direction, conn_id))
        self.proxy = proxy
        self.src = src
        self.dst = dst
        self.direction = direction
        self.conn_id = conn_id
        # schedule determinism: the rng depends only on (seed,
        # conn_id, direction), never on which pump thread ran first
        self.rng = random.Random(
            (proxy.seed, conn_id, direction).__repr__())
        self.index = 0
        self.kind_counts = {}

    def run(self):
        try:
            while not self.proxy._closing.is_set():
                header = _recv_exact(self.src, 4)
                if header is None:
                    break
                size, = struct.unpack(">I", header)
                tag = _recv_exact(self.src, 32)
                blob = _recv_exact(self.src, size) \
                    if tag is not None else None
                if blob is None:
                    break
                if not self._relay(header, tag, blob):
                    break
        except OSError:
            pass
        finally:
            self.proxy._sever(self.conn_id)

    def _relay(self, header, tag, blob):
        kind = self._peek(blob)
        nth = self.kind_counts[kind] = self.kind_counts.get(kind, 0) + 1
        event = ChaosEvent(self.direction, self.conn_id, self.index,
                           kind, nth)
        self.index += 1
        action = self.proxy._decide(event, self.rng)
        self.proxy._count(self.direction, action)
        frame = header + tag + blob
        if action == DROP:
            self.proxy.debug("drop %r", event)
            return True
        if action == TRUNCATE:
            self.proxy.debug("truncate %r", event)
            try:
                self.dst.sendall(frame[:max(5, len(frame) // 2)])
            except OSError:
                pass
            return False               # sever the connection
        if action == DELAY:
            time.sleep(self.proxy.delay_s)
        try:
            self.dst.sendall(frame)
            if action == DUP:
                self.proxy.debug("dup %r", event)
                self.dst.sendall(frame)
        except OSError:
            return False
        return True

    def _peek(self, blob):
        # frames are our own HMAC-verified-shape payloads on loopback
        # (bare pickle OR the out-of-band buffer format — the shared
        # decoder handles both); surface the protocol tag so plans can
        # target by meaning
        try:
            obj = decode_frame_payload(blob)
            return obj[0] if isinstance(obj, tuple) and obj else None
        except Exception:
            return None


class ChaosProxy(Logger):
    """``ChaosProxy(("127.0.0.1", master_port), seed=7, drop_rate=.02)``
    then point slaves at ``"127.0.0.1:%d" % proxy.port``.

    ``plan(event) -> action|None`` wins when it returns an action;
    ``None`` falls through to the seeded rates (cumulative
    drop/dup/delay/truncate probabilities per frame)."""

    def __init__(self, target, seed=0, plan=None, drop_rate=0.0,
                 dup_rate=0.0, delay_rate=0.0, delay_s=0.05,
                 truncate_rate=0.0, listen_host="127.0.0.1"):
        self.name = "ChaosProxy"
        host, _, port = str(target).rpartition(":") \
            if isinstance(target, str) else (target[0], ":", target[1])
        self.target = (host or "127.0.0.1", int(port))
        self.seed = seed
        self.plan = plan
        self.drop_rate = float(drop_rate)
        self.dup_rate = float(dup_rate)
        self.delay_rate = float(delay_rate)
        self.delay_s = float(delay_s)
        self.truncate_rate = float(truncate_rate)
        self._lock = threading.Lock()
        self._stats = {C2S: dict.fromkeys(ACTIONS, 0),
                       S2C: dict.fromkeys(ACTIONS, 0)}
        self._conns = {}              # conn_id -> (client, upstream)
        self._next_conn = 0
        self._closing = threading.Event()
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen()
        self.port = self._listener.getsockname()[1]
        self.address = "%s:%d" % (listen_host, self.port)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="chaos-accept")
        self._accept_thread.start()

    # -- wiring --------------------------------------------------------

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                break
            try:
                upstream = socket.create_connection(self.target,
                                                    timeout=10)
            except OSError as exc:
                self.warning("upstream %s unreachable: %s",
                             self.target, exc)
                client.close()
                continue
            with self._lock:
                conn_id = self._next_conn
                self._next_conn += 1
                self._conns[conn_id] = (client, upstream)
            _Pump(self, client, upstream, C2S, conn_id).start()
            _Pump(self, upstream, client, S2C, conn_id).start()

    def _sever(self, conn_id):
        with self._lock:
            pair = self._conns.pop(conn_id, None)
        if pair:
            for sock in pair:
                try:
                    sock.close()
                except OSError:
                    pass

    # -- chaos ---------------------------------------------------------

    def _decide(self, event, rng):
        if self.plan is not None:
            action = self.plan(event)
            if action is not None:
                if action not in ACTIONS:
                    raise ValueError("plan returned %r (want one of "
                                     "%s)" % (action, ACTIONS))
                return action
        r = rng.random()
        for rate, action in ((self.drop_rate, DROP),
                             (self.dup_rate, DUP),
                             (self.delay_rate, DELAY),
                             (self.truncate_rate, TRUNCATE)):
            if r < rate:
                return action
            r -= rate
        return PASS

    def _count(self, direction, action):
        with self._lock:
            self._stats[direction][action] += 1

    # -- control / inspection ------------------------------------------

    def kill_all(self):
        """Sever every live connection NOW (abrupt whole-slave death:
        both peers see a reset mid-conversation, nobody sees a FIN
        handshake's politeness)."""
        with self._lock:
            conn_ids = list(self._conns)
        for conn_id in conn_ids:
            self._sever(conn_id)
        return len(conn_ids)

    def stats(self):
        with self._lock:
            return {"connections": self._next_conn,
                    "live": len(self._conns),
                    C2S: dict(self._stats[C2S]),
                    S2C: dict(self._stats[S2C])}

    def faults_injected(self):
        s = self.stats()
        return sum(s[d][a] for d in (C2S, S2C)
                   for a in (DROP, DUP, DELAY, TRUNCATE))

    def close(self):
        self._closing.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.kill_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- HTTP-aware brownouts -----------------------------------


class _Pipe(threading.Thread):
    """One direction of one BrownoutProxy connection: copy bytes,
    applying whatever degradation the proxy currently orders."""

    def __init__(self, proxy, src, dst, direction, conn_id):
        super().__init__(daemon=True,
                         name="brownout-%s-%d" % (direction, conn_id))
        self.proxy = proxy
        self.src = src
        self.dst = dst
        self.direction = direction
        self.conn_id = conn_id

    def run(self):
        try:
            while not self.proxy._closing.is_set():
                data = self.src.recv(65536)
                if not data:
                    break
                delay = self.proxy.latency_s
                if delay > 0:
                    time.sleep(delay)
                if self.proxy.black_hole:
                    self.proxy._count_pipe(self.direction, len(data),
                                           swallowed=True)
                    continue
                self.dst.sendall(data)
                self.proxy._count_pipe(self.direction, len(data))
        except OSError:
            pass
        finally:
            self.proxy._sever(self.conn_id)


class BrownoutProxy(Logger):
    """Byte-level TCP degradation proxy for the HTTP planes.

    :class:`ChaosProxy` speaks the framed master↔slave wire protocol;
    this sibling is FRAME-AGNOSTIC — it forwards raw bytes, so it can
    sit in front of a serving replica's (or router's) HTTP port and
    brown it out deterministically:

    * :meth:`brownout` — inject ``latency_s`` seconds before every
      forwarded read (both directions): probes and proxied requests
      through this target slow to a crawl, exactly the
      sick-but-not-dead replica a router must eject on scrape
      timeout rather than wait out;
    * :meth:`set_black_hole` — swallow bytes entirely (connections
      stay open, nothing ever answers — the wedged-process model);
    * :meth:`restore` — back to a transparent pipe;
    * :meth:`kill_all` — sever every live connection now.

    All knobs are plain attribute flips read by the pump threads per
    chunk, so a test can flip a healthy fleet into brownout (and
    back) mid-scenario without touching the replica itself."""

    def __init__(self, target, listen_host="127.0.0.1"):
        self.name = "BrownoutProxy"
        if isinstance(target, str):
            # accept URL form too ('http://host:port' — the shape
            # router/fleet targets and this proxy's own .url use)
            target = target.split("://", 1)[-1].rstrip("/")
            host, _, port = target.rpartition(":")
        else:
            host, port = target[0], target[1]
        self.target = (host or "127.0.0.1", int(port))
        #: per-chunk forwarding delay (seconds); pump threads read it
        self.latency_s = 0.0
        #: True -> swallow all bytes (connections wedge silently)
        self.black_hole = False
        self._lock = threading.Lock()
        self._stats = {C2S: {"bytes": 0, "swallowed": 0},
                       S2C: {"bytes": 0, "swallowed": 0}}
        self._conns = {}
        self._next_conn = 0
        self._closing = threading.Event()
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((listen_host, 0))
        self._listener.listen()
        self.port = self._listener.getsockname()[1]
        self.address = "%s:%d" % (listen_host, self.port)
        self.url = "http://%s" % self.address
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="brownout-accept")
        self._accept_thread.start()

    # -- control -------------------------------------------------------

    def brownout(self, latency_s):
        """Inject ``latency_s`` seconds per forwarded chunk."""
        self.latency_s = float(latency_s)
        return self

    def set_black_hole(self, on=True):
        """Swallow (True) or forward (False) all traffic."""
        self.black_hole = bool(on)
        return self

    def restore(self):
        """Back to a transparent pipe (latency 0, forwarding on)."""
        self.latency_s = 0.0
        self.black_hole = False
        return self

    # -- wiring --------------------------------------------------------

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                break
            try:
                upstream = socket.create_connection(self.target,
                                                    timeout=10)
            except OSError as exc:
                self.warning("upstream %s unreachable: %s",
                             self.target, exc)
                client.close()
                continue
            # the connect timeout must not become a recv timeout: a
            # black-holed connection has to WEDGE indefinitely (the
            # documented model), not sever itself after 10s
            upstream.settimeout(None)
            with self._lock:
                conn_id = self._next_conn
                self._next_conn += 1
                self._conns[conn_id] = (client, upstream)
            _Pipe(self, client, upstream, C2S, conn_id).start()
            _Pipe(self, upstream, client, S2C, conn_id).start()

    def _sever(self, conn_id):
        with self._lock:
            pair = self._conns.pop(conn_id, None)
        if pair:
            for sock in pair:
                try:
                    sock.close()
                except OSError:
                    pass

    def _count_pipe(self, direction, n, swallowed=False):
        with self._lock:
            stats = self._stats[direction]
            stats["swallowed" if swallowed else "bytes"] += n

    # -- control / inspection ------------------------------------------

    def kill_all(self):
        """Sever every live proxied connection now."""
        with self._lock:
            conn_ids = list(self._conns)
        for conn_id in conn_ids:
            self._sever(conn_id)
        return len(conn_ids)

    def stats(self):
        with self._lock:
            return {"connections": self._next_conn,
                    "live": len(self._conns),
                    C2S: dict(self._stats[C2S]),
                    S2C: dict(self._stats[S2C])}

    def close(self):
        self._closing.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.kill_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
