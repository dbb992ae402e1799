"""Single-threaded selector reactor of the port: the event loop under its
HTTP planes.

The port's own copy of ``veles/reactor.py`` (it imports nothing of the
JAX package). ONE daemon loop thread per process owns every
non-blocking socket through a :mod:`selectors` selector:

* :class:`Reactor` — the loop: readiness dispatch, a timer heap
  (``call_later``/``every``) and a thread-safe ``call_soon`` handoff (a
  wakeup socketpair);
* :class:`Connection` — one non-blocking socket: incremental reads and
  a per-connection bounded WRITE QUEUE; a reader that lets it grow past
  ``max_write_buffer`` is dropped with a counted fault, so a stalled
  client never blocks the loop or other connections;
* :class:`HttpServer` / :class:`HttpConnection` — a minimal HTTP/1.1
  surface on the loop: probe and metrics routes answer inline from
  cached state, routes that must block (``/v1/predict`` parking in the
  micro-batcher) go to a worker thread through ``HttpRequest.defer`` and
  reply through ``call_soon``. Chunked transfer-encoding
  (``HttpRequest.begin_stream`` -> :class:`HttpStream`) carries the
  per-token ``/v1/generate`` stream through the same bounded write
  queue, with an ``on_close`` hook telling the producer to stop.

Code running on the loop never blocks (no socket ``recv``/``sendall``,
``time.sleep``, ``Event.wait``, ``urlopen``): anything that parks the
loop parks every connection and every probe with it. Device work, the
health monitor's checks and blocking routes stay off the loop.

Instruments: ``veles_reactor_loop_lag_seconds``,
``veles_reactor_connections`` and ``veles_reactor_overflow_drops_total``.
"""

import collections
import heapq
import json
import selectors
import socket
import threading
import time

from veles_torch import telemetry
from veles_torch.logger import Logger

#: per-connection write-queue cap (bytes) before the peer is declared
#: a dead reader and dropped: several full MNIST-scale weight
#: broadcasts, far above anything a healthy consumer accumulates
DEFAULT_MAX_WRITE_BUFFER = 64 << 20

#: bytes one connection may consume per readable event before the
#: loop moves on — keeps a firehose peer from starving the others
#: (the selector is level-triggered, so the remainder re-fires)
READ_BUDGET = 1 << 18

_G_LAG = telemetry.LazyChild(lambda: telemetry.gauge(
    "veles_reactor_loop_lag_seconds",
    "How late the reactor fired its periodic lag probe — sustained "
    "lag means a callback is blocking the shared loop"))
_G_CONNS = telemetry.LazyChild(lambda: telemetry.gauge(
    "veles_reactor_connections",
    "Sockets currently owned by the reactor loop"))
_C_OVERFLOW = telemetry.LazyChild(lambda: telemetry.counter(
    "veles_reactor_overflow_drops_total",
    "Connections dropped because their bounded write queue exceeded "
    "max_write_buffer (slow/stalled reader)"))


class Timer:
    """Handle for one scheduled callback; ``interval`` re-arms it."""

    __slots__ = ("due", "interval", "fn", "args", "cancelled")

    def __init__(self, due, fn, args, interval=None):
        self.due = due
        self.fn = fn
        self.args = args
        self.interval = interval
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


class Reactor(Logger):
    """The loop. One per process (see :func:`get_reactor`); servers
    register sockets, timers and ``call_soon`` thunks on it."""

    #: cadence of the self-lag probe (also the idle select timeout cap)
    LAG_PROBE_INTERVAL = 0.25

    def __init__(self, name="reactor"):
        self.name = name
        self._selector = selectors.DefaultSelector()
        self._soon = collections.deque()
        self._timers = []               # heap of (due, seq, Timer)
        self._seq = 0
        self._lock = threading.Lock()   # thread start + seq
        self._thread = None
        self._tid = None
        self._stopped = False
        self._n_conns = 0
        #: seconds the last lag probe fired behind schedule — the
        #: loop's own self-measurement (exported as the loop-lag
        #: gauge). A WEDGED loop cannot update this, so readiness
        #: checks must read :meth:`current_lag`, not this attribute.
        self.loop_lag_s = 0.0
        #: monotonic time the lag probe last fired (any-thread read)
        self.last_probe = time.monotonic()
        # wakeup channel: call_soon from another thread writes one
        # byte so a parked select() returns immediately
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ,
                                _Waker(self._wake_r))

    # -- lifecycle -----------------------------------------------------

    def ensure_started(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stopped = False
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name=self.name)
                self._thread.start()
        return self

    @property
    def alive(self):
        thread = self._thread
        return thread is not None and thread.is_alive()

    def in_loop(self):
        return threading.get_ident() == self._tid

    def current_lag(self):
        """Loop lag as observable from ANY thread: the loop's own
        last self-measurement — or, when the loop is wedged behind a
        blocking callback and cannot even run its probe, how overdue
        that probe is. Readiness checks must use this, never
        ``loop_lag_s`` alone (a frozen loop holds its last near-zero
        value forever)."""
        overdue = time.monotonic() - self.last_probe \
            - self.LAG_PROBE_INTERVAL
        return max(self.loop_lag_s, overdue, 0.0)

    def stop(self):
        """Stop the loop thread (tests); registered sockets are NOT
        closed — their owners hold them."""
        self._stopped = True
        self._wakeup()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)

    # -- scheduling (thread-safe) --------------------------------------

    def call_soon(self, fn, *args):
        """Run ``fn(*args)`` on the loop as soon as possible. The ONE
        correct way for another thread to touch loop-owned state."""
        self._soon.append((fn, args))
        self._wakeup()

    def call_later(self, delay, fn, *args):
        """Run ``fn(*args)`` on the loop after ``delay`` seconds;
        -> cancellable :class:`Timer`."""
        timer = Timer(time.monotonic() + max(delay, 0.0), fn, args)
        self._push_timer(timer)
        return timer

    def every(self, interval, fn, *args):
        """Run ``fn(*args)`` on the loop every ``interval`` seconds
        (re-armed AFTER each firing — no overlap); -> :class:`Timer`."""
        interval = max(float(interval), 1e-3)
        timer = Timer(time.monotonic() + interval, fn, args,
                      interval=interval)
        self._push_timer(timer)
        return timer

    def post(self, fn, *args):
        """Run ``fn`` now when already on the loop, else hand it off
        via :meth:`call_soon` (the reply path worker threads use)."""
        if self.in_loop():
            fn(*args)
        else:
            self.call_soon(fn, *args)

    def _push_timer(self, timer):
        if self.in_loop():
            self._seq += 1
            heapq.heappush(self._timers, (timer.due, self._seq, timer))
        else:
            self.call_soon(self._push_timer, timer)

    def _wakeup(self):
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, InterruptedError):
            pass                # a full pipe already guarantees wakeup
        except OSError:
            pass                # reactor being torn down

    # -- socket registration (loop thread only) ------------------------

    def register(self, sock, events, handler):
        self._selector.register(sock, events, handler)

    def modify(self, sock, events, handler):
        self._selector.modify(sock, events, handler)

    def unregister(self, sock):
        try:
            self._selector.unregister(sock)
        except (KeyError, ValueError):
            pass

    def add_acceptor(self, sock, factory):
        """Register a LISTENING socket: ``factory(conn_sock, addr)``
        runs on the loop per accepted connection. Thread-safe (defers
        to the loop); the kernel backlog holds early connects."""
        acceptor = _Acceptor(self, sock, factory)
        self.post(self.register, sock, selectors.EVENT_READ, acceptor)
        return acceptor

    def _conn_opened(self):
        self._n_conns += 1
        _G_CONNS.get().set(self._n_conns)

    def _conn_closed(self):
        self._n_conns -= 1
        _G_CONNS.get().set(self._n_conns)

    # -- the loop ------------------------------------------------------

    def _run(self):
        self._tid = threading.get_ident()
        self.last_probe = time.monotonic()
        lag_due = self.last_probe + self.LAG_PROBE_INTERVAL
        while not self._stopped:
            now = time.monotonic()
            if now >= lag_due:
                # the probe is the lag INSTRUMENT: how far behind
                # schedule the loop is running right now
                self.loop_lag_s = now - lag_due
                self.last_probe = now
                _G_LAG.get().set(self.loop_lag_s)
                lag_due = now + self.LAG_PROBE_INTERVAL
            timeout = lag_due - now
            if self._timers:
                timeout = min(timeout,
                              max(self._timers[0][0] - now, 0.0))
            if self._soon:
                timeout = 0.0
            try:
                events = self._selector.select(timeout)
            except OSError:
                # a socket closed out from under the selector between
                # callbacks: retry — unregister already happened
                continue
            for key, mask in events:
                handler = key.data
                try:
                    if mask & selectors.EVENT_READ:
                        handler.on_readable()
                    if mask & selectors.EVENT_WRITE:
                        handler.on_writable()
                except Exception as exc:
                    # a callback must never kill the shared loop
                    self.warning("reactor handler %r failed: %s: %s",
                                 handler, type(exc).__name__, exc)
                    closer = getattr(handler, "close", None)
                    if closer is not None:
                        try:
                            closer(reason="handler error: %s" % exc)
                        except Exception:
                            pass
            self._fire_timers()
            self._drain_soon()
        self._tid = None

    def _fire_timers(self):
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            _, _, timer = heapq.heappop(self._timers)
            if timer.cancelled:
                continue
            lag = now - timer.due
            if lag > self.loop_lag_s:
                self.loop_lag_s = lag
                _G_LAG.get().set(lag)
            try:
                timer.fn(*timer.args)
            except Exception as exc:
                self.warning("reactor timer %r failed: %s: %s",
                             timer.fn, type(exc).__name__, exc)
            if timer.interval is not None and not timer.cancelled:
                timer.due = time.monotonic() + timer.interval
                self._seq += 1
                heapq.heappush(self._timers,
                               (timer.due, self._seq, timer))

    def _drain_soon(self):
        # bounded batch: a callback that re-posts itself must not
        # starve socket readiness forever
        for _ in range(len(self._soon)):
            try:
                fn, args = self._soon.popleft()
            except IndexError:
                return
            try:
                fn(*args)
            except Exception as exc:
                self.warning("call_soon %r failed: %s: %s", fn,
                             type(exc).__name__, exc)


class _Waker:
    """Drains the wakeup socketpair (the bytes only exist to unpark
    ``select``)."""

    __slots__ = ("_sock",)

    def __init__(self, sock):
        self._sock = sock

    def on_readable(self):
        try:
            while self._sock.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass


class _Acceptor:
    """Readiness handler for one listening socket."""

    __slots__ = ("reactor", "sock", "factory", "closed")

    def __init__(self, reactor, sock, factory):
        self.reactor = reactor
        self.sock = sock
        self.factory = factory
        self.closed = False

    def on_readable(self):
        for _ in range(64):             # accept bursts, stay fair
            try:
                sock, addr = self.sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return                  # listener closed under us
            sock.setblocking(False)
            try:
                self.factory(sock, addr)
            except Exception as exc:
                # a failing factory costs THIS connection only: the
                # error must never escape to the loop's handler-error
                # recovery, which would close() this acceptor and
                # silently stop the listener forever
                self.reactor.warning(
                    "accept factory failed for %s: %s: %s", addr,
                    type(exc).__name__, exc)
                try:
                    sock.close()
                except OSError:
                    pass

    def close(self, reason=None):
        if self.closed:
            return
        self.closed = True
        self.reactor.unregister(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass


class Connection:
    """One non-blocking socket owned by the reactor.

    Subclasses implement ``data_received(bytes)`` (or override
    :meth:`on_readable` for zero-copy assembly) and ``on_closed``.
    All methods are LOOP-THREAD ONLY unless stated otherwise."""

    CHUNK = 1 << 16

    def __init__(self, reactor, sock, max_write_buffer=None):
        sock.setblocking(False)
        try:
            # request/response frames must not wait out Nagle; no-op
            # for non-TCP sockets (tests use socketpairs)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.reactor = reactor
        self.sock = sock
        self.max_write_buffer = max_write_buffer \
            or DEFAULT_MAX_WRITE_BUFFER
        self._wq = collections.deque()
        #: queued-but-unsent bytes — read (racily, for display) by
        #: status surfaces on other threads; written on the loop only
        self.write_queued = 0
        self.closed = False
        self.close_reason = None
        self._events = selectors.EVENT_READ
        self._close_when_drained = False
        self.last_recv = time.monotonic()
        reactor.register(sock, self._events, self)
        reactor._conn_opened()

    # -- reading -------------------------------------------------------

    def on_readable(self):
        budget = READ_BUDGET
        while budget > 0 and not self.closed:
            try:
                data = self.sock.recv(min(self.CHUNK, budget))
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
            self.data_received(data)

    def data_received(self, data):
        raise NotImplementedError

    # -- writing -------------------------------------------------------

    def send_parts(self, parts):
        """Write a sequence of bytes-like parts, in order, without
        ever blocking: an optimistic direct ``send`` while the queue
        is empty (the common case — no copy), then the REMAINDER is
        copied into the bounded queue. The copy is deliberate: queued
        buffers may alias live arrays (weight broadcasts) that the
        very next merge mutates, and a queued view would then ship
        corrupt bytes under an already-computed HMAC."""
        if self.closed:
            return
        parts = [memoryview(p).cast("B") for p in parts]
        i = 0
        if not self._wq:
            try:
                while i < len(parts):
                    sent = self.sock.send(parts[i])
                    if sent < len(parts[i]):
                        parts[i] = parts[i][sent:]
                        break
                    i += 1
            except (BlockingIOError, InterruptedError):
                pass
            except OSError as exc:
                self.close(reason="send: %s" % exc)
                return
        if i >= len(parts):
            return
        for part in parts[i:]:
            blob = bytes(part)
            self._wq.append(memoryview(blob))
            self.write_queued += len(blob)
        if self.write_queued > self.max_write_buffer:
            _C_OVERFLOW.get().inc()
            self.close(reason="overflow")
            return
        self._want_write(True)

    def on_writable(self):
        while self._wq and not self.closed:
            buf = self._wq[0]
            try:
                sent = self.sock.send(buf)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self.close(reason="send: %s" % exc)
                return
            self.write_queued -= sent
            if sent == len(buf):
                self._wq.popleft()
            else:
                self._wq[0] = buf[sent:]
                return
        if not self._wq:
            self._want_write(False)
            if self._close_when_drained:
                self.close(reason="drained")

    def close_when_drained(self):
        """Close once the write queue empties (polite goodbyes)."""
        if not self._wq:
            self.close(reason="drained")
        else:
            self._close_when_drained = True

    def _want_write(self, want):
        events = selectors.EVENT_READ \
            | (selectors.EVENT_WRITE if want else 0)
        if events != self._events and not self.closed:
            self._events = events
            self.reactor.modify(self.sock, events, self)

    # -- teardown ------------------------------------------------------

    def close(self, reason=None):
        if self.closed:
            return
        self.closed = True
        self.close_reason = reason
        self.reactor.unregister(self.sock)
        try:
            self.sock.close()
        except OSError:
            pass
        self._wq.clear()
        self.write_queued = 0
        self.reactor._conn_closed()
        try:
            self.on_closed(reason)
        except Exception:
            pass

    def on_closed(self, reason):
        pass


class ListeningServer(Logger):
    """Shared listener plumbing for reactor-hosted servers: bind +
    listen + (deferrable) acceptor registration, tracked connections,
    and the cross-thread teardown dance — one implementation for the
    framed wire plane and the HTTP plane. Subclasses implement
    ``build_connection(sock, addr)`` (loop thread)."""

    def __init__(self, address, name="listener", reactor=None,
                 start=True):
        self.name = name
        self.reactor = reactor or get_reactor()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(address)
        sock.listen(128)
        sock.setblocking(False)
        self.socket = sock
        self.server_address = sock.getsockname()
        self._conns = set()
        self._conns_lock = threading.Lock()
        self._acceptor = None
        self._closed = False
        if start:
            self.start()

    def start(self):
        """Register the acceptor on the loop (``start=False`` defers
        this so a caller can finish wiring state the connections
        read — the port is already bound, the kernel backlog holds
        early connects)."""
        if self._acceptor is None and not self._closed:
            self._acceptor = self.reactor.add_acceptor(
                self.socket, self._accept)
        return self

    def build_connection(self, sock, addr):
        raise NotImplementedError

    def _accept(self, sock, addr):
        conn = self.build_connection(sock, addr)
        if conn is not None:
            with self._conns_lock:
                self._conns.add(conn)

    def untrack(self, conn):
        with self._conns_lock:
            self._conns.discard(conn)

    def connections(self):
        with self._conns_lock:
            return list(self._conns)

    @property
    def accepting(self):
        """True while the listener can still accept — False once
        closed OR if the acceptor was torn down out-of-band (the
        readiness checks read this)."""
        acceptor = self._acceptor
        return not self._closed and acceptor is not None \
            and not acceptor.closed

    def on_close_loop(self):
        """Loop-thread hook run during close, before connections are
        severed (cancel timers etc.)."""

    def close(self):
        """Unregister + close listener and live connections; safe
        from any thread, idempotent."""
        if self._closed:
            return
        self._closed = True
        done = threading.Event()

        def on_loop():
            if self._acceptor is not None:
                self._acceptor.close()
            else:
                try:
                    self.socket.close()
                except OSError:
                    pass
            self.on_close_loop()
            for conn in self.connections():
                conn.close(reason="server closed")
            with self._conns_lock:
                self._conns.clear()
            done.set()

        if self.reactor.in_loop():
            on_loop()
        else:
            self.reactor.call_soon(on_loop)
            if not self.reactor.alive:
                on_loop()               # no loop left: tear down inline
            done.wait(2.0)


# -- HTTP on the loop ---------------------------------------------------

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}

#: request head cap: probe/metrics/predict requests are small; a peer
#: streaming an unbounded header is attacking, not probing
MAX_HTTP_HEAD = 1 << 16
MAX_HTTP_BODY = 64 << 20


class HttpRequest:
    """One parsed request + the reply surface handed to routes.

    ``reply*`` may be called from ANY thread (worker handoff): the
    response write is posted back onto the loop."""

    __slots__ = ("conn", "method", "path", "headers", "body")

    def __init__(self, conn, method, path, headers, body):
        self.conn = conn
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body

    @property
    def remote_addr(self):
        """``host:port`` of the requesting peer (what a proxy tier
        writes into ``X-Forwarded-For``), or None for non-INET
        sockets (tests use socketpairs)."""
        peer = getattr(self.conn, "peer", None)
        if isinstance(peer, tuple) and len(peer) >= 2:
            return "%s:%s" % (peer[0], peer[1])
        return None

    def reply(self, code, body, ctype="text/plain", headers=()):
        if isinstance(body, str):
            body = body.encode()
        self.conn.reactor.post(
            self.conn.send_response, code, body, ctype, tuple(headers))

    def reply_json(self, code, doc, headers=()):
        self.reply(code, json.dumps(doc).encode(),
                   "application/json", headers)

    def begin_stream(self, code, ctype="application/x-ndjson",
                     headers=(), on_close=None):
        """Start a chunked (``Transfer-Encoding: chunked``) response;
        -> :class:`HttpStream` whose ``write``/``end`` may be called
        from ANY thread (each chunk is posted onto the loop and rides
        the connection's bounded write queue — a stalled reader
        overflows it and is dropped like any other dead peer).
        ``on_close(reason)`` fires ON THE LOOP if the connection dies
        BEFORE :meth:`HttpStream.end` (client disconnect, write-queue
        overflow) — the producer's cue to stop generating; it must
        not block."""
        conn = self.conn
        conn.reactor.post(conn.start_stream, code, ctype,
                          tuple(headers), on_close)
        return HttpStream(conn)

    def defer(self, fn, *args):
        """Run ``fn(*args)`` on a fresh worker thread — the escape
        hatch for routes that must block (predict parking in the
        micro-batcher, dashboard provider pulls). ``fn`` replies via
        this request; an exception becomes a 500."""
        def run():
            try:
                fn(*args)
            except Exception as exc:
                self.reply_json(500, {"error": "%s: %s"
                                      % (type(exc).__name__, exc)})
        threading.Thread(target=run, daemon=True,
                         name="http-worker").start()


class HttpStream:
    """Thread-safe handle for one in-flight chunked response (see
    :meth:`HttpRequest.begin_stream`). Writes after the peer dropped
    are silently discarded — the producer learns of the death through
    the ``on_close`` callback (or by reading :attr:`closed`)."""

    __slots__ = ("conn",)

    def __init__(self, conn):
        self.conn = conn

    @property
    def closed(self):
        return self.conn.closed

    def write(self, data):
        """Queue one chunk (bytes or str)."""
        if isinstance(data, str):
            data = data.encode()
        if data:
            self.conn.reactor.post(self.conn.send_chunk, data)

    def end(self):
        """Terminal chunk + drain + close (the normal finish — the
        ``on_close`` callback does NOT fire for it)."""
        self.conn.reactor.post(self.conn.finish_stream)


class HttpConnection(Connection):
    """Incremental HTTP/1.1 request parsing on the loop; one request
    per connection (every response carries ``Connection: close`` —
    probes and scrapes open fresh connections anyway)."""

    def __init__(self, reactor, sock, handler, server=None):
        self._handler = handler
        self._server = server
        try:
            #: peer address as accepted — read by HttpRequest.remote_addr
            self.peer = sock.getpeername()
        except OSError:
            self.peer = None
        self._buf = bytearray()
        self._head = None               # (method, path, headers)
        self._need_body = 0
        self._dispatched = False
        #: fires on close while a chunked response is mid-stream —
        #: cleared by finish_stream, so a NORMAL end never reports a
        #: disconnect (see HttpRequest.begin_stream)
        self._stream_on_close = None
        super().__init__(reactor, sock)

    def on_closed(self, reason):
        if self._server is not None:
            self._server.untrack(self)
        cb = self._stream_on_close
        self._stream_on_close = None
        if cb is not None:
            try:
                cb(reason)
            except Exception:
                pass

    def data_received(self, data):
        if self._dispatched:
            return                      # one request per connection
        self._buf += data
        if self._head is None:
            end = self._buf.find(b"\r\n\r\n")
            if end < 0:
                if len(self._buf) > MAX_HTTP_HEAD:
                    self.close(reason="oversized request head")
                return
            try:
                head = bytes(self._buf[:end]).decode("latin-1")
                del self._buf[:end + 4]
                lines = head.split("\r\n")
                method, path, _version = lines[0].split(" ", 2)
                headers = {}
                for line in lines[1:]:
                    key, _, value = line.partition(":")
                    headers[key.strip().lower()] = value.strip()
                # inside the guard: a garbled/negative Content-Length
                # must answer 400, not leak a ValueError that tears
                # the connection down with no HTTP response
                need = int(headers.get("content-length") or 0)
                if need < 0:
                    raise ValueError("negative content-length")
            except ValueError:
                self.send_response(400, b'{"error": "bad request"}',
                                   "application/json", ())
                return
            self._head = (method.upper(), path, headers)
            self._need_body = need
            if self._need_body > MAX_HTTP_BODY:
                self.close(reason="oversized request body")
                return
        if len(self._buf) < self._need_body:
            return
        method, path, headers = self._head
        body = bytes(self._buf[:self._need_body])
        self._dispatched = True
        request = HttpRequest(self, method, path, headers, body)
        try:
            self._handler(request)
        except Exception as exc:
            request.reply_json(500, {"error": "%s: %s"
                                     % (type(exc).__name__, exc)})

    def send_response(self, code, body, ctype, headers):
        if self.closed:
            return
        head = ["HTTP/1.1 %d %s" % (code, _REASONS.get(code, "OK")),
                "Content-Type: %s" % ctype,
                "Content-Length: %d" % len(body),
                "Connection: close"]
        head.extend("%s: %s" % kv for kv in headers)
        self.send_parts([("\r\n".join(head) + "\r\n\r\n").encode(),
                         body])
        self.close_when_drained()

    # -- chunked streaming (loop thread; posted via HttpStream) --------

    def start_stream(self, code, ctype, headers, on_close):
        """Response head for a chunked-transfer body (streaming
        decode). No Content-Length — chunks follow until
        finish_stream's terminal chunk."""
        if self.closed:
            # born dead: tell the producer immediately
            if on_close is not None:
                try:
                    on_close(self.close_reason or "closed")
                except Exception:
                    pass
            return
        self._stream_on_close = on_close
        head = ["HTTP/1.1 %d %s" % (code, _REASONS.get(code, "OK")),
                "Content-Type: %s" % ctype,
                "Transfer-Encoding: chunked",
                "Connection: close"]
        head.extend("%s: %s" % kv for kv in headers)
        self.send_parts([("\r\n".join(head) + "\r\n\r\n").encode()])

    def send_chunk(self, data):
        if self.closed or not data:
            return
        self.send_parts([b"%x\r\n" % len(data), data, b"\r\n"])

    def finish_stream(self):
        if self.closed:
            return
        # deliberate end: the close that follows is NOT a disconnect
        self._stream_on_close = None
        self.send_parts([b"0\r\n\r\n"])
        self.close_when_drained()


class HttpServer(ListeningServer):
    """An HTTP listener on the shared reactor. ``handler(request)``
    runs ON THE LOOP — it must reply inline from cached state or
    ``request.defer`` to a worker thread."""

    def __init__(self, host, port, handler, name="http",
                 reactor=None, start=True):
        self._handler = handler
        super().__init__((host, port), name=name, reactor=reactor,
                         start=start)
        self.host, self.port = self.server_address[:2]

    def build_connection(self, sock, _addr):
        return HttpConnection(self.reactor, sock, self._handler,
                              server=self)


# -- process-wide reactor plumbing --------------------------------------

_active_lock = threading.Lock()
_active = None


def get_reactor() -> Reactor:
    """The process's shared loop, created and started on first use —
    the master's wire plane, web-status and the serving frontend all
    register on this one instance."""
    global _active
    with _active_lock:
        if _active is None:
            _active = Reactor()
        reactor = _active
    return reactor.ensure_started()


def peek_reactor():
    """The active reactor WITHOUT creating or starting one — for
    health checks that must OBSERVE the loop, not resurrect it (a
    readiness check that ensure_started()s as a side effect could
    never report a dead loop)."""
    with _active_lock:
        return _active


def set_reactor(reactor):
    """Swap the active reactor (-> the previous one, NOT stopped)."""
    global _active
    with _active_lock:
        previous = _active
        _active = reactor
    return previous
