"""Graphics pipeline of the PyTorch port: plot frames streamed to a
renderer process.

Counterpart of ``veles/graphics.py``, with the same wire: a frame is an
npz of the plot's arrays plus a ``__meta__`` JSON entry (no pickle, so
the renderer never deserializes executable content), sent over
localhost TCP with a 4-byte big-endian length prefix. Either package's
renderer draws either package's frames.

:class:`GraphicsServer` listens on a free localhost port, spawns the
port's renderer (``python -m veles_torch.graphics_client --connect PORT
--out DIR``) and waits up to ``connect_timeout`` seconds for it to
connect; :meth:`GraphicsServer.publish` is fire-and-forget: a frame is
dropped (and counted) when no renderer is attached, the pipe broke, or
the renderer stays ``send_timeout`` seconds behind, and training never
stalls on a plot. :meth:`GraphicsServer.close` ends the stream and waits
for the renderer to draw what it has and exit.

The framing is the wire's raw framing (``server.py``'s
``send_raw_frame`` / ``recv_raw_frame``: the length cap checked before
anything is allocated, exact receives), exported here as
:func:`send_frame` / :func:`recv_frame`.
"""

import io
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time

import numpy

from veles_torch.server import (  # noqa: F401 (read by the renderer)
    MAX_FRAME_BYTES, recv_raw_frame as recv_frame,
    send_raw_frame as send_frame)

logger = logging.getLogger("veles_torch.graphics")


def pack_payload(meta, arrays):
    """(meta dict, {name: ndarray}) -> npz frame bytes."""
    buf = io.BytesIO()
    numpy.savez_compressed(
        buf, __meta__=numpy.frombuffer(
            json.dumps(meta).encode(), numpy.uint8), **arrays)
    return buf.getvalue()


def unpack_payload(blob):
    """npz frame bytes -> (meta dict, {name: ndarray})."""
    with numpy.load(io.BytesIO(blob), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


class GraphicsServer:
    """Accepts one renderer connection and streams plot frames to it.
    ``spawn_client=False`` leaves the renderer to the caller (any
    renderer that speaks the wire, e.g. the reference's)."""

    #: seconds :meth:`publish` may block in the kernel's send buffer;
    #: past that the renderer loses the feed (a timed-out send leaves a
    #: half frame on the wire)
    send_timeout = 5.0
    #: seconds the constructor waits for a spawned renderer to connect
    #: (less if it exits first)
    connect_timeout = 30.0

    def __init__(self, out_dir, spawn_client=True, name="graphics"):
        self.name = name
        self.out_dir = out_dir
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.port = self._listener.getsockname()[1]
        self._conn = None
        self._lock = threading.Lock()
        self._connected = threading.Event()
        #: frames dropped so far
        self.dropped = 0
        self.client = None
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True, name="%s-accept" % name)
        self._accept_thread.start()
        if spawn_client:
            self.client = subprocess.Popen(
                [sys.executable, "-m", "veles_torch.graphics_client",
                 "--connect", str(self.port), "--out", out_dir],
                stdout=subprocess.DEVNULL, env=_client_env())
            deadline = time.monotonic() + self.connect_timeout
            while not self._connected.wait(0.05):
                if self.client.poll() is not None \
                        or time.monotonic() > deadline:
                    logger.warning(
                        "%s: the renderer did not connect (exit code %s) — "
                        "plot frames are dropped", name, self.client.poll())
                    break

    def _accept(self):
        try:
            conn, _ = self._listener.accept()
        except OSError:
            return      # closed before anyone connected
        conn.settimeout(self.send_timeout)
        with self._lock:
            self._conn = conn
        self._connected.set()

    def publish(self, meta, arrays):
        """Send one plot; -> True when it went out, False when it was
        dropped."""
        if self._conn is None:
            self.dropped += 1
            return False
        blob = pack_payload(meta, arrays)
        with self._lock:
            conn = self._conn
            if conn is None:
                self.dropped += 1
                return False
            try:
                send_frame(conn, blob)
                return True
            except OSError:
                self.dropped += 1
                self._conn = None
                conn.close()
                logger.warning("%s: renderer lost (%d frame(s) dropped so "
                               "far)", self.name, self.dropped)
                return False

    def close(self):
        """End the stream; a spawned renderer gets 30 s to draw what it
        received and exit, then is killed."""
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                self._conn.close()
                self._conn = None
        self._listener.close()
        if self.client is not None:
            try:
                self.client.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.client.kill()
                self.client.wait()


def _client_env():
    """The environment of the renderer: this package importable from
    wherever the run started."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    return env
