"""The port's reactor (veles_torch/reactor.py) against the JAX
package's (veles/reactor.py): a chunked HTTP stream written from a
worker thread reaches a raw-socket client chunk for chunk in both, and a
stalled reader of a stream is disconnected at the write-queue bound in
both: the producer's ``on_close`` hears ``overflow`` and
``veles_reactor_overflow_drops_total`` counts it."""

import socket
import threading
import time

import pytest

from veles import reactor as JR
from veles import telemetry as JT
from veles_torch import reactor as TR
from veles_torch import telemetry as TT

PACKAGES = [(JR, JT), (TR, TT)]


def _read_chunks(sock):
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += sock.recv(4096)
    head, buf = buf.split(b"\r\n\r\n", 1)
    chunks = []
    while True:
        while b"\r\n" not in buf:
            buf += sock.recv(4096)
        size_s, buf = buf.split(b"\r\n", 1)
        size = int(size_s, 16)
        if size == 0:
            return head, chunks
        while len(buf) < size + 2:
            buf += sock.recv(4096)
        chunks.append(buf[:size])
        buf = buf[size + 2:]


@pytest.mark.parametrize("pkg", PACKAGES, ids=["ref", "port"])
def test_chunked_stream_from_a_worker_thread(pkg):
    reactor, _ = pkg
    closes = []

    def route(request):
        def work():
            stream = request.begin_stream(200, on_close=closes.append)
            for i in range(5):
                stream.write('{"token": %d}\n' % i)
            stream.end()
        request.defer(work)

    server = reactor.HttpServer("127.0.0.1", 0, route, name="t-stream")
    try:
        sock = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=10)
        try:
            sock.sendall(b"POST /s HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: 0\r\n\r\n")
            head, chunks = _read_chunks(sock)
        finally:
            sock.close()
        assert b"transfer-encoding: chunked" in head.lower()
        assert chunks == [b'{"token": %d}\n' % i for i in range(5)]
        time.sleep(0.05)
        assert closes == []          # a normal end is no disconnect
    finally:
        server.close()


def test_stalled_reader_is_dropped_at_the_bound_in_both():
    reasons = {}
    for tag, (reactor, telemetry) in zip(("ref", "port"), PACKAGES):
        with telemetry.scoped() as reg:
            closed = threading.Event()
            seen = []

            def route(request, seen=seen, closed=closed):
                request.conn.max_write_buffer = 1 << 16

                def on_close(reason):
                    seen.append(reason)
                    closed.set()

                def work():
                    stream = request.begin_stream(200, on_close=on_close)
                    chunk = b"x" * 8192
                    deadline = time.time() + 20
                    while not closed.is_set() and time.time() < deadline:
                        stream.write(chunk)
                        time.sleep(0.0005)
                request.defer(work)

            server = reactor.HttpServer("127.0.0.1", 0, route,
                                        name="t-stall")
            sock = socket.socket()
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            try:
                sock.connect(("127.0.0.1", server.port))
                sock.sendall(b"POST /s HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Length: 0\r\n\r\n")
                # never read: the reply queue must hit the bound
                assert closed.wait(20)
            finally:
                sock.close()
                server.close()
            reasons[tag] = (seen[0], reg.counter_total(
                "veles_reactor_overflow_drops_total"))
    assert reasons["ref"] == reasons["port"] == ("overflow", 1)
