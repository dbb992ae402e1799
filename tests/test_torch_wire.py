"""The port's frames (``veles_torch/server.py``) against the reference's
(``veles/server.py``): ``_frame_parts`` of the same object gives the same
bytes in both packages, each package's ``recv_frame`` reads the other's
``send_frame`` over a socketpair (both frame formats), a bad HMAC tag
and an oversized length header are refused before anything is
unpickled, and ``require_secret_for`` refuses a non-loopback endpoint
while ``$VELES_CLUSTER_SECRET`` is unset."""

import hashlib
import hmac
import socket
import struct
import threading
import types

import numpy
import pytest

from tests.torch_cluster import close_process_planes  # noqa: F401
from veles import server as J
from veles_torch import server as T
from veles_torch import telemetry as ttelemetry

OBJECTS = {
    "hello": ("hello", "slave-1", "int8"),
    "ack": ("ok",),
    "job": ("job", {"loader": (2, list(range(50))),
                    "GDTanh": {"weights": numpy.arange(
                        12, dtype=numpy.float32).reshape(3, 4),
                        "bias": numpy.ones(4, numpy.float32)}},
            7, 1, "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"),
    "update": ("update", 3, "abcd", 7, 1,
               {"GDSoftmax": {"dweights": {
                   "__codec__": "int8", "dtype": "float32",
                   "scale": 0.25, "zero": -1.0,
                   "data": numpy.arange(6, dtype=numpy.uint8)}},
                "__telemetry__": {"token": "t", "job_seconds": 0.01}}),
    "empty_array": ("x", numpy.zeros((0, 3), numpy.float32)),
}


@pytest.fixture(autouse=True)
def port_telemetry_isolation():
    with ttelemetry.scoped():
        yield


def _same(a, b):
    if isinstance(a, numpy.ndarray):
        return isinstance(b, numpy.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) \
            and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_constants_are_the_references():
    assert T._FRAME_MAGIC == J._FRAME_MAGIC
    assert T.MAX_FRAME_BYTES == J.MAX_FRAME_BYTES
    assert T._FRAME_OVERHEAD == J._FRAME_OVERHEAD
    assert T._REQUEST_KINDS == J._REQUEST_KINDS
    assert T._secret() == J._secret()


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_frame_parts_are_the_same_bytes(name):
    obj = OBJECTS[name]
    pt, pj = T._frame_parts(obj), J._frame_parts(obj)
    assert [bytes(p) for p in pt] == [bytes(p) for p in pj]
    assert _same(T.decode_frame_payload(b"".join(bytes(p) for p in pj)),
                 obj)


@pytest.mark.parametrize("legacy", [False, True], ids=["oob", "legacy"])
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_each_package_reads_the_others_frames(name, direction, legacy):
    sender, receiver = (T, J) if direction == "port_to_ref" else (J, T)
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=sender.send_frame,
                             args=(a, OBJECTS[name], legacy))
        t.start()
        got = receiver.recv_frame(b)
        t.join(timeout=10)
    finally:
        a.close()
        b.close()
    assert _same(got, OBJECTS[name])


def test_bad_hmac_is_refused_before_unpickling():
    blob = b"".join(bytes(p) for p in T._frame_parts(("ping", 1, "x")))
    tag = hmac.new(b"some-other-cluster", blob, hashlib.sha256).digest()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", len(blob)) + tag + blob)
        with pytest.raises(ConnectionError, match="HMAC"):
            T.recv_frame(b)
    finally:
        a.close()
        b.close()


def test_oversized_header_is_refused_before_allocation():
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", T.MAX_FRAME_BYTES + 1))
        with pytest.raises(ConnectionError, match="cap"):
            T.recv_frame(b)
        a.sendall(struct.pack(">I", T.MAX_FRAME_BYTES + 1))
        with pytest.raises(ConnectionError, match="cap"):
            T.recv_raw_frame(b)
    finally:
        a.close()
        b.close()


def test_garbled_out_of_band_header_is_refused():
    blob = T._FRAME_MAGIC + struct.pack(">II", 2, 5) + b"\x00" * 3
    with pytest.raises(ConnectionError):
        T.decode_frame_payload(blob)


def test_raw_frames_round_trip():
    a, b = socket.socketpair()
    try:
        T.send_raw_frame(a, b"plot-bytes")
        assert T.recv_raw_frame(b) == b"plot-bytes"
        a.close()
        assert T.recv_raw_frame(b) is None
    finally:
        b.close()


def test_require_secret_for(monkeypatch):
    monkeypatch.delenv("VELES_CLUSTER_SECRET", raising=False)
    for host in ("127.0.0.1", "localhost", "::1"):
        T.require_secret_for(host, "master listen")
    with pytest.raises(RuntimeError, match="VELES_CLUSTER_SECRET"):
        T.require_secret_for("10.0.0.5", "master listen")
    # the master refuses before it binds anything
    with pytest.raises(RuntimeError, match="VELES_CLUSTER_SECRET"):
        T.MasterServer(types.SimpleNamespace(), "0.0.0.0:0")
    monkeypatch.setenv("VELES_CLUSTER_SECRET", "s3cret")
    T.require_secret_for("10.0.0.5", "master listen")


def test_request_kind_counter_is_bounded():
    for kind in T._REQUEST_KINDS:
        assert T._resolve_request_kind(kind) == kind
    for bad in ("jailbreak", "job2", b"\xff" * 64, None):
        assert T._resolve_request_kind(bad) == "other"


def test_wire_bytes_are_counted_by_direction():
    a, b = socket.socketpair()
    try:
        T.send_frame(a, OBJECTS["job"])
        T.recv_frame(b)
    finally:
        a.close()
        b.close()
    reg = ttelemetry.get_registry()
    tx = reg.counter_total("veles_wire_bytes_total", direction="tx")
    rx = reg.counter_total("veles_wire_bytes_total", direction="rx")
    size = sum(len(p) for p in T._frame_parts(OBJECTS["job"]))
    assert tx == rx == size + T._FRAME_OVERHEAD
