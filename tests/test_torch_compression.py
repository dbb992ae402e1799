"""The port's gradient wire codecs (``veles_torch/compression.py``)
against the reference's (``veles/compression.py``) on the same arrays:
every codec's ``encode_update`` over 3 rounds (the error-feedback
residuals included), ``encode_broadcast`` and ``decode`` give the same
payloads bit for bit; each package decodes the other's payloads; and the
legacy-frame negotiations of ``tests/test_compression.py`` hold for the
port's master and slave."""

import pickle
import socket
import struct
import threading

import numpy
import pytest

from tests.torch_cluster import BOUND, port_wf
from tests.torch_cluster import close_process_planes  # noqa: F401
from tests.torch_monitor import port_model_health_isolation  # noqa: F401
from veles import compression as J
from veles_torch import compression as T
from veles_torch import telemetry as ttelemetry
from veles_torch.client import SlaveClient
from veles_torch.server import MasterServer, _recv_exact, send_frame

CODECS = ("bf16", "int8", "topk")
SHAPES = [(), (1,), (7,), (3, 4), (2, 3, 5), (100, 10)]


@pytest.fixture(autouse=True)
def port_telemetry_isolation():
    with ttelemetry.scoped():
        yield


def _arrays(shape, seed):
    """Deltas with the edge cases the codecs treat specially: ties of
    magnitude (top-k's order), values at bf16 rounding midpoints, and
    one NaN and one inf where there is room."""
    rng = numpy.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(numpy.float32)
    flat = a.reshape(-1)
    if flat.size >= 4:
        flat[1] = -flat[0]                 # a magnitude tie
        flat[2] = numpy.float32(1.0 + 2.0 ** -8)   # an RNE midpoint
    if flat.size >= 7:
        flat[5] = numpy.nan
        flat[6] = numpy.inf
    return a


def _same(x, y):
    """Payloads equal bit for bit: arrays by dtype, shape and bytes,
    dicts key by key, scalars by value."""
    if isinstance(x, numpy.ndarray) or isinstance(y, numpy.ndarray):
        x, y = numpy.asarray(x), numpy.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape \
            and x.tobytes() == y.tobytes()
    if isinstance(x, dict):
        return isinstance(y, dict) and set(x) == set(y) \
            and all(_same(x[k], y[k]) for k in x)
    return type(x) is type(y) and (x == y or (x != x and y != y))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_encode_update_three_rounds_bit_for_bit(codec, shape):
    """Three rounds of the same key: the residual each round leaves
    folds into the next, in both packages alike."""
    j, t = J.get_codec(codec, 25.0), T.get_codec(codec, 25.0)
    for r in range(3):
        a = _arrays(shape, 10 * r + len(shape))
        pj, pt = j.encode_update("u/w", a), t.encode_update("u/w", a)
        assert _same(pj, pt), (r, pj, pt)
        assert set(j._residual) == set(t._residual)
        for k in j._residual:
            assert _same(j._residual[k], t._residual[k])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_encode_broadcast_and_decode_bit_for_bit(codec, shape):
    a = _arrays(shape, 7)
    pj = J.get_codec(codec).encode_broadcast("u/w", a)
    pt = T.get_codec(codec).encode_broadcast("u/w", a)
    assert _same(pj, pt)
    assert _same(J.decode(pj), T.decode(pt))


@pytest.mark.parametrize("codec", CODECS)
def test_each_package_decodes_the_others_payloads(codec):
    a = _arrays((9, 5), 3)
    for enc, dec in ((J, T), (T, J)):
        c = enc.get_codec(codec, 10.0)
        for payload in (c.encode_update("k", a), c.encode_broadcast("k", a)):
            # over the wire a payload is a pickle of plain data
            wire = pickle.loads(pickle.dumps(payload, protocol=5))
            assert _same(dec.decode(wire), enc.decode(payload))


def test_names_none_and_unknown_codecs():
    assert T.CODEC_NAMES == J.CODEC_NAMES
    assert T.TAG == J.TAG
    assert T.get_codec("none") is None
    raw = numpy.arange(4, dtype=numpy.float32)
    assert T.decode(raw) is raw
    with pytest.raises(KeyError, match="unknown grad codec"):
        T.get_codec("zstd")
    with pytest.raises(ValueError, match="unknown grad codec"):
        T.decode({T.TAG: "zstd"})


def test_codec_counters_show_the_shrink():
    c = T.get_codec("int8")
    c.encode_update("k", numpy.ones((64, 64), numpy.float32))
    reg = ttelemetry.get_registry()
    raw = reg.counter_total("veles_grad_codec_raw_bytes_total",
                            codec="int8")
    enc = reg.counter_total("veles_grad_codec_encoded_bytes_total",
                            codec="int8")
    assert raw == 64 * 64 * 4 and enc == 64 * 64


def _old_recv_frame(sock):
    """What a pre-out-of-band peer does: pickle.loads over the whole
    authenticated payload."""
    header = _recv_exact(sock, 4)
    size, = struct.unpack(">I", header)
    _recv_exact(sock, 32)
    return pickle.loads(_recv_exact(sock, size))


def test_old_slave_gets_legacy_frames_from_port_master():
    """A pre-codec slave (2-tuple hello, monolithic-pickle recv) reads
    every reply of a port master, the array-carrying job included, and
    the int8-wanting master falls back to uncompressed for it."""
    wf = port_wf("LegacyM", role="master")
    server = MasterServer(wf, "127.0.0.1:0", max_epochs=2,
                          grad_codec="int8", drain_timeout=0.1)
    thread = server.start_background()
    try:
        sock = socket.create_connection(server.bound_address, timeout=10)
        send_frame(sock, ("hello", "old-peer"), legacy=True)
        welcome = _old_recv_frame(sock)
        assert welcome[0] == "welcome" and len(welcome) == 3
        send_frame(sock, ("job", welcome[1], welcome[2]), legacy=True)
        resp = _old_recv_frame(sock)
        assert resp[0] == "job"
        units = [u for u in resp[1].values() if isinstance(u, dict)]
        values = [v for u in units for v in u.values()]
        assert any(isinstance(v, numpy.ndarray)
                   and v.dtype == numpy.float32 for v in values)
        assert not any(isinstance(v, dict) and T.TAG in v for v in values)
        assert server.faults["codec_fallbacks"] == 1
        sock.close()
    finally:
        server.done.set()
        thread.join(timeout=BOUND)


def test_port_slave_pins_legacy_frames_against_old_master():
    """An old master answers hello with a 3-tuple welcome in a
    monolithic frame: the port's client pins its own sends to legacy
    frames that master can read."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen()
    seen = {}

    def old_master():
        conn, _ = listener.accept()
        seen["hello"] = _old_recv_frame(conn)
        send_frame(conn, ("welcome", 1, "lease-x"), legacy=True)
        seen["next"] = _old_recv_frame(conn)
        conn.close()

    t = threading.Thread(target=old_master, daemon=True)
    t.start()
    wf = port_wf("LegacyS", role="slave")
    client = SlaveClient(wf, "127.0.0.1:%d" % listener.getsockname()[1],
                         io_timeout=10.0, grad_codec="int8",
                         ping_interval=0)
    client.connect()
    assert client._legacy_frames is True
    assert client._codec_active[0] == "none"
    try:
        client._roundtrip(("update", 1, "lease-x", 1, 0,
                           {"gd": {"dweights": numpy.ones(
                               8, numpy.float32)}}))
    except ConnectionError:
        pass                              # the old master hangs up
    t.join(timeout=BOUND)
    listener.close()
    client._close_sock()
    assert seen["hello"][2] == "int8"
    assert seen["next"][0] == "update"
