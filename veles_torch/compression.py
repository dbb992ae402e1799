"""Gradient wire codecs of the port: quantized and sparsified payloads.

The port's own copy of ``veles/compression.py``, numpy on the host as
the reference does it, so every payload comes out bit for bit the
reference's (top-k's tie order, bf16's rounding) and either package
decodes the other's. Deltas tolerate lossy compression when the
quantization error is fed back into the next update (1-bit SGD, Seide
et al. 2014; Deep Gradient Compression, Lin et al. 2018); the slave's
GD units ship ``current - basis`` (``znicz/nn_units.py``), which is the
hook point.

Codecs (negotiated at ``hello``, see ``server.py``; the codec is the
ENCODER's choice, decoding is always possible):

* ``none`` — passthrough;
* ``bf16`` — round-to-nearest-even bfloat16 both directions: 2x shrink,
  stateless;
* ``int8`` — per-tensor affine (min + scale) uint8 both directions: 4x
  shrink. UPDATE deltas carry an **error-feedback residual** on the
  encoder: each sync's quantization error is added into the next delta.
  Weight BROADCASTS are stateless: the master keeps canonical fp32
  weights, so broadcast error is fresh per job and never accumulates;
* ``topk`` — sparsified update deltas: only the largest-magnitude
  ``topk_percent``% of entries ship, as (indices, values); everything
  else accumulates in the residual. Weight broadcasts ride bf16.

Encoded payloads are SELF-DESCRIBING dicts (``{"__codec__": ...}``), so
:func:`decode` needs no negotiation state and raw ndarrays pass through
untouched.

Non-finite policy: UPDATE deltas ZERO non-finite entries on encode,
under every lossy codec, and keep them out of the residual. ``bf16``
weight BROADCASTS preserve inf and NaN (NaN canonicalized to the quiet
NaN 0x7FC0); ``int8`` broadcasts sanitize like updates.

Instruments: ``veles_grad_codec_{raw,encoded}_bytes_total{codec}`` and
``veles_grad_codec_{encode,decode}_seconds{codec}``; the frame-level
``veles_wire_bytes_total`` (``server.py``) shows the end result on the
wire.
"""

import time

import numpy

from veles_torch import telemetry

#: wire tag marking an encoded tensor payload (raw ndarrays have no
#: tag and pass through decode untouched)
TAG = "__codec__"


def _instruments(codec):
    """Per-codec LazyChild handles (the repo's hot-path convention —
    see _WIRE_TX in server.py): steady-state cost of a count is
    one int compare + the child op, no registry-lock family lookups
    per tensor."""
    return {
        "raw": telemetry.LazyChild(lambda: telemetry.counter(
            "veles_grad_codec_raw_bytes_total",
            "Tensor bytes entering the gradient wire codec "
            "(pre-encode)", ("codec",)).labels(codec)),
        "encoded": telemetry.LazyChild(lambda: telemetry.counter(
            "veles_grad_codec_encoded_bytes_total",
            "Tensor bytes leaving the gradient wire codec (what the "
            "frame actually carries)", ("codec",)).labels(codec)),
        "encode_s": telemetry.LazyChild(lambda: telemetry.histogram(
            "veles_grad_codec_encode_seconds",
            "Wall time of one tensor encode",
            ("codec",)).labels(codec)),
        "decode_s": telemetry.LazyChild(lambda: telemetry.histogram(
            "veles_grad_codec_decode_seconds",
            "Wall time of one tensor decode",
            ("codec",)).labels(codec)),
    }


_CODEC_STATS = {"bf16": _instruments("bf16"),
                "int8": _instruments("int8"),
                "topk": _instruments("topk")}


def _count_encode(codec, raw_bytes, encoded_bytes, seconds):
    stats = _CODEC_STATS[codec]
    stats["raw"].get().inc(raw_bytes)
    stats["encoded"].get().inc(encoded_bytes)
    stats["encode_s"].get().observe(seconds)


def _count_decode(codec, seconds):
    _CODEC_STATS[codec]["decode_s"].get().observe(seconds)


def _payload_nbytes(payload):
    """Tensor bytes a payload puts on the wire (ndarray parts only —
    the per-frame pickle/HMAC overhead is veles_wire_bytes_total's
    business)."""
    if isinstance(payload, numpy.ndarray):
        return payload.nbytes
    return sum(v.nbytes for v in payload.values()
               if isinstance(v, numpy.ndarray))


def _as_f32(arr):
    """Contiguous float32 view/copy that PRESERVES 0-d shapes
    (``ascontiguousarray`` alone promotes scalars to 1-d)."""
    a = numpy.asarray(arr, dtype=numpy.float32)
    if not a.flags["C_CONTIGUOUS"]:
        a = numpy.ascontiguousarray(a)
    return a


def _zero_nonfinite(a):
    mask = numpy.isfinite(a)
    if mask.all():
        return a
    return numpy.where(mask, a, numpy.float32(0.0))


# -- bf16 --------------------------------------------------------------


def _to_bf16(a):
    """float32 -> uint16 bfloat16 bits, round-to-nearest-even.

    Values past the bf16 max finite (3.39e38) round to inf, as RNE
    demands; NaNs are canonicalized to the quiet NaN 0x7FC0 (sign and
    payload dropped) because rounding could zero a NaN mantissa,
    which would read back as inf."""
    u = a.view(numpy.uint32).astype(numpy.uint64)
    u16 = ((u + 0x7FFF + ((u >> numpy.uint64(16)) & numpy.uint64(1)))
           >> numpy.uint64(16)).astype(numpy.uint16)
    nan = numpy.isnan(a)
    if nan.any():
        u16 = numpy.where(nan, numpy.uint16(0x7FC0), u16)
    return u16


def _from_bf16(u16, dtype):
    u = numpy.asarray(u16, numpy.uint16).astype(numpy.uint32) << 16
    return u.view(numpy.float32).astype(dtype, copy=False)


def _bf16_payload(a):
    return {TAG: "bf16", "dtype": "float32", "data": _to_bf16(a)}


# -- int8 --------------------------------------------------------------


def _int8_code(x, with_decoded=True):
    """Per-tensor affine quantization: ``q*scale + zero`` with
    ``zero = min(x)`` — a constant tensor round-trips EXACTLY
    (scale 0, everything rides the zero point). Range arithmetic in
    float64 so a worst-case float32 spread cannot overflow the
    scale."""
    a = x.astype(numpy.float64, copy=False)
    lo = float(a.min()) if a.size else 0.0
    hi = float(a.max()) if a.size else 0.0
    scale = (hi - lo) / 255.0
    if scale <= 0.0:
        scale = 0.0
        q = numpy.zeros(x.shape, numpy.uint8)
    else:
        q = numpy.clip(numpy.rint((a - lo) / scale), 0,
                       255).astype(numpy.uint8)
    payload = {TAG: "int8", "dtype": "float32", "scale": scale,
               "zero": lo, "data": q}
    if not with_decoded:
        return payload, None
    dec = (q.astype(numpy.float64) * scale + lo).astype(numpy.float32)
    return payload, dec


# -- codec classes -----------------------------------------------------


class GradCodec:
    """Stateful wire ENCODER: one instance per endpoint per peer (the
    slave holds one; the master holds one per slave, minted at hello).
    Decoding is stateless — module-level :func:`decode` dispatches on
    the payload's own tag."""

    name = None

    def __init__(self, topk_percent=1.0):
        self.topk_percent = float(topk_percent)
        #: key -> float32 ndarray of quantization error not yet
        #: shipped (error feedback). Slave-local ephemera by design: a
        #: restarted slave loses at most one sync's residual.
        self._residual = {}

    def encode_update(self, key, arr):
        """Encode one update DELTA tensor (slave -> master), folding
        in and refreshing ``key``'s error-feedback residual."""
        t0 = time.perf_counter()
        a = _as_f32(arr)
        payload = self._update(key, a)
        _count_encode(self.name, a.nbytes, _payload_nbytes(payload),
                      time.perf_counter() - t0)
        return payload

    def encode_broadcast(self, key, arr):
        """Encode one dense weight tensor (master -> slave).
        Stateless: the master's canonical weights stay fp32, so
        broadcast error is fresh per job and never accumulates."""
        t0 = time.perf_counter()
        a = _as_f32(arr)
        payload = self._broadcast(a)
        _count_encode(self.name, a.nbytes, _payload_nbytes(payload),
                      time.perf_counter() - t0)
        return payload

    def reset(self):
        self._residual.clear()

    def _fold_residual(self, key, a):
        r = self._residual.get(key)
        if r is not None and r.shape == a.shape:
            a = a + r
        return _zero_nonfinite(a)

    def _update(self, key, a):
        raise NotImplementedError

    def _broadcast(self, a):
        raise NotImplementedError


class Bf16Codec(GradCodec):
    """2x shrink, both directions; the worst-case relative error of
    one round-trip is 2^-8 ≈ 0.4% — small enough that no feedback
    state is kept (the "lossless-enough" baseline)."""

    name = "bf16"

    def _update(self, key, a):
        return _bf16_payload(_zero_nonfinite(a))

    def _broadcast(self, a):
        return _bf16_payload(a)


class Int8Codec(GradCodec):
    """4x shrink, both directions; update deltas are error-feedback
    compensated, broadcasts are stateless."""

    name = "int8"

    def _update(self, key, a):
        x = self._fold_residual(key, a)
        payload, dec = _int8_code(x)
        self._residual[key] = x - dec
        return payload

    def _broadcast(self, a):
        payload, _ = _int8_code(_zero_nonfinite(a), with_decoded=False)
        return payload


class TopKCodec(GradCodec):
    """Ship only the largest-magnitude ``topk_percent``% of delta
    entries as (flat indices, values); the rest accumulates in the
    residual and ships once it outranks the fresh delta mass
    (DGC-style). Dense weight broadcasts ride bf16."""

    name = "topk"

    def _update(self, key, a):
        x = self._fold_residual(key, a)
        flat = x.reshape(-1)
        k = max(1, int(round(flat.size * self.topk_percent / 100.0)))
        if k >= flat.size:
            idx = numpy.arange(flat.size, dtype=numpy.int64)
        else:
            idx = numpy.argpartition(numpy.abs(flat),
                                     flat.size - k)[flat.size - k:]
        vals = numpy.ascontiguousarray(flat[idx], numpy.float32)
        residual = x.copy()
        residual.reshape(-1)[idx] = 0.0
        self._residual[key] = residual
        idx_dtype = numpy.int32 \
            if flat.size <= numpy.iinfo(numpy.int32).max \
            else numpy.int64
        return {TAG: "topk", "dtype": "float32",
                "shape": tuple(int(s) for s in x.shape),
                "idx": numpy.ascontiguousarray(idx, idx_dtype),
                "val": vals}

    def _broadcast(self, a):
        return _bf16_payload(a)


#: codec name -> encoder class; ``none`` maps to no encoder at all so
#: the uncompressed hot path stays byte-identical to the pre-codec one
_CODECS = {"none": None, "bf16": Bf16Codec, "int8": Int8Codec,
           "topk": TopKCodec}

CODEC_NAMES = tuple(sorted(_CODECS))


def get_codec(name, topk_percent=1.0):
    """Instantiate the encoder for ``name`` — ``None`` for ``"none"``
    (passthrough needs no state); ``KeyError`` on unknown names, so a
    typo'd ``--grad-codec`` fails at configuration time, not at the
    first sync."""
    try:
        cls = _CODECS[name]
    except KeyError:
        raise KeyError("unknown grad codec %r (known: %s)"
                       % (name, ", ".join(CODEC_NAMES)))
    return None if cls is None else cls(topk_percent=topk_percent)


def decode(payload):
    """One wire tensor entry -> ndarray. Raw payloads (codec ``none``
    or a pre-codec peer) pass through untouched; the tag dict is
    self-describing, so no negotiation state is needed here."""
    if not (isinstance(payload, dict) and TAG in payload):
        return payload
    t0 = time.perf_counter()
    kind = payload[TAG]
    if kind == "bf16":
        out = _from_bf16(payload["data"],
                         payload.get("dtype", "float32"))
    elif kind == "int8":
        q = numpy.asarray(payload["data"]).astype(numpy.float64)
        out = (q * payload["scale"] + payload["zero"]).astype(
            payload.get("dtype", "float32"))
    elif kind == "topk":
        out = numpy.zeros(tuple(payload["shape"]),
                          payload.get("dtype", "float32"))
        out.reshape(-1)[numpy.asarray(payload["idx"])] = \
            numpy.asarray(payload["val"])
    else:
        raise ValueError("unknown grad codec payload %r" % (kind,))
    _count_decode(kind, time.perf_counter() - t0)
    return out
