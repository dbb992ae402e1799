"""Image decoding of the PyTorch port, with numpy and zlib only.

The reference decodes with Pillow (``veles/loader/image.py``); the card's
host has neither Pillow nor torchvision, so the port reads the files
itself and gives the same pixels:

* the format comes from the file's magic bytes, never its extension (as
  Pillow's): PNG (8-bit grey, RGB, grey+alpha, RGBA and palette,
  non-interlaced, every filter), binary PGM/PPM (``P5``/``P6``, maxval
  255) and uncompressed 24- and 32-bit BMP (bottom-up or top-down; the
  32-bit one read as RGB, its fourth byte dropped, as Pillow does);
* JPEG, GIF, interlaced PNG, 16-bit PNG, PNG bit depths below 8 and the
  other PPM/BMP variants are recognised and raise
  :class:`NotImplementedError` naming the file and ROADMAP Queue 1 #6b;
  bytes of no known format raise :class:`ValueError`;
* :func:`to_color` is Pillow's ``convert("RGB")`` / ``convert("L")`` bit
  for bit (grey repeated, alpha dropped, a palette looked up, RGB -> L as
  ``(R·19595 + G·38470 + B·7471 + 0x8000) >> 16``);
* :func:`resize` is Pillow's ``Image.resize(size, BILINEAR)`` bit for
  bit: the separable two-pass convolution with Pillow's coefficients in
  float64, quantised to 22-bit integers, horizontal pass first, each pass
  only when its size changes, uint8 in between.

PNG's Sub and Up filters are undone row-wide in numpy; Average and Paeth
depend on the left neighbour and are undone byte by byte in Python (a
tree written with filter 0, as :func:`veles_torch.graphics_client.
write_png` writes, never takes that path).
"""

import struct
import zlib

import numpy

#: what :class:`NotImplementedError` names for a format not decoded yet
UNPORTED = "ROADMAP Queue 1 #6b"

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
#: (magic prefix, format name) of the formats recognised but not decoded
_REFUSED = ((b"\xff\xd8\xff", "JPEG"), (b"GIF87a", "GIF"),
            (b"GIF89a", "GIF"))

#: fixed-point bits of Pillow's 8-bit resampling coefficients
_PRECISION_BITS = 32 - 8 - 2


def _refuse(path, what):
    raise NotImplementedError(
        "%s: %s is not decoded by the port yet (%s)" % (path, what,
                                                       UNPORTED))


def sniff(data):
    """The format name of encoded image ``data`` by its magic bytes
    (``PNG``, ``PPM``, ``BMP``, ``JPEG``, ``GIF``), or None."""
    if data[:8] == PNG_MAGIC:
        return "PNG"
    if data[:2] in (b"P5", b"P6", b"P1", b"P2", b"P3", b"P4"):
        return "PPM"
    if data[:2] == b"BM":
        return "BMP"
    for magic, name in _REFUSED:
        if data[:len(magic)] == magic:
            return name
    return None


def decode(data, path="<bytes>"):
    """Encoded image bytes -> ``(pixels, mode)``: an (H, W, C) uint8
    array and its Pillow mode (``L``, ``LA``, ``RGB``, ``RGBA``; a
    palette image comes back looked up, as ``RGB``)."""
    kind = sniff(data)
    if kind == "PNG":
        return _decode_png(data, path)
    if kind == "PPM":
        return _decode_ppm(data, path)
    if kind == "BMP":
        return _decode_bmp(data, path)
    if kind is not None:
        _refuse(path, kind)
    raise ValueError("%s: not an image file of a known format" % path)


def read_png(path):
    """An 8-bit PNG -> an (H, W, channels) uint8 array (a palette image
    looked up as RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if sniff(data) != "PNG":
        raise ValueError("%s: not a PNG" % path)
    return _decode_png(data, path)[0]


# -- PNG ---------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_MODES = {0: "L", 2: "RGB", 3: "RGB", 4: "LA", 6: "RGBA"}


def _decode_png(data, path):
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = numpy.frombuffer(body, numpy.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("%s: PNG without IHDR" % path)
    w, h, depth, color, _, _, interlace = header
    channels = _PNG_CHANNELS.get(color)
    if channels is None:
        raise ValueError("%s: bad PNG colour type %d" % (path, color))
    if depth != 8:
        _refuse(path, "a %d-bit PNG" % depth)
    if interlace:
        _refuse(path, "an interlaced PNG")
    stride = w * channels
    raw = numpy.frombuffer(zlib.decompress(b"".join(idat)), numpy.uint8)
    if raw.size < h * (1 + stride):
        raise ValueError("%s: truncated PNG data" % path)
    rows = raw[:h * (1 + stride)].reshape(h, 1 + stride)
    out = _unfilter(rows, channels, path)
    pixels = out.reshape(h, w, channels)
    if color == 3:
        if palette is None:
            raise ValueError("%s: palette PNG without PLTE" % path)
        pixels = palette[pixels[:, :, 0]]
    return pixels, _PNG_MODES[color]


def _unfilter(rows, bpp, path):
    """Undo the per-row PNG filters of ``rows`` ((H, 1 + stride) uint8,
    the filter byte first) -> (H, stride) uint8."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError("%s: bad PNG filter %d" % (path, kinds.max()))
    out = numpy.empty((h, stride), numpy.uint8)
    if not kinds.any():
        out[:] = rows[:, 1:]
        return out
    prev = numpy.zeros(stride, numpy.uint8)
    for y in range(h):
        kind, line = kinds[y], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:         # Sub: a running sum per channel
            cur = numpy.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=numpy.uint8).reshape(-1)
        elif kind == 2:         # Up
            cur = line + prev
        else:
            cur = _unfilter_left(line, prev, bpp, kind == 4)
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_left(line, prev, bpp, paeth):
    """Average (``paeth`` False) or Paeth: byte by byte, each byte
    predicted from its left neighbour's decoded value."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if paeth:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[x] = (cur[x] + pred) & 0xFF
    return numpy.frombuffer(bytes(cur), numpy.uint8)


# -- PPM / PGM -----------------------------------------------------------

def _decode_ppm(data, path):
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        _refuse(path, "a %s (text or bitmap) PNM" % magic.decode())
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("%s: truncated PNM header" % path)
        fields.append(int(data[start:pos]))
    pos += 1                    # the one whitespace byte before the raster
    w, h, maxval = fields
    if maxval != 255:
        _refuse(path, "a PNM of maxval %d" % maxval)
    channels = 3 if magic == b"P6" else 1
    n = w * h * channels
    if len(data) < pos + n:
        raise ValueError("%s: truncated PNM raster" % path)
    pixels = numpy.frombuffer(data, numpy.uint8, n, pos)
    return pixels.reshape(h, w, channels), "RGB" if channels == 3 else "L"


# -- BMP -----------------------------------------------------------------

def _decode_bmp(data, path):
    offset, = struct.unpack("<I", data[10:14])
    size, = struct.unpack("<I", data[14:18])
    if size < 40:
        _refuse(path, "an OS/2 BMP")
    w, h, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    if compression != 0 or bits not in (24, 32):
        _refuse(path, "a %d-bit BMP of compression %d" % (bits,
                                                          compression))
    bpp = bits // 8
    stride = (w * bpp + 3) & ~3
    rows = abs(h)
    if len(data) < offset + stride * rows:
        raise ValueError("%s: truncated BMP raster" % path)
    raster = numpy.frombuffer(data, numpy.uint8, stride * rows, offset) \
        .reshape(rows, stride)[:, :w * bpp].reshape(rows, w, bpp)
    if h > 0:                   # bottom-up
        raster = raster[::-1]
    return numpy.ascontiguousarray(raster[:, :, 2::-1]), "RGB"


# -- colour and size -----------------------------------------------------

def to_color(pixels, mode, color_space):
    """Pillow's ``convert("L")`` (``color_space`` ``"GRAY"``) or
    ``convert("RGB")`` of ``pixels`` in ``mode`` -> (H, W, 1 or 3)
    uint8."""
    grey = color_space == "GRAY"
    if mode in ("L", "LA"):
        base = pixels[:, :, :1]
        return base if grey else numpy.repeat(base, 3, axis=2)
    if mode not in ("RGB", "RGBA"):
        raise ValueError("no conversion from mode %r" % mode)
    rgb = pixels[:, :, :3]
    if not grey:
        return rgb
    c = rgb.astype(numpy.uint32)
    lum = (c[:, :, 0] * 19595 + c[:, :, 1] * 38470 + c[:, :, 2] * 7471
           + 0x8000) >> 16
    return lum.astype(numpy.uint8)[:, :, None]


def _coefficients(in_size, out_size):
    """Pillow's bilinear ``precompute_coeffs`` + ``normalize_coeffs_8bpc``
    for one axis: (index (out, ksize) int64, weight (out, ksize) int64),
    the padding columns weighted 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale            # the bilinear filter's support is 1
    ss = 1.0 / filterscale
    ksize = int(numpy.ceil(support)) * 2 + 1
    center = (numpy.arange(out_size, dtype=numpy.float64) + 0.5) * scale
    xmin = numpy.maximum((center - support + 0.5).astype(numpy.int64), 0)
    xmax = numpy.minimum((center + support + 0.5).astype(numpy.int64),
                         in_size) - xmin
    x = numpy.arange(ksize, dtype=numpy.int64)
    arg = ((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss
    weight = numpy.maximum(1.0 - numpy.abs(arg), 0.0)
    weight[x[None, :] >= xmax[:, None]] = 0.0
    total = numpy.zeros(out_size)
    for k in range(ksize):           # Pillow's sequential sum
        total = total + weight[:, k]
    weight = numpy.where(total[:, None] != 0.0,
                         weight / numpy.where(total == 0.0, 1.0,
                                              total)[:, None], weight)
    fixed = (0.5 + weight * (1 << _PRECISION_BITS)).astype(numpy.int64)
    index = numpy.minimum(x[None, :] + xmin[:, None], in_size - 1)
    return index, fixed


def _resample(pixels, axis, out_size):
    """One pass of :func:`resize` along ``axis``: every output position
    at once, one kernel tap at a time. The integer sums stay below 2**31
    (the weights sum to about 2**22, times 255), as Pillow's do."""
    index, weight = _coefficients(pixels.shape[axis], out_size)
    shape = [1] * pixels.ndim
    shape[axis] = out_size
    out_shape = list(pixels.shape)
    out_shape[axis] = out_size
    acc = numpy.full(out_shape, 1 << (_PRECISION_BITS - 1), numpy.int32)
    for k in range(index.shape[1]):
        tap = numpy.take(pixels, index[:, k], axis=axis)
        acc += tap * weight[:, k].astype(numpy.int32).reshape(shape)
    return numpy.clip(acc >> _PRECISION_BITS, 0, 255).astype(numpy.uint8)


def resize(pixels, size):
    """Pillow's ``Image.resize((w, h), BILINEAR)`` of (H, W, C) uint8
    ``pixels`` to ``size`` = (h, w)."""
    h, w = int(size[0]), int(size[1])
    if pixels.shape[1] != w:
        pixels = _resample(pixels, 1, w)
    if pixels.shape[0] != h:
        pixels = _resample(pixels, 0, h)
    return pixels


def load(path, color_space="RGB", scale=None):
    """The loader's decode: the file at ``path`` converted to
    ``color_space`` (``"RGB"`` or ``"GRAY"``) and, with ``scale`` =
    (h, w), resized -> (h, w, 3 or 1) uint8."""
    with open(path, "rb") as f:
        pixels, mode = decode(f.read(), path)
    pixels = to_color(pixels, mode, color_space)
    if scale:
        pixels = resize(pixels, scale)
    return numpy.ascontiguousarray(pixels)
