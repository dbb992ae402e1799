"""Image decoding of the PyTorch port, with numpy and zlib only.

The reference decodes with Pillow (``veles/loader/image.py``); the card's
host has neither Pillow nor torchvision, so the port reads the files
itself and gives the same pixels, in the mode Pillow opens them in:

* the format comes from the file's magic bytes, never its extension (as
  Pillow's): JPEG (``jpeg.py``: baseline, extended and progressive
  Huffman JPEG, arithmetic-coded sequential and progressive JPEG and
  lossless JPEG, of 1, 3 or 4 components); PNG of every colour type, bit
  depth (1, 2, 4, 8, 16) and filter, plain or Adam7-interlaced; GIF (the
  first frame: LZW, a global or local palette, interlaced rows); PNM
  (``P1``-``P6``, any maxval, scaled as Pillow scales it); BMP (1-, 4-
  and 8-bit palettes, RLE4 and RLE8 as Pillow's decoder reads them, 16-,
  24- and 32-bit, bitfields, OS/2 headers). What Pillow refuses raises
  :class:`ValueError`, as do bytes of no known format;
* :func:`to_color` is Pillow's ``convert("RGB")`` / ``convert("L")`` bit
  for bit (grey repeated, alpha dropped, a palette looked up, CMYK as
  ``cmyk2rgb``, 16-bit and 32-bit grey clipped to 255, RGB -> L as
  ``(R·19595 + G·38470 + B·7471 + 0x8000) >> 16``);
* :func:`resize` is Pillow's ``Image.resize(size, BILINEAR)`` bit for
  bit: the separable two-pass convolution with Pillow's coefficients in
  float64, quantised to 22-bit integers, horizontal pass first, each pass
  only when its size changes, uint8 in between.

The serial inner loops have a native routine in ``csrc/image_decode.cu``
(built with the toolkit at first use, bound with ctypes) and a Python
twin that gives the same bytes: JPEG's entropy decodes (Huffman,
arithmetic, lossless) and PNG's row filters (Average and Paeth depend on
the decoded left neighbour). The caller declares which runs
(``native``): the streaming loaders ask for the native routine on the
card and the twin on ``-d cpu``; a build failure raises, the twin never
stands in for it.
"""

import struct
import zlib

import numpy

from veles_torch.loader import jpeg

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

#: fixed-point bits of Pillow's 8-bit resampling coefficients
_PRECISION_BITS = 32 - 8 - 2

#: PNG row blocks unfiltered in this process, by routine (``native``, the
#: ``python`` twin; blocks of filter 0 alone take neither)
unfilters = {"native": 0, "python": 0}


def sniff(data):
    """The format name of encoded image ``data`` by its magic bytes
    (``PNG``, ``PPM``, ``BMP``, ``JPEG``, ``GIF``), or None."""
    if data[:8] == PNG_MAGIC:
        return "PNG"
    if data[:2] in (b"P5", b"P6", b"P1", b"P2", b"P3", b"P4"):
        return "PPM"
    if data[:2] == b"BM":
        return "BMP"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    return None


def decode(data, path="<bytes>", native=False):
    """Encoded image bytes -> ``(pixels, mode)``: an (H, W, C) array and
    its Pillow mode (``1``, ``L``, ``LA``, ``RGB``, ``RGBA``, ``CMYK``
    uint8; ``I;16`` uint16; ``I`` int32; a palette image comes back
    looked up, as ``RGB``). ``native``: JPEG's entropy decode and PNG's
    row filters run in ``csrc/image_decode.cu`` (else their Python
    twins)."""
    kind = sniff(data)
    if kind == "PNG":
        return _decode_png(data, path, native)
    if kind == "JPEG":
        return jpeg.decode(data, path, native)
    if kind == "GIF":
        return _decode_gif(data, path)
    if kind == "PPM":
        return _decode_ppm(data, path)
    if kind == "BMP":
        return _decode_bmp(data, path)
    raise ValueError("%s: not an image file of a known format" % path)


def read_png(path):
    """A PNG -> an (H, W, channels) array (a palette image looked up as
    RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if sniff(data) != "PNG":
        raise ValueError("%s: not a PNG" % path)
    return _decode_png(data, path)[0]


def _unpack_bits(raw, depth, count):
    """``count`` samples of ``depth`` (1, 2 or 4) bits from each row of
    ``raw`` ((rows, bytes) uint8), most significant first."""
    bits = numpy.unpackbits(raw, axis=1)
    rows = bits.shape[0]
    bits = bits[:, :count * depth].reshape(rows, count, depth)
    weights = (1 << numpy.arange(depth - 1, -1, -1)).astype(numpy.uint8)
    return (bits * weights).sum(axis=2, dtype=numpy.uint8)


# -- PNG ---------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: (colour type, depth) -> Pillow's mode (``PngImagePlugin._MODES``;
#: a palette is looked up here, so palette images come back as RGB)
_PNG_MODES = {(0, 1): "1", (0, 2): "L", (0, 4): "L", (0, 8): "L",
              (0, 16): "I;16", (2, 8): "RGB", (2, 16): "RGB",
              (3, 1): "RGB", (3, 2): "RGB", (3, 4): "RGB", (3, 8): "RGB",
              (4, 8): "LA", (4, 16): "RGBA", (6, 8): "RGBA",
              (6, 16): "RGBA"}
#: Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _decode_png(data, path, native=False):
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = numpy.frombuffer(body, numpy.uint8,
                                       len(body) // 3 * 3).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("%s: PNG without IHDR" % path)
    w, h, depth, color, _, _, interlace = header
    mode = _PNG_MODES.get((color, depth))
    if mode is None:
        raise ValueError("%s: unknown PNG colour type %d at depth %d"
                         % (path, color, depth))
    channels = _PNG_CHANNELS[color]
    raw = numpy.frombuffer(zlib.decompress(b"".join(idat)), numpy.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = numpy.zeros((h, w, channels),
                          numpy.uint16 if depth == 16 else numpy.uint8)
    at = 0
    for y0, x0, dy, dx in passes:
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph <= 0 or pw <= 0:
            continue
        stride = -(-(pw * channels * depth) // 8)
        n = ph * (1 + stride)
        if raw.size < at + n:
            raise ValueError("%s: truncated PNG data" % path)
        rows = raw[at:at + n].reshape(ph, 1 + stride)
        at += n
        out = unfilter(rows, max(1, channels * depth // 8), path, native)
        if depth == 16:
            part = out.view(">u2").astype(numpy.uint16)
        elif depth == 8:
            part = out
        else:
            part = _unpack_bits(out, depth, pw * channels)
        samples[y0::dy, x0::dx] = part.reshape(ph, pw, channels)
    if color == 3:
        if palette is None:
            raise ValueError("%s: palette PNG without PLTE" % path)
        full = numpy.zeros((256, 3), numpy.uint8)
        full[:len(palette)] = palette[:256]
        return full[samples[:, :, 0]], mode
    if depth == 16 and mode != "I;16":
        samples = (samples >> 8).astype(numpy.uint8)   # RGB;16B: high bytes
        if color == 4:                                 # LA;16B -> RGBA
            samples = samples[:, :, [0, 0, 0, 1]]
    elif depth < 8:
        samples = samples * numpy.uint8(
            {1: 255, 2: 85, 4: 17}[depth])             # 1, L;2, L;4
    return samples, mode


def unfilter(rows, bpp, path="<bytes>", native=False):
    """Undo the per-row PNG filters of ``rows`` ((H, 1 + stride) uint8,
    the filter byte first) -> (H, stride) uint8: in the native routine
    (``csrc/image_decode.cu``'s ``png_unfilter``) or its Python twin."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError("%s: bad PNG filter %d" % (path, kinds.max()))
    out = numpy.empty((h, stride), numpy.uint8)
    if not kinds.any():
        out[:] = rows[:, 1:]
        return out
    if native:
        unfilters["native"] += 1
        rows = numpy.ascontiguousarray(rows)
        bad = jpeg.native_library().png_unfilter(
            rows.ctypes.data, out.ctypes.data, h, stride, bpp)
        if bad:
            raise ValueError("%s: bad PNG filter %d" % (path, bad))
        return out
    unfilters["python"] += 1
    return _unfilter_python(rows, bpp, out)


def _unfilter_python(rows, bpp, out):
    """:func:`unfilter`'s twin: Sub and Up row-wide in numpy, Average and
    Paeth byte by byte."""
    kinds = rows[:, 0]
    prev = numpy.zeros(out.shape[1], numpy.uint8)
    for y in range(out.shape[0]):
        kind, line = kinds[y], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:         # Sub: a running sum per channel
            cur = _sub(line, bpp)
        elif kind == 2:         # Up
            cur = line + prev
        else:
            cur = _unfilter_left(line, prev, bpp, kind == 4)
        out[y] = cur
        prev = out[y]
    return out


def _sub(line, bpp):
    n = len(line)
    padded = numpy.zeros(-(-n // bpp) * bpp, numpy.uint8)
    padded[:n] = line
    return numpy.cumsum(padded.reshape(-1, bpp), axis=0,
                        dtype=numpy.uint8).reshape(-1)[:n]


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


# -- GIF -----------------------------------------------------------------

def _gif_blocks(data, pos):
    """The data sub-blocks from ``pos`` joined -> (bytes, the position
    after the terminator)."""
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        out.append(data[pos:pos + n])
        pos += n
    return b"".join(out), pos


def _lzw(code_bytes, bits, count, fill=0):
    """GIF's LZW decode of ``code_bytes`` (least significant bit first)
    with minimum code size ``bits`` -> ``count`` indices (``fill`` where
    the data ends early)."""
    clear, end = 1 << bits, (1 << bits) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size = bits + 1
    out, total = [], 0
    prev = None
    acc = nacc = 0
    pos, n = 0, len(code_bytes)
    while total < count:
        while nacc < size and pos < n:
            acc |= code_bytes[pos] << nacc
            pos += 1
            nacc += 8
        if nacc < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            table = list(base)
            size = bits + 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code] if code < len(table) else b""
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == (1 << size) and size < 12:
                    size += 1
        out.append(entry)
        total += len(entry)
        prev = entry
    pixels = b"".join(out)[:count]
    return pixels + bytes([fill]) * (count - len(pixels))


def _grey_ramp(palette):
    """Pillow's ``_is_palette_needed`` is false: entry i is (i, i, i)."""
    return bool((palette == numpy.arange(len(palette))[:, None]).all())


def _decode_gif(data, path):
    """The first frame, as Pillow 12 loads it: mode ``P`` (looked up here
    as RGB) or, with no palette or an identity grey ramp, ``L``."""
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    palette = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette = numpy.frombuffer(data, numpy.uint8, n, pos).reshape(-1, 3)
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("%s: image not found in GIF frame" % path)
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            label = data[pos]
            block, pos = _gif_blocks(data, pos + 1)
            if label == 0xF9 and block and block[0] & 1:
                transparency = block[3]
            continue
        if kind != 0x2C:
            continue            # junk between blocks, skipped as Pillow
        x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        if fflags & 0x80:
            n = 3 << ((fflags & 7) + 1)
            palette = numpy.frombuffer(data, numpy.uint8, n, pos) \
                .reshape(-1, 3)
            pos += n
        interlace = bool(fflags & 0x40)
        bits = data[pos]
        codes, pos = _gif_blocks(data, pos + 1)
        break
    if not 0 < bits <= 11:
        raise ValueError("%s: bad GIF code size %d" % (path, bits))
    w, h = max(w, x0 + fw), max(h, y0 + fh)
    frame = numpy.frombuffer(_lzw(codes, bits, fw * fh, transparency or 0),
                             numpy.uint8) \
        .reshape(fh, fw)
    if interlace:
        order = numpy.concatenate([numpy.arange(s, fh, d) for s, d in
                                   ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = numpy.empty_like(frame)
        rows[order] = frame
        frame = rows
    canvas = numpy.full((h, w), transparency or 0, numpy.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None or _grey_ramp(palette):
        return canvas[:, :, None], "L"
    full = numpy.zeros((256, 3), numpy.uint8)
    full[:len(palette)] = palette
    return full[canvas], "RGB"


# -- PPM / PGM / PBM -------------------------------------------------------

_PNM_WHITE = b" \t\n\x0b\x0c\r"


def _pnm_tokens(data, pos, count):
    """``count`` header tokens from ``pos`` (Pillow's ``_read_token``:
    whitespace-separated, ``#`` to the end of the line a comment) ->
    (tokens, the position after the byte that ended the last one)."""
    tokens = []
    n = len(data)
    while len(tokens) < count:
        token = b""
        while True:
            if pos >= n:
                if not token:
                    raise ValueError("reached EOF while reading header")
                break
            c = data[pos:pos + 1]
            pos += 1
            if c in _PNM_WHITE:
                if token:
                    break
                continue
            if c == b"#":
                while pos < n and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            token += c
            if len(token) > 10:
                raise ValueError("token too long in PNM header")
        tokens.append(token)
    return tokens, pos


def _plain_body(data):
    """The raster of a plain PNM with its comments taken out."""
    out, pos = [], 0
    while True:
        i = data.find(b"#", pos)
        if i < 0:
            out.append(data[pos:])
            return b"".join(out)
        out.append(data[pos:i])
        ends = [e for e in (data.find(b"\n", i), data.find(b"\r", i))
                if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def _decode_ppm(data, path):
    """Pillow's ``PpmImagePlugin``: P1/P4 as mode ``1``; P2/P5 as ``L``,
    or ``I`` (scaled to 65535) when maxval > 255; P3/P6 as ``RGB``; a
    maxval other than 255 scaled by ``round(v / maxval · 255)``."""
    magic = data[:2]
    bands = 3 if magic in (b"P3", b"P6") else 1
    bitmap = magic in (b"P1", b"P4")
    (w, h), pos = _pnm_tokens(data, 2, 2)
    w, h = int(w), int(h)
    maxval = 1
    if not bitmap:
        (maxval,), pos = _pnm_tokens(data, pos, 1)
        maxval = int(maxval)
        if not 0 < maxval < 65536:
            raise ValueError("%s: maxval must be greater than 0 and less "
                             "than 65536" % path)
    mode = "1" if bitmap else ("RGB" if bands == 3 else
                               ("I" if maxval > 255 else "L"))
    out_max = 65535 if mode == "I" else 255
    n = w * h * bands
    if magic == b"P4":
        stride = -(-w // 8)
        raw = numpy.frombuffer(data, numpy.uint8, min(stride * h,
                                                      len(data) - pos), pos)
        raw = numpy.concatenate([raw, numpy.zeros(stride * h - raw.size,
                                                  numpy.uint8)])
        bits = _unpack_bits(raw.reshape(h, stride), 1, w)
        return ((1 - bits) * 255).astype(numpy.uint8)[:, :, None], mode
    if magic == b"P1":
        body = bytes(_plain_body(data[pos:]).translate(None, _PNM_WHITE))
        if any(c not in b"01" for c in body[:n]):
            raise ValueError("%s: invalid token for this mode" % path)
        vals = numpy.frombuffer(body[:n], numpy.uint8)
        vals = numpy.where(vals == ord("0"), 255, 0).astype(numpy.uint8)
        vals = numpy.concatenate([vals, numpy.zeros(n - vals.size,
                                                    numpy.uint8)])
        return vals.reshape(h, w, 1), mode
    if magic in (b"P2", b"P3"):
        tokens = _plain_body(data[pos:]).split()[:n]
        if any(len(t) > 10 for t in tokens):
            raise ValueError("%s: token too long in PNM data" % path)
        vals = numpy.array([int(t) for t in tokens], numpy.int64)
        if (vals < 0).any() or (vals > maxval).any():
            raise ValueError("%s: channel value out of range" % path)
        scaled = numpy.round(vals / maxval * out_max)
    else:
        size = 1 if maxval < 256 else 2
        count = min(n, (len(data) - pos) // (size * bands) * bands)
        vals = numpy.frombuffer(data, numpy.uint8 if size == 1 else ">u2",
                                count, pos).astype(numpy.int64)
        if maxval == 255 or (maxval == 65535 and mode == "I"):
            scaled = vals
        else:
            scaled = numpy.minimum(out_max,
                                   numpy.round(vals / maxval * out_max))
    full = numpy.zeros(n, numpy.int64)
    full[:len(scaled)] = scaled
    dtype = numpy.int32 if mode == "I" else numpy.uint8
    return full.astype(dtype).reshape(h, w, bands), mode


# -- BMP -----------------------------------------------------------------

#: Pillow's supported bitfield layouts: (bits, masks) -> raw mode
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _bmp_rle(data, pos, w, h, rle4):
    """Pillow's ``BmpRleDecoder`` byte for byte (its delta escape reads
    two bytes and then takes the next two as the offsets, and the
    absolute runs pad to an even position in the file) -> (h, w) uint8
    indices, bottom row first."""
    out = bytearray()
    x = 0
    total = w * h
    n = len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x))
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            while len(out) % w:
                out.append(0)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2
            right, up = data[pos:pos + 2] + bytes(2 - len(data[pos:pos + 2]))
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:
            if rle4:
                got = data[pos:pos + byte // 2]
                pos += len(got)
                for b in got:
                    out += bytes((b >> 4, b & 15))
                short = len(got) < byte // 2
            else:
                got = data[pos:pos + byte]
                pos += len(got)
                out += got
                short = len(got) < byte
            if short:
                break
            x += byte
            if pos % 2:
                pos += 1
    out = bytes(out[:total]) + bytes(max(0, total - len(out)))
    return numpy.frombuffer(out, numpy.uint8).reshape(h, w)


def _bmp_direct(raster, raw_mode):
    """Unpack (h, w, bytes) rows of a 16-, 24- or 32-bit BMP in Pillow's
    ``raw_mode`` -> (h, w, 3 or 4) uint8 RGB(A)."""
    if raw_mode in ("BGR;15", "BGR;16"):
        p = raster[:, :, 0].astype(numpy.int32) \
            | (raster[:, :, 1].astype(numpy.int32) << 8)
        if raw_mode == "BGR;15":
            r, g = (p >> 10) & 31, ((p >> 5) & 31) * 255 // 31
        else:
            r, g = (p >> 11) & 31, ((p >> 5) & 63) * 255 // 63
        rgb = numpy.stack([r * 255 // 31, g, (p & 31) * 255 // 31], -1)
        return rgb.astype(numpy.uint8)
    order = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
             "BGXR": (3, 1, 0), "ABGR": (3, 2, 1, 0), "RGBA": (0, 1, 2, 3),
             "BGRA": (2, 1, 0, 3), "BGAR": (3, 1, 0, 2)}[raw_mode]
    return numpy.ascontiguousarray(raster[:, :, list(order)])


def _decode_bmp(data, path):
    """Pillow's ``BmpImagePlugin``: the header forms it reads (OS/2's 12
    bytes, Windows' 40 to 124), its raw modes and its grey-palette rule
    (a 2-entry black/white palette opens as ``1``, an identity grey ramp
    as ``L``; the port looks any other palette up as RGB)."""
    offset, = struct.unpack("<I", data[10:14])
    size, = struct.unpack("<I", data[14:18])
    head = data[18:14 + size]
    masks = None
    after = 14 + size           # where the palette (or the masks) start
    if size == 12:
        w, h, _, bits = struct.unpack("<HHHH", head[:8])
        compression, colors, entry, flip = 0, 0, 3, False
    elif size in (40, 52, 56, 64, 108, 124):
        flip = head[7] == 0xFF
        w, h, _, bits, compression = struct.unpack("<IIHHI", head[:16])
        if flip:
            h = 2 ** 32 - h
        colors, = struct.unpack("<I", head[28:32])
        entry = 4
        if compression == 3:
            if len(head) >= 48:
                masks = struct.unpack("<III", head[36:48])
                alpha = struct.unpack("<I", head[48:52])[0] \
                    if len(head) >= 52 else 0
            else:
                masks = struct.unpack("<III", data[after:after + 12])
                alpha = 0
                after += 12
    else:
        raise ValueError("%s: unsupported BMP header type (%d)"
                         % (path, size))
    colors = colors or (1 << bits)
    if offset == 14 + size and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError("%s: unsupported BMP pixel depth (%d)"
                         % (path, bits))
    raw_mode = {16: "BGR;15", 24: "BGR", 32: "BGRX"}.get(bits)
    rle = False
    if compression == 3:
        key = (bits, masks + (alpha,)) if bits == 32 else (bits, masks)
        if key not in _BMP_MASKS:
            raise ValueError("%s: unsupported BMP bitfields layout" % path)
        raw_mode = _BMP_MASKS[key]
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise ValueError("%s: unsupported BMP compression (%d)"
                         % (path, compression))
    if rle and bits > 8:
        raise ValueError("%s: a %d-bit BMP cannot be run-length coded"
                         % (path, bits))
    grey = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError("%s: unsupported BMP palette size (%d)"
                             % (path, colors))
        table = numpy.frombuffer(data[after:after + entry * colors].ljust(
            entry * colors, b"\0"), numpy.uint8).reshape(
                colors, entry)[:, 2::-1]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all((table[i] == v).all() for i, v in enumerate(ramp)):
            grey = "1" if colors == 2 else "L"
    if rle:
        rows = _bmp_rle(data, offset, w, h, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        raster = numpy.frombuffer(data, numpy.uint8, min(
            stride * h, max(0, len(data) - offset)), offset)
        raster = numpy.concatenate([raster, numpy.zeros(
            stride * h - raster.size, numpy.uint8)]).reshape(h, stride)
        if grey == "L":             # Pillow's raw mode "L", whatever bits
            raster = numpy.pad(raster, ((0, 0), (0, max(0, w - stride))))
            rows = raster[:, :w]
        elif grey == "1":           # raw mode "1", whatever bits
            rows = _unpack_bits(raster, 1, w) * numpy.uint8(255)
        elif bits <= 8:
            rows = raster if bits == 8 else _unpack_bits(raster, bits, w)
            rows = rows[:, :w]
        else:
            rows = raster[:, :w * bits // 8].reshape(h, w, bits // 8)
    if not flip:
        rows = rows[::-1]               # bottom-up
    if bits > 8:
        out = _bmp_direct(rows, raw_mode)
        return out, "RGBA" if out.shape[2] == 4 else "RGB"
    if grey is not None:
        return numpy.ascontiguousarray(rows)[:, :, None], grey
    full = numpy.zeros((256, 3), numpy.uint8)
    full[:min(colors, 256)] = table[:256]
    return full[rows], "RGB"


# -- colour and size -----------------------------------------------------

def to_color(pixels, mode, color_space):
    """Pillow's ``convert("L")`` (``color_space`` ``"GRAY"``) or
    ``convert("RGB")`` of ``pixels`` in ``mode`` -> (H, W, 1 or 3)
    uint8."""
    grey = color_space == "GRAY"
    if mode in ("I;16", "I"):           # I16_L, I_L: clipped to 255
        pixels = numpy.clip(pixels[:, :, :1], 0, 255).astype(numpy.uint8)
        mode = "L"
    if mode in ("1", "L", "LA"):
        base = pixels[:, :, :1]
        return base if grey else numpy.repeat(base, 3, axis=2)
    if mode == "CMYK":                  # cmyk2rgb
        c = pixels.astype(numpy.int32)
        nk = 255 - c[:, :, 3:]
        tmp = c[:, :, :3] * nk + 128
        pixels = numpy.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255) \
            .astype(numpy.uint8)
        mode = "RGB"
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


def load(path, color_space="RGB", scale=None, native=False):
    """The loader's decode: the file at ``path`` converted to
    ``color_space`` (``"RGB"`` or ``"GRAY"``) and, with ``scale`` =
    (h, w), resized -> (h, w, 3 or 1) uint8. ``native``: as
    :func:`decode`'s."""
    with open(path, "rb") as f:
        pixels, mode = decode(f.read(), path, native)
    pixels = to_color(pixels, mode, color_space)
    if scale:
        pixels = resize(pixels, scale)
    return numpy.ascontiguousarray(pixels)
