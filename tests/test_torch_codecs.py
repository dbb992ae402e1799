"""The port's image decoding (veles_torch/loader/codecs.py, jpeg.py)
against Pillow, the reference's decoder (veles/loader/image.py
``_decode_file``), bit for bit: PNG of every colour type, bit depth,
filter and interlace; JPEG (4:4:4, 4:2:2, 4:2:0, h1v2, h4v1, grey,
progressive, restart intervals, CMYK, YCCK, odd sizes) through the
Python twin of the entropy decode; GIF (global and local palettes,
interlaced, grey ramps); PNM (text, bitmap, any maxval); BMP (palettes,
RLE4, RLE8, bitfields, OS/2); each also after ``to_color`` and
``resize``; the JPEG processes not decoded yet raise naming ROADMAP
Queue 1 #6c; ``load`` equals the reference loader's own decode; and the
committed fixtures decode to the digests of Pillow's pixels that the
card checks without Pillow."""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy
import pytest
from PIL import Image

import veles.prng as jprng
from veles.loader.image import FileImageLoader as JaxFileImageLoader
from veles.workflow import Workflow
from veles_torch.graphics_client import read_png as graphics_read_png
from veles_torch.graphics_client import write_png
from veles_torch.loader import codecs, jpeg

GEN_SEED = 20261018


def _gen(salt=0):
    return numpy.random.Generator(numpy.random.PCG64(GEN_SEED + salt))


def _image(shape, salt=0):
    """Noise over a smooth ramp: Pillow's adaptive filter choice then
    picks more than one filter."""
    gen = _gen(salt)
    h, w = shape[:2]
    ramp = (numpy.add.outer(numpy.arange(h), numpy.arange(w)) * 3) % 256
    ramp = ramp.reshape(ramp.shape + (1,) * (len(shape) - 2))
    noise = gen.integers(0, 24, shape)
    out = (ramp + noise) % 256
    out[: h // 3] = gen.integers(0, 256, out[: h // 3].shape)
    return out.astype(numpy.uint8)


def _encode(arr, fmt, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _png_filters(data):
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, color, _, _, _ = header
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = numpy.frombuffer(zlib.decompress(b"".join(idat)), numpy.uint8)
    return set(raw.reshape(h, 1 + w * ch)[:, 0].tolist())


def _pillow(data, convert=None):
    with Image.open(io.BytesIO(data)) as img:
        if convert:
            img = img.convert(convert)
        arr = numpy.asarray(img)
    return arr if arr.ndim == 3 else arr[:, :, None]


PNG_CASES = (("L", (37, 45)), ("RGB", (31, 52, 3)), ("LA", (29, 33, 2)),
             ("RGBA", (41, 23, 4)))


@pytest.mark.parametrize("mode,shape", PNG_CASES,
                         ids=[m for m, _ in PNG_CASES])
def test_png_colour_types_bit_for_bit(mode, shape):
    arr = _image(shape)
    data = _encode(arr, "PNG", mode)
    assert len(_png_filters(data)) > 1
    got, got_mode = codecs.decode(data)
    assert got_mode == mode
    numpy.testing.assert_array_equal(got, _pillow(data))
    for space, pil in (("RGB", "RGB"), ("GRAY", "L")):
        numpy.testing.assert_array_equal(
            codecs.to_color(got, got_mode, space), _pillow(data, pil))


def test_png_every_filter_bit_for_bit():
    """Pillow's adaptive filters over a set of images give all of 0-4
    (Average only with ``optimize=True``, which tries every filter); each
    image decodes to Pillow's pixels."""
    seen = set()
    for salt, shape in enumerate(((64, 64, 3), (40, 80, 3), (16, 200, 3),
                                  (33, 17, 4), (50, 50))):
        arr = _image(shape, salt)
        flat = arr.copy()
        flat[shape[0] // 2:] = 128          # filter 0 or Up on flat rows
        for img in (arr, flat):
            for optimize in (False, True):
                data = _encode(img, "PNG", optimize=optimize)
                seen |= _png_filters(data)
                numpy.testing.assert_array_equal(codecs.decode(data)[0],
                                                 _pillow(data))
    assert seen == {0, 1, 2, 3, 4}, seen


def test_palette_png_is_looked_up():
    rgb = _image((27, 35, 3))
    pal = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                       colors=100)
    buf = io.BytesIO()
    pal.save(buf, "PNG")
    data = buf.getvalue()
    got, mode = codecs.decode(data)
    assert mode == "RGB"
    numpy.testing.assert_array_equal(got, _pillow(data, "RGB"))
    numpy.testing.assert_array_equal(codecs.to_color(got, mode, "GRAY"),
                                     _pillow(data, "L"))


@pytest.mark.parametrize("shape", ((9, 13, 3), (10, 7)),
                         ids=["P6", "P5"])
def test_ppm_and_pgm_bit_for_bit(shape):
    arr = _image(shape)
    data = _encode(arr, "PPM")
    assert data[:2] == (b"P6" if len(shape) == 3 else b"P5")
    got, mode = codecs.decode(data)
    numpy.testing.assert_array_equal(got, _pillow(data))
    numpy.testing.assert_array_equal(codecs.to_color(got, mode, "RGB"),
                                     _pillow(data, "RGB"))
    commented = data[:2] + b"\n# a comment\n" + data[3:]
    numpy.testing.assert_array_equal(codecs.decode(commented)[0], got)


@pytest.mark.parametrize("channels", (3, 4), ids=["bmp24", "bmp32"])
def test_bmp_bit_for_bit(channels):
    arr = _image((11, 13, channels))         # 13·3 bytes: padded rows
    data = _encode(arr, "BMP")
    bits, = struct.unpack("<H", data[28:30])
    assert bits == 8 * channels
    got, mode = codecs.decode(data)
    assert mode == "RGB"
    numpy.testing.assert_array_equal(got, _pillow(data, "RGB"))
    # the same raster stored top-down (negative height)
    raw = bytearray(data)
    w, h = struct.unpack("<ii", raw[18:26])
    off, = struct.unpack("<I", raw[10:14])
    stride = (w * channels + 3) & ~3
    rows = [bytes(raw[off + i * stride:off + (i + 1) * stride])
            for i in range(h)]
    raw[22:26] = struct.pack("<i", -h)
    raw[off:] = b"".join(rows[::-1])
    numpy.testing.assert_array_equal(codecs.decode(bytes(raw))[0],
                                     _pillow(bytes(raw), "RGB"))


RESIZE_CASES = (((375, 500), (256, 256)), ((40, 48), (32, 32)),
                ((7, 5), (13, 29)), ((256, 256), (227, 227)),
                ((33, 17), (33, 40)), ((301, 199), (64, 65)),
                ((1000, 37), (64, 255)), ((3, 3), (1, 1)))


@pytest.mark.parametrize("src,dst", RESIZE_CASES,
                         ids=["%dx%d-%dx%d" % (s + d) for s, d in
                              RESIZE_CASES])
def test_resize_is_pillow_bilinear(src, dst):
    for channels in (1, 3):
        arr = _image(src + (channels,), channels)
        img = Image.fromarray(arr[:, :, 0] if channels == 1 else arr)
        want = numpy.asarray(img.resize((dst[1], dst[0]), Image.BILINEAR))
        got = codecs.resize(arr, dst)
        assert got.shape == dst + (channels,)
        numpy.testing.assert_array_equal(
            got[:, :, 0] if channels == 1 else got, want)


def test_grey_conversion_is_pillow_convert_l():
    arr = _image((67, 91, 3))
    want = numpy.asarray(Image.fromarray(arr).convert("L"))
    numpy.testing.assert_array_equal(
        codecs.to_color(arr, "RGB", "GRAY")[:, :, 0], want)


def _held(data, mode=None):
    """``codecs.decode`` of ``data`` equals Pillow's pixels (``mode``: the
    mode Pillow opens it in, when the port keeps it), and its
    ``to_color`` and a bilinear ``resize`` equal Pillow's convert and
    resize, for RGB and L."""
    got, got_mode = codecs.decode(data)
    with Image.open(io.BytesIO(data)) as img:
        if mode is not None:
            assert img.mode == mode
            want = numpy.asarray(img)
            want = want if want.ndim == 3 else want[:, :, None]
            if mode == "1":
                want = want.astype(numpy.uint8) * 255
            assert got_mode == mode
            numpy.testing.assert_array_equal(got, want)
        for space, conv in (("RGB", "RGB"), ("GRAY", "L")):
            pil = img.convert(conv)
            col = codecs.to_color(got, got_mode, space)
            numpy.testing.assert_array_equal(col, _pillow_array(pil))
            size = (max(1, pil.height * 2 // 3), pil.width + 5)
            numpy.testing.assert_array_equal(
                codecs.resize(col, size),
                _pillow_array(pil.resize((size[1], size[0]),
                                         Image.BILINEAR)))


def _pillow_array(img):
    arr = numpy.asarray(img)
    return arr if arr.ndim == 3 else arr[:, :, None]


# -- JPEG ----------------------------------------------------------------

def _sof(data):
    i = 2
    while data[i + 1] not in (0xC0, 0xC1, 0xC2):
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return i


def _resample_jpeg(data, w, h, factors):
    """The same scan read under other sampling factors and size: a file
    with the same MCU count decodes fully (libjpeg reads it as any
    other), so a Pillow-written 4:2:2 or 4:2:0 stream gives the h1v2 and
    h4v1 layouts Pillow does not write."""
    out = bytearray(data)
    i = _sof(out)
    out[i + 5:i + 9] = struct.pack(">HH", h, w)
    for c, hv in enumerate(factors):
        out[i + 11 + 3 * c] = hv
    return bytes(out)


def _adobe(data, transform):
    out = bytearray(data)
    i = out.find(b"Adobe")
    out[i + 11] = transform
    return bytes(out)


JPEG_CASES = {
    "444": lambda: _encode(_image((37, 45, 3)), "JPEG", subsampling=0),
    "422": lambda: _encode(_image((37, 45, 3), 1), "JPEG", subsampling=1),
    "420": lambda: _encode(_image((45, 67, 3), 2), "JPEG", subsampling=2,
                           quality=90),
    "grey": lambda: _encode(_image((29, 33), 3), "JPEG"),
    "h1v2": lambda: _resample_jpeg(_encode(_image((21, 37, 3), 4), "JPEG",
                                           subsampling=1), 21, 37,
                                   (0x12, 0x11, 0x11)),
    "h4v1": lambda: _resample_jpeg(_encode(_image((32, 48, 3), 5), "JPEG",
                                           subsampling=2), 96, 16,
                                   (0x41, 0x11, 0x11)),
    "progressive": lambda: _encode(_image((41, 53, 3), 6), "JPEG",
                                   progressive=True),
    "progressive444": lambda: _encode(_image((23, 29, 3), 7), "JPEG",
                                      progressive=True, subsampling=0,
                                      quality=95),
    "progressive_grey": lambda: _encode(_image((19, 26), 8), "JPEG",
                                        progressive=True),
    "restart": lambda: _encode(_image((47, 61, 3), 9), "JPEG",
                               restart_marker_blocks=3),
    "restart_progressive": lambda: _encode(_image((33, 40, 3), 10), "JPEG",
                                           restart_marker_rows=1,
                                           progressive=True),
    "optimized": lambda: _encode(_image((30, 30, 3), 11), "JPEG",
                                 optimize=True),
    "rgb": lambda: _encode(_image((17, 22, 3), 12), "JPEG", keep_rgb=True),
    "cmyk": lambda: _encode(_image((23, 31, 4), 13), "JPEG", "CMYK"),
    "ycck": lambda: _adobe(_encode(_image((26, 35, 4), 14), "JPEG",
                                   "CMYK", progressive=True), 2),
    "narrow": lambda: _encode(_image((9, 3, 3), 15), "JPEG"),
    "pixel": lambda: _encode(_image((1, 1, 3), 16), "JPEG"),
}


@pytest.mark.parametrize("name", sorted(JPEG_CASES))
def test_jpeg_bit_for_bit(name):
    """The Python twin of the entropy decode and the numpy stages give
    Pillow's (libjpeg-turbo's) pixels, then its convert and resize."""
    data = JPEG_CASES[name]()
    with Image.open(io.BytesIO(data)) as img:
        mode = img.mode
    _held(data, mode)


def _sof_marker(data, marker, precision=None):
    out = bytearray(data)
    i = _sof(out)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


LATER_CASES = (("lossless", 0xC3, None, "lossless"),
               ("arithmetic", 0xC9, None, "arithmetic"),
               ("arithmetic_progressive", 0xCA, None, "arithmetic"),
               ("12bit", 0xC1, 12, "12-bit"))


@pytest.mark.parametrize("name,marker,precision,what", LATER_CASES,
                         ids=[c[0] for c in LATER_CASES])
def test_jpeg_processes_not_decoded_raise_naming_6c(tmp_path, name, marker,
                                                    precision, what):
    """Recognised by their frame marker (never by the name: a JPEG under
    .png) and refused naming the file and ROADMAP Queue 1 #6c."""
    path = tmp_path / ("img_%s.png" % name)
    path.write_bytes(_sof_marker(_encode(_image((8, 8, 3)), "JPEG"),
                                 marker, precision))
    with pytest.raises(NotImplementedError) as err:
        codecs.load(str(path))
    assert str(path) in str(err.value)
    assert "ROADMAP Queue 1 #6c" in str(err.value)
    assert what in str(err.value)


def test_jpeg_processes_pillow_refuses_raise_value_error():
    """Hierarchical JPEG and two-component frames: libjpeg refuses them,
    so the port does with ValueError."""
    data = _encode(_image((8, 8, 3)), "JPEG")
    with pytest.raises(ValueError, match="SOF5"):
        codecs.decode(_sof_marker(data, 0xC5))
    two = bytearray(data)
    two[_sof(two) + 9] = 2
    with pytest.raises(ValueError, match="2-layer"):
        codecs.decode(bytes(two))


# -- corrupt JPEG headers ----------------------------------------------------

def _segments_of(data):
    """(marker, offset, length) of every marker segment, the scans' own
    included (their entropy-coded bytes skipped)."""
    out, i = [], 2
    while i < len(data) - 1:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m in (0, 0xFF) or 0xD0 <= m <= 0xD7:
            i += 1 if m == 0xFF else 2
            continue
        if m == 0xD9:
            break
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((m, i, n))
        i += 2 + n
    return out


def _nth(data, marker, nth=0):
    return [s for s in _segments_of(data) if s[0] == marker][nth]


def _body(data, marker, nth=0):
    _, i, n = _nth(data, marker, nth)
    return bytearray(data[i + 4:i + 2 + n])


def _with_body(data, marker, body, nth=0):
    _, i, n = _nth(data, marker, nth)
    return (data[:i] + bytes([0xFF, marker])
            + struct.pack(">H", len(body) + 2) + bytes(body)
            + data[i + 2 + n:])


def _scan_of(data, want):
    """The index of the first scan whose (components, Ss > 0, Ah > 0)
    is ``want``."""
    for k in range(len([s for s in _segments_of(data) if s[0] == 0xDA])):
        b = _body(data, 0xDA, k)
        ns = b[0]
        ss, a = b[1 + 2 * ns], b[3 + 2 * ns]
        if (ns, ss > 0, a >> 4 > 0) == want:
            return k
    raise AssertionError(want)


def _sos(data, edit, want=None):
    """``data`` with scan ``want`` (its first scan by default) rewritten
    by ``edit(body) -> body``."""
    k = 0 if want is None else _scan_of(data, want)
    return _with_body(data, 0xDA, edit(_body(data, 0xDA, k)), k)


def _tail(ss=None, se=None, a=None):
    def edit(b):
        for off, v in ((-3, ss), (-2, se), (-1, a)):
            if v is not None:
                b[off] = v
        return b
    return edit


def _base():
    return _encode(_image((24, 24, 3), 20), "JPEG", subsampling=0)


def _prog():
    return _encode(_image((24, 24, 3), 21), "JPEG", progressive=True)


def _dht(edit):
    d = _base()
    return _with_body(d, 0xC4, edit(_body(d, 0xC4)))


def _dc_symbol_200(b):
    assert b[0] == 0x00             # the first table is DC table 0
    b[17 + sum(b[1:17]) - 1] = 200
    return b


def _frame(edit):
    d = _base()
    return _with_body(d, 0xC0, edit(_body(d, 0xC0)))


def _set(b, **at):
    for k, v in at.items():
        b[int(k[1:])] = v
    return b


#: headers libjpeg (so Pillow 12.1.0) refuses, each one field of a
#: Pillow-written file changed: the frame, Huffman and quantization
#: tables, and the scans (components, spectral band, successive
#: approximation)
CORRUPT_JPEG = {
    "scan_of_5_components": lambda: _sos(
        _base(), lambda b: bytes([5]) + b[1:7] + b[1:5] + b[7:]),
    "scan_repeats_a_component": lambda: _sos(
        _base(), lambda b: b[:1] + b[1:3] + b[1:3] + b[5:]),
    "scan_out_of_frame_order": lambda: _sos(
        _base(), lambda b: b[:1] + b[3:5] + b[1:3] + b[5:]),
    "scan_of_no_component": lambda: _sos(_base(), lambda b: b[:1] * 0
                                         + bytes([0]) + b[-3:]),
    "refinement_band_past_63": lambda: _sos(_prog(), _tail(se=200),
                                            (1, True, True)),
    "refinement_band_from_70": lambda: _sos(_prog(), _tail(ss=70, se=80),
                                            (1, True, True)),
    "ac_band_reversed": lambda: _sos(_prog(), _tail(ss=10, se=5),
                                     (1, True, False)),
    "dc_scan_with_ac_band": lambda: _sos(_prog(), _tail(se=5),
                                         (3, False, False)),
    "refinement_not_one_bit": lambda: _sos(_prog(), _tail(a=0x31),
                                           (1, True, True)),
    "shift_of_14_bits": lambda: _sos(_prog(), _tail(a=0x0E),
                                     (1, True, False)),
    "ac_scan_of_3_components": lambda: _sos(
        _prog(), lambda b: _body(_prog(), 0xDA, _scan_of(
            _prog(), (3, False, False)))[:7] + b[-3:], (1, True, False)),
    "dc_symbol_above_15": lambda: _dht(_dc_symbol_200),
    "huffman_index_4": lambda: _dht(lambda b: _set(b, b0=0x04)),
    "huffman_class_2": lambda: _dht(lambda b: _set(b, b0=0x20)),
    "huffman_code_overflow": lambda: _dht(lambda b: _set(b, b1=3)),
    "two_frame_headers": lambda: (lambda d, s: d[:s[1] + 2 + s[2]]
                                  + d[s[1]:s[1] + 2 + s[2]]
                                  + d[s[1] + 2 + s[2]:])(
        _base(), _nth(_base(), 0xC0)),
    "mcu_of_12_blocks": lambda: _frame(lambda b: _set(b, b7=0x22, b10=0x22,
                                                    b13=0x22)),
    "quant_index_5": lambda: (lambda d: _with_body(
        d, 0xDB, _set(_body(d, 0xDB), b0=0x05)))(_base()),
    "frame_header_cut": lambda: _frame(lambda b: b[:10]),
    "duplicate_component_id": lambda: _frame(lambda b: _set(b, b9=b[6])),
}


@pytest.mark.parametrize("name", sorted(CORRUPT_JPEG))
def test_corrupt_jpeg_headers_raise_value_error_as_pillow_refuses(name):
    """A header libjpeg refuses (these would have the entropy decode
    write past a block, its stack arrays or the coefficient array, or
    shift by more than 15 bits) raises ValueError before any scan is
    decoded, by either routine; Pillow refuses each file too."""
    data = CORRUPT_JPEG[name]()
    with pytest.raises((OSError, SyntaxError)):
        with Image.open(io.BytesIO(data)) as img:
            img.load()
    before = dict(jpeg.scans)
    for native in (False, True):
        with pytest.raises(ValueError):
            codecs.decode(data, native=native)
    assert jpeg.scans == before


def test_sequential_scan_band_is_ignored_as_pillow_does():
    """A sequential scan's Ss, Se, Ah and Al are only warned about by
    libjpeg: the file decodes to Pillow's pixels."""
    data = _sos(_base(), _tail(ss=5, se=70, a=0x12))
    _held(data, "RGB")


# -- PNG variants ------------------------------------------------------------

def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows, bpp, kinds):
    """PNG-filter (h, stride) uint8 ``rows``, row y with filter
    ``kinds[y % len(kinds)]`` -> the filtered bytes."""
    out, prev = [], numpy.zeros(rows.shape[1], numpy.int32)
    for y, row in enumerate(rows.astype(numpy.int32)):
        kind = kinds[y % len(kinds)]
        a = numpy.concatenate([numpy.zeros(bpp, numpy.int32), row[:-bpp]])
        c = numpy.concatenate([numpy.zeros(bpp, numpy.int32), prev[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = numpy.where((pa <= pb) & (pa <= pc), a,
                               numpy.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + ((row - pred) & 255).astype(
            numpy.uint8).tobytes())
        prev = row
    return b"".join(out)


def _pack(samples, depth):
    """(h, w·channels) samples -> PNG rows of ``depth`` bits."""
    if depth == 16:
        return samples.astype(">u2").view(numpy.uint8).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples.astype(numpy.uint8)
    bits = ((samples[:, :, None] >> numpy.arange(depth - 1, -1, -1))
            & 1).reshape(samples.shape[0], -1).astype(numpy.uint8)
    return numpy.packbits(bits, axis=1)


def _write_png(samples, depth, color, interlace=False, palette=None,
               kinds=(0, 1, 2, 3, 4)):
    """A PNG of (h, w, channels) ``samples`` at ``depth`` bits, plain or
    Adam7, every filter in turn."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
              (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)) if interlace \
        else ((0, 0, 1, 1),)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(_pack(sub.reshape(sub.shape[0], -1), depth),
                                bpp, kinds)
    out = PNG_MAGIC + _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _png_chunk(b"PLTE", palette.tobytes())
    return out + _png_chunk(b"IDAT", zlib.compress(raw)) \
        + _png_chunk(b"IEND", b"")


PNG_MAGIC = codecs.PNG_MAGIC
PNG_VARIANTS = (
    ("grey1", 1, 0, 1, "1"), ("grey2", 2, 0, 1, "L"), ("grey4", 4, 0, 1, "L"),
    ("grey16", 16, 0, 1, "I;16"), ("rgb16", 16, 2, 3, "RGB"),
    ("la16", 16, 4, 2, "RGBA"), ("rgba16", 16, 6, 4, "RGBA"),
    ("palette1", 1, 3, 1, None), ("palette2", 2, 3, 1, None),
    ("palette4", 4, 3, 1, None), ("rgb8", 8, 2, 3, "RGB"),
)


@pytest.mark.parametrize("interlace", (False, True),
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("name,depth,color,ch,mode", PNG_VARIANTS,
                         ids=[v[0] for v in PNG_VARIANTS])
def test_png_depths_and_interlace_bit_for_bit(name, depth, color, ch, mode,
                                              interlace):
    """Bit depths 1, 2, 4 and 16 and Adam7 on odd sizes (passes of one
    column or none), every filter in turn; 16-bit grey opens as ``I;16``
    and converts clipped to 255, as Pillow's."""
    gen = _gen(depth * 10 + color)
    shape = (13, 11, ch)
    top = 1 << depth
    samples = gen.integers(0, top, shape)
    if depth == 16:
        samples[:6] = gen.integers(0, 300, (6, 11, ch))   # clipped and not
    palette = gen.integers(0, 256, (top, 3), dtype=numpy.uint8) \
        if color == 3 else None
    data = _write_png(samples, depth, color, interlace, palette)
    _held(data, mode)
    if mode is None:
        got, got_mode = codecs.decode(data)
        assert got_mode == "RGB"
        numpy.testing.assert_array_equal(got, _pillow(data, "RGB"))


def test_png_unfilter_twin_takes_every_filter_at_every_width():
    """The Python unfilter (the native routine's twin) on pixel widths of
    1 to 8 bytes, each filter, against a direct re-computation."""
    gen = _gen(77)
    for bpp in (1, 2, 3, 4, 6, 8):
        samples = gen.integers(0, 256, (9, 7 * bpp))
        rows = numpy.frombuffer(_filter_rows(samples, bpp, (4, 3, 1, 2, 0)),
                                numpy.uint8).reshape(9, -1)
        numpy.testing.assert_array_equal(codecs.unfilter(rows, bpp),
                                         samples.astype(numpy.uint8))


# -- GIF -----------------------------------------------------------------

def _gif_surgery(data, local=False, grey_ramp=False, transparency=None):
    """A Pillow-written one-frame GIF re-laid: its global palette moved to
    a local one, replaced by an identity grey ramp, or a graphic control
    extension with a transparent index added."""
    flags = data[10]
    n = 3 << ((flags & 7) + 1)
    head, pal, rest = data[:13], data[13:13 + n], data[13 + n:]
    if grey_ramp:
        pal = bytes(numpy.repeat(numpy.arange(n // 3, dtype=numpy.uint8),
                                 3))
    if transparency is not None:
        rest = bytes([0x21, 0xF9, 4, 1, 0, 0, transparency, 0]) \
            + rest[rest.index(b",") - 0:] if b"!" not in rest[:1] \
            else rest
    if local:
        i = rest.index(b",")
        desc = bytearray(rest[i:i + 10])
        desc[9] |= 0x80 | (flags & 7)
        rest = rest[:i] + bytes(desc) + pal + rest[i + 10:]
        return head[:10] + bytes([flags & 0x70]) + head[11:] + rest
    return head + pal + rest


GIF_CASES = {
    "plain": lambda: _encode(_image((9, 11, 3)), "GIF"),
    "interlaced": lambda: _encode(_image((40, 37, 3), 1), "GIF",
                                  interlace=True),
    "local": lambda: _gif_surgery(_encode(_image((21, 18, 3), 2), "GIF"),
                                  local=True),
    "grey_ramp": lambda: _gif_surgery(_encode(_image((17, 19), 3), "GIF"),
                                      grey_ramp=True),
    "transparent": lambda: _gif_surgery(_encode(_image((12, 14, 3), 4),
                                                "GIF"), transparency=3),
    "big": lambda: _encode(_image((64, 80, 3), 5), "GIF"),
}


@pytest.mark.parametrize("name", sorted(GIF_CASES))
def test_gif_first_frame_bit_for_bit(name):
    """The first frame's LZW (codes growing to 12 bits on the larger
    images), interlaced rows, a global or local palette, a grey ramp
    that Pillow 12 opens as ``L``."""
    data = GIF_CASES[name]()
    with Image.open(io.BytesIO(data)) as img:
        mode = img.mode
    assert mode == ("L" if name == "grey_ramp" else "P")
    if mode == "L":
        _held(data, "L")
    else:
        _held(data)


# -- PNM -----------------------------------------------------------------

def _pnm(magic, w, h, maxval, values, text):
    head = b"%s\n# comment\n%d %d\n" % (magic, w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    if text:
        lines = [b" ".join(b"%d" % v for v in values[i:i + 7])
                 for i in range(0, len(values), 7)]
        return head + b"\n".join(lines) + b"\n"
    if magic == b"P4":
        return head + numpy.packbits(values.reshape(h, w), axis=1).tobytes()
    dtype = numpy.uint8 if maxval < 256 else ">u2"
    return head + values.astype(dtype).tobytes()


PNM_CASES = (("P1", 1, None), ("P4", 1, None), ("P2", 1, 200),
             ("P2", 1, 1000), ("P3", 3, 31), ("P3", 3, 4095),
             ("P5", 1, 100), ("P5", 1, 65535), ("P5", 1, 300),
             ("P6", 3, 7), ("P6", 3, 65535), ("P6", 3, 255))


@pytest.mark.parametrize("magic,bands,maxval", PNM_CASES,
                         ids=["%s-%s" % (m, v) for m, _, v in PNM_CASES])
def test_pnm_text_bitmap_and_maxval_bit_for_bit(magic, bands, maxval):
    """Text and bitmap PNM; maxvals other than 255 scaled by Pillow's
    ``round(v / maxval * 255)``; grey above 255 opens as ``I`` and
    converts clipped."""
    gen = _gen(len(magic) + (maxval or 0))
    w, h = 7, 5
    top = 2 if maxval is None else maxval + 1
    values = gen.integers(0, top, w * h * bands)
    data = _pnm(magic.encode(), w, h, maxval, values,
                magic in ("P1", "P2", "P3"))
    with Image.open(io.BytesIO(data)) as img:
        mode = img.mode
    _held(data, mode)


# -- BMP -----------------------------------------------------------------

def _rle(indices, rle4):
    """A run-length coding of (h, w) palette ``indices`` (bottom row
    first): encoded runs, absolute runs and an end of line per row."""
    out = bytearray()
    for row in indices[::-1]:
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 60:
                run += 1
            if run >= 3 or len(row) - x < 4:
                out += bytes([run, row[x] * 17 if rle4 else row[x]])
                x += run
            else:
                n = min(4, len(row) - x)
                lit = row[x:x + n]
                if rle4:
                    packed = bytes((lit[i] << 4) | lit[i + 1]
                                   for i in range(0, n, 2))
                else:
                    packed = bytes(lit)
                out += bytes([0, n]) + packed
                if len(packed) % 2:
                    out += b"\0"
                x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _write_bmp(w, h, bits, raster, palette=None, compression=0, masks=None,
               header=40, top_down=False):
    """BMP bytes: a 40-byte (or OS/2 12-byte) header, the palette (BGR0,
    or BGR under OS/2), the bitfield masks after a 40-byte header."""
    entry = 3 if header == 12 else 4
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(int(v) for v in c[::-1]) + b"\0" * (entry - 3)
                       for c in palette)
    extra = struct.pack("<III", *masks) if masks else b""
    offset = 14 + header + len(extra) + len(pal)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                           bits, compression, len(raster), 2835, 2835,
                           len(palette) if palette is not None else 0, 0)
    return b"BM" + struct.pack("<IHHI", offset + len(raster), 0, 0,
                               offset) + info + extra + pal + raster


def _rows(indices, bits):
    """(h, w) samples of ``bits`` -> bottom-up rows padded to 4 bytes."""
    h, w = indices.shape[:2]
    packed = _pack(indices.reshape(h, -1), bits) if bits < 8 \
        else indices.reshape(h, -1).astype(numpy.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    out = numpy.zeros((h, stride), numpy.uint8)
    out[:, :packed.shape[1]] = packed
    return out[::-1].tobytes()


def _bmp_case(name):
    gen = _gen(sum(map(ord, name)))
    w, h = 13, 7
    if name in ("pal1", "pal4", "pal8", "os2", "rle4", "rle8", "grey8"):
        bits = {"pal1": 1, "pal4": 4, "rle4": 4}.get(name, 8)
        top = 1 << bits
        palette = gen.integers(0, 256, (min(top, 200), 3))
        if name == "grey8":
            palette = numpy.repeat(numpy.arange(256)[:, None], 3, 1)
        idx = gen.integers(0, len(palette), (h, w))
        idx[2, :] = idx[2, 0]                 # runs for the RLE coders
        if name.startswith("rle"):
            return _write_bmp(w, h, bits, _rle(idx, name == "rle4"),
                              palette, 2 if name == "rle4" else 1)
        return _write_bmp(w, h, bits, _rows(idx, bits), palette,
                          header=12 if name == "os2" else 40)
    if name in ("rgb565", "rgb555"):
        px = gen.integers(0, 1 << 16, (h, w)).astype("<u2")
        masks = (0xF800, 0x7E0, 0x1F) if name == "rgb565" \
            else (0x7C00, 0x3E0, 0x1F)
        stride = (w * 2 + 3) & ~3
        rows = numpy.zeros((h, stride), numpy.uint8)
        rows[:, :2 * w] = px.view(numpy.uint8).reshape(h, -1)
        return _write_bmp(w, h, 16, rows[::-1].tobytes(), compression=3,
                          masks=masks)
    if name == "rgb16":
        rows = gen.integers(0, 256, (h, (w * 2 + 3) & ~3), dtype=numpy.uint8)
        return _write_bmp(w, h, 16, rows.tobytes())
    if name == "bgrx_top_down":
        rows = gen.integers(0, 256, (h, w * 4), dtype=numpy.uint8)
        return _write_bmp(w, h, 32, rows.tobytes(), compression=3,
                          masks=(0xFF0000, 0xFF00, 0xFF), top_down=True)
    raise KeyError(name)


BMP_CASES = ("pal1", "pal4", "pal8", "grey8", "os2", "rle4", "rle8",
             "rgb565", "rgb555", "rgb16", "bgrx_top_down")


@pytest.mark.parametrize("name", BMP_CASES)
def test_bmp_palettes_rle_bitfields_os2_bit_for_bit(name):
    data = _bmp_case(name)
    with Image.open(io.BytesIO(data)) as img:
        mode = img.mode
    _held(data, mode if mode != "P" else None)


def test_bmp_pillow_refusals_raise_value_error():
    """A 2-bit BMP and an unknown header size: Pillow refuses them, and so
    does the port, with ValueError."""
    for data in (_write_bmp(4, 2, 2, b"\0" * 8, [(0, 0, 0)] * 4),
                 _write_bmp(4, 2, 24, b"\0" * 24)[:14]
                 + struct.pack("<I", 20) + b"\0" * 40):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        with pytest.raises(ValueError):
            codecs.decode(data)


# -- the committed fixtures ----------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")


def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def test_fixture_digests_are_pillows_and_the_port_decodes_to_them():
    """The fixtures' digests (what the card checks without Pillow) are
    Pillow's decodes and 256x256 bilinear resizes here, and the port's
    Python twin gives the same pixels."""
    digests = _digests()
    assert len(digests["files"]) >= 16 + 8
    for name, want in sorted(digests["files"].items()):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        for space, conv in (("RGB", "RGB"), ("GRAY", "L")):
            with Image.open(io.BytesIO(data)) as img:
                pil = img.convert(conv)
                small = pil.resize((256, 256), Image.BILINEAR)
            assert hashlib.sha256(_pillow_array(pil).tobytes()) \
                .hexdigest() == want[conv]
            assert hashlib.sha256(_pillow_array(small).tobytes()) \
                .hexdigest() == want[conv + "_256"]
        if name.startswith("tree_"):
            continue            # the 16 tree images: the card decodes them
        pixels, mode = codecs.decode(data)
        for space, conv in (("RGB", "RGB"), ("GRAY", "L")):
            col = codecs.to_color(pixels, mode, space)
            assert hashlib.sha256(col.tobytes()).hexdigest() == want[conv]
            assert hashlib.sha256(codecs.resize(col, (256, 256)).tobytes()) \
                .hexdigest() == want[conv + "_256"]


def test_format_comes_from_bytes_not_extension(tmp_path):
    """PNG bytes under a .JPEG name decode (the reference's staging
    fixtures write such files); bytes of no image format raise."""
    arr = _image((12, 14, 3))
    path = tmp_path / "n01440764_0.JPEG"
    path.write_bytes(_encode(arr, "PNG"))
    numpy.testing.assert_array_equal(codecs.load(str(path)), arr)
    junk = tmp_path / "junk.png"
    junk.write_bytes(b"not an image at all")
    with pytest.raises(ValueError, match="junk.png"):
        codecs.load(str(junk))


def test_write_png_round_trips_through_read_png(tmp_path):
    arr = _image((19, 23, 3))
    path = str(tmp_path / "w.png")
    write_png(path, arr)
    assert _png_filters(open(path, "rb").read()) == {0}
    numpy.testing.assert_array_equal(graphics_read_png(path), arr)
    numpy.testing.assert_array_equal(_pillow(open(path, "rb").read()), arr)


@pytest.mark.parametrize("space", ("RGB", "GRAY"))
def test_load_equals_the_reference_decode(tmp_path, space):
    """``codecs.load`` == the reference loader's ``_decode_file`` (Pillow
    convert + resize) for each format, with and without a resize."""
    jprng.seed_all(3)
    files = {"a.png": _encode(_image((30, 41, 4)), "PNG"),
             "b.ppm": _encode(_image((25, 18, 3)), "PPM"),
             "c.bmp": _encode(_image((17, 22, 3)), "BMP"),
             "d.png": _encode(_image((20, 20)), "PNG"),
             "e.jpg": _encode(_image((21, 26, 3)), "JPEG"),
             "f.gif": _encode(_image((15, 12, 3)), "GIF"),
             "g.bmp": _encode(_image((9, 10)), "BMP")}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    for scale in (None, (24, 32)):
        ref = JaxFileImageLoader(
            Workflow(None, name="DecodeWF"), name="loader",
            train_paths=[str(tmp_path / n) for n in files],
            train_labels=[0] * len(files), scale=scale,
            color_space=space, minibatch_size=2)
        for name in files:
            want = ref._decode_file(str(tmp_path / name))
            got = codecs.load(str(tmp_path / name), space, scale)
            assert got.dtype == numpy.uint8
            numpy.testing.assert_array_equal(got, want)


# -- the native routine, built with the host compiler -------------------------

@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """``csrc/image_decode.cu`` (host code only) built with g++ and bound
    as ``jpeg.native_library`` binds it; ``jpeg.native_library`` and
    ``codecs``' use of it answer with this library in the tests that
    take the fixture."""
    import shutil
    import subprocess
    from veles_torch import kernels
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native routine on the host")
    out = str(tmp_path_factory.mktemp("image_decode") / "libimage_decode.so")
    subprocess.run(["g++", "-x", "c++", "-O2", "-shared", "-fPIC", "-o", out,
                    os.path.join(kernels.SOURCE_DIR, "image_decode.cu")],
                   check=True)
    return kernels.open_library(out, jpeg.SIGNATURES)


@pytest.fixture
def with_native(native, monkeypatch):
    monkeypatch.setattr(jpeg, "native_library", lambda: native)
    return native


def _small_fixtures():
    return sorted(n for n in _digests()["files"]
                  if n.endswith(".jpg") and not n.startswith("tree_"))


@pytest.mark.parametrize("name", sorted(JPEG_CASES) + _small_fixtures())
def test_native_scan_decode_equals_the_twin(with_native, name):
    """Every scan's coefficients, native against the Python twin."""
    if name in JPEG_CASES:
        data = JPEG_CASES[name]()
    else:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
    frame = jpeg.parse(data)
    before = dict(jpeg.scans)
    got, layout = jpeg.coefficients(frame, True)
    want, want_layout = jpeg.coefficients(frame, False)
    assert layout == want_layout
    numpy.testing.assert_array_equal(got, want)
    assert jpeg.scans["native"] - before["native"] == len(frame.scans)


def test_native_decodes_the_tree_fixtures_to_pillows_digests(with_native):
    """The card's 16 tree images (baseline 4:2:0 and progressive) decode
    natively to Pillow's pixels and resizes (``digests.json``)."""
    digests = _digests()["files"]
    names = sorted(n for n in digests if n.startswith("tree_"))
    assert len(names) == 16
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            pixels, mode = codecs.decode(f.read(), native=True)
        col = codecs.to_color(pixels, mode, "RGB")
        assert hashlib.sha256(col.tobytes()).hexdigest() \
            == digests[name]["RGB"], name
        assert hashlib.sha256(codecs.resize(col, (256, 256)).tobytes()) \
            .hexdigest() == digests[name]["RGB_256"], name


def _scan_args(ncomp=1, hv=(1, 1), progressive=0, ss=0, se=63, ah=0, al=0,
               dc_symbol=0):
    """One scan's arguments over zero bytes: ``ncomp`` components of
    sampling ``hv``, 2×2 MCUs, DC table 0 one 1-bit code for
    ``dc_symbol``, AC table 0 one 1-bit code for EOB; coef with a guard
    block past the scan's blocks."""
    h, v = hv
    blocks = 4 * h * v
    comps = numpy.array([[c * blocks, 2 * h, h, v, 0, 0, 2 * h, 2 * v]
                         for c in range(ncomp)], numpy.int32)
    tables = numpy.zeros((8, jpeg.TABLE_WORDS), numpy.int32)
    counts = [1] + [0] * 15
    tables[0] = jpeg.huffman_table(counts, [dc_symbol])
    tables[4] = jpeg.huffman_table(counts, [0])
    coef = numpy.full((ncomp * blocks + 1, 64), 7, numpy.int16)
    data = bytes(64)
    offsets = numpy.array([0, len(data)], numpy.int64)
    return (data, offsets, coef, comps, 2, 2, 0, ss, se, ah, al,
            progressive, tables)


GUARDS = {"components_5": (1, dict(ncomp=5)),
          "mcu_of_12_blocks": (2, dict(ncomp=3, hv=(2, 2))),
          "band_past_63": (3, dict(progressive=1, ss=1, se=200, ah=1)),
          "dc_band_past_0": (3, dict(progressive=1, ss=0, se=5)),
          "shift_of_14": (3, dict(progressive=1, ss=1, se=63, al=14)),
          "dc_symbol_200": (4, dict(dc_symbol=200))}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_native_decoder_refuses_what_would_write_out_of_bounds(with_native,
                                                               name):
    """Called directly with a scan that ``jpeg.parse`` refuses, the
    native routine returns its code before writing (the guard block past
    the scan stays as it was) and the twin raises the same code."""
    code, kw = GUARDS[name]
    args = _scan_args(**kw)
    coef = args[2]
    with pytest.raises(ValueError, match="code %d" % code):
        jpeg.decode_scan_native(*args)
    assert (coef == 7).all()
    with pytest.raises(ValueError, match="code %d" % code):
        jpeg.decode_scan_python(*_scan_args(**kw))


def test_native_unfilter_equals_the_twin(with_native):
    """PNG rows of every filter, native against the Python twin, at
    pixel widths of 1 to 8 bytes; a bad filter type raises in both."""
    gen = _gen(40)
    for bpp in (1, 2, 3, 4, 6, 8):
        stride = bpp * 13
        rows = gen.integers(0, 256, (10, 1 + stride), dtype=numpy.uint8)
        rows[:, 0] = numpy.arange(10) % 5
        got = codecs.unfilter(rows.copy(), bpp, native=True)
        want = codecs.unfilter(rows.copy(), bpp, native=False)
        numpy.testing.assert_array_equal(got, want)
    rows[3, 0] = 5
    for native in (False, True):
        with pytest.raises(ValueError):
            codecs.unfilter(rows.copy(), bpp, native=native)
