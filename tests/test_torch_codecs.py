"""The port's image decoding (veles_torch/loader/codecs.py) against Pillow,
the reference's decoder (veles/loader/image.py ``_decode_file``): PNG of
every colour type with the filters Pillow writes, PGM/PPM and BMP, bit
for bit; ``to_color`` against ``convert("RGB")``/``convert("L")`` and
``resize`` against ``Image.resize(BILINEAR)`` exactly, on odd shapes
down and up; the formats not decoded yet raise naming ROADMAP Queue 1
#6b; and ``load`` equal to the reference loader's own decode."""

import io
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
from veles_torch.loader import codecs

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


def _interlaced_png():
    data = bytearray(_encode(_image((8, 8, 3)), "PNG"))
    data[28] = 1                 # IHDR's interlace byte
    crc = zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF
    data[29:33] = struct.pack(">I", crc)
    return bytes(data)


REFUSED = (
    ("jpeg", lambda: _encode(_image((8, 8, 3)), "JPEG"), "JPEG"),
    ("gif", lambda: _encode(_image((8, 8, 3)), "GIF"), "GIF"),
    ("png16", lambda: _encode(
        _image((8, 8)).astype(numpy.uint16) * 200, "PNG"), "16-bit"),
    ("png1", lambda: _encode(_image((8, 8)) > 100, "PNG"), "1-bit"),
    ("interlaced", _interlaced_png, "interlaced"),
    ("bmp8", lambda: _encode(_image((8, 8)), "BMP"), "8-bit BMP"),
)


@pytest.mark.parametrize("name,make,what", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_formats_not_decoded_raise_naming_6b(tmp_path, name, make, what):
    """Recognised by their bytes, never by the name (a JPEG under .png),
    and refused naming the file and ROADMAP Queue 1 #6b."""
    path = tmp_path / ("img_%s.png" % name)
    path.write_bytes(make())
    with pytest.raises(NotImplementedError) as err:
        codecs.load(str(path))
    assert str(path) in str(err.value)
    assert "ROADMAP Queue 1 #6b" in str(err.value)
    assert what in str(err.value)


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
             "d.png": _encode(_image((20, 20)), "PNG")}
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
