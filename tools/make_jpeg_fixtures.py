"""Write the image fixtures of ``tests/data/jpeg/`` with Pillow and
libjpeg-turbo, and the SHA-256 of Pillow's decodes that hosts without
Pillow check the port against (``chip_smoke.py`` phase ``image_jpeg``).

    python tools/make_jpeg_fixtures.py [OUT_DIR]

* ``tree_00.jpg`` ... ``tree_15.jpg``: one 320x240 image a class for the
  streamed AlexNet tree (even classes baseline 4:2:0, odd progressive);
* ``arith_tree_00.jpg`` ... ``arith_tree_15.jpg``: each tree image's
  coefficients rewritten arithmetic-coded (even ones sequential, SOF9;
  odd ones progressive, SOF10): the same pixels as its Huffman twin;
* the JPEG variants the decoder reads (sampling 4:4:4, 4:2:2, 4:2:0,
  h1v2, grey, progressive, restart intervals, CMYK, YCCK), their
  arithmetic-coded kin (4:2:0, 4:4:4, grey, CMYK, a restart interval,
  non-default DAC conditioning, a progression that refines DC and AC),
  lossless files (predictors 1-7, a point transform of 2, grey and RGB,
  4:2:0, a restart interval, a scan per component) and a 320x240
  PNG whose rows are all Paeth-filtered;
* ``digests.json``: for each file, the SHA-256 of Pillow's
  ``convert("RGB")`` and ``convert("L")`` pixels (uint8, row-major,
  channels last) and of their 256x256 bilinear resizes.

Pillow writes neither arithmetic-coded nor lossless JPEG, so
``tools/jpeg_fixture_writer.c`` does: it is compiled with ``gcc``
against the system's ``jpeglib.h`` and linked to the libjpeg-turbo that
Pillow bundles (``pillow.libs/libjpeg-*.so*``), which has both encoders.

The images are drawn from a fixed seed, so the files are the same on
every run with the same Pillow (12.1.0 with libjpeg-turbo 3.1.3 made the
committed ones).
"""

import glob
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy
from PIL import Image

SEED = 20261018


def scene(k, h=240, w=320, noise=4.0):
    """Class ``k``'s picture: a colour ramp at its own angle, two discs
    and mild noise (smooth enough to stay small as a JPEG)."""
    gen = numpy.random.Generator(numpy.random.PCG64(SEED + k))
    y, x = numpy.mgrid[:h, :w].astype(numpy.float64)
    angle = numpy.pi * k / 16
    ramp = (x * numpy.cos(angle) + y * numpy.sin(angle)) / (w + h)
    base = numpy.stack([ramp, 1 - ramp, 0.5 + 0.5 * numpy.sin(6 * ramp)],
                       -1)
    base = base * gen.uniform(0.5, 1.0, 3)
    for _ in range(2):
        cy, cx = gen.uniform(0, h), gen.uniform(0, w)
        r = gen.uniform(20, 70)
        disc = ((y - cy) ** 2 + (x - cx) ** 2) < r * r
        base[disc] = gen.uniform(0, 1, 3)
    out = base * 255 + gen.normal(0, noise, base.shape)
    return numpy.clip(out, 0, 255).astype(numpy.uint8)


def jpeg(arr, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def sof(data):
    i = 2
    while data[i + 1] not in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return i


def resample(data, w, h, factors):
    """``data``'s scans read as a frame of ``w`` x ``h`` with the
    components' sampling ``factors``: a layout its encoder does not write
    (libjpeg-turbo writes lossless frames at 1x1 only). The sizes are
    chosen so that the scans' data fills the new layout."""
    out = bytearray(data)
    i = sof(out)
    out[i + 5:i + 9] = struct.pack(">HH", h, w)
    for c, hv in enumerate(factors):
        out[i + 11 + 3 * c] = hv
    return bytes(out)


def h1v2(data, w, h):
    """A 4:2:2 stream read as luma 1x2 of the transposed size (the same
    MCU count): a layout Pillow does not write."""
    return resample(data, w, h, (0x12,))


def ycck(data):
    out = bytearray(data)
    i = out.find(b"Adobe")
    out[i + 11] = 2
    return bytes(out)


def paeth_png(arr):
    """A PNG of ``arr`` with every row Paeth-filtered."""
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c).astype(numpy.int32)
    raw, prev = [], numpy.zeros(w * c, numpy.int32)
    for row in rows:
        a = numpy.concatenate([numpy.zeros(c, numpy.int32), row[:-c]])
        up = prev
        cc = numpy.concatenate([numpy.zeros(c, numpy.int32), prev[:-c]])
        p = a + up - cc
        pa, pb, pc = abs(p - a), abs(p - up), abs(p - cc)
        pred = numpy.where((pa <= pb) & (pa <= pc), a,
                           numpy.where(pb <= pc, up, cc))
        raw.append(b"\x04" + ((row - pred) & 255).astype(
            numpy.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(raw), 6))
            + chunk(b"IEND", b""))


class Writer:
    """``tools/jpeg_fixture_writer.c`` built in a temporary directory
    against Pillow's bundled libjpeg-turbo."""

    def __init__(self, tmp):
        import PIL
        libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
            PIL.__file__)), "pillow.libs", "libjpeg*.so*"))
        if not libs:
            raise RuntimeError("no libjpeg-turbo bundled with Pillow")
        self.tmp = tmp
        self.exe = os.path.join(tmp, "jpeg_fixture_writer")
        subprocess.run(
            ["gcc", "-O2", "-o", self.exe, os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "jpeg_fixture_writer.c"), libs[0],
             "-Wl,-rpath," + os.path.dirname(libs[0])], check=True)

    def transcode(self, data, progressive):
        """``data``'s coefficients written arithmetic-coded."""
        src = os.path.join(self.tmp, "in.jpg")
        with open(src, "wb") as f:
            f.write(data)
        out = os.path.join(self.tmp, "out.jpg")
        subprocess.run([self.exe, "transcode", src, out,
                        str(int(progressive))], check=True)
        with open(out, "rb") as f:
            return f.read()

    def compress(self, arr, **kw):
        """``arr`` (h, w[, c]) compressed with the writer's options."""
        arr = arr if arr.ndim == 3 else arr[:, :, None]
        raw = os.path.join(self.tmp, "raw.bin")
        numpy.ascontiguousarray(arr).tofile(raw)
        out = os.path.join(self.tmp, "out.jpg")
        h, w, c = arr.shape
        opts = dict(w=w, h=h, c=c, **kw)
        subprocess.run([self.exe, "compress", raw, out] + [
            "%s=%s" % item for item in opts.items()], check=True)
        with open(out, "rb") as f:
            return f.read()


#: the progression of ``arith_refine.jpg``: DC first at Al 2, the AC bands
#: first at Al 2 (luma) and 1 (chroma), then every refinement down to 0
REFINE_SCANS = "/".join((
    "012:0:0:0:2", "0:1:5:0:2", "1:1:63:0:1", "2:1:63:0:1", "0:6:63:0:2",
    "0:1:63:2:1", "0:1:63:1:0", "1:1:63:1:0", "2:1:63:1:0", "012:0:0:2:1",
    "012:0:0:1:0"))


def writer_files(writer, trees):
    """The arithmetic-coded and lossless fixtures (``trees``: the Huffman
    tree images by name)."""
    out = {}
    for k in range(16):
        out["arith_tree_%02d.jpg" % k] = writer.transcode(
            trees["tree_%02d.jpg" % k], k % 2)
    small = scene(3, 61, 83)
    cmyk = numpy.concatenate([small, small[:, :, :1] // 3], -1)
    out["arith_420.jpg"] = writer.compress(small, arith=1)
    out["arith_444.jpg"] = writer.compress(small, arith=1, samp="11,11,11")
    out["arith_grey.jpg"] = writer.compress(small[:, :, 1], arith=1,
                                            q=90, **{"in": "grey"})
    out["arith_cmyk.jpg"] = writer.compress(cmyk, arith=1, **{"in": "cmyk"})
    out["arith_restart.jpg"] = writer.compress(small, arith=1, restart=5)
    out["arith_dac.jpg"] = writer.compress(small, arith=1, q=90,
                                           samp="11,11,11",
                                           dac="2,6,12/1,3,2")
    out["arith_refine.jpg"] = writer.compress(small, arith=1, q=90, rows=1,
                                              scans=REFINE_SCANS)
    # libjpeg-turbo converts no colours in a lossless frame (Pillow
    # refuses a YCbCr or YCCK one), so the 3-component files are RGB
    tiny = scene(6, 29, 38)
    for psv in range(1, 8):
        out["lossless_p%d.jpg" % psv] = writer.compress(
            tiny[:, :, 0], lossless=psv, **{"in": "grey"})
    out["lossless_rgb.jpg"] = writer.compress(tiny, lossless=4)
    out["lossless_pt2.jpg"] = writer.compress(tiny, lossless=7, pt=2)
    out["lossless_restart.jpg"] = writer.compress(tiny, lossless=6, rows=2)
    # 38x28 at 1x1 read as 76x28 at 4:2:0: 38 x 14 MCUs of 6 samples
    out["lossless_420.jpg"] = resample(writer.compress(
        scene(7, 28, 38), lossless=5), 76, 28, (0x22, 0x11, 0x11))
    # a scan per component, a restart a row, the first component read at
    # 2x2: its scan keeps its 38x29 samples and restarts every row within
    # its iMCU rows of 2; each other scan's restart (38 MCUs) covers 2 of
    # its 19-sample rows
    out["lossless_scans.jpg"] = resample(writer.compress(
        tiny, lossless=1, rows=1, scans="0:1:0:0:0/1:3:0:0:0/2:7:0:0:0"),
        38, 29, (0x22, 0x11, 0x11))
    return out


def files():
    out = {}
    for k in range(16):
        out["tree_%02d.jpg" % k] = jpeg(scene(k), quality=75,
                                        progressive=bool(k % 2))
    small = scene(3, 61, 83)
    out["baseline_444.jpg"] = jpeg(small, subsampling=0)
    out["baseline_422.jpg"] = jpeg(small, subsampling=1)
    out["baseline_420.jpg"] = jpeg(small, subsampling=2)
    out["h1v2.jpg"] = h1v2(jpeg(scene(4, 37, 54), subsampling=1), 37, 54)
    out["grey.jpg"] = jpeg(small[:, :, 1], quality=90)
    out["progressive_420.jpg"] = jpeg(small, progressive=True)
    out["restart.jpg"] = jpeg(small, restart_marker_blocks=5,
                              progressive=True)
    cmyk = numpy.concatenate([small, small[:, :, :1] // 3], -1)
    out["cmyk.jpg"] = jpeg(cmyk, "CMYK")
    out["ycck.jpg"] = ycck(jpeg(cmyk, "CMYK", progressive=True))
    out["paeth.png"] = paeth_png(scene(5, noise=0.0))
    return out


def digests(data):
    out = {}
    with Image.open(io.BytesIO(data)) as img:
        for conv in ("RGB", "L"):
            pil = img.convert(conv)
            for key, im in ((conv, pil), (conv + "_256", pil.resize(
                    (256, 256), Image.BILINEAR))):
                arr = numpy.asarray(im)
                arr = arr if arr.ndim == 3 else arr[:, :, None]
                out[key] = hashlib.sha256(
                    numpy.ascontiguousarray(arr).tobytes()).hexdigest()
    return out


def main(out_dir=None):
    out_dir = out_dir or os.path.join(os.path.dirname(__file__), "..",
                                      "tests", "data", "jpeg")
    os.makedirs(out_dir, exist_ok=True)
    table = {}
    made = files()
    with tempfile.TemporaryDirectory() as tmp:
        made.update(writer_files(Writer(tmp), made))
    for name, data in sorted(made.items()):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        table[name] = digests(data)
    for k in range(16):
        # the same coefficients: the same pixels as the Huffman file
        assert table["arith_tree_%02d.jpg" % k] == table["tree_%02d.jpg" % k]
    from PIL import features
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump({"pillow": Image.__version__,
                   "libjpeg_turbo": features.version("libjpeg_turbo"),
                   "files": table}, f, indent=1, sort_keys=True)
        f.write("\n")
    return table


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
