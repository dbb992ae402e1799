"""Write the image fixtures of ``tests/data/jpeg/`` with Pillow, and the
SHA-256 of Pillow's decodes that hosts without Pillow check the port
against (``chip_smoke.py`` phase ``image_jpeg``).

    python tools/make_jpeg_fixtures.py [OUT_DIR]

* ``tree_00.jpg`` ... ``tree_15.jpg``: one 320x240 image a class for the
  streamed AlexNet tree (even classes baseline 4:2:0, odd progressive);
* the JPEG variants the decoder reads (sampling 4:4:4, 4:2:2, 4:2:0,
  h1v2, grey, progressive, restart intervals, CMYK, YCCK) and a 320x240
  PNG whose rows are all Paeth-filtered;
* ``digests.json``: for each file, the SHA-256 of Pillow's
  ``convert("RGB")`` and ``convert("L")`` pixels (uint8, row-major,
  channels last) and of their 256x256 bilinear resizes.

The images are drawn from a fixed seed, so the files are the same on
every run with the same Pillow (12.1.0 with libjpeg-turbo 3.1.3 made the
committed ones).
"""

import hashlib
import io
import json
import os
import struct
import sys
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
    while data[i + 1] not in (0xC0, 0xC1, 0xC2):
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return i


def h1v2(data, w, h):
    """A 4:2:2 stream read as luma 1x2 of the transposed size (the same
    MCU count): a layout Pillow does not write."""
    out = bytearray(data)
    i = sof(out)
    out[i + 5:i + 9] = struct.pack(">HH", h, w)
    out[i + 11] = 0x12
    return bytes(out)


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
    for name, data in sorted(files().items()):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        table[name] = digests(data)
    from PIL import features
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump({"pillow": Image.__version__,
                   "libjpeg_turbo": features.version("libjpeg_turbo"),
                   "files": table}, f, indent=1, sort_keys=True)
        f.write("\n")
    return table


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
