"""Host ms of the port's two IDCT paths on the blocks of the streamed tree's
images (``tests/data/jpeg/tree_00.jpg``, baseline, and ``tree_01.jpg``,
progressive), in turns (split, lanes, lanes, split): ``jpeg.idct_islow``
as the decode runs it (``jidctint.c``'s product where the ranges show no
16-bit lane can wrap or saturate, as on every block an encoder writes)
against every block through the emulated SIMD lanes
(``jpeg._idct_simd``). Both give the same pixels, which the script checks.
One thread, as a decode thread runs it; prints the card's name and power
limit (the host beside it) and one JSON line.

    python3 tools/jpeg_idct_ab.py [--repeats 20]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from veles_torch.loader import jpeg  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data", "jpeg")
FILES = ("tree_00.jpg", "tree_01.jpg")


def lanes(blocks, quant):
    """``idct_islow`` with every block through the emulated lanes."""
    n = len(blocks)
    x = numpy.empty((n, 64), numpy.int64)
    x[:, jpeg.NATURAL] = blocks
    x *= numpy.asarray(quant, numpy.int64)
    out = jpeg._idct_simd(x, n)
    numpy.clip(out, -128, 127, out=out)
    out += 128
    return out.astype(numpy.uint8).reshape(8, n, 8).transpose(1, 2, 0)


def image_blocks(name):
    """[(blocks, quant)] of each component of ``name``'s frame."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        frame = jpeg.parse(f.read(), name)
    coef, layout = jpeg.coefficients(frame, False)
    return [(coef[first:first + bw * bh], frame.quant[tq])
            for (_, _, _, tq), (first, bw, bh) in zip(frame.components,
                                                      layout)]


def image_ms(idct, parts, repeats):
    t0 = time.perf_counter()
    for _ in range(repeats):
        for blocks, quant in parts:
            idct(blocks, quant)
    return 1e3 * (time.perf_counter() - t0) / repeats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if shutil.which("nvidia-smi") else "no card"
    print(card)
    paths = {"split": jpeg.idct_islow, "lanes": lanes}
    row = {"card": card, "repeats": args.repeats}
    for name in FILES:
        parts = image_blocks(name)
        for blocks, quant in parts:
            if not numpy.array_equal(jpeg.idct_islow(blocks, quant),
                                     lanes(blocks, quant)):
                sys.exit("%s: the two paths differ" % name)
        row[name] = {"blocks": sum(len(b) for b, _ in parts)}
        for path in ("split", "lanes", "lanes", "split"):
            row[name].setdefault(path + "_ms", []).append(
                image_ms(paths[path], parts, args.repeats))
    print(json.dumps(row))


if __name__ == "__main__":
    main()
