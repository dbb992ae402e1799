"""Renderer process of the PyTorch port: receives plot frames, writes
PNGs, with no plotting library.

Counterpart of ``veles/graphics_client.py``:

    python -m veles_torch.graphics_client --connect PORT --out DIR

Each frame's ``meta["kind"]`` picks one of the reference's four
renderers (``curves``, ``image``, ``grid``, ``matrix``); every frame
rewrites ``DIR/<name>.png`` (``name`` sanitised as the reference does)
and the ``plots.json`` index ``{name: {"kind", "file", "title"}}``. A
frame that fails to render is reported on stderr and the feed goes on.

The reference draws with matplotlib; this renderer draws into a numpy
RGB canvas and encodes the PNG itself (``zlib`` and ``struct``), so it
runs wherever numpy does, the card's host included. It draws the data:
heat maps through the named colormap (``viridis``, ``bone``, ``hot``,
``coolwarm``, ``gray``, ``Blues``, each a piecewise-linear
approximation) with a colour bar, tiles each scaled to its own range,
the matrix's counts as digits, the curves as lines with markers on a
grid with their y range and last x as numbers. Titles and axis names
stay in ``plots.json`` and the frame's meta: the renderer has a digit
font only. :func:`read_png` (``veles_torch/loader/codecs.py``) decodes
an 8-bit PNG (any filter) back into an array.
"""

import argparse
import json
import os
import socket
import struct
import sys
import zlib

import numpy

from veles_torch.loader.codecs import read_png  # noqa: F401 (re-exported)

#: colormap -> evenly spaced RGB stops
COLORMAPS = {
    "viridis": ((68, 1, 84), (59, 82, 139), (33, 145, 140),
                (94, 201, 98), (253, 231, 37)),
    "bone": ((0, 0, 0), (84, 84, 116), (167, 199, 199), (255, 255, 255)),
    "hot": ((11, 0, 0), (255, 0, 0), (255, 255, 0), (255, 255, 255)),
    "coolwarm": ((59, 76, 192), (221, 221, 221), (180, 4, 38)),
    "gray": ((0, 0, 0), (255, 255, 255)),
    "Blues": ((247, 251, 255), (107, 174, 214), (8, 48, 107)),
}
#: line colours of the curves, in series order (matplotlib's cycle)
PALETTE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
           (148, 103, 189), (140, 86, 75), (227, 119, 194))
WHITE, BLACK, GRID = (255, 255, 255), (0, 0, 0), (220, 220, 220)
#: 3×5 glyphs of the numbers the renderer writes
FONT = {
    "0": ("111", "101", "101", "101", "111"),
    "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"),
    "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"),
    "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"),
    "7": ("111", "001", "001", "001", "001"),
    "8": ("111", "101", "111", "101", "111"),
    "9": ("111", "101", "111", "001", "111"),
    ".": ("000", "000", "000", "000", "010"),
    "-": ("000", "000", "111", "000", "000"),
    "+": ("000", "010", "111", "010", "000"),
    "e": ("000", "111", "111", "100", "111"),
}
MARGIN = 8


# -- PNG ---------------------------------------------------------------

def _chunk(kind, data):
    body = kind + data
    return struct.pack(">I", len(data)) + body \
        + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def write_png(path, rgb):
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = numpy.ascontiguousarray(rgb, numpy.uint8)
    h, w, _ = rgb.shape
    raw = numpy.zeros((h, 1 + 3 * w), numpy.uint8)   # filter 0 per row
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    png = b"\x89PNG\r\n\x1a\n" \
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) \
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) \
        + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


# -- drawing -------------------------------------------------------------

def _canvas(h, w):
    return numpy.full((h, w, 3), 255, numpy.uint8)


def colorize(values, cmap):
    """A 2-D array -> (H, W, 3) uint8 through ``cmap`` over its finite
    range; non-finite entries are white."""
    if cmap not in COLORMAPS:
        raise ValueError("unknown colormap %r (known: %s)"
                         % (cmap, ", ".join(sorted(COLORMAPS))))
    v = numpy.asarray(values, numpy.float64)
    finite = numpy.isfinite(v)
    lo, hi = (v[finite].min(), v[finite].max()) if finite.any() else (0, 0)
    t = (v - lo) / (hi - lo) if hi > lo else numpy.full(v.shape, 0.5)
    t = numpy.clip(numpy.where(finite, t, 0.0), 0.0, 1.0)
    stops = numpy.asarray(COLORMAPS[cmap], numpy.float64)
    x = numpy.linspace(0.0, 1.0, len(stops))
    rgb = numpy.stack([numpy.interp(t, x, stops[:, c]) for c in range(3)],
                      axis=-1)
    rgb[~finite] = WHITE
    return numpy.round(rgb).astype(numpy.uint8)


def _upscale(img, s):
    return numpy.repeat(numpy.repeat(img, s, axis=0), s, axis=1)


def text_width(text, scale=1):
    return (4 * len(text) - 1) * scale


def draw_text(canvas, x, y, text, color=BLACK, scale=1):
    """Numbers in the 3×5 font, top-left at (x, y); glyphs the font lacks
    and pixels off the canvas are skipped."""
    h, w, _ = canvas.shape
    for i, ch in enumerate(text):
        glyph = FONT.get(ch)
        if glyph is None:
            continue
        for r, bits in enumerate(glyph):
            for c, bit in enumerate(bits):
                if bit == "1":
                    y0 = y + r * scale
                    x0 = x + (4 * i + c) * scale
                    if 0 <= y0 and y0 + scale <= h and 0 <= x0 \
                            and x0 + scale <= w:
                        canvas[y0:y0 + scale, x0:x0 + scale] = color


def draw_line(canvas, x0, y0, x1, y1, color, width=2):
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = numpy.round(numpy.linspace(x0, x1, n)).astype(int)
    ys = numpy.round(numpy.linspace(y0, y1, n)).astype(int)
    h, w, _ = canvas.shape
    for d in range(width):
        canvas[numpy.clip(ys + d, 0, h - 1), numpy.clip(xs, 0, w - 1)] = color


def _number(v):
    return "%.3g" % v


def render_curves(meta, arrays, path):
    """Line plot: arrays = {label: 1-D series} over a shared x (epochs),
    one colour per label in ``meta["series"]`` order."""
    names = [n for n in meta.get("series", sorted(arrays))
             if numpy.size(arrays[n])]
    series = [numpy.asarray(arrays[n], numpy.float64).ravel()
              for n in names]
    finite = numpy.concatenate([s[numpy.isfinite(s)] for s in series]) \
        if series else numpy.zeros(0)
    lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 1.0)
    if hi <= lo:
        lo, hi = lo - 0.5, hi + 0.5
    n_x = max([len(s) for s in series] + [2])
    left, top, width, height = 44, MARGIN, 420, 260
    canvas = _canvas(top + height + 24, left + width + MARGIN)
    for k in range(5):
        y = top + round(k * (height - 1) / 4)
        canvas[y, left:left + width] = GRID
    canvas[top:top + height, [left, left + width - 1]] = BLACK
    canvas[[top, top + height - 1], left:left + width] = BLACK

    def px(i, v):
        return (left + i * (width - 1) / (n_x - 1),
                top + (hi - v) * (height - 1) / (hi - lo))

    for k, s in enumerate(series):
        color = PALETTE[k % len(PALETTE)]
        points = [px(i, v) for i, v in enumerate(s) if numpy.isfinite(v)]
        for (xa, ya), (xb, yb) in zip(points, points[1:]):
            draw_line(canvas, xa, ya, xb, yb, color)
        for x, y in points:
            x, y = int(round(x)), int(round(y))
            canvas[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = color
        # the legend: one swatch per series, top right
        canvas[top + 4 + 8 * k:top + 10 + 8 * k,
               left + width - 14:left + width - 6] = color
    draw_text(canvas, 2, top, _number(hi))
    draw_text(canvas, 2, top + height - 5, _number(lo))
    draw_text(canvas, left, top + height + 6, "0")
    last = str(n_x - 1)
    draw_text(canvas, left + width - text_width(last), top + height + 6,
              last)
    write_png(path, canvas)


def render_image(meta, arrays, path):
    """One 2-D heat map (Kohonen maps, similarity matrices) with a
    colour bar and its range."""
    img = numpy.asarray(arrays["image"], numpy.float64)
    if img.ndim != 2:
        raise ValueError("image of shape %s, expected 2-D" % (img.shape,))
    cmap = meta.get("cmap", "viridis")
    h, w = img.shape
    s = max(1, 320 // max(h, w))
    heat = _upscale(colorize(img, cmap), s)
    bar = colorize(numpy.linspace(1.0, 0.0, h * s)[:, None]
                   .repeat(16, axis=1), cmap)
    canvas = _canvas(h * s + 2 * MARGIN, w * s + 16 + 3 * MARGIN + 24)
    canvas[MARGIN:MARGIN + h * s, MARGIN:MARGIN + w * s] = heat
    x_bar = w * s + 2 * MARGIN
    canvas[MARGIN:MARGIN + h * s, x_bar:x_bar + 16] = bar
    finite = img[numpy.isfinite(img)]
    if finite.size:
        draw_text(canvas, x_bar + 18, MARGIN, _number(finite.max()))
        draw_text(canvas, x_bar + 18, MARGIN + h * s - 5,
                  _number(finite.min()))
    write_png(path, canvas)


def render_grid(meta, arrays, path):
    """Tile an (N, h, w) stack into a near-square grid, each tile scaled
    to its own range (the Weights2D filter imager)."""
    tiles = numpy.asarray(arrays["tiles"], numpy.float64)
    if tiles.ndim != 3:
        raise ValueError("tiles of shape %s, expected (N, h, w)"
                         % (tiles.shape,))
    n, th, tw = tiles.shape
    cols = int(numpy.ceil(numpy.sqrt(n)))
    rows = int(numpy.ceil(n / cols))
    s = max(1, 48 // max(th, tw))
    cell_h, cell_w = th * s + 2, tw * s + 2
    canvas = _canvas(rows * cell_h + 2 * MARGIN, cols * cell_w + 2 * MARGIN)
    cmap = meta.get("cmap", "gray")
    for i in range(n):
        y = MARGIN + (i // cols) * cell_h
        x = MARGIN + (i % cols) * cell_w
        canvas[y:y + th * s, x:x + tw * s] = _upscale(
            colorize(tiles[i], cmap), s)
    write_png(path, canvas)


def render_matrix(meta, arrays, path):
    """An integer matrix (the confusion matrix) as a heat map, each count
    written in its cell up to 20 rows."""
    m = numpy.asarray(arrays["matrix"])
    if m.ndim != 2:
        raise ValueError("matrix of shape %s, expected 2-D" % (m.shape,))
    rows, cols = m.shape
    s = max(12, min(40, 480 // max(rows, cols)))
    heat = _upscale(colorize(m, "Blues"), s)
    canvas = _canvas(rows * s + 2 * MARGIN, cols * s + 2 * MARGIN)
    canvas[MARGIN:MARGIN + rows * s, MARGIN:MARGIN + cols * s] = heat
    if rows <= 20:
        lo, hi = float(m.min()), float(m.max())
        for i in range(rows):
            for j in range(cols):
                text = str(int(m[i, j]))
                scale = 2 if text_width(text, 2) <= s - 4 else 1
                dark = hi > lo and (m[i, j] - lo) / (hi - lo) > 0.5
                draw_text(canvas,
                          MARGIN + j * s + (s - text_width(text, scale)) // 2,
                          MARGIN + i * s + (s - 5 * scale) // 2, text,
                          WHITE if dark else BLACK, scale)
    write_png(path, canvas)


RENDERERS = {
    "curves": render_curves,
    "image": render_image,
    "grid": render_grid,
    "matrix": render_matrix,
}


def render_payload(meta, arrays, out_dir):
    """Render one payload; -> the written path."""
    kind = meta["kind"]
    name = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in meta["name"])
    path = os.path.join(out_dir, name + ".png")
    RENDERERS[kind](meta, arrays, path)
    return path


def serve(port, out_dir):
    """Render every frame from the server on ``port`` until it closes the
    stream; -> the ``plots.json`` index."""
    from veles_torch.graphics import recv_frame, unpack_payload
    os.makedirs(out_dir, exist_ok=True)
    sock = socket.create_connection(("127.0.0.1", port))
    index = {}
    try:
        while True:
            blob = recv_frame(sock)
            if blob is None:
                break
            try:
                meta, arrays = unpack_payload(blob)
                path = render_payload(meta, arrays, out_dir)
                index[meta["name"]] = {
                    "kind": meta["kind"],
                    "file": os.path.basename(path),
                    "title": meta.get("title", "")}
                with open(os.path.join(out_dir, "plots.json"), "w") as f:
                    json.dump(index, f, indent=1)
            except Exception as exc:
                # a bad frame must not kill the feed
                print("render error: %s: %s" % (type(exc).__name__, exc),
                      file=sys.stderr)
    finally:
        sock.close()
    return index


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m veles_torch.graphics_client",
        description="Render plot frames from a graphics server into PNGs")
    p.add_argument("--connect", type=int, required=True,
                   help="graphics server port on localhost")
    p.add_argument("--out", required=True, help="PNG output directory")
    args = p.parse_args(argv)
    serve(args.connect, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
