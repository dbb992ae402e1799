"""JPEG decoding of the port: libjpeg-turbo's default path, bit for bit.

The reference decodes with Pillow, which runs libjpeg-turbo with its
defaults (``veles/loader/image.py``). This module reads the same files
and gives the same pixels:

* **what it reads**: every process Pillow 12.1.0 (libjpeg-turbo 3.1.3)
  decodes: Huffman-coded baseline and extended sequential (SOF0/SOF1)
  and progressive (SOF2) JPEG, arithmetic-coded sequential (SOF9) and
  progressive (SOF10) JPEG, and Huffman-coded lossless JPEG (SOF3,
  predictors 1-7, any point transform), of 8-bit samples, with 1, 3 or 4
  components (grey; YCbCr or RGB; Adobe CMYK or YCCK), any integral
  sampling factors, restart intervals, any size. What libjpeg or Pillow
  refuses raises :class:`ValueError`: hierarchical processes, the
  arithmetic-coded lossless process (SOF11), a precision other than 8
  bits, fractional sampling, 2 components, a DAC entry libjpeg refuses.
* **the entropy decode** (Huffman or arithmetic codes -> quantised
  coefficient blocks, progressive refinement included; lossless codes ->
  the component's samples) runs in the native routines of
  ``csrc/image_decode.cu`` when ``native`` is asked for, and else in
  their Python twins (:func:`decode_scan_python`,
  :func:`decode_scan_arith_python`, :func:`decode_scan_lossless_python`):
  the same arguments, the same output. The caller declares which;
  neither stands in for the other.
* **the stages after it** run in numpy over every block at once:
  dequantization and the ISLOW integer IDCT as libjpeg-turbo's x86-64
  SIMD code computes them (``jidctint.c``'s arithmetic in the 16- and
  32-bit lanes of ``jidctint-sse2.asm``: the same pixels on every file
  an encoder writes, and Pillow's on the out-of-range coefficients of a
  corrupt scan, where the C code would wrap), fancy
  upsampling (``jdsample.c``: h2v1, h2v2, h1v2; box replication for
  other integral factors, for planes 2 samples wide or less and for
  lossless frames) and the fixed-point YCbCr -> RGB tables
  (``jdcolor.c``); YCCK -> CMYK as ``ycck_cmyk_convert``; CMYK inverted
  as Pillow's ``CMYK;I`` raw mode. A lossless frame's samples skip the
  dequantization and the IDCT: they are scaled back by the point
  transform (``jdlossls.c``) and go straight to the upsampling.

The scan's bytes are cut at its restart markers and unstuffed (``FF 00``
-> ``FF``) here, so each decoder reads plain segments and resets its
state at each one. A segment that ends early reads as zero bits
(Huffman) or zero bytes (arithmetic), as libjpeg's does.
"""

import ctypes

import numpy

#: zigzag index k -> natural (row-major) index. The decoders keep blocks
#: in zigzag order and clamp a corrupt run's index to 63, as libjpeg's
#: table of 16 extra entries of 63 does
NATURAL = numpy.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
     12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
     35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
     58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    numpy.int32)

#: int32 words of one Huffman table: maxcode[18], valoff[18],
#: huffval[256], look[256] ((length << 8) | symbol of each 8-bit prefix
#: whose code is at most 8 bits long, else 0)
TABLE_WORDS = 18 + 18 + 256 + 256

#: the entropy codings, as :data:`scans` counts them
CODINGS = ("huffman", "arithmetic", "lossless")

#: scans entropy-decoded in this process, by routine (``native``, the
#: ``python`` twin) and by routine and coding (``native_arithmetic``, ...):
#: a run on the card shows its decode never took the twin
scans = dict.fromkeys(("native", "python") + tuple(
    "%s_%s" % (r, c) for r in ("native", "python") for c in CODINGS), 0)

#: the frame markers decoded: -> (coding, progressive)
_SOF_DECODED = {0xC0: ("huffman", False), 0xC1: ("huffman", False),
                0xC2: ("huffman", True), 0xC3: ("lossless", False),
                0xC9: ("arithmetic", False), 0xCA: ("arithmetic", True)}
_SOF_REFUSED = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)
_SOF_ARITH_LOSSLESS = 0xCB
#: libjpeg's limits (jpeglib.h, jmorecfg.h): components a scan, blocks an
#: interleaved MCU, Huffman and quantization tables, arithmetic
#: conditioning tables, the longest side
MAX_COMPS_IN_SCAN = 4
MAX_BLOCKS_IN_MCU = 10
NUM_TABLES = 4
NUM_ARITH_TABLES = 16
MAX_DIMENSION = 65500
#: the conditioning of an arithmetic table no DAC entry sets (L, U, K:
#: ``jdmarker.c get_soi``)
ARITH_DEFAULT = (0, 1, 5)


def _count(routine, coding):
    scans[routine] += 1
    scans["%s_%s" % (routine, coding)] += 1


def huffman_table(counts, symbols):
    """libjpeg's derived decoding table (``jpeg_make_d_derived_tbl``) of
    one DHT entry as :data:`TABLE_WORDS` int32; None where libjpeg
    refuses the table (a code longer than its length allows: it is
    refused when a scan uses it, as libjpeg does)."""
    out = numpy.zeros(TABLE_WORDS, numpy.int32)
    maxcode, valoff = out[:18], out[18:36]
    huffval, look = out[36:292], out[292:]
    huffval[:len(symbols)] = symbols
    code = p = 0
    maxcode[:] = -1
    for length in range(1, 17):
        n = counts[length - 1]
        if n:
            valoff[length] = p - code
            for _ in range(n):
                if length <= 8:
                    lo = code << (8 - length)
                    look[lo:lo + (1 << (8 - length))] = \
                        (length << 8) | symbols[p]
                code += 1
                p += 1
            maxcode[length] = code - 1
            if code >= 1 << length:
                return None
        code <<= 1
    maxcode[17] = 0xFFFFF
    return out


# -- parsing -------------------------------------------------------------

class Frame:
    """What the markers of one JPEG say: size, components, tables and the
    scans (each with the Huffman tables, the arithmetic conditioning and
    the restart interval in force). ``coding``: one of :data:`CODINGS`."""

    def __init__(self):
        self.width = self.height = 0
        self.coding = "huffman"
        self.progressive = False
        self.components = []    # [id, h, v, quant table] each
        self.quant = {}
        self.scans = []
        self.jfif = False
        self.adobe_transform = None


def _segments(data, pos):
    """The entropy-coded bytes of a scan from ``pos``: -> (unstuffed
    segments cut at the restart markers, the position of the marker that
    ends the scan)."""
    segs, start, end = [], pos, len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= end:
            segs.append(data[start:end].replace(b"\xff\x00", b"\xff"))
            return segs, end
        nxt = data[i + 1]
        if nxt == 0:
            pos = i + 2
            continue
        if nxt == 0xFF:             # a fill byte before a marker
            pos = i + 1
            continue
        if 0xD0 <= nxt <= 0xD7:
            segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            start = pos = i + 2
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        return segs, i


def parse(data, path="<bytes>"):
    """The markers of JPEG ``data`` -> a :class:`Frame`."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("%s: not a JPEG" % path)
    frame = Frame()
    dc, ac = {}, {}
    cond = numpy.array([ARITH_DEFAULT] * NUM_ARITH_TABLES, numpy.int32)
    restart = 0
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1            # junk between markers, skipped as Pillow
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > n:
            break
        length = (data[pos] << 8) | data[pos + 1]
        if length < 2 or pos + length > n:
            raise ValueError("%s: truncated JPEG marker segment" % path)
        body = data[pos + 2:pos + length]
        pos += length
        is_sof = marker in _SOF_DECODED or marker in _SOF_REFUSED \
            or marker == _SOF_ARITH_LOSSLESS
        if is_sof and len(body) >= 1 and body[0] != 8:
            # Pillow's own check, before libjpeg sees the frame
            raise ValueError("%s: cannot handle %d-bit layers"
                             % (path, body[0]))
        if marker == _SOF_ARITH_LOSSLESS:
            raise ValueError("%s: an arithmetic-coded lossless JPEG (SOF11)"
                             ": libjpeg-turbo has no decoder for it"
                             % path)
        if marker in _SOF_REFUSED:
            raise ValueError("%s: unsupported JPEG process (SOF%d)"
                             % (path, marker - 0xC0))
        if marker in _SOF_DECODED:
            if len(body) < 6:
                raise ValueError("%s: bad JPEG frame header" % path)
            if frame.components:
                raise ValueError("%s: more than one JPEG frame header"
                                 % path)
            frame.coding, frame.progressive = _SOF_DECODED[marker]
            frame.height = (body[1] << 8) | body[2]
            frame.width = (body[3] << 8) | body[4]
            nc = body[5]
            if nc not in (1, 3, 4):
                raise ValueError("%s: cannot handle %d-layer images"
                                 % (path, nc))
            if len(body) != 6 + 3 * nc:
                raise ValueError("%s: bad JPEG frame header" % path)
            for c in range(nc):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                    raise ValueError("%s: bad sampling factors" % path)
                if cid in [f[0] for f in frame.components]:
                    raise ValueError("%s: duplicate JPEG component id %d"
                                     % (path, cid))
                frame.components.append([cid, hv >> 4, hv & 15, tq])
            if frame.width == 0 or frame.height == 0:
                raise ValueError("%s: empty JPEG image" % path)
            if max(frame.width, frame.height) > MAX_DIMENSION:
                raise ValueError("%s: JPEG image too big" % path)
        elif marker == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                if tc > 1 or th >= NUM_TABLES:
                    raise ValueError("%s: bad Huffman table index %d"
                                     % (path, body[p]))
                counts = list(body[p + 1:p + 17])
                total = sum(counts)
                if len(counts) < 16 or p + 17 + total > len(body):
                    raise ValueError("%s: bad Huffman table" % path)
                symbols = list(body[p + 17:p + 17 + total])
                (ac if tc else dc)[th] = (huffman_table(counts, symbols),
                                          max(symbols, default=0))
                p += 17 + total
        elif marker == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if tq >= NUM_TABLES:
                    raise ValueError("%s: bad quantization table index %d"
                                     % (path, tq))
                if pq:
                    q = numpy.frombuffer(body, ">u2", 64, p + 1)
                    p += 129
                else:
                    q = numpy.frombuffer(body, numpy.uint8, 64, p + 1)
                    p += 65
                table = numpy.zeros(64, numpy.int64)
                table[NATURAL] = q
                frame.quant[tq] = table
        elif marker == 0xCC:
            _parse_dac(path, body, cond)
        elif marker == 0xDD:
            restart = (body[0] << 8) | body[1]
        elif marker == 0xE0:
            frame.jfif = frame.jfif or (body[:5] == b"JFIF\0"
                                        and length >= 16)
        elif marker == 0xEE:
            if body[:5] == b"Adobe" and length >= 14:
                frame.adobe_transform = body[11]
        elif marker == 0xDA:
            if not frame.components:
                raise ValueError("%s: scan before the frame header" % path)
            ns = body[0] if body else 0
            if not 1 <= ns <= MAX_COMPS_IN_SCAN or len(body) != 4 + 2 * ns:
                raise ValueError("%s: bad JPEG scan header" % path)
            ids = [c[0] for c in frame.components]
            comps = []
            for c in range(ns):
                cid, td = body[1 + 2 * c:3 + 2 * c]
                if cid not in ids:
                    raise ValueError("%s: scan of an unknown component"
                                     % path)
                if comps and ids.index(cid) <= comps[-1][0]:
                    raise ValueError("%s: scan components repeated or out "
                                     "of the frame's order" % path)
                comps.append((ids.index(cid), td >> 4, td & 15))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            _check_scan(path, frame, comps, ss, se, a >> 4, a & 15)
            if frame.coding == "lossless" and restart % mcus_per_row(
                    frame, [ci for ci, _, _ in comps]):
                raise ValueError("%s: lossless JPEG restart interval %d is "
                                 "not a whole number of MCU rows"
                                 % (path, restart))
            segs, pos = _segments(data, pos)
            frame.scans.append({
                "comps": comps, "ss": ss, "se": se, "ah": a >> 4,
                "al": a & 15, "restart": restart, "segments": segs,
                "dc": dict(dc), "ac": dict(ac), "cond": cond.copy()})
    if not frame.scans:
        raise ValueError("%s: JPEG without a scan" % path)
    return frame


def _parse_dac(path, body, cond):
    """A DAC segment into ``cond`` ((16, 3) L, U, K), with
    ``jdmarker.c get_dac``'s refusals: an odd length, a table index past
    the 16 DC and 16 AC tables, a DC entry whose L exceeds its U."""
    if len(body) % 2:
        raise ValueError("%s: bad DAC segment length" % path)
    for p in range(0, len(body), 2):
        index, val = body[p], body[p + 1]
        if index >= 2 * NUM_ARITH_TABLES:
            raise ValueError("%s: bad DAC table index %d" % (path, index))
        if index >= NUM_ARITH_TABLES:
            cond[index - NUM_ARITH_TABLES, 2] = val
        else:
            if val & 15 > val >> 4:
                raise ValueError("%s: bad DAC value 0x%02x (L > U)"
                                 % (path, val))
            cond[index, 0], cond[index, 1] = val & 15, val >> 4


def mcus_per_row(frame, comps):
    """The MCUs of a row of a scan of ``comps`` (frame component
    indices): a single component's samples or blocks across, else the
    frame's MCUs across. A lossless frame's data unit is one sample, a
    DCT frame's an 8x8 block."""
    unit = 1 if frame.coding == "lossless" else 8
    max_h = max(c[1] for c in frame.components)
    if len(comps) == 1:
        h = frame.components[comps[0]][1]
        return -(-(frame.width * h) // (unit * max_h))
    return -(-frame.width // (unit * max_h))


def _check_scan(path, frame, comps, ss, se, ah, al):
    """libjpeg's refusals of a scan header: an interleaved MCU of more
    than :data:`MAX_BLOCKS_IN_MCU` blocks (``jdinput.c``); in a
    progressive frame a spectral band or successive approximation the
    process does not allow (``jdphuff.c``, ``jdarith.c``); in a lossless
    frame a predictor outside 1-7, an Se or Ah other than 0, a point
    transform of 8 bits or more (``jdlossls.c``), or a restart interval
    that is not a whole number of MCU rows (``jddiffct.c``). A sequential
    scan's Ss, Se, Ah and Al are only warned about there, and ignored."""
    if len(comps) > 1 and sum(frame.components[ci][1]
                              * frame.components[ci][2]
                              for ci, _, _ in comps) > MAX_BLOCKS_IN_MCU:
        raise ValueError("%s: JPEG MCU of more than %d blocks"
                         % (path, MAX_BLOCKS_IN_MCU))
    if frame.coding == "lossless":
        if not 1 <= ss <= 7 or se or ah or al >= 8:
            raise ValueError("%s: bad lossless JPEG scan (predictor %d, Se "
                             "%d, Ah %d, Pt %d)" % (path, ss, se, ah, al))
        return
    if not frame.progressive:
        return
    if ss == 0:
        bad = se != 0
    else:
        bad = ss > se or se > 63 or len(comps) != 1
    if ah and al != ah - 1 or al > 13:
        bad = True
    if bad:
        raise ValueError("%s: bad JPEG progression (Ss %d, Se %d, Ah %d, "
                         "Al %d)" % (path, ss, se, ah, al))


# -- the entropy decode: the Python twins --------------------------------

def scan_error(code):
    """The error of a scan that a native scan routine (or its twin)
    returned ``code`` for."""
    return ValueError("corrupt JPEG scan (decoder code %d)" % code)


def _check_scan_args(comps, progressive, ss, se, al):
    """The guards every scan routine runs before it writes (codes 1-3)."""
    ncomp = len(comps)
    if not 1 <= ncomp <= MAX_COMPS_IN_SCAN:
        raise scan_error(1)
    if ncomp > 1 and sum(int(c[2]) * int(c[3]) for c in comps) \
            > MAX_BLOCKS_IN_MCU:
        raise scan_error(2)
    if progressive and (ss > se or se > 63 or al > 13
                        or (ss > 0 and ncomp != 1) or (ss == 0 and se)):
        raise scan_error(3)


def _mcu_units(comps, m, mcus_x):
    """(component, unit index) of each data unit of MCU ``m``: one unit of
    a single component's scan, else each component's v x h units."""
    if len(comps) == 1:
        c = comps[0]
        return [(0, c[0] + (m // c[6]) * c[1] + m % c[6])]
    my, mx = divmod(m, mcus_x)
    return [(ci, c[0] + (my * c[3] + y) * c[1] + mx * c[2] + x)
            for ci, c in enumerate(comps)
            for y in range(c[3]) for x in range(c[2])]


def _to16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _extend(r, s):
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


class _Bits:
    """The Huffman decoders' bit reader over one segment of ``data``
    (past its end it reads zero bits) and libjpeg's table lookup."""

    def __init__(self, data, tables):
        self.data = data
        self.tabs = [(list(map(int, t[:18])), list(map(int, t[18:36])),
                      list(map(int, t[36:292])), list(map(int, t[292:])))
                     for t in tables]
        self.reset(0, 0)

    def reset(self, pos, end):
        self.pos, self.end, self.acc, self.n = pos, end, 0, 0

    def fill(self, need):
        acc, n, pos, end, data = self.acc, self.n, self.pos, self.end, \
            self.data
        while n < need:
            acc = (acc << 8) | (data[pos] if pos < end else 0)
            pos += 1
            n += 8
        self.acc, self.n, self.pos = acc & ((1 << n) - 1), n, pos

    def bits(self, k):
        if k == 0:
            return 0
        if self.n < k:
            self.fill(k)
        self.n -= k
        return (self.acc >> self.n) & ((1 << k) - 1)

    def huff(self, t):
        maxcode, valoff, huffval, look = self.tabs[t]
        if self.n < 8:
            self.fill(8)
        e = look[(self.acc >> (self.n - 8)) & 255]
        if e:
            self.n -= e >> 8
            return e & 255
        code = self.bits(9)
        length = 9
        while length < 17 and code > maxcode[length]:
            code = (code << 1) | self.bits(1)
            length += 1
        if length > 16:
            return 0            # a corrupt code reads as 0, as libjpeg
        return huffval[(valoff[length] + code) & 255]


def _segment(offsets, seg):
    """(start, end) of segment ``seg``; past the last one, an empty one."""
    nseg = len(offsets) - 1
    if seg < nseg:
        return int(offsets[seg]), int(offsets[seg + 1])
    return 0, 0


def decode_scan_python(data, offsets, coef, comps, mcus_x, mcus_y,
                       restart, ss, se, ah, al, progressive, tables):
    """Decode one Huffman-coded scan's segments into ``coef`` (int16
    (blocks, 64), each block in zigzag order). ``data``: the unstuffed
    segments end to end, ``offsets``: where each begins (and the end);
    ``comps``: int32 (n, 8) rows ``[first block, blocks a row, h, v, dc
    table, ac table, blocks wide, blocks high]``; ``tables``: int32 (8,
    TABLE_WORDS), DC tables 0-3 then AC 4-7. The twin of
    ``image_decode.cu``'s ``jpeg_decode_scan``, line for line, with its
    refusals (raised as :func:`scan_error`)."""
    _count("python", "huffman")
    _check_scan_args(comps, progressive, ss, se, al)
    comps = [list(map(int, c)) for c in comps]
    rd = _Bits(data, tables)
    bits, huff = rd.bits, rd.huff
    if len(comps) == 1:
        c = comps[0]
        total = c[6] * c[7]
    else:
        total = mcus_x * mcus_y
    pred = [0] * len(comps)
    eobrun = 0
    seg = -1
    for m in range(total):
        if m == 0 or (restart and m % restart == 0):
            seg += 1
            rd.reset(*_segment(offsets, seg))
            pred = [0] * len(comps)
            eobrun = 0
        for ci, b in _mcu_units(comps, m, mcus_x):
            blk = coef[b]
            dct, act = comps[ci][4] & 3, 4 + (comps[ci][5] & 3)
            if not progressive:
                s = huff(dct)
                if s > 15:
                    raise scan_error(4)
                if s:
                    s = _extend(bits(s), s)
                pred[ci] += s
                blk[0] = _to16(pred[ci])
                k = 1
                while k < 64:
                    rs = huff(act)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[min(k, 63)] = _extend(bits(s), s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            elif ss == 0:
                if ah == 0:
                    s = huff(dct)
                    if s > 15:
                        raise scan_error(4)
                    if s:
                        s = _extend(bits(s), s)
                    pred[ci] += s
                    blk[0] = _to16(pred[ci] << al)
                elif bits(1):
                    blk[0] = _to16(int(blk[0]) | (1 << al))
            elif ah == 0:
                if eobrun > 0:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = huff(act)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[min(k, 63)] = _to16(
                            _extend(bits(s), s) << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + bits(r) - 1
                        break
                    k += 1
            else:
                eobrun = _refine_ac(blk, eobrun, ss, se, al, act, huff,
                                    bits)
    return 0


def _refine_ac(blk, eobrun, ss, se, al, act, huff, bits):
    """One block of a progressive AC refinement scan (``jdphuff.c``'s
    ``decode_mcu_AC_refine``); -> the end-of-band run left."""
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = huff(act)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits(1) else m1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += bits(r)
                break
            while k <= se:
                z = min(k, 63)
                v = int(blk[z])
                if v != 0:
                    if bits(1) and (v & p1) == 0:
                        blk[z] = v + p1 if v >= 0 else v + m1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                blk[min(k, 63)] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            v = int(blk[k])
            if v != 0 and bits(1) and (v & p1) == 0:
                blk[k] = v + p1 if v >= 0 else v + m1
            k += 1
        eobrun -= 1
    return eobrun


#: ``jaricom.c``'s ``jpeg_aritab``, the QM coder's 113 states and the
#: fixed-probability state 113, each packed as libjpeg packs it:
#: ``(Qe << 16) | (next state after an MPS << 8) | (MPS switch << 7) |
#: next state after an LPS``
ARITAB = tuple((qe << 16) | (nm << 8) | (sw << 7) | nl
               for qe, nl, nm, sw in (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)))
#: the statistics bins of a DC and an AC conditioning table
DC_STAT_BINS, AC_STAT_BINS = 64, 256


class _Arith:
    """``jdarith.c``'s QM decoder over one segment of ``data`` (past its
    end it reads zero bytes, as libjpeg does after a marker), its
    statistics areas and its error latch (``ct == -1``)."""

    def __init__(self, data):
        self.data = data
        self.reset(0, 0)

    def reset(self, pos, end):
        """``process_restart``: every statistics area zeroed, the decoder
        set to read two initial bytes."""
        self.pos, self.end = pos, end
        self.c = self.a = 0
        self.ct = -16
        self.dc = [bytearray(DC_STAT_BINS) for _ in range(NUM_ARITH_TABLES)]
        self.ac = [bytearray(AC_STAT_BINS) for _ in range(NUM_ARITH_TABLES)]
        self.fixed = bytearray([113])

    def decode(self, st, i):
        """``arith_decode`` of bin ``st[i]``: -> 0 or 1."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                byte = self.data[self.pos] if self.pos < self.end else 0
                self.pos += 1
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = a - qe
        a = temp
        temp <<= ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7

    def _bits(self, st, i, m):
        v = m
        m >>= 1
        while m:
            if self.decode(st, i):
                v |= m
            m >>= 1
        return v


def _arith_dc(ar, tbl, ci, last_dc, ctx, cond):
    """One DC difference (``decode_mcu``/``decode_mcu_DC_first``): updates
    ``last_dc[ci]`` and ``ctx[ci]``; False on a bad code (the latch)."""
    st = ar.dc[tbl]
    s0 = ctx[ci]
    if ar.decode(st, s0) == 0:
        ctx[ci] = 0
        return True
    sign = ar.decode(st, s0 + 1)
    i = s0 + 2 + sign
    m = ar.decode(st, i)
    if m:
        i = 20
        while ar.decode(st, i):
            m <<= 1
            if m == 0x8000:
                ar.ct = -1
                return False
            i += 1
    low, up = cond[tbl][0], cond[tbl][1]
    if m < (1 << low) >> 1:
        ctx[ci] = 0
    elif m > (1 << up) >> 1:
        ctx[ci] = 12 + sign * 4
    else:
        ctx[ci] = 4 + sign * 4
    v = ar._bits(st, i + 14, m) + 1
    last_dc[ci] = (last_dc[ci] + (-v if sign else v)) & 0xFFFF
    return True


def _arith_ac(ar, tbl, blk, k, se, al, kx):
    """The AC coefficients ``k``..``se`` of one block (sequential
    ``decode_mcu`` and ``decode_mcu_AC_first``), each shifted left by
    ``al``; False on a bad code (the latch)."""
    st = ar.ac[tbl]
    while k <= se:
        i = 3 * (k - 1)
        if ar.decode(st, i):
            break                       # EOB
        while ar.decode(st, i + 1) == 0:
            i += 3
            k += 1
            if k > se:
                ar.ct = -1              # spectral overflow
                return False
        sign = ar.decode(ar.fixed, 0)
        i += 2
        m = ar.decode(st, i)
        if m and ar.decode(st, i):
            m <<= 1
            i = 189 if k <= kx else 217
            while ar.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    ar.ct = -1          # magnitude overflow
                    return False
                i += 1
        v = ar._bits(st, i + 14, m) + 1
        blk[k] = _to16((-v if sign else v) << al)
        k += 1
    return True


def _arith_ac_refine(ar, tbl, blk, ss, se, al):
    """One block of ``decode_mcu_AC_refine``; False on a bad code."""
    st = ar.ac[tbl]
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not blk[kex]:
        kex -= 1
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and ar.decode(st, i):
            break                       # EOB
        while True:
            v = int(blk[k])
            if v:
                if ar.decode(st, i + 2):
                    blk[k] = _to16(v + (m1 if v < 0 else p1))
                break
            if ar.decode(st, i + 1):
                blk[k] = m1 if ar.decode(ar.fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                ar.ct = -1              # spectral overflow
                return False
        k += 1
    return True


def _check_cond(cond):
    """Code 5: conditioning values outside what a DAC entry can hold."""
    for low, up, kx in cond:
        if not (0 <= low <= 15 and 0 <= up <= 15 and 0 <= kx <= 255):
            raise scan_error(5)


def decode_scan_arith_python(data, offsets, coef, comps, mcus_x, mcus_y,
                             restart, ss, se, ah, al, progressive, cond):
    """Decode one arithmetic-coded scan into ``coef``: the arguments of
    :func:`decode_scan_python` (the table numbers of ``comps`` are
    conditioning tables, 0-15), with ``cond`` int32 (16, 3), each table's
    L, U and K, in place of the Huffman tables. The twin of
    ``image_decode.cu``'s ``jpeg_decode_scan_arith`` (``jdarith.c``): a
    bad code latches the decoder, which leaves the rest of the segment's
    blocks as they are, as libjpeg does after its warning."""
    _count("python", "arithmetic")
    _check_scan_args(comps, progressive, ss, se, al)
    _check_cond(cond)
    comps = [list(map(int, c)) for c in comps]
    cond = [list(map(int, c)) for c in cond]
    ar = _Arith(data)
    if len(comps) == 1:
        c = comps[0]
        total = c[6] * c[7]
    else:
        total = mcus_x * mcus_y
    last_dc = [0] * len(comps)
    ctx = [0] * len(comps)
    seg = -1
    for m in range(total):
        if m == 0 or (restart and m % restart == 0):
            seg += 1
            ar.reset(*_segment(offsets, seg))
            last_dc = [0] * len(comps)
            ctx = [0] * len(comps)
        if ar.ct == -1:
            continue                    # the latch: nothing till a restart
        for ci, b in _mcu_units(comps, m, mcus_x):
            blk = coef[b]
            dct, act = comps[ci][4] & 15, comps[ci][5] & 15
            if not progressive:
                if not _arith_dc(ar, dct, ci, last_dc, ctx, cond):
                    break
                blk[0] = _to16(last_dc[ci])
                if not _arith_ac(ar, act, blk, 1, 63, 0, cond[act][2]):
                    break
            elif ss == 0 and ah == 0:
                if not _arith_dc(ar, dct, ci, last_dc, ctx, cond):
                    break
                blk[0] = _to16(last_dc[ci] << al)
            elif ss == 0:
                if ar.decode(ar.fixed, 0):
                    blk[0] = _to16(int(blk[0]) | (1 << al))
            elif ah == 0:
                if not _arith_ac(ar, act, blk, ss, se, al, cond[act][2]):
                    break
            elif not _arith_ac_refine(ar, act, blk, ss, se, al):
                break
    return 0


def _predict(psv, ra, rb, rc):
    """Predictor ``psv`` (``jdpred.c``) of the neighbours left, above and
    above-left."""
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1


def lossless_first_rows(comps, mcus_y, restart_rows):
    """Per component of a lossless scan, the rows its predictor takes as
    a first row (``jddiffct.c``): the first row of the scan and of each
    restart interval. libjpeg-turbo undifferences an iMCU row (an MCU row
    of an interleaved scan, ``v`` rows of a component scanned alone)
    after it decodes all of it, so in a component's own scan a restart
    within an iMCU row resets its first row."""
    out = []
    interleaved = len(comps) > 1
    for c in comps:
        v, height = c[3], c[7]
        rows = mcus_y if interleaved else height
        first = set()
        for mr in range(rows):
            if mr == 0 or (restart_rows and mr % restart_rows == 0):
                first.add(mr * v if interleaved else mr - mr % v)
        out.append(sorted(first))
    return out


def decode_scan_lossless_python(data, offsets, samples, comps, mcus_x,
                                mcus_y, restart, psv, pt, tables):
    """Decode one lossless (Huffman-coded) scan into ``samples`` (uint16,
    each component's plane row after row): ``comps`` rows ``[first
    sample, samples a row, h, v, dc table, 0, samples wide, samples
    high]``, the planes padded to whole MCUs as :func:`decode_scan_python`
    pads its blocks; ``psv`` the predictor, ``pt`` the point transform;
    ``tables`` as :func:`decode_scan_python`'s (DC tables only). Each
    sample is its difference (``jdlhuff.c``: category 16 is 32768 and
    reads no bits) plus its prediction, modulo 2**16, not yet scaled by
    ``pt``; the padding holds the differences. The twin of
    ``image_decode.cu``'s ``jpeg_decode_scan_lossless``."""
    _count("python", "lossless")
    _check_scan_args(comps, False, 0, 63, 0)
    if not 1 <= psv <= 7 or not 0 <= pt < 8:
        raise scan_error(3)
    comps = [list(map(int, c)) for c in comps]
    interleaved = len(comps) > 1
    per_row = mcus_x if interleaved else comps[0][6]
    rows = mcus_y if interleaved else comps[0][7]
    if restart % per_row:
        raise scan_error(6)
    restart_rows = restart // per_row
    rd = _Bits(data, tables)
    bits, huff = rd.bits, rd.huff
    seg = -1
    for mr in range(rows):
        if mr == 0 or (restart_rows and mr % restart_rows == 0):
            seg += 1
            rd.reset(*_segment(offsets, seg))
        for m in range(mr * per_row, (mr + 1) * per_row):
            for ci, at in _mcu_units(comps, m, mcus_x):
                s = huff(comps[ci][4] & 3)
                if s > 16:
                    raise scan_error(4)
                if s == 16:
                    d = 32768
                elif s:
                    d = _extend(bits(s), s)
                else:
                    d = 0
                samples[at] = d & 0xFFFF
    initial = 1 << (8 - pt - 1)
    for c, first in zip(comps, lossless_first_rows(comps, mcus_y,
                                                    restart_rows)):
        at, stride, width, height = c[0], c[1], c[6], c[7]
        first = set(first)
        plane = samples[at:at + stride * height].reshape(height, stride)
        for r in range(height):
            row = [int(x) for x in plane[r, :width]]
            above = [int(x) for x in plane[r - 1, :width]] if r else None
            if r in first:
                ra = (row[0] + initial) & 0xFFFF
                row[0] = ra
                for x in range(1, width):
                    ra = (row[x] + ra) & 0xFFFF
                    row[x] = ra
            else:
                ra = (row[0] + above[0]) & 0xFFFF
                row[0] = ra
                for x in range(1, width):
                    ra = (row[x] + _predict(psv, ra, above[x],
                                            above[x - 1])) & 0xFFFF
                    row[x] = ra
            plane[r, :width] = row
    return 0


# -- the entropy decode: the native routines -------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "jpeg_decode_scan": (_I, [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P]),
    "jpeg_decode_scan_arith": (_I, [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _P]),
    "jpeg_decode_scan_lossless": (_I, [_P, _P, _I, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _P]),
    "png_unfilter": (_I, [_P, _P, _I, _I, _I]),
}


def native_library():
    """``csrc/image_decode.cu`` built with the toolkit (``kernels.py``)
    and bound with ctypes. A build failure raises."""
    from veles_torch import kernels
    return kernels.load("image_decode", SIGNATURES)


def _native_args(data, offsets, out, comps, mcus_x, mcus_y, table,
                 dtype, table_shape):
    """The arrays of a native scan routine, each checked before a pointer
    to it is passed: the segments' offsets within ``data``, ``out`` a
    C-contiguous array of ``dtype`` that holds every data unit the rows
    of ``comps`` place (and, in a lossless scan, every sample its
    predictor reads), ``table`` of ``table_shape``."""
    buf = numpy.frombuffer(data, numpy.uint8) if len(data) \
        else numpy.zeros(1, numpy.uint8)
    offsets = numpy.ascontiguousarray(offsets, numpy.int64)
    if len(offsets) < 1 or offsets[0] < 0 or offsets[-1] > len(data) \
            or (numpy.diff(offsets) < 0).any():
        raise ValueError("scan segment offsets outside the scan's data")
    comps = numpy.ascontiguousarray(comps, numpy.int32)
    table = numpy.ascontiguousarray(table, numpy.int32)
    if out.dtype != dtype or not out.flags.c_contiguous:
        raise ValueError("scan output must be C-contiguous %s" % dtype)
    if table.shape != table_shape or comps.ndim != 2 \
            or comps.shape[1] != 8:
        raise ValueError("bad scan tables or component rows")
    units = len(out)
    for first, stride, h, v, _, _, wide, high in comps.tolist():
        if len(comps) > 1:
            wide, high = max(wide, mcus_x * h), max(high, mcus_y * v)
        if min(first, h, v, wide, high) < 0 or stride < wide \
                or first + (high - 1) * stride + wide > units:
            raise ValueError("scan component rows outside the output")
    return buf, offsets, comps, table


def decode_scan_native(data, offsets, coef, comps, mcus_x, mcus_y,
                       restart, ss, se, ah, al, progressive, tables):
    """:func:`decode_scan_python`'s arguments, decoded by the native
    routine (it releases the interpreter while it runs)."""
    lib = native_library()
    _count("native", "huffman")
    buf, offsets, comps, tables = _native_args(
        data, offsets, coef, comps, mcus_x, mcus_y, tables, numpy.int16,
        (8, TABLE_WORDS))
    rc = lib.jpeg_decode_scan(
        buf.ctypes.data, offsets.ctypes.data, len(offsets) - 1,
        coef.ctypes.data, comps.ctypes.data, len(comps), mcus_x, mcus_y,
        restart, ss, se, ah, al, int(progressive), tables.ctypes.data)
    if rc:
        raise scan_error(rc)
    return rc


def decode_scan_arith_native(data, offsets, coef, comps, mcus_x, mcus_y,
                             restart, ss, se, ah, al, progressive, cond):
    """:func:`decode_scan_arith_python`'s arguments, decoded by the native
    routine (it releases the interpreter while it runs)."""
    lib = native_library()
    _count("native", "arithmetic")
    buf, offsets, comps, cond = _native_args(
        data, offsets, coef, comps, mcus_x, mcus_y, cond, numpy.int16,
        (NUM_ARITH_TABLES, 3))
    rc = lib.jpeg_decode_scan_arith(
        buf.ctypes.data, offsets.ctypes.data, len(offsets) - 1,
        coef.ctypes.data, comps.ctypes.data, len(comps), mcus_x, mcus_y,
        restart, ss, se, ah, al, int(progressive), cond.ctypes.data)
    if rc:
        raise scan_error(rc)
    return rc


def decode_scan_lossless_native(data, offsets, samples, comps, mcus_x,
                                mcus_y, restart, psv, pt, tables):
    """:func:`decode_scan_lossless_python`'s arguments, decoded by the
    native routine (it releases the interpreter while it runs)."""
    lib = native_library()
    _count("native", "lossless")
    buf, offsets, comps, tables = _native_args(
        data, offsets, samples, comps, mcus_x, mcus_y, tables, numpy.uint16,
        (8, TABLE_WORDS))
    rc = lib.jpeg_decode_scan_lossless(
        buf.ctypes.data, offsets.ctypes.data, len(offsets) - 1,
        samples.ctypes.data, comps.ctypes.data, len(comps), mcus_x, mcus_y,
        restart, psv, pt, tables.ctypes.data)
    if rc:
        raise scan_error(rc)
    return rc


# -- coefficients -> samples (numpy, every block at once) ----------------

_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
        "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
        "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
        "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
_CONST_BITS, _PASS1_BITS = 13, 2


def _wrap(v, bits):
    """int64 ``v`` modulo ``2**bits`` as a signed lane of that width (a
    check of its range first: on an encoder's coefficients nothing
    wraps)."""
    half = 1 << (bits - 1)
    if v.size and (v.min() < -half or v.max() >= half):
        v = ((v + half) & ((1 << bits) - 1)) - half
    return v


def _wrap16(v):
    return _wrap(v, 16)


def _saturate16(v):
    if v.size and (v.min() < -32768 or v.max() > 32767):
        v = numpy.clip(v, -32768, 32767)
    return v


def _simd_pass_terms(y):
    """One pass of libjpeg-turbo's x86-64 SIMD ISLOW IDCT
    (``jidctint-sse2.asm``, ``jidctint-avx2.asm``) before its descale,
    over ``y``: the 16-bit lane sums ``(in0 + in4) << 13``,
    ``(in0 - in4) << 13``, then ``in2, in6, in7, in5, in3, in1``, then the
    16-bit lane sums ``in7 + in3`` and ``in5 + in1`` (``paddw``: each
    wraps to 16 bits). Every output is an integer linear combination of
    these 10 terms (``jidctint.c``'s butterfly with its multiplies folded
    into ``pmaddwd`` pairs); the SIMD code sums it in 32-bit lanes,
    modulo 2**32."""
    f = _FIX
    a, b, z2, z3, t0, t1, t2, t3, s3, s4 = y
    tmp3 = z2 * (f["0_541196100"] + f["0_765366865"]) \
        + z3 * f["0_541196100"]
    tmp2 = z2 * f["0_541196100"] \
        + z3 * (f["0_541196100"] - f["1_847759065"])
    tmp10, tmp13 = a + tmp3, a - tmp3
    tmp11, tmp12 = b + tmp2, b - tmp2
    z3 = s3 * (f["1_175875602"] - f["1_961570560"]) + s4 * f["1_175875602"]
    z4 = s3 * f["1_175875602"] + s4 * (f["1_175875602"] - f["0_390180644"])
    o0 = t0 * (f["0_298631336"] - f["0_899976223"]) \
        - t3 * f["0_899976223"] + z3
    o3 = -t0 * f["0_899976223"] \
        + t3 * (f["1_501321110"] - f["0_899976223"]) + z4
    o1 = t1 * (f["2_053119869"] - f["2_562915447"]) \
        - t2 * f["2_562915447"] + z4
    o2 = -t1 * f["2_562915447"] \
        + t2 * (f["3_072711026"] - f["2_562915447"]) + z3
    return [tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
            tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3]


#: the pass as an 8x10 integer matrix over its 10 terms, in float64: the
#: terms are below 2**28 and the entries below 2**16, so every product
#: and partial sum is an integer below 2**47, which a float64 product
#: holds exactly; the 32-bit lanes' wrap is taken once on the sum (a
#: wrap modulo 2**32 of each partial sum gives the same residue)
_IDCT = numpy.array(_simd_pass_terms(list(numpy.eye(10, dtype=numpy.int64))),
                    numpy.float64)
#: the 10 terms of 8 inputs where no 16-bit sum wraps
_TERMS = numpy.zeros((10, 8), numpy.float64)
_TERMS[0, (0, 4)] = _TERMS[1, 0] = 1 << _CONST_BITS
_TERMS[1, 4] = -(1 << _CONST_BITS)
_TERMS[range(2, 8), (2, 6, 7, 5, 3, 1)] = 1
_TERMS[8, (7, 3)] = _TERMS[9, (5, 1)] = 1
#: the pass over its 8 inputs where nothing wraps or saturates: exactly
#: ``jidctint.c``'s (integer entries, row sums of magnitudes 61214: an
#: input below 2**14 keeps every sum below 2**31)
_IDCT_LINEAR = _IDCT @ _TERMS


def _descale(v, shift):
    out = v.astype(numpy.int64)
    out += 1 << (shift - 1)
    out >>= shift
    return out


def _idct_pass(x, shift):
    """One pass of the SIMD code over ``x`` (8, m) int64 holding int16
    inputs, input k in row k -> (8, m) int64: descaled by ``shift``
    (rounded, modulo 2**32 as ``paddd``/``psrad``) and saturated to
    int16 (``packssdw``)."""
    y = numpy.empty((10,) + x.shape[1:], numpy.int64)
    y[0] = _wrap16(x[0] + x[4]) << _CONST_BITS
    y[1] = _wrap16(x[0] - x[4]) << _CONST_BITS
    y[2:8] = x[[2, 6, 7, 5, 3, 1]]
    y[8] = _wrap16(x[7] + x[3])
    y[9] = _wrap16(x[5] + x[1])
    out = numpy.einsum("ok,km->om", _IDCT, y).astype(numpy.int64)
    out += 1 << (shift - 1)
    out = _wrap(out, 32)
    out >>= shift
    return _saturate16(out)


def _idct_simd(x, n):
    """:func:`idct_islow`'s passes lane for lane over dequantized ``x``
    (n, 64) int64 in natural order -> (8, n * 8) int64 outputs."""
    x = _wrap16(x)
    cols = x.reshape(n, 8, 8).transpose(1, 0, 2).reshape(8, n * 8)
    ws = _idct_pass(cols, _CONST_BITS - _PASS1_BITS).reshape(8, n, 8)
    dc_only = ~x.reshape(n, 8, 8)[:, 1:].any((1, 2))
    ws[:, dc_only] = _wrap16(x.reshape(n, 8, 8)[dc_only, 0]
                             << _PASS1_BITS)[None]
    rows = ws.transpose(2, 1, 0).reshape(8, n * 8)
    return _idct_pass(rows, _CONST_BITS + _PASS1_BITS + 3)


def idct_islow(blocks, quant):
    """libjpeg-turbo's ISLOW IDCT of every block as Pillow runs it on
    x86-64, its SIMD code (``jidctint-sse2.asm``, ``jidctint-avx2.asm``):
    ``blocks`` (N, 64) int16 in zigzag order, ``quant`` (64,) in natural
    order -> (N, 8, 8) uint8. The SIMD code dequantizes with a 16-bit
    multiply (``pmullw``; the quantizer held as a short, as
    ``jddctmgr.c`` holds it), runs pass 1 over the columns into an int16
    workspace (a block whose coefficient rows 1-7 are all zero takes the
    shortcut of its dequantized row 0 shifted left by ``PASS1_BITS`` in
    16-bit lanes), pass 2 over the rows, and saturates to -128..127
    (``packsswb``) before centring on 128. Where no lane wraps or
    saturates, as on every block an encoder writes, that is
    ``jidctint.c``'s arithmetic: one product a pass with
    :data:`_IDCT_LINEAR` over every block (an ``einsum``: no BLAS threads
    under the loader's decode threads), checked by the ranges of its
    inputs and outputs; else the lanes are emulated
    (:func:`_idct_simd`), which is what Pillow gives on the out-of-range
    coefficients of a corrupt scan (``jidctint.c`` would wrap there)."""
    n = len(blocks)
    x = numpy.empty((n, 64), numpy.int64)
    x[:, NATURAL] = blocks
    quant = numpy.asarray(quant, numpy.int64)
    x *= quant
    out = None
    if n and quant.max() < 32768 and numpy.abs(x).max() < 1 << 13:
        # pass 1: the columns; input k is coefficient row k
        cols = x.reshape(n, 8, 8).transpose(1, 0, 2).reshape(8, n * 8)
        ws = _descale(numpy.einsum("ok,km->om", _IDCT_LINEAR, cols),
                      _CONST_BITS - _PASS1_BITS).reshape(8, n, 8)
        if numpy.abs(ws).max() < 1 << 14:
            # pass 2: the rows; input k is the workspace's column k
            rows = ws.transpose(2, 1, 0).reshape(8, n * 8)
            out = _descale(numpy.einsum("ok,km->om", _IDCT_LINEAR, rows),
                           _CONST_BITS + _PASS1_BITS + 3)
            if out.min() < -512 or out.max() > 511:
                out = None
    if out is None:
        out = _idct_simd(x, n) if n else numpy.zeros((8, 0), numpy.int64)
    numpy.clip(out, -128, 127, out=out)
    out += 128
    return out.astype(numpy.uint8).reshape(8, n, 8).transpose(1, 2, 0)


def _edge(p, axis, step):
    """``p`` shifted one sample along ``axis`` (``step`` -1: the previous
    sample, +1: the next), the edge sample repeated."""
    n = p.shape[axis]
    idx = numpy.clip(numpy.arange(n) + step, 0, n - 1)
    return numpy.take(p, idx, axis=axis)


def upsample(plane, fh, fv):
    """``jdsample.c``'s upsampling of one component's (h, w) samples by
    integral factors (``fh``, ``fv``), fancy where libjpeg-turbo's
    defaults use it."""
    p = plane.astype(numpy.int32)
    h, w = p.shape
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) == (2, 1) and w > 2:
        out = numpy.empty((h, 2 * w), numpy.int32)
        out[:, 0::2] = (3 * p + _edge(p, 1, -1) + 1) >> 2
        out[:, 1::2] = (3 * p + _edge(p, 1, 1) + 2) >> 2
        return out.astype(numpy.uint8)
    if (fh, fv) == (1, 2):
        out = numpy.empty((2 * h, w), numpy.int32)
        out[0::2] = (3 * p + _edge(p, 0, -1) + 1) >> 2
        out[1::2] = (3 * p + _edge(p, 0, 1) + 2) >> 2
        return out.astype(numpy.uint8)
    if (fh, fv) == (2, 2) and w > 2:
        out = numpy.empty((2 * h, 2 * w), numpy.int32)
        for v, near in ((0, -1), (1, 1)):
            col = 3 * p + _edge(p, 0, near)
            out[v::2, 0::2] = (3 * col + _edge(col, 1, -1) + 8) >> 4
            out[v::2, 1::2] = (3 * col + _edge(col, 1, 1) + 7) >> 4
        return out.astype(numpy.uint8)
    return numpy.repeat(numpy.repeat(plane, fv, axis=0), fh, axis=1)


def _ycc_tables():
    x = numpy.arange(256, dtype=numpy.int32) - 128
    half = 1 << 15
    cr_r = (91881 * x + half) >> 16
    cb_b = (116130 * x + half) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr):
    """``jdcolor.c``'s ``ycc_rgb_convert`` -> (H, W, 3) int32, not yet
    range-limited (every term fits 32 bits, as libjpeg's ``int``
    tables)."""
    y = y.astype(numpy.int32)
    return numpy.stack([y + _CR_R[cr],
                        y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                        y + _CB_B[cb]], axis=-1)


def _table_ok(tables, t, max_symbol):
    """Whether Huffman table ``t`` of ``tables`` is defined, libjpeg
    derives it, and its symbols are at most ``max_symbol`` (a DC table's
    are bit counts: 15 at most, 16 in a lossless frame)."""
    return t in tables and tables[t][0] is not None \
        and tables[t][1] <= max_symbol


def _huffman_tables(scan):
    tables = numpy.zeros((8, TABLE_WORDS), numpy.int32)
    for t, (tab, _) in scan["dc"].items():
        if tab is not None:
            tables[t] = tab
    for t, (tab, _) in scan["ac"].items():
        if tab is not None:
            tables[4 + t] = tab
    return tables


def _layout(frame, unit):
    """Per component (first unit, units a row, unit rows) of the frame's
    planes padded to whole MCUs, and the MCUs across and down; ``unit``:
    8 (blocks of a DCT frame) or 1 (samples of a lossless frame)."""
    comps = frame.components
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    mcus_x = -(-frame.width // (unit * max_h))
    mcus_y = -(-frame.height // (unit * max_v))
    layout, first = [], 0
    for _, h, v, _ in comps:
        layout.append((first, mcus_x * h, mcus_y * v))
        first += mcus_x * h * mcus_y * v
    return layout, first, mcus_x, mcus_y


def _scan_rows(frame, scan, layout, unit):
    """The scan's ``comps`` rows of the scan routines."""
    comps = frame.components
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    rows = []
    for ci, td, ta in scan["comps"]:
        _, h, v, _ = comps[ci]
        rows.append([layout[ci][0], layout[ci][1], h, v, td, ta,
                     -(-(frame.width * h) // (unit * max_h)),
                     -(-(frame.height * v) // (unit * max_v))])
    return numpy.array(rows, numpy.int32)


def coefficients(frame, native):
    """Run every scan's entropy decode of a DCT frame (Huffman or
    arithmetic) -> (coef (blocks, 64) int16, per component (first block,
    blocks a row, blocks high))."""
    layout, total, mcus_x, mcus_y = _layout(frame, 8)
    coef = numpy.zeros((total, 64), numpy.int16)
    arith = frame.coding == "arithmetic"
    if arith:
        decode = decode_scan_arith_native if native \
            else decode_scan_arith_python
    else:
        decode = decode_scan_native if native else decode_scan_python
    prog = frame.progressive
    for scan in frame.scans:
        if not arith:
            for _, td, ta in scan["comps"]:
                if (not prog or (scan["ss"] == 0 and scan["ah"] == 0)) \
                        and not _table_ok(scan["dc"], td, 15) \
                        or (not prog or scan["ss"] > 0) \
                        and not _table_ok(scan["ac"], ta, 255):
                    raise ValueError("JPEG scan uses an undefined or bad "
                                     "Huffman table")
        segs = scan["segments"]
        offsets = numpy.cumsum([0] + [len(s) for s in segs])
        ss, se = scan["ss"], scan["se"]
        if not prog:
            ss, se = 0, 63
        decode(b"".join(segs), offsets, coef,
               _scan_rows(frame, scan, layout, 8), mcus_x, mcus_y,
               scan["restart"], ss, se, scan["ah"], scan["al"], prog,
               scan["cond"] if arith else _huffman_tables(scan))
    return coef, layout


def samples(frame, native):
    """Run every scan's entropy decode and undifferencing of a lossless
    frame -> (samples uint16, per component (first sample, samples a row,
    rows)), the planes padded to whole MCUs and not yet scaled by the
    point transform. -> also each component's point transform (that of
    the last scan that holds it)."""
    layout, total, mcus_x, mcus_y = _layout(frame, 1)
    out = numpy.zeros(total, numpy.uint16)
    decode = decode_scan_lossless_native if native \
        else decode_scan_lossless_python
    pts = [0] * len(frame.components)
    for scan in frame.scans:
        for ci, td, _ in scan["comps"]:
            if not _table_ok(scan["dc"], td, 16):
                raise ValueError("JPEG scan uses an undefined or bad "
                                 "Huffman table")
            pts[ci] = scan["al"]
        segs = scan["segments"]
        offsets = numpy.cumsum([0] + [len(s) for s in segs])
        decode(b"".join(segs), offsets, out,
               _scan_rows(frame, scan, layout, 1), mcus_x, mcus_y,
               scan["restart"], scan["ss"], scan["al"],
               _huffman_tables(scan))
    return out, layout, pts


def entropy_decode(frame, native):
    """The frame's entropy-decoded output: :func:`coefficients` of a DCT
    frame, :func:`samples` of a lossless one (without the point
    transforms) -> (array, layout)."""
    if frame.coding == "lossless":
        return samples(frame, native)[:2]
    return coefficients(frame, native)


def _planes(frame, native, path):
    """Each component's (h, w) uint8 samples at its own sampling, and
    whether libjpeg-turbo upsamples them fancily (a DCT frame) or by
    replication (a lossless frame: its data unit of one sample turns
    fancy upsampling off, ``jdsample.c``)."""
    comps = frame.components
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    out = []
    if frame.coding == "lossless":
        values, layout, pts = samples(frame, native)
        for (_, h, v, _), (first, sw, sh), pt in zip(comps, layout, pts):
            plane = values[first:first + sw * sh].reshape(sh, sw)
            dw = -(-(frame.width * h) // max_h)
            dh = -(-(frame.height * v) // max_v)
            # jdlossls.c's scaling: (JSAMPLE)(sample << Pt)
            out.append(((plane[:dh, :dw].astype(numpy.int32) << pt)
                        & 0xFF).astype(numpy.uint8))
        return out, False
    for c in comps:
        if c[3] not in frame.quant:
            raise ValueError("%s: undefined quantization table" % path)
    coef, layout = coefficients(frame, native)
    for (_, h, v, tq), (first, bw, bh) in zip(comps, layout):
        blocks = idct_islow(coef[first:first + bw * bh], frame.quant[tq])
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(bh * 8, bw * 8)
        dw = -(-(frame.width * h) // max_h)
        dh = -(-(frame.height * v) // max_v)
        out.append(plane[:dh, :dw])
    return out, True


def _colour_space(frame):
    """The frame's colour space as libjpeg guesses it (``jdapimin.c``):
    ``L``, ``RGB``, ``YCbCr``, ``CMYK`` or ``YCCK``."""
    n = len(frame.components)
    if n == 1:
        return "L"
    if n == 3:
        ids = tuple(c[0] for c in frame.components)
        if frame.jfif:
            return "YCbCr"
        if frame.adobe_transform is not None:
            return "RGB" if frame.adobe_transform == 0 else "YCbCr"
        return "RGB" if ids == (82, 71, 66) else "YCbCr"
    if frame.adobe_transform is not None and frame.adobe_transform != 0:
        return "YCCK"
    return "CMYK"


def decode(data, path="<bytes>", native=False):
    """JPEG bytes -> ``(pixels, mode)`` as Pillow opens them: (H, W, 1)
    ``L``, (H, W, 3) ``RGB`` or (H, W, 4) ``CMYK`` uint8. ``native``: the
    entropy decode runs in ``csrc/image_decode.cu`` (else in its Python
    twin)."""
    frame = parse(data, path)
    comps = frame.components
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    for _, h, v, _ in comps:
        if max_h % h or max_v % v:
            raise ValueError("%s: fractional sampling is not implemented "
                             "(by libjpeg either)" % path)
    space = _colour_space(frame)
    if frame.coding == "lossless" and space in ("YCbCr", "YCCK"):
        # jdcolor.c converts no colours of a lossless frame: libjpeg-turbo
        # refuses Pillow's request for RGB or CMYK
        raise ValueError("%s: a lossless JPEG in %s: libjpeg-turbo converts "
                         "no colours of a lossless frame" % (path, space))
    own, fancy = _planes(frame, native, path)
    planes = []
    for (_, h, v, _), plane in zip(comps, own):
        if fancy:
            plane = upsample(plane, max_h // h, max_v // v)
        else:
            plane = numpy.repeat(numpy.repeat(plane, max_v // v, axis=0),
                                 max_h // h, axis=1)
        planes.append(plane[:frame.height, :frame.width])
    if space == "L":
        return planes[0][:, :, None], "L"
    if space == "RGB":
        return numpy.stack(planes, -1), "RGB"
    if space == "YCbCr":
        rgb = ycc_to_rgb(*planes)
        return numpy.clip(rgb, 0, 255).astype(numpy.uint8), "RGB"
    if space == "YCCK":
        cmy = 255 - ycc_to_rgb(*planes[:3])
        cmyk = numpy.concatenate([numpy.clip(cmy, 0, 255),
                                  planes[3][:, :, None]], -1)
    else:
        cmyk = numpy.stack(planes, -1).astype(numpy.int32)
    return (255 - cmyk).astype(numpy.uint8), "CMYK"
