"""JPEG decoding of the port: libjpeg-turbo's default path, bit for bit.

The reference decodes with Pillow, which runs libjpeg-turbo with its
defaults (``veles/loader/image.py``). This module reads the same files
and gives the same pixels:

* **what it reads**: Huffman-coded baseline and extended sequential
  (SOF0/SOF1) and progressive (SOF2) JPEG of 8-bit samples, with 1, 3 or
  4 components (grey; YCbCr or RGB; Adobe CMYK or YCCK), any integral
  sampling factors, restart intervals, any size. Arithmetic-coded,
  12-bit and lossless JPEG raise :class:`NotImplementedError` naming
  ROADMAP Queue 1 #6c; what libjpeg refuses (hierarchical processes,
  fractional sampling, 2 components) raises :class:`ValueError`.
* **the entropy decode** (Huffman codes -> quantised coefficient blocks,
  progressive refinement included) runs in the native routine of
  ``csrc/image_decode.cu`` when ``native`` is asked for, and else in
  :func:`decode_scan_python`, its twin: the same arguments, the same
  coefficients. The caller declares which; neither stands in for the
  other.
* **the stages after it** run in numpy over every block at once:
  dequantization, the ISLOW integer IDCT (``jidctint.c``), fancy
  upsampling (``jdsample.c``: h2v1, h2v2, h1v2; box replication for
  other integral factors and for planes 2 samples wide or less) and the
  fixed-point YCbCr -> RGB tables (``jdcolor.c``); YCCK -> CMYK as
  ``ycck_cmyk_convert``; CMYK inverted as Pillow's ``CMYK;I`` raw mode.

The scan's bytes are cut at its restart markers and unstuffed (``FF 00``
-> ``FF``) here, so each decoder reads plain segments and resets its DC
predictors and end-of-band run at each one. A segment that ends early
reads as zero bits, as libjpeg's does.
"""

import ctypes

import numpy

#: what NotImplementedError names for a JPEG process not decoded yet
LATER = "ROADMAP Queue 1 #6c"

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

#: scans entropy-decoded in this process, by routine (``native``, the
#: ``python`` twin): a run on the card shows its decode never took the twin
scans = {"native": 0, "python": 0}

_SOF_DECODED = {0xC0: False, 0xC1: False, 0xC2: True}
_SOF_LATER = {0xC3: "a lossless JPEG", 0xC9: "an arithmetic-coded JPEG",
              0xCA: "an arithmetic-coded JPEG",
              0xCB: "an arithmetic-coded lossless JPEG"}
_SOF_REFUSED = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF)
#: libjpeg's limits (jpeglib.h, jmorecfg.h): components a scan, blocks an
#: interleaved MCU, Huffman and quantization tables, the longest side
MAX_COMPS_IN_SCAN = 4
MAX_BLOCKS_IN_MCU = 10
NUM_TABLES = 4
MAX_DIMENSION = 65500


def _later(path, what):
    raise NotImplementedError("%s: %s is not decoded by the port yet (%s)"
                              % (path, what, LATER))


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
    scans (each with the Huffman tables and restart interval in force)."""

    def __init__(self):
        self.width = self.height = 0
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
        if marker in _SOF_LATER:
            _later(path, _SOF_LATER[marker])
        if marker in _SOF_REFUSED:
            raise ValueError("%s: unsupported JPEG process (SOF%d)"
                             % (path, marker - 0xC0))
        if marker in _SOF_DECODED:
            if len(body) < 6:
                raise ValueError("%s: bad JPEG frame header" % path)
            if body[0] != 8:
                _later(path, "a %d-bit JPEG" % body[0])
            if frame.components:
                raise ValueError("%s: more than one JPEG frame header"
                                 % path)
            frame.progressive = _SOF_DECODED[marker]
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
            segs, pos = _segments(data, pos)
            frame.scans.append({
                "comps": comps, "ss": ss, "se": se, "ah": a >> 4,
                "al": a & 15, "restart": restart, "segments": segs,
                "dc": dict(dc), "ac": dict(ac)})
    if not frame.scans:
        raise ValueError("%s: JPEG without a scan" % path)
    return frame


def _check_scan(path, frame, comps, ss, se, ah, al):
    """libjpeg's refusals of a scan header: an interleaved MCU of more
    than :data:`MAX_BLOCKS_IN_MCU` blocks (``jdinput.c``), and in a
    progressive frame a spectral band or successive approximation the
    process does not allow (``jdphuff.c``). A sequential scan's Ss, Se,
    Ah and Al are only warned about there, and ignored."""
    if len(comps) > 1 and sum(frame.components[ci][1]
                              * frame.components[ci][2]
                              for ci, _, _ in comps) > MAX_BLOCKS_IN_MCU:
        raise ValueError("%s: JPEG MCU of more than %d blocks"
                         % (path, MAX_BLOCKS_IN_MCU))
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


# -- the entropy decode: the Python twin ---------------------------------

def scan_error(code):
    """The error of a scan that ``jpeg_decode_scan`` (and its twin)
    returned ``code`` for."""
    return ValueError("corrupt JPEG scan (decoder code %d)" % code)


def decode_scan_python(data, offsets, coef, comps, mcus_x, mcus_y,
                       restart, ss, se, ah, al, progressive, tables):
    """Decode one scan's segments into ``coef`` (int16 (blocks, 64), each
    block in zigzag order). ``data``: the unstuffed segments end to end,
    ``offsets``: where each begins (and the end); ``comps``: int32 (n, 8)
    rows ``[first block, blocks a row, h, v, dc table, ac table, blocks
    wide, blocks high]``; ``tables``: int32 (8, TABLE_WORDS), DC tables
    0-3 then AC 4-7. The twin of ``image_decode.cu``'s
    ``jpeg_decode_scan``, line for line, with its refusals (raised as
    :func:`scan_error`)."""
    scans["python"] += 1
    ncomp = len(comps)
    if not 1 <= ncomp <= MAX_COMPS_IN_SCAN:
        raise scan_error(1)
    if ncomp > 1 and sum(int(c[2]) * int(c[3]) for c in comps) \
            > MAX_BLOCKS_IN_MCU:
        raise scan_error(2)
    if progressive and (ss > se or se > 63 or al > 13
                        or (ss > 0 and ncomp != 1) or (ss == 0 and se)):
        raise scan_error(3)
    comps = [list(map(int, c)) for c in comps]
    tabs = [(list(map(int, t[:18])), list(map(int, t[18:36])),
             list(map(int, t[36:292])), list(map(int, t[292:])))
            for t in tables]
    nseg = len(offsets) - 1
    blocks = coef
    # the bit reader's state
    st = {"pos": 0, "end": 0, "acc": 0, "n": 0}

    def fill(need):
        acc, n, pos, end = st["acc"], st["n"], st["pos"], st["end"]
        while n < need:
            acc = (acc << 8) | (data[pos] if pos < end else 0)
            pos += 1
            n += 8
        st["acc"], st["n"], st["pos"] = acc & ((1 << n) - 1), n, pos

    def bits(k):
        if k == 0:
            return 0
        if st["n"] < k:
            fill(k)
        st["n"] -= k
        return (st["acc"] >> st["n"]) & ((1 << k) - 1)

    def huff(t):
        maxcode, valoff, huffval, look = tabs[t]
        if st["n"] < 8:
            fill(8)
        e = look[(st["acc"] >> (st["n"] - 8)) & 255]
        if e:
            st["n"] -= e >> 8
            return e & 255
        code = bits(9)
        length = 9
        while length < 17 and code > maxcode[length]:
            code = (code << 1) | bits(1)
            length += 1
        if length > 16:
            return 0            # a corrupt code reads as 0, as libjpeg
        return huffval[(valoff[length] + code) & 255]

    def extend(r, s):
        return r - (1 << s) + 1 if r < (1 << (s - 1)) else r

    def to16(v):
        return ((v + 0x8000) & 0xFFFF) - 0x8000

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
            st["pos"] = int(offsets[seg]) if seg < nseg else 0
            st["end"] = int(offsets[seg + 1]) if seg < nseg else 0
            st["acc"] = st["n"] = 0
            pred = [0] * len(comps)
            eobrun = 0
        if len(comps) == 1:
            c = comps[0]
            where = [(0, c[0] + (m // c[6]) * c[1] + m % c[6])]
        else:
            my, mx = divmod(m, mcus_x)
            where = [(ci, c[0] + (my * c[3] + y) * c[1] + mx * c[2] + x)
                     for ci, c in enumerate(comps)
                     for y in range(c[3]) for x in range(c[2])]
        for ci, b in where:
            blk = blocks[b]
            dct, act = comps[ci][4], 4 + comps[ci][5]
            if not progressive:
                s = huff(dct)
                if s > 15:
                    raise scan_error(4)
                if s:
                    s = extend(bits(s), s)
                pred[ci] += s
                blk[0] = to16(pred[ci])
                k = 1
                while k < 64:
                    rs = huff(act)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[min(k, 63)] = extend(bits(s), s)
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
                        s = extend(bits(s), s)
                    pred[ci] += s
                    blk[0] = to16(pred[ci] << al)
                elif bits(1):
                    blk[0] = to16(int(blk[0]) | (1 << al))
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
                        blk[min(k, 63)] = to16(
                            extend(bits(s), s) << al)
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


# -- the entropy decode: the native routine --------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "jpeg_decode_scan": (_I, [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P]),
    "png_unfilter": (_I, [_P, _P, _I, _I, _I]),
}


def native_library():
    """``csrc/image_decode.cu`` built with the toolkit (``kernels.py``)
    and bound with ctypes. A build failure raises."""
    from veles_torch import kernels
    return kernels.load("image_decode", SIGNATURES)


def decode_scan_native(data, offsets, coef, comps, mcus_x, mcus_y,
                       restart, ss, se, ah, al, progressive, tables):
    """:func:`decode_scan_python`'s arguments, decoded by the native
    routine (it releases the interpreter while it runs)."""
    lib = native_library()
    scans["native"] += 1
    buf = numpy.frombuffer(data, numpy.uint8) if len(data) \
        else numpy.zeros(1, numpy.uint8)
    offsets = numpy.ascontiguousarray(offsets, numpy.int64)
    comps = numpy.ascontiguousarray(comps, numpy.int32)
    tables = numpy.ascontiguousarray(tables, numpy.int32)
    assert coef.dtype == numpy.int16 and coef.flags.c_contiguous
    rc = lib.jpeg_decode_scan(
        buf.ctypes.data, offsets.ctypes.data, len(offsets) - 1,
        coef.ctypes.data, comps.ctypes.data, len(comps), mcus_x, mcus_y,
        restart, ss, se, ah, al, int(progressive), tables.ctypes.data)
    if rc:
        raise scan_error(rc)
    return rc


# -- coefficients -> samples (numpy, every block at once) ----------------

_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
        "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
        "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
        "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
_CONST_BITS, _PASS1_BITS = 13, 2


def _idct_1d(x):
    """One pass of ``jpeg_idct_islow`` over the 8 inputs ``x`` before its
    descale: the 8 outputs, each an integer linear combination of the
    inputs (the butterfly's products and sums are exact in JLONG)."""
    f = _FIX
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 - z3 * f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[0] + x[4]) * (1 << _CONST_BITS)
    tmp1 = (x[0] - x[4]) * (1 << _CONST_BITS)
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


#: the pass as an 8x8 integer matrix (its outputs from the unit inputs),
#: in float64: its entries are below 2**16 and a pass's inputs below 2**31
#: (int16 coefficients times 16-bit quantizers; the workspace is an int),
#: so every product and partial sum is an integer below 2**50, which a
#: float64 product holds exactly: libjpeg's JLONG arithmetic bit for bit
_IDCT = numpy.array(_idct_1d(list(numpy.eye(8, dtype=numpy.int64))),
                    numpy.float64)


def _idct_limit():
    """libjpeg's post-IDCT range-limit table, indexed by ``x & 1023``."""
    x = numpy.arange(1024)
    out = numpy.zeros(1024, numpy.uint8)
    out[:128] = x[:128] + 128
    out[128:512] = 255
    out[896:] = x[896:] - 896
    return out


_LIMIT = _idct_limit()


def _descale(v, shift):
    return (v.astype(numpy.int64) + (1 << (shift - 1))) >> shift


def idct_islow(blocks, quant):
    """``jpeg_idct_islow`` of every block: ``blocks`` (N, 64) int16 in
    zigzag order, ``quant`` (64,) in natural order -> (N, 8, 8) uint8.
    Each pass is one product with :data:`_IDCT` over every block (an
    ``einsum``: no BLAS threads under the loader's decode threads)."""
    n = len(blocks)
    nat = numpy.empty((n, 64), numpy.int64)
    nat[:, NATURAL] = blocks
    nat *= quant
    # pass 1: the columns; input k is coefficient row k (libjpeg keeps
    # the workspace in int)
    cols = nat.reshape(n, 8, 8).transpose(1, 0, 2).reshape(8, n * 8)
    ws = _descale(numpy.einsum("ok,km->om", _IDCT, cols),
                  _CONST_BITS - _PASS1_BITS)
    ws = ws.astype(numpy.int32).reshape(8, n, 8)        # [row, block, col]
    # pass 2: the rows; input k is the workspace's column k
    rows = ws.transpose(2, 1, 0).reshape(8, n * 8)      # [col, block, row]
    out = _descale(numpy.einsum("ok,km->om", _IDCT, rows),
                   _CONST_BITS + _PASS1_BITS + 3)
    return _LIMIT[out.reshape(8, n, 8).transpose(1, 2, 0) & 1023]


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
    are bit counts: 15 at most)."""
    return t in tables and tables[t][0] is not None \
        and tables[t][1] <= max_symbol


def coefficients(frame, native):
    """Run every scan's entropy decode -> (coef (blocks, 64) int16, per
    component (first block, blocks a row, blocks high))."""
    comps = frame.components
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    mcus_x = -(-frame.width // (8 * max_h))
    mcus_y = -(-frame.height // (8 * max_v))
    layout, first = [], 0
    for _, h, v, _ in comps:
        layout.append((first, mcus_x * h, mcus_y * v))
        first += mcus_x * h * mcus_y * v
    coef = numpy.zeros((first, 64), numpy.int16)
    decode = decode_scan_native if native else decode_scan_python
    for scan in frame.scans:
        rows = []
        for ci, td, ta in scan["comps"]:
            _, h, v, _ = comps[ci]
            prog = frame.progressive
            if (not prog or (scan["ss"] == 0 and scan["ah"] == 0)) \
                    and not _table_ok(scan["dc"], td, 15) \
                    or (not prog or scan["ss"] > 0) \
                    and not _table_ok(scan["ac"], ta, 255):
                raise ValueError("JPEG scan uses an undefined or bad "
                                 "Huffman table")
            bw = -(-(frame.width * h) // (8 * max_h))
            bh = -(-(frame.height * v) // (8 * max_v))
            rows.append([layout[ci][0], layout[ci][1], h, v, td, ta, bw,
                         bh])
        tables = numpy.zeros((8, TABLE_WORDS), numpy.int32)
        for t, (tab, _) in scan["dc"].items():
            if tab is not None:
                tables[t] = tab
        for t, (tab, _) in scan["ac"].items():
            if tab is not None:
                tables[4 + t] = tab
        segs = scan["segments"]
        offsets = numpy.cumsum([0] + [len(s) for s in segs])
        ss, se = scan["ss"], scan["se"]
        if not frame.progressive:
            ss, se = 0, 63
        decode(b"".join(segs), offsets, coef, numpy.array(rows, numpy.int32),
               mcus_x, mcus_y, scan["restart"], ss, se, scan["ah"],
               scan["al"], frame.progressive, tables)
    return coef, layout


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
    for c in comps:
        if c[3] not in frame.quant:
            raise ValueError("%s: undefined quantization table" % path)
    coef, layout = coefficients(frame, native)
    planes = []
    for (_, h, v, tq), (first, bw, bh) in zip(comps, layout):
        blocks = idct_islow(coef[first:first + bw * bh], frame.quant[tq])
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
            .reshape(bh * 8, bw * 8)
        dw = -(-(frame.width * h) // max_h)
        dh = -(-(frame.height * v) // max_v)
        plane = upsample(plane[:dh, :dw], max_h // h, max_v // v)
        planes.append(plane[:frame.height, :frame.width])
    n = len(comps)
    if n == 1:
        return planes[0][:, :, None], "L"
    ids = tuple(c[0] for c in comps)
    if n == 3:
        if frame.jfif:
            space = "YCbCr"
        elif frame.adobe_transform is not None:
            space = "RGB" if frame.adobe_transform == 0 else "YCbCr"
        else:
            space = "RGB" if ids == (82, 71, 66) else "YCbCr"
        if space == "RGB":
            return numpy.stack(planes, -1), "RGB"
        rgb = ycc_to_rgb(*planes)
        return numpy.clip(rgb, 0, 255).astype(numpy.uint8), "RGB"
    if frame.adobe_transform is not None and frame.adobe_transform != 0:
        cmy = 255 - ycc_to_rgb(*planes[:3])
        cmyk = numpy.concatenate([numpy.clip(cmy, 0, 255),
                                  planes[3][:, :, None]], -1)
    else:
        cmyk = numpy.stack(planes, -1).astype(numpy.int32)
    return (255 - cmyk).astype(numpy.uint8), "CMYK"
