// Host-side image decoding of the streaming loaders: the serial parts
// that numpy cannot do a row or a block at a time.
//
//   jpeg_decode_scan           the Huffman entropy decode of one JPEG scan
//                              into quantised coefficient blocks (jdhuff.c's
//                              sequential decode_mcu, jdphuff.c's four
//                              progressive passes);
//   jpeg_decode_scan_arith     the same from arithmetic codes (jdarith.c:
//                              the QM decoder, the sequential MCU and the
//                              four progressive passes);
//   jpeg_decode_scan_lossless  a lossless scan's Huffman-coded differences
//                              (jdlhuff.c) undone by its predictor
//                              (jdpred.c, jddiffct.c) into samples;
//   png_unfilter               PNG's five row filters undone (Average and
//                              Paeth depend on the decoded left neighbour,
//                              byte by byte).
//
// All are plain C functions on host memory, bound with ctypes
// (veles_torch/loader/jpeg.py, codecs.py); the decode threads call them
// with the interpreter released. Each has a Python twin that tier-1 holds
// against Pillow: decode_scan_python, decode_scan_arith_python,
// decode_scan_lossless_python and codecs._unfilter_python. The twins and
// these routines take the same arguments and give the same bytes. No
// device code: nvcc hands this file to the host compiler.

#include <cstdint>
#include <cstdlib>

namespace {

// int32 words of one Huffman table (jpeg.py's TABLE_WORDS)
constexpr int kTableWords = 18 + 18 + 256 + 256;
// libjpeg's limits: components a scan, blocks an interleaved MCU,
// arithmetic conditioning tables
constexpr int kMaxComps = 4;
constexpr int kMaxBlocks = 10;
constexpr int kArithTables = 16;

struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc;
  int n;

  void reset(const uint8_t* begin, const uint8_t* stop) {
    p = begin;
    end = stop;
    acc = 0;
    n = 0;
  }
  // past the segment's end the reader sees zero bits, as libjpeg does
  void fill(int need) {
    while (n < need) {
      acc = (acc << 8) | (p < end ? *p : 0u);
      ++p;
      n += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (n < k) fill(k);
    n -= k;
    return static_cast<int>((acc >> n) & ((1ull << k) - 1));
  }
};

struct Table {
  const int32_t* maxcode;
  const int32_t* valoff;
  const int32_t* huffval;
  const int32_t* look;
};

inline int huff(Bits& b, const Table& t) {
  if (b.n < 8) b.fill(8);
  int e = t.look[(b.acc >> (b.n - 8)) & 255];
  if (e) {
    b.n -= e >> 8;
    return e & 255;
  }
  int code = b.get(9);
  int length = 9;
  while (length < 17 && code > t.maxcode[length]) {
    code = (code << 1) | b.get(1);
    ++length;
  }
  if (length > 16) return 0;  // a corrupt code reads as 0, as libjpeg
  return t.huffval[(t.valoff[length] + code) & 255];
}

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

inline int16_t to16(int v) { return static_cast<int16_t>(v); }

inline int zz(int k) { return k < 63 ? k : 63; }

// one block of a progressive AC refinement scan; returns the EOB run left
int refine_ac(int16_t* blk, int eobrun, int ss, int se, int al, Bits& b,
              const Table& t) {
  const int p1 = 1 << al;
  const int m1 = -(1 << al);
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      int rs = huff(b, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = b.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun = 1 << r;
        if (r) eobrun += b.get(r);
        break;
      }
      while (k <= se) {
        int z = zz(k);
        int v = blk[z];
        if (v != 0) {
          if (b.get(1) && (v & p1) == 0) blk[z] = to16(v >= 0 ? v + p1 : v + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      }
      if (s) blk[zz(k)] = to16(s);
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int v = blk[k];
      if (v != 0 && b.get(1) && (v & p1) == 0)
        blk[k] = to16(v >= 0 ? v + p1 : v + m1);
    }
    --eobrun;
  }
  return eobrun;
}

// the guards every scan routine runs before it writes: 1 for a component
// count outside 1..4, 2 for an MCU of more than 10 blocks, 3 for a
// progressive band or shift libjpeg refuses
int check_scan(const int32_t* comps, int ncomp, int progressive, int ss,
               int se, int al) {
  if (ncomp < 1 || ncomp > kMaxComps) return 1;
  if (ncomp > 1) {
    int blocks = 0;
    for (int ci = 0; ci < ncomp; ++ci) blocks += comps[8 * ci + 2] * comps[8 * ci + 3];
    if (blocks > kMaxBlocks) return 2;
  }
  if (progressive &&
      (ss > se || se > 63 || al > 13 || (ss > 0 && ncomp != 1) || (ss == 0 && se != 0)))
    return 3;
  return 0;
}

// the data units of MCU m (a single component's unit, else each
// component's v x h units) into where[] and owner[]; returns their count
int mcu_units(const int32_t* comps, int ncomp, int mcus_x, long m, long* where,
              int* owner) {
  if (ncomp == 1) {
    where[0] = comps[0] + (m / comps[6]) * comps[1] + m % comps[6];
    owner[0] = 0;
    return 1;
  }
  int nb = 0;
  long my = m / mcus_x, mx = m % mcus_x;
  for (int ci = 0; ci < ncomp; ++ci) {
    const int32_t* c = comps + 8 * ci;
    for (int y = 0; y < c[3]; ++y)
      for (int x = 0; x < c[2]; ++x) {
        where[nb] = c[0] + (my * c[3] + y) * c[1] + mx * c[2] + x;
        owner[nb++] = ci;
      }
  }
  return nb;
}

// jaricom.c's jpeg_aritab: the QM coder's 113 states and the fixed
// probability state 113, (Qe << 16) | (next MPS << 8) | (switch << 7) |
// next LPS
#define V(qe, nl, nm, sw) ((static_cast<int32_t>(qe) << 16) | ((nm) << 8) | ((sw) << 7) | (nl))
constexpr int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

constexpr int kDcBins = 64;
constexpr int kAcBins = 256;

// jdarith.c's decoder state over one segment (past its end it reads zero
// bytes, as libjpeg does once it meets a marker), its statistics areas and
// its error latch (ct == -1)
struct Arith {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c;
  int64_t a;
  int ct;
  uint8_t dc[kArithTables][kDcBins];
  uint8_t ac[kArithTables][kAcBins];
  uint8_t fixed;

  // process_restart: every statistics area zeroed, two initial bytes due
  void reset(const uint8_t* begin, const uint8_t* stop) {
    p = begin;
    end = stop;
    c = a = 0;
    ct = -16;
    for (int t = 0; t < kArithTables; ++t) {
      for (int i = 0; i < kDcBins; ++i) dc[t][i] = 0;
      for (int i = 0; i < kAcBins; ++i) ac[t][i] = 0;
    }
    fixed = 113;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = p < end ? *p : 0;
        ++p;
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    int nl = qe & 0xFF;
    int nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // Figure F.24: the magnitude bits below m from bin st
  int bits(uint8_t* st, int m) {
    int v = m;
    while (m >>= 1)
      if (decode(st)) v |= m;
    return v;
  }
};

// one DC difference (decode_mcu / decode_mcu_DC_first) into last_dc and
// ctx; false on a bad code (the latch set)
bool arith_dc(Arith& ar, int tbl, int ci, unsigned* last_dc, int* ctx,
              const int32_t* cond) {
  uint8_t* st = ar.dc[tbl] + ctx[ci];
  if (ar.decode(st) == 0) {
    ctx[ci] = 0;
    return true;
  }
  int sign = ar.decode(st + 1);
  st += 2 + sign;
  int m = ar.decode(st);
  if (m) {
    st = ar.dc[tbl] + 20;
    while (ar.decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ar.ct = -1;
        return false;
      }
      ++st;
    }
  }
  const int low = cond[3 * tbl], up = cond[3 * tbl + 1];
  if (m < ((1 << low) >> 1))
    ctx[ci] = 0;
  else if (m > ((1 << up) >> 1))
    ctx[ci] = 12 + sign * 4;
  else
    ctx[ci] = 4 + sign * 4;
  int v = ar.bits(st + 14, m) + 1;
  last_dc[ci] = (last_dc[ci] + static_cast<unsigned>(sign ? -v : v)) & 0xFFFFu;
  return true;
}

// the AC coefficients k..se of one block (decode_mcu, decode_mcu_AC_first),
// each shifted left by al; false on a bad code
bool arith_ac(Arith& ar, int tbl, int16_t* blk, int k, int se, int al, int kx) {
  uint8_t* base = ar.ac[tbl];
  for (; k <= se; ++k) {
    uint8_t* st = base + 3 * (k - 1);
    if (ar.decode(st)) break;  // EOB
    while (ar.decode(st + 1) == 0) {
      st += 3;
      if (++k > se) {
        ar.ct = -1;  // spectral overflow
        return false;
      }
    }
    int sign = ar.decode(&ar.fixed);
    st += 2;
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = base + (k <= kx ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;  // magnitude overflow
          return false;
        }
        ++st;
      }
    }
    int v = ar.bits(st + 14, m) + 1;
    blk[k] = to16(static_cast<int>(static_cast<unsigned>(sign ? -v : v) << al));
  }
  return true;
}

// one block of decode_mcu_AC_refine; false on a bad code
bool arith_ac_refine(Arith& ar, int tbl, int16_t* blk, int ss, int se, int al) {
  uint8_t* base = ar.ac[tbl];
  const int p1 = 1 << al;
  const int m1 = -(1 << al);
  int kex = se;
  while (kex > 0 && !blk[kex]) --kex;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = base + 3 * (k - 1);
    if (k > kex && ar.decode(st)) break;  // EOB
    for (;;) {
      int v = blk[k];
      if (v) {
        if (ar.decode(st + 2)) blk[k] = to16(v + (v < 0 ? m1 : p1));
        break;
      }
      if (ar.decode(st + 1)) {
        blk[k] = to16(ar.decode(&ar.fixed) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) {
        ar.ct = -1;  // spectral overflow
        return false;
      }
    }
  }
  return true;
}

// predictor psv of jdpred.c from the neighbours left, above, above-left
inline int predict(int psv, int ra, int rb, int rc) {
  switch (psv) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;
  }
}

}  // namespace

extern "C" {

// Decode one scan (jpeg.py's decode_scan_python documents the
// arguments: data/offsets the unstuffed restart segments, coef the int16
// (blocks, 64) zigzag blocks, comps int32 (ncomp, 8) rows, tables int32
// (8, kTableWords)). Returns 0, or before it writes past a block or the
// scan's arrays: 1 for a component count outside 1..4, 2 for an MCU of
// more than 10 blocks, 3 for a progressive band or shift libjpeg
// refuses, 4 for a DC difference of more than 15 bits. jpeg.parse
// refuses such files first; these guards hold for any caller.
int jpeg_decode_scan(const uint8_t* data, const int64_t* offsets, int nseg,
                     int16_t* coef, const int32_t* comps, int ncomp,
                     int mcus_x, int mcus_y, int restart, int ss, int se,
                     int ah, int al, int progressive, const int32_t* tables) {
  if (int rc = check_scan(comps, ncomp, progressive, ss, se, al)) return rc;
  Table tab[8];
  for (int i = 0; i < 8; ++i) {
    const int32_t* t = tables + i * kTableWords;
    tab[i] = Table{t, t + 18, t + 36, t + 292};
  }
  long total = ncomp == 1 ? static_cast<long>(comps[6]) * comps[7]
                          : static_cast<long>(mcus_x) * mcus_y;
  // the DC predictions wrap as libjpeg-turbo's (unsigned arithmetic)
  unsigned pred[kMaxComps] = {0, 0, 0, 0};
  int eobrun = 0;
  int seg = -1;
  Bits b;
  b.reset(data, data);
  long where[kMaxBlocks];
  int owner[kMaxBlocks];
  for (long m = 0; m < total; ++m) {
    if (m == 0 || (restart && m % restart == 0)) {
      ++seg;
      if (seg < nseg)
        b.reset(data + offsets[seg], data + offsets[seg + 1]);
      else
        b.reset(data, data);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    int nb = mcu_units(comps, ncomp, mcus_x, m, where, owner);
    for (int i = 0; i < nb; ++i) {
      int ci = owner[i];
      int16_t* blk = coef + 64 * where[i];
      const Table& dct = tab[comps[8 * ci + 4] & 3];
      const Table& act = tab[4 + (comps[8 * ci + 5] & 3)];
      if (!progressive) {
        int s = huff(b, dct);
        if (s > 15) return 4;
        if (s) s = extend(b.get(s), s);
        pred[ci] += static_cast<unsigned>(s);
        blk[0] = to16(static_cast<int>(pred[ci]));
        for (int k = 1; k < 64; ++k) {
          int rs = huff(b, act);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            blk[zz(k)] = to16(extend(b.get(s), s));
          } else if (r != 15) {
            break;
          } else {
            k += 15;
          }
        }
      } else if (ss == 0) {
        if (ah == 0) {
          int s = huff(b, dct);
          if (s > 15) return 4;
          if (s) s = extend(b.get(s), s);
          pred[ci] += static_cast<unsigned>(s);
          blk[0] = to16(static_cast<int>(pred[ci] << al));
        } else if (b.get(1)) {
          blk[0] = to16(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        if (eobrun > 0) {
          --eobrun;
          continue;
        }
        for (int k = ss; k <= se; ++k) {
          int rs = huff(b, act);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[zz(k)] = to16(extend(b.get(s), s) * (1 << al));
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = (1 << r) + b.get(r) - 1;
            break;
          }
        }
      } else {
        eobrun = refine_ac(blk, eobrun, ss, se, al, b, act);
      }
    }
  }
  return 0;
}

// Decode one arithmetic-coded scan: jpeg_decode_scan's arguments, with the
// table numbers of comps naming conditioning tables (0..15) and cond
// int32 (16, 3), each table's L, U and K, in place of the Huffman tables
// (jpeg.py's decode_scan_arith_python documents them). A bad code latches
// the decoder: the rest of the segment's blocks stay as they are, as
// libjpeg leaves them after its warning. Returns 0, or before any write
// the codes of jpeg_decode_scan (1-3) and 5 for a conditioning value no
// DAC entry can hold.
int jpeg_decode_scan_arith(const uint8_t* data, const int64_t* offsets, int nseg,
                           int16_t* coef, const int32_t* comps, int ncomp,
                           int mcus_x, int mcus_y, int restart, int ss, int se,
                           int ah, int al, int progressive, const int32_t* cond) {
  if (int rc = check_scan(comps, ncomp, progressive, ss, se, al)) return rc;
  for (int t = 0; t < kArithTables; ++t) {
    const int32_t* c = cond + 3 * t;
    if (c[0] < 0 || c[0] > 15 || c[1] < 0 || c[1] > 15 || c[2] < 0 || c[2] > 255)
      return 5;
  }
  long total = ncomp == 1 ? static_cast<long>(comps[6]) * comps[7]
                          : static_cast<long>(mcus_x) * mcus_y;
  // ~20 KB of statistics: on the heap, not the decode thread's stack
  Arith* ar = static_cast<Arith*>(malloc(sizeof(Arith)));
  if (!ar) return 7;
  unsigned last_dc[kMaxComps] = {0, 0, 0, 0};
  int ctx[kMaxComps] = {0, 0, 0, 0};
  int seg = -1;
  long where[kMaxBlocks];
  int owner[kMaxBlocks];
  for (long m = 0; m < total; ++m) {
    if (m == 0 || (restart && m % restart == 0)) {
      ++seg;
      if (seg < nseg)
        ar->reset(data + offsets[seg], data + offsets[seg + 1]);
      else
        ar->reset(data, data);
      for (int ci = 0; ci < kMaxComps; ++ci) last_dc[ci] = ctx[ci] = 0;
    }
    if (ar->ct == -1) continue;  // the latch: nothing till a restart
    int nb = mcu_units(comps, ncomp, mcus_x, m, where, owner);
    for (int i = 0; i < nb; ++i) {
      int ci = owner[i];
      int16_t* blk = coef + 64 * where[i];
      const int dct = comps[8 * ci + 4] & 15, act = comps[8 * ci + 5] & 15;
      bool ok = true;
      if (!progressive) {
        ok = arith_dc(*ar, dct, ci, last_dc, ctx, cond);
        if (ok) {
          blk[0] = to16(static_cast<int>(last_dc[ci]));
          ok = arith_ac(*ar, act, blk, 1, 63, 0, cond[3 * act + 2]);
        }
      } else if (ss == 0 && ah == 0) {
        ok = arith_dc(*ar, dct, ci, last_dc, ctx, cond);
        if (ok) blk[0] = to16(static_cast<int>(last_dc[ci] << al));
      } else if (ss == 0) {
        if (ar->decode(&ar->fixed)) blk[0] = to16(blk[0] | (1 << al));
      } else if (ah == 0) {
        ok = arith_ac(*ar, act, blk, ss, se, al, cond[3 * act + 2]);
      } else {
        ok = arith_ac_refine(*ar, act, blk, ss, se, al);
      }
      if (!ok) break;
    }
  }
  free(ar);
  return 0;
}

// Decode one lossless scan (jpeg.py's decode_scan_lossless_python
// documents the arguments): samples uint16, each component's plane padded
// to whole MCUs; comps rows [first sample, samples a row, h, v, dc table,
// 0, samples wide, samples high]; psv the predictor, pt the point
// transform; tables as jpeg_decode_scan's (the DC tables). Each decoded
// difference is stored modulo 2^16 where its sample goes, then each row of
// each component is undifferenced in place (the padding keeps its
// differences). Returns 0, or before any write the codes 1-2 of
// jpeg_decode_scan, 3 for a predictor outside 1..7 or a point transform
// outside 0..7, 6 for a restart interval that is not a whole number of MCU
// rows; 4 for a difference category above 16 (the scan stops there).
int jpeg_decode_scan_lossless(const uint8_t* data, const int64_t* offsets, int nseg,
                              uint16_t* samples, const int32_t* comps, int ncomp,
                              int mcus_x, int mcus_y, int restart, int psv, int pt,
                              const int32_t* tables) {
  if (int rc = check_scan(comps, ncomp, 0, 0, 63, 0)) return rc;
  if (psv < 1 || psv > 7 || pt < 0 || pt > 7) return 3;
  const bool interleaved = ncomp > 1;
  const long per_row = interleaved ? mcus_x : comps[6];
  const long rows = interleaved ? mcus_y : comps[7];
  if (per_row < 1 || restart % per_row) return 6;
  const long restart_rows = restart / per_row;
  Table tab[4];
  for (int i = 0; i < 4; ++i) {
    const int32_t* t = tables + i * kTableWords;
    tab[i] = Table{t, t + 18, t + 36, t + 292};
  }
  Bits b;
  b.reset(data, data);
  int seg = -1;
  long where[kMaxBlocks];
  int owner[kMaxBlocks];
  for (long mr = 0; mr < rows; ++mr) {
    if (mr == 0 || (restart_rows && mr % restart_rows == 0)) {
      ++seg;
      if (seg < nseg)
        b.reset(data + offsets[seg], data + offsets[seg + 1]);
      else
        b.reset(data, data);
    }
    for (long m = mr * per_row; m < (mr + 1) * per_row; ++m) {
      int nb = mcu_units(comps, ncomp, mcus_x, m, where, owner);
      for (int i = 0; i < nb; ++i) {
        int s = huff(b, tab[comps[8 * owner[i] + 4] & 3]);
        if (s > 16) return 4;
        int d = s == 16 ? 32768 : (s ? extend(b.get(s), s) : 0);
        samples[where[i]] = static_cast<uint16_t>(d);
      }
    }
  }
  // jddiffct.c undifferences an iMCU row (an MCU row of an interleaved
  // scan, v rows of a component scanned alone) once all of it is decoded,
  // so a restart within a component's own iMCU row resets the predictor
  // of its first row only
  const int initial = 1 << (8 - pt - 1);
  for (int ci = 0; ci < ncomp; ++ci) {
    const int32_t* c = comps + 8 * ci;
    const int v = c[3];
    const long stride = c[1], width = c[6], height = c[7];
    uint16_t* plane = samples + c[0];
    for (long r = 0; r < height; ++r) {
      bool first = false;
      if (interleaved) {
        long mr = r / v;
        first = r % v == 0 && (mr == 0 || (restart_rows && mr % restart_rows == 0));
      } else if (r % v == 0) {
        for (long mr = r; mr < r + v && mr < height; ++mr)
          if (mr == 0 || (restart_rows && mr % restart_rows == 0)) first = true;
      }
      uint16_t* row = plane + r * stride;
      const uint16_t* above = row - stride;
      if (first) {
        int ra = (row[0] + initial) & 0xFFFF;
        row[0] = static_cast<uint16_t>(ra);
        for (long x = 1; x < width; ++x) {
          ra = (row[x] + ra) & 0xFFFF;
          row[x] = static_cast<uint16_t>(ra);
        }
      } else {
        int ra = (row[0] + above[0]) & 0xFFFF;
        row[0] = static_cast<uint16_t>(ra);
        for (long x = 1; x < width; ++x) {
          ra = (row[x] + predict(psv, ra, above[x], above[x - 1])) & 0xFFFF;
          row[x] = static_cast<uint16_t>(ra);
        }
      }
    }
  }
  return 0;
}

// Undo PNG's row filters: rows (h, 1 + stride) with the filter byte
// first -> out (h, stride). bpp: bytes a pixel (at least 1). Returns the
// first bad filter type found, else 0 (nothing written past that row).
int png_unfilter(const uint8_t* rows, uint8_t* out, int h, int stride,
                 int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = rows + static_cast<long>(y) * (stride + 1);
    uint8_t* cur = out + static_cast<long>(y) * stride;
    int kind = in[0];
    ++in;
    for (int x = 0; x < stride; ++x) {
      int a = x >= bpp ? cur[x - bpp] : 0;
      int up = prev ? prev[x] : 0;
      int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = up; break;
        case 3: pred = (a + up) >> 1; break;
        case 4: {
          int p = a + up - c;
          int pa = abs(p - a), pb = abs(p - up), pc = abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? up : c);
          break;
        }
        default: return kind;
      }
      cur[x] = static_cast<uint8_t>(in[x] + pred);
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
