// Host-side image decoding of the streaming loaders: the serial parts
// that numpy cannot do a row or a block at a time.
//
//   jpeg_decode_scan  the Huffman entropy decode of one JPEG scan into
//                     quantised coefficient blocks (jdhuff.c's sequential
//                     decode_mcu, jdphuff.c's four progressive passes);
//   png_unfilter      PNG's five row filters undone (Average and Paeth
//                     depend on the decoded left neighbour, byte by byte).
//
// Both are plain C functions on host memory, bound with ctypes
// (veles_torch/loader/jpeg.py, codecs.py); the decode threads call them
// with the interpreter released. Each has a Python twin that tier-1 holds
// against Pillow: decode_scan_python and codecs._unfilter_python. The
// twins and these routines take the same arguments and give the same
// bytes. No device code: nvcc hands this file to the host compiler.

#include <cstdint>
#include <cstdlib>

namespace {

// int32 words of one Huffman table (jpeg.py's TABLE_WORDS)
constexpr int kTableWords = 18 + 18 + 256 + 256;
// libjpeg's limits: components a scan, blocks an interleaved MCU
constexpr int kMaxComps = 4;
constexpr int kMaxBlocks = 10;

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
  if (ncomp < 1 || ncomp > kMaxComps) return 1;
  if (ncomp > 1) {
    int blocks = 0;
    for (int ci = 0; ci < ncomp; ++ci) blocks += comps[8 * ci + 2] * comps[8 * ci + 3];
    if (blocks > kMaxBlocks) return 2;
  }
  if (progressive &&
      (ss > se || se > 63 || al > 13 || (ss > 0 && ncomp != 1) || (ss == 0 && se != 0)))
    return 3;
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
    int nb = 0;
    if (ncomp == 1) {
      const int32_t* c = comps;
      where[0] = c[0] + (m / c[6]) * c[1] + m % c[6];
      owner[0] = 0;
      nb = 1;
    } else {
      long my = m / mcus_x, mx = m % mcus_x;
      for (int ci = 0; ci < ncomp; ++ci) {
        const int32_t* c = comps + 8 * ci;
        for (int y = 0; y < c[3]; ++y)
          for (int x = 0; x < c[2]; ++x) {
            where[nb] = c[0] + (my * c[3] + y) * c[1] + mx * c[2] + x;
            owner[nb++] = ci;
          }
      }
    }
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
