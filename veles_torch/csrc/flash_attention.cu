// Flash attention on Hopper (sm_90a): exact softmax attention over
// (B*H, S, dh) rows with the row logsumexp, and its backward, fused or as
// two kernels.
//
// Replaces the Pallas TPU kernels of veles/znicz_tpu/parallel/
// pallas_attention.py:
//
//   flash_fwd_f32<.., PIPE=false>         _fwd_kernel (flash_attention_fwd)
//                                         for f32 inputs; bf16 inputs take
//                                         flash_fwd_sm90 in
//                                         flash_fwd_sm90.cu (wgmma + TMA)
//   flash_fwd_f32<.., PIPE=true>          _fwd_kernel_pipe (pipeline=True),
//                                         likewise
//   flash_bwd_f32 + dq_reduce             _dkvq_kernel (flash_attention_bwd,
//                                         fused=True) for f32 inputs; bf16
//                                         inputs take flash_bwd_sm90 in
//                                         flash_bwd_sm90.cu (wgmma + TMA)
//   flash_bwd_dq_f32                      _dq_kernel (fused=False) for f32
//                                         inputs; bf16 inputs take
//                                         flash_dq_sm90 in
//                                         flash_dq_sm90.cu (wgmma + TMA)
//   flash_bwd_dkv_f32                     _dkv_kernel (fused=False) for f32
//                                         inputs; bf16 inputs take
//                                         flash_bwd_sm90<DH, false> in
//                                         flash_bwd_sm90.cu (wgmma + TMA)
//
// What they compute, as the TPU kernels do: scores s = q.k^T * scale
// with scale = 1/sqrt(dh), in f32 from the storage dtype (f32 or bf16);
// a causal run masks col > row with -1e9; the online softmax keeps m and
// l in f32; p is rounded to the storage dtype before the PV product,
// which accumulates in f32 (or, with acc_bf16, in a bf16 chain: the
// attn_acc="bf16" experiment). lse = m + log(l) in f32. The backward
// recomputes p = exp(s - lse) per tile pair, dv += p^T.do,
// ds = p*(do.v^T - delta)*scale rounded to the storage dtype,
// dk += ds^T.q and dq += ds.k in f32; delta = rowsum(do*out) comes from
// the caller.
//
// Tiles are 64 query rows x 64 key rows for every dh in {16, 32, 64,
// 128}. Q/K/V/dO tiles sit in shared memory in the storage dtype with
// rows padded by 16 bytes (16-byte aligned rows for cp.async, and
// column reads that spread over the banks). Any S: rows and columns
// past S load as zeros and are masked in the kernel; the JAX version
// needs tiles that divide S, this one does not. Every kernel here takes
// f32 inputs (the CPU policy's dtype): the tensor cores take no f32, so
// each thread owns a strided micro-tile of every product and runs scalar
// f32 FMAs out of shared memory, score tiles staged there too. bf16
// inputs, the card's compute dtype, run every function on wgmma with TMA
// loads in flash_fwd_sm90.cu, flash_bwd_sm90.cu and flash_dq_sm90.cu.
//
// Bounds on an H100 (989 TFLOP/s bf16, 67 TFLOP/s f32 outside the
// tensor cores, 3.35 TB/s):
//   forward   4*B*H*S^2*dh/2 operations (causal); at the 110M shapes
//             (8, 12, 512, 64) that is 3.2 GFLOP = 3.3 us at the bf16
//             peak against 26 MB of q, k, v, out and lse = 7.8 us: bytes
//             bound at S=512. At (4, 12, 8192, 64) it is 412 GFLOP =
//             0.42 ms against 0.2 GB = 0.06 ms: operations bound.
//   backward  10*B*H*S^2*dh/2 operations; bytes at S=512 (q, k, v, dO,
//             lse, delta in, dq, dk, dv out: 44 MB = 13 us vs 8 us of
//             operations), operations at S=8192 (1.03 TFLOP = 1.04 ms).
//   dq        6*B*H*S^2*dh/2 operations; q, k, v, dO, lse, delta in, dq
//             out: 32 MB = 9.5 us at S=512 (bytes), 0.63 ms at S=8192
//             (operations).
//   dk/dv     8*B*H*S^2*dh/2 operations; q, k, v, dO, lse, delta in, dk,
//             dv out: 38 MB = 11.4 us at S=512 (bytes), 0.83 ms at S=8192
//             (operations).
//   The two-kernel backward recomputes s and dp in both kernels: 7 block
//   products and 2 exps per tile pair against the fused kernel's 5 and 1
//   (1.46 ms against 1.04 ms at S=8192), and reads q, k, v, dO, lse and
//   delta twice; in exchange it moves no dq partials (below).
// The ceiling here is the 67 TFLOP/s f32 rate. The kernels keep the
// causal loop bounds, which skip every fully masked tile (half the
// work), evaluate the mask only where a tile can need it, and start the
// longest causal rows first.
//
// Pipelined forward (f32): the TPU kernel double-buffers K/V blocks from
// HBM with make_async_copy and DMA semaphores. Here a two-stage cp.async
// ring does the same: tile j+1 is in flight while tile j computes. As on
// the TPU, that variant applies the mask to every tile.
//
// Fused backward for f32 inputs (flash_bwd_f32, unchanged; the bf16 one,
// the card's compute path, is flash_bwd_sm90.cu, whose dq needs no
// partials): the TPU kernel adds each K block's dq contribution into a
// full-row f32 output block revisited over a sequential grid. A GPU grid
// is parallel, so this is design (b) without float atomics:
// one CTA per (chunk, b*h) walks the K tiles kt = chunk, chunk + C, ...
// in order (round robin, so causal work is balanced across chunks),
// keeps dk/dv in registers, and writes its dq contribution into an f32
// partial buffer private to its chunk, only for the Q tiles at or below
// the diagonal. dq_reduce then sums the chunks' partials in chunk order.
// Every sum has a fixed order, so two launches agree bitwise. C (the
// chunk count) is the caller's: one chunk per K tile unless the partial
// buffer would grow past its cap (veles_torch/znicz/ops/flash_attention.py).
// The partials are traffic of their own, beyond the bound above: 16 KB
// of f32 per (K tile, Q tile) pair written, and reread for every K tile
// after a chunk's first. At (8, 12, 512, 64) causal (8 chunks, one K tile
// each) that is 57 MB written and 57 MB read by dq_reduce: 113 MB, 2.6x
// the 44 MB a bf16 backward must move; at (4, 12, 8192, 64) (10 chunks)
// 6.5 GB written, 5.5 GB reread and 1.0 GB reduced: 13 GB, 3.9 ms at
// 3.35 TB/s, 3.7x the bf16 operation bound (what the bf16 kernel of this
// design paid before flash_bwd_sm90.cu replaced it). The
// two-kernel backward (flash_bwd_dq + flash_bwd_dkv, the fused=False form
// below) and flash_bwd_sm90.cu's ordered dq workspace avoid them.
//
// Plain C interface for ctypes (veles_torch/kernels.py): launches go on
// the caller's stream and each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile
static_assert(kBQ == kBK, "dq_reduce and the causal bounds assume square tiles");
constexpr int kLdS = kBK + 1;  // row stride of the f32 score tiles
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr float kMaskValue = -1e9f;  // the TPU kernels' causal mask

// dtype codes shared with veles_torch/znicz/ops/flash_attention.py
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A 64-row tile of dh columns in shared memory, storage dtype T.
template <typename T, int DH>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);          // elements per 16 B
  static constexpr int kLd = DH + kVec;                // padded row stride
  static constexpr int kChunks = DH / kVec;            // 16 B chunks per row
  static constexpr int kElems = 64 * kLd;
};

// Rows [row0, row0 + 64) of a (S, DH) matrix into a tile; rows >= s
// become zeros. Synchronous 16-byte loads.
template <typename T, int DH, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int s) {
  using TL = Tile<T, DH>;
  for (int c = threadIdx.x; c < 64 * TL::kChunks; c += NT) {
    const int r = c / TL::kChunks;
    const int part = c % TL::kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s) {
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * DH + part * TL::kVec);
    }
    *reinterpret_cast<uint4*>(dst + r * TL::kLd + part * TL::kVec) = val;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// load_tile through cp.async: rows >= s are zero-filled by the copy
// (source size 0). The caller commits and waits.
template <typename T, int DH, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int row0, int s) {
  using TL = Tile<T, DH>;
  for (int c = threadIdx.x; c < 64 * TL::kChunks; c += NT) {
    const int r = c / TL::kChunks;
    const int part = c % TL::kChunks;
    const bool in = row0 + r < s;
    const T* from =
        in ? src + static_cast<int64_t>(row0 + r) * DH + part * TL::kVec
           : src;
    cp_async16(dst + r * TL::kLd + part * TL::kVec, from, in ? 16 : 0);
  }
}

// acc[i][j] += sum_k A(ty + i*TY, k) * B(k, tx + j*TX) for k in [0, K),
// with A(m, k) = a[m*a_rs + k*a_cs] and B(k, n) = b[k*b_rs + n*b_cs], in
// f32 FMAs and a fixed order.
template <int K, int TM, int TN, int TX, int TY>
__device__ __forceinline__ void mm(float (&acc)[TM][TN], const float* a,
                                   int a_rs, int a_cs, const float* b,
                                   int b_rs, int b_cs, int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM];
    float bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      av[i] = a[(ty + i * TY) * a_rs + k * a_cs];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      bv[j] = b[k * b_rs + (tx + j * TX) * b_cs];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.0f;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// butterfly: every lane ends with the same, order-fixed sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <int DH, bool PIPE>
constexpr size_t fwd_f32_smem_bytes() {
  return sizeof(float) * (Tile<float, DH>::kElems * (1 + 2 * (PIPE ? 2 : 1)) +
                          kBQ * kLdS + 3 * kBQ);
}

// f32 inputs. One CTA per (q tile, b*h): out rows [q0, q0 + 64) and
// their lse.
template <int DH, bool PIPE>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int s, int causal, int acc_bf16,
                  float scale) {
  using TL = Tile<float, DH>;
  constexpr int kLd = TL::kLd;
  constexpr int TX = 8;
  constexpr int TY = kFwdThreads / TX;  // 16
  constexpr int SM = kBQ / TY;          // score micro-tile rows (4)
  constexpr int SN = kBK / TX;          // score micro-tile cols (8)
  constexpr int ON = DH / TX;           // output micro-tile cols
  constexpr int kStages = PIPE ? 2 : 1;
  static_assert(SM * TY == kBQ && SN * TX == kBK && ON * TX == DH, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + TL::kElems;
  float* sV = sK + kStages * TL::kElems;
  float* sP = sV + kStages * TL::kElems;
  float* sM = sP + kBQ * kLdS;
  float* sL = sM + kBQ;
  float* sC = sL + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.y;
  // the longest causal rows start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t base = static_cast<int64_t>(bh) * s * DH;
  const float* kb = k + base;
  const float* vb = v + base;
  const int n_kt = (s + kBK - 1) / kBK;
  // causal: K tiles past this Q tile's last row are all masked — skipped
  const int hi = causal ? min(n_kt, (q0 + kBQ + kBK - 1) / kBK) : n_kt;
  // first K tile that can hold a column past one of this tile's rows
  const int clear = causal ? q0 / kBK : n_kt;
  const bool ragged = s % kBK != 0;

  if constexpr (PIPE) {
    load_tile_async<float, DH, kFwdThreads>(sK, kb, 0, s);
    load_tile_async<float, DH, kFwdThreads>(sV, vb, 0, s);
    cp_async_commit();
  }
  load_tile<float, DH, kFwdThreads>(sQ, q + base, q0, s);
  if (tid < kBQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.0f;
  }
  float acc[SM][ON];
  zero(acc);

  for (int j = 0; j < hi; ++j) {
    const float* tK = sK;
    const float* tV = sV;
    if constexpr (PIPE) {
      if (j + 1 < hi) {
        const int nxt = (j + 1) & 1;
        load_tile_async<float, DH, kFwdThreads>(sK + nxt * TL::kElems, kb,
                                            (j + 1) * kBK, s);
        load_tile_async<float, DH, kFwdThreads>(sV + nxt * TL::kElems, vb,
                                            (j + 1) * kBK, s);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      tK = sK + (j & 1) * TL::kElems;
      tV = sV + (j & 1) * TL::kElems;
    } else {
      load_tile<float, DH, kFwdThreads>(sK, kb, j * kBK, s);
      load_tile<float, DH, kFwdThreads>(sV, vb, j * kBK, s);
    }
    __syncthreads();

    float sc[SM][SN];
    zero(sc);
    mm<DH, SM, SN, TX, TY>(sc, sQ, kLd, 1, tK, 1, kLd, tx, ty);
    const bool masked = PIPE || j >= clear || (ragged && j == n_kt - 1);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = ty + i * TY;
#pragma unroll
      for (int jj = 0; jj < SN; ++jj) {
        const int c = tx + jj * TX;
        float x = sc[i][jj] * scale;
        if (masked) {
          const int col = j * kBK + c;
          if (causal && col > q0 + r) {
            x = kMaskValue;
          }
          if (col >= s) {
            x = -INFINITY;
          }
        }
        sP[r * kLdS + c] = x;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int r = warp; r < kBQ; r += kFwdThreads / 32) {
      const float x0 = sP[r * kLdS + lane];
      const float x1 = sP[r * kLdS + lane + 32];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      const float coef = expf(m_old - m_new);
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * coef + sum;
        sC[r] = coef;
      }
      sP[r * kLdS + lane] = p0;
      sP[r * kLdS + lane + 32] = p1;
    }
    __syncthreads();

    float pv[SM][ON];
    zero(pv);
    mm<kBK, SM, ON, TX, TY>(pv, sP, kLdS, 1, tV, kLd, 1, tx, ty);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const float coef = sC[ty + i * TY];
#pragma unroll
      for (int jj = 0; jj < ON; ++jj) {
        if (acc_bf16) {
          acc[i][jj] = round_bf16(round_bf16(acc[i][jj] * round_bf16(coef)) +
                                  round_bf16(pv[i][jj]));
        } else {
          acc[i][jj] = acc[i][jj] * coef + pv[i][jj];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < SM; ++i) {
    const int r = ty + i * TY;
    if (q0 + r < s) {
      const float l = sL[r];
      float* row = out + base + static_cast<int64_t>(q0 + r) * DH;
#pragma unroll
      for (int jj = 0; jj < ON; ++jj) {
        row[tx + jj * TX] = acc[i][jj] / l;
      }
    }
  }
  if (tid < kBQ && q0 + tid < s) {
    lse[static_cast<int64_t>(bh) * s + q0 + tid] = sM[tid] + logf(sL[tid]);
  }
}

template <int DH>
constexpr size_t bwd_f32_smem_bytes() {
  return sizeof(float) *
         (Tile<float, DH>::kElems * 4 + 2 * kBQ * kLdS + 2 * kBQ);
}

// f32 inputs. One CTA per (chunk, b*h): dk/dv of K tiles chunk,
// chunk + C, ... and their dq contributions into dq_part[chunk, b*h].
template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, float* __restrict__ dq_part, int s,
                  int causal, float scale) {
  using TL = Tile<float, DH>;
  constexpr int kLd = TL::kLd;
  constexpr int TX = 16;
  constexpr int TY = kBwdThreads / TX;  // 16
  constexpr int SM = kBQ / TY;          // 4
  constexpr int SN = kBK / TX;          // 4
  constexpr int GM = kBK / TY;          // dk/dv/dq micro-tile rows (4)
  constexpr int GN = DH / TX;           // dk/dv/dq micro-tile cols
  static_assert(SM * TY == kBQ && SN * TX == kBK && GN * TX == DH, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + TL::kElems;
  float* sQ = sV + TL::kElems;
  float* sDO = sQ + TL::kElems;
  float* sP = sDO + TL::kElems;
  float* sDS = sP + kBQ * kLdS;
  float* sLse = sDS + kBQ * kLdS;
  float* sDelta = sLse + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int bh = blockIdx.y;
  const int64_t base = static_cast<int64_t>(bh) * s * DH;
  const float* qb = q + base;
  const float* dob = dout + base;
  const float* lseb = lse + static_cast<int64_t>(bh) * s;
  const float* deltab = delta + static_cast<int64_t>(bh) * s;
  float* part =
      dq_part + (static_cast<int64_t>(chunk) * gridDim.y + bh) * s * DH;
  const int n_kt = (s + kBK - 1) / kBK;
  const int n_qt = (s + kBQ - 1) / kBQ;
  const bool ragged = s % kBK != 0;

  for (int kt = chunk; kt < n_kt; kt += n_chunks) {
    const int k0 = kt * kBK;
    // the chunk's first K tile writes its dq rows, later ones add
    const bool first = kt == chunk;
    load_tile<float, DH, kBwdThreads>(sK, k + base, k0, s);
    load_tile<float, DH, kBwdThreads>(sV, v + base, k0, s);
    float dkacc[GM][GN];
    float dvacc[GM][GN];
    zero(dkacc);
    zero(dvacc);
    // causal: Q tiles above this K tile's first column see only masked
    // scores — start at the diagonal
    const int qlo = causal ? k0 / kBQ : 0;
    for (int qt = qlo; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      load_tile<float, DH, kBwdThreads>(sQ, qb, q0, s);
      load_tile<float, DH, kBwdThreads>(sDO, dob, q0, s);
      if (tid < kBQ) {
        const bool in = q0 + tid < s;
        sLse[tid] = in ? lseb[q0 + tid] : 0.0f;
        sDelta[tid] = in ? deltab[q0 + tid] : 0.0f;
      }
      __syncthreads();

      float sc[SM][SN];
      float dp[SM][SN];
      zero(sc);
      zero(dp);
      mm<DH, SM, SN, TX, TY>(sc, sQ, kLd, 1, sK, 1, kLd, tx, ty);
      mm<DH, SM, SN, TX, TY>(dp, sDO, kLd, 1, sV, 1, kLd, tx, ty);
      // only the diagonal tile (causal) and the ragged edge need a mask
      const bool masked = (causal && q0 < k0 + kBK - 1) ||
                          (ragged && (kt == n_kt - 1 || qt == n_qt - 1));
#pragma unroll
      for (int i = 0; i < SM; ++i) {
        const int r = ty + i * TY;
        const int row = q0 + r;
        const float lr = sLse[r];
        const float dr = sDelta[r];
#pragma unroll
        for (int jj = 0; jj < SN; ++jj) {
          const int c = tx + jj * TX;
          const int col = k0 + c;
          float x = sc[i][jj] * scale;
          if (masked && causal && col > row) {
            x = kMaskValue;
          }
          float p = expf(x - lr);
          if (masked && (row >= s || col >= s)) {
            p = 0.0f;
          }
          const float ds = p * (dp[i][jj] - dr) * scale;
          sP[r * kLdS + c] = p;
          sDS[r * kLdS + c] = ds;
        }
      }
      __syncthreads();

      // dv += p^T.do and dk += ds^T.q over this tile's 64 query rows
      mm<kBQ, GM, GN, TX, TY>(dvacc, sP, 1, kLdS, sDO, kLd, 1, tx, ty);
      mm<kBQ, GM, GN, TX, TY>(dkacc, sDS, 1, kLdS, sQ, kLd, 1, tx, ty);
      // this tile pair's dq contribution ds.k
      float dq[GM][GN];
      zero(dq);
      mm<kBK, GM, GN, TX, TY>(dq, sDS, kLdS, 1, sK, kLd, 1, tx, ty);
#pragma unroll
      for (int i = 0; i < GM; ++i) {
        const int row = q0 + ty + i * TY;
        if (row < s) {
          float* dst = part + static_cast<int64_t>(row) * DH;
#pragma unroll
          for (int jj = 0; jj < GN; ++jj) {
            const int d = tx + jj * TX;
            dst[d] = first ? dq[i][jj] : dst[d] + dq[i][jj];
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < GM; ++i) {
      const int col = k0 + ty + i * TY;
      if (col < s) {
        const int64_t off = base + static_cast<int64_t>(col) * DH;
#pragma unroll
        for (int jj = 0; jj < GN; ++jj) {
          const int d = tx + jj * TX;
          dk[off + d] = dkacc[i][jj];
          dv[off + d] = dvacc[i][jj];
        }
      }
    }
  }
}

// -- the two-kernel backward (fused=False) --------------------------------
//
// _dkv_kernel's counterpart is the fused kernel's K-tile body without the
// dq product: one CTA per (K tile, b*h), kt = blockIdx.x so the K tiles
// with the most causal Q tiles (kt = 0) start first. _dq_kernel's is the
// forward's CTA plan: one CTA per (Q tile, b*h), the longest causal rows
// first, over the K tiles [0, hi); s = q.k^T and dp = do.v^T recomputed,
// p = exp(s*scale - lse) masked on the tail tiles >= clear and on columns
// >= S, ds = p*(dp - delta)*scale rounded to the storage dtype, dq += ds.k.
// Each kernel keeps its sums in f32 registers and writes every output
// element once, from one thread: no partials, no atomics.

template <int DH>
constexpr size_t bwd_dq_f32_smem_bytes() {
  return sizeof(float) * (Tile<float, DH>::kElems * 4 + kBQ * kLdS);
}

// f32 inputs. One CTA per (q tile, b*h): dq rows [q0, q0 + 64).
template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int s, int causal, float scale) {
  using TL = Tile<float, DH>;
  constexpr int kLd = TL::kLd;
  constexpr int TX = 16;
  constexpr int TY = kBwdThreads / TX;  // 16
  constexpr int SM = kBQ / TY;          // 4: score and dq micro-tile rows
  constexpr int SN = kBK / TX;          // 4
  constexpr int GN = DH / TX;           // dq micro-tile cols
  static_assert(SM * TY == kBQ && SN * TX == kBK && GN * TX == DH, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + TL::kElems;
  float* sK = sDO + TL::kElems;
  float* sV = sK + TL::kElems;
  float* sDS = sV + TL::kElems;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t base = static_cast<int64_t>(bh) * s * DH;
  const int n_kt = (s + kBK - 1) / kBK;
  const int hi = causal ? min(n_kt, (q0 + kBQ + kBK - 1) / kBK) : n_kt;
  const int clear = causal ? q0 / kBK : n_kt;
  const bool ragged = s % kBK != 0;

  load_tile<float, DH, kBwdThreads>(sQ, q + base, q0, s);
  load_tile<float, DH, kBwdThreads>(sDO, dout + base, q0, s);
  float lr[SM];
  float dr[SM];
#pragma unroll
  for (int i = 0; i < SM; ++i) {
    const int row = q0 + ty + i * TY;
    lr[i] = row < s ? lse[static_cast<int64_t>(bh) * s + row] : 0.0f;
    dr[i] = row < s ? delta[static_cast<int64_t>(bh) * s + row] : 0.0f;
  }
  float acc[SM][GN];
  zero(acc);

  for (int j = 0; j < hi; ++j) {
    load_tile<float, DH, kBwdThreads>(sK, k + base, j * kBK, s);
    load_tile<float, DH, kBwdThreads>(sV, v + base, j * kBK, s);
    __syncthreads();

    float sc[SM][SN];
    float dp[SM][SN];
    zero(sc);
    zero(dp);
    mm<DH, SM, SN, TX, TY>(sc, sQ, kLd, 1, sK, 1, kLd, tx, ty);
    mm<DH, SM, SN, TX, TY>(dp, sDO, kLd, 1, sV, 1, kLd, tx, ty);
    const bool masked = j >= clear || (ragged && j == n_kt - 1);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = ty + i * TY;
#pragma unroll
      for (int jj = 0; jj < SN; ++jj) {
        const int c = tx + jj * TX;
        const int col = j * kBK + c;
        float x = sc[i][jj] * scale;
        if (masked && causal && col > q0 + r) {
          x = kMaskValue;
        }
        float p = expf(x - lr[i]);
        if (masked && col >= s) {
          p = 0.0f;
        }
        sDS[r * kLdS + c] = p * (dp[i][jj] - dr[i]) * scale;
      }
    }
    __syncthreads();

    mm<kBK, SM, GN, TX, TY>(acc, sDS, kLdS, 1, sK, kLd, 1, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < SM; ++i) {
    const int row = q0 + ty + i * TY;
    if (row < s) {
      float* dst = dq + base + static_cast<int64_t>(row) * DH;
#pragma unroll
      for (int jj = 0; jj < GN; ++jj) {
        dst[tx + jj * TX] = acc[i][jj];
      }
    }
  }
}

template <int DH>
constexpr size_t bwd_dkv_f32_smem_bytes() {
  return sizeof(float) *
         (Tile<float, DH>::kElems * 4 + 2 * kBQ * kLdS + 2 * kBQ);
}

// f32 inputs. One CTA per (k tile, b*h): dk and dv rows [k0, k0 + 64).
template <int DH>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_f32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int s,
                      int causal, float scale) {
  using TL = Tile<float, DH>;
  constexpr int kLd = TL::kLd;
  constexpr int TX = 16;
  constexpr int TY = kBwdThreads / TX;  // 16
  constexpr int SM = kBQ / TY;          // 4
  constexpr int SN = kBK / TX;          // 4
  constexpr int GM = kBK / TY;          // dk/dv micro-tile rows (4)
  constexpr int GN = DH / TX;           // dk/dv micro-tile cols
  static_assert(SM * TY == kBQ && SN * TX == kBK && GN * TX == DH, "tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + TL::kElems;
  float* sQ = sV + TL::kElems;
  float* sDO = sQ + TL::kElems;
  float* sP = sDO + TL::kElems;
  float* sDS = sP + kBQ * kLdS;
  float* sLse = sDS + kBQ * kLdS;
  float* sDelta = sLse + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int kt = blockIdx.x;
  const int k0 = kt * kBK;
  const int bh = blockIdx.y;
  const int64_t base = static_cast<int64_t>(bh) * s * DH;
  const float* lseb = lse + static_cast<int64_t>(bh) * s;
  const float* deltab = delta + static_cast<int64_t>(bh) * s;
  const int n_kt = (s + kBK - 1) / kBK;
  const int n_qt = (s + kBQ - 1) / kBQ;
  const bool ragged = s % kBK != 0;
  // causal: Q tiles above this K tile's first column see only masked
  // scores (skipped); those below clear cross the diagonal
  const int qlo = causal ? k0 / kBQ : 0;
  const int clear = causal ? (k0 + kBK - 1 + kBQ - 1) / kBQ : 0;
  const bool edge = ragged && kt == n_kt - 1;

  load_tile<float, DH, kBwdThreads>(sK, k + base, k0, s);
  load_tile<float, DH, kBwdThreads>(sV, v + base, k0, s);
  float dkacc[GM][GN];
  float dvacc[GM][GN];
  zero(dkacc);
  zero(dvacc);
  for (int qt = qlo; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    load_tile<float, DH, kBwdThreads>(sQ, q + base, q0, s);
    load_tile<float, DH, kBwdThreads>(sDO, dout + base, q0, s);
    if (tid < kBQ) {
      const bool in = q0 + tid < s;
      sLse[tid] = in ? lseb[q0 + tid] : 0.0f;
      sDelta[tid] = in ? deltab[q0 + tid] : 0.0f;
    }
    __syncthreads();

    float sc[SM][SN];
    float dp[SM][SN];
    zero(sc);
    zero(dp);
    mm<DH, SM, SN, TX, TY>(sc, sQ, kLd, 1, sK, 1, kLd, tx, ty);
    mm<DH, SM, SN, TX, TY>(dp, sDO, kLd, 1, sV, 1, kLd, tx, ty);
    const bool masked = qt < clear || edge || (ragged && qt == n_qt - 1);
#pragma unroll
    for (int i = 0; i < SM; ++i) {
      const int r = ty + i * TY;
      const int row = q0 + r;
      const float lr = sLse[r];
      const float dr = sDelta[r];
#pragma unroll
      for (int jj = 0; jj < SN; ++jj) {
        const int c = tx + jj * TX;
        const int col = k0 + c;
        float x = sc[i][jj] * scale;
        if (masked && causal && col > row) {
          x = kMaskValue;
        }
        float p = expf(x - lr);
        // padded Q rows read lse 0: exp must not reach dk/dv
        if (masked && (row >= s || col >= s)) {
          p = 0.0f;
        }
        sP[r * kLdS + c] = p;
        sDS[r * kLdS + c] = p * (dp[i][jj] - dr) * scale;
      }
    }
    __syncthreads();

    mm<kBQ, GM, GN, TX, TY>(dvacc, sP, 1, kLdS, sDO, kLd, 1, tx, ty);
    mm<kBQ, GM, GN, TX, TY>(dkacc, sDS, 1, kLdS, sQ, kLd, 1, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < GM; ++i) {
    const int col = k0 + ty + i * TY;
    if (col < s) {
      const int64_t off = base + static_cast<int64_t>(col) * DH;
#pragma unroll
      for (int jj = 0; jj < GN; ++jj) {
        const int d = tx + jj * TX;
        dk[off + d] = dkacc[i][jj];
        dv[off + d] = dvacc[i][jj];
      }
    }
  }
}

// dq[bh, row, d] = sum over the chunks that wrote row (in chunk order) of
// dq_part[chunk, bh, row, d], in the storage dtype.
template <typename T>
__global__ void dq_reduce(const float* __restrict__ dq_part,
                          T* __restrict__ dq, int64_t total, int s, int dh,
                          int n_chunks, int causal) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) {
    return;
  }
  const int row = static_cast<int>((idx / dh) % s);
  // chunk c starts at K tile c, so it wrote the rows of Q tiles >= c
  const int last = causal ? min(n_chunks, row / kBQ + 1) : n_chunks;
  float acc = 0.0f;
  for (int c = 0; c < last; ++c) {
    acc += dq_part[c * total + idx];
  }
  dq[idx] = from_f32<T>(acc);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) {
    return cudaSuccess;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launchers, one per kernel family: Launch<T, DH>::run(...) launches on
// the caller's stream and returns cudaGetLastError(); dispatch() picks T
// and DH from the caller's dtype code and head dim.

// the forward for f32 inputs (bf16 inputs take flash_fwd_sm90.cu)
template <int DH, bool PIPE>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       void* lse, int bh, int s, int causal, int acc_bf16,
                       float scale, cudaStream_t stream) {
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  constexpr size_t bytes = fwd_f32_smem_bytes<DH, PIPE>();
  cudaError_t rc = allow_smem(flash_fwd_f32<DH, PIPE>, bytes);
  if (rc != cudaSuccess) {
    return rc;
  }
  flash_fwd_f32<DH, PIPE><<<grid, kFwdThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), s, causal, acc_bf16, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
struct LaunchFwd {
  static_assert(std::is_same<T, float>::value, "f32 inputs only");
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, void* lse, int bh, int s, int causal,
                         int pipeline, int acc_bf16, float scale,
                         cudaStream_t stream) {
    if (pipeline) {
      return launch_fwd<DH, true>(q, k, v, out, lse, bh, s, causal,
                                  acc_bf16, scale, stream);
    }
    return launch_fwd<DH, false>(q, k, v, out, lse, bh, s, causal, acc_bf16,
                                 scale, stream);
  }
};

// the fused backward for f32 inputs and dq_reduce (bf16 inputs take
// flash_bwd_sm90.cu)
template <typename T, int DH>
struct LaunchBwd {
  static_assert(std::is_same<T, float>::value, "f32 inputs only");
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, void* dq_part, int bh,
                         int s, int causal, int n_chunks, float scale,
                         cudaStream_t stream) {
    const dim3 grid(n_chunks, bh);
    constexpr size_t bytes = bwd_f32_smem_bytes<DH>();
    cudaError_t rc = allow_smem(flash_bwd_f32<DH>, bytes);
    if (rc != cudaSuccess) {
      return rc;
    }
    flash_bwd_f32<DH><<<grid, kBwdThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(dq_part), s, causal, scale);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) {
      return rc;
    }
    const int64_t total = static_cast<int64_t>(bh) * s * DH;
    constexpr int kThreads = 256;
    dq_reduce<float>
        <<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
           kThreads, 0, stream>>>(static_cast<const float*>(dq_part),
                                  static_cast<float*>(dq), total, s, DH,
                                  n_chunks, causal);
    return cudaGetLastError();
  }
};

// the two-kernel backward's dq kernel for f32 inputs: one CTA per (Q
// tile, b*h) (bf16 inputs take flash_dq_sm90.cu)
template <typename T, int DH>
struct LaunchBwdDq {
  static_assert(std::is_same<T, float>::value, "f32 inputs only");
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int bh, int s, int causal, float scale,
                         cudaStream_t stream) {
    const dim3 grid((s + kBQ - 1) / kBQ, bh);
    constexpr size_t bytes = bwd_dq_f32_smem_bytes<DH>();
    cudaError_t rc = allow_smem(flash_bwd_dq_f32<DH>, bytes);
    if (rc != cudaSuccess) {
      return rc;
    }
    flash_bwd_dq_f32<DH><<<grid, kBwdThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), s, causal, scale);
    return cudaGetLastError();
  }
};

// the two-kernel backward's dk/dv kernel for f32 inputs: one CTA per (K
// tile, b*h) (bf16 inputs take flash_bwd_sm90<DH, false> in
// flash_bwd_sm90.cu)
template <typename T, int DH>
struct LaunchBwdDkv {
  static_assert(std::is_same<T, float>::value, "f32 inputs only");
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int bh, int s, int causal,
                         float scale, cudaStream_t stream) {
    const dim3 grid((s + kBK - 1) / kBK, bh);
    constexpr size_t bytes = bwd_dkv_f32_smem_bytes<DH>();
    cudaError_t rc = allow_smem(flash_bwd_dkv_f32<DH>, bytes);
    if (rc != cudaSuccess) {
      return rc;
    }
    flash_bwd_dkv_f32<DH><<<grid, kBwdThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), s, causal, scale);
    return cudaGetLastError();
  }
};

template <template <typename, int> class Launch, typename T,
          typename... Args>
cudaError_t by_dh(int dh, Args... args) {
  switch (dh) {
    case 16:
      return Launch<T, 16>::run(args...);
    case 32:
      return Launch<T, 32>::run(args...);
    case 64:
      return Launch<T, 64>::run(args...);
    case 128:
      return Launch<T, 128>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int s) { return bh <= 0 || bh > 65535 || s <= 0; }

}  // namespace

extern "C" int veles_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bh, int s, int dh,
                               int dtype, int causal, int pipeline,
                               int acc_bf16, float scale, void* stream) {
  if (bad_shape(bh, s) || dtype != kF32) {
    return cudaErrorInvalidValue;
  }
  return by_dh<LaunchFwd, float>(dh, q, k, v, out, lse, bh, s, causal,
                                 pipeline, acc_bf16, scale,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int veles_flash_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, void* dq_part, int bh, int s, int dh,
                               int dtype, int causal, int n_chunks,
                               float scale, void* stream) {
  if (bad_shape(bh, s) || n_chunks <= 0 ||
      n_chunks > (s + kBK - 1) / kBK || dtype != kF32) {
    return cudaErrorInvalidValue;
  }
  return by_dh<LaunchBwd, float>(dh, q, k, v, dout, lse, delta, dq, dk, dv,
                                 dq_part, bh, s, causal, n_chunks, scale,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int veles_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int bh, int s,
                                  int dh, int dtype, int causal, float scale,
                                  void* stream) {
  if (bad_shape(bh, s) || dtype != kF32) {
    return cudaErrorInvalidValue;
  }
  return by_dh<LaunchBwdDq, float>(dh, q, k, v, dout, lse, delta, dq, bh, s,
                                   causal, scale,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int veles_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int bh, int s, int dh,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  if (bad_shape(bh, s) || dtype != kF32) {
    return cudaErrorInvalidValue;
  }
  return by_dh<LaunchBwdDkv, float>(dh, q, k, v, dout, lse, delta, dk, dv,
                                    bh, s, causal, scale,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* veles_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
