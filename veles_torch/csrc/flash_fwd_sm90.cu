// The flash-attention forward for bf16 inputs on Hopper (sm_90a): both
// block products on wgmma, K and V brought in by TMA through an mbarrier
// ring that a producer warp keeps full.
//
// Replaces the Pallas TPU kernels _fwd_kernel (veles/znicz_tpu/parallel/
// pallas_attention.py:161, flash_attention_fwd) as flash_fwd_sm90<DH,
// PIPE=false> and _fwd_kernel_pipe (:203, pipeline=True) as <DH,
// PIPE=true>, for bf16 inputs. f32 inputs keep flash_fwd_f32 in
// flash_attention.cu, unchanged. What it computes, under the dtype rules
// in the header of flash_attention.cu: s = q.k^T * scale in f32, the
// causal -1e9 mask, the online softmax with m and l in f32, p rounded to
// bf16 before the PV product, which accumulates in f32; lse = m + log(l)
// in f32, out = acc / l in bf16. With ACC_BF16 (attn_acc="bf16") the PV
// chain narrows to bf16 as the TPU kernel's acc_dtype=bfloat16 does: once
// per K tile, acc = bf16(bf16(acc * bf16(coef)) + bf16(p.v)), the
// product itself in f32. Any S: Q, K and V rows past S read as zeros
// (TMA's out-of-bounds fill), padded keys are masked to -inf, padded
// query rows are never stored. Head dims 16, 32, 64 and 128.
//
// The two variants keep the TPU kernels' difference, which lies in the
// arithmetic: PIPE=false masks only the tiles that can hold a masked pair
// (the causal diagonal) and the ragged last K tile; PIPE=true applies the
// mask to every visited tile. Both skip the fully masked tiles past the
// diagonal and share one load ring. The TPU's "resident" form, which
// keeps a whole K/V row in VMEM, has no counterpart here: at S=8192 a row
// of K and V is 2 MB against the 227 KB of shared memory a CTA can hold,
// so both variants stream K/V tiles.
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 4*B*H*S^2*dh/2
// operations causal. At the 110M shape (8, 12, 512, 64): 3.2 GFLOP = 3.3
// us against 26 MB (q, k, v, out in bf16, lse in f32) = 7.6 us: bytes
// bound (0.0076 ms). At (4, 12, 8192, 64): 412 GFLOP = 0.417 ms against
// 0.2 GB = 0.06 ms: operations bound.
//
// Design, against what held the mma.sync kernel (flash_fwd_bf16, PR 2)
// back:
//  1. wgmma, not mma.sync fed by scalar fragment loads. S = Q.K^T runs
//     m64n128k16 with Q and K read K-major straight from the swizzled
//     tiles (no fragment loads at all); O += P.V takes P as a register A
//     operand, packed to bf16 from the S accumulator (whose layout is the
//     A fragment's), and V as an MN-major B from its tile, one m64n64k16
//     per 64 columns of dh and 16 keys. dh 16 and 32 use the 64-column
//     box: TMA fills the columns past dh with zeros, S runs over dh only,
//     PV at a width of 64 whose extra columns are never stored.
//  2. Loads that overlap the math. One producer thread issues every
//     load: each item's Q tile into one of two Q buffers, then its K and
//     V tiles of 128 keys into a ring (four stages at dh <= 64, two at dh
//     128) as soon as a stage is released, running ahead into the next
//     item; the consumers wait on the mbarriers. Within a warpgroup, the
//     product S_j = Q.K_j^T is issued together with O += P_(j-1).V_(j-1),
//     and the softmax of tile j runs while the PV product of tile j-1 is
//     still on the tensor cores; the two consumer warpgroups interleave on
//     the SM besides (making them take turns to issue, with two named
//     barriers, measured slower). Every path through the K loop issues and
//     waits for the same products, so ptxas keeps them asynchronous (a
//     product issued and waited for under two separate conditions made it
//     serialize every wgmma). The producer's warpgroup gives its registers
//     to the consumers (setmaxnreg 24 / 240).
//  3. Larger CTAs, and persistent: a 128-row Q tile per work item (two
//     consumer warpgroups of 64 rows, wgmma's M), so every K/V tile
//     fetched serves 128 query rows, half the L2 traffic of the 64-row
//     tiles. One CTA per SM takes its items (b*h, Q tile) from a fixed
//     deal: items in order of Q tile, longest first, handed out in rounds
//     of one per CTA, every other round in reverse, so long and short
//     causal items even out; an item's Q tile and first K/V tiles load
//     while the CTA finishes the item before, so no CTA start-up or
//     first load stands between two items. The deal needs no counter,
//     so a launch needs no zeroed memory.
//  4. exp2 of pre-scaled scores: m is the max of the raw scores, p =
//     2^(s*scale*log2e - m*scale*log2e), one FMA and one ex2.approx per
//     element; lse = m*scale + log(l). The mask test stays per element in
//     PIPE=true, as the TPU variant has it.
// Row max and row sum take two quad shuffles over the accumulator's row
// layout, in a fixed order, so two launches agree bitwise. The output is
// staged through this warpgroup's half of its item's Q buffer (free once
// its last S product is read) and stored in coalesced 16-byte rows.
//
// Plain C interface for ctypes (veles_torch/kernels.py): one launch on the
// caller's stream, returning cudaGetLastError() or the tensor map's
// encode failure.

#include "sm90.cuh"

namespace {

using namespace veles_sm90;

constexpr int kBQ = 128;             // query rows per item, 64 per warpgroup
constexpr int kBK = 128;             // keys per K tile
constexpr int kThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr float kMaskValue = -1e9f;  // the TPU kernels' causal mask
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK, "the causal bounds assume square tiles");

// named barriers (0 is __syncthreads): one per consumer warpgroup
constexpr int kBarWarpgroup = 1;

// byte offsets from a 1024-byte aligned base; a tile is DP/64 chunks of
// 64 columns (128-byte rows, swizzled in 8-row atoms of 1024 bytes)
template <int DH>
struct Smem {
  static constexpr int kDP = DH < 64 ? 64 : DH;  // padded head dim
  static constexpr int kChunks = kDP / 64;
  static constexpr int kStages = DH == 128 ? 2 : 4;  // K/V ring depth
  static constexpr int kQChunk = kBQ * 128;  // one 64-column chunk of Q
  static constexpr int kKChunk = kBK * 128;  // ... of a K or V tile
  static constexpr int kQ = 0;  // [buffer][chunk]: two items' Q tiles
  static constexpr int kK = kQ + 2 * kChunks * kQChunk;  // [stage][chunk]
  static constexpr int kV = kK + kStages * kChunks * kKChunk;
  // q_full[2], q_empty[2], full[stage], empty[stage]
  static constexpr int kBars = kV + kStages * kChunks * kKChunk;
  static constexpr int kBytes = kBars + (4 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The online-softmax step of one K tile on this thread's two rows (r0 and
// r0 + 8; element e of the accumulator is row r0 + 8*((e>>1)&1), key k0 +
// 8*(e/4) + 2*(lane%4) + (e&1)): raw scores sa -> p in place (f32), m
// (max of raw scores) and l updated; -> coef, the factor the running
// output takes before this tile's PV is added. It runs while the
// previous tile's PV product is in flight, so it writes no register but
// sa's and a few scalars: p is packed into the PV product's A fragments
// only once that product is done.
__device__ __forceinline__ void softmax_tile(float (&sa)[64], float (&m)[2],
                                             float (&l)[2], float (&coef)[2],
                                             bool masked, int causal, int k0,
                                             int r0, int s, float scale_log2,
                                             float mask_raw) {
  const int t4 = threadIdx.x % 4;
  float mx[2] = {m[0], m[1]};
  if (masked) {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int key = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      float x = sa[e];
      if (causal && key > r0 + 8 * ((e >> 1) & 1)) {
        x = mask_raw;
      }
      if (key >= s) {
        x = -INFINITY;
      }
      sa[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sa[e]);
    }
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    coef[r] = ex2((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    neg[r] = -mx[r] * scale_log2;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    sa[e] = ex2(fmaf(sa[e], scale_log2, neg[(e >> 1) & 1]));
    rs[(e >> 1) & 1] += sa[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // butterfly over the row's 4 lanes: the same order-fixed sum in each
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * coef[r] + rs[r];
  }
}

// p (f32, the S accumulator's layout) -> the PV product's bf16 A
// fragments: k step ks takes elements 8*ks .. 8*ks + 7
__device__ __forceinline__ void pack_p(uint32_t (&pf)[8][4],
                                       const float (&sa)[64]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pf[ks][r] = pack_bf16(sa[8 * ks + 2 * r], sa[8 * ks + 2 * r + 1]);
    }
  }
}

// sa = Q . K^T over dh (KS k steps of 16) for one K tile of 128 keys,
// committed as its own group; Q and K K-major from their swizzled tiles
// (64-column chunks QC and KC bytes apart)
template <int KS, int QC, int KC>
__device__ __forceinline__ void issue_s(float (&sa)[64],
                                        const unsigned char* s_q,
                                        const unsigned char* s_k) {
  fence_acc(sa);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    wgmma_ss_n128(sa, desc(s_q + (ks / 4) * QC + (ks % 4) * 32),
                  desc(s_k + (ks / 4) * KC + (ks % 4) * 32), ks > 0);
  }
  wgmma_commit();
  fence_acc(sa);
}

// d (+)= P . V over one K tile (C chunks of 64 columns, 8 k steps of 16
// keys), committed as its own group; overwrite starts from zero
// (scale_d 0). The product has its own fence, and every register it
// reads is pinned before the fence, so no write the compiler would
// otherwise place between the fence and the product can serialize or
// race it.
template <int C>
__device__ __forceinline__ void pv_product(float (&d)[C][32],
                                           uint32_t (&pf)[8][4],
                                           const unsigned char* s_v,
                                           int kchunk, bool overwrite) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    fence_acc(d[c]);
  }
  fence_frag(pf);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      wgmma_rs<1>(d[c], pf[ks], desc(s_v + c * kchunk + ks * 2048),
                  !(overwrite && ks == 0));
    }
  }
  wgmma_commit();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    fence_acc(d[c]);
  }
  fence_frag(pf);
}

// Issues one K tile's PV product: with the f32 chain, o takes the tile's
// factor and the product adds into it; with the bf16 chain the product
// goes to a fresh pv, which finish_pv combines.
template <int C, bool ACC_BF16>
__device__ __forceinline__ void issue_pv(float (&o)[C][32],
                                         float (&pv)[ACC_BF16 ? C : 1][32],
                                         uint32_t (&pf)[8][4],
                                         const float (&coef)[2],
                                         const unsigned char* s_v,
                                         int kchunk) {
  if constexpr (ACC_BF16) {
    pv_product<C>(pv, pf, s_v, kchunk, true);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        o[c][e] *= coef[(e >> 1) & 1];
      }
    }
    pv_product<C>(o, pf, s_v, kchunk, false);
  }
}

// After the PV product's wait: pins its result and, with the bf16 chain,
// takes the step of the TPU kernel, which rounds once per block_k:
// o = bf16(bf16(o * bf16(coef)) + bf16(pv)), pv the tile's f32 product
template <int C, bool ACC_BF16>
__device__ __forceinline__ void finish_pv(float (&o)[C][32],
                                          float (&pv)[ACC_BF16 ? C : 1][32],
                                          const float (&coef)[2]) {
  if constexpr (ACC_BF16) {
    const float cb[2] = {round_bf16(coef[0]), round_bf16(coef[1])};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      fence_acc(pv[c]);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        o[c][e] = round_bf16(round_bf16(o[c][e] * cb[(e >> 1) & 1]) +
                             round_bf16(pv[c][e]));
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      fence_acc(o[c]);
    }
  }
}

template <int DH, bool PIPE, bool ACC_BF16>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   bf16* __restrict__ out, float* __restrict__ lse,
                   int bh_total, int s, int causal, float scale) {
  using SM = Smem<DH>;
  constexpr int C = SM::kChunks;
  constexpr int KS = DH / 16;  // k steps of S over dh
  constexpr int ST = SM::kStages;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + SM::kBars);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + ST;

  const int n_kt = (s + kBK - 1) / kBK;
  const int n_qt = (s + kBQ - 1) / kBQ;
  // item i is Q tile n_qt - 1 - i / bh_total of head i % bh_total: the
  // longest causal rows first
  const Deal deal{static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x),
                  bh_total * n_qt};

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], kConsumers);
    }
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != kConsumers) {
      return;
    }
    int stage = 0;
    uint32_t par = 1;  // the ring and both Q buffers start empty
    for (int r = 0, i = deal.item(0); i >= 0; i = deal.item(++r)) {
      const int qt = n_qt - 1 - i / bh_total;
      const int bh = i % bh_total;
      // the next item's Q tile goes into the buffer its last-but-one
      // item's output has left
      const int qb = r & 1;
      mbar_wait(&q_empty[qb], ((r >> 1) & 1) ^ 1);
      mbar_expect_tx(&q_full[qb], C * SM::kQChunk);
      for (int c = 0; c < C; ++c) {
        tma_load(smem + SM::kQ + (qb * C + c) * SM::kQChunk, &tm_q, c * 64,
                 qt * kBQ, bh, &q_full[qb]);
      }
      const int hi = causal ? min(n_kt, qt + 1) : n_kt;
      for (int j = 0; j < hi; ++j) {
        mbar_wait(&empty[stage], par);
        mbar_expect_tx(&full[stage], 2 * C * SM::kKChunk);
        for (int c = 0; c < C; ++c) {
          const int off = (stage * C + c) * SM::kKChunk;
          tma_load(smem + SM::kK + off, &tm_k, c * 64, j * kBK, bh,
                   &full[stage]);
          tma_load(smem + SM::kV + off, &tm_v, c * 64, j * kBK, bh,
                   &full[stage]);
        }
        if (++stage == ST) {
          stage = 0;
          par ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns query rows q0 + wg*64 .. +63 of
  // each item ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int t4 = tid % 4;
  const float scale_log2 = scale * kLog2e;
  const float mask_raw = kMaskValue / scale;  // -1e9 after the scale
  const bool ragged = s % kBK != 0;
  int stage = 0;
  uint32_t par = 0;

  for (int r = 0, i = deal.item(0); i >= 0; i = deal.item(++r)) {
    const int qt = n_qt - 1 - i / bh_total;
    const int bh = i % bh_total;
    const int q0 = qt * kBQ;
    // causal: K tiles past this Q tile's last row are all masked — skipped
    const int hi = causal ? min(n_kt, qt + 1) : n_kt;
    // first K tile that can hold a key past one of this tile's rows
    const int clear = causal ? qt : n_kt;
    const int r0 = q0 + wg * 64 + 16 * warp + g;  // and r0 + 8
    const int qb = r & 1;
    unsigned char* s_q = smem + SM::kQ + qb * C * SM::kQChunk + wg * 64 * 128;

    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    float o[C][32];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        o[c][e] = 0.0f;
      }
    }
    float coef_pv[2];   // the factor of the tile whose PV is next
    uint32_t pf[8][4];  // that tile's p, the PV product's A fragments
    mbar_wait(&q_full[qb], (r >> 1) & 1);

    // K tile 0, alone: no PV product in flight yet. Every later tile
    // issues the previous tile's PV and waits for it on every path, so
    // the compiler can see which products are in flight where.
    mbar_wait(&full[stage], par);
    float sa[64];
    issue_s<KS, SM::kQChunk, SM::kKChunk>(
        sa, s_q, smem + SM::kK + stage * C * SM::kKChunk);
    wgmma_wait_all();
    fence_acc(sa);
    softmax_tile(sa, m, l, coef_pv,
                 PIPE || clear == 0 || (ragged && n_kt == 1), causal, 0, r0,
                 s, scale_log2, mask_raw);
    pack_p(pf, sa);
    int prev = stage;  // the stage of the tile whose PV is next
    if (++stage == ST) {
      stage = 0;
      par ^= 1;
    }
    for (int j = 1; j < hi; ++j) {
      mbar_wait(&full[stage], par);
      float pv[ACC_BF16 ? C : 1][32];
      issue_s<KS, SM::kQChunk, SM::kKChunk>(
          sa, s_q, smem + SM::kK + stage * C * SM::kKChunk);
      // the previous tile's PV, on the tensor cores while this tile's
      // softmax runs
      issue_pv<C, ACC_BF16>(o, pv, pf, coef_pv,
                            smem + SM::kV + prev * C * SM::kKChunk,
                            SM::kKChunk);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(sa);
      float coef[2];
      softmax_tile(sa, m, l, coef,
                   PIPE || j >= clear || (ragged && j == n_kt - 1), causal,
                   j * kBK, r0, s, scale_log2, mask_raw);
      wgmma_wait_all();
      mbar_arrive(&empty[prev]);  // K and V of the previous tile are read
      finish_pv<C, ACC_BF16>(o, pv, coef_pv);
      pack_p(pf, sa);
      coef_pv[0] = coef[0];
      coef_pv[1] = coef[1];
      prev = stage;
      if (++stage == ST) {
        stage = 0;
        par ^= 1;
      }
    }
    {
      // the last tile's PV
      float pv[ACC_BF16 ? C : 1][32];
      issue_pv<C, ACC_BF16>(o, pv, pf, coef_pv,
                            smem + SM::kV + prev * C * SM::kKChunk,
                            SM::kKChunk);
      wgmma_wait_all();
      mbar_arrive(&empty[prev]);
      finish_pv<C, ACC_BF16>(o, pv, coef_pv);
    }

    // out = O / l in bf16, staged (128-byte swizzled, as the Q tile) into
    // this warpgroup's half of the Q tile, then stored in 16-byte rows
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int h = (e >> 1) & 1;
        const int row = 16 * warp + g + 8 * h;
        const int chunk = (e / 4) ^ (row % 8);
        *reinterpret_cast<uint32_t*>(s_q + c * SM::kQChunk + row * 128 +
                                     chunk * 16 + 4 * t4) =
            pack_bf16(o[c][e] / l[h], o[c][e + 1] / l[h]);
      }
    }
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < s) {
          lse[static_cast<int64_t>(bh) * s + row] =
              m[h] * scale + logf(l[h]);
        }
      }
    }
    bar_sync(kBarWarpgroup + wg, 128);
    constexpr int U = DH / 8;  // 16-byte pieces per row
    const int row0 = q0 + wg * 64;
    for (int u = tid % 128; u < 64 * U; u += 128) {
      const int row = u / U;
      const int piece = u % U;
      if (row0 + row < s) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            s_q + (piece / 8) * SM::kQChunk + row * 128 +
            ((piece % 8) ^ (row % 8)) * 16);
        *reinterpret_cast<uint4*>(
            out + (static_cast<int64_t>(bh) * s + row0 + row) * DH +
            piece * 8) = val;
      }
    }
    // the Q buffer is free for a later item's TMA load (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&q_empty[qb]);
  }
}

// -- host side ------------------------------------------------------------

template <int DH, bool PIPE, bool ACC_BF16>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int s, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, s, DH, kBQ) ||
      !make_map(&tk, k, bh, s, DH, kBK) ||
      !make_map(&tv, v, bh, s, DH, kBK)) {
    return cudaErrorInvalidValue;
  }
  constexpr int bytes = Smem<DH>::kBytes;
  auto kernel = flash_fwd_sm90<DH, PIPE, ACC_BF16>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) {
    return rc;
  }
  int device = 0;
  int n_sm = 0;
  rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                device);
  }
  if (rc != cudaSuccess) {
    return rc;
  }
  // persistent: one CTA per SM, each over the items the Deal gives it
  const int64_t items = static_cast<int64_t>(bh) * ((s + kBQ - 1) / kBQ);
  const int grid = items < n_sm ? static_cast<int>(items) : n_sm;
  kernel<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), bh, s,
      causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t by_variant(const void* q, const void* k, const void* v,
                       void* out, void* lse, int bh, int s, int causal,
                       int pipeline, int acc_bf16, float scale,
                       cudaStream_t stream) {
  if (pipeline) {
    return acc_bf16 ? launch<DH, true, true>(q, k, v, out, lse, bh, s,
                                             causal, scale, stream)
                    : launch<DH, true, false>(q, k, v, out, lse, bh, s,
                                              causal, scale, stream);
  }
  return acc_bf16 ? launch<DH, false, true>(q, k, v, out, lse, bh, s, causal,
                                            scale, stream)
                  : launch<DH, false, false>(q, k, v, out, lse, bh, s,
                                             causal, scale, stream);
}

}  // namespace

// q, k, v, out: (bh, s, dh) bf16; lse: (bh, s) f32
extern "C" int veles_flash_fwd_sm90(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int bh, int s, int dh, int causal,
                                    int pipeline, int acc_bf16, float scale,
                                    void* stream) {
  if (bh <= 0 || s <= 0 ||
      static_cast<int64_t>(bh) * ((s + kBQ - 1) / kBQ) > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return by_variant<16>(q, k, v, out, lse, bh, s, causal, pipeline,
                            acc_bf16, scale, st);
    case 32:
      return by_variant<32>(q, k, v, out, lse, bh, s, causal, pipeline,
                            acc_bf16, scale, st);
    case 64:
      return by_variant<64>(q, k, v, out, lse, bh, s, causal, pipeline,
                            acc_bf16, scale, st);
    case 128:
      return by_variant<128>(q, k, v, out, lse, bh, s, causal, pipeline,
                             acc_bf16, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* veles_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
