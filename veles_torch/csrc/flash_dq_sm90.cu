// The two-kernel flash backward's dq kernel for bf16 inputs on Hopper
// (sm_90a): its three block products on wgmma, the tiles brought in by TMA
// through an mbarrier ring that a producer thread keeps full.
//
// Replaces the Pallas TPU kernel _dq_kernel of veles/znicz_tpu/parallel/
// pallas_attention.py:278 (flash_attention_bwd, fused=False) for bf16
// inputs; f32 inputs keep flash_bwd_dq_f32 in flash_attention.cu, and the
// pair's dk/dv kernel is flash_bwd_sm90<DH, false> in flash_bwd_sm90.cu.
// What it computes, under the dtype rules in the header of
// flash_attention.cu: per (Q tile, K tile) pair, s = q.k^T * scale in f32,
// the causal -1e9 mask, p = exp(s - lse) in f32, dp = do.v^T,
// ds = p*(dp - delta)*scale rounded to bf16, dq += ds.k accumulated in
// f32; dq is stored once, in bf16. Three block products and one exp per
// pair, as the TPU kernel. Any S: Q, K, V and dO rows past S read as
// zeros (TMA's out-of-bounds fill), padded keys are masked, padded query
// rows are never stored. Head dims 16, 32, 64 and 128.
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 6*B*H*S^2*dh/2
// operations causal. At the 110M shape (8, 12, 512, 64): 4.8 GFLOP = 4.9
// us against 32 MB (q, k, v, dO in, dq out in bf16, lse and delta in
// f32) = 9.5 us: bytes bound (0.0095 ms). At (4, 12, 8192, 64): 619 GFLOP
// = 0.625 ms against 0.25 GB = 0.08 ms: operations bound.
//
// Design, after the forward (flash_fwd_sm90.cu, its items 1-4), against
// what held the mma.sync kernel before it (flash_bwd_dq_bf16) back:
//  1. wgmma. S = Q.K^T and dP = dO.V^T run m64n128k16 with both operands
//     K-major straight from the swizzled tiles: the forward's S product,
//     twice. dq += dS.K takes dS as a register A operand, packed to bf16
//     from the S accumulator (whose layout is the A fragment's), and K as
//     an MN-major B, one m64n64k16 per 64 columns of dh: the forward's
//     P.V with K in V's place. At dh 128 the K tiles are 64 keys
//     (m64n64k16 for S and dP), so that S, dP, dS and dq (64 f32 a thread
//     at that width) fit in the consumers' 240 registers.
//  2. Loads that overlap the math. One producer thread issues every
//     load: each item's Q and dO tiles into one of two buffers, its K and
//     V tiles into a ring (four stages, two at dh 128) as soon as a stage
//     is released, running ahead into the next item. Within a warpgroup,
//     S_j and dP_j are issued together with dq += dS_(j-1).K_(j-1), and
//     ds of tile j is computed while that product is on the tensor cores.
//     K tile 0 is peeled, so every path through the loop issues and waits
//     for the same products and ptxas keeps them asynchronous.
//  3. Persistent and ordered by a fixed deal: a work item is (b*h, a Q
//     tile of 128 rows), two consumer warpgroups of 64 rows each (wgmma's
//     M); one CTA per SM takes its items in rounds (Deal in sm90.cuh),
//     the longest causal rows first. The lse and delta of a thread's two
//     rows sit in registers for the item (lse is given, so no online
//     max). The CTA owns its Q tile's dq outright: no workspace, no
//     counter, no traffic between CTAs, and a launch needs no zeroed
//     memory.
//  4. p = exp(s*scale - lse) in the fused kernel's expression (expf), not
//     the forward's exp2 of pre-scaled scores. A row's ds sum to 0, so
//     where its keys are nearly alike dq is a small difference of large
//     terms, and a bf16 rounding of ds that lands on the other side moves
//     it by a share of its row: on an H100, on the 110M model's attention
//     activations, the exp2 form read 0.096 against the fused kernel's dq
//     (one unit of 12; expf: at most 0.0056), though it was 13% (S=512)
//     to 29% (S=8192) faster (PERF.md). With the fused kernel's p the two
//     forms round ds alike.
// dq is staged through this warpgroup's half of its item's Q buffer (free
// once the item's last S product is read) and stored in coalesced 16-byte
// rows. Every sum has a fixed order, so two launches agree bitwise.
//
// Plain C interface for ctypes (veles_torch/kernels.py): one launch on the
// caller's stream, returning cudaGetLastError() or the tensor map's
// encode failure.

#include "sm90.cuh"

namespace {

using namespace veles_sm90;

constexpr int kBQ = 128;             // query rows per item, 64 per warpgroup
constexpr int kThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr float kMaskValue = -1e9f;  // the TPU kernels' causal mask

// named barriers (0 is __syncthreads): one per consumer warpgroup
constexpr int kBarWarpgroup = 1;

// byte offsets from a 1024-byte aligned base; a tile is DP/64 chunks of
// 64 columns (128-byte rows, swizzled in 8-row atoms of 1024 bytes)
template <int DH>
struct Smem {
  static constexpr int kDP = DH < 64 ? 64 : DH;  // padded head dim
  static constexpr int kChunks = kDP / 64;
  static constexpr int kBK = DH == 128 ? 64 : 128;   // keys per K tile
  static constexpr int kStages = DH == 128 ? 2 : 4;  // K/V ring depth
  static constexpr int kQChunk = kBQ * 128;  // one 64-column chunk of Q, dO
  static constexpr int kKChunk = kBK * 128;  // ... of a K or V tile
  static constexpr int kQ = 0;  // [buffer][chunk]: two items' Q tiles
  static constexpr int kDO = kQ + 2 * kChunks * kQChunk;  // ... dO tiles
  static constexpr int kK = kDO + 2 * kChunks * kQChunk;  // [stage][chunk]
  static constexpr int kV = kK + kStages * kChunks * kKChunk;
  // q_full[2], q_empty[2], full[stage], empty[stage]
  static constexpr int kBars = kV + kStages * kChunks * kKChunk;
  static constexpr int kBytes = kBars + (4 + 2 * kStages) * 8 + 1024;
  static_assert(kBQ % kBK == 0, "the causal bounds assume whole K tiles");
};

// d (64 x NK keys, f32) (+)= A (64 x 16) . B (16 x NK)^T, both K-major
// from shared memory
template <int NK>
__device__ __forceinline__ void mma_keys(float (&d)[NK / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (NK == 128) {
    wgmma_ss_n128(d, a, b, scale_d);
  } else {
    wgmma_ss<0, 0>(d, a, b, scale_d);
  }
}

// sa = Q . K^T and pa = dO . V^T over dh (KS k steps of 16) for one K
// tile, committed as one group; Q, dO, K and V K-major from their
// swizzled tiles (64-column chunks QC and KC bytes apart)
template <int KS, int NK, int QC, int KC>
__device__ __forceinline__ void issue_sdp(float (&sa)[NK / 2],
                                          float (&pa)[NK / 2],
                                          const unsigned char* s_q,
                                          const unsigned char* s_do,
                                          const unsigned char* s_k,
                                          const unsigned char* s_v) {
  fence_acc(sa);
  fence_acc(pa);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int qoff = (ks / 4) * QC + (ks % 4) * 32;
    const int koff = (ks / 4) * KC + (ks % 4) * 32;
    mma_keys<NK>(sa, desc(s_q + qoff), desc(s_k + koff), ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int qoff = (ks / 4) * QC + (ks % 4) * 32;
    const int koff = (ks / 4) * KC + (ks % 4) * 32;
    mma_keys<NK>(pa, desc(s_do + qoff), desc(s_v + koff), ks > 0);
  }
  wgmma_commit();
  fence_acc(sa);
  fence_acc(pa);
}

// d += dS . K over one K tile (C chunks of 64 columns, NK/16 k steps of 16
// keys), committed as its own group; every register it reads is pinned
// before its fence, and again after the commit
template <int C, int NK>
__device__ __forceinline__ void dq_product(float (&d)[C][32],
                                           uint32_t (&df)[NK / 16][4],
                                           const unsigned char* s_k,
                                           int kchunk) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    fence_acc(d[c]);
  }
  fence_frag(df);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int ks = 0; ks < NK / 16; ++ks) {
      wgmma_rs<1>(d[c], df[ks], desc(s_k + c * kchunk + ks * 2048));
    }
  }
  wgmma_commit();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    fence_acc(d[c]);
  }
  fence_frag(df);
}

// ds of one K tile on this thread's two rows (r0 and r0 + 8; element e of
// the accumulator is row r0 + 8*((e>>1)&1), key k0 + 8*(e/4) + 2*(lane%4)
// + (e&1)), in place of the raw scores sa: p = exp(s*scale - lse) with
// the causal -1e9 mask and the padded keys only where ``masked``; ds =
// p*(dp - delta)*scale in f32. It runs while the previous tile's dq
// product is in flight, so it writes no register but sa's: ds is packed
// into that product's A fragments once it is done.
template <int N>
__device__ __forceinline__ void ds_tile(float (&sa)[N], const float (&pa)[N],
                                        const float (&lr)[2],
                                        const float (&dl)[2], bool masked,
                                        int causal, int k0, int r0, int s,
                                        float scale) {
  const int t4 = threadIdx.x % 4;
  if (masked) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int h = (e >> 1) & 1;
      const int key = k0 + 8 * (e / 4) + 2 * t4 + (e & 1);
      float x = sa[e] * scale;
      if (causal && key > r0 + 8 * h) {
        x = kMaskValue;
      }
      float p = expf(x - lr[h]);
      // padded keys: a very negative lse would overflow the exp
      if (key >= s) {
        p = 0.0f;
      }
      sa[e] = p * (pa[e] - dl[h]) * scale;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int h = (e >> 1) & 1;
      const float p = expf(sa[e] * scale - lr[h]);
      sa[e] = p * (pa[e] - dl[h]) * scale;
    }
  }
}

// ds (f32, the S accumulator's layout) -> the dq product's bf16 A
// fragments: k step ks takes elements 8*ks .. 8*ks + 7
template <int KT>
__device__ __forceinline__ void pack_ds(uint32_t (&df)[KT][4],
                                        const float (&sa)[8 * KT]) {
#pragma unroll
  for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      df[ks][r] = pack_bf16(sa[8 * ks + 2 * r], sa[8 * ks + 2 * r + 1]);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int bh_total, int s, int causal, float scale) {
  using SM = Smem<DH>;
  constexpr int C = SM::kChunks;
  constexpr int KS = DH / 16;  // k steps of S and dP over dh
  constexpr int ST = SM::kStages;
  constexpr int NK = SM::kBK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + SM::kBars);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + ST;

  const int n_kt = (s + NK - 1) / NK;
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
    uint32_t par = 1;  // the ring and both Q/dO buffers start empty
    for (int r = 0, i = deal.item(0); i >= 0; i = deal.item(++r)) {
      const int qt = n_qt - 1 - i / bh_total;
      const int bh = i % bh_total;
      // the item's Q and dO tiles go into the buffer its last-but-one
      // item's dq has left
      const int qb = r & 1;
      mbar_wait(&q_empty[qb], ((r >> 1) & 1) ^ 1);
      mbar_expect_tx(&q_full[qb], 2 * C * SM::kQChunk);
      for (int c = 0; c < C; ++c) {
        const int off = (qb * C + c) * SM::kQChunk;
        tma_load(smem + SM::kQ + off, &tm_q, c * 64, qt * kBQ, bh,
                 &q_full[qb]);
        tma_load(smem + SM::kDO + off, &tm_do, c * 64, qt * kBQ, bh,
                 &q_full[qb]);
      }
      const int hi =
          causal ? min(n_kt, (qt * kBQ + kBQ + NK - 1) / NK) : n_kt;
      for (int j = 0; j < hi; ++j) {
        mbar_wait(&empty[stage], par);
        mbar_expect_tx(&full[stage], 2 * C * SM::kKChunk);
        for (int c = 0; c < C; ++c) {
          const int off = (stage * C + c) * SM::kKChunk;
          tma_load(smem + SM::kK + off, &tm_k, c * 64, j * NK, bh,
                   &full[stage]);
          tma_load(smem + SM::kV + off, &tm_v, c * 64, j * NK, bh,
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
  const bool ragged = s % NK != 0;
  int stage = 0;
  uint32_t par = 0;

  for (int r = 0, i = deal.item(0); i >= 0; i = deal.item(++r)) {
    const int qt = n_qt - 1 - i / bh_total;
    const int bh = i % bh_total;
    const int q0 = qt * kBQ;
    // causal: K tiles past this Q tile's last row are all masked — skipped
    const int hi = causal ? min(n_kt, (q0 + kBQ + NK - 1) / NK) : n_kt;
    // first K tile that can hold a key past one of this tile's rows
    const int clear = causal ? q0 / NK : n_kt;
    const int r0 = q0 + wg * 64 + 16 * warp + g;  // and r0 + 8
    const int qb = r & 1;
    unsigned char* s_q = smem + SM::kQ + qb * C * SM::kQChunk + wg * 64 * 128;
    const unsigned char* s_do =
        smem + SM::kDO + qb * C * SM::kQChunk + wg * 64 * 128;

    // lse and delta of this thread's two rows (0 past S: those rows are
    // never stored)
    float lr[2];
    float dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const int64_t at = static_cast<int64_t>(bh) * s + row;
      lr[h] = row < s ? lse[at] : 0.0f;
      dl[h] = row < s ? delta[at] : 0.0f;
    }
    float dqa[C][32];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        dqa[c][e] = 0.0f;
      }
    }
    uint32_t df[NK / 16][4];  // the tile whose dq product is next
    mbar_wait(&q_full[qb], (r >> 1) & 1);

    // K tile 0, alone: no dq product in flight yet. Every later tile
    // issues the previous tile's dq product and waits for it on every
    // path, so the compiler can see which products are in flight where.
    mbar_wait(&full[stage], par);
    float sa[NK / 2];
    float pa[NK / 2];
    issue_sdp<KS, NK, SM::kQChunk, SM::kKChunk>(
        sa, pa, s_q, s_do, smem + SM::kK + stage * C * SM::kKChunk,
        smem + SM::kV + stage * C * SM::kKChunk);
    wgmma_wait_all();
    fence_acc(sa);
    fence_acc(pa);
    ds_tile(sa, pa, lr, dl, clear == 0 || (ragged && n_kt == 1), causal, 0,
            r0, s, scale);
    pack_ds(df, sa);
    int prev = stage;  // the stage of the tile whose dq product is next
    if (++stage == ST) {
      stage = 0;
      par ^= 1;
    }
    for (int j = 1; j < hi; ++j) {
      mbar_wait(&full[stage], par);
      issue_sdp<KS, NK, SM::kQChunk, SM::kKChunk>(
          sa, pa, s_q, s_do, smem + SM::kK + stage * C * SM::kKChunk,
          smem + SM::kV + stage * C * SM::kKChunk);
      // the previous tile's dq product, on the tensor cores while this
      // tile's ds is computed
      dq_product<C, NK>(dqa, df, smem + SM::kK + prev * C * SM::kKChunk,
                        SM::kKChunk);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(sa);
      fence_acc(pa);
      ds_tile(sa, pa, lr, dl, j >= clear || (ragged && j == n_kt - 1),
              causal, j * NK, r0, s, scale);
      wgmma_wait_all();
      mbar_arrive(&empty[prev]);  // K and V of the previous tile are read
#pragma unroll
      for (int c = 0; c < C; ++c) {
        fence_acc(dqa[c]);
      }
      pack_ds(df, sa);
      prev = stage;
      if (++stage == ST) {
        stage = 0;
        par ^= 1;
      }
    }
    // the last tile's dq product
    dq_product<C, NK>(dqa, df, smem + SM::kK + prev * C * SM::kKChunk,
                      SM::kKChunk);
    wgmma_wait_all();
    mbar_arrive(&empty[prev]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      fence_acc(dqa[c]);
    }

    // dq in bf16, staged (128-byte swizzled, as the Q tile) into this
    // warpgroup's half of the Q tile, then stored in 16-byte rows
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int row = 16 * warp + g + 8 * ((e >> 1) & 1);
        const int chunk = (e / 4) ^ (row % 8);
        *reinterpret_cast<uint32_t*>(s_q + c * SM::kQChunk + row * 128 +
                                     chunk * 16 + 4 * t4) =
            pack_bf16(dqa[c][e], dqa[c][e + 1]);
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
            dq + (static_cast<int64_t>(bh) * s + row0 + row) * DH +
            piece * 8) = val;
      }
    }
    // the Q and dO buffers are free for a later item's TMA loads (the
    // async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&q_empty[qb]);
  }
}

// -- host side ------------------------------------------------------------

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int s, int causal, float scale,
                   cudaStream_t stream) {
  using SM = Smem<DH>;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, bh, s, DH, kBQ) ||
      !make_map(&tk, k, bh, s, DH, SM::kBK) ||
      !make_map(&tv, v, bh, s, DH, SM::kBK) ||
      !make_map(&tdo, dout, bh, s, DH, kBQ)) {
    return cudaErrorInvalidValue;
  }
  constexpr int bytes = SM::kBytes;
  cudaError_t rc = cudaFuncSetAttribute(
      flash_dq_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  flash_dq_sm90<DH><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), bh, s,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq: (bh, s, dh) bf16; lse, delta: (bh, s) f32
extern "C" int veles_flash_dq_sm90(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int bh, int s, int dh,
                                   int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0 ||
      static_cast<int64_t>(bh) * ((s + kBQ - 1) / kBQ) > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale,
                        st);
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale,
                        st);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, bh, s, causal, scale,
                        st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq, bh, s, causal,
                         scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* veles_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
