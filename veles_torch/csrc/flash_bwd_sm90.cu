// The fused flash-attention backward for bf16 inputs on Hopper (sm_90a):
// dq, dk and dv in one pass, the block products on wgmma, the Q-side
// tiles brought in by TMA, dq summed in a fixed order without partials.
// The same kernel without dq is the two-kernel backward's dk/dv kernel.
//
// Replaces the Pallas TPU kernel _dkvq_kernel of veles/znicz_tpu/
// parallel/pallas_attention.py:384 (flash_attention_bwd, fused=True) as
// flash_bwd_sm90<DH, WITH_DQ=true>, and _dkv_kernel (:324, fused=False)
// as flash_bwd_sm90<DH, WITH_DQ=false>, for bf16 inputs (the pair's dq
// kernel is flash_dq_sm90.cu). f32 inputs keep flash_bwd_f32 + dq_reduce
// and flash_bwd_dkv_f32, unchanged, in flash_attention.cu. What it
// computes, under the dtype rules in the header of flash_attention.cu:
// per (K tile, Q tile) pair, s = q.k^T * scale in f32, the causal -1e9
// mask, p = exp(s - lse) in f32; dv += p^T.do with p rounded to bf16;
// ds = p*(do.v^T - delta)*scale rounded to bf16; dk += ds^T.q and dq +=
// ds.k; f32 accumulation; five block products and one exp per pair, as
// the TPU kernel (four without dq, as _dkv_kernel). Any S: Q and dO rows
// past S come in as zeros (TMA's out-of-bounds fill) and padded rows and
// keys are masked. Head dims 16, 32, 64 and 128.
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s): 10*B*H*S^2*dh/2
// operations causal. At the 110M shape (8, 12, 512, 64): 8.1 GFLOP = 8.1
// us against 44 MB (q, k, v, dO, dq, dk, dv in bf16, lse and delta in
// f32) = 13.3 us: bytes bound (0.0133 ms). At (4, 12, 8192, 64): 1.03
// TFLOP = 1.042 ms against 0.4 GB = 0.12 ms: operations bound. Without
// dq: 8*B*H*S^2*dh/2 operations; 38 MB (no dq) = 11.4 us at the 110M
// shape (bytes), 0.834 ms at (4, 12, 8192, 64) (operations).
//
// Design, against what held the old kernel (design (b), flash_bwd_bf16 +
// dq_reduce) back:
//  1. No dq partials. One f32 workspace dq_acc (b*h, n_qt*64, dh) takes
//     every contribution, and a per-(b*h, Q tile) int32 counter orders
//     them: K tiles descending, which is the order a causal run reaches a
//     Q tile in anyway (K tile j+1 starts two Q tiles further down). The
//     consumers hand each step's two dq shares (one per warpgroup) to a
//     writer warp through shared memory and go on; the writer sums the
//     shares, waits until the counter names its contribution (every lane
//     acquires it: a relaxed probe issued before the sum, then
//     fence.acq_rel.gpu, or ld.acquire.gpu spins), reads the tile of
//     dq_acc through L2 (cp.async.cg into shared memory), adds with plain
//     f32 arithmetic (no float atomics), stores (st.global.cg), and
//     releases the counter (red.release.gpu, once per lane, after the
//     lane's own stores). Three writer warps each own a buffer, so three
//     tiles' read-modify-writes are in flight at once (one at dh 128, for
//     room). The first contributor (the diagonal K tile, causal) stores
//     without adding, so dq_acc needs no zeroing; the last (K tile 0)
//     writes dq in bf16 and skips the store, so no dq_reduce pass is
//     left. Every sum has a fixed order: two launches agree bitwise.
//     Traffic, counted as the old note counted the partials: 16 KB of
//     f32 per (K tile of 128 keys, Q tile) pair, stored by every
//     contributor but the last and read by every one but the first. At
//     (4, 12, 8192, 64) causal that is 4032 of the 4160 pairs per head
//     each way: 3.2 GB stored and 3.2 GB read, into the L2. The rows in
//     flight are only those of the Q tiles the ~132 resident CTAs are on
//     (about 2 MB, one or two heads), so HBM should see dq_acc (48 x 8192
//     x 64 x 4 B = 100 MB) about once. At (8, 12, 512, 64): 19 MB each
//     way into the L2, over a 13 MB dq_acc. The old partials sent 13 GB
//     (3.9 ms at the HBM rate) to HBM at S=8192 and 113 MB at the 110M
//     shape. What this costs is latency, not bytes: each tile's
//     read-modify-write is three dependent L2 round trips (acquire, read,
//     release), and the writers, not the products, set the pace at
//     S=8192 (PERF.md).
//  2. Work items are (b*h, K tile of 128 keys), handed out from a global
//     ticket (atomicAdd) in (b*h, K tile descending) order to a
//     persistent grid of one CTA per SM. A contribution only ever waits
//     on an item with an earlier ticket, which a running CTA holds: no
//     deadlock, whatever order the blocks launch in. The long causal
//     items (K tile 0) come last within a head and the ticket balances
//     the rest, where the old grid ran 480 long serial CTAs in two
//     uneven waves at S=8192.
//  3. The products on wgmma m64n64k16 (bf16 in, f32 accumulate), 4 of
//     them per 16 of the reduction: two consumer warpgroups each own 64
//     keys of the tile (wgmma's M). S^T = K.Q^T and dP^T = V.dO^T read K,
//     V, Q and dO from shared memory (K-major); dv += P^T.dO and dk +=
//     dS^T.Q take P^T and dS^T as register A operands straight from the
//     S^T and dP^T accumulators, rounded to bf16, with dO and Q as
//     MN-major B; dq's share dS.K reads dS^T (stored bf16 into shared
//     memory, 128-byte swizzled) as an MN-major A and K as an MN-major
//     B. Each warpgroup sums over its own 64 keys; the two halves meet in
//     shared memory and are added in a fixed order. dk and dv stay in
//     registers for the whole item.
//  4. TMA and an mbarrier ring. A loader warp takes the tickets,
//     issues cp.async.bulk.tensor loads of the K and V tile per item and
//     of the Q and dO tiles per step into a two-stage ring (the tiles'
//     lse and delta by its lanes), and the consumers wait on the ring's
//     mbarriers, so the next Q tile is in flight while this one
//     computes. The tensor maps (encoded on the host with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda) use the 128-byte swizzle that the
//     wgmma descriptors name; a 64-column box each, so dh 128 is two
//     boxes and dh 16 and 32 are one box whose columns past dh read as
//     zeros (the products then run at a width of 64). The loader and
//     the three writers make up the third warpgroup; setmaxnreg gives it
//     56 registers and the consumers 224.
//
// Without dq (WITH_DQ=false, _dkv_kernel's counterpart) the kernel drops
// the dS^T store, the dq share, the writer warps and their mbarriers,
// dq_acc and the counters, and keeps four products per pair (S^T, dP^T,
// dv, dk) in the same order and arithmetic, so its dk and dv are the
// fused kernel's bit for bit. Its items need no order: they come from a
// fixed deal (Deal in sm90.cuh), K tiles ascending (the longest causal
// items first) and the heads in turn, so a launch needs no zeroed memory.
//
// The PTX wrappers and the tensor-map encoder are in sm90.cuh, shared
// with the forward (flash_fwd_sm90.cu) and the dq kernel
// (flash_dq_sm90.cu).
//
// Plain C interface for ctypes (veles_torch/kernels.py): one launch on the
// caller's stream, returning cudaGetLastError() or the tensor map's
// encode failure.

#include "sm90.cuh"

namespace {

using namespace veles_sm90;

constexpr int kBQ = 64;              // query rows per Q tile (a step)
constexpr int kBK = 128;             // keys per work item, 64 per warpgroup
constexpr int kStages = 2;           // Q/dO ring depth
constexpr int kThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr float kMaskValue = -1e9f;  // the TPU kernels' causal mask

// named barriers (0 is __syncthreads): one per consumer warpgroup
constexpr int kBarWarpgroup = 1;

// -- shared memory --------------------------------------------------------

// byte offsets from a 1024-byte aligned base; a tile is DP/64 chunks of
// 64 columns (128-byte rows, swizzled in 8-row atoms of 1024 bytes)
template <int DH, bool WITH_DQ>
struct Smem {
  static constexpr int kDP = DH < 64 ? 64 : DH;  // padded head dim
  static constexpr int kChunks = kDP / 64;
  static constexpr int kKChunk = kBK * 128;  // one 64-column chunk of K
  static constexpr int kQChunk = kBQ * 128;  // ... of a Q tile
  static constexpr int kLdPart = kDP + 8;    // f32 row stride of a dq half
  // dq tiles in flight to the writers, one writer warp each (one at dh
  // 128, for room; none without dq)
  static constexpr int kDqBufs = !WITH_DQ ? 0 : DH == 128 ? 1 : 3;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kChunks * kKChunk;
  static constexpr int kQ = kV + kChunks * kKChunk;  // [stage][chunk]
  static constexpr int kDO = kQ + kStages * kChunks * kQChunk;
  static constexpr int kDS = kDO + kStages * kChunks * kQChunk;  // [wg]
  static constexpr int kPart = kDS + (WITH_DQ ? 2 * kBQ * 128 : 0);
  static constexpr int kLse = kPart + kDqBufs * 2 * kBQ * kLdPart * 4;
  static constexpr int kDelta = kLse + kStages * kBQ * 4;
  static constexpr int kBars = kDelta + kStages * kBQ * 4;
  // full[stage], empty[stage], kv_full, kv_empty, dq_full[buf],
  // dq_empty[buf]; then the item, and each dq tile's (b*h, K tile, Q tile)
  static constexpr int kItem = kBars + (2 * kStages + 2 + 2 * kDqBufs) * 8;
  static constexpr int kMeta = kItem + 16;
  static constexpr int kBytes = kMeta + kDqBufs * 16 + 1024;  // + alignment
};

// -- the kernel -----------------------------------------------------------

template <int DH, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   bf16* __restrict__ dk, bf16* __restrict__ dv,
                   float* __restrict__ dq_acc, int* __restrict__ sync,
                   int bh_total, int s, int causal, float scale) {
  using SM = Smem<DH, WITH_DQ>;
  constexpr int C = SM::kChunks;
  constexpr int KS = DH / 16;  // k steps of S^T and dP^T over dh

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* dq_full = kv_empty + 1;
  uint64_t* dq_empty = dq_full + SM::kDqBufs;
  int* s_item = reinterpret_cast<int*>(smem + SM::kItem);
  int* s_meta = reinterpret_cast<int*>(smem + SM::kMeta);
  float* s_part = reinterpret_cast<float*>(smem + SM::kPart);
  float* s_lse = reinterpret_cast<float*>(smem + SM::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + SM::kDelta);

  const int n_qt = (s + kBQ - 1) / kBQ;
  const int n_kt = (s + kBK - 1) / kBK;
  const int n_items = bh_total * n_kt;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);  // the loader warp's lanes
      mbar_init(&empty[st], kConsumers);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers);
    for (int b = 0; b < SM::kDqBufs; ++b) {
      mbar_init(&dq_full[b], kConsumers);
      mbar_init(&dq_empty[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: a loader warp and the dq writers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x >= kConsumers + 32) {
      // the dq writers, a warp per dq buffer: each dq tile of the
      // consumers into dq_acc (or dq) once its counter admits it; the
      // three warps work on three Q tiles at once, so the latency of one
      // tile's read-modify-write hides behind the others'
      const int writer = (threadIdx.x - kConsumers) / 32 - 1;
      if (writer >= SM::kDqBufs) {
        return;
      }
      const int lane = threadIdx.x % 32;
      constexpr int U = DH / 4;  // float4 per row
      uint32_t par = 0;
      for (;;) {
        mbar_wait(&dq_full[writer], par);
        par ^= 1;
        const int bh = s_meta[4 * writer];
        const int kt = s_meta[4 * writer + 1];
        const int qt = s_meta[4 * writer + 2];
        if (kt < 0) {
          break;
        }
        const int first =
            causal ? min(n_kt - 1, qt / (kBK / kBQ)) : n_kt - 1;
        int* counter = sync + 1 + static_cast<int64_t>(bh) * n_qt + qt;
        float* part0 = s_part + writer * 2 * kBQ * SM::kLdPart;
        float* part1 = part0 + kBQ * SM::kLdPart;
        float* acc_tile =
            dq_acc + (static_cast<int64_t>(bh) * n_qt + qt) * kBQ * DH;
        if (kt != first) {
          // probe the counter now, and sum the two warpgroups' shares into
          // part1 while the probe is in flight
          const int target = 32 * (first - kt);
          const int seen = ld_relaxed(counter);
#pragma unroll 4
          for (int u = lane; u < kBQ * U; u += 32) {
            const int off = (u / U) * SM::kLdPart + (u % U) * 4;
            const float4 a = *reinterpret_cast<const float4*>(part0 + off);
            float4* b = reinterpret_cast<float4*>(part1 + off);
            const float4 c = *b;
            *b = make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
          }
          // each lane acquires the counter itself: every lane of each
          // contribution before this one released it once
          if (seen >= target) {
            asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
          } else {
            const uint64_t t0 = now_ns();
            while (ld_acquire(counter) < target) {
              if (now_ns() - t0 > kSpinNs) {
                __trap();
              }
            }
          }
          // dq_acc's tile into part0 (read, so free), through L2
#pragma unroll 4
          for (int u = lane; u < kBQ * U; u += 32) {
            cp_async16(part0 + (u / U) * SM::kLdPart + (u % U) * 4,
                       acc_tile + (u / U) * DH + (u % U) * 4);
          }
          asm volatile("cp.async.commit_group;\n"
                       "cp.async.wait_group 0;\n" ::: "memory");
        }
        // part0 + part1: the two shares (first contribution), or the old
        // sum and the two shares' sum
#pragma unroll 4
        for (int u = lane; u < kBQ * U; u += 32) {
          const int r = u / U;
          const int c4 = (u % U) * 4;
          const float4 a = *reinterpret_cast<const float4*>(
              part0 + r * SM::kLdPart + c4);
          const float4 b = *reinterpret_cast<const float4*>(
              part1 + r * SM::kLdPart + c4);
          const float4 v =
              make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
          if (kt == 0) {
            const int row = qt * kBQ + r;
            if (row < s) {
              uint2 out;
              out.x = pack_bf16(v.x, v.y);
              out.y = pack_bf16(v.z, v.w);
              *reinterpret_cast<uint2*>(
                  dq + (static_cast<int64_t>(bh) * s + row) * DH + c4) = out;
            }
          } else {
            __stcg(reinterpret_cast<float4*>(acc_tile + r * DH + c4), v);
          }
        }
        if (kt > 0) {
          red_release(counter, 1);  // after this lane's own stores
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&dq_empty[writer]);
        }
      }
      return;
    }
    const int lane = threadIdx.x % 32;
    int stage = 0;
    uint32_t empty_par = 1;  // the ring starts empty
    uint32_t kv_par = 1;
    // without dq: item i of the deal is K tile i / bh_total of head
    // i % bh_total, the longest causal items first
    const Deal deal{static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x),
                    n_items};
    for (int turn = 0;; ++turn) {
      int item = 0;
      if constexpr (WITH_DQ) {
        if (lane == 0) {
          item = atomicAdd(sync, 1);
        }
        item = __shfl_sync(0xffffffffu, item, 0);
      } else {
        // as the ticket that names the same (b*h, K tile)
        const int i = deal.item(turn);
        item = i < 0 ? n_items
                     : (i % bh_total) * n_kt + n_kt - 1 - i / bh_total;
      }
      const bool done = item >= n_items;
      mbar_wait(kv_empty, kv_par);
      kv_par ^= 1;
      const int bh = item / n_kt;
      const int kt = n_kt - 1 - item % n_kt;
      if (lane == 0) {
        *s_item = done ? -1 : item;
        if (done) {
          mbar_arrive(kv_full);
        } else {
          mbar_expect_tx(kv_full, 2 * C * SM::kKChunk);
          for (int c = 0; c < C; ++c) {
            tma_load(smem + SM::kK + c * SM::kKChunk, &tm_k, c * 64,
                     kt * kBK, bh, kv_full);
            tma_load(smem + SM::kV + c * SM::kKChunk, &tm_v, c * 64,
                     kt * kBK, bh, kv_full);
          }
        }
      }
      if (done) {
        break;
      }
      const float* lse_bh = lse + static_cast<int64_t>(bh) * s;
      const float* delta_bh = delta + static_cast<int64_t>(bh) * s;
      for (int qt = causal ? (kBK / kBQ) * kt : 0; qt < n_qt; ++qt) {
        mbar_wait(&empty[stage], empty_par);
        for (int r = lane; r < kBQ; r += 32) {
          const int row = qt * kBQ + r;
          s_lse[stage * kBQ + r] = row < s ? lse_bh[row] : 0.0f;
          s_delta[stage * kBQ + r] = row < s ? delta_bh[row] : 0.0f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * C * SM::kQChunk);
          for (int c = 0; c < C; ++c) {
            const int off = (stage * C + c) * SM::kQChunk;
            tma_load(smem + SM::kQ + off, &tm_q, c * 64, qt * kBQ, bh,
                     &full[stage]);
            tma_load(smem + SM::kDO + off, &tm_do, c * 64, qt * kBQ, bh,
                     &full[stage]);
          }
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) {
          stage = 0;
          empty_par ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wg owns keys wg*64 .. +63 of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int g = (tid % 32) / 4;
    const int t4 = tid % 4;
    unsigned char* s_ds = smem + SM::kDS + wg * kBQ * 128;
    const bool ragged_k = s % kBK != 0;
    const bool ragged_q = s % kBQ != 0;
    int stage = 0;
    uint32_t full_par = 0;
    uint32_t kv_par = 0;
    int dbuf = 0;
    uint32_t dq_par = 1;  // the writers' buffers start free
    for (;;) {
      mbar_wait(kv_full, kv_par);
      kv_par ^= 1;
      const int item = *s_item;
      if (item < 0) {
        // tell every writer there is no more
        for (int n = 0; n < SM::kDqBufs; ++n) {
          mbar_wait(&dq_empty[dbuf], dq_par);
          if (tid == 0) {
            s_meta[4 * dbuf + 1] = -1;
          }
          mbar_arrive(&dq_full[dbuf]);
          if (++dbuf == SM::kDqBufs) {
            dbuf = 0;
            dq_par ^= 1;
          }
        }
        break;
      }
      const int bh = item / n_kt;
      const int kt = n_kt - 1 - item % n_kt;
      const int k0 = kt * kBK + wg * 64;  // this warpgroup's first key
      const unsigned char* s_k = smem + SM::kK + wg * 64 * 128;
      const unsigned char* s_v = smem + SM::kV + wg * 64 * 128;
      float dka[C][32];
      float dva[C][32];
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          dka[c][e] = 0.0f;
          dva[c][e] = 0.0f;
        }
      }
      for (int qt = causal ? (kBK / kBQ) * kt : 0; qt < n_qt; ++qt) {
        mbar_wait(&full[stage], full_par);
        const unsigned char* s_q = smem + SM::kQ + stage * C * SM::kQChunk;
        const unsigned char* s_do =
            smem + SM::kDO + stage * C * SM::kQChunk;
        const float* lse_s = s_lse + stage * kBQ;
        const float* delta_s = s_delta + stage * kBQ;

        // S^T = K.Q^T and dP^T = V.dO^T over dh (64 keys x 64 queries)
        float sa[32];
        float pa[32];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = (ks / 4) * SM::kKChunk + (ks % 4) * 32;
          const int qoff = (ks / 4) * SM::kQChunk + (ks % 4) * 32;
          wgmma_ss<0, 0>(sa, desc(s_k + off), desc(s_q + qoff), ks > 0);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = (ks / 4) * SM::kKChunk + (ks % 4) * 32;
          const int qoff = (ks / 4) * SM::kQChunk + (ks % 4) * 32;
          wgmma_ss<0, 0>(pa, desc(s_v + off), desc(s_do + qoff), ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();

        // p and ds; element e of a thread: key 16*warp + g (+8 for e&2),
        // query 8*(e/4) + 2*t4 + (e&1)
        const bool masked = (causal && qt < (kBK / kBQ) * (kt + 1)) ||
                            (ragged_k && kt == n_kt - 1) ||
                            (ragged_q && qt == n_qt - 1);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = 8 * (e / 4) + 2 * t4 + (e & 1);
          const int row = qt * kBQ + qi;
          const int key = k0 + 16 * warp + g + 8 * ((e >> 1) & 1);
          float x = sa[e] * scale;
          if (masked && causal && key > row) {
            x = kMaskValue;
          }
          float p = expf(x - lse_s[qi]);
          if (masked && (row >= s || key >= s)) {
            p = 0.0f;
          }
          sa[e] = p;
          pa[e] = p * (pa[e] - delta_s[qi]) * scale;
        }
        // P^T and dS^T as bf16 A fragments (k = queries), and dS^T into
        // shared memory [key][query], 128-byte swizzled, for dq
        uint32_t pf[4][4];
        uint32_t df[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pf[ks][r] = pack_bf16(sa[8 * ks + 2 * r], sa[8 * ks + 2 * r + 1]);
            df[ks][r] = pack_bf16(pa[8 * ks + 2 * r], pa[8 * ks + 2 * r + 1]);
          }
        }
        if constexpr (WITH_DQ) {
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int key = 16 * warp + g + 8 * ((e >> 1) & 1);
            const int chunk = (e / 4) ^ (key % 8);
            *reinterpret_cast<uint32_t*>(s_ds + key * 128 + chunk * 16 +
                                         4 * t4) =
                df[e / 8][(e % 8) / 2];
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bar_sync(kBarWarpgroup + wg, 128);  // dS^T is in shared memory
        }

        // dv += P^T.dO and dk += dS^T.Q (k = the 64 queries), then this
        // warpgroup's share of dq, dS (64 queries x its 64 keys) . K, in
        // 64-column chunks, all issued before the first wait
        float qa[32];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int off = c * SM::kQChunk + ks * 2048;
            wgmma_rs<1>(dva[c], pf[ks], desc(s_do + off));
            wgmma_rs<1>(dka[c], df[ks], desc(s_q + off));
          }
        }
        if constexpr (WITH_DQ) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_ss<1, 1>(qa, desc(s_ds + ks * 2048), desc(s_k + ks * 2048),
                           ks > 0);
          }
        }
        wgmma_commit();
        if constexpr (WITH_DQ) {
          // the writers' buffer, which takes the two shares in order
          mbar_wait(&dq_empty[dbuf], dq_par);
        }
        wgmma_wait_all();
        mbar_arrive(&empty[stage]);  // Q, dO, lse and delta are read
        if (++stage == kStages) {
          stage = 0;
          full_par ^= 1;
        }
        if constexpr (WITH_DQ) {
          float* part = s_part + (dbuf * 2 + wg) * kBQ * SM::kLdPart;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (c > 0) {
              wgmma_fence();
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
                wgmma_ss<1, 1>(qa, desc(s_ds + ks * 2048),
                               desc(s_k + c * SM::kKChunk + ks * 2048),
                               ks > 0);
              }
              wgmma_commit();
              wgmma_wait_all();
            }
#pragma unroll
            for (int e = 0; e < 32; e += 2) {
              const int row = 16 * warp + g + 8 * ((e >> 1) & 1);
              const int col = c * 64 + 8 * (e / 4) + 2 * t4;
              *reinterpret_cast<float2*>(part + row * SM::kLdPart + col) =
                  make_float2(qa[e], qa[e + 1]);
            }
          }
          if (tid == 0) {
            s_meta[4 * dbuf] = bh;
            s_meta[4 * dbuf + 1] = kt;
            s_meta[4 * dbuf + 2] = qt;
          }
          mbar_arrive(&dq_full[dbuf]);
          if (++dbuf == SM::kDqBufs) {
            dbuf = 0;
            dq_par ^= 1;
          }
        }
      }

      // dk and dv rows of this warpgroup's keys
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int key = k0 + 16 * warp + g + 8 * ((e >> 1) & 1);
          const int col = c * 64 + 8 * (e / 4) + 2 * t4;
          if (key < s && col < DH) {
            const int64_t off = (static_cast<int64_t>(bh) * s + key) * DH + col;
            *reinterpret_cast<uint32_t*>(dk + off) =
                pack_bf16(dka[c][e], dka[c][e + 1]);
            *reinterpret_cast<uint32_t*>(dv + off) =
                pack_bf16(dva[c][e], dva[c][e + 1]);
          }
        }
      }
      mbar_arrive(kv_empty);  // K and V are read
    }
  }
}

// -- host side ------------------------------------------------------------

template <int DH, bool WITH_DQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, void* dq_acc, void* sync,
                   int bh, int s, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, bh, s, DH, kBQ) || !make_map(&tk, k, bh, s, DH, kBK) ||
      !make_map(&tv, v, bh, s, DH, kBK) ||
      !make_map(&tdo, dout, bh, s, DH, kBQ)) {
    return cudaErrorInvalidValue;
  }
  constexpr int bytes = Smem<DH, WITH_DQ>::kBytes;
  auto kernel = flash_bwd_sm90<DH, WITH_DQ>;
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
  const int items = bh * ((s + kBK - 1) / kBK);
  const int grid = items < n_sm ? items : n_sm;
  kernel<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_acc), static_cast<int*>(sync), bh, s, causal,
      scale);
  return cudaGetLastError();
}

template <bool WITH_DQ>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk,
             void* dv, void* dq_acc, void* sync, int bh, int s, int dh,
             int causal, float scale, void* stream) {
  if (bh <= 0 || s <= 0) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16, WITH_DQ>(q, k, v, dout, lse, delta, dq, dk, dv,
                                 dq_acc, sync, bh, s, causal, scale, st);
    case 32:
      return launch<32, WITH_DQ>(q, k, v, dout, lse, delta, dq, dk, dv,
                                 dq_acc, sync, bh, s, causal, scale, st);
    case 64:
      return launch<64, WITH_DQ>(q, k, v, dout, lse, delta, dq, dk, dv,
                                 dq_acc, sync, bh, s, causal, scale, st);
    case 128:
      return launch<128, WITH_DQ>(q, k, v, dout, lse, delta, dq, dk, dv,
                                  dq_acc, sync, bh, s, causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (bh, s, dh) bf16; lse, delta: (bh, s) f32;
// dq_acc: (bh, ceil(s/64)*64, dh) f32, any contents; sync: 1 + bh *
// ceil(s/64) int32, zeros (the ticket, then one counter per Q tile)
extern "C" int veles_flash_bwd_sm90(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv,
                                    void* dq_acc, void* sync, int bh, int s,
                                    int dh, int causal, float scale,
                                    void* stream) {
  return dispatch<true>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, sync,
                        bh, s, dh, causal, scale, stream);
}

// the two-kernel backward's dk/dv: q, k, v, dout, dk, dv: (bh, s, dh)
// bf16; lse, delta: (bh, s) f32; no workspace
extern "C" int veles_flash_dkv_sm90(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int s,
                                    int dh, int causal, float scale,
                                    void* stream) {
  return dispatch<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, nullptr,
                         nullptr, bh, s, dh, causal, scale, stream);
}

extern "C" const char* veles_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
