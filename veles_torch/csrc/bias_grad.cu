// Bias gradient of the dense/conv GD units on Hopper (sm_90a):
//
//     out[k] = sum_n err[n, k] * act'(y[n, k])        (f32 accumulate)
//
// Replaces the Pallas kernels _bias_grad_kernel (masked form) and
// _sum_rows_kernel (identity form, never reads y) of
// veles/znicz_tpu/ops/pallas_grads.py. The TPU kernel carries its sum in
// an output block revisited across a sequential row grid. A GPU grid is
// parallel, so the rows are split over CTAs and the CTAs' sums meet in
// the same launch:
//
//   grid    (column tiles, row blocks). A CTA has TX x TY threads: TX
//           along K, each thread owning VEC adjacent columns, and TY lanes
//           interleaved over the rows of the CTA's row block. TX is one
//           warp (32) or, for narrow K, all of K, so a CTA's loads of one
//           step cover whole rows back to back.
//   loads   16 bytes a thread (8 bf16/f16 or 4 f32 columns) where the row
//           pitch and the base pointers are 16-byte aligned (VEC > 1);
//           otherwise one element a thread, the same code at VEC = 1 (the
//           scalar path: MNIST's K = 10 and 100 in bf16). Each lane issues
//           kUnroll independent loads (twice that in the masked form)
//           before its first add: 16 KB in flight per CTA of 256 threads
//           in the identity form, several CTAs per SM.
//   sum     each lane adds its rows in order; the CTA adds its lanes in
//           order through shared memory. With one row block the CTA
//           writes out[]; with several it writes its f32 partial row and
//           takes a ticket (an integer atomicAdd per column tile). The
//           CTA that takes the last ticket adds the tile's partials, lane
//           ty over row blocks ty, ty + TY, ..., then the lanes in order,
//           writes out[] and sets the ticket back to 0, so the next
//           launch needs no memset (and a CUDA graph can replay it). The
//           order of every sum depends only on the launch plan, that is
//           on (N, K, dtype, alignment), never on which CTA arrives when:
//           the result is bitwise the same from run to run, with no float
//           atomics.
//
// Bound: bytes. The function reads err (and y in the masked form) once:
// N*K*itemsize bytes per input at 3.35 TB/s; the derivative costs a few
// f32 operations per element, far below the compute roofline. What holds
// a memory-bound kernel back is bytes in flight (about 20 KB per SM to
// cover the latency at 3.35 TB/s), hence the wide, unrolled loads and a
// grid of about four CTAs per SM at every K (ops/bias_grad.py plan()).
//
// Plain C interface for ctypes (see veles_torch/kernels.py); the launch
// goes on the caller's stream, allocates nothing (partials and tickets
// come from the caller) and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
// loads each lane issues before it adds (ops/bias_grad.py UNROLL)
constexpr int kUnroll = 4;
// most row blocks a plan may have (ops/bias_grad.py MAX_ROW_BLOCKS)
constexpr int kMaxRowBlocks = 264;

// activation codes shared with veles_torch/znicz/ops/bias_grad.py
enum Act : int {
  kIdentity = 0,
  kTanh = 1,
  kSoftRelu = 2,
  kStrictRelu = 3,
  kSigmoid = 4,
};

// dtype codes shared with veles_torch/znicz/ops/bias_grad.py
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// derivative by output, the formulas of ops/activations.py
constexpr float kTanhAB = static_cast<float>(1.7159 * (2.0 / 3.0));
constexpr float kTanhBoverA = static_cast<float>((2.0 / 3.0) / 1.7159);

template <int ACT>
__device__ __forceinline__ float deriv(float y) {
  if constexpr (ACT == kTanh) {
    return kTanhAB - kTanhBoverA * y * y;
  } else if constexpr (ACT == kSoftRelu) {
    return 1.0f - expf(-y);
  } else if constexpr (ACT == kStrictRelu) {
    return y > 0.0f ? 1.0f : 0.0f;
  } else if constexpr (ACT == kSigmoid) {
    return y * (1.0f - y);
  } else {
    return 1.0f;
  }
}

// VEC adjacent elements of one row: one 16-byte load, or one element
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(T) * VEC == 16) {
    // read once: stream past L1
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, sizeof(r));
  } else {
    static_assert(VEC == 1, "a pack is 16 bytes or one element");
    r.v[0] = p[0];
  }
  return r;
}

// VEC f32 values at p (16-byte aligned when VEC % 4 == 0), from L2: the
// partials other CTAs wrote
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&dst)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(p + i));
      dst[i] = f.x;
      dst[i + 1] = f.y;
      dst[i + 2] = f.z;
      dst[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dst[i] = __ldcg(p + i);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&src)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      p[i] = src[i];
    }
  }
}

// The CTA's lanes added in order (lane 0 first) into `sum` of the lane-0
// threads; `lanes` holds every thread's VEC values.
template <int VEC>
__device__ __forceinline__ void add_lanes(float* lanes, const float (&acc)[VEC],
                                          int tx, int ty, int tx_n, int ty_n,
                                          float (&sum)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    lanes[threadIdx.x * VEC + v] = acc[v];
  }
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      sum[v] = acc[v];
    }
    for (int j = 1; j < ty_n; ++j) {
      const float* other = lanes + (j * tx_n + tx) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        sum[v] += other[v];
      }
    }
  }
}

template <typename T, int ACT, int VEC>
__global__ void __launch_bounds__(kThreads)
    bias_grad_kernel(const T* __restrict__ err, const T* __restrict__ y,
                     float* __restrict__ partials, float* __restrict__ out,
                     unsigned int* __restrict__ tickets, int64_t n, int k,
                     int tx_n, int ty_n, int64_t rows_per_block) {
  __shared__ float lanes[kThreads * VEC];
  __shared__ bool last;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * tx_n + tx) * VEC;
  // VEC divides K on the vector path, so a pack is all in or all out
  const bool active = col < k;
  const int row_blocks = gridDim.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  const int64_t step = static_cast<int64_t>(ty_n) * kUnroll;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    acc[v] = 0.0f;
  }
  if (active) {
    for (int64_t base = r0 + ty; base < r1; base += step) {
      Pack<T, VEC> e[kUnroll];
      Pack<T, VEC> d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = base + static_cast<int64_t>(u) * ty_n;
        if (r < r1) {
          e[u] = load<T, VEC>(err + r * k + col);
          if constexpr (ACT != kIdentity) {
            d[u] = load<T, VEC>(y + r * k + col);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + static_cast<int64_t>(u) * ty_n < r1) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float x = to_f32(e[u].v[v]);
            if constexpr (ACT != kIdentity) {
              x *= deriv<ACT>(to_f32(d[u].v[v]));
            }
            acc[v] += x;
          }
        }
      }
    }
  }

  float sum[VEC];
  add_lanes<VEC>(lanes, acc, tx, ty, tx_n, ty_n, sum);
  if (row_blocks == 1) {
    if (ty == 0 && active) {
      store_f32<VEC>(out + col, sum);
    }
    return;
  }
  if (ty == 0 && active) {
    store_f32<VEC>(partials + static_cast<int64_t>(blockIdx.y) * k + col, sum);
  }
  // publish the partial, then take a ticket: the last CTA of the column
  // tile sees every other CTA's partial
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + blockIdx.x, 1u) ==
           static_cast<unsigned int>(row_blocks - 1);
  }
  __syncthreads();
  if (!last) {
    return;
  }
  __threadfence();
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    acc[v] = 0.0f;
  }
  if (active) {
    for (int rb0 = ty; rb0 < row_blocks; rb0 += ty_n * kUnroll) {
      float p[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rb = rb0 + u * ty_n;
        if (rb < row_blocks) {
          load_f32<VEC>(partials + static_cast<int64_t>(rb) * k + col, p[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (rb0 + u * ty_n < row_blocks) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[v] += p[u][v];
          }
        }
      }
    }
  }
  // (the barriers around the ticket ended every read of the first sum)
  add_lanes<VEC>(lanes, acc, tx, ty, tx_n, ty_n, sum);
  if (ty == 0 && active) {
    store_f32<VEC>(out + col, sum);
  }
  if (threadIdx.x == 0) {
    tickets[blockIdx.x] = 0;  // ready for the next launch
  }
}

struct Launch {
  const void* err;
  const void* y;
  float* partials;
  float* out;
  unsigned int* tickets;
  int64_t n;
  int k;
  int tx;
  int ty;
  int row_blocks;
  int64_t rows_per_block;
  cudaStream_t stream;
};

template <typename T, int VEC, int ACT>
void launch_act(const Launch& a) {
  const int64_t units = a.k / VEC;
  const dim3 grid(static_cast<unsigned int>((units + a.tx - 1) / a.tx),
                  a.row_blocks);
  bias_grad_kernel<T, ACT, VEC><<<grid, a.tx * a.ty, 0, a.stream>>>(
      static_cast<const T*>(a.err), static_cast<const T*>(a.y), a.partials,
      a.out, a.tickets, a.n, a.k, a.tx, a.ty, a.rows_per_block);
}

template <typename T, int VEC>
cudaError_t launch_vec(const Launch& a, int act) {
  switch (act) {
    case kIdentity:
      launch_act<T, VEC, kIdentity>(a);
      break;
    case kTanh:
      launch_act<T, VEC, kTanh>(a);
      break;
    case kSoftRelu:
      launch_act<T, VEC, kSoftRelu>(a);
      break;
    case kStrictRelu:
      launch_act<T, VEC, kStrictRelu>(a);
      break;
    case kSigmoid:
      launch_act<T, VEC, kSigmoid>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const Launch& a, int act, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.n <= 0 || a.k <= 0 || a.tx <= 0 || a.ty <= 0 ||
      a.tx * a.ty > kThreads || a.row_blocks <= 0 ||
      a.row_blocks > kMaxRowBlocks || a.rows_per_block <= 0 ||
      a.rows_per_block * a.row_blocks < a.n ||
      (a.row_blocks > 1 && (a.partials == nullptr || a.tickets == nullptr)) ||
      (act != kIdentity && a.y == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (vec == kVec) {
    // the vector path reads whole 16-byte packs: rows and bases aligned
    if (a.k % kVec != 0 || !aligned16(a.err) ||
        (act != kIdentity && !aligned16(a.y)) || !aligned16(a.out) ||
        (a.partials != nullptr && !aligned16(a.partials))) {
      return cudaErrorInvalidValue;
    }
    return launch_vec<T, kVec>(a, act);
  }
  if (vec == 1) {
    return launch_vec<T, 1>(a, act);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int veles_bias_grad(const void* err, const void* y,
                               void* partials, void* out, void* tickets,
                               long long n, int k, int dtype, int act,
                               int vec, int tx, int ty, int row_blocks,
                               long long rows_per_block, void* stream) {
  const Launch a{err,
                 y,
                 static_cast<float*>(partials),
                 static_cast<float*>(out),
                 static_cast<unsigned int*>(tickets),
                 n,
                 k,
                 tx,
                 ty,
                 row_blocks,
                 rows_per_block,
                 static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32:
      return launch<float>(a, act, vec);
    case kBF16:
      return launch<__nv_bfloat16>(a, act, vec);
    case kF16:
      return launch<__half>(a, act, vec);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* veles_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
