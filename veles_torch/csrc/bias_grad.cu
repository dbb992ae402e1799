// Bias gradient of the dense/conv GD units on Hopper (sm_90a):
//
//     out[k] = sum_n err[n, k] * act'(y[n, k])        (f32 accumulate)
//
// Replaces the Pallas kernels _bias_grad_kernel (masked form) and
// _sum_rows_kernel (identity form, never reads y) of
// veles/znicz_tpu/ops/pallas_grads.py. The TPU kernel carries its sum in
// an output block revisited across a sequential row grid; a GPU grid is
// parallel, so this is two passes with no float atomics:
//
//   pass 1  blocks tile (row chunk x column tile). blockDim.x threads run
//           along K (coalesced loads), blockDim.y lanes interleave over
//           the chunk's rows. Lanes are summed in a fixed order in shared
//           memory and each block writes partials[row_block, k].
//   pass 2  one thread per column sums partials over row_block in order.
//           With a single row block, pass 1 writes out[] directly.
//
// Both passes sum in a fixed order that depends only on (N, K), so the
// result is bitwise the same from run to run. The ragged row edge (the
// last chunk) and column edge (the last tile) are masked in the kernel.
//
// Bound: bytes. The function reads err (and y in the masked form) once:
// 2*N*K*itemsize bytes (N*K*itemsize for the identity form) at
// 3.35 TB/s; the derivative costs a few f32 operations per element,
// far below the compute roofline.
//
// Plain C interface for ctypes (see veles_torch/kernels.py); the launch
// goes on the caller's stream and the function returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    partial_sums(const T* __restrict__ err, const T* __restrict__ y,
                 float* __restrict__ dst, int64_t n, int k,
                 int64_t rows_per_block) {
  __shared__ float lanes[kThreads];
  const int bx = blockDim.x;
  const int by = blockDim.y;
  const int col = blockIdx.x * bx + threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  float acc = 0.0f;
  if (col < k) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += by) {
      const int64_t i = r * k + col;
      float e = to_f32(err[i]);
      if constexpr (ACT != kIdentity) {
        e *= deriv<ACT>(to_f32(y[i]));
      }
      acc += e;
    }
  }
  lanes[threadIdx.y * bx + threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < k) {
    float s = lanes[threadIdx.x];
    for (int j = 1; j < by; ++j) {
      s += lanes[j * bx + threadIdx.x];
    }
    dst[static_cast<int64_t>(blockIdx.y) * k + col] = s;
  }
}

__global__ void sum_partials(const float* __restrict__ partials,
                             float* __restrict__ out, int row_blocks,
                             int k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) {
    return;
  }
  float s = 0.0f;
  for (int rb = 0; rb < row_blocks; ++rb) {
    s += partials[static_cast<int64_t>(rb) * k + col];
  }
  out[col] = s;
}

template <typename T>
cudaError_t launch(const void* err, const void* y, float* partials,
                   float* out, int64_t n, int k, int act, int bx,
                   int row_blocks, int64_t rows_per_block,
                   cudaStream_t stream) {
  if (bx <= 0 || kThreads % bx != 0 || row_blocks <= 0 ||
      row_blocks > 65535 || (row_blocks > 1 && partials == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const dim3 block(bx, kThreads / bx);
  const dim3 grid((k + bx - 1) / bx, row_blocks);
  float* dst = row_blocks == 1 ? out : partials;
  const T* e = static_cast<const T*>(err);
  const T* yy = static_cast<const T*>(y);
  switch (act) {
    case kIdentity:
      partial_sums<T, kIdentity>
          <<<grid, block, 0, stream>>>(e, yy, dst, n, k, rows_per_block);
      break;
    case kTanh:
      partial_sums<T, kTanh>
          <<<grid, block, 0, stream>>>(e, yy, dst, n, k, rows_per_block);
      break;
    case kSoftRelu:
      partial_sums<T, kSoftRelu>
          <<<grid, block, 0, stream>>>(e, yy, dst, n, k, rows_per_block);
      break;
    case kStrictRelu:
      partial_sums<T, kStrictRelu>
          <<<grid, block, 0, stream>>>(e, yy, dst, n, k, rows_per_block);
      break;
    case kSigmoid:
      partial_sums<T, kSigmoid>
          <<<grid, block, 0, stream>>>(e, yy, dst, n, k, rows_per_block);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || row_blocks == 1) {
    return rc;
  }
  sum_partials<<<(k + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partials, out, row_blocks, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int veles_bias_grad(const void* err, const void* y,
                               void* partials, void* out, long long n,
                               int k, int dtype, int act, int bx,
                               int row_blocks, long long rows_per_block,
                               void* stream) {
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(err, y, p, o, n, k, act, bx, row_blocks,
                           rows_per_block, s);
    case kBF16:
      return launch<__nv_bfloat16>(err, y, p, o, n, k, act, bx, row_blocks,
                                   rows_per_block, s);
    case kF16:
      return launch<__half>(err, y, p, o, n, k, act, bx, row_blocks,
                            rows_per_block, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* veles_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
