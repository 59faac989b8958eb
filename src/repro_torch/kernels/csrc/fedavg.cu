// Masked FedAvg reduction over stacked client updates, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/fedavg.py::fedavg_reduce
// (body _fedavg_kernel), which issues one (1, n) x (n, block_d) MXU
// matvec per D block.  On Hopper the work is a memory-bound stream:
// n * d values read once, d written once, 2 flops per value, far below
// the ~20 flops/byte at which f32 arithmetic would bound it.  So the
// design is the plainest coalesced pass: each thread owns one column j
// at a time (grid-stride over d), loops over the n rows with an f32
// accumulator, and a warp reads 32 neighbouring values of each row.
// No tensor core, no shared memory, no padding of n or d.
//
// A row whose normalised weight is not positive is skipped, never
// multiplied: a client masked because its update diverged carries
// NaN/inf, and 0 * NaN would poison the aggregate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fedavg_reduce_kernel(const T* __restrict__ updates,
                         const float* __restrict__ wn, T* __restrict__ out,
                         int64_t n, int64_t d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < d; j += stride) {
    float acc = 0.f;
#pragma unroll 4
    for (int64_t u = 0; u < n; ++u) {
      const float w = wn[u];
      if (w > 0.f) acc += w * to_f32(updates[u * d + j]);
    }
    out[j] = from_f32<T>(acc);
  }
}

}  // namespace

void launch_fedavg_reduce(const void* updates, const float* wn, void* out,
                          int64_t n, int64_t d, int dtype,
                          cudaStream_t stream) {
  if (d == 0) return;
  const int64_t want = (d + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
  if (dtype == kBF16) {
    fedavg_reduce_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(updates), wn,
        static_cast<__nv_bfloat16*>(out), n, d);
  } else {
    fedavg_reduce_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(updates), wn, static_cast<float*>(out), n,
        d);
  }
}

}  // namespace repro_torch
