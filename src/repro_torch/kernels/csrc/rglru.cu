// RG-LRU gated diagonal linear recurrence, for sm_90a.
//
//     h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * (gx_t * x_t)
//
// Replaces the Pallas TPU kernel repro/kernels/rglru.py::rglru_scan
// (body _rglru_kernel), whose grid runs time innermost so the (block_d,)
// carry persists in VMEM scratch across time blocks.  On Hopper the
// carry lives in a register: one thread owns one (b, d) channel and
// walks t = 0 .. T-1 itself; a warp reads 32 neighbouring channels of
// each time row, so every load and store is coalesced.  Ragged B, T and
// D are bounds-checked (the TPU pads a with 1 instead).
//
// What bounds it: 3 input values read and 1 written per (b, t, d), 6
// flops each, so the bytes over the HBM rate.  With B * D threads and a
// dependent chain of T steps, the loads of kUnroll steps are issued
// before the chain consumes them, to keep enough bytes in flight.  A
// time-parallel (chunked) scan, for small B * D, is later work.
//
// Arithmetic in f32, built without --use_fast_math (sqrtf is exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

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
    rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                      const T* __restrict__ gx, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ h_last,
                      int64_t t_len, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (j >= d) return;
  float h = h0 == nullptr ? 0.f : h0[b * d + j];
  const int64_t base = b * t_len * d + j;
  int64_t t = 0;
  for (; t + kUnroll <= t_len; t += kUnroll) {
    float xs[kUnroll], as[kUnroll], gs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t o = base + (t + u) * d;
      xs[u] = to_f32(x[o]);
      as[u] = to_f32(a[o]);
      gs[u] = to_f32(gx[o]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float inp = sqrtf(fmaxf(1.f - as[u] * as[u], 0.f)) *
                        (gs[u] * xs[u]);
      h = as[u] * h + inp;
      y[base + (t + u) * d] = from_f32<T>(h);
    }
  }
  for (; t < t_len; ++t) {
    const int64_t o = base + t * d;
    const float av = to_f32(a[o]);
    const float inp = sqrtf(fmaxf(1.f - av * av, 0.f)) *
                      (to_f32(gx[o]) * to_f32(x[o]));
    h = av * h + inp;
    y[o] = from_f32<T>(h);
  }
  h_last[b * d + j] = h;
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* a, const void* gx,
                         const float* h0, void* y, float* h_last, int64_t b,
                         int64_t t, int64_t d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(gx), h0, static_cast<T*>(y), h_last, t, d);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_rglru_scan(const void* x, const void* a, const void* gx,
                              const float* h0, void* y, float* h_last,
                              int64_t b, int64_t t, int64_t d, int dtype,
                              cudaStream_t stream) {
  if (b == 0 || d == 0) return cudaSuccess;
  if (dtype == kBF16) {
    return launch_typed<__nv_bfloat16>(x, a, gx, h0, y, h_last, b, t, d,
                                       stream);
  }
  return launch_typed<float>(x, a, gx, h0, y, h_last, b, t, d, stream);
}

}  // namespace repro_torch
