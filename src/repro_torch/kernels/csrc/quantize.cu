// Per-chunk int8 symmetric quantize / dequantize, for sm_90a.
//
// Replaces the Pallas TPU kernels repro/kernels/quantize.py::
// chunk_quantize (body _quant_kernel) and chunk_dequantize (body
// _dequant_kernel).  The Pallas grid is one program per row; on the
// federated train step the rows are the torrent blocks, (8, 430M) at
// full width, so one block per row would give 8 CTAs of 1.7 GB each.
// Both passes are memory-bound (a compare, a divide and a round per
// 5 bytes), so the design spreads each row over a (tiles, rows) grid:
//
//   quantize  1. amax_partial: every (row, tile) block folds |x| over a
//                grid-stride slice of its row, reduced with warp
//                shuffles, into partial[row, tile];
//             2. row_scale: one block per row folds the partials into
//                scale = amax > 0 ? amax / 127 : 1;
//             3. quantize: q = clip(rint(x / scale), -127, 127).
//   dequantize   out = float(q) * scale[row], in the output dtype.
//
// Exactness: the codes must equal the reference's bit for bit.  This
// file is compiled without --use_fast_math, so `/` is the IEEE
// round-to-nearest divide (never __fdividef, never x * (1 / scale)),
// and rintf rounds half to even as jnp.round and torch.round do.  The
// max propagates NaN like jnp.max, so a row holding NaN gets scale 1
// as in the reference; such a row is masked out downstream and the
// kernel only has to finish without fault.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 8192;
constexpr int64_t kMaxRowsPerGrid = 65535;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Max over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_max(float v, float* warp_max) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // warp_max may be reused by the caller's next row
  return v;
}

__global__ void __launch_bounds__(kThreads)
    amax_partial_kernel(const float* __restrict__ x,
                        float* __restrict__ partial, int64_t n, int64_t e,
                        int64_t tiles) {
  __shared__ float warp_max[kWarps];
  const int64_t stride = tiles * kThreads;
  for (int64_t row = blockIdx.y; row < n; row += gridDim.y) {
    const float* xr = x + row * e;
    float m = 0.f;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         j < e; j += stride)
      m = nan_max(m, fabsf(xr[j]));
    m = block_max(m, warp_max);
    if (threadIdx.x == 0) partial[row * tiles + blockIdx.x] = m;
  }
}

__global__ void __launch_bounds__(kThreads)
    row_scale_kernel(const float* __restrict__ partial,
                     float* __restrict__ scale, int64_t n, int64_t tiles) {
  __shared__ float warp_max[kWarps];
  for (int64_t row = blockIdx.x; row < n; row += gridDim.x) {
    float m = 0.f;
    for (int64_t t = threadIdx.x; t < tiles; t += kThreads)
      m = nan_max(m, partial[row * tiles + t]);
    m = block_max(m, warp_max);
    if (threadIdx.x == 0) scale[row] = m > 0.f ? m / 127.f : 1.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x,
                    const float* __restrict__ scale, int8_t* __restrict__ q,
                    int64_t n, int64_t e) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t row = blockIdx.y; row < n; row += gridDim.y) {
    const float s = scale[row];
    const int64_t base = row * e;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         j < e; j += stride) {
      const float r = rintf(x[base + j] / s);
      q[base + j] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int64_t n, int64_t e) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t row = blockIdx.y; row < n; row += gridDim.y) {
    const float s = scale[row];
    const int64_t base = row * e;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         j < e; j += stride)
      store(out + base + j, static_cast<float>(q[base + j]) * s);
  }
}

int64_t grid_rows(int64_t n) {
  return n < kMaxRowsPerGrid ? n : kMaxRowsPerGrid;
}

dim3 row_grid(int64_t n, int64_t e) {
  return dim3(static_cast<unsigned>(chunk_tiles(n, e)),
              static_cast<unsigned>(grid_rows(n)));
}

}  // namespace

int64_t chunk_tiles(int64_t n, int64_t e) {
  // Enough blocks for the card, at most one per kThreads elements of a
  // row, and (grid rows) x tiles near kMaxBlocks.
  const int64_t want = (e + kThreads - 1) / kThreads;
  const int64_t cap = kMaxBlocks / (n > 0 ? grid_rows(n) : 1);
  const int64_t tiles = want < cap ? want : cap;
  return tiles > 1 ? tiles : 1;
}

void launch_chunk_quantize(const float* x, int8_t* q, float* scale,
                           float* partial, int64_t n, int64_t e,
                           cudaStream_t stream) {
  if (n == 0 || e == 0) return;
  const dim3 grid = row_grid(n, e);
  const int64_t tiles = grid.x;
  amax_partial_kernel<<<grid, kThreads, 0, stream>>>(x, partial, n, e, tiles);
  row_scale_kernel<<<grid.y, kThreads, 0, stream>>>(partial, scale, n, tiles);
  quantize_kernel<<<grid, kThreads, 0, stream>>>(x, scale, q, n, e);
}

void launch_chunk_dequantize(const int8_t* q, const float* scale, void* out,
                             int64_t n, int64_t e, int dtype,
                             cudaStream_t stream) {
  if (n == 0 || e == 0) return;
  const dim3 grid = row_grid(n, e);
  if (dtype == kBF16) {
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        q, scale, static_cast<__nv_bfloat16*>(out), n, e);
  } else {
    dequantize_kernel<float><<<grid, kThreads, 0, stream>>>(
        q, scale, static_cast<float*>(out), n, e);
  }
}

}  // namespace repro_torch
