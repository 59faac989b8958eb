// Flash attention forward (causal / sliding window / softcap / GQA /
// cache offsets), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py::
// flash_attention (body _flash_kernel).  The TPU grid is (B, Hq, q
// blocks, kv blocks) with the kv axis innermost and sequential, so the
// running max, denominator and accumulator live in VMEM scratch across
// kv steps, and dead (q, kv) tiles are skipped with pl.when.  On Hopper
// grid blocks run in no order, so:
//
//   * one CTA owns one (b, h, q tile of kBQ rows) and loops over the kv
//     tiles itself; m, l and the f32 accumulator stay on chip for the
//     whole loop (m, l in shared memory, the accumulator in registers);
//   * the loop bounds come from q_offset, kv_offset, causal, window and
//     Tk, so a dead tile is never loaded (the TPU's pl.when skip), and
//     rows past Tq do no work; with at most kFewRows live rows (decode
//     has Tq = 1) a warp computes each score, its lanes splitting d;
//   * K and V tiles are staged in shared memory as f32; ragged Tq and Tk
//     are bounds-checked, nothing is padded in device memory;
//   * GQA reads KV head h / (Hq / Hkv); K and V are never repeated.
//
// What bounds it: at the prefill shapes the work is 4 * D flops per live
// (q, k) pair, far above the bytes, so the tensor cores' rate would bound
// it.  This first version is plain f32 FMA on the CUDA cores with 4 x 4
// register tiles for Q K^T (the f32 inputs of the tests and the reduced
// models must agree with the plain version to 3e-5, which bf16 tensor
// cores on P V would not give); moving Q K^T and P V onto wgmma is later
// work.  Decode (Tq = 1) is bound by the bytes of the live K/V.
//
// Numerics follow _flash_kernel: s = (q . k) * scale, then
// softcap * tanh(s / softcap), then the mask (k_pos >= 0, k_pos <= q_pos
// when causal, k_pos > q_pos - window); masked scores are -1e30 and
// their p is forced to 0; online softmax in f32; a row with no live key
// gives 0.  Built without --use_fast_math: expf and tanhf are the
// accurate ones.  All offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per kv tile
constexpr int kSThreads = 256;   // threads of the 16 x 16 grid of Q K^T
constexpr int kFewRows = 4;      // at most this many live rows: warp dots
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Per head dim: kDV float4 columns; the P V phase gives each thread one
// float4 column and kBQ / kRG rows, so the CTA has kDV * kRG threads.
template <int D>
struct Shape {
  static constexpr int kDV = D / 4;
  static constexpr int kRG = D >= 256 ? 4 : D >= 128 ? 8 : D >= 64 ? 16
                           : D >= 32 ? 32 : 64;
  static constexpr int kThreads = kDV * kRG;
  static constexpr int kRPT = kBQ / kRG;      // rows per thread in P V
  static constexpr int kLD = D + 4;           // smem row stride (floats)
  static constexpr int kSLD = kBK + 1;
  static constexpr size_t kSmem =
      sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * kLD +
                       static_cast<size_t>(kBQ) * kSLD + 3 * kBQ);
  static_assert(kThreads >= kSThreads, "Q K^T needs 256 threads");
  static_assert(kBQ % kRG == 0, "rows must split evenly");
};

// Stage rows [row0, row0 + nrows) of a (rows, D) slab as f32, zeros past
// `valid` rows.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t row0,
                                      int64_t valid, int nrows, int tid) {
  constexpr int kDV = D / 4;
  constexpr int kLD = D + 4;
  for (int i = tid; i < nrows * kDV; i += NT) {
    const int r = i / kDV;
    const int c = (i - r * kDV) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < valid) v = load4(src + (row0 + r) * D + c);
    store4(dst + r * kLD + c, v);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
                           int causal, int64_t window, float softcap,
                           int64_t q_offset, int64_t kv_offset, float scale) {
  using S = Shape<D>;
  constexpr int NT = S::kThreads;
  constexpr int kLD = S::kLD;
  constexpr int kSLD = S::kSLD;
  extern __shared__ float smem[];
  float* qs = smem;                        // (kBQ, kLD)
  float* ks = qs + kBQ * kLD;              // (kBK, kLD)
  float* vs = ks + kBK * kLD;              // (kBK, kLD)
  float* ss = vs + kBK * kLD;              // (kBQ, kSLD): scores, then p
  float* m_s = ss + kBQ * kSLD;            // running max
  float* l_s = m_s + kBQ;                  // running denominator
  float* a_s = l_s + kBQ;                  // this tile's rescale factor

  const int tid = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBQ;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t hk = h / (hq / hkv);
  const int rows = static_cast<int>(tq - q0 < kBQ ? tq - q0 : kBQ);

  const T* qb = q + ((b * hq + h) * tq) * D;
  const T* kb = k + ((b * hkv + hk) * tk) * D;
  const T* vb = v + ((b * hkv + hk) * tk) * D;
  T* ob = out + ((b * hq + h) * tq) * D;

  // Live key indices j (k_pos = kv_offset + j) for the tile's q rows.
  const int64_t qlo = q_offset + q0;
  const int64_t qhi = qlo + rows - 1;
  int64_t j_lo = -kv_offset > 0 ? -kv_offset : 0;
  if (window >= 0) {
    const int64_t w_lo = qlo - window + 1 - kv_offset;
    if (w_lo > j_lo) j_lo = w_lo;
  }
  int64_t j_hi = tk - 1;
  if (causal && qhi - kv_offset < j_hi) j_hi = qhi - kv_offset;

  stage<T, D, NT>(qs, qb, q0, tq, kBQ, tid);
  for (int r = tid; r < kBQ; r += NT) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // P V ownership: float4 column pc, rows pr0 + kRG * i.
  const int pc = (tid % S::kDV) * 4;
  const int pr0 = tid / S::kDV;
  float4 acc[S::kRPT];
#pragma unroll
  for (int i = 0; i < S::kRPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // Q K^T ownership (threads < 256): rows sy + 16 i, keys sx + 16 j.
  const int sx = tid % 16;
  const int sy = tid / 16;
  constexpr int kSR = kBQ / 16;
  constexpr int kSC = kBK / 16;

  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int kWarps = NT / 32;

  if (j_lo <= j_hi) {
    for (int64_t t0 = (j_lo / kBK) * kBK; t0 <= j_hi; t0 += kBK) {
      __syncthreads();   // the previous tile's readers are done
      stage<T, D, NT>(ks, kb, t0, tk, kBK, tid);
      stage<T, D, NT>(vs, vb, t0, tk, kBK, tid);
      __syncthreads();

      // s = (q . k) * scale, softcapped.  Few rows (decode): a warp per
      // (row, key) pair, lanes split d; else 4 x 4 register tiles.
      if (rows <= kFewRows) {
        for (int pair = warp; pair < rows * kBK; pair += kWarps) {
          const int r = pair / kBK;
          const int c = pair - r * kBK;
          float dot = 0.f;
          for (int d = lane * 4; d < D; d += 128) {
            const float4 q4 = load4(qs + r * kLD + d);
            const float4 k4 = load4(ks + c * kLD + d);
            dot = fmaf(q4.x, k4.x, dot);
            dot = fmaf(q4.y, k4.y, dot);
            dot = fmaf(q4.z, k4.z, dot);
            dot = fmaf(q4.w, k4.w, dot);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (lane == 0) {
            float s = dot * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            ss[r * kSLD + c] = s;
          }
        }
      } else if (tid < kSThreads && sy < rows) {
        float sacc[kSR][kSC];
#pragma unroll
        for (int i = 0; i < kSR; ++i)
#pragma unroll
          for (int j = 0; j < kSC; ++j) sacc[i][j] = 0.f;
        for (int d = 0; d < D; d += 4) {
          float4 kv4[kSC];
#pragma unroll
          for (int j = 0; j < kSC; ++j)
            kv4[j] = load4(ks + (sx + 16 * j) * kLD + d);
#pragma unroll
          for (int i = 0; i < kSR; ++i) {
            if (sy + 16 * i >= rows) break;
            const float4 q4 = load4(qs + (sy + 16 * i) * kLD + d);
#pragma unroll
            for (int j = 0; j < kSC; ++j) {
              sacc[i][j] = fmaf(q4.x, kv4[j].x, sacc[i][j]);
              sacc[i][j] = fmaf(q4.y, kv4[j].y, sacc[i][j]);
              sacc[i][j] = fmaf(q4.z, kv4[j].z, sacc[i][j]);
              sacc[i][j] = fmaf(q4.w, kv4[j].w, sacc[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kSR; ++i) {
          if (sy + 16 * i >= rows) break;
#pragma unroll
          for (int j = 0; j < kSC; ++j) {
            float s = sacc[i][j] * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            ss[(sy + 16 * i) * kSLD + sx + 16 * j] = s;
          }
        }
      }
      __syncthreads();

      // mask + online softmax, one warp per row
      for (int r = warp; r < rows; r += kWarps) {
        const int64_t q_pos = qlo + r;
        float sv[kBK / 32];
        bool live[kBK / 32];
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kBK / 32; ++u) {
          const int c = lane + 32 * u;
          const int64_t j = t0 + c;
          const int64_t k_pos = kv_offset + j;
          bool ok = j < tk && k_pos >= 0;
          if (causal) ok = ok && k_pos <= q_pos;
          if (window >= 0) ok = ok && k_pos > q_pos - window;
          live[u] = ok;
          sv[u] = ok ? ss[r * kSLD + c] : kNegInf;
          mx = fmaxf(mx, sv[u]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kBK / 32; ++u) {
          const float p = live[u] ? expf(sv[u] - m_new) : 0.f;
          ss[r * kSLD + lane + 32 * u] = p;
          sum += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[r] = alpha;
          l_s[r] = alpha * l_s[r] + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p V
#pragma unroll
      for (int i = 0; i < S::kRPT; ++i) {
        const int r = pr0 + S::kRG * i;
        if (r >= rows) break;
        const float alpha = a_s[r];
        float4 a = acc[i];
        a.x *= alpha;
        a.y *= alpha;
        a.z *= alpha;
        a.w *= alpha;
        const float* prow = ss + r * kSLD;
#pragma unroll 8
        for (int c = 0; c < kBK; ++c) {
          const float p = prow[c];
          const float4 v4 = load4(vs + c * kLD + pc);
          a.x = fmaf(p, v4.x, a.x);
          a.y = fmaf(p, v4.y, a.y);
          a.z = fmaf(p, v4.z, a.z);
          a.w = fmaf(p, v4.w, a.w);
        }
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < S::kRPT; ++i) {
    const int r = pr0 + S::kRG * i;
    if (r >= rows) break;
    const float l = l_s[r];
    const float inv = 1.f / (l > 0.f ? l : 1.f);
    float4 a = acc[i];
    a.x *= inv;
    a.y *= inv;
    a.z *= inv;
    a.w *= inv;
    store4(ob + (q0 + r) * D + pc, a);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int64_t b, int64_t hq, int64_t hkv,
                         int64_t tq, int64_t tk, int causal, int64_t window,
                         float softcap, int64_t q_offset, int64_t kv_offset,
                         float scale, cudaStream_t stream) {
  using S = Shape<D>;
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((tq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, tq, tk,
      causal, window, softcap, q_offset, kv_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       void* out, int64_t b, int64_t hq, int64_t hkv,
                       int64_t tq, int64_t tk, int64_t d, int causal,
                       int64_t window, float softcap, int64_t q_offset,
                       int64_t kv_offset, float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                               \
  case DIM:                                                                 \
    return launch_typed<T, DIM>(q, k, v, out, b, hq, hkv, tq, tk, causal,   \
                                window, softcap, q_offset, kv_offset, scale, \
                                stream);
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

bool flash_attention_head_dim_ok(int64_t d) {
  return d == 16 || d == 32 || d == 64 || d == 80 || d == 128 || d == 256;
}

cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int64_t b,
                                   int64_t hq, int64_t hkv, int64_t tq,
                                   int64_t tk, int64_t d, int causal,
                                   int64_t window, float softcap,
                                   int64_t q_offset, int64_t kv_offset,
                                   float scale, int dtype,
                                   cudaStream_t stream) {
  if (b == 0 || hq == 0 || tq == 0) return cudaSuccess;
  if (dtype == kBF16) {
    return launch_dim<__nv_bfloat16>(q, k, v, out, b, hq, hkv, tq, tk, d,
                                     causal, window, softcap, q_offset,
                                     kv_offset, scale, stream);
  }
  return launch_dim<float>(q, k, v, out, b, hq, hkv, tq, tk, d, causal,
                           window, softcap, q_offset, kv_offset, scale,
                           stream);
}

}  // namespace repro_torch
