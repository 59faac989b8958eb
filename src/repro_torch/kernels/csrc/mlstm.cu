// Chunkwise-parallel mLSTM from a zero state, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm.py::mlstm_chunkwise
// (body _mlstm_kernel).  Per (b, h) and chunk of L steps, from the state
// (C0, n0, m0) the previous chunk left (A = cumsum f, gia = i - A):
//
//     g = cummax(gia),  M_j = max(m0, g_j),  c_j = exp(m0 - M_j)
//     P[j, s] = exp(gia_s - M_j) (q_j . k_s)            for s <= j
//     h_j = (c_j (C0 q_j) + sum_s P[j, s] v_s) / max(|c_j (n0.q_j) + sum_s P[j, s]|, 1)
//     C = e^{m0-MxL} C0 + sum_s wL_s v_s k_s^T,  n likewise,  m = A_{L-1} + MxL
//
// with MxL = M_{L-1} and wL_s = exp(gia_s - MxL).  The denominator comes
// from the scores: n_j . q_j = c_j (n0 . q_j) + sum_s W[j, s] (q_j . k_s),
// so no W k product is formed.
//
// The TPU kernel runs the chunk axis innermost in its grid and keeps the
// (dh, dh) f32 C in VMEM across it.  At dh = 512 that is 1 MiB, more than
// one SM's shared memory, so here C is split by value rows (its first
// index): one CTA owns kRows rows of C for one (b, h) and walks the
// chunks in order, its rows of C resident in shared memory.  A row block
// needs all of q and k but only its columns of v and of h: per chunk it
// streams q and k through shared memory in kSlice-wide dh slices, and in
// the same pass accumulates the (L, L) scores, C0 q for its rows and
// n0 . q, then updates its slice of C and n (the weights wL depend on
// the gates only, which come first).  Every CTA of a (b, h) keeps the
// whole n and reduces the chunk's gates itself, which is cheap.  It also
// computes the chunk's (L, L) scores itself, which is not: at dh = 512
// the 16 row blocks of a (b, h) each compute them again, about two
// thirds of the kernel's work (the first thing a faster version shares,
// through a cluster or a separate pass).
//
// What bounds it: per (b, h, chunk) the function needs 4 L dh^2 +
// 2 dh L (L + 1) flops (C0 q, the C update, and the causal triangle of
// the scores and of P v) against (q, k, v, h) L dh values moved, so the
// f32 operations, not the bytes.  This first version is f32 FMA on the CUDA cores; the
// tensor cores (TF32 wgmma) are later work.  Arithmetic is f32, built
// without --use_fast_math.  -1e30 stands for -inf as in the reference,
// so m0 - M never meets inf - inf.
//
// q, k, v, h are read and written through (b, h, t) element strides with
// a unit dh stride, so the layer's (B, T, H, dh) tensors need no
// transposes; i and f through their own (b, h, t) strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kRows = 32;            // value rows of C per CTA
constexpr int kSlice = 32;           // dh columns per streamed slice
constexpr int kSliceStride = kSlice + 1;
constexpr int kTile = 8;             // (L, L) tile rows/cols per thread
constexpr float kNegBig = -1e30f;
// a block's shared-memory limit on sm_90, less room for the static part
constexpr int64_t kMaxDynamicSmem = 232448 - 1024;

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

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory floats for (dh, chunk): C rows (row stride dhp + 1, the
// columns padded to whole slices), n, P (row stride L + 1), the v block,
// the q and k slices and seven gate vectors.
int64_t smem_floats(int64_t dh, int64_t chunk) {
  const int64_t dhp = round_up(static_cast<int>(dh), kSlice);
  return kRows * (dhp + 1) + dhp + chunk * (chunk + 1) + chunk * kRows +
         2 * chunk * kSliceStride + 7 * chunk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ ig,
                           const float* __restrict__ fg, T* __restrict__ h,
                           float* __restrict__ c_out,
                           float* __restrict__ n_out,
                           float* __restrict__ m_out, int64_t t_len,
                           int dh, int chunk, int64_t sb, int64_t sh,
                           int64_t st, int64_t gb, int64_t gh, int64_t gt) {
  extern __shared__ float smem[];
  const int L = chunk;
  const int dhp = round_up(dh, kSlice);       // slice-padded columns
  const int cst = dhp + 1;                    // C row stride
  const int pst = L + 1;                      // P row stride
  float* Cs = smem;                           // kRows x cst
  float* ns = Cs + kRows * cst;               // dhp
  float* Ps = ns + dhp;                       // L x pst
  float* vs = Ps + L * pst;                   // L x kRows
  float* qs = vs + L * kRows;                 // L x kSliceStride
  float* ks = qs + L * kSliceStride;          // L x kSliceStride
  float* gi = ks + L * kSliceStride;          // i, then gia
  float* gf = gi + L;                         // f
  float* gM = gf + L;                         // M_j
  float* gc = gM + L;                         // c_j = exp(m0 - M_j)
  float* gw = gc + L;                         // wL_s
  float* qn = gw + L;                         // n0 . q_j
  float* rs = qn + L;                         // sum_s P[j, s]
  __shared__ float s_m, s_decay;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, dh - r0);
  const int64_t base = b * sb + hh * sh;
  const int64_t gbase = b * gb + hh * gh;

  for (int e = tid; e < kRows * cst; e += kThreads) Cs[e] = 0.f;
  for (int e = tid; e < dhp; e += kThreads) ns[e] = 0.f;
  if (tid == 0) s_m = kNegBig;

  const int64_t n_chunks = t_len / L;
  for (int64_t ci = 0; ci < n_chunks; ++ci) {
    const int64_t t0 = ci * L;
    // the chunk's gates and this block's columns of v
    for (int s = tid; s < L; s += kThreads) {
      gi[s] = ig[gbase + (t0 + s) * gt];
      gf[s] = fg[gbase + (t0 + s) * gt];
    }
    for (int e = tid; e < L * kRows; e += kThreads) {
      const int s = e / kRows;
      const int r = e - s * kRows;
      vs[e] = r < rows ? to_f32(v[base + (t0 + s) * st + r0 + r]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      // cumsum, cummax and the stabiliser, in order, as the reference
      const float m0 = s_m;
      float a = 0.f;
      float g = kNegBig;
      for (int s = 0; s < L; ++s) {
        a += gf[s];
        const float gia = gi[s] - a;
        g = s == 0 ? gia : fmaxf(g, gia);
        gi[s] = gia;
        const float M = fmaxf(m0, g);
        gM[s] = M;
        gc[s] = expf(m0 - M);
      }
      const float mxl = fmaxf(m0, g);
      for (int s = 0; s < L; ++s) gw[s] = expf(gi[s] - mxl);
      s_decay = expf(m0 - mxl);
      s_m = a + mxl;
    }
    __syncthreads();
    const float decay = s_decay;

    float sacc[kTile][kTile];                 // scores (ty+16a, tx+16b)
    float hacc[kTile][2];                     // C0 q (ty+16a, tx+16c)
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
#pragma unroll
      for (int c = 0; c < kTile; ++c) sacc[a][c] = 0.f;
      hacc[a][0] = hacc[a][1] = 0.f;
    }
    float qn_acc = 0.f;                       // thread tid < L: row tid

    for (int d0 = 0; d0 < dhp; d0 += kSlice) {
      for (int e = tid; e < L * kSlice; e += kThreads) {
        const int s = e / kSlice;
        const int dd = e - s * kSlice;
        const int d = d0 + dd;
        const int64_t o = base + (t0 + s) * st + d;
        qs[s * kSliceStride + dd] = d < dh ? to_f32(q[o]) : 0.f;
        ks[s * kSliceStride + dd] = d < dh ? to_f32(k[o]) : 0.f;
      }
      __syncthreads();
      // scores, C0 q for this block's rows, n0 . q; all read the old state
#pragma unroll 4
      for (int dd = 0; dd < kSlice; ++dd) {
        float qv[kTile], kv[kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          const int j = ty + 16 * a;
          qv[a] = j < L ? qs[j * kSliceStride + dd] : 0.f;
          const int s = tx + 16 * a;
          kv[a] = s < L ? ks[s * kSliceStride + dd] : 0.f;
        }
        const float c0 = Cs[tx * cst + d0 + dd];
        const float c1 = Cs[(tx + 16) * cst + d0 + dd];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
#pragma unroll
          for (int c = 0; c < kTile; ++c) sacc[a][c] += qv[a] * kv[c];
          hacc[a][0] += qv[a] * c0;
          hacc[a][1] += qv[a] * c1;
        }
      }
      if (tid < L) {
        for (int dd = 0; dd < kSlice; ++dd)
          qn_acc += qs[tid * kSliceStride + dd] * ns[d0 + dd];
      }
      __syncthreads();
      // this slice of C's rows and of n, to the chunk's end
      {
        float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int s = 0; s < L; ++s) {
          const float w = gw[s];
          const float v0 = vs[s * kRows + ty] * w;
          const float v1 = vs[s * kRows + ty + 16] * w;
          const float k0 = ks[s * kSliceStride + tx];
          const float k1 = ks[s * kSliceStride + tx + 16];
          acc[0][0] += v0 * k0;
          acc[0][1] += v0 * k1;
          acc[1][0] += v1 * k0;
          acc[1][1] += v1 * k1;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* p = Cs + (ty + 16 * c) * cst + d0 + tx + 16 * e;
            *p = decay * *p + acc[c][e];
          }
        }
      }
      if (tid < kSlice) {
        float acc = 0.f;
        for (int s = 0; s < L; ++s) acc += gw[s] * ks[s * kSliceStride + tid];
        ns[d0 + tid] = decay * ns[d0 + tid] + acc;
      }
      __syncthreads();
    }
    if (tid < L) qn[tid] = qn_acc;

    // P = W o S, and its row sums for the denominator
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int j = ty + 16 * a;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int s = tx + 16 * c;
        float p = 0.f;
        if (j < L && s <= j) p = expf(gi[s] - gM[j]) * sacc[a][c];
        if (j < L && s < L) Ps[j * pst + s] = p;
        sum += p;
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (tx == 0 && j < L) rs[j] = sum;
    }
    __syncthreads();
    // h for this block's columns
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int j = ty + 16 * a;
      if (j >= L) break;
      const float cj = gc[j];
      const float den = fmaxf(fabsf(cj * qn[j] + rs[j]), 1.f);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = tx + 16 * c;
        float acc = 0.f;
        for (int s = 0; s <= j; ++s) acc += Ps[j * pst + s] * vs[s * kRows + r];
        if (r < rows) {
          h[base + (t0 + j) * st + r0 + r] =
              from_f32<T>((cj * hacc[a][c] + acc) / den);
        }
      }
    }
    __syncthreads();
  }

  // the final state: this block's rows of C; block 0 writes n and m
  __syncthreads();
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + hh;
  for (int e = tid; e < rows * dh; e += kThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    c_out[(bh * dh + r0 + r) * dh + d] = Cs[r * cst + d];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < dh; d += kThreads) n_out[bh * dh + d] = ns[d];
    if (tid == 0) m_out[bh] = s_m;
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const float* i, const float* f, void* h, float* c,
                         float* n, float* m, int64_t b, int64_t hh,
                         int64_t t, int64_t dh, int64_t chunk, int64_t sb,
                         int64_t sh, int64_t st, int64_t gb, int64_t gh,
                         int64_t gt, cudaStream_t stream) {
  const int64_t bytes = 4 * smem_floats(dh, chunk);
  auto kernel = mlstm_chunkwise_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((dh + kRows - 1) / kRows),
                  static_cast<unsigned>(hh), static_cast<unsigned>(b));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), i, f, static_cast<T*>(h), c, n, m, t,
      static_cast<int>(dh), static_cast<int>(chunk), sb, sh, st, gb, gh, gt);
  return cudaGetLastError();
}

}  // namespace

bool mlstm_chunkwise_shape_ok(int64_t dh, int64_t chunk) {
  return dh >= 1 && chunk >= 1 && chunk <= kMaxMlstmChunk &&
         4 * smem_floats(dh, chunk) <= kMaxDynamicSmem;
}

cudaError_t launch_mlstm_chunkwise(const void* q, const void* k,
                                   const void* v, const float* i,
                                   const float* f, void* h, float* c,
                                   float* n, float* m, int64_t b, int64_t hh,
                                   int64_t t, int64_t dh, int64_t chunk,
                                   int64_t sb, int64_t sh, int64_t st,
                                   int64_t gb, int64_t gh, int64_t gt,
                                   int dtype, cudaStream_t stream) {
  if (!mlstm_chunkwise_shape_ok(dh, chunk) || t % chunk != 0) {
    return cudaErrorInvalidValue;
  }
  if (b == 0 || hh == 0) return cudaSuccess;
  if (dtype == kBF16) {
    return launch_typed<__nv_bfloat16>(q, k, v, i, f, h, c, n, m, b, hh, t,
                                       dh, chunk, sb, sh, st, gb, gh, gt,
                                       stream);
  }
  return launch_typed<float>(q, k, v, i, f, h, c, n, m, b, hh, t, dh, chunk,
                             sb, sh, st, gb, gh, gt, stream);
}

}  // namespace repro_torch
