// Chunkwise-parallel mLSTM from a zero state, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm.py::mlstm_chunkwise
// (body _mlstm_kernel, pallas_call at :113).  Per (b, h) and chunk of L
// steps, from the state (C0, n0, m0) the previous chunk left
// (A = cumsum f, gia = i - A):
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
// What bounds it: per (b, h, chunk) the function needs 4 L dh^2 +
// 2 dh L (L + 1) flops (C0 q, the C update, and the causal triangle of
// the scores and of P v) against (q, k, v, h) L dh values moved, so the
// operations, not the bytes: at (8, 4, 8192, 512) 309.5 GFLOP, 0.627 ms
// on the TF32 tensor cores, 4.619 ms in f32 on the CUDA cores.
//
// Two routes; the wrapper (mlstm.py::route) picks one.
//
// * Tensor cores ("tc": f32 or bf16, L in {64, 128}, dh a multiple of 32
//   from 32 to 512).  Every product runs on TF32 wgmma with the 3xTF32
//   split: x = hi + lo with hi = tf32(x) (to nearest, ties away, as
//   cvt.rna) and lo = tf32(x - hi), and a b = hi hi' + hi lo' + lo hi',
//   three wgmma into one f32 accumulator.  1xTF32 (10 mantissa bits per
//   operand), emulated on the CPU, comes close to the 5e-4 check; the
//   split keeps f32 accuracy (tests/test_torch_mlstm_route.py).  TF32
//   has no transpose bits, so both shared-memory operands are K-major
//   tiles (no swizzle, 8 x 16-byte core matrices) that the threads write
//   when they split a raw tile into hi and lo; v and k are transposed on
//   that write where a product needs it.  A register A operand taken
//   from an accumulator (P, C) holds columns 2t and 2t + 1 of each group
//   of 8 where a TF32 A fragment wants t and t + 4, so the B tile's K
//   index is permuted to match instead.  Three launches:
//   a. gates: one warp per (b, h) walks the chunks and writes gia, M_j,
//      c_j, wL_s and decay per chunk, and the final m (lane 0 takes the
//      cumsum and cummax in the reference's order);
//   b. intra-chunk: one CTA per (b, h, chunk) computes the scores once:
//      S = q k^T (A and B from shared memory) over dh in 32-column
//      slices, P = W o S and its row sums rs in registers, H = P v (A =
//      P from registers) in 64-column blocks of v; H goes to h when h is
//      f32, else to an f32 scratch;
//   c. inter-chunk: one CTA per (b, h, 64 value rows of C) walks the
//      chunks with its rows of C in registers (two warpgroups, each
//      half of the columns: 128 registers a thread at dh = 512): Y =
//      C0 q^T (A = C from registers) over q's 32-column slices, then
//      h_j = (c_j Y_j + H_j) / max(|c_j n0 . q_j + rs_j|, 1), then the
//      update C = decay C + (wL o v)^T k over 8 keys a step (A = wL o v
//      loaded into registers, B = k^T); n0 . q_j and n's update run on
//      the CUDA cores beside them.  It computes no scores.
//   Raw q, k, v slices arrive by TMA (one thread issues 4-D boxes of
//   tensor maps over the strided (B, H, T, dh) views; mbarriers count
//   the bytes) through a ring of two slots (pass b) or three (pass c),
//   two steps ahead, while the previous step's wgmma runs; a chunk's q
//   and k (512 KB at dh = 512) do not fit a CTA, so the ring holds
//   slices, not chunks.  The split rounds with integer operations
//   (tf32_rna in hopper.cuh): the conversion instruction's rate held
//   the steps back.  Operations per (b, h,
//   chunk), times three for the split: 4 L dh^2 (pass c, exactly the
//   function's) plus 2 dh x 2 x 64 x 64 x nb (nb + 1) / 2 (pass b, nb =
//   L / 64 row blocks of 64: the key blocks at or below the diagonal),
//   which is 2 dh (L^2 + 64 L) against the function's 2 dh (L^2 + L):
//   wgmma's 64-row tile computes the upper half of each diagonal block
//   too.  At L = 128, dh = 512: 159.4 MFLOP against 151.0 (5.5% more),
//   478 MFLOP with the split.
// * FMA (everything else: chunk 1, 16, 32, 100, dh 8, 80, ...): the
//   first version, f32 FMA on the CUDA cores.  One CTA owns kRows value
//   rows of C for one (b, h) and walks the chunks in order, its rows of
//   C resident in shared memory, streaming q and k through it in
//   kSlice-wide dh slices; in the same pass it accumulates the (L, L)
//   scores, C0 q for its rows and n0 . q, then updates its slice of C
//   and n.  Every row block of a (b, h) computes the chunk's scores and
//   gates again.
//
// Arithmetic is f32 (TF32 products split as above), built without
// --use_fast_math.  -1e30 stands for -inf as in the reference, so
// m0 - M never meets inf - inf.  q, k, v, h are read and written through
// (b, h, t) element strides with a unit dh stride, so the layer's
// (B, T, H, dh) tensors need no transposes; i and f through their own
// (b, h, t) strides.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
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


// ---------------------------------------------------------------------
// tensor-core route: gate pass, intra-chunk pass, inter-chunk pass
// ---------------------------------------------------------------------

constexpr int kTcSlice = 32;     // d columns of a raw q/k slice
constexpr int kVBlock = 64;      // d columns of a P v block (pass b)
constexpr int kRowsC = 64;       // value rows of C per pass-c CTA
constexpr int kUSlice = 8;       // steps s of one C-update step (pass c)
constexpr int kInterThreads = 256;

// Planes of the f32 gate scratch, each (B H, T): gia, M, c, wL, rs;
// then decay (B H, T / L).
enum GatePlane : int { kGia = 0, kGM = 1, kGc = 2, kGw = 3, kGrs = 4 };
constexpr int kGatePlanes = 5;

// Byte offset of (row, col) in a K-major tf32 tile of R rows (R % 8 ==
// 0) without swizzle: 8-row x 4-column core matrices of 128 bytes,
// rows of a core matrix 16 bytes apart, core matrices R / 8 apart along
// K and adjacent along M/N.
__device__ __forceinline__ uint32_t kmaj(int row, int col, int R) {
  return ((((col >> 2) * (R >> 3)) + (row >> 3)) << 7) + ((row & 7) << 4) +
         ((col & 3) << 2);
}

// The descriptor of k-step kk (8 columns) of such a tile at shared
// address `tile`, from row r0 (a multiple of 8).
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int R, int kk,
                                          int r0) {
  return hopper::plain_desc(tile + ((2 * kk * (R >> 3) + (r0 >> 3)) << 7),
                            (R >> 3) << 7, 128);
}

// Four floats of raw shared memory (16-byte aligned for f32, 8 for bf16).
template <typename T>
__device__ __forceinline__ float4 raw4(const uint8_t* p);
template <>
__device__ __forceinline__ float4 raw4<float>(const uint8_t* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 raw4<__nv_bfloat16>(const uint8_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <typename T>
__device__ __forceinline__ float raw1(const uint8_t* p) {
  return to_f32(*reinterpret_cast<const T*>(p));
}

// The 3xTF32 split of four floats into the hi and lo tiles at `off`.
__device__ __forceinline__ void put4(uint8_t* hi, uint8_t* lo, uint32_t off,
                                     float4 x) {
  uint4 h, l;
  hopper::split_tf32(x.x, h.x, l.x);
  hopper::split_tf32(x.y, h.y, l.y);
  hopper::split_tf32(x.z, h.z, l.z);
  hopper::split_tf32(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// Byte a of a tile written by TMA with a 128-byte (kSwz = 3) or 64-byte
// (kSwz = 2) swizzle lies at swz<kSwz>(a) (tiles aligned to 1024 bytes).
template <int kSwz>
__device__ __forceinline__ uint32_t swz(uint32_t a) {
  return a ^ ((a >> 3) & (((1u << kSwz) - 1) << 4));
}

// The 4-D box at (d, t) of head (blockIdx.y, blockIdx.z) of a map built
// by tensor_map (below), whose second dimension is t when t_dim == 1
// and the head otherwise.
__device__ __forceinline__ void tma_bh(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int d, int64_t t,
                                       int t_dim) {
  const int tt = static_cast<int>(t);
  if (t_dim == 1)
    hopper::tma_load_4d(dst, map, bar, d, tt, blockIdx.y, blockIdx.z);
  else
    hopper::tma_load_4d(dst, map, bar, d, blockIdx.y, tt, blockIdx.z);
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A 4-D map over a (b, hh, t, dh) tensor with element strides (sb, sh,
// st, 1): dims dh first, then t and hh in the order of their strides
// (t second when t_dim == 1), then b; a (box_d, box_t, 1, 1) box.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int es,
                const void* ptr, int64_t b, int64_t hh, int64_t t,
                int64_t dh, int64_t sb, int64_t sh, int64_t st, int t_dim,
                int box_d, int box_t, CUtensorMapSwizzle swizzle) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const bool t1 = t_dim == 1;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(t1 ? t : hh),
      static_cast<cuuint64_t>(t1 ? hh : t), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>((t1 ? st : sh) * es),
                                 static_cast<cuuint64_t>((t1 ? sh : st) * es),
                                 static_cast<cuuint64_t>(sb * es)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d),
                             static_cast<cuuint32_t>(t1 ? box_t : 1),
                             static_cast<cuuint32_t>(t1 ? 1 : box_t), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- a. gates ----------------------------------------------------------

// One warp per (b, h) walks the chunks: lane 0 takes the cumsum and
// cummax in order (the reference's order, so gia and M match it), then
// the lanes compute the exponentials.
template <int L>
__global__ void __launch_bounds__(128)
    mlstm_gates_kernel(const float* __restrict__ ig,
                       const float* __restrict__ fg, float* __restrict__ gs,
                       float* __restrict__ m_out, int64_t bhn, int hh,
                       int64_t t_len, int64_t gb, int64_t gh, int64_t gt) {
  __shared__ float sf[4][L];
  __shared__ float sg[4][L];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t bh = static_cast<int64_t>(blockIdx.x) * 4 + warp;
  if (bh >= bhn) return;
  const int64_t gbase = (bh / hh) * gb + (bh % hh) * gh;
  const int64_t plane = bhn * t_len;
  const int64_t nc = t_len / L;
  float* gia_o = gs + kGia * plane + bh * t_len;
  float* M_o = gs + kGM * plane + bh * t_len;
  float* c_o = gs + kGc * plane + bh * t_len;
  float* w_o = gs + kGw * plane + bh * t_len;
  float* decay_o = gs + kGatePlanes * plane + bh * nc;
  float* fs = sf[warp];
  float* gis = sg[warp];
  float m0 = kNegBig;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t t0 = c * L;
    for (int s = lane; s < L; s += 32) {
      fs[s] = fg[gbase + (t0 + s) * gt];
      gis[s] = ig[gbase + (t0 + s) * gt];
    }
    __syncwarp();
    float a = 0.f;
    float g = kNegBig;
    if (lane == 0) {
      for (int s = 0; s < L; ++s) {
        a += fs[s];
        const float gia = gis[s] - a;
        g = s == 0 ? gia : fmaxf(g, gia);
        gis[s] = gia;
        fs[s] = g;               // cummax
      }
    }
    __syncwarp();
    a = __shfl_sync(0xffffffffu, a, 0);
    const float mxl = fmaxf(m0, fs[L - 1]);
    for (int s = lane; s < L; s += 32) {
      const float M = fmaxf(m0, fs[s]);
      gia_o[t0 + s] = gis[s];
      M_o[t0 + s] = M;
      c_o[t0 + s] = expf(m0 - M);
      w_o[t0 + s] = expf(gis[s] - mxl);
    }
    if (lane == 0) decay_o[c] = expf(m0 - mxl);
    m0 = a + mxl;
    __syncwarp();
  }
  if (lane == 0) m_out[bh] = m0;
}

// ---- b. intra-chunk ----------------------------------------------------

template <typename T, int L>
struct IntraShape {
  static constexpr int kWgs = L / 64;
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kEs = sizeof(T);
  static constexpr int kSRow = kTcSlice * kEs;     // raw q, k row bytes
  static constexpr int kSSwz = kSRow == 128 ? 3 : 2;
  static constexpr int kSBytes = L * kSRow;        // a raw q or k slice
  static constexpr int kVBytes = L * kVBlock * kEs;
  static constexpr int kRawBytes =
      2 * kSBytes > kVBytes ? 2 * kSBytes : kVBytes;
  static constexpr int kTile = L * kTcSlice * 4;   // a q or k hi or lo tile
  static constexpr int kOpBytes = 4 * kTile;       // = v^T hi + lo
  static constexpr size_t kSmem =
      1024 + 2 * static_cast<size_t>(kRawBytes) + 2 * kOpBytes + 2 * L * 4;
  static_assert(2 * 64 * L * 4 == kOpBytes, "v^T tiles fill a stage");
  static_assert(kSmem <= 232448 - 1024, "shared memory");
};

// One CTA per (b, h, chunk), a warpgroup per 64 rows j: S = q k^T over
// dh in 32-column slices (A and B from shared memory), P = W o S in
// registers, rs = row sums of P, then H = P v in 64-column blocks of v
// (A = P from registers); H -> hbuf, rs -> the gate scratch.  Only the
// key blocks at or below the diagonal are computed: warpgroup w takes
// keys s < 64 (w + 1).  Raw slices arrive by TMA two steps ahead; the
// threads split them into hi/lo tiles while the previous step's wgmma
// runs.
template <typename T, int L>
__global__ void __launch_bounds__(IntraShape<T, L>::kThreads, 1)
    mlstm_intra_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, int t_dim,
                       float* __restrict__ gs, float* __restrict__ hbuf,
                       int hh, int64_t bhn, int64_t t_len, int dh,
                       int64_t sb, int64_t sh, int64_t st) {
  using namespace hopper;
  using S = IntraShape<T, L>;
  constexpr int NT = S::kThreads;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[2];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));             // the swizzle's span
  uint8_t* const raw0 = base;
  uint8_t* const op0 = base + 2 * S::kRawBytes;
  float* const gia_s = reinterpret_cast<float*>(op0 + 2 * S::kOpBytes);
  float* const M_s = gia_s + L;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * L;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * hh + blockIdx.y;
  const int64_t off0 = blockIdx.z * sb + blockIdx.y * sh + t0 * st;
  float* const hb = hbuf + off0;
  if (tid == 0) {
    mbar_init(smem_u32(&full_bar[0]), 1);
    mbar_init(smem_u32(&full_bar[1]), 1);
    mbar_init_fence();
  }
  const int64_t plane = bhn * t_len;
  for (int s = tid; s < L; s += NT) {
    gia_s[s] = gs[kGia * plane + bh * t_len + t0 + s];
    M_s[s] = gs[kGM * plane + bh * t_len + t0 + s];
  }

  const int n_s = dh / kTcSlice;
  const int n_steps = n_s + (dh + kVBlock - 1) / kVBlock;
  auto raw = [&](int i) { return raw0 + (i & 1) * S::kRawBytes; };
  auto op = [&](int i) { return op0 + (i & 1) * S::kOpBytes; };
  auto bar = [&](int i) { return smem_u32(&full_bar[i & 1]); };
  // step i's raw slices by TMA (a v block past dh is zero-filled)
  auto load = [&](int i) {
    if (tid != 0 || i >= n_steps) return;
    const uint32_t dst = smem_u32(raw(i));
    if (i < n_s) {
      mbar_expect_tx(bar(i), 2 * S::kSBytes);
      tma_bh(dst, &qmap, bar(i), i * kTcSlice, t0, t_dim);
      tma_bh(dst + S::kSBytes, &kmap, bar(i), i * kTcSlice, t0, t_dim);
    } else {
      mbar_expect_tx(bar(i), S::kVBytes);
      tma_bh(dst, &vmap, bar(i), (i - n_s) * kVBlock, t0, t_dim);
    }
  };
  auto convert = [&](int i) {
    const uint8_t* src = raw(i);
    uint8_t* dst = op(i);
    if (i < n_s) {
      // q and k slices -> hi, lo tiles (L rows, 32 columns)
      constexpr int kPer = kTcSlice / 4;
      for (int e = tid; e < 2 * L * kPer; e += NT) {
        const int which = e / (L * kPer);
        const int rem = e - which * L * kPer;
        const int r = rem % L;
        const int c = (rem / L) * 4;
        const float4 x = raw4<T>(src + which * S::kSBytes +
                                 swz<S::kSSwz>(r * S::kSRow + c * S::kEs));
        uint8_t* hi = dst + which * 2 * S::kTile;
        put4(hi, hi + S::kTile, kmaj(r, c, L), x);
      }
    } else {
      // a v block -> v^T hi, lo (64 rows d, L columns s); in each group
      // of 8 keys the columns hold s = 0, 2, 4, 6, 1, 3, 5, 7, the order
      // of P's columns in the accumulator fragment that feeds A
      for (int e = tid; e < kVBlock * (L / 8); e += NT) {
        const int d = e % kVBlock;
        const int sg = e / kVBlock;
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          x[u] = raw1<T>(src + ((8 * sg + u) * kVBlock + d) * S::kEs);
        put4(dst, dst + 2 * S::kTile, kmaj(d, 8 * sg, 64),
             make_float4(x[0], x[2], x[4], x[6]));
        put4(dst, dst + 2 * S::kTile, kmaj(d, 8 * sg + 4, 64),
             make_float4(x[1], x[3], x[5], x[7]));
      }
    }
    fence_proxy_async();
  };

  float sacc[L / 2];
#pragma unroll
  for (int e = 0; e < L / 2; ++e) sacc[e] = 0.f;
  // while step i's wgmma runs: the next step's raw slice in, converted
  auto advance = [&](int i) {
    if (i + 1 < n_steps) {
      __syncthreads();        // every warpgroup's step i - 1 is done
      mbar_wait(bar(i + 1), ((i + 1) >> 1) & 1);
      convert(i + 1);
    }
  };
  __syncthreads();
  load(0);
  load(1);
  mbar_wait(bar(0), 0);
  convert(0);
  __syncthreads();
  for (int i = 0; i < n_s; ++i) {
    load(i + 2);
    const uint32_t o = smem_u32(op(i));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcSlice / 8; ++kk) {
      const uint64_t ah = kdesc(o, L, kk, 64 * wg);
      const uint64_t al = kdesc(o + S::kTile, L, kk, 64 * wg);
      const uint64_t bh_ = kdesc(o + 2 * S::kTile, L, kk, 0);
      const uint64_t bl = kdesc(o + 3 * S::kTile, L, kk, 0);
      const int sc = (i > 0 || kk > 0) ? 1 : 0;
      if (L == 128 && wg == 1) {
        auto& d = *reinterpret_cast<float(*)[L / 2]>(sacc);
        wgmma_ss_tf32(d, ah, bh_, sc);
        wgmma_ss_tf32(d, ah, bl, 1);
        wgmma_ss_tf32(d, al, bh_, 1);
      } else {
        auto& d = *reinterpret_cast<float(*)[32]>(sacc);
        wgmma_ss_tf32(d, ah, bh_, sc);
        wgmma_ss_tf32(d, ah, bl, 1);
        wgmma_ss_tf32(d, al, bh_, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();       // step i - 1 is done: its op buffer is free
    advance(i);
    __syncthreads();
  }
  wgmma_wait<0>();
  fence_regs(sacc);

  // P = W o S (keys s <= j), its row sums, and its A fragments
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < L / 2; ++e) {
    const int hf = (e >> 1) & 1;
    const int j = 64 * wg + 16 * warp + g + 8 * hf;
    const int s = 8 * (e >> 2) + 2 * tq + (e & 1);
    const float p = s <= j ? expf(gia_s[s] - M_s[j]) * sacc[e] : 0.f;
    sacc[e] = p;
    rsum[hf] += p;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float r = rsum[hf];
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
    if (tq == 0) {
      const int j = 64 * wg + 16 * warp + g + 8 * hf;
      gs[kGrs * plane + bh * t_len + t0 + j] = r;
    }
  }
  uint32_t pa[L / 8][4], pl[L / 8][4];    // P's A fragments, hi and lo
#pragma unroll
  for (int kk = 0; kk < L / 8; ++kk) {
    split_tf32(sacc[4 * kk + 0], pa[kk][0], pl[kk][0]);
    split_tf32(sacc[4 * kk + 2], pa[kk][1], pl[kk][1]);
    split_tf32(sacc[4 * kk + 1], pa[kk][2], pl[kk][2]);
    split_tf32(sacc[4 * kk + 3], pa[kk][3], pl[kk][3]);
  }

  const int nk = 8 * (wg + 1);            // live k-steps of P v
  float hacc[32];
  for (int i = n_s; i < n_steps; ++i) {
    load(i + 2);
    const uint32_t o = smem_u32(op(i));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 8; ++kk) {
      if (kk < nk) {
        const uint64_t bh_ = kdesc(o, 64, kk, 0);
        const uint64_t bl = kdesc(o + 2 * S::kTile, 64, kk, 0);
        wgmma_rs_tf32(hacc, pa[kk], bh_, kk > 0 ? 1 : 0);
        wgmma_rs_tf32(hacc, pa[kk], bl, 1);
        wgmma_rs_tf32(hacc, pl[kk], bh_, 1);
      }
    }
    wgmma_commit();
    advance(i);
    wgmma_wait<0>();
    fence_regs(hacc);
    // this 64-column block of H
    const int d0 = (i - n_s) * kVBlock;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int j = 64 * wg + 16 * warp + g + 8 * ((e >> 1) & 1);
      const int d = d0 + 8 * (e >> 2) + 2 * tq;
      if (d < dh)
        *reinterpret_cast<float2*>(hb + j * st + d) =
            make_float2(hacc[e], hacc[e + 1]);
    }
    __syncthreads();
  }
}

// ---- c. inter-chunk ----------------------------------------------------

template <typename T, int L, int CW>
struct InterShape {
  static constexpr int kEs = sizeof(T);
  static constexpr int kQRow = kTcSlice * kEs;           // q slice row bytes
  static constexpr int kQSwz = kQRow == 128 ? 3 : 2;      // 128- or 64-byte
  static constexpr int kQBytes = L * kQRow;
  static constexpr int kKBox = 2 * CW < 256 ? 2 * CW : 256;   // k box width
  static constexpr int kKBytes = kUSlice * 2 * CW * kEs;
  static constexpr int kVBytes = kUSlice * kRowsC * kEs;
  static constexpr int kHBytes = L * kRowsC * 4;
  static constexpr int kRawU = kKBytes + kVBytes;
  static constexpr int kRawBytes =
      ((kQBytes > kRawU ? kQBytes : kRawU) + 1023) / 1024 * 1024;
  static constexpr int kStages = 3;
  static constexpr int kYTile = L * 16 * 4;       // a warpgroup's q hi or lo
  static constexpr int kUTile = CW * kUSlice * 4;  // a warpgroup's k^T hi or lo
  static constexpr int kOpBytes =
      4 * kYTile > 4 * kUTile ? 4 * kYTile : 4 * kUTile;
  static constexpr int kXBytes = 2 * (L / 4) * 128 * 4;   // Y exchange
  static constexpr size_t kSmem =
      1024 + kStages * static_cast<size_t>(kRawBytes) + 2 * kOpBytes +
      kHBytes + 4 * (2 * CW + 2 * 3 * L + L + 4);
  static_assert(kXBytes <= kOpBytes, "the Y exchange fits an op stage");
  static_assert(kSmem <= 232448 - 1024, "shared memory");
};

// One CTA per (b, h, 64 value rows of C) walks the chunks in order.  Two
// warpgroups hold the rows' C in registers, split by columns: warpgroup
// w owns the columns d with (d / 16) % 2 == w, accumulator column n
// standing for d = 32 (n / 16) + 16 w + n % 16.  Per chunk:
//   Y steps (32 columns of q each): Y = C0 q^T, A = C's fragments from
//     registers, B = q (its columns permuted as P's are in pass b), each
//     warpgroup over its own columns; the threads also sum n0 . q_j;
//   epilogue: the two halves of Y are summed through shared memory and
//     h_j = (c_j Y_j + H_j) / max(|c_j n0 . q_j + rs_j|, 1) is written;
//   U steps (8 keys each): C = decay C + (wL o v)^T k, A = wL o v
//     loaded into registers, B = k^T from shared memory; n likewise.
// Raw slices arrive by TMA (one thread issues them; 4-D tensor maps over
// the strided q, k, v and H) through a ring of three, two steps ahead.
template <typename T, int L, int CW>
__global__ void __launch_bounds__(kInterThreads, 1)
    mlstm_inter_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap hmap,
                       int t_dim, const float* __restrict__ gs,
                       T* h,   // may alias H (f32 h), read through hmap
                       float* __restrict__ c_out, float* __restrict__ n_out,
                       int hh, int64_t bhn, int64_t t_len, int dh,
                       int64_t sb, int64_t sh, int64_t st) {
  using namespace hopper;
  using S = InterShape<T, L, CW>;
  constexpr int NT = kInterThreads;
  constexpr int kY = CW / 16;           // Y steps a chunk
  constexpr int kU = L / kUSlice;       // U steps a chunk
  constexpr int kSpc = kY + kU;
  constexpr int kHalf = L / 4;          // Y registers a warpgroup hands over
  constexpr int kTpj = NT / L;          // threads summing one n0 . q_j
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[S::kStages];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));             // the q swizzle's span
  uint8_t* const raw0 = base;
  uint8_t* const op0 = raw0 + S::kStages * S::kRawBytes;
  float* const hs = reinterpret_cast<float*>(op0 + 2 * S::kOpBytes);
  float* const n_s = hs + L * kRowsC;              // 2 CW
  float* const gbuf = n_s + 2 * CW;                // [2][3][L]: c, wL, rs
  float* const qn_s = gbuf + 6 * L;                // L
  float* const decay_s = qn_s + L;                 // 2

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lt = tid % 128;
  const int warp = lt / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int r0 = blockIdx.x * kRowsC;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * hh + blockIdx.y;
  const int64_t off0 = blockIdx.z * sb + blockIdx.y * sh;
  const int64_t plane = bhn * t_len;
  const int64_t nc = t_len / L;
  const int64_t n_steps = nc * kSpc;

  for (int d = tid; d < 2 * CW; d += NT) n_s[d] = 0.f;
  if (tid == 0) {
    for (int x = 0; x < S::kStages; ++x) mbar_init(smem_u32(&full_bar[x]), 1);
    mbar_init_fence();
  }

  // byte of raw k (s, d): kKBox-wide boxes one after the other
  auto kaddr = [](int s, int d) {
    return ((d / S::kKBox) * kUSlice * S::kKBox + s * S::kKBox +
            d % S::kKBox) * S::kEs;
  };
  auto raw = [&](int64_t i) { return raw0 + (i % S::kStages) * S::kRawBytes; };
  auto bar = [&](int64_t i) {
    return smem_u32(&full_bar[i % S::kStages]);
  };
  auto op = [&](int64_t i) { return op0 + (i & 1) * S::kOpBytes; };
  // step i's raw slices (and at a chunk's first step its H) by TMA; the
  // box past dh is zero-filled
  auto load = [&](int64_t i) {
    if (tid != 0 || i >= n_steps) return;
    const int64_t c = i / kSpc;
    const int r = static_cast<int>(i - c * kSpc);
    const uint32_t dst = smem_u32(raw(i));
    if (r < kY) {
      mbar_expect_tx(bar(i), S::kQBytes + (r == 0 ? S::kHBytes : 0));
      tma_bh(dst, &qmap, bar(i), r * kTcSlice, c * L, t_dim);
      if (r == 0) tma_bh(smem_u32(hs), &hmap, bar(i), r0, c * L, t_dim);
    } else {
      const int64_t s0 = c * L + (r - kY) * kUSlice;
      mbar_expect_tx(bar(i), S::kRawU);
#pragma unroll
      for (int x = 0; x < 2 * CW / S::kKBox; ++x)
        tma_bh(dst + x * kUSlice * S::kKBox * S::kEs, &kmap, bar(i),
               x * S::kKBox, s0, t_dim);
      tma_bh(dst + S::kKBytes, &vmap, bar(i), r0, s0, t_dim);
    }
  };
  float qn_part = 0.f;
  auto convert = [&](int64_t i) {
    const int64_t c = i / kSpc;
    const int r = static_cast<int>(i - c * kSpc);
    const uint8_t* src = raw(i);
    uint8_t* dst = op(i);
    float* gb = gbuf + (c & 1) * 3 * L;
    if (r < kY) {
      if (r == 0) {
        for (int s = tid; s < L; s += NT) {
          const int64_t o = bh * t_len + c * L + s;
          gb[s] = gs[kGc * plane + o];
          gb[L + s] = gs[kGw * plane + o];
          gb[2 * L + s] = gs[kGrs * plane + o];
        }
        if (tid == 0)
          decay_s[c & 1] = gs[kGatePlanes * plane + bh * nc + c];
        qn_part = 0.f;
      }
      // B of Y for each warpgroup: rows j, 16 columns holding, per
      // group of 8, its columns n = 0, 2, 4, 6, 1, 3, 5, 7
      for (int e = tid; e < 2 * L * 2; e += NT) {
        const int w = e / (2 * L);
        const int rem = e - w * 2 * L;
        const int j = rem % L;
        const int h8 = rem / L;
        const uint32_t a0 = j * S::kQRow + (16 * w + 8 * h8) * S::kEs;
        const float4 a = raw4<T>(src + swz<S::kQSwz>(a0));
        const float4 b = raw4<T>(src + swz<S::kQSwz>(a0 + 4 * S::kEs));
        uint8_t* hi = dst + w * 2 * S::kYTile;
        put4(hi, hi + S::kYTile, kmaj(j, 8 * h8, L),
             make_float4(a.x, a.z, b.x, b.z));
        put4(hi, hi + S::kYTile, kmaj(j, 8 * h8 + 4, L),
             make_float4(a.y, a.w, b.y, b.w));
      }
      // n0 . q_j over this slice
      {
        constexpr int kW = kTcSlice / kTpj;
        const int j = tid / kTpj;
        const int part = tid % kTpj;
        const uint32_t a0 = j * S::kQRow + part * kW * S::kEs;
        const float* nn = n_s + r * kTcSlice + part * kW;
#pragma unroll
        for (int u = 0; u < kW; u += 4) {
          const float4 x = raw4<T>(src + swz<S::kQSwz>(a0 + u * S::kEs));
          const float4 y = *reinterpret_cast<const float4*>(nn + u);
          qn_part += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
        }
      }
    } else {
      const int u = r - kY;
      // B of the C update for each warpgroup: k^T, rows n, 8 keys, in
      // 4 x 4 blocks (4 keys of 4 neighbouring columns)
      for (int e = tid; e < 2 * CW * 2; e += NT) {
        const int d = e % (2 * CW);
        const int cg = e / (2 * CW);
        const int w = (d >> 4) & 1;
        const int n = 16 * (d >> 5) + (d & 15);
        uint8_t* hi = dst + w * 2 * S::kUTile;
        put4(hi, hi + S::kUTile, kmaj(n, 4 * cg, CW),
             make_float4(raw1<T>(src + kaddr(4 * cg, d)),
                         raw1<T>(src + kaddr(4 * cg + 1, d)),
                         raw1<T>(src + kaddr(4 * cg + 2, d)),
                         raw1<T>(src + kaddr(4 * cg + 3, d))));
      }
      // n = decay n + sum_s wL_s k_s, each column by one thread
      const float* wl = gb + L + u * kUSlice;
      for (int d = 4 * tid; d < dh; d += 4 * NT) {
        float4 acc = *reinterpret_cast<const float4*>(n_s + d);
        if (u == 0) {
          const float dec = decay_s[c & 1];
          acc = make_float4(dec * acc.x, dec * acc.y, dec * acc.z,
                            dec * acc.w);
        }
#pragma unroll
        for (int s = 0; s < kUSlice; ++s) {
          const float4 x = raw4<T>(src + kaddr(s, d));
          acc.x += wl[s] * x.x;
          acc.y += wl[s] * x.y;
          acc.z += wl[s] * x.z;
          acc.w += wl[s] * x.w;
        }
        *reinterpret_cast<float4*>(n_s + d) = acc;
      }
    }
    fence_proxy_async();
  };
  auto advance = [&](int64_t i) {
    if (i + 1 < n_steps) {
      __syncthreads();        // both warpgroups' step i - 1 is done
      mbar_wait(bar(i + 1), ((i + 1) / S::kStages) & 1);
      convert(i + 1);
    }
  };

  float cacc[CW / 2];
#pragma unroll
  for (int e = 0; e < CW / 2; ++e) cacc[e] = 0.f;
  float yacc[L / 2];

  __syncthreads();
  load(0);
  load(1);
  mbar_wait(bar(0), 0);
  convert(0);
  __syncthreads();
  for (int64_t c = 0; c < nc; ++c) {
    const float* gb = gbuf + (c & 1) * 3 * L;
#pragma unroll
    for (int r = 0; r < kY; ++r) {
      const int64_t i = c * kSpc + r;
      load(i + 2);
      if (r == 0) {          // the previous chunk's C update is done
        wgmma_wait<0>();
        fence_regs(cacc);
#pragma unroll
        for (int e = 0; e < L / 2; ++e) yacc[e] = 0.f;   // free till now
      }
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int kk = 2 * r + x;
        split_tf32(cacc[4 * kk + 0], ah[x][0], al[x][0]);
        split_tf32(cacc[4 * kk + 2], ah[x][1], al[x][1]);
        split_tf32(cacc[4 * kk + 1], ah[x][2], al[x][2]);
        split_tf32(cacc[4 * kk + 3], ah[x][3], al[x][3]);
      }
      const uint32_t o = smem_u32(op(i)) + wg * 2 * S::kYTile;
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const uint64_t bh_ = kdesc(o, L, x, 0);
        const uint64_t bl = kdesc(o + S::kYTile, L, x, 0);
        wgmma_rs_tf32(yacc, ah[x], bh_, (r > 0 || x > 0) ? 1 : 0);
        wgmma_rs_tf32(yacc, ah[x], bl, 1);
        wgmma_rs_tf32(yacc, al[x], bh_, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();       // step i - 1 is done: its op buffer is free
      advance(i);
      if (r == kY - 1) {
        wgmma_wait<0>();
        fence_regs(yacc);
        // n0 . q_j, then the two halves of Y summed, then h
        float qn = qn_part;
#pragma unroll
        for (int o2 = 1; o2 < kTpj; o2 <<= 1)
          qn += __shfl_xor_sync(0xffffffffu, qn, o2);
        if (tid % kTpj == 0) qn_s[tid / kTpj] = qn;
        // Y's exchange goes to this step's op stage: its wgmma is done
        // and the next write to it is convert(i + 2)
        float* const xb = reinterpret_cast<float*>(op(i));
#pragma unroll
        for (int e = 0; e < kHalf; ++e)
          xb[(wg * kHalf + e) * 128 + lt] =
              wg == 0 ? yacc[kHalf + e] : yacc[e];
        __syncthreads();
        const int64_t t0 = c * L;
#pragma unroll
        for (int e = 0; e < kHalf; ++e) {
          const int ei = wg * kHalf + e;        // the register kept
          const float y = (wg == 0 ? yacc[e] : yacc[kHalf + e]) +
                          xb[((1 - wg) * kHalf + e) * 128 + lt];
          const int rr = r0 + 16 * warp + g + 8 * ((ei >> 1) & 1);
          const int j = 8 * (ei >> 2) + 2 * tq + (ei & 1);
          if (rr < dh) {
            const float cj = gb[j];
            const float den = fmaxf(fabsf(cj * qn_s[j] + gb[2 * L + j]), 1.f);
            const int64_t o2 = off0 + (t0 + j) * st + rr;
            h[o2] = from_f32<T>((cj * y + hs[j * kRowsC + rr - r0]) / den);
          }
        }
      }
      __syncthreads();
    }
    {   // C's decay, before the update's first wgmma (none is in flight)
      const float dec = decay_s[c & 1];
#pragma unroll
      for (int e = 0; e < CW / 2; ++e) cacc[e] *= dec;
    }
    for (int u = 0; u < kU; ++u) {
      const int64_t i = c * kSpc + kY + u;
      load(i + 2);
      // A = (wL o v)^T: rows r (this warp's 16), keys tq and tq + 4
      uint32_t ah[4], al[4];
      {
        const uint8_t* vr = raw(i) + S::kKBytes;
        const float* wl = gb + L + u * kUSlice;
        const int rl = 16 * warp + g;
        const float w0 = wl[tq];
        const float w1 = wl[tq + 4];
        auto vat = [&](int s, int r) {
          return raw1<T>(vr + (s * kRowsC + r) * S::kEs);
        };
        split_tf32(w0 * vat(tq, rl), ah[0], al[0]);
        split_tf32(w0 * vat(tq, rl + 8), ah[1], al[1]);
        split_tf32(w1 * vat(tq + 4, rl), ah[2], al[2]);
        split_tf32(w1 * vat(tq + 4, rl + 8), ah[3], al[3]);
      }
      const uint32_t o = smem_u32(op(i)) + wg * 2 * S::kUTile;
      wgmma_fence();
      const uint64_t bh_ = kdesc(o, CW, 0, 0);
      const uint64_t bl = kdesc(o + S::kUTile, CW, 0, 0);
      wgmma_rs_tf32(cacc, ah, bh_, 1);
      wgmma_rs_tf32(cacc, ah, bl, 1);
      wgmma_rs_tf32(cacc, al, bh_, 1);
      wgmma_commit();
      wgmma_wait<1>();       // step i - 1 is done: its op buffer is free
      advance(i);
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  fence_regs(cacc);

  // the final state: this block's rows of C; block 0 writes n
#pragma unroll
  for (int e = 0; e < CW / 2; e += 2) {
    const int rr = r0 + 16 * warp + g + 8 * ((e >> 1) & 1);
    const int nn = 8 * (e >> 2) + 2 * tq;
    const int d = 32 * (nn / 16) + 16 * wg + nn % 16;
    if (rr < dh && d < dh)
      *reinterpret_cast<float2*>(c_out + (bh * dh + rr) * dh + d) =
          make_float2(cacc[e], cacc[e + 1]);
  }
  if (blockIdx.x == 0)
    for (int d = tid; d < dh; d += NT) n_out[bh * dh + d] = n_s[d];
}

template <typename T, int L, int CW>
cudaError_t launch_inter(const void* q, const void* k, const void* v,
                         const float* gs, const float* hbuf, void* h,
                         float* c, float* n, int64_t b, int64_t hh,
                         int64_t t, int64_t dh, int64_t sb, int64_t sh,
                         int64_t st, cudaStream_t stream) {
  using S = InterShape<T, L, CW>;
  const int t_dim = st <= sh ? 1 : 2;
  const CUtensorMapDataType ty = tma_type<T>();
  CUtensorMap qmap, kmap, vmap, hmap;
  if (!tensor_map(&qmap, ty, S::kEs, q, b, hh, t, dh, sb, sh, st, t_dim,
                  kTcSlice, L,
                  S::kQSwz == 3 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&kmap, ty, S::kEs, k, b, hh, t, dh, sb, sh, st, t_dim,
                  S::kKBox, kUSlice, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&vmap, ty, S::kEs, v, b, hh, t, dh, sb, sh, st, t_dim,
                  kRowsC, kUSlice, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, hbuf, b, hh, t,
                  dh, sb, sh, st, t_dim, kRowsC, L,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorNotSupported;
  auto kernel = mlstm_inter_kernel<T, L, CW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((dh + kRowsC - 1) / kRowsC),
                  static_cast<unsigned>(hh), static_cast<unsigned>(b));
  kernel<<<grid, kInterThreads, S::kSmem, stream>>>(
      qmap, kmap, vmap, hmap, t_dim, gs, static_cast<T*>(h), c, n,
      static_cast<int>(hh), b * hh, t, static_cast<int>(dh), sb, sh, st);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* i, const float* f, void* h, float* hbuf,
                      float* c, float* n, float* m, float* gs, int64_t b,
                      int64_t hh, int64_t t, int64_t dh, int64_t sb,
                      int64_t sh, int64_t st, int64_t gb, int64_t gh,
                      int64_t gt, cudaStream_t stream) {
  const int64_t bhn = b * hh;
  mlstm_gates_kernel<L><<<static_cast<unsigned>((bhn + 3) / 4), 128, 0,
                          stream>>>(i, f, gs, m, bhn, static_cast<int>(hh),
                                    t, gb, gh, gt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using S = IntraShape<T, L>;
  const int t_dim = st <= sh ? 1 : 2;
  const CUtensorMapDataType ty = tma_type<T>();
  const CUtensorMapSwizzle sw = S::kSSwz == 3 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map(&qmap, ty, S::kEs, q, b, hh, t, dh, sb, sh, st, t_dim,
                  kTcSlice, L, sw) ||
      !tensor_map(&kmap, ty, S::kEs, k, b, hh, t, dh, sb, sh, st, t_dim,
                  kTcSlice, L, sw) ||
      !tensor_map(&vmap, ty, S::kEs, v, b, hh, t, dh, sb, sh, st, t_dim,
                  kVBlock, L, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorNotSupported;
  auto intra = mlstm_intra_kernel<T, L>;
  err = cudaFuncSetAttribute(intra,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(t / L), static_cast<unsigned>(hh),
                  static_cast<unsigned>(b));
  intra<<<grid, S::kThreads, S::kSmem, stream>>>(
      qmap, kmap, vmap, t_dim, gs, hbuf, static_cast<int>(hh), bhn, t,
      static_cast<int>(dh), sb, sh, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // each warpgroup's share of C's columns, rounded up to a wgmma width
  const int64_t half = dh / 2;
  if (half <= 32)
    return launch_inter<T, L, 32>(q, k, v, gs, hbuf, h, c, n, b, hh, t, dh,
                                  sb, sh, st, stream);
  if (half <= 64)
    return launch_inter<T, L, 64>(q, k, v, gs, hbuf, h, c, n, b, hh, t, dh,
                                  sb, sh, st, stream);
  if (half <= 128)
    return launch_inter<T, L, 128>(q, k, v, gs, hbuf, h, c, n, b, hh, t,
                                   dh, sb, sh, st, stream);
  return launch_inter<T, L, 256>(q, k, v, gs, hbuf, h, c, n, b, hh, t, dh,
                                 sb, sh, st, stream);
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

bool mlstm_tc_shape_ok(int64_t dh, int64_t chunk) {
  return (chunk == 64 || chunk == 128) && dh >= 32 && dh <= 512 &&
         dh % 32 == 0;
}

int64_t mlstm_tc_scratch_floats(int64_t b, int64_t hh, int64_t t,
                                int64_t chunk) {
  return b * hh * (kGatePlanes * t + t / chunk);
}

cudaError_t launch_mlstm_chunkwise_tc(
    const void* q, const void* k, const void* v, const float* i,
    const float* f, void* h, float* hbuf, float* c, float* n, float* m,
    float* scratch, int64_t b, int64_t hh, int64_t t, int64_t dh,
    int64_t chunk, int64_t sb, int64_t sh, int64_t st, int64_t gb,
    int64_t gh, int64_t gt, int dtype, cudaStream_t stream) {
  if (!mlstm_tc_shape_ok(dh, chunk) || t % chunk != 0 || t == 0)
    return cudaErrorInvalidValue;
  if (b == 0 || hh == 0) return cudaSuccess;
#define REPRO_TC(TYPE, L)                                                   \
  return launch_tc<TYPE, L>(q, k, v, i, f, h, hbuf, c, n, m, scratch, b,   \
                            hh, t, dh, sb, sh, st, gb, gh, gt, stream)
  if (dtype == kBF16) {
    if (chunk == 64) REPRO_TC(__nv_bfloat16, 64);
    REPRO_TC(__nv_bfloat16, 128);
  }
  if (chunk == 64) REPRO_TC(float, 64);
  REPRO_TC(float, 128);
#undef REPRO_TC
}

}  // namespace repro_torch
