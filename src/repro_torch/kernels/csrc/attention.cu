// Flash attention forward (causal / sliding window / softcap / GQA /
// cache offsets), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py::
// flash_attention (body _flash_kernel).  The TPU grid is (B, Hq, q
// blocks, kv blocks) with the kv axis innermost and sequential, so the
// running max, denominator and accumulator live in VMEM scratch across
// kv steps, and dead (q, kv) tiles are skipped with pl.when.  On Hopper
// grid blocks run in no order, so a CTA loops over the kv tiles itself
// and keeps m, l and the accumulator on chip; the loop bounds come from
// q_offset, kv_offset, causal, window and Tk, so a dead tile is never
// loaded (the TPU's pl.when skip).  GQA reads KV head h / (Hq / Hkv); K
// and V are never repeated.  The wrapper (attention.py) picks one of
// three routes from the dtype, Tq and D alone:
//
// * wgmma prefill (bf16, Tq > 4, D in {64, 128, 256}): bound by
//   the tensor cores (4 D flops per live (q, k) pair, far above the
//   bytes).  One CTA owns (b, h, 128 q rows): a producer warpgroup (24
//   registers a thread after setmaxnreg; one thread issues TMA) and two
//   consumer warpgroups of 64 rows each (240 registers: at D = 256 the O
//   accumulator alone is 128).  Q, and a two-stage ring of K and V
//   tiles, arrive by TMA through 3-D tensor maps over (D, T, B * H) with
//   128-byte swizzle, so a ragged edge is zero-filled inside its own
//   head; mbarriers hand the stages over (K and V each released as soon
//   as its product is done).  S = Q K^T is wgmma with both operands in
//   shared memory; scale, softcap (accurate tanhf), mask and the online
//   softmax run in the accumulator's registers (row max and sum over the
//   four lanes of a quad); P goes to bf16 in registers as wgmma's A
//   operand against V read transposed (MN-major) from shared memory, and
//   O accumulates in f32.  Inside a warpgroup tile i's Q K^T is issued
//   ahead of tile i - 1's P V, so the softmax of tile i runs while the
//   tensor cores do that P V.  P in bf16 is the one rounding the f32
//   route does not make; l sums the unrounded p.  Causal q tiles run
//   heaviest first.  The TMA maps come from cuTensorMapEncodeTiled
//   through the runtime's driver entry point, so nothing links libcuda.
// * split-KV decode (Tq <= 4, f32 or bf16, every D): bound by the
//   bytes of the live K/V.  The grid is (splits, Hkv * row blocks, B): a
//   CTA reads its key range of one KV head once (cp.async, two stages)
//   and computes every query row of that head's group (group x Tq rows,
//   up to kDecRows a CTA), in f32 on the CUDA cores; it writes f32
//   partials o, m, l, and a second launch (one CTA a row) combines the
//   splits with the max-rescaled sum.  A split with no live key for a
//   row leaves m = -1e30 and l = 0 there, and the combine skips it.  The
//   split plan (the number of splits and their key ranges) is the
//   wrapper's.
// * FMA (f32 prefill, and bf16 prefill at D in {16, 32, 80}): the first
//   kernel of the port, f32 FMA on the CUDA cores with 4 x 4 register
//   tiles for Q K^T and K/V staged in shared memory as f32 (217,088
//   bytes at D = 256, one CTA an SM); it meets the f32 tolerance of
//   3e-5, which bf16 tensor cores on P V would not.
//
// Numerics follow _flash_kernel: s = (q . k) * scale, then
// softcap * tanh(s / softcap), then the mask (k_pos >= 0, k_pos <= q_pos
// when causal, k_pos > q_pos - window); masked scores are -1e30 and
// their p is forced to 0; online softmax in f32; a row with no live key
// gives 0.  Built without --use_fast_math: tanhf (and the FMA and decode
// routes' expf) are the accurate ones.  All offsets are 64-bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;          // FMA route: query rows per CTA
constexpr int kBK = 64;          // FMA route: keys per kv tile
constexpr int kSThreads = 256;   // threads of the 16 x 16 grid of Q K^T
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

      // s = (q . k) * scale, softcapped, in 4 x 4 register tiles
      if (tid < kSThreads && sy < rows) {
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

// ---------------------------------------------------------------------
// wgmma prefill (bf16, D in {64, 128, 256})
// ---------------------------------------------------------------------

constexpr int kWgRows = 128;      // q rows per CTA: two consumer warpgroups
constexpr int kWgThreads = 384;   // consumers 0-255, producer 256-383
constexpr int kPanelCols = 64;    // bf16 columns of one 128-byte TMA box
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgShape {
  static constexpr int kBK = D >= 256 ? 64 : 128;   // keys per K/V tile
  static constexpr int kStages = 2;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kQPanel = kWgRows * 128;     // bytes of a Q panel
  static constexpr int kKPanel = kBK * 128;         // bytes of a K/V panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKPanel;  // one K or V tile
  // 1024 bytes of slack to align the ring to the swizzle atom
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * static_cast<size_t>(kKVBytes);
  static constexpr int kSRegs = kBK / 2;   // S accumulator a thread
  static constexpr int kORegs = D / 2;     // O accumulator a thread
  static_assert(D % kPanelCols == 0, "D must be a multiple of 64");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out, int hq, int hkv,
                       int64_t tq, int64_t tk, int causal, int64_t window,
                       float softcap, int64_t q_offset, int64_t kv_offset,
                       float scale) {
  using namespace hopper;
  using S = WgShape<D>;
  constexpr int kBKt = S::kBK;
  extern __shared__ uint8_t smem_raw[];
  // q; then, for each stage, K full, V full, K empty, V empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * S::kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;
  const uint32_t v_s = k_s + S::kStages * S::kKVBytes;
  const uint32_t q_bar = smem_u32(&bars[0]);
  // the barrier of kind `kind` for stage `st`
  auto bar = [&](int kind, int st) {
    return smem_u32(&bars[1 + kind * S::kStages + st]);
  };
  enum { kFullK = 0, kFullV = 1, kEmptyK = 2, kEmptyV = 3 };

  const int bh = blockIdx.x;                  // b * hq + h
  const int h = bh % hq;
  const int b = bh / hq;
  const int bhk = b * hkv + h / (hq / hkv);
  // heaviest causal q tiles first: blockIdx.y = 0 is the last tile
  const int64_t q0 =
      static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kWgRows;
  const int64_t qlo = q_offset + q0;
  const int64_t qhi = qlo + kWgRows - 1;

  // live key indices j (k_pos = kv_offset + j) for the tile's q rows
  int64_t j_lo = -kv_offset > 0 ? -kv_offset : 0;
  if (window >= 0) {
    const int64_t w_lo = qlo - window + 1 - kv_offset;
    if (w_lo > j_lo) j_lo = w_lo;
  }
  int64_t j_hi = tk - 1;
  if (causal && qhi - kv_offset < j_hi) j_hi = qhi - kv_offset;
  const int64_t t_first = j_lo <= j_hi ? (j_lo / kBKt) * kBKt : 0;
  const int n_tiles =
      j_lo <= j_hi ? static_cast<int>((j_hi - t_first) / kBKt + 1) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(bar(kFullK, st), 1);
      mbar_init(bar(kFullV, st), 1);
      mbar_init(bar(kEmptyK, st), 2 * 128);   // every consumer thread
      mbar_init(bar(kEmptyV, st), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // producer warpgroup: one thread keeps the ring full, K ahead of V
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_bar, S::kQBytes);
#pragma unroll
      for (int p = 0; p < S::kPanels; ++p)
        tma_load_3d(q_s + p * S::kQPanel, &qmap, q_bar, p * kPanelCols,
                    static_cast<int>(q0), bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % S::kStages;
        const uint32_t reuse = ((i / S::kStages) - 1) & 1;
        const int t0 = static_cast<int>(t_first + static_cast<int64_t>(i) *
                                                      kBKt);
        const uint32_t kb = k_s + st * S::kKVBytes;
        const uint32_t vb = v_s + st * S::kKVBytes;
        if (i >= S::kStages) mbar_wait(bar(kEmptyK, st), reuse);
        mbar_expect_tx(bar(kFullK, st), S::kKVBytes);
#pragma unroll
        for (int p = 0; p < S::kPanels; ++p)
          tma_load_3d(kb + p * S::kKPanel, &kmap, bar(kFullK, st),
                      p * kPanelCols, t0, bhk);
        if (i >= S::kStages) mbar_wait(bar(kEmptyV, st), reuse);
        mbar_expect_tx(bar(kFullV, st), S::kKVBytes);
#pragma unroll
        for (int p = 0; p < S::kPanels; ++p)
          tma_load_3d(vb + p * S::kKPanel, &vmap, bar(kFullV, st),
                      p * kPanelCols, t0, bhk);
      }
    }
    return;
  }

  // consumer warpgroups: wg owns q rows [64 wg, 64 wg + 64) of the tile
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int row0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int cb = 2 * (lane % 4);        // first of the thread's column pairs
  // this thread's two rows: row0 and row0 + 8 (accumulator halves 0, 1)
  const int64_t qpos[2] = {qlo + row0, qlo + row0 + 8};
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  float o[S::kORegs];
#pragma unroll
  for (int i = 0; i < S::kORegs; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  uint32_t pa[kBKt / 16][4];   // the previous tile's P, bf16 pairs

  const uint64_t q_desc = sw128_desc(q_s + wg * 64 * 128, 16, 1024);
  // O += P V for tile j (V MN-major), from the bf16 P in pa
  auto issue_pv = [&](int j) {
    const uint64_t v_desc =
        sw128_desc(v_s + (j % S::kStages) * S::kKVBytes, S::kKPanel, 1024);
#pragma unroll
    for (int kk = 0; kk < kBKt / 16; ++kk)
      wgmma_rs(o, pa[kk], v_desc + ((kk * 16 * 128) >> 4));
    wgmma_commit();
  };
  // S = Q K^T for tile i over D in steps of 16 (32 bytes inside a
  // 128-byte panel), committed as one group
  auto issue_s = [&](int i, float (&sc)[S::kSRegs]) {
    const int st = i % S::kStages;
    const uint64_t k_desc = sw128_desc(k_s + st * S::kKVBytes, 16, 1024);
    mbar_wait(bar(kFullK, st), (i / S::kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4;
      const int w = (kk % 4) * 32;
      wgmma_ss(sc, q_desc + ((p * S::kQPanel + w) >> 4),
               k_desc + ((p * S::kKPanel + w) >> 4), kk > 0 ? 1 : 0);
    }
    wgmma_commit();
  };
  // scale, softcap, mask and the online softmax of tile i, all in
  // registers: sc becomes p, m and l move on, alpha rescales O.  The
  // mask is needed only on tiles at the edge of some row's live range.
  auto softmax = [&](int i, float (&sc)[S::kSRegs], float (&alpha)[2]) {
    const int64_t t0 = t_first + static_cast<int64_t>(i) * kBKt;
    const int64_t kp_lo = kv_offset + t0;
    const int64_t kp_hi = kp_lo + kBKt - 1;
    const bool edge = t0 + kBKt > tk || kp_lo < 0 ||
                      (causal && kp_hi > qlo) ||
                      (window >= 0 && kp_lo <= qhi - window);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBKt / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * hh + e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
          if (edge) {
            const int64_t jj = t0 + 8 * j + cb + e;
            const int64_t k_pos = kv_offset + jj;
            bool ok = jj < tk && k_pos >= 0;
            if (causal) ok = ok && k_pos <= qpos[hh];
            if (window >= 0) ok = ok && k_pos > qpos[hh] - window;
            if (!ok) x = -INFINITY;   // p = 0 whatever the running max
          }
          sc[4 * j + 2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      alpha[hh] = exp2f((m[hh] - m_new) * kLog2e);
      const float mb = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBKt / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(sc[4 * j + 2 * hh + e], kLog2e, -mb));
          sc[4 * j + 2 * hh + e] = p;
          sum += p;
        }
      }
      l[hh] = l[hh] * alpha[hh] + sum;   // this thread's columns; summed
      m[hh] = m_new;                     // over the quad at the end
    }
  };
  // P in bf16 pairs, laid out as wgmma's A fragment (the layout of the
  // S accumulator)
  auto pack_p = [&](const float (&sc)[S::kSRegs]) {
#pragma unroll
    for (int kk = 0; kk < kBKt / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  mbar_wait(q_bar, 0);

  if (n_tiles > 0) {   // tile 0: O is still 0
    float sc[S::kSRegs];
    float alpha[2];
    issue_s(0, sc);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(bar(kEmptyK, 0));
    softmax(0, sc, alpha);
    pack_p(sc);
  }
  // Tile i's S = Q K^T is issued first, then tile i - 1's P V behind it
  // on the tensor cores; tile i's softmax runs while that P V does.
  for (int i = 1; i < n_tiles; ++i) {
    float sc[S::kSRegs];
    float alpha[2];
    issue_s(i, sc);
    mbar_wait(bar(kFullV, (i - 1) % S::kStages), ((i - 1) / S::kStages) & 1);
    issue_pv(i - 1);
    wgmma_wait<1>();    // S is done; P V may still run
    fence_regs(sc);
    mbar_arrive(bar(kEmptyK, i % S::kStages));
    softmax(i, sc, alpha);
    wgmma_wait<0>();    // tile i - 1's P V is done: O and pa are free
    fence_regs(o);
    mbar_arrive(bar(kEmptyV, (i - 1) % S::kStages));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    pack_p(sc);
  }
  if (n_tiles > 0) {   // the last tile's P V
    const int j = n_tiles - 1;
    mbar_wait(bar(kFullV, j % S::kStages), (j / S::kStages) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_pv(j);
    wgmma_wait<0>();
    fence_regs(o);
  }

  // O / l, written as bf16 pairs
  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * tq * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / (lt > 0.f ? lt : 1.f);
    const int64_t r = q0 + row0 + 8 * hh;
    if (r < tq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(ob + r * D + 8 * j + cb) = v2;
      }
    }
  }
}

// ---------------------------------------------------------------------
// split-KV decode (Tq <= 4, f32 or bf16, every D)
// ---------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecBK = 32;        // keys per tile: one a lane
constexpr int kDecRows = 16;      // query rows (group x Tq) per CTA
constexpr int kDecWarps = kDecThreads / 32;

template <typename T, int D>
struct DecShape {
  static constexpr int kVec = 16 / sizeof(T);        // elements per 16 B
  static constexpr int kChunks = D / kVec;           // 16-byte chunks a row
  static constexpr int kRowBytes = D * sizeof(T) + 16;   // padded: no
  static constexpr int kTileBytes = kDecBK * kRowBytes;  // bank conflicts
  static constexpr int kD4 = D / 4;
  static constexpr int kPairs = (kDecRows * kD4 + kDecThreads - 1) /
                                kDecThreads;         // (row, float4) a thread
  static constexpr int kSLD = kDecBK + 1;
  // two stages of K and V: at D = 256 in bf16 two CTAs of four warps fit
  // an SM and cover each other's barriers, where a deeper ring would
  // leave one
  static constexpr int kStages = 2;
  static constexpr size_t kSmem =
      2 * kStages * static_cast<size_t>(kTileBytes) +
      sizeof(float) * (kDecRows * D + kDecRows * kSLD + 3 * kDecRows);
  static_assert(D % kVec == 0, "rows must be whole 16-byte chunks");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void chunk_f32(const uint8_t* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void chunk_f32(const uint8_t* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ o_part,
                        float* __restrict__ m_part,
                        float* __restrict__ l_part, int64_t b_all,
                        int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
                        int causal, int64_t window, float softcap,
                        int64_t q_offset, int64_t kv_offset, float scale,
                        int64_t j_lo, int64_t j_hi, int64_t per,
                        int row_blocks) {
  using S = DecShape<T, D>;
  extern __shared__ __align__(16) uint8_t dsmem[];
  uint8_t* kv_s = dsmem;                      // K, V of each stage
  float* qs = reinterpret_cast<float*>(dsmem + 2 * S::kStages *
                                                   S::kTileBytes);
  float* ss = qs + kDecRows * D;              // (kDecRows, kSLD) s, then p
  float* m_s = ss + kDecRows * S::kSLD;
  float* l_s = m_s + kDecRows;
  float* a_s = l_s + kDecRows;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t split = blockIdx.x;
  const int64_t hk = blockIdx.y / row_blocks;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y % row_blocks) *
                     kDecRows;
  const int64_t b = blockIdx.z;
  const int64_t group = hq / hkv;
  const int rows = static_cast<int>(
      group * tq - r0 < kDecRows ? group * tq - r0 : kDecRows);
  const int64_t s_lo = j_lo + split * per;
  const int64_t s_hi = s_lo + per - 1 < j_hi ? s_lo + per - 1 : j_hi;
  const int n_tiles =
      s_lo <= s_hi ? static_cast<int>((s_hi - s_lo) / kDecBK + 1) : 0;

  const T* kb = k + (b * hkv + hk) * tk * D;
  const T* vb = v + (b * hkv + hk) * tk * D;
  // row r of this CTA: query head hk * group + (r0 + r) / tq, query
  // (r0 + r) % tq; its global row index in (B, Hq, Tq)
  auto grow = [&](int r) {
    const int64_t gr = r0 + r;
    return (b * hq + hk * group + gr / tq) * tq + gr % tq;
  };

  for (int i = tid; i < kDecRows * S::kD4; i += kDecThreads) {
    const int r = i / S::kD4;
    const int c = (i - r * S::kD4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = load4(q + grow(r) * D + c);
    store4(qs + r * D + c, x);
  }
  for (int r = tid; r < kDecRows; r += kDecThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // one commit group per tile index, empty past the last tile, so that
  // "all but kStages - 1 groups done" always means tile `it` is in
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const int64_t t0 = s_lo + static_cast<int64_t>(it) * kDecBK;
      const int nk = static_cast<int>(
          s_hi - t0 + 1 < kDecBK ? s_hi - t0 + 1 : kDecBK);
      uint8_t* ks = kv_s + (2 * (it % S::kStages)) * S::kTileBytes;
      uint8_t* vs = ks + S::kTileBytes;
      for (int i = tid; i < nk * S::kChunks; i += kDecThreads) {
        const int r = i / S::kChunks;
        const int c = i - r * S::kChunks;
        const int64_t off = (t0 + r) * D + c * S::kVec;
        cp_async16(ks + r * S::kRowBytes + c * 16, kb + off);
        cp_async16(vs + r * S::kRowBytes + c * 16, vb + off);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float4 acc[S::kPairs];
#pragma unroll
  for (int i = 0; i < S::kPairs; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < S::kStages - 1; ++it) issue(it);
  for (int it = 0; it < n_tiles; ++it) {
    const int64_t t0 = s_lo + static_cast<int64_t>(it) * kDecBK;
    const int nk = static_cast<int>(s_hi - t0 + 1 < kDecBK ? s_hi - t0 + 1
                                                           : kDecBK);
    issue(it + S::kStages - 1);   // into the stage tile it - 1 has freed
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S::kStages - 1)
                 : "memory");
    __syncthreads();   // the tile, q and the row state are in place
    const uint8_t* ks = kv_s + (2 * (it % S::kStages)) * S::kTileBytes;
    const uint8_t* vs = ks + S::kTileBytes;

    // scores: lane = key, warp w takes rows w, w + 4, w + 8, w + 12
    {
      constexpr int kRW = kDecRows / kDecWarps;
      float dot[kRW];
#pragma unroll
      for (int u = 0; u < kRW; ++u) dot[u] = 0.f;
      const uint8_t* krow = ks + lane * S::kRowBytes;
      for (int c = 0; c < S::kChunks; ++c) {
        float kx[S::kVec];
        chunk_f32(krow + c * 16, kx);
#pragma unroll
        for (int u = 0; u < kRW; ++u) {
          if (warp + kDecWarps * u >= rows) break;
          const float* qr = qs + (warp + kDecWarps * u) * D + c * S::kVec;
#pragma unroll
          for (int e = 0; e < S::kVec; e += 4) {
            const float4 q4 = load4(qr + e);
            dot[u] = fmaf(q4.x, kx[e], dot[u]);
            dot[u] = fmaf(q4.y, kx[e + 1], dot[u]);
            dot[u] = fmaf(q4.z, kx[e + 2], dot[u]);
            dot[u] = fmaf(q4.w, kx[e + 3], dot[u]);
          }
        }
      }
      const int64_t jj = t0 + lane;
      const int64_t k_pos = kv_offset + jj;
#pragma unroll
      for (int u = 0; u < kRW; ++u) {
        const int r = warp + kDecWarps * u;
        if (r >= rows) break;
        const int64_t q_pos = q_offset + (r0 + r) % tq;
        float x = dot[u] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = lane < nk && k_pos >= 0;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window >= 0) ok = ok && k_pos > q_pos - window;
        // a masked key gives p = 0 whatever the running max
        float mx = ok ? x : -INFINITY;
        const float sv = mx;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p = expf(sv - m_new);
        ss[r * S::kSLD + lane] = p;
        float sum = p;
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
    }
    __syncthreads();

    // acc = acc * alpha + p V over the tile's nk keys
#pragma unroll
    for (int i = 0; i < S::kPairs; ++i) {
      const int pr = tid + kDecThreads * i;
      if (pr >= rows * S::kD4) break;
      const int r = pr / S::kD4;
      const int c = (pr - r * S::kD4) * 4;
      const float alpha = a_s[r];
      float4 a = acc[i];
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
      const float* prow = ss + r * S::kSLD;
      for (int key = 0; key < nk; ++key) {
        const float pv = prow[key];
        const float4 v4 = load4(reinterpret_cast<const T*>(
                                    vs + key * S::kRowBytes) + c);
        a.x = fmaf(pv, v4.x, a.x);
        a.y = fmaf(pv, v4.y, a.y);
        a.z = fmaf(pv, v4.z, a.z);
        a.w = fmaf(pv, v4.w, a.w);
      }
      acc[i] = a;
    }
    __syncthreads();   // the stage and ss are free for the next tile
  }

  // partials: o (unnormalised), m, l for each of this CTA's rows
  const int64_t nrows = b_all * hq * tq;
#pragma unroll
  for (int i = 0; i < S::kPairs; ++i) {
    const int pr = tid + kDecThreads * i;
    if (pr >= rows * S::kD4) break;
    const int r = pr / S::kD4;
    const int c = (pr - r * S::kD4) * 4;
    store4(o_part + (split * nrows + grow(r)) * D + c, acc[i]);
  }
  for (int r = tid; r < rows; r += kDecThreads) {
    m_part[split * nrows + grow(r)] = m_s[r];
    l_part[split * nrows + grow(r)] = l_s[r];
  }
}

// out[row] = sum_s w_s o_s / sum_s w_s l_s, w_s = exp(m_s - max m) over
// the splits with l_s > 0; 0 where no split has a live key.  One CTA a
// row: the splits' weights are computed once, in parallel, into shared
// memory (`splits` floats of dynamic shared memory).
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_combine(const float* __restrict__ o_part,
                         const float* __restrict__ m_part,
                         const float* __restrict__ l_part,
                         T* __restrict__ out, int64_t nrows, int64_t d,
                         int64_t splits) {
  extern __shared__ float w_s[];
  __shared__ float red[kDecWarps];
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  float mx = kNegInf;
  for (int64_t s = tid; s < splits; s += kDecThreads)
    if (l_part[s * nrows + row] > 0.f)
      mx = fmaxf(mx, m_part[s * nrows + row]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();   // red is reused below
  float l = 0.f;
  for (int64_t s = tid; s < splits; s += kDecThreads) {
    const float ls = l_part[s * nrows + row];
    const float w = ls > 0.f ? expf(m_part[s * nrows + row] - mx) : 0.f;
    w_s[s] = w;
    l += w * ls;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) l += red[w];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int64_t c = tid * 4; c < d; c += 4 * kDecThreads) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t s = 0; s < splits; ++s) {
      const float w = w_s[s];
      if (w == 0.f) continue;
      const float4 o4 = load4(o_part + (s * nrows + row) * d + c);
      a.x = fmaf(w, o4.x, a.x);
      a.y = fmaf(w, o4.y, a.y);
      a.z = fmaf(w, o4.z, a.z);
      a.w = fmaf(w, o4.w, a.w);
    }
    a.x *= inv;
    a.y *= inv;
    a.z *= inv;
    a.w *= inv;
    store4(out + row * d + c, a);
  }
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
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

// A 3-D map over a contiguous (bh, t, d) bf16 tensor, dims innermost
// first, with a (64, rows, 1) box and 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t bh, int64_t t,
                int64_t d, int rows) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t * d) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kPanelCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int64_t b, int64_t hq, int64_t hkv,
                         int64_t tq, int64_t tk, int causal, int64_t window,
                         float softcap, int64_t q_offset, int64_t kv_offset,
                         float scale, cudaStream_t stream) {
  using S = WgShape<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map(&qmap, q, b * hq, tq, D, kWgRows) ||
      !tensor_map(&kmap, k, b * hkv, tk, D, S::kBK) ||
      !tensor_map(&vmap, v, b * hkv, tk, D, S::kBK))
    return cudaErrorNotSupported;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(b * hq),
                  static_cast<unsigned>((tq + kWgRows - 1) / kWgRows));
  kernel<<<grid, kWgThreads, S::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
      static_cast<int>(hq), static_cast<int>(hkv), tq, tk, causal, window,
      softcap, q_offset, kv_offset, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          void* out, float* o_part, float* m_part,
                          float* l_part, int64_t b, int64_t hq, int64_t hkv,
                          int64_t tq, int64_t tk, int causal, int64_t window,
                          float softcap, int64_t q_offset, int64_t kv_offset,
                          float scale, int64_t j_lo, int64_t j_hi,
                          int64_t per, int64_t splits, cudaStream_t stream) {
  using S = DecShape<T, D>;
  auto kernel = flash_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const int64_t row_blocks = decode_row_blocks(hq, hkv, tq);
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>(hkv * row_blocks),
                  static_cast<unsigned>(b));
  kernel<<<grid, kDecThreads, S::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o_part, m_part, l_part, b, hq, hkv, tq, tk,
      causal, window, softcap, q_offset, kv_offset, scale, j_lo, j_hi, per,
      static_cast<int>(row_blocks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t nrows = b * hq * tq;
  flash_decode_combine<T>
      <<<static_cast<unsigned>(nrows), kDecThreads,
         static_cast<size_t>(splits) * sizeof(float), stream>>>(
          o_part, m_part, l_part, static_cast<T*>(out), nrows, D, splits);
  return cudaGetLastError();
}

#define REPRO_HEAD_DIMS(CASE) \
  CASE(16) CASE(32) CASE(64) CASE(80) CASE(128) CASE(256)

}  // namespace

bool flash_attention_head_dim_ok(int64_t d) {
  return d == 16 || d == 32 || d == 64 || d == 80 || d == 128 || d == 256;
}

bool flash_wgmma_head_dim_ok(int64_t d) {
  return d == 64 || d == 128 || d == 256;
}

int64_t decode_row_blocks(int64_t hq, int64_t hkv, int64_t tq) {
  return ((hq / hkv) * tq + kDecRows - 1) / kDecRows;
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
#define REPRO_FMA_CASE(DIM)                                                 \
  case DIM:                                                                 \
    return dtype == kBF16                                                   \
               ? launch_fma<__nv_bfloat16, DIM>(                            \
                     q, k, v, out, b, hq, hkv, tq, tk, causal, window,      \
                     softcap, q_offset, kv_offset, scale, stream)           \
               : launch_fma<float, DIM>(q, k, v, out, b, hq, hkv, tq, tk,   \
                                        causal, window, softcap, q_offset,  \
                                        kv_offset, scale, stream);
  switch (d) {
    REPRO_HEAD_DIMS(REPRO_FMA_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FMA_CASE
}

cudaError_t launch_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* out, int64_t b,
    int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d, int causal,
    int64_t window, float softcap, int64_t q_offset, int64_t kv_offset,
    float scale, cudaStream_t stream) {
  if (b == 0 || hq == 0 || tq == 0) return cudaSuccess;
  switch (d) {
    case 64:
      return launch_wgmma<64>(q, k, v, out, b, hq, hkv, tq, tk, causal,
                              window, softcap, q_offset, kv_offset, scale,
                              stream);
    case 128:
      return launch_wgmma<128>(q, k, v, out, b, hq, hkv, tq, tk, causal,
                               window, softcap, q_offset, kv_offset, scale,
                               stream);
    case 256:
      return launch_wgmma<256>(q, k, v, out, b, hq, hkv, tq, tk, causal,
                               window, softcap, q_offset, kv_offset, scale,
                               stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_flash_decode(
    const void* q, const void* k, const void* v, void* out, float* o_part,
    float* m_part, float* l_part, int64_t b, int64_t hq, int64_t hkv,
    int64_t tq, int64_t tk, int64_t d, int causal, int64_t window,
    float softcap, int64_t q_offset, int64_t kv_offset, float scale,
    int64_t j_lo, int64_t j_hi, int64_t per, int64_t splits, int dtype,
    cudaStream_t stream) {
  if (b == 0 || hq == 0 || tq == 0) return cudaSuccess;
#define REPRO_DEC_CASE(DIM)                                                  \
  case DIM:                                                                  \
    return dtype == kBF16                                                    \
               ? launch_decode<__nv_bfloat16, DIM>(                          \
                     q, k, v, out, o_part, m_part, l_part, b, hq, hkv, tq,   \
                     tk, causal, window, softcap, q_offset, kv_offset,       \
                     scale, j_lo, j_hi, per, splits, stream)                 \
               : launch_decode<float, DIM>(                                  \
                     q, k, v, out, o_part, m_part, l_part, b, hq, hkv, tq,   \
                     tk, causal, window, softcap, q_offset, kv_offset,       \
                     scale, j_lo, j_hi, per, splits, stream);
  switch (d) {
    REPRO_HEAD_DIMS(REPRO_DEC_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DEC_CASE
}

}  // namespace repro_torch
