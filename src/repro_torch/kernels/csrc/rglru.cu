// RG-LRU gated diagonal linear recurrence, for sm_90a.
//
//     h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * (gx_t * x_t)
//
// Replaces the Pallas TPU kernel repro/kernels/rglru.py::rglru_scan
// (body _rglru_kernel), whose grid runs time innermost so the (block_d,)
// carry persists in VMEM scratch across time blocks.  Blocks on Hopper
// run in parallel and in no order, so nothing carries over between them
// by itself.  Two routes (kernels/rglru.py::route picks one from T):
//
// "seq", rglru_seq_kernel, for short T (decode's T = 1 among them): one
// thread owns one (b, d) channel, carries h in a register and walks
// t = 0 .. T-1; a warp reads 32 neighbouring channels of each time row,
// so every load and store is coalesced.  Its parallelism is B * D and
// no more: at (8, 8192, 2560) that is 20,480 threads, too few bytes in
// flight to stream HBM, so long T takes the other route.
//
// "scan", rglru_scan_kernel, a single-pass chunked scan with decoupled
// look-back.  A tile is (b, kChunk = 64 time rows, kCols = 128
// channels; chunk 128 was no faster at T = 8192 and slower at shorter T
// on one H100, see PERF.md);
// each CTA takes its tile from an atomic ticket in chunk-major order, so
// a tile's predecessor (same b and channels, the chunk before) always
// holds a smaller ticket and is already running: waiting on it cannot
// deadlock.  A CTA
//   1. loads its x, a and gx slabs into shared memory once (16-byte
//      cp.async where rows are whole 16-byte vectors, else element by
//      element), zero beyond T and D;
//   2. runs a local pass from h = 0 in kSubs sub-chunks of rows side by
//      side (two channels a thread), computing the input term once and
//      writing it in place over the x and gx words the thread just read;
//      each sub-chunk leaves its aggregate (A = prod a, H = end state);
//   3. in two warps of 64 channels each: folds the sub-chunks into the
//      tile's aggregate, publishes it behind a flag (chunk 0 publishes
//      its inclusive prefix at once), looks back over predecessors,
//      taking an inclusive prefix where one is published, else folding
//      in the aggregate and going on back, to get h_in (h0 or 0 before
//      chunk 0), and publishes its own inclusive prefix A h_in + H;
//   4. rescans each sub-chunk from shared memory starting at its own
//      h_in, writing y in place over a, and the last chunk writes h_T;
//   5. stores y once with 16-byte stores (element by element on the
//      other path).
// Rows past T are never scanned: a missing row acts as a = 1 with a
// zero input term, as the TPU kernel's padding does.  Channels past D
// are computed on zeros and never stored.  NaN propagates through the
// aggregates as through the sequential loop.
//
// What bounds it: 3 inputs read once and y written once per (b, t, d),
// 6 flops each, so the bytes over the HBM rate: 0.4007 ms at (8, 8192,
// 2560) bf16.  The per-tile status (A, H and the prefix, f32 per
// channel, one flag per 64 channels) is scratch of about 12 bytes a
// channel a tile, read back from L2 by the next tiles; the wrapper
// sizes it from rglru_scan_scratch_bytes and the launcher zeroes its
// flags and ticket counter before each launch.
//
// Arithmetic in f32, built without --use_fast_math (sqrtf is exact).
// Splitting T into chunks and sub-chunks reassociates the recurrence;
// ref.rglru_chunked is the plain mirror of that association.  The scan
// route is not reproducible to the bit from run to run: whether a
// look-back finds its predecessor's inclusive prefix or only its
// aggregate depends on timing, and the two fold in a different order.
// Both ends of that choice are mirrored by ref.rglru_chunked (lookback
// 1 and all the way to chunk 0) and held within 2e-5 of the sequential
// loop; a caller that needs the same bits every run takes the seq route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels.h"

namespace repro_torch {
namespace {

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

__device__ __forceinline__ float input_term(float a, float g, float x) {
  return sqrtf(fmaxf(1.f - a * a, 0.f)) * (g * x);
}

// ---------------------------------------------------------------------
// "seq": one thread per channel
// ---------------------------------------------------------------------

constexpr int kSeqThreads = 64;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kSeqThreads)
    rglru_seq_kernel(const T* __restrict__ x, const T* __restrict__ a,
                     const T* __restrict__ gx, const float* __restrict__ h0,
                     T* __restrict__ y, float* __restrict__ h_last,
                     int64_t t_len, int64_t d) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kSeqThreads + threadIdx.x;
  const int64_t b = blockIdx.y;
  if (j >= d) return;
  float h = h0 == nullptr ? 0.f : h0[b * d + j];
  const int64_t base = b * t_len * d + j;
  int64_t t = 0;
  // the loads of kUnroll steps are issued before the chain consumes them
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
      h = as[u] * h + input_term(as[u], gs[u], xs[u]);
      y[base + (t + u) * d] = from_f32<T>(h);
    }
  }
  for (; t < t_len; ++t) {
    const int64_t o = base + t * d;
    const float av = to_f32(a[o]);
    h = av * h + input_term(av, to_f32(gx[o]), to_f32(x[o]));
    y[o] = from_f32<T>(h);
  }
  h_last[b * d + j] = h;
}

// ---------------------------------------------------------------------
// "scan": chunked, single pass, decoupled look-back
// ---------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kChunk = 64;                      // time rows of a tile
constexpr int kCols = 128;                      // channels of a tile
constexpr int kPairs = kCols / 2;               // threads across a row
constexpr int kSubs = kScanThreads / kPairs;    // sub-chunks side by side
constexpr int kGroups = kPairs / 32;            // look-back warps a tile
enum : uint32_t { kEmpty = 0, kAggregate = 1, kPrefix = 2 };

// The scratch: ticket counter and flags (zeroed per launch), then per
// (tile, group) 32 lanes x {A0, H0, A1, H1} aggregates and 32 lanes x
// {P0, P1} inclusive prefixes.
struct ScanScratch {
  int64_t groups;
  __host__ __device__ int64_t flag_bytes() const {
    return (4 * (groups + 1) + 15) / 16 * 16;
  }
  __host__ __device__ int64_t bytes() const {
    return flag_bytes() + groups * 32 * (16 + 8);
  }
};

int64_t scan_groups(int64_t b, int64_t t, int64_t d) {
  return b * ((t + kChunk - 1) / kChunk) * ((d + kCols - 1) / kCols) *
         kGroups;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// 16 bytes global -> shared; zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// two neighbouring channels
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

template <typename T>
struct ScanShape {
  static constexpr int kSlab = kChunk * kCols;          // elements
  static constexpr int kRows = kChunk / kSubs;          // rows a sub-chunk
  static constexpr size_t kSmem =
      3 * sizeof(T) * kSlab + sizeof(float) * (2 * kSubs * kCols + kCols);
  static_assert(kChunk % kSubs == 0, "sub-chunks must split the chunk");
};

// One (b, rows [t0, t0 + kChunk), channels [d0, d0 + kCols)) slab of
// src into shared memory, zero outside (T, D).
template <typename T, bool kVec>
__device__ __forceinline__ void load_slab(T* dst, const T* __restrict__ src,
                                          int64_t row0, int64_t t0,
                                          int64_t d0, int64_t t_len,
                                          int64_t d) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);                // elements a vector
    constexpr int kRowVecs = kCols / kPer;
    for (int i = threadIdx.x; i < kChunk * kRowVecs; i += kScanThreads) {
      const int r = i / kRowVecs;
      const int c = (i % kRowVecs) * kPer;
      const bool ok = t0 + r < t_len && d0 + c < d;
      const T* s = ok ? src + (row0 + t0 + r) * d + d0 + c : src;
      cp_async16(dst + r * kCols + c, s, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kScanThreads) {
      const int r = i / kCols;
      const int c = i % kCols;
      dst[i] = t0 + r < t_len && d0 + c < d
                   ? src[(row0 + t0 + r) * d + d0 + c]
                   : from_f32<T>(0.f);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kScanThreads)
    rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                      const T* __restrict__ gx, const float* __restrict__ h0,
                      T* __restrict__ y, float* __restrict__ h_last,
                      uint8_t* __restrict__ scratch, int64_t b_len,
                      int64_t t_len, int64_t d) {
  using S = ScanShape<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* as = xs + S::kSlab;
  T* gs = as + S::kSlab;
  float* part_a = reinterpret_cast<float*>(gs + S::kSlab);  // [kSubs][kCols]
  float* part_h = part_a + kSubs * kCols;
  float* h_in = part_h + kSubs * kCols;                     // [kCols]
  __shared__ int64_t s_ticket;

  const int64_t d_tiles = (d + kCols - 1) / kCols;
  const int64_t n_chunks = (t_len + kChunk - 1) / kChunk;
  const int64_t cols = b_len * d_tiles;
  const ScanScratch sc{cols * n_chunks * kGroups};
  uint32_t* flags = reinterpret_cast<uint32_t*>(scratch);   // [0]: ticket
  float4* agg = reinterpret_cast<float4*>(scratch + sc.flag_bytes());
  float2* pref = reinterpret_cast<float2*>(agg + sc.groups * 32);

  if (threadIdx.x == 0) s_ticket = atomicAdd(flags, 1u);
  __syncthreads();
  const int64_t ticket = s_ticket;
  const int64_t chunk = ticket / cols;
  const int64_t b = (ticket % cols) / d_tiles;
  const int64_t d0 = (ticket % d_tiles) * kCols;
  const int64_t t0 = chunk * kChunk;
  const int64_t row0 = b * t_len;

  load_slab<T, kVec>(xs, x, row0, t0, d0, t_len, d);
  load_slab<T, kVec>(as, a, row0, t0, d0, t_len, d);
  load_slab<T, kVec>(gs, gx, row0, t0, d0, t_len, d);
  if constexpr (kVec) {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  const int p = threadIdx.x % kPairs;
  const int s = threadIdx.x / kPairs;
  const int c0 = 2 * p;
  const int n_rows = static_cast<int>(
      t_len - t0 < kChunk ? t_len - t0 : kChunk);
  const int r0 = s * S::kRows;
  const int r1 = r0 + S::kRows < n_rows ? r0 + S::kRows : n_rows;
  // the input term of channel c0 (c0 + 1) goes over the x word (the gx
  // word) of the pair this thread reads: 4 bytes each in bf16; in f32
  // the pair's own 8 bytes of x
  auto inp0 = [&](int r) {
    return reinterpret_cast<float*>(xs + r * kCols + c0);
  };
  auto inp1 = [&](int r) {
    return sizeof(T) == 4 ? inp0(r) + 1
                          : reinterpret_cast<float*>(gs + r * kCols + c0);
  };

  // 2. local pass of the sub-chunk from h = 0
  {
    float2 A = make_float2(1.f, 1.f), H = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float2 av = ld2(as + r * kCols + c0);
      const float2 xv = ld2(xs + r * kCols + c0);
      const float2 gv = ld2(gs + r * kCols + c0);
      const float i0 = input_term(av.x, gv.x, xv.x);
      const float i1 = input_term(av.y, gv.y, xv.y);
      *inp0(r) = i0;
      *inp1(r) = i1;
      H.x = av.x * H.x + i0;
      H.y = av.y * H.y + i1;
      A.x *= av.x;
      A.y *= av.y;
    }
    st2(part_a + s * kCols + c0, A);
    st2(part_h + s * kCols + c0, H);
  }
  __syncthreads();

  // 3. the tile's aggregate, publication and look-back: warps 0 and 1,
  // 64 channels each, every group behind its own flag
  if (s == 0) {
    float2 A = make_float2(1.f, 1.f), H = make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kSubs; ++u) {
      const float2 pa = ld2(part_a + u * kCols + c0);
      const float2 ph = ld2(part_h + u * kCols + c0);
      H = make_float2(pa.x * H.x + ph.x, pa.y * H.y + ph.y);
      A = make_float2(pa.x * A.x, pa.y * A.y);
    }
    const int lane = p % 32;
    const int64_t me = ticket * kGroups + p / 32;
    float2 hin = make_float2(0.f, 0.f);
    if (chunk == 0) {
      if (h0 != nullptr) {
        const int64_t j = d0 + c0;
        if (j < d) hin.x = h0[b * d + j];
        if (j + 1 < d) hin.y = h0[b * d + j + 1];
      }
    } else {
      agg[me * 32 + lane] = make_float4(A.x, H.x, A.y, H.y);
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(flags + 1 + me, kAggregate);
      // walk back: hin = addH + mulA * (prefix of the first tile found)
      float2 mul = make_float2(1.f, 1.f), add = make_float2(0.f, 0.f);
      for (int64_t k = me - cols * kGroups;; k -= cols * kGroups) {
        uint32_t f;
        while ((f = ld_acquire(flags + 1 + k)) == kEmpty) __nanosleep(32);
        if (f == kPrefix) {
          const float2 pv = __ldcg(pref + k * 32 + lane);
          hin = make_float2(mul.x * pv.x + add.x, mul.y * pv.y + add.y);
          break;
        }
        const float4 q = __ldcg(agg + k * 32 + lane);
        add = make_float2(mul.x * q.y + add.x, mul.y * q.w + add.y);
        mul = make_float2(mul.x * q.x, mul.y * q.z);
      }
    }
    if (chunk + 1 < n_chunks) {
      pref[me * 32 + lane] = make_float2(A.x * hin.x + H.x,
                                         A.y * hin.y + H.y);
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(flags + 1 + me, kPrefix);
    }
    st2(h_in + c0, hin);
  }
  __syncthreads();

  // 4. rescan the sub-chunk from its own start state; y over a
  {
    float2 h = ld2(h_in + c0);
    for (int u = 0; u < s; ++u) {
      const float2 pa = ld2(part_a + u * kCols + c0);
      const float2 ph = ld2(part_h + u * kCols + c0);
      h = make_float2(pa.x * h.x + ph.x, pa.y * h.y + ph.y);
    }
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float2 av = ld2(as + r * kCols + c0);
      h.x = av.x * h.x + *inp0(r);
      h.y = av.y * h.y + *inp1(r);
      st2(as + r * kCols + c0, h);
    }
    if (chunk + 1 == n_chunks && r0 < n_rows && r1 == n_rows) {
      const int64_t j = d0 + c0;
      if (j < d) h_last[b * d + j] = h.x;
      if (j + 1 < d) h_last[b * d + j + 1] = h.y;
    }
  }
  __syncthreads();

  // 5. y, stored once
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRowVecs = kCols / kPer;
    for (int i = threadIdx.x; i < kChunk * kRowVecs; i += kScanThreads) {
      const int r = i / kRowVecs;
      const int c = (i % kRowVecs) * kPer;
      if (r < n_rows && d0 + c < d) {
        *reinterpret_cast<uint4*>(y + (row0 + t0 + r) * d + d0 + c) =
            *reinterpret_cast<const uint4*>(as + r * kCols + c);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kCols; i += kScanThreads) {
      const int r = i / kCols;
      const int c = i % kCols;
      if (r < n_rows && d0 + c < d) {
        y[(row0 + t0 + r) * d + d0 + c] = as[i];
      }
    }
  }
}

template <typename T>
cudaError_t launch_seq(const void* x, const void* a, const void* gx,
                       const float* h0, void* y, float* h_last, int64_t b,
                       int64_t t, int64_t d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((d + kSeqThreads - 1) / kSeqThreads),
                  static_cast<unsigned>(b));
  rglru_seq_kernel<T><<<grid, kSeqThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(gx), h0, static_cast<T*>(y), h_last, t, d);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t launch_scan_typed(const void* x, const void* a, const void* gx,
                              const float* h0, void* y, float* h_last,
                              void* scratch, int64_t b, int64_t t, int64_t d,
                              cudaStream_t stream) {
  using S = ScanShape<T>;
  auto kernel = rglru_scan_kernel<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const ScanScratch sc{scan_groups(b, t, d)};
  err = cudaMemsetAsync(scratch, 0, sc.flag_bytes(), stream);
  if (err != cudaSuccess) return err;
  const int64_t tiles = sc.groups / kGroups;
  kernel<<<static_cast<unsigned>(tiles), kScanThreads, S::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(gx), h0, static_cast<T*>(y), h_last,
      static_cast<uint8_t*>(scratch), b, t, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scan(const void* x, const void* a, const void* gx,
                        const float* h0, void* y, float* h_last,
                        void* scratch, int64_t b, int64_t t, int64_t d,
                        cudaStream_t stream) {
  const bool vec =
      (d * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a) |
        reinterpret_cast<uintptr_t>(gx) | reinterpret_cast<uintptr_t>(y)) %
       16) == 0;
  return vec ? launch_scan_typed<T, true>(x, a, gx, h0, y, h_last, scratch,
                                          b, t, d, stream)
             : launch_scan_typed<T, false>(x, a, gx, h0, y, h_last, scratch,
                                           b, t, d, stream);
}

}  // namespace

cudaError_t launch_rglru_scan(const void* x, const void* a, const void* gx,
                              const float* h0, void* y, float* h_last,
                              int64_t b, int64_t t, int64_t d, int dtype,
                              cudaStream_t stream) {
  if (b == 0 || d == 0) return cudaSuccess;
  if (dtype == kBF16) {
    return launch_seq<__nv_bfloat16>(x, a, gx, h0, y, h_last, b, t, d,
                                     stream);
  }
  return launch_seq<float>(x, a, gx, h0, y, h_last, b, t, d, stream);
}

int64_t rglru_scan_scratch_bytes(int64_t b, int64_t t, int64_t d) {
  return ScanScratch{scan_groups(b, t, d)}.bytes();
}

cudaError_t launch_rglru_scan_chunked(const void* x, const void* a,
                                      const void* gx, const float* h0,
                                      void* y, float* h_last, void* scratch,
                                      int64_t b, int64_t t, int64_t d,
                                      int dtype, cudaStream_t stream) {
  if (b == 0 || t == 0 || d == 0) return cudaSuccess;
  if (dtype == kBF16) {
    return launch_scan<__nv_bfloat16>(x, a, gx, h0, y, h_last, scratch, b,
                                      t, d, stream);
  }
  return launch_scan<float>(x, a, gx, h0, y, h_last, scratch, b, t, d,
                            stream);
}

}  // namespace repro_torch
