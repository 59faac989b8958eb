// Fair-share solvers of the event engine (repro_torch/net/fairshare.py),
// for sm_90a.
//
// No Pallas kernel stands behind these.  The JAX package compiles each
// solver into one device program (repro/net/fairshare.py):
//   _maxmin_compiled (:191)     one lax.while_loop over bottleneck
//                               levels (_maxmin_fill, :140), then the
//                               truncated tail fill;
//   _transport_compiled (:389)  the whole segment loop in one
//                               lax.while_loop: the nested water-fill,
//                               flow deaths, quantum-batched finish
//                               events and chunk-crossing emission.
// Their counterparts here run one launch a call:
//   fairshare_maxmin     every bottleneck level and the tail fill;
//   fairshare_transport  every segment of the call: solve, the live and
//                        dead masks, ttf, dt = max(tmin, quantum), the
//                        advance, the chunk crossings, the finish
//                        instants and the alive update.
//
// Design.  A call is small: at most a few thousand flows over 2n <= a
// few thousand links.  So a call is one CTA of up to 1024 threads (one
// SM): the link capacities, saturation slacks and unfrozen-flow counts
// of the 2n access links live in dynamic shared memory (42 n + 256
// bytes), a flow's state (residual and delivered bytes, rate, flags) in
// global memory, owned by one thread (flows and links stride over the
// threads), so only the link state is shared.  A fill level is three
// block barriers: after the counts (__syncthreads_or: any flow left
// unfrozen), inside the minimum of cap / count (warp shuffles, then one
// partial a warp in shared memory), and after the capacity update
// (__syncthreads_or: any link saturated, which is the host loop's "any
// flow froze").  Counts are atomicAdds of 1 into shared memory.  A
// segment adds two: the minimum time to finish and the alive test.  A
// cooperative grid would add grid-wide barriers, which is what bounds
// slot_rounds; one SM holds the whole problem.  Chunk ends are written
// where they are crossed: a live flow writes only its ranks (k0, k1] of
// the segment, at chunk_off[f] + rank - 1, so a call writes each of its
// M ends once (the plain torch loop sweeps all M rows every segment).
// What bounds the kernels is the chain of dependent barriers, a few
// hundred nanoseconds each, far above their bytes (a call moves at most
// a few MB; chip_smoke.py states the byte bound).
//
// Bits.  The plain loops (the numpy host loops of net/fairshare.py and
// the torch loop on tensors) round every product, quotient, sum and
// difference on its own.  nvcc contracts a * b - c and a + b / c into
// fused multiply-adds by default, so every such operation here is an
// explicit round-to-nearest intrinsic (__dmul_rn, __dadd_rn, __dsub_rn,
// __ddiv_rn), which nvcc never contracts.  The chunk size and the
// quantum are read from the input buffer and divided by, never turned
// into reciprocals.  A finish instant is formed as the host loop forms
// it, (t + dt) - dt + ttf, and a chunk's lower rank as floor(old / cb +
// 1e-9).  Counts are sums of 1 (exact in any order of the atomics) and
// minima are exact in any order, so rates, finish instants and chunk
// ends are the plain versions' bits.
//
// Watchdog.  Every segment finishes at least the flow with the least
// time to finish (dt >= its ttf) or drops every dead flow, so a call
// runs at most F segments.  The loop stops after max_segments and sets
// the status word; the wrapper raises on it and returns nothing.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEps = 1e-9;          // net/fairshare.py's _EPS

// Per-flow flag bits.
constexpr uint8_t kAlive = 1;          // bytes left, not dead
constexpr uint8_t kOk = 2;             // capacity on both of its links
constexpr uint8_t kUnfrozen = 4;       // ramping in the current fill

// Views of the dynamic shared memory: the per-warp minima, then the
// link state (uplinks 0..n-1, downlinks n..2n-1).
struct Links {
  double* red;
  double* cap;
  double* slack;
  int* cnt;
  uint8_t* sat;
};

__device__ Links carve(int64_t n2) {
  extern __shared__ __align__(16) unsigned char smem[];
  Links s;
  s.red = reinterpret_cast<double*>(smem);
  s.cap = s.red + kMaxWarps;
  s.slack = s.cap + n2;
  s.cnt = reinterpret_cast<int*>(s.slack + n2);
  s.sat = reinterpret_cast<uint8_t*>(s.cnt + n2);
  return s;
}

// The block's minimum of v (one value a thread), in every thread.  One
// barrier: the caller puts another between two calls' reads and writes
// of red (every phase below ends in one).
__device__ double block_min(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmin(v, __shfl_xor_sync(kFull, v, o));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double m = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
    m = fmin(m, red[w]);
  }
  return m;
}

__device__ int64_t up_link(const FairshareIo& io, int64_t i) {
  return static_cast<int64_t>(io.src[i]);
}

__device__ int64_t down_link(const FairshareIo& io, int64_t i) {
  return io.n + static_cast<int64_t>(io.dst[i]);
}

// Progressive filling over the flows whose kAlive and kOk bits are set
// (the host loop's _maxmin_host): one pass a bottleneck level while a
// flow is unfrozen, up to max_passes, the stall guard (no link
// saturated: everything freezes), then the truncated tail's feasible
// min-share fill.  Writes rate[i] for every flow (0 for the others) and
// returns the passes run.  The caller puts a barrier between its last
// read of the link state and this call, which resets it.
__device__ int progressive_fill(const FairshareIo& io, const Links& s,
                                double* rate, uint8_t* flags) {
  const int64_t tid = threadIdx.x, nt = blockDim.x;
  const int64_t n2 = 2 * io.n, f = io.f;
  for (int64_t l = tid; l < n2; l += nt) {
    s.cap[l] = io.cap[l];
    s.cnt[l] = 0;
  }
  __syncthreads();
  int any = 0;
  for (int64_t i = tid; i < f; i += nt) {
    const uint8_t fl = flags[i];
    const bool u = (fl & kAlive) && (fl & kOk);
    flags[i] = u ? (fl | kUnfrozen) : (fl & ~kUnfrozen);
    rate[i] = 0.0;
    if (u) {
      atomicAdd(&s.cnt[up_link(io, i)], 1);
      atomicAdd(&s.cnt[down_link(io, i)], 1);
      any = 1;
    }
  }
  any = __syncthreads_or(any);
  double fill = 0.0;
  int pass = 0;
  for (; pass < io.max_passes && any; ++pass) {
    double m = CUDART_INF;
    for (int64_t l = tid; l < n2; l += nt) {
      const int c = s.cnt[l];
      if (c > 0) m = fmin(m, __ddiv_rn(s.cap[l], static_cast<double>(c)));
    }
    const double t = block_min(m, s.red);
    fill = __dadd_rn(fill, t);
    int anysat = 0;
    for (int64_t l = tid; l < n2; l += nt) {
      const int c = s.cnt[l];
      bool sat = false;
      if (c > 0) {
        const double v =
            __dsub_rn(s.cap[l], __dmul_rn(t, static_cast<double>(c)));
        s.cap[l] = v;
        sat = v <= s.slack[l];
      }
      s.sat[l] = sat;
      s.cnt[l] = 0;
      anysat |= sat;
    }
    // A saturated link carries an unfrozen flow, so "any link
    // saturated" is the host loop's "any flow froze".
    anysat = __syncthreads_or(anysat);
    any = 0;
    for (int64_t i = tid; i < f; i += nt) {
      const uint8_t fl = flags[i];
      if (!(fl & kUnfrozen)) continue;
      const int64_t a = up_link(io, i), b = down_link(io, i);
      if (!anysat || s.sat[a] || s.sat[b]) {
        rate[i] = fill;
        flags[i] = fl & ~kUnfrozen;
      } else {
        atomicAdd(&s.cnt[a], 1);
        atomicAdd(&s.cnt[b], 1);
        any = 1;
      }
    }
    any = __syncthreads_or(any);
  }
  if (any) {
    for (int64_t i = tid; i < f; i += nt) {
      if (!(flags[i] & kUnfrozen)) continue;
      const int64_t a = up_link(io, i), b = down_link(io, i);
      const double su =
          __ddiv_rn(s.cap[a], static_cast<double>(s.cnt[a]));
      const double sd =
          __ddiv_rn(s.cap[b], static_cast<double>(s.cnt[b]));
      rate[i] = __dadd_rn(fill, fmax(fmin(su, sd), 0.0));
    }
  }
  return pass;
}

// The links' saturation slacks: relative, so links of any magnitude
// compare fairly.
__device__ void init_slacks(const FairshareIo& io, const Links& s) {
  const int64_t tid = threadIdx.x, nt = blockDim.x;
  for (int64_t l = tid; l < 2 * io.n; l += nt) {
    s.slack[l] = __dmul_rn(kEps, fmax(io.cap[l], 1.0));
  }
}

// kOk when flow i has capacity on both of its links.
__device__ uint8_t ok_bit(const FairshareIo& io, int64_t i) {
  return io.cap[up_link(io, i)] > kEps && io.cap[down_link(io, i)] > kEps
             ? kOk
             : 0;
}

__global__ void __launch_bounds__(kMaxThreads)
    fairshare_maxmin_kernel(FairshareIo io) {
  const Links s = carve(2 * io.n);
  init_slacks(io, s);
  for (int64_t i = threadIdx.x; i < io.f; i += blockDim.x) {
    io.flags[i] = kAlive | ok_bit(io, i);
  }
  const int passes = progressive_fill(io, s, io.rate, io.flags);
  if (threadIdx.x == 0) io.tail[0] = static_cast<double>(passes);
}

__global__ void __launch_bounds__(kMaxThreads)
    fairshare_transport_kernel(FairshareIo io) {
  const int64_t tid = threadIdx.x, nt = blockDim.x, f = io.f;
  const Links s = carve(2 * io.n);
  init_slacks(io, s);
  const double cb = io.scalars[0];
  const double quantum = io.scalars[1];
  const double eps_cb = __dmul_rn(kEps, cb);
  int any = 0;
  for (int64_t i = tid; i < f; i += nt) {
    const double nb = io.nbytes[i];
    const bool alive = nb > 0.0;
    io.rem[i] = nb;
    io.delivered[i] = 0.0;
    io.finish[i] = alive ? CUDART_INF : 0.0;
    io.flags[i] = (alive ? kAlive : 0) | ok_bit(io, i);
    any |= alive;
  }
  for (int64_t j = tid; j < io.m; j += nt) io.cend[j] = CUDART_INF;
  any = __syncthreads_or(any);
  double t = 0.0;
  int64_t segments = 0, passes = 0;
  int status = 0;
  while (any) {
    if (segments >= io.max_segments) {
      status = 1;
      break;
    }
    passes += progressive_fill(io, s, io.rate, io.flags);
    ++segments;
    double m = CUDART_INF;
    for (int64_t i = tid; i < f; i += nt) {
      const double r = io.rate[i];
      if ((io.flags[i] & kAlive) && r > kEps) {
        m = fmin(m, __ddiv_rn(io.rem[i], r));
      }
    }
    const double tmin = block_min(m, s.red);
    const double dt = isfinite(tmin) ? fmax(tmin, quantum) : 0.0;
    const double t_next = __dadd_rn(t, dt);
    any = 0;
    for (int64_t i = tid; i < f; i += nt) {
      const uint8_t fl = io.flags[i];
      if (!(fl & kAlive)) continue;
      const double r = io.rate[i];
      if (!(r > kEps)) {               // no capacity, ever: never finishes
        io.flags[i] = fl & ~kAlive;
        continue;
      }
      const double rem = io.rem[i];
      const double ttf = __ddiv_rn(rem, r);
      const double adv = fmin(__dmul_rn(r, dt), rem);
      const double old = io.delivered[i];
      const double now = __dadd_rn(old, adv);
      const int64_t k0 = static_cast<int64_t>(
          floor(__dadd_rn(__ddiv_rn(old, cb), kEps)));
      const int64_t k1 = static_cast<int64_t>(
          fmin(floor(__dadd_rn(__ddiv_rn(now, cb), kEps)), io.counts[i]));
      const int64_t base = static_cast<int64_t>(io.chunk_off[i]) - 1;
      for (int64_t k = k0 + 1; k <= k1; ++k) {
        io.cend[base + k] = __dadd_rn(
            t, __ddiv_rn(__dsub_rn(__dmul_rn(static_cast<double>(k), cb),
                                   old),
                         r));
      }
      const double left = __dsub_rn(rem, adv);
      io.rem[i] = left;
      io.delivered[i] = now;
      if (left <= eps_cb) {
        io.finish[i] = __dadd_rn(__dsub_rn(t_next, dt), ttf);
        io.flags[i] = fl & ~kAlive;
      } else {
        any = 1;
      }
    }
    t = t_next;
    any = __syncthreads_or(any);
  }
  if (tid == 0) {
    io.tail[0] = static_cast<double>(segments);
    io.tail[1] = static_cast<double>(status);
    io.tail[2] = static_cast<double>(passes);
  }
}

int threads_for(const FairshareIo& io) {
  const int64_t work = io.f > 2 * io.n ? io.f : 2 * io.n;
  const int64_t t = (work + 31) / 32 * 32;
  return static_cast<int>(t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t));
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const FairshareIo& io,
                   cudaStream_t stream) {
  const int64_t bytes = fairshare_shared_bytes(io.n);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, threads_for(io), bytes, stream>>>(io);
  return cudaGetLastError();
}

}  // namespace

int64_t fairshare_shared_bytes(int64_t n) {
  const int64_t bytes = 8 * kMaxWarps + 2 * n * (8 + 8 + 4 + 1);
  return (bytes + 15) / 16 * 16;
}

int64_t fairshare_max_peers(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  int64_t n = (optin - 8 * kMaxWarps) / 42;
  while (n > 0 && fairshare_shared_bytes(n) > optin) --n;
  return n;
}

cudaError_t launch_fairshare_maxmin(const FairshareIo& io,
                                    cudaStream_t stream) {
  return launch(fairshare_maxmin_kernel, io, stream);
}

cudaError_t launch_fairshare_transport(const FairshareIo& io,
                                       cudaStream_t stream) {
  return launch(fairshare_transport_kernel, io, stream);
}

}  // namespace repro_torch
