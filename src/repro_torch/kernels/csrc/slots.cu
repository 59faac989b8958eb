// Bitplane kernels of the GPU slot engine (repro_torch/core/jit_engine.py),
// for sm_90a.
//
// No TPU kernel stands behind these: the JAX package computes a slot's
// plane work as plain lax code over packed uint32 words
// (repro/core/jit_engine.py::_slot_rounds, stage 1 at :358-402, the
// per-round _rank_counts at :462-476, _extract_ranked and the tier merge
// at :273-320 and :513-536).  torch has no popcount op, so the plain
// versions (kernels/slots.py) spend a dozen SWAR launches on every
// popcount; here __popc does it in one instruction.
//
// Each kernel is one pass with one CTA per receiver row v and threads
// over the row's W words (W = m_pad / 32, at most a few hundred), so
// nothing needs a second launch or a cross-CTA reduction.  All three are
// bound by bytes (a few operations per word read); the bound
// chip_smoke.py states for each is its inputs read once and its outputs
// written once over 3.35 TB/s, where slot_planes reads only the
// inventory words that hold a candidate column.  Simple first: the
// candidate gather of slot_planes is uncoalesced (a column's word is
// wherever its chunk id puts it), and extract_ranked walks one
// superblock per rank.
#include <cuda_runtime.h>

#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRankThreads = 128;
constexpr int kMaxSuper = 16;

__device__ __forceinline__ int block_sum(int x, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < (blockDim.x + 31) / 32; ++i) total += scratch[i];
  return total;                   // valid in thread 0 only
}

// Stage 1: per (row v, word w), bit b is candidate column c = 32 w + b.
__global__ void __launch_bounds__(kThreads) slot_planes_kernel(
    const uint32_t* __restrict__ have, int64_t w_full,
    const int32_t* __restrict__ cand, const int32_t* __restrict__ owner,
    const bool* __restrict__ allowed, const bool* __restrict__ recv_ok,
    int64_t m_cnt, int64_t w_words, int nonowner, int ungated,
    uint32_t* __restrict__ plane_a, uint32_t* __restrict__ plane_b,
    uint32_t* __restrict__ need, int32_t* __restrict__ need_cnt,
    bool* __restrict__ sup_any) {
  __shared__ int scratch[2][kThreads / 32];
  const int64_t v = blockIdx.x;
  const uint32_t* hrow = have + v * w_full;
  const bool rok = recv_ok[v];
  int cnt_need = 0;
  int cnt_sup = 0;
  for (int64_t w = threadIdx.x; w < w_words; w += blockDim.x) {
    uint32_t hv = 0, own = 0, allow = 0, valid = 0;
    for (int b = 0; b < 32; ++b) {
      const int64_t c = w * 32 + b;
      if (c >= m_cnt) break;
      const uint32_t bit = 1u << b;
      const int32_t cc = cand[c];
      valid |= bit;
      if ((hrow[cc >> 5] >> (cc & 31)) & 1u) hv |= bit;
      if (owner[c] == v) {
        own |= bit;
        if (allowed[c]) allow |= bit;
      }
    }
    // eligible_supply's owner fix-up: the owner cell of a column serves
    // only while its window is open
    const uint32_t sup = ungated ? hv : ((hv & ~own) | (hv & own & allow));
    const uint32_t nd = rok ? (~hv & valid) : 0u;
    const int64_t o = v * w_words + w;
    if (nonowner) {
      plane_a[o] = sup & ~own;
      plane_b[o] = sup & own;
    } else {
      plane_a[o] = sup;
    }
    need[o] = nd;
    cnt_need += __popc(nd);
    cnt_sup += __popc(sup);
  }
  const int total_need = block_sum(cnt_need, scratch[0]);
  const int total_sup = block_sum(cnt_sup, scratch[1]);
  if (threadIdx.x == 0) {
    need_cnt[v] = total_need;
    sup_any[v] = total_sup > 0;
  }
}

// Per round: sbc[v] = inclusive superblock cumsum of popc(a[u] & need[v]),
// cnt_b[v] = popc(b[u] & need[v]) over the row.
__global__ void __launch_bounds__(kThreads) overlap_rank_kernel(
    const uint32_t* __restrict__ plane_a, const uint32_t* __restrict__ plane_b,
    int has_b, const uint32_t* __restrict__ need,
    const int64_t* __restrict__ u_c, int64_t w_words, int supers,
    int32_t* __restrict__ sbc, int32_t* __restrict__ cnt_b) {
  __shared__ int sb[kMaxSuper];
  __shared__ int cb;
  if (threadIdx.x < supers) sb[threadIdx.x] = 0;
  if (threadIdx.x == 0) cb = 0;
  __syncthreads();
  const int64_t v = blockIdx.x;
  const int64_t u = u_c[v];
  const int64_t per = w_words / supers;
  const uint32_t* nrow = need + v * w_words;
  const uint32_t* arow = plane_a + u * w_words;
  const uint32_t* brow = plane_b + u * w_words;
  int local_b = 0;
  for (int64_t w = threadIdx.x; w < w_words; w += blockDim.x) {
    const uint32_t nd = nrow[w];
    const int c = __popc(arow[w] & nd);
    if (c) atomicAdd(&sb[w / per], c);
    if (has_b) local_b += __popc(brow[w] & nd);
  }
  if (local_b) atomicAdd(&cb, local_b);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int s = 0; s < supers; ++s) {
      acc += sb[s];
      sbc[v * supers + s] = acc;
    }
    cnt_b[v] = cb;
  }
}

// Column id of the k-th (0-based) set bit of row & nrow, given the row's
// inclusive superblock cumsum `cum`; k must be below its last entry.
__device__ int32_t rank_to_column(const uint32_t* row, const uint32_t* nrow,
                                  const int* cum, int supers, int64_t per,
                                  int k) {
  int s = 0;
  while (s < supers - 1 && cum[s] <= k) ++s;
  int rest = k - (s > 0 ? cum[s - 1] : 0);
  for (int64_t w = s * per; w < (s + 1) * per; ++w) {
    uint32_t x = row[w] & nrow[w];
    const int c = __popc(x);
    if (rest < c) {
      for (int i = 0; i < rest; ++i) x &= x - 1;   // drop the lower bits
      return static_cast<int32_t>(w * 32 + (__ffs(x) - 1));
    }
    rest -= c;
  }
  return -1;
}

// Per round: cols[v, k] is the k-th set bit of a[u] & need[v] for k < t_a,
// then (with b) the (k - t_a)-th of b[u] & need[v] for k < take; -1 past
// the grant.  The picked bits are cleared from need[v] once every rank of
// the row has been found.
__global__ void __launch_bounds__(kRankThreads) extract_ranked_kernel(
    const uint32_t* __restrict__ plane_a, const uint32_t* __restrict__ plane_b,
    int has_b, uint32_t* __restrict__ need, const int64_t* __restrict__ u_c,
    const int32_t* __restrict__ take, const int32_t* __restrict__ t_a,
    const int32_t* __restrict__ sbc, int64_t w_words, int supers,
    int64_t t_cap, int32_t* __restrict__ cols) {
  __shared__ int cum_a[kMaxSuper];
  __shared__ int cum_b[kMaxSuper];
  const int64_t v = blockIdx.x;
  const int tk = take[v];
  const int ta = t_a[v];
  int32_t* crow = cols + v * t_cap;
  if (tk <= 0) {
    for (int64_t k = threadIdx.x; k < t_cap; k += blockDim.x) crow[k] = -1;
    return;
  }
  const int64_t u = u_c[v];
  const int64_t per = w_words / supers;
  uint32_t* nrow = need + v * w_words;
  const uint32_t* arow = plane_a + u * w_words;
  const uint32_t* brow = plane_b + u * w_words;
  const bool do_b = has_b && tk > ta;
  if (threadIdx.x < supers) {
    cum_a[threadIdx.x] = sbc[v * supers + threadIdx.x];
    cum_b[threadIdx.x] = 0;
  }
  __syncthreads();
  if (do_b) {
    for (int64_t w = threadIdx.x; w < w_words; w += blockDim.x) {
      const int c = __popc(brow[w] & nrow[w]);
      if (c) atomicAdd(&cum_b[w / per], c);
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 1; s < supers; ++s) cum_b[s] += cum_b[s - 1];
    __syncthreads();
  }
  const int tot_a = cum_a[supers - 1];
  const int tot_b = cum_b[supers - 1];
  for (int64_t k = threadIdx.x; k < t_cap; k += blockDim.x) {
    int32_t col = -1;
    const int kk = static_cast<int>(k);
    if (kk < ta && kk < tot_a && (!has_b || kk < tk)) {
      col = rank_to_column(arow, nrow, cum_a, supers, per, kk);
    } else if (do_b && kk >= ta && kk < tk && kk - ta < tot_b) {
      col = rank_to_column(brow, nrow, cum_b, supers, per, kk - ta);
    }
    crow[k] = col;
  }
  __syncthreads();               // every rank read need[v] before a clear
  for (int64_t k = threadIdx.x; k < t_cap; k += blockDim.x) {
    const int32_t col = crow[k];
    if (col >= 0) atomicAnd(&nrow[col >> 5], ~(1u << (col & 31)));
  }
}

int supers_of(int64_t w_words) {
  return w_words % kMaxSuper == 0 ? kMaxSuper : 1;
}

}  // namespace

cudaError_t launch_slot_planes(const int32_t* have, int64_t n,
                               int64_t w_full, const int32_t* cand,
                               const int32_t* owner, const bool* allowed,
                               const bool* recv_ok, int64_t m_cnt,
                               int64_t m_pad, int nonowner, int ungated,
                               int32_t* plane_a, int32_t* plane_b,
                               int32_t* need, int32_t* need_cnt,
                               bool* sup_any, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  slot_planes_kernel<<<static_cast<unsigned>(n), kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(have), w_full, cand, owner, allowed,
      recv_ok, m_cnt, m_pad / 32, nonowner, ungated,
      reinterpret_cast<uint32_t*>(plane_a),
      reinterpret_cast<uint32_t*>(plane_b), reinterpret_cast<uint32_t*>(need),
      need_cnt, sup_any);
  return cudaGetLastError();
}

cudaError_t launch_overlap_rank(const int32_t* plane_a,
                                const int32_t* plane_b, int has_b,
                                const int32_t* need, const int64_t* u_c,
                                int64_t n, int64_t w_words, int32_t* sbc,
                                int32_t* cnt_b, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  overlap_rank_kernel<<<static_cast<unsigned>(n), kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(plane_a),
      reinterpret_cast<const uint32_t*>(plane_b), has_b,
      reinterpret_cast<const uint32_t*>(need), u_c, w_words,
      supers_of(w_words), sbc, cnt_b);
  return cudaGetLastError();
}

cudaError_t launch_extract_ranked(const int32_t* plane_a,
                                  const int32_t* plane_b, int has_b,
                                  int32_t* need, const int64_t* u_c,
                                  const int32_t* take, const int32_t* t_a,
                                  const int32_t* sbc, int64_t n,
                                  int64_t w_words, int64_t t_cap,
                                  int32_t* cols, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  extract_ranked_kernel<<<static_cast<unsigned>(n), kRankThreads, 0,
                          stream>>>(
      reinterpret_cast<const uint32_t*>(plane_a),
      reinterpret_cast<const uint32_t*>(plane_b), has_b,
      reinterpret_cast<uint32_t*>(need), u_c, take, t_a, sbc, w_words,
      supers_of(w_words), t_cap, cols);
  return cudaGetLastError();
}

}  // namespace repro_torch
