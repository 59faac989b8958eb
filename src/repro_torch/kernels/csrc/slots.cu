// Bitplane kernels of the GPU slot engine (repro_torch/core/jit_engine.py),
// for sm_90a.
//
// No TPU kernel stands behind these: the JAX package computes a slot as
// plain lax code over packed uint32 words (repro/core/jit_engine.py::
// _slot_rounds: stage 1 at :358-402, then one lax.while_loop over grant
// rounds at :404-559, with _rank_counts at :462-476 and _extract_ranked
// and the tier merge at :273-320 and :513-536).  torch has no popcount
// op, so the plain versions (kernels/slots.py) spend a dozen SWAR
// launches on every popcount; here __popc does it in one instruction.
//
// A slot is two launches:
//   slot_planes  stage 1, over the chunk-major inventory have_t (one row
//                a chunk, bit v for peer v; rows of n_wp words, n_wp a
//                multiple of 8).  A CTA pairs 256 receivers (8 warps, a
//                32-receiver word of have_t each) with WB output words
//                (32 WB candidates; WB = min(8, W), a 32-byte sector
//                of each plane row: 640 CTAs at n 5000, 64 at n 500,
//                where more, smaller CTAs were slower).  It loads the
//                candidates' cand, owner and allowed once, and the one
//                32-byte sector of each candidate's have_t row that holds
//                its receivers, into shared memory; each warp turns its
//                32 x 32 bit tiles around with a shuffle butterfly (lane
//                l holds candidate l's word, lane r ends with receiver
//                r's word), marks owner cells through a ballot of the
//                lanes whose owner lies in its block, stages its rows'
//                words and stores them as whole sectors.  Counts of a
//                row whose words span CTAs merge through a partial
//                buffer and a self-resetting ticket a group of 256
//                receivers: one launch, nothing reset by the host.
//                The tickets are one array a device: launches on one
//                device must not overlap.
//   slot_rounds  every grant round of the slot in one persistent
//                cooperative launch, as the JAX package's while_loop.  A
//                round moves a few MB at most, so a launch a phase (and
//                a host read a round to stop) would cost more than its
//                work.  A warp owns a receiver row (or a sender) per
//                phase, rows and senders striding over the grid, and
//                grid-wide barriers separate the phases: 2 a round,
//                plus 2 for each of the 3 GFF retries.  A sender's
//                phases walk its in-neighbor list, so the plain loop's
//                global sorts become per-group ranks and need no
//                atomics.  All state stays in device memory (L2 at these
//                sizes); the round's "any pair" flag is one word a
//                round, so nothing is reset between rounds.  The
//                barriers are cooperative_groups' grid.sync().
// overlap_rank and extract_ranked keep their one-CTA-a-row kernels over
// the same per-row bodies (overlap_row, extract_row) that slot_rounds
// runs on a warp, so chip_smoke.py and the tests hold those bodies
// against their plain versions alone.
//
// What bounds them: slot_planes and the two row passes move a few bytes
// per operation (bytes); slot_planes reads the candidates' have_t rows
// (a few MB) and writes the planes (15 MB at n 5000), where a row-major
// inventory made it read a scattered sector per candidate and receiver.
// slot_rounds is bound by its barriers and the latency of its dependent
// phases, far above its bytes.  The bound chip_smoke.py states for each
// is its inputs read once and its outputs written once over 3.35 TB/s.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

#include "kernels.h"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kRankThreads = 128;
constexpr int kMaxSuper = 16;
constexpr int kRoundThreads = 256;
constexpr int kRoundWarps = kRoundThreads / 32;
constexpr int kMaxRoundBlocksPerSm = 2;   // barrier cost grows with CTAs
constexpr int kGffRetries = 3;            // as the batched engine
constexpr unsigned kFull = 0xffffffffu;

// The threads that work on one row: a whole CTA or one warp.
struct CtaGroup {
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};
struct WarpGroup {
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
};

// Stage 1: per (row v, word w), bit b is candidate column c = 32 w + b.
constexpr int kPlaneWarps = 8;             // 32-receiver blocks a CTA
constexpr int kPlaneThreads = kPlaneWarps * 32;
constexpr int kCountBits = 0x3fffffff;     // partial: need count | sup << 30
constexpr int kPlaneGroups = 65535;        // receiver groups: grid.y's limit
constexpr int kPlaneWords = 8;             // output words a CTA (W if less)

// A ticket a group of 256 receivers: static device memory starts at 0,
// and the last CTA of a group to take one puts it back to 0.  One array
// a device, so two slot_planes launches on one device must not overlap
// (the engine launches on one stream, one slot after another).
__device__ int plane_tickets[kPlaneGroups];

// Row `lane` of the transpose of the 32 x 32 bit matrix whose row l is
// lane l's x: bit l of the result is bit `lane` of lane l's x.  Five
// butterfly stages swap off-diagonal blocks of 16, 8, 4, 2 and 1 bits.
__device__ __forceinline__ uint32_t swap_blocks(uint32_t x, int lane, int j,
                                                uint32_t m) {
  const uint32_t y = __shfl_xor_sync(kFull, x, j);
  return (lane & j) ? ((x & ~m) | ((y >> j) & m))
                    : ((x & m) | ((y << j) & ~m));
}

__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  x = swap_blocks(x, lane, 16, 0x0000ffffu);
  x = swap_blocks(x, lane, 8, 0x00ff00ffu);
  x = swap_blocks(x, lane, 4, 0x0f0f0f0fu);
  x = swap_blocks(x, lane, 2, 0x33333333u);
  return swap_blocks(x, lane, 1, 0x55555555u);
}

// Grid (W / WB, ceil(n / 256)): CTA (x, y) builds words [WB x, WB x + WB)
// of receivers [256 y, 256 y + 256).
template <int WB>
__global__ void __launch_bounds__(kPlaneThreads) slot_planes_kernel(
    const uint32_t* __restrict__ have_t, int64_t n_wp,
    const int32_t* __restrict__ cand, const int32_t* __restrict__ owner,
    const bool* __restrict__ allowed, const bool* __restrict__ recv_ok,
    int64_t n, int64_t m_cnt, int64_t w_words, int nonowner, int ungated,
    uint32_t* __restrict__ plane_a, uint32_t* __restrict__ plane_b,
    uint32_t* __restrict__ need, int32_t* __restrict__ need_cnt,
    bool* __restrict__ sup_any, int32_t* __restrict__ partial) {
  constexpr int kCols = 32 * WB;           // candidates a CTA
  constexpr int kStride = WB | 1;          // staged words a row (odd: no
                                           // bank conflict)
  __shared__ uint32_t hv_s[kPlaneWarps][kCols];      // [block][candidate]
  __shared__ int32_t own_s[kCols];                   // owner, -1 for pad
  __shared__ uint8_t allow_s[kCols];
  __shared__ uint32_t out_s[kPlaneWarps][3][32 * kStride];
  __shared__ int last_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * WB;
  const int64_t rb0 = static_cast<int64_t>(blockIdx.y) * kPlaneWarps;

  // 1. A thread a candidate: its metadata, and the sector of its have_t
  // row that holds this CTA's receivers (rb0 + 8 <= n_wp).
  if (tid < kCols) {
    const int64_t c = w0 * 32 + tid;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u);
    uint4 hi = lo;
    int32_t ow = -1;
    bool al = false;
    if (c < m_cnt) {
      const uint4* src = reinterpret_cast<const uint4*>(
          have_t + static_cast<int64_t>(cand[c]) * n_wp + rb0);
      lo = src[0];
      hi = src[1];
      ow = owner[c];
      al = allowed[c];
    }
    own_s[tid] = ow;
    allow_s[tid] = al;
    hv_s[0][tid] = lo.x;
    hv_s[1][tid] = lo.y;
    hv_s[2][tid] = lo.z;
    hv_s[3][tid] = lo.w;
    hv_s[4][tid] = hi.x;
    hv_s[5][tid] = hi.y;
    hv_s[6][tid] = hi.z;
    hv_s[7][tid] = hi.w;
  }
  __syncthreads();

  // 2. A warp a receiver block rb: lane r is receiver v = 32 rb + r.
  const int64_t rb = rb0 + warp;
  const int64_t v = rb * 32 + lane;
  const bool row_ok = v < n;
  const bool rok = row_ok && recv_ok[v];
  int cnt_need = 0;
  int cnt_sup = 0;
  if (rb * 32 < n) {                       // warp-uniform
    uint32_t* st_a = out_s[warp][0];
    uint32_t* st_n = out_s[warp][1];
    uint32_t* st_b = out_s[warp][2];
#pragma unroll
    for (int wl = 0; wl < WB; ++wl) {
      const int cl = wl * 32 + lane;
      const bool valid = (w0 + wl) * 32 + lane < m_cnt;
      const uint32_t hv = transpose32(hv_s[warp][cl], lane);
      const uint32_t vmask = __ballot_sync(kFull, valid);
      const uint32_t alw = __ballot_sync(kFull, allow_s[cl] != 0);
      // owner cells: candidate j's owner is receiver ownr of this block
      const int32_t ow = own_s[cl];
      const int ownr = (ow >= 0 && (ow >> 5) == rb) ? (ow & 31) : -1;
      uint32_t own = 0;
      for (uint32_t hits = __ballot_sync(kFull, ownr >= 0); hits;
           hits &= hits - 1) {
        const int j = __ffs(hits) - 1;
        if (__shfl_sync(kFull, ownr, j) == lane) own |= 1u << j;
      }
      // eligible_supply's owner fix-up: the owner cell of a column serves
      // only while its window is open
      const uint32_t sup = ungated ? hv : ((hv & ~own) | (hv & own & alw));
      const uint32_t nd = rok ? (~hv & vmask) : 0u;
      if (row_ok) {
        cnt_need += __popc(nd);
        cnt_sup += __popc(sup);
      }
      st_a[lane * kStride + wl] = nonowner ? (sup & ~own) : sup;
      st_n[lane * kStride + wl] = nd;
      st_b[lane * kStride + wl] = sup & own;
    }
    __syncwarp();
    // the block's rows, WB contiguous words each
    const int rows = static_cast<int>(n - rb * 32 < 32 ? n - rb * 32 : 32);
    for (int i = lane; i < rows * WB; i += 32) {
      const int r = i / WB;
      const int wl = i % WB;
      const int64_t o = (rb * 32 + r) * w_words + w0 + wl;
      plane_a[o] = st_a[r * kStride + wl];
      need[o] = st_n[r * kStride + wl];
      if (nonowner) plane_b[o] = st_b[r * kStride + wl];
    }
  }

  // 3. The counts.  One CTA a row: write them.  Else each CTA leaves its
  // part, and the last CTA of the receiver group to take a ticket sums
  // the parts and puts the ticket back to 0.
  if (gridDim.x == 1) {
    if (row_ok) {
      need_cnt[v] = cnt_need;
      sup_any[v] = cnt_sup > 0;
    }
    return;
  }
  if (row_ok)
    partial[blockIdx.x * n + v] = cnt_need | (cnt_sup > 0 ? 1 << 30 : 0);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(&plane_tickets[blockIdx.y], 1) ==
             static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last_s) return;
  if (row_ok) {
    int total = 0;
    int any = 0;
    for (unsigned k = 0; k < gridDim.x; ++k) {
      const int p = __ldcg(partial + k * n + v);
      total += p & kCountBits;
      any |= p >> 30;
    }
    need_cnt[v] = total;
    sup_any[v] = any != 0;
  }
  if (tid == 0) plane_tickets[blockIdx.y] = 0;
}

// ---------------------------------------------------------------------
// Per-row bodies, on a CTA (the standalone kernels) or a warp (slot_rounds)
// ---------------------------------------------------------------------

// Adds popc(arow[w] & nrow[w]) into sb[w / per] (shared, zeroed by the
// caller) and returns this thread's part of popc(brow & nrow) over the
// row (0 without has_b).
template <class G>
__device__ int overlap_row(const G& g, const uint32_t* arow,
                           const uint32_t* brow, int has_b,
                           const uint32_t* nrow, int64_t w_words,
                           int64_t per, int* sb) {
  int local_b = 0;
  for (int64_t w = g.rank(); w < w_words; w += g.size()) {
    const uint32_t nd = nrow[w];
    const int c = __popc(arow[w] & nd);
    if (c) atomicAdd(&sb[w / per], c);
    if (has_b) local_b += __popc(brow[w] & nd);
  }
  return local_b;
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

// One row's grant of tk > 0 columns: crow[k] is the k-th set bit of
// arow & nrow for k < ta (cum_a its inclusive superblock cumsum, in
// shared memory), then (with has_b) the (k - ta)-th of brow & nrow for
// k < tk; -1 past the grant.  The picked bits are cleared from nrow once
// every rank of the row has been found.  cum_b is shared scratch of
// `supers` ints, zeroed by the caller, who syncs the group after filling
// both.
template <class G>
__device__ void extract_row(const G& g, const uint32_t* arow,
                            const uint32_t* brow, int has_b, uint32_t* nrow,
                            int tk, int ta, const int* cum_a, int* cum_b,
                            int supers, int64_t per, int64_t t_cap,
                            int32_t* crow) {
  const bool do_b = has_b && tk > ta;
  if (do_b) {
    for (int64_t w = g.rank(); w < supers * per; w += g.size()) {
      const int c = __popc(brow[w] & nrow[w]);
      if (c) atomicAdd(&cum_b[w / per], c);
    }
    g.sync();
    if (g.rank() == 0)
      for (int s = 1; s < supers; ++s) cum_b[s] += cum_b[s - 1];
    g.sync();
  }
  const int tot_a = cum_a[supers - 1];
  const int tot_b = cum_b[supers - 1];
  for (int64_t k = g.rank(); k < t_cap; k += g.size()) {
    int32_t col = -1;
    const int kk = static_cast<int>(k);
    if (kk < ta && kk < tot_a && (!has_b || kk < tk)) {
      col = rank_to_column(arow, nrow, cum_a, supers, per, kk);
    } else if (do_b && kk >= ta && kk < tk && kk - ta < tot_b) {
      col = rank_to_column(brow, nrow, cum_b, supers, per, kk - ta);
    }
    crow[k] = col;
  }
  g.sync();                      // every rank read nrow before a clear
  for (int64_t k = g.rank(); k < t_cap; k += g.size()) {
    const int32_t col = crow[k];
    if (col >= 0) atomicAnd(&nrow[col >> 5], ~(1u << (col & 31)));
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
  const int local_b = overlap_row(
      CtaGroup{}, plane_a + u * w_words, plane_b + u * w_words, has_b,
      need + v * w_words, w_words, w_words / supers, sb);
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

// Per round: cols[v, k] is the k-th set bit of a[u] & need[v] for k < t_a,
// then (with b) the (k - t_a)-th of b[u] & need[v] for k < take; -1 past
// the grant; the picked bits are cleared from need[v].
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
  int32_t* crow = cols + v * t_cap;
  if (tk <= 0) {
    for (int64_t k = threadIdx.x; k < t_cap; k += blockDim.x) crow[k] = -1;
    return;
  }
  const int64_t u = u_c[v];
  if (threadIdx.x < supers) {
    cum_a[threadIdx.x] = sbc[v * supers + threadIdx.x];
    cum_b[threadIdx.x] = 0;
  }
  __syncthreads();
  extract_row(CtaGroup{}, plane_a + u * w_words, plane_b + u * w_words,
              has_b, need + v * w_words, tk, t_a[v], cum_a, cum_b, supers,
              w_words / supers, t_cap, crow);
}

int supers_of(int64_t w_words) {
  return w_words % kMaxSuper == 0 ? kMaxSuper : 1;
}

// ---------------------------------------------------------------------
// slot_rounds: every grant round of a slot in one cooperative launch
// ---------------------------------------------------------------------

struct RoundsParams {
  SlotRoundsIo io;
  int supers;
  int64_t per;
  // working state, carried across rounds
  uint32_t* need;         // (n, W), cleared as grants are extracted
  int32_t* need_cnt;      // (n,)
  int32_t* rem_down;      // (n,)
  int32_t* rem_up;        // (n,), per sender
  int32_t* recv_slots;    // (n,), per sender: tau minus pairs opened
  uint8_t* live;          // (n, d_pad): not tombstoned
  uint8_t* serving;       // (n, d_pad): pair opened in an earlier round
  // per round
  float* score;           // (n, d_pad), GFF: the round's scores
  float* tie;             // (n,), GFF: the retry's tie key, -1 when idle
  int32_t* d_sel;         // (n,), GFF: the retry's pick
  int32_t* u_sel;         // (n,), GFF: its sender
  float* wkey;            // (n,), GFF, per sender: the best tie key
  uint8_t* taken;         // (n,), GFF, per sender: won this round
  int32_t* dv;            // (n,): the paired slot, -1 when unpaired
  int32_t* u_v;           // (n,): the paired sender, -1 when unpaired
  int32_t* sbc;           // (n, supers): overlap cumsum of plane_a
  float* key;             // (n,): the receiver priority
  int32_t* req;           // (n,): the request
  uint8_t* is_new;        // (n,): the pair opens a serve slot
  int32_t* greq;          // (n,): the request after the tau gate
  int32_t* take;          // (n,): the grant
  // control (zeroed by the launcher)
  int32_t* flags;         // (r_max,): round r found a pair
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// mix32(base ^ salt) as a float in [0, 1]: the plain version's uint32 ->
// f32 conversion (round to nearest) times 2^-32.
__device__ __forceinline__ float salted(uint32_t base, uint32_t salt) {
  return __fmul_rn(__uint2float_rn(mix32(base ^ salt)),
                   __int_as_float(0x2f800000));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// First maximum over a warp: the larger value, else the lower index.
__device__ __forceinline__ void warp_argmax(float& best, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// Phase A of a round, row v: feasibility of each neighbor slot, its score
// (GFF: remaining uplink plus noise; else noise) and the first argmax.
// GFF keeps the scores and opens retry 0; the other modes pair at once.
__device__ void row_match(const RoundsParams& p, int64_t v, int r, int lane) {
  const SlotRoundsIo& io = p.io;
  const int64_t dp = io.d_pad;
  const bool needy = p.rem_down[v] > 0 && p.need_cnt[v] > 0;
  const uint32_t salt = static_cast<uint32_t>(r) * 0x9E3779B9u;
  float best = neg_inf();
  int bi = INT_MAX;
  for (int64_t d = lane; d < dp; d += 32) {
    const int64_t o = v * dp + d;
    const int u = io.nbr[o];
    float s = neg_inf();
    if (needy && u >= 0 && p.live[o] && p.rem_up[u] > 0
        && (p.recv_slots[u] > 0 || p.serving[o])) {
      const float noise = salted(io.noise_base[o], salt);
      s = io.mode == 2 ? __fadd_rn(__int2float_rn(p.rem_up[u]), noise)
                       : noise;
    }
    if (io.mode == 2) p.score[o] = s;
    if (bi == INT_MAX || s > best) {
      best = s;
      bi = static_cast<int>(d);
    }
  }
  warp_argmax(best, bi);
  const bool act = best > neg_inf();
  if (lane == 0) {
    if (io.mode == 2) {
      p.d_sel[v] = bi;
      p.tie[v] = act ? salted(io.tie_base[v],
                              static_cast<uint32_t>(r) * 0x85EBCA6Bu)
                     : -1.0f;
      p.u_sel[v] = max(io.nbr[v * dp + bi], 0);
      p.dv[v] = -1;
    } else {
      p.dv[v] = act ? bi : -1;
    }
  }
}

// GFF retry, sender u: the best tie key among the active receivers that
// picked u (equal keys all win); u is taken once anyone won it.
__device__ void sender_pick(const RoundsParams& p, int64_t u, int lane) {
  const SlotRoundsIo& io = p.io;
  float best = -2.0f;
  for (int64_t j = lane; j < io.din_pad; j += 32) {
    const int v = io.in_nbr[u * io.din_pad + j];
    if (v >= 0 && p.u_sel[v] == u) best = fmaxf(best, p.tie[v]);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kFull, best, off));
  if (lane == 0) {
    p.wkey[u] = best;
    if (best >= 0.0f) p.taken[u] = 1;
  }
}

// GFF retry `it`, row v: an active receiver whose key won its sender
// pairs; one that lost re-picks among the senders not yet taken and, if
// one is left, draws its key for retry it + 1.
__device__ void row_retry(const RoundsParams& p, int64_t v, int r, int it,
                          int lane) {
  const SlotRoundsIo& io = p.io;
  const float t = p.tie[v];
  if (!(t >= 0.0f)) return;                       // idle this round
  if (t == p.wkey[p.u_sel[v]]) {
    if (lane == 0) {
      p.dv[v] = p.d_sel[v];
      p.tie[v] = -1.0f;
    }
    return;
  }
  if (it == kGffRetries - 1) return;              // nothing reads past it
  const int64_t dp = io.d_pad;
  float best = neg_inf();
  int bi = INT_MAX;
  for (int64_t d = lane; d < dp; d += 32) {
    const int64_t o = v * dp + d;
    float s = p.score[o];
    if (s > neg_inf() && p.taken[io.nbr[o]]) {
      s = neg_inf();
      p.score[o] = s;
    }
    if (bi == INT_MAX || s > best) {
      best = s;
      bi = static_cast<int>(d);
    }
  }
  warp_argmax(best, bi);
  if (lane == 0) {
    const bool act = best > neg_inf();
    const uint32_t salt = static_cast<uint32_t>(r) * 0x85EBCA6Bu
                          + static_cast<uint32_t>(it + 1) * 0xC2B2AE35u;
    p.d_sel[v] = bi;
    p.tie[v] = act ? salted(io.tie_base[v], salt) : -1.0f;
    p.u_sel[v] = max(io.nbr[v * dp + bi], 0);
  }
}

// Phase B, row v: the overlap of the paired sender's supply with v's
// need (overlap_rank's body), the tombstone of an empty pair, the
// request and the receiver priority.
__device__ void row_request(const RoundsParams& p, int64_t v, int r,
                            int lane, int* sb) {
  const SlotRoundsIo& io = p.io;
  const int d = p.dv[v];
  if (lane == 0) p.take[v] = 0;
  if (d < 0) {
    if (lane == 0) p.u_v[v] = -1;
    return;
  }
  const int64_t w_words = io.w_words;
  const int64_t o = v * io.d_pad + d;
  const int u = io.nbr[o];
  if (lane < p.supers) sb[lane] = 0;
  __syncwarp();
  int cnt_b = overlap_row(WarpGroup{}, io.plane_a + u * w_words,
                          io.plane_b + u * w_words, io.has_b,
                          p.need + v * w_words, w_words, p.per, sb);
  cnt_b = __reduce_add_sync(kFull, cnt_b);
  __syncwarp();
  if (lane == 0) {
    int acc = 0;
    for (int s = 0; s < p.supers; ++s) {
      acc += sb[s];
      p.sbc[v * p.supers + s] = acc;
    }
    const int cnt = acc + (io.has_b ? cnt_b : 0);
    if (cnt == 0) p.live[o] = 0;                 // tombstone
    const int rd = p.rem_down[v];
    const float pn = salted(io.prio_base[v],
                            static_cast<uint32_t>(r) * 0x27D4EB2Fu);
    p.key[v] = io.mode == 1 ? -__fadd_rn(__int2float_rn(rd), pn) : pn;
    p.req[v] = min(min(rd, cnt), io.batch_cap);
    p.is_new[v] = !p.serving[o];
    p.u_v[v] = u;
    p.flags[r] = 1;
  }
  __syncwarp();
}

// A member of sender u's group: an in-neighbor v paired with u.
struct Member {
  int v;
  float key;
  int req;
  bool in;
  bool isn;
};

__device__ __forceinline__ Member member_at(const RoundsParams& p,
                                            int64_t u, int64_t j) {
  Member m{-1, 0.0f, 0, false, false};
  if (j < p.io.din_pad) {
    const int v = p.io.in_nbr[u * p.io.din_pad + j];
    if (v >= 0 && p.u_v[v] == u) {
      m.v = v;
      m.key = p.key[v];
      m.req = p.req[v];
      m.in = true;
      m.isn = p.is_new[v] != 0;
    }
  }
  return m;
}

// Member (key, v) sorts before (mk, mv): ascending priority (-0.0 ==
// +0.0), then receiver id, the order of the plain version's stable sorts.
__device__ __forceinline__ bool before(float k, int v, float mk, int mv) {
  return k < mk || (k == mk && v < mv);
}

// Phase C, sender u: its group's order, the tau gate (only the first
// recv_slots[u] new pairs may open), the uplink split (each grant capped
// at what u has left after the members before it), and u's budgets.
// Member j of the group is lane j % 32 of chunk j / 32; the O(d^2)
// comparisons go through shuffles.
__device__ void sender_split(const RoundsParams& p, int64_t u, int lane) {
  const int64_t din = p.io.din_pad;
  const int slots = p.recv_slots[u];
  const int up = p.rem_up[u];
  for (int64_t c0 = 0; c0 < din; c0 += 32) {
    const Member me = member_at(p, u, c0 + lane);
    int new_rank = 0;
    for (int64_t c1 = 0; c1 < din; c1 += 32) {
      const Member o = member_at(p, u, c1 + lane);
      const bool onew = o.in && o.isn;
      for (int t = 0; t < 32; ++t) {
        const float ok = __shfl_sync(kFull, o.key, t);
        const int ov = __shfl_sync(kFull, o.v, t);
        const bool on = __shfl_sync(kFull, onew ? 1 : 0, t) != 0;
        if (on && before(ok, ov, me.key, me.v)) ++new_rank;
      }
    }
    if (me.in) p.greq[me.v] = (!me.isn || new_rank < slots) ? me.req : 0;
  }
  __syncwarp();
  long long granted = 0;
  int fresh = 0;
  for (int64_t c0 = 0; c0 < din; c0 += 32) {
    const Member me = member_at(p, u, c0 + lane);
    long long excl = 0;
    for (int64_t c1 = 0; c1 < din; c1 += 32) {
      const Member o = member_at(p, u, c1 + lane);
      const int og = o.in ? p.greq[o.v] : 0;
      for (int t = 0; t < 32; ++t) {
        const float ok = __shfl_sync(kFull, o.key, t);
        const int ov = __shfl_sync(kFull, o.v, t);
        const int g = __shfl_sync(kFull, og, t);
        if (g && before(ok, ov, me.key, me.v)) excl += g;
      }
    }
    if (me.in) {
      const long long room = max(static_cast<long long>(up) - excl, 0LL);
      const int tk = static_cast<int>(
          min(static_cast<long long>(p.greq[me.v]), room));
      p.take[me.v] = tk;
      granted += tk;
      fresh += (tk > 0 && me.isn) ? 1 : 0;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    granted += __shfl_xor_sync(kFull, granted, off);
    fresh += __shfl_xor_sync(kFull, fresh, off);
  }
  if (lane == 0) {
    p.rem_up[u] = up - static_cast<int>(granted);
    p.recv_slots[u] = slots - fresh;
    p.taken[u] = 0;
  }
}

// Phase D, row v: the grant's columns (extract_ranked's body, non-owner
// tier first) into round r's row of the grids, and v's budgets.
__device__ void row_grant(const RoundsParams& p, int64_t v, int r, int lane,
                          int* cum_a, int* cum_b) {
  const SlotRoundsIo& io = p.io;
  const int tk = p.take[v];
  const int64_t cell = static_cast<int64_t>(r) * io.n + v;
  int32_t* crow = io.out_col + cell * io.t_cap;
  if (tk <= 0) {
    for (int64_t k = lane; k < io.t_cap; k += 32) crow[k] = -1;
    if (lane == 0) io.out_snd[cell] = -1;
    return;
  }
  const int u = p.u_v[v];
  const int64_t w_words = io.w_words;
  if (lane < p.supers) {
    cum_a[lane] = p.sbc[v * p.supers + lane];
    cum_b[lane] = 0;
  }
  __syncwarp();
  const int ta = io.has_b ? min(tk, cum_a[p.supers - 1]) : tk;
  extract_row(WarpGroup{}, io.plane_a + u * w_words, io.plane_b + u * w_words,
              io.has_b, p.need + v * w_words, tk, ta, cum_a, cum_b, p.supers,
              p.per, io.t_cap, crow);
  if (lane == 0) {
    p.need_cnt[v] -= tk;
    p.rem_down[v] -= tk;
    if (p.is_new[v]) p.serving[v * io.d_pad + p.dv[v]] = 1;
    io.out_snd[cell] = u;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kRoundThreads) slot_rounds_kernel(
    const RoundsParams p) {
  __shared__ int sm[kRoundWarps][2][kMaxSuper];
  const cg::grid_group grid = cg::this_grid();
  const SlotRoundsIo& io = p.io;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  int* cum_a = sm[wib][0];
  int* cum_b = sm[wib][1];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRoundWarps + wib;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kRoundWarps;
  const int64_t n = io.n;
  const int64_t w_words = io.w_words;
  for (int64_t v = first; v < n; v += stride) {
    for (int64_t w = lane; w < w_words; w += 32)
      p.need[v * w_words + w] = io.need[v * w_words + w];
    for (int64_t d = lane; d < io.d_pad; d += 32) {
      const int u = io.nbr[v * io.d_pad + d];
      p.live[v * io.d_pad + d] = u >= 0 && io.sup_any[u];
      p.serving[v * io.d_pad + d] = 0;
    }
    if (lane == 0) {
      p.need_cnt[v] = io.need_cnt[v];
      p.rem_down[v] = io.rem_down[v];
      p.rem_up[v] = io.rem_up[v];
      p.recv_slots[v] = io.tau;
      p.taken[v] = 0;
    }
  }
  grid.sync();
  int r = 0;
  for (; r < io.r_max; ++r) {
    for (int64_t v = first; v < n; v += stride) {
      row_match(p, v, r, lane);
      __syncwarp();
    }
    if (io.mode == 2) {
      for (int it = 0; it < kGffRetries; ++it) {
        grid.sync();
        for (int64_t u = first; u < n; u += stride) sender_pick(p, u, lane);
        grid.sync();
        for (int64_t v = first; v < n; v += stride) {
          row_retry(p, v, r, it, lane);
          __syncwarp();
        }
      }
    }
    for (int64_t v = first; v < n; v += stride) {
      row_request(p, v, r, lane, cum_a);
      __syncwarp();
    }
    grid.sync();
    if (!*static_cast<volatile int32_t*>(p.flags + r)) break;
    for (int64_t u = first; u < n; u += stride) sender_split(p, u, lane);
    grid.sync();
    for (int64_t v = first; v < n; v += stride) {
      row_grant(p, v, r, lane, cum_a, cum_b);
      __syncwarp();
    }
  }
  // r rounds wrote their grants; the round that found no pair counts too
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *io.rounds = r < io.r_max ? r + 1 : io.r_max;
  for (int64_t v = first; v < n; v += stride) {
    for (int rr = r; rr < io.r_max; ++rr) {
      const int64_t cell = static_cast<int64_t>(rr) * n + v;
      for (int64_t k = lane; k < io.t_cap; k += 32)
        io.out_col[cell * io.t_cap + k] = -1;
      if (lane == 0) io.out_snd[cell] = -1;
    }
  }
}

// Carves the scratch words into the working arrays (16-byte aligned);
// with base == nullptr it only counts the words.
struct Carver {
  int32_t* base;
  int64_t words = 0;
  template <class T>
  T* take(int64_t count) {
    T* out = base ? reinterpret_cast<T*>(base + words) : nullptr;
    words += (count * static_cast<int64_t>(sizeof(T)) + 15) / 16 * 4;
    return out;
  }
};

RoundsParams carve(const SlotRoundsIo& io, int32_t* scratch,
                   int64_t* words) {
  Carver c{scratch};
  RoundsParams p;
  p.io = io;
  p.supers = supers_of(io.w_words);
  p.per = io.w_words / p.supers;
  const int64_t n = io.n;
  const int64_t cells = n * io.d_pad;
  p.flags = c.take<int32_t>(io.r_max);
  p.need = c.take<uint32_t>(n * io.w_words);
  p.need_cnt = c.take<int32_t>(n);
  p.rem_down = c.take<int32_t>(n);
  p.rem_up = c.take<int32_t>(n);
  p.recv_slots = c.take<int32_t>(n);
  p.live = c.take<uint8_t>(cells);
  p.serving = c.take<uint8_t>(cells);
  p.score = c.take<float>(io.mode == 2 ? cells : 0);
  p.tie = c.take<float>(n);
  p.d_sel = c.take<int32_t>(n);
  p.u_sel = c.take<int32_t>(n);
  p.wkey = c.take<float>(n);
  p.taken = c.take<uint8_t>(n);
  p.dv = c.take<int32_t>(n);
  p.u_v = c.take<int32_t>(n);
  p.sbc = c.take<int32_t>(n * p.supers);
  p.key = c.take<float>(n);
  p.req = c.take<int32_t>(n);
  p.is_new = c.take<uint8_t>(n);
  p.greq = c.take<int32_t>(n);
  p.take = c.take<int32_t>(n);
  *words = c.words;
  return p;
}

cudaError_t round_grid(int64_t n, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slot_rounds_kernel, kRoundThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t want = (n + kRoundWarps - 1) / kRoundWarps;
  const int64_t room =
      static_cast<int64_t>(sms) * (per_sm < kMaxRoundBlocksPerSm
                                       ? per_sm : kMaxRoundBlocksPerSm);
  *grid = static_cast<int>(want < room ? want : room);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_slot_planes(const int32_t* have_t, int64_t n_wp,
                               const int32_t* cand, const int32_t* owner,
                               const bool* allowed, const bool* recv_ok,
                               int64_t n, int64_t m_cnt, int64_t m_pad,
                               int nonowner, int ungated,
                               int32_t* plane_a, int32_t* plane_b,
                               int32_t* need, int32_t* need_cnt,
                               bool* sup_any, int32_t* partial,
                               cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const int64_t w_words = m_pad / 32;
  const int64_t groups = (n + kPlaneThreads - 1) / kPlaneThreads;
  const int64_t wb = w_words < kPlaneWords ? w_words : kPlaneWords;
  if (groups > kPlaneGroups || wb < 1 || w_words % wb)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(w_words / wb),
                  static_cast<unsigned>(groups));
  auto go = [&](auto kernel) {
    kernel<<<grid, kPlaneThreads, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(have_t), n_wp, cand, owner,
        allowed, recv_ok, n, m_cnt, w_words, nonowner, ungated,
        reinterpret_cast<uint32_t*>(plane_a),
        reinterpret_cast<uint32_t*>(plane_b),
        reinterpret_cast<uint32_t*>(need), need_cnt, sup_any, partial);
    return cudaGetLastError();
  };
  switch (wb) {
    case 1: return go(slot_planes_kernel<1>);
    case 2: return go(slot_planes_kernel<2>);
    case 4: return go(slot_planes_kernel<4>);
    case 8: return go(slot_planes_kernel<8>);
    default: return cudaErrorInvalidValue;
  }
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

int64_t slot_rounds_scratch_words(const SlotRoundsIo& io) {
  int64_t words = 0;
  carve(io, nullptr, &words);
  return words;
}

int slot_rounds_grid(int64_t n) {
  int grid = 0;
  return round_grid(n, &grid) == cudaSuccess ? grid : -1;
}

cudaError_t launch_slot_rounds(const SlotRoundsIo& io, int32_t* scratch,
                               cudaStream_t stream) {
  if (io.n == 0) return cudaSuccess;
  int grid = 0;
  cudaError_t err = round_grid(io.n, &grid);
  if (err != cudaSuccess) return err;
  int64_t words = 0;
  RoundsParams p = carve(io, scratch, &words);
  err = cudaMemsetAsync(scratch, 0,
                        reinterpret_cast<char*>(p.need)
                            - reinterpret_cast<char*>(scratch),
                        stream);          // the round flags
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slot_rounds_kernel), dim3(grid),
      dim3(kRoundThreads), args, 0, stream);
}

}  // namespace repro_torch
