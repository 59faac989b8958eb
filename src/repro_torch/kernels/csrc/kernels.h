// Launchers for the hand-written Hopper kernels of repro_torch.kernels.
//
// The .cu files include no PyTorch header, so nvcc compiles them in
// seconds; bindings.cpp is the one file that sees torch/extension.h.
// Every launcher enqueues on the stream it is given, allocates nothing
// and does not synchronise; the binding checks cudaGetLastError()
// right after it returns.  The Python wrappers check every tensor's
// device, dtype, shape and contiguity before a launcher is reached.
// All element offsets are 64-bit: on the federated train step at full
// width a (P, D) buffer holds more than 2^31 elements.
#pragma once

#include <cstdint>

#include <cuda_runtime_api.h>

namespace repro_torch {

// Element types a kernel reads or writes besides its fixed-type inputs.
enum DtypeCode : int { kF32 = 0, kBF16 = 1 };

// out[j] = sum_u (wn[u] > 0 ? wn[u] * updates[u, j] : 0), accumulated in
// f32; updates (n, d) and out (d,) share `dtype`, wn is (n,) f32.
void launch_fedavg_reduce(const void* updates, const float* wn, void* out,
                          int64_t n, int64_t d, int dtype,
                          cudaStream_t stream);

// Blocks the quantize kernels give each row of an (n, e) input: the
// x-extent of their grids and the row length of the `partial` scratch.
int64_t chunk_tiles(int64_t n, int64_t e);

// Per row of x (n, e) f32: scale = amax > 0 ? amax / 127 : 1, and
// q = clip(rint(x / scale), -127, 127) as int8.  `partial` is
// (n, chunk_tiles(n, e)) f32 scratch for the first pass.
void launch_chunk_quantize(const float* x, int8_t* q, float* scale,
                           float* partial, int64_t n, int64_t e,
                           cudaStream_t stream);

// out[r, j] = float(q[r, j]) * scale[r], written as `dtype`.
void launch_chunk_dequantize(const int8_t* q, const float* scale,
                             void* out, int64_t n, int64_t e, int dtype,
                             cudaStream_t stream);

// Flash attention forward.  q (b, hq, tq, d), k and v (b, hkv, tk, d) and
// out (b, hq, tq, d) are contiguous and share `dtype`; hq % hkv == 0 and
// d is one of flash_attention_head_dim_ok's.  window < 0 means none and
// softcap <= 0 means none.  Each launcher returns the error of its
// attribute call or of its launch (cudaGetLastError), which the caller
// must check.  The wrapper picks the route:
//   launch_flash_attention: f32 FMA on the CUDA cores, any dtype and d;
//   launch_flash_attention_wgmma: bf16 on the tensor cores, d one of
//     flash_wgmma_head_dim_ok's; q, k, v 16-byte aligned (TMA);
//   launch_flash_decode: split-KV for a few query rows, any dtype and d.
//     Split s covers keys [j_lo + s * per, min(j_lo + (s + 1) * per - 1,
//     j_hi)], 1 <= splits <= 12288 (the combine keeps a weight a split
//     in shared memory); o_part (splits, b * hq * tq, d), m_part and
//     l_part (splits, b * hq * tq) are f32 scratch; the grid's y-extent
//     is hkv * decode_row_blocks(hq, hkv, tq), at most 65535.
bool flash_attention_head_dim_ok(int64_t d);
bool flash_wgmma_head_dim_ok(int64_t d);
int64_t decode_row_blocks(int64_t hq, int64_t hkv, int64_t tq);
cudaError_t launch_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int64_t b,
                                   int64_t hq, int64_t hkv, int64_t tq,
                                   int64_t tk, int64_t d, int causal,
                                   int64_t window, float softcap,
                                   int64_t q_offset, int64_t kv_offset,
                                   float scale, int dtype,
                                   cudaStream_t stream);
cudaError_t launch_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* out, int64_t b,
    int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d, int causal,
    int64_t window, float softcap, int64_t q_offset, int64_t kv_offset,
    float scale, cudaStream_t stream);
cudaError_t launch_flash_decode(
    const void* q, const void* k, const void* v, void* out, float* o_part,
    float* m_part, float* l_part, int64_t b, int64_t hq, int64_t hkv,
    int64_t tq, int64_t tk, int64_t d, int causal, int64_t window,
    float softcap, int64_t q_offset, int64_t kv_offset, float scale,
    int64_t j_lo, int64_t j_hi, int64_t per, int64_t splits, int dtype,
    cudaStream_t stream);

// RG-LRU scan over x, a, gx (b, t, d) of `dtype`, contiguous: y (b, t, d)
// of `dtype` and h_last (b, d) f32, from h0 (b, d) f32 or zeros when h0
// is null.  Each returns the error of its attribute call, memset or
// launch (cudaGetLastError).  Two routes:
//   launch_rglru_scan: "seq", one thread per channel walks all of T;
//   launch_rglru_scan_chunked: "scan", one CTA per (b, chunk of T, 128
//     channels) with decoupled look-back, chunks of 64; `scratch`
//     holds rglru_scan_scratch_bytes(b, t, d) bytes, 16-byte
//     aligned, which the launcher partly zeroes on the stream first.
cudaError_t launch_rglru_scan(const void* x, const void* a, const void* gx,
                              const float* h0, void* y, float* h_last,
                              int64_t b, int64_t t, int64_t d, int dtype,
                              cudaStream_t stream);
int64_t rglru_scan_scratch_bytes(int64_t b, int64_t t, int64_t d);
cudaError_t launch_rglru_scan_chunked(const void* x, const void* a,
                                      const void* gx, const float* h0,
                                      void* y, float* h_last, void* scratch,
                                      int64_t b, int64_t t, int64_t d,
                                      int dtype, cudaStream_t stream);

// Chunkwise mLSTM from a zero state (C = 0, n = 0, m = -1e30).  q, k, v
// and h (b, hh, t, dh) of `dtype` are addressed through the element
// strides (sb, sh, st) with a unit dh stride; i and f (b, hh, t) f32
// through (gb, gh, gt).  Writes h, and C (b, hh, dh, dh), n (b, hh, dh)
// and m (b, hh) f32, contiguous.  t must be a multiple of chunk, and
// (dh, chunk) must pass mlstm_chunkwise_shape_ok.  Returns the error of
// the attribute call or of the launch (cudaGetLastError).
constexpr int kMaxMlstmChunk = 128;
bool mlstm_chunkwise_shape_ok(int64_t dh, int64_t chunk);
cudaError_t launch_mlstm_chunkwise(const void* q, const void* k,
                                   const void* v, const float* i,
                                   const float* f, void* h, float* c,
                                   float* n, float* m, int64_t b, int64_t hh,
                                   int64_t t, int64_t dh, int64_t chunk,
                                   int64_t sb, int64_t sh, int64_t st,
                                   int64_t gb, int64_t gh, int64_t gt,
                                   int dtype, cudaStream_t stream);


// The tensor-core route of the same function (3xTF32 wgmma, three
// launches: gates, intra-chunk, inter-chunk).  dtype f32 or bf16; chunk
// 64 or 128 and dh a multiple of 32 from 32 to 512
// (mlstm_tc_shape_ok); q, k, v and hbuf 16-byte aligned, their strides
// multiples of 16 bytes (TMA).  `hbuf` is f32 with h's
// strides: h itself when h is f32, else scratch; `scratch` holds
// mlstm_tc_scratch_floats(b, hh, t, chunk) floats.  Writes h, C, n, m
// as launch_mlstm_chunkwise does and returns the first launch error.
bool mlstm_tc_shape_ok(int64_t dh, int64_t chunk);
int64_t mlstm_tc_scratch_floats(int64_t b, int64_t hh, int64_t t,
                                int64_t chunk);
cudaError_t launch_mlstm_chunkwise_tc(
    const void* q, const void* k, const void* v, const float* i,
    const float* f, void* h, float* hbuf, float* c, float* n, float* m,
    float* scratch, int64_t b, int64_t hh, int64_t t, int64_t dh,
    int64_t chunk, int64_t sb, int64_t sh, int64_t st, int64_t gb,
    int64_t gh, int64_t gt, int dtype, cudaStream_t stream);

// The GPU slot engine's bitplane kernels (slots.cu).  Words are the
// uint32 bit patterns of int32 tensors; planes are (n, W) contiguous,
// W = m_pad / 32, and u_c (n,) int64 indexes their rows.  Each of the
// first three returns the error of its launch (cudaGetLastError); a
// slot runs slot_planes and then slot_rounds, and overlap_rank and
// extract_ranked run alone the row bodies slot_rounds runs a round.
//   launch_slot_planes: have_t (universe, n_wp) chunk-major (bit v & 31
//     of word v >> 5 of row c: peer v holds chunk c; n_wp a multiple of
//     8, the rows 16-byte aligned); cand, owner (m_pad,) int32; allowed
//     (m_pad,), recv_ok (n,) bool.  A CTA builds WB = min(8, W) words
//     of 256 rows.  Writes plane_a (and, when nonowner, plane_b), need,
//     need_cnt (n,) int32 and sup_any (n,).  partial holds (W / WB, n)
//     int32 scratch words when that is above 1.  At most 65,535 x 256
//     rows, and W a power of two below 8 or a multiple of 8; returns
//     cudaErrorInvalidValue otherwise.  Rows whose words span CTAs
//     merge their counts through tickets in static device memory, one
//     array a device: launches on one device must not overlap in time
//     (one stream, as the engine launches them).
//   launch_overlap_rank: sbc (n, S) int32, the inclusive superblock
//     cumsum of popc(plane_a[u_c] & need) (S = 16 when W % 16 == 0,
//     else 1), and cnt_b (n,) int32, popc(plane_b[u_c] & need) (0
//     without has_b).
//   launch_extract_ranked: cols (n, t_cap) int32, the first t_a set bits
//     of plane_a[u_c] & need (sbc its cumsum), then up to take of
//     plane_b[u_c] & need, -1 past; clears them from need.  Needs
//     0 <= t_a <= take <= t_cap.
cudaError_t launch_slot_planes(const int32_t* have_t, int64_t n_wp,
                               const int32_t* cand, const int32_t* owner,
                               const bool* allowed, const bool* recv_ok,
                               int64_t n, int64_t m_cnt, int64_t m_pad,
                               int nonowner, int ungated,
                               int32_t* plane_a, int32_t* plane_b,
                               int32_t* need, int32_t* need_cnt,
                               bool* sup_any, int32_t* partial,
                               cudaStream_t stream);
cudaError_t launch_overlap_rank(const int32_t* plane_a,
                                const int32_t* plane_b, int has_b,
                                const int32_t* need, const int64_t* u_c,
                                int64_t n, int64_t w_words, int32_t* sbc,
                                int32_t* cnt_b, cudaStream_t stream);
cudaError_t launch_extract_ranked(const int32_t* plane_a,
                                  const int32_t* plane_b, int has_b,
                                  int32_t* need, const int64_t* u_c,
                                  const int32_t* take, const int32_t* t_a,
                                  const int32_t* sbc, int64_t n,
                                  int64_t w_words, int64_t t_cap,
                                  int32_t* cols, cudaStream_t stream);

// launch_slot_rounds: every grant round of a slot in one cooperative
// launch.  Reads the planes of launch_slot_planes (plane_b == plane_a
// when !has_b), need_cnt and sup_any; nbr (n, d_pad) and in_nbr (n,
// din_pad) int32 neighbor lists, -1 pad (in_nbr[u] lists the rows v with
// u in nbr[v]); rem_up, rem_down (n,) int32; the noise (n, d_pad), tie
// and prio (n,) bases.  mode 0 random FIFO, 1 random fastest first, 2
// greedy fastest first.  Writes out_snd (r_max, n), out_col (r_max, n,
// t_cap) int32 and rounds (1,) int32, and changes none of its inputs.
// `scratch` holds slot_rounds_scratch_words(io) int32 words (from n,
// w_words, d_pad, r_max and mode), 16-byte
// aligned; the launcher zeroes its head on the stream first.  Returns
// cudaErrorNotSupported where the device has no cooperative launch, else
// the error of the occupancy query, the memset or the launch.
// slot_rounds_grid(n) is the CTA count of a launch (-1 on error).
struct SlotRoundsIo {
  const uint32_t* plane_a;
  const uint32_t* plane_b;
  const uint32_t* need;
  const int32_t* need_cnt;
  const bool* sup_any;
  const int32_t* nbr;
  const int32_t* in_nbr;
  const int32_t* rem_up;
  const int32_t* rem_down;
  const uint32_t* noise_base;
  const uint32_t* tie_base;
  const uint32_t* prio_base;
  int32_t* out_snd;
  int32_t* out_col;
  int32_t* rounds;
  int64_t n, w_words, d_pad, din_pad, t_cap;
  int has_b, mode, r_max, batch_cap, tau;
};
int64_t slot_rounds_scratch_words(const SlotRoundsIo& io);
int slot_rounds_grid(int64_t n);
cudaError_t launch_slot_rounds(const SlotRoundsIo& io, int32_t* scratch,
                               cudaStream_t stream);

// The event engine's fair-share solvers (fairshare.cu), one CTA a call.
// Integer fields arrive as exact doubles in the packed input buffer:
// cap (2n,) the uplinks then the downlinks; src, dst (f,) peer ids.
//   launch_fairshare_maxmin: rate (f,) the max-min rates after at most
//     max_passes bottleneck levels and the tail fill; tail[0] the passes.
//     flags (f,) is scratch.
//   launch_fairshare_transport: also counts, chunk_off, nbytes (f,) and
//     scalars (chunk_bytes, quantum); writes finish (f,), cend (m,), the
//     end of chunk rank k of flow i at chunk_off[i] + k - 1 (inf where
//     never crossed), and tail = (segments, status, passes): status 1
//     when flows were still alive after max_segments segments.  rate,
//     rem, delivered (f,) and flags (f,) are scratch.
// Both return cudaErrorInvalidValue when the 2n links' shared memory,
// fairshare_shared_bytes(n), exceeds the device's opt-in limit;
// fairshare_max_peers(device) is the largest n that fits there (-1 on
// error).
struct FairshareIo {
  const double* cap;
  const double* src;
  const double* dst;
  const double* counts;
  const double* chunk_off;
  const double* nbytes;
  const double* scalars;
  double* rate;
  double* rem;
  double* delivered;
  uint8_t* flags;
  double* finish;
  double* cend;
  double* tail;
  int64_t n, f, m, max_segments;
  int max_passes;
};
int64_t fairshare_shared_bytes(int64_t n);
int64_t fairshare_max_peers(int device);
cudaError_t launch_fairshare_maxmin(const FairshareIo& io,
                                    cudaStream_t stream);
cudaError_t launch_fairshare_transport(const FairshareIo& io,
                                       cudaStream_t stream);

}  // namespace repro_torch
