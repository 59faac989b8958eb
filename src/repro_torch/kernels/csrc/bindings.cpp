// PyTorch bindings for the launchers in kernels.h.
//
// The only source that includes torch/extension.h.  It is called only
// by the wrappers in fedavg.py, quantize.py, attention.py, rglru.py,
// mlstm.py and slots.py,
// which check device, dtype, shape, contiguity and alignment and
// allocate every output and scratch tensor with torch.empty; the typed
// data_ptr<T>() calls below still refuse a tensor of another dtype.  Each entry point launches on
// PyTorch's current stream of the tensors' device and checks the launch
// right after it.
#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include "kernels.h"

namespace {

int dtype_code(const at::Tensor& t) {
  return t.scalar_type() == at::kBFloat16 ? repro_torch::kBF16
                                          : repro_torch::kF32;
}

void fedavg_reduce(const at::Tensor& updates, const at::Tensor& wn,
                   const at::Tensor& out) {
  const c10::cuda::CUDAGuard guard(updates.device());
  repro_torch::launch_fedavg_reduce(
      updates.data_ptr(), wn.data_ptr<float>(), out.data_ptr(),
      updates.size(0), updates.size(1), dtype_code(updates),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void chunk_quantize(const at::Tensor& x, const at::Tensor& q,
                    const at::Tensor& scale, const at::Tensor& partial) {
  const int64_t n = x.size(0);
  const int64_t e = x.size(1);
  TORCH_CHECK(partial.numel() == n * repro_torch::chunk_tiles(n, e),
              "partial must hold n * chunk_tiles(n, E) floats");
  const c10::cuda::CUDAGuard guard(x.device());
  repro_torch::launch_chunk_quantize(
      x.data_ptr<float>(), q.data_ptr<int8_t>(), scale.data_ptr<float>(),
      partial.data_ptr<float>(), n, e,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void chunk_dequantize(const at::Tensor& q, const at::Tensor& scale,
                      const at::Tensor& out) {
  const c10::cuda::CUDAGuard guard(q.device());
  repro_torch::launch_chunk_dequantize(
      q.data_ptr<int8_t>(), scale.data_ptr<float>(), out.data_ptr(),
      q.size(0), q.size(1), dtype_code(out),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void check_launch(cudaError_t err, const char* what) {
  TORCH_CHECK(err == cudaSuccess, what, ": ", cudaGetErrorString(err));
}

void flash_attention(const at::Tensor& q, const at::Tensor& k,
                     const at::Tensor& v, const at::Tensor& out,
                     bool causal, int64_t window, double softcap,
                     int64_t q_offset, int64_t kv_offset, double scale) {
  TORCH_CHECK(repro_torch::flash_attention_head_dim_ok(q.size(3)),
              "flash_attention: unsupported head dim ", q.size(3));
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(repro_torch::launch_flash_attention(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   q.size(0), q.size(1), k.size(1), q.size(2), k.size(2),
                   q.size(3), causal ? 1 : 0, window,
                   static_cast<float>(softcap), q_offset, kv_offset,
                   static_cast<float>(scale), dtype_code(q),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_attention_wgmma(const at::Tensor& q, const at::Tensor& k,
                           const at::Tensor& v, const at::Tensor& out,
                           bool causal, int64_t window, double softcap,
                           int64_t q_offset, int64_t kv_offset,
                           double scale) {
  TORCH_CHECK(repro_torch::flash_wgmma_head_dim_ok(q.size(3)),
              "flash_attention (wgmma): unsupported head dim ", q.size(3));
  TORCH_CHECK(q.scalar_type() == at::kBFloat16,
              "flash_attention (wgmma): needs bfloat16");
  TORCH_CHECK(q.size(2) <= 65535LL * 128 && k.size(2) < (1LL << 31),
              "flash_attention (wgmma): Tq must be at most 65535 x 128 "
              "and Tk below 2^31");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(repro_torch::launch_flash_attention_wgmma(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   q.size(0), q.size(1), k.size(1), q.size(2), k.size(2),
                   q.size(3), causal ? 1 : 0, window,
                   static_cast<float>(softcap), q_offset, kv_offset,
                   static_cast<float>(scale),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention (wgmma)");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_decode(const at::Tensor& q, const at::Tensor& k,
                  const at::Tensor& v, const at::Tensor& out,
                  const at::Tensor& o_part, const at::Tensor& m_part,
                  const at::Tensor& l_part, bool causal, int64_t window,
                  double softcap, int64_t q_offset, int64_t kv_offset,
                  double scale, int64_t j_lo, int64_t j_hi, int64_t per,
                  int64_t splits) {
  TORCH_CHECK(repro_torch::flash_attention_head_dim_ok(q.size(3)),
              "flash_attention (decode): unsupported head dim ", q.size(3));
  const int64_t rows = q.size(0) * q.size(1) * q.size(2);
  TORCH_CHECK(splits > 0 && splits <= 12288,   // the combine's 48 KB
              "flash_attention (decode): 1 to 12288 splits, got ", splits);
  TORCH_CHECK(o_part.numel() == splits * rows * q.size(3) &&
                  m_part.numel() == splits * rows &&
                  l_part.numel() == splits * rows,
              "flash_attention (decode): partials must hold splits x rows");
  TORCH_CHECK(k.size(1) * repro_torch::decode_row_blocks(
                              q.size(1), k.size(1), q.size(2)) <= 65535,
              "flash_attention (decode): too many (KV head, row block) "
              "pairs for the grid");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(repro_torch::launch_flash_decode(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   o_part.data_ptr<float>(), m_part.data_ptr<float>(),
                   l_part.data_ptr<float>(), q.size(0), q.size(1),
                   k.size(1), q.size(2), k.size(2), q.size(3),
                   causal ? 1 : 0, window, static_cast<float>(softcap),
                   q_offset, kv_offset, static_cast<float>(scale), j_lo,
                   j_hi, per, splits, dtype_code(q),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "flash_attention (decode)");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void rglru_scan(const at::Tensor& x, const at::Tensor& a,
                const at::Tensor& gx, const c10::optional<at::Tensor>& h0,
                const at::Tensor& y, const at::Tensor& h_last) {
  const c10::cuda::CUDAGuard guard(x.device());
  const float* h0p = h0.has_value() ? h0->data_ptr<float>() : nullptr;
  check_launch(repro_torch::launch_rglru_scan(
                   x.data_ptr(), a.data_ptr(), gx.data_ptr(), h0p,
                   y.data_ptr(), h_last.data_ptr<float>(), x.size(0),
                   x.size(1), x.size(2), dtype_code(x),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "rglru_scan");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void rglru_scan_chunked(const at::Tensor& x, const at::Tensor& a,
                        const at::Tensor& gx,
                        const c10::optional<at::Tensor>& h0,
                        const at::Tensor& y, const at::Tensor& h_last,
                        const at::Tensor& scratch) {
  TORCH_CHECK(scratch.numel() >= repro_torch::rglru_scan_scratch_bytes(
                                     x.size(0), x.size(1), x.size(2)),
              "rglru_scan (scan): scratch must hold "
              "rglru_scan_scratch_bytes(B, T, D) bytes");
  const c10::cuda::CUDAGuard guard(x.device());
  const float* h0p = h0.has_value() ? h0->data_ptr<float>() : nullptr;
  check_launch(repro_torch::launch_rglru_scan_chunked(
                   x.data_ptr(), a.data_ptr(), gx.data_ptr(), h0p,
                   y.data_ptr(), h_last.data_ptr<float>(),
                   scratch.data_ptr<uint8_t>(), x.size(0), x.size(1),
                   x.size(2), dtype_code(x),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "rglru_scan (scan)");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mlstm_chunkwise(const at::Tensor& q, const at::Tensor& k,
                     const at::Tensor& v, const at::Tensor& i,
                     const at::Tensor& f, const at::Tensor& h,
                     const at::Tensor& c, const at::Tensor& n,
                     const at::Tensor& m, int64_t chunk) {
  TORCH_CHECK(k.strides().equals(q.strides()) &&
                  v.strides().equals(q.strides()) &&
                  h.strides().equals(q.strides()) && q.stride(3) == 1,
              "mlstm_chunkwise: q, k, v and h must share strides with a "
              "unit last stride");
  TORCH_CHECK(f.strides().equals(i.strides()),
              "mlstm_chunkwise: i and f must share strides");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(repro_torch::launch_mlstm_chunkwise(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   i.data_ptr<float>(), f.data_ptr<float>(), h.data_ptr(),
                   c.data_ptr<float>(), n.data_ptr<float>(),
                   m.data_ptr<float>(), q.size(0), q.size(1), q.size(2),
                   q.size(3), chunk, q.stride(0), q.stride(1), q.stride(2),
                   i.stride(0), i.stride(1), i.stride(2), dtype_code(q),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "mlstm_chunkwise");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void mlstm_chunkwise_tc(const at::Tensor& q, const at::Tensor& k,
                        const at::Tensor& v, const at::Tensor& i,
                        const at::Tensor& f, const at::Tensor& h,
                        const at::Tensor& hbuf, const at::Tensor& c,
                        const at::Tensor& n, const at::Tensor& m,
                        const at::Tensor& scratch, int64_t chunk) {
  TORCH_CHECK(k.strides().equals(q.strides()) &&
                  v.strides().equals(q.strides()) &&
                  h.strides().equals(q.strides()) &&
                  hbuf.strides().equals(q.strides()) && q.stride(3) == 1,
              "mlstm_chunkwise (tc): q, k, v, h and hbuf must share "
              "strides with a unit last stride");
  TORCH_CHECK(f.strides().equals(i.strides()),
              "mlstm_chunkwise (tc): i and f must share strides");
  TORCH_CHECK(repro_torch::mlstm_tc_shape_ok(q.size(3), chunk),
              "mlstm_chunkwise (tc): unsupported head dim ", q.size(3),
              " with chunk ", chunk);
  TORCH_CHECK(scratch.numel() >= repro_torch::mlstm_tc_scratch_floats(
                                     q.size(0), q.size(1), q.size(2), chunk),
              "mlstm_chunkwise (tc): scratch too small");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(repro_torch::launch_mlstm_chunkwise_tc(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   i.data_ptr<float>(), f.data_ptr<float>(), h.data_ptr(),
                   hbuf.data_ptr<float>(), c.data_ptr<float>(),
                   n.data_ptr<float>(), m.data_ptr<float>(),
                   scratch.data_ptr<float>(), q.size(0), q.size(1),
                   q.size(2), q.size(3), chunk, q.stride(0), q.stride(1),
                   q.stride(2), i.stride(0), i.stride(1), i.stride(2),
                   dtype_code(q), c10::cuda::getCurrentCUDAStream().stream()),
               "mlstm_chunkwise (tc)");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void slot_planes(const at::Tensor& have_t, const at::Tensor& cand,
                 const at::Tensor& owner, const at::Tensor& allowed,
                 const at::Tensor& recv_ok, int64_t m_cnt, bool nonowner,
                 bool ungated, const at::Tensor& plane_a,
                 const at::Tensor& plane_b,
                 const at::Tensor& need, const at::Tensor& need_cnt,
                 const at::Tensor& sup_any, const at::Tensor& partial) {
  const c10::cuda::CUDAGuard guard(have_t.device());
  check_launch(repro_torch::launch_slot_planes(
                   have_t.data_ptr<int32_t>(), have_t.size(1),
                   cand.data_ptr<int32_t>(), owner.data_ptr<int32_t>(),
                   allowed.data_ptr<bool>(), recv_ok.data_ptr<bool>(),
                   recv_ok.size(0), m_cnt, cand.size(0), nonowner ? 1 : 0,
                   ungated ? 1 : 0, plane_a.data_ptr<int32_t>(),
                   nonowner ? plane_b.data_ptr<int32_t>() : nullptr,
                   need.data_ptr<int32_t>(), need_cnt.data_ptr<int32_t>(),
                   sup_any.data_ptr<bool>(), partial.data_ptr<int32_t>(),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "slot_planes");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void overlap_rank(const at::Tensor& plane_a, const at::Tensor& plane_b,
                  bool has_b, const at::Tensor& need, const at::Tensor& u_c,
                  const at::Tensor& sbc, const at::Tensor& cnt_b) {
  const c10::cuda::CUDAGuard guard(need.device());
  check_launch(repro_torch::launch_overlap_rank(
                   plane_a.data_ptr<int32_t>(), plane_b.data_ptr<int32_t>(),
                   has_b ? 1 : 0, need.data_ptr<int32_t>(),
                   u_c.data_ptr<int64_t>(), need.size(0), need.size(1),
                   sbc.data_ptr<int32_t>(), cnt_b.data_ptr<int32_t>(),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "overlap_rank");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void extract_ranked(const at::Tensor& plane_a, const at::Tensor& plane_b,
                    bool has_b, const at::Tensor& need,
                    const at::Tensor& u_c, const at::Tensor& take,
                    const at::Tensor& t_a, const at::Tensor& sbc,
                    const at::Tensor& cols) {
  const c10::cuda::CUDAGuard guard(need.device());
  check_launch(repro_torch::launch_extract_ranked(
                   plane_a.data_ptr<int32_t>(), plane_b.data_ptr<int32_t>(),
                   has_b ? 1 : 0, need.data_ptr<int32_t>(),
                   u_c.data_ptr<int64_t>(), take.data_ptr<int32_t>(),
                   t_a.data_ptr<int32_t>(), sbc.data_ptr<int32_t>(),
                   need.size(0), need.size(1), cols.size(1),
                   cols.data_ptr<int32_t>(),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "extract_ranked");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

repro_torch::SlotRoundsIo slot_rounds_io(
    const at::Tensor& plane_a, const at::Tensor& plane_b, bool has_b,
    const at::Tensor& need, const at::Tensor& need_cnt,
    const at::Tensor& sup_any, const at::Tensor& nbr,
    const at::Tensor& in_nbr, const at::Tensor& rem_up,
    const at::Tensor& rem_down, const at::Tensor& noise_base,
    const at::Tensor& tie_base, const at::Tensor& prio_base, int64_t mode,
    int64_t batch_cap, int64_t tau, const at::Tensor& out_snd,
    const at::Tensor& out_col, const at::Tensor& rounds) {
  auto words = [](const at::Tensor& t) {
    return reinterpret_cast<const uint32_t*>(t.data_ptr<int32_t>());
  };
  repro_torch::SlotRoundsIo io{};
  io.plane_a = words(plane_a);
  io.plane_b = has_b ? words(plane_b) : io.plane_a;
  io.need = words(need);
  io.need_cnt = need_cnt.data_ptr<int32_t>();
  io.sup_any = sup_any.data_ptr<bool>();
  io.nbr = nbr.data_ptr<int32_t>();
  io.in_nbr = in_nbr.data_ptr<int32_t>();
  io.rem_up = rem_up.data_ptr<int32_t>();
  io.rem_down = rem_down.data_ptr<int32_t>();
  io.noise_base = words(noise_base);
  io.tie_base = words(tie_base);
  io.prio_base = words(prio_base);
  io.out_snd = out_snd.data_ptr<int32_t>();
  io.out_col = out_col.data_ptr<int32_t>();
  io.rounds = rounds.data_ptr<int32_t>();
  io.n = need.size(0);
  io.w_words = need.size(1);
  io.d_pad = nbr.size(1);
  io.din_pad = in_nbr.size(1);
  io.t_cap = out_col.size(2);
  io.has_b = has_b ? 1 : 0;
  io.mode = static_cast<int>(mode);
  io.r_max = static_cast<int>(out_snd.size(0));
  io.batch_cap = static_cast<int>(batch_cap);
  io.tau = static_cast<int>(tau);
  return io;
}

void slot_rounds(const at::Tensor& plane_a, const at::Tensor& plane_b,
                 bool has_b, const at::Tensor& need,
                 const at::Tensor& need_cnt, const at::Tensor& sup_any,
                 const at::Tensor& nbr, const at::Tensor& in_nbr,
                 const at::Tensor& rem_up, const at::Tensor& rem_down,
                 const at::Tensor& noise_base, const at::Tensor& tie_base,
                 const at::Tensor& prio_base, int64_t mode, int64_t batch_cap,
                 int64_t tau, const at::Tensor& out_snd,
                 const at::Tensor& out_col, const at::Tensor& rounds,
                 const at::Tensor& scratch) {
  const c10::cuda::CUDAGuard guard(need.device());
  check_launch(repro_torch::launch_slot_rounds(
                   slot_rounds_io(plane_a, plane_b, has_b, need, need_cnt,
                                  sup_any, nbr, in_nbr, rem_up, rem_down,
                                  noise_base, tie_base, prio_base, mode,
                                  batch_cap, tau, out_snd, out_col, rounds),
                   scratch.data_ptr<int32_t>(),
                   c10::cuda::getCurrentCUDAStream().stream()),
               "slot_rounds");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

int64_t slot_rounds_scratch_words(int64_t n, int64_t w_words, int64_t d_pad,
                                  int64_t r_max, int64_t mode) {
  repro_torch::SlotRoundsIo io{};
  io.n = n;
  io.w_words = w_words;
  io.d_pad = d_pad;
  io.r_max = static_cast<int>(r_max);
  io.mode = static_cast<int>(mode);
  return repro_torch::slot_rounds_scratch_words(io);
}

int64_t slot_rounds_grid(const at::Tensor& like, int64_t n) {
  const c10::cuda::CUDAGuard guard(like.device());
  return repro_torch::slot_rounds_grid(n);
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fedavg_reduce", &fedavg_reduce,
        "Masked FedAvg reduction (updates, wn, out)");
  m.def("chunk_tiles", &repro_torch::chunk_tiles,
        "Row length of chunk_quantize's partial scratch for (n, E)");
  m.def("chunk_quantize", &chunk_quantize,
        "Per-row int8 quantize (x, q, scale, partial)");
  m.def("chunk_dequantize", &chunk_dequantize,
        "Per-row int8 dequantize (q, scale, out)");
  m.def("flash_attention", &flash_attention,
        "Flash attention forward (q, k, v, out, causal, window, softcap, "
        "q_offset, kv_offset, scale); the FMA route");
  m.def("flash_attention_wgmma", &flash_attention_wgmma,
        "Flash attention forward, bf16 on wgmma (q, k, v, out, causal, "
        "window, softcap, q_offset, kv_offset, scale)");
  m.def("flash_decode", &flash_decode,
        "Split-KV decode attention (q, k, v, out, o_part, m_part, l_part, "
        "causal, window, softcap, q_offset, kv_offset, scale, j_lo, j_hi, "
        "per, splits)");
  m.def("rglru_scan", &rglru_scan,
        "RG-LRU scan, one thread per channel (x, a, gx, h0 or None, y, "
        "h_last); the seq route");
  m.def("rglru_scan_scratch_bytes", &repro_torch::rglru_scan_scratch_bytes,
        "Bytes of the scan route's look-back scratch for (B, T, D)");
  m.def("rglru_scan_chunked", &rglru_scan_chunked,
        "RG-LRU chunked scan with decoupled look-back (x, a, gx, h0 or "
        "None, y, h_last, scratch); the scan route");
  m.def("mlstm_chunkwise_shape_ok", &repro_torch::mlstm_chunkwise_shape_ok,
        "Whether mlstm_chunkwise takes head dim dh and chunk length chunk");
  m.def("mlstm_chunkwise", &mlstm_chunkwise,
        "Chunkwise mLSTM from a zero state (q, k, v, i, f, h, C, n, m, "
        "chunk); the FMA route");
  m.def("mlstm_tc_scratch_floats", &repro_torch::mlstm_tc_scratch_floats,
        "Floats of the tensor-core route's gate scratch for (B, H, T, "
        "chunk)");
  m.def("mlstm_chunkwise_tc", &mlstm_chunkwise_tc,
        "Chunkwise mLSTM on TF32 wgmma (q, k, v, i, f, h, hbuf, C, n, m, "
        "scratch, chunk)");
  m.def("slot_planes", &slot_planes,
        "Slot engine stage 1 (have_t, cand, owner, allowed, recv_ok, m_cnt, "
        "nonowner, ungated, plane_a, plane_b, need, "
        "need_cnt, sup_any, partial)");
  m.def("overlap_rank", &overlap_rank,
        "Per-round overlap rank counts (plane_a, plane_b, has_b, need, "
        "u_c, sbc, cnt_b)");
  m.def("extract_ranked", &extract_ranked,
        "Per-round ranked extraction (plane_a, plane_b, has_b, need, u_c, "
        "take, t_a, sbc, cols); clears the picks from need");
  m.def("slot_rounds", &slot_rounds,
        "Every grant round of a slot, one cooperative launch (plane_a, "
        "plane_b, has_b, need, need_cnt, sup_any, nbr, in_nbr, rem_up, "
        "rem_down, noise_base, tie_base, prio_base, mode, batch_cap, tau, "
        "out_snd, out_col, rounds, scratch)");
  m.def("slot_rounds_scratch_words", &slot_rounds_scratch_words,
        "int32 scratch words of slot_rounds (n, w_words, d_pad, r_max, "
        "mode)");
  m.def("slot_rounds_grid", &slot_rounds_grid,
        "CTAs of a slot_rounds launch on `like`'s device (like, n)");
}
