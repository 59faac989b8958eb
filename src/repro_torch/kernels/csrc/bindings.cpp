// PyTorch bindings for the launchers in kernels.h.
//
// The only source that includes torch/extension.h.  It is called only
// by the wrappers in fedavg.py and quantize.py, which check device,
// dtype, shape and contiguity and allocate every output and scratch
// tensor with torch.empty; the typed data_ptr<T>() calls below still
// refuse a tensor of another dtype.  Each entry point launches on
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
}
