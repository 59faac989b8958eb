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

}  // namespace repro_torch
