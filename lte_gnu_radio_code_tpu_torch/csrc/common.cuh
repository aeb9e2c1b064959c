// Shared device code of the port's kernels.
//
// Arithmetic is float32 FFMA on the CUDA cores (no TF32).  Complex values
// are float2 (re, im), the layout of a contiguous torch.complex64 tensor.

#pragma once

#include <cuda_runtime.h>

namespace lte {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace lte
