// Shared helpers for the package's CUDA kernels (plain C interface, loaded
// with ctypes by audiocodecs_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_runtime.h>

#define ACX_EXPORT extern "C" __attribute__((visibility("default")))

// ELU(alpha=1) with expm1f, the form of the reference's layers.elu. The
// package is built without --use_fast_math, so expf/expm1f/tanhf are the
// accurate library versions.
__device__ __forceinline__ float acx_elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

__device__ __forceinline__ float acx_sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

static inline int acx_num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}
