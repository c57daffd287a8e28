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

// cp.async copies from global into shared memory (sm_80 and later).
__device__ __forceinline__ void acx_cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 4-byte copy; with ok false the destination is filled with zero.
__device__ __forceinline__ void acx_cp_async4(float* dst, const float* src,
                                              bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void acx_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void acx_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static inline int acx_num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}
