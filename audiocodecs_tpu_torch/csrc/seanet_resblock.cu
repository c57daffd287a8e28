// Fused SEANet residual block, fp32, for sm_90a:
//
//     out = (ws . x + bs) + (w2 . ELU(w1 *k3 ELU(x_padded) + b1) + b2)
//
// Replaces the TPU kernel audiocodecs_tpu/ops/seanet_block_pallas.py::
// seanet_resblock_pallas (kernel `_kernel`): the causal, dilation-1 block of
// EnCodec with a 1x1 conv shortcut. The port keeps PyTorch's [B, C, T]
// layout, so threads walk the time axis and global reads coalesce.
//
// Bound: 6*C^2 FLOPs a sample (k3 conv 3*C*Hc*2, 1x1 conv Hc*C*2, shortcut
// C*C*2 with Hc = C/2). In exact fp32 on CUDA cores the block is FLOP-bound
// at every main-path shape (e.g. C=64, T=120000, B=8: 23.6 GFLOP ~ 0.35 ms
// at 67 TFLOP/s against 491 MB ~ 0.15 ms of HBM). The design reads x once
// and writes out once: one block per (time tile, batch) stages ELU(x) of the
// tile plus its 2-sample causal halo in shared memory, computes the k3 conv
// into a shared [Hc, tile] buffer, then the 1x1 conv and the shortcut (x
// again, now an L1/L2 hit) and the add, and writes the tile. Each thread
// holds an RM x RT register tile (RT time samples 32 apart, so shared reads
// are conflict-free, and RM channels whose weights are warp-wide broadcast
// loads). Unlike the TPU kernel, the weights do not fit on-chip at C = 256
// (786 KB): they are read through L1/L2 with __ldg.
//
// The halo [B, C, 2] holds the two padded samples before t = 0 (reflect or
// zero, per the model's pad mode); the caller gathers it, so x is not
// copied into a padded buffer. ELU uses expm1f, as the reference's XLA path.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int RM1, int RM2, int RT>
__global__ void __launch_bounds__(kThreads, 2)
    seanet_resblock_kernel(const float* __restrict__ x,
                           const float* __restrict__ halo,
                           const float* __restrict__ w1,  // [Hc, C, 3]
                           const float* __restrict__ b1,  // [Hc]
                           const float* __restrict__ w2,  // [C, Hc]
                           const float* __restrict__ b2,  // [C]
                           const float* __restrict__ ws,  // [C, C]
                           const float* __restrict__ bs,  // [C]
                           float* __restrict__ out, int C, int Hc, int T) {
  constexpr int TT = 32 * RT;  // time tile
  constexpr int TE = TT + 2;   // with the causal halo
  extern __shared__ float smem[];
  float* e_s = smem;          // [C][TE]  ELU(x_padded)
  float* h_s = e_s + C * TE;  // [Hc][TT] ELU(conv3)
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)b * C * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int idx = threadIdx.x; idx < C * TE; idx += kThreads) {
    const int c = idx / TE, p = t0 - 2 + idx % TE;
    float v = 0.f;
    if (p < 0)
      v = halo[((size_t)b * C + c) * 2 + p + 2];
    else if (p < T)
      v = __ldg(xb + (size_t)c * T + p);
    e_s[idx] = acx_elu(v);
  }
  __syncthreads();

  // k3 conv: h[m][t] = ELU(b1[m] + sum_{c,k} w1[m][c][k] * e[c][t + k])
  for (int m0 = warp * RM1; m0 < Hc; m0 += kWarps * RM1) {
    float acc[RM1][RT];
#pragma unroll
    for (int r = 0; r < RM1; ++r)
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[r][i] = 0.f;
    const float* wrow[RM1];
#pragma unroll
    for (int r = 0; r < RM1; ++r) wrow[r] = w1 + (size_t)min(m0 + r, Hc - 1) * C * 3;
    for (int c = 0; c < C; ++c) {
      const float* er = e_s + c * TE + lane;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float wv[RM1];
#pragma unroll
        for (int r = 0; r < RM1; ++r) wv[r] = __ldg(wrow[r] + c * 3 + k);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float ev = er[32 * i + k];
#pragma unroll
          for (int r = 0; r < RM1; ++r) acc[r][i] = fmaf(wv[r], ev, acc[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RM1; ++r) {
      if (m0 + r >= Hc) break;
      const float bias = __ldg(b1 + m0 + r);
#pragma unroll
      for (int i = 0; i < RT; ++i)
        h_s[(m0 + r) * TT + lane + 32 * i] = acx_elu(acc[r][i] + bias);
    }
  }
  __syncthreads();

  // out[o][t] = (bs[o] + sum_c ws[o][c] x[c][t]) + (b2[o] + sum_m w2[o][m] h[m][t])
  for (int o0 = warp * RM2; o0 < C; o0 += kWarps * RM2) {
    float acc_s[RM2][RT], acc_y[RM2][RT];
#pragma unroll
    for (int r = 0; r < RM2; ++r)
#pragma unroll
      for (int i = 0; i < RT; ++i) acc_s[r][i] = acc_y[r][i] = 0.f;
    int orow[RM2];
#pragma unroll
    for (int r = 0; r < RM2; ++r) orow[r] = min(o0 + r, C - 1);
    for (int m = 0; m < Hc; ++m) {
      float wv[RM2];
#pragma unroll
      for (int r = 0; r < RM2; ++r) wv[r] = __ldg(w2 + (size_t)orow[r] * Hc + m);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float hv = h_s[m * TT + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < RM2; ++r) acc_y[r][i] = fmaf(wv[r], hv, acc_y[r][i]);
      }
    }
    for (int c = 0; c < C; ++c) {
      float wv[RM2];
#pragma unroll
      for (int r = 0; r < RM2; ++r) wv[r] = __ldg(ws + (size_t)orow[r] * C + c);
      const float* xr = xb + (size_t)c * T + t0 + lane;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float xv = t0 + lane + 32 * i < T ? __ldg(xr + 32 * i) : 0.f;
#pragma unroll
        for (int r = 0; r < RM2; ++r) acc_s[r][i] = fmaf(wv[r], xv, acc_s[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < RM2; ++r) {
      if (o0 + r >= C) break;
      const int o = o0 + r;
      const float bsv = __ldg(bs + o), b2v = __ldg(b2 + o);
      float* orow_out = out + ((size_t)b * C + o) * T + t0 + lane;
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (t0 + lane + 32 * i < T)
          orow_out[32 * i] = (acc_s[r][i] + bsv) + (acc_y[r][i] + b2v);
    }
  }
}

template <int RM1, int RM2, int RT>
cudaError_t launch(const float* x, const float* halo, const float* w1,
                   const float* b1, const float* w2, const float* b2,
                   const float* ws, const float* bs, float* out, int B, int C,
                   int Hc, int T, cudaStream_t stream) {
  auto kernel = seanet_resblock_kernel<RM1, RM2, RT>;
  constexpr int TT = 32 * RT;
  const size_t smem = sizeof(float) * ((size_t)C * (TT + 2) + (size_t)Hc * TT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TT - 1) / TT, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, halo, w1, b1, w2, b2, ws, bs,
                                           out, C, Hc, T);
  return cudaGetLastError();
}

}  // namespace

// Register tiles by width: RM1 channels of the k3 conv and RM2 of the 1x1
// convs a thread, RT time samples; the tile shrinks at C > 128 so shared
// memory ((C*(32*RT+2) + Hc*32*RT) floats) stays near 100 KB. C > 384
// (wider than any block of the models served) is refused.
ACX_EXPORT int seanet_resblock_f32(const float* x, const float* halo,
                                   const float* w1, const float* b1,
                                   const float* w2, const float* b2,
                                   const float* ws, const float* bs,
                                   float* out, int B, int C, int Hc, int T,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || C < 1 || Hc < 1 || T < 1 || C > 384)
    return cudaErrorInvalidValue;
  if (Hc <= 16 && C <= 32)
    return launch<2, 4, 4>(x, halo, w1, b1, w2, b2, ws, bs, out, B, C, Hc, T, s);
  if (Hc <= 32 && C <= 64)
    return launch<4, 8, 4>(x, halo, w1, b1, w2, b2, ws, bs, out, B, C, Hc, T, s);
  if (C <= 128)
    return launch<8, 8, 4>(x, halo, w1, b1, w2, b2, ws, bs, out, B, C, Hc, T, s);
  return launch<8, 8, 2>(x, halo, w1, b1, w2, b2, ws, bs, out, B, C, Hc, T, s);
}

ACX_EXPORT const char* seanet_resblock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
