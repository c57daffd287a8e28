// One LSTM layer's recurrence over precomputed input gates, fp32, for sm_90a.
//
// Replaces the TPU kernel audiocodecs_tpu/ops/lstm_pallas.py::_pallas_impl
// (kernel body `_kernel`), which keeps all of w_hh [H, 4H] in VMEM and walks
// time in one core's sequential grid. On Hopper w_hh does not fit in one SM
// (4 MB at H = 512 against 227 KB of shared memory), and blocks run in no
// order, so the layer is spread over the card instead:
//
//   * one persistent cooperative grid; block j owns U hidden units and ALL
//     FOUR gate columns of those units, so the cell update is block-local;
//     its w_hh slice [H, 4U] is loaded into shared memory once;
//   * the time loop runs inside the kernel: each step reads h_{t-1} (the
//     previous row of ys, written by every block) through L2 with __ldcg,
//     does the [B, H] x [H, 4U] product as plain fp32 FMAs on the CUDA cores
//     (no TF32: the encoder LSTM decides tokens), applies the gate math,
//     writes h_t into ys and meets the other blocks at grid.sync().
//
// Bound: the FLOPs (2*T*B*H*4H, 12.6 GFLOP at T=750, B=8, H=512) take
// ~0.19 ms at the FP32 CUDA-core peak and the bytes (gates_x + ys, 61 MB)
// ~0.02 ms; the real floor is T dependent steps, each one grid barrier plus
// an L2 round trip for h. The design keeps a step's work tiny (B*4U*H FMAs
// a block) so the barrier latency is what remains.
//
// Inputs: gates_x [T, ldb, 4H] (x @ w_ih + b, gate order i, f, g, o),
// w_hh [H, 4H], h0/c0 [B, H]. Outputs: ys [T, ldb, H], h_T, c_T [B, H].
// One launch runs B <= ldb consecutive batch rows (the pointers are offset
// to the first); shared memory holds B rows of h, so the wrapper splits a
// larger batch into launches of at most lstm_recurrence_max_batch(H).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int U>
__global__ void __launch_bounds__(kThreads)
    lstm_recurrence_kernel(const float* __restrict__ gx,
                           const float* __restrict__ w_hh,
                           const float* __restrict__ h0,
                           const float* __restrict__ c0, float* ys,
                           float* __restrict__ h_out,
                           float* __restrict__ c_out, int T, int B,
                           int ldb, int H) {
  constexpr int G = 4 * U;  // gate columns of this block
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* w_s = smem;             // [G][H]: w_s[c*H + k] = w_hh[k][col(c)]
  float* h_s = w_s + G * H;      // [B][H]: h_{t-1}
  float* g_s = h_s + B * H;      // [B][G]: recurrent part of the gates
  float* c_s = g_s + B * G;      // [B][U]: cell state
  const int j0 = blockIdx.x * U;
  const int H4 = 4 * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // local column c = gate*U + u  <->  global column gate*H + j0 + u
  for (int idx = threadIdx.x; idx < G * H; idx += kThreads) {
    const int k = idx / G, c = idx % G;
    w_s[c * H + k] = w_hh[(size_t)k * H4 + (c / U) * H + j0 + (c % U)];
  }
  for (int idx = threadIdx.x; idx < B * U; idx += kThreads)
    c_s[idx] = c0[(idx / U) * H + j0 + idx % U];

  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 : ys + (size_t)(t - 1) * ldb * H;
    // written by other blocks before the last grid.sync(): bypass L1
    for (int idx = threadIdx.x; idx < B * H; idx += kThreads)
      h_s[idx] = __ldcg(hprev + idx);
    __syncthreads();

    for (int b = warp; b < B; b += kWarps) {
      float acc[G];
#pragma unroll
      for (int c = 0; c < G; ++c) acc[c] = 0.f;
      const float* hb = h_s + b * H;
      for (int k = lane; k < H; k += 32) {
        const float hv = hb[k];
#pragma unroll
        for (int c = 0; c < G; ++c) acc[c] = fmaf(hv, w_s[c * H + k], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < G; ++c) {
        float v = acc[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[c] = v;
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < G; ++c) g_s[b * G + c] = acc[c];
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < B * U; idx += kThreads) {
      const int b = idx / U, u = idx % U, j = j0 + u;
      const float* gxt = gx + ((size_t)t * ldb + b) * H4 + j;
      const float* gr = g_s + b * G + u;
      const float gi = acx_sigmoid(gxt[0 * H] + gr[0 * U]);
      const float gf = acx_sigmoid(gxt[1 * H] + gr[1 * U]);
      const float gg = tanhf(gxt[2 * H] + gr[2 * U]);
      const float go = acx_sigmoid(gxt[3 * H] + gr[3 * U]);
      const float c = gf * c_s[idx] + gi * gg;
      c_s[idx] = c;
      ys[((size_t)t * ldb + b) * H + j] = go * tanhf(c);
    }
    grid.sync();
  }

  for (int idx = threadIdx.x; idx < B * U; idx += kThreads) {
    const int b = idx / U, j = j0 + idx % U;
    h_out[b * H + j] = __ldcg(ys + ((size_t)(T - 1) * ldb + b) * H + j);
    c_out[b * H + j] = c_s[idx];
  }
}

template <int U>
cudaError_t launch(const float* gx, const float* w_hh, const float* h0,
                   const float* c0, float* ys, float* h_out, float* c_out,
                   int T, int B, int ldb, int H, cudaStream_t stream) {
  auto kernel = lstm_recurrence_kernel<U>;
  const size_t smem =
      sizeof(float) * ((size_t)4 * U * H + (size_t)B * H + 4 * U * B + U * B);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = H / U;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * acx_num_sms() < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&gx, (void*)&w_hh, (void*)&h0, (void*)&c0,
                  (void*)&ys, (void*)&h_out, (void*)&c_out,
                  (void*)&T, (void*)&B, (void*)&ldb, (void*)&H};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Units per block: the smallest U in {1, 2, 4, 8} whose grid (H / U blocks)
// fits on the card at one block per SM. The wrapper admits H % 32 == 0 and
// H <= 1024, so every U divides H.
ACX_EXPORT int lstm_recurrence_units(int H) {
  const int sms = acx_num_sms();
  for (int U = 1; U <= 8; U *= 2)
    if (H % U == 0 && H / U <= sms) return U;
  return 0;
}

// The most batch rows one launch takes: shared memory holds the block's
// w_hh slice (4U*H floats) plus H + 5U floats a row.
ACX_EXPORT int lstm_recurrence_max_batch(int H) {
  const int U = lstm_recurrence_units(H);
  int dev = 0, optin = 0;
  if (U == 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const long avail = optin / (long)sizeof(float) - 4L * U * H;
  return avail > 0 ? (int)(avail / (H + 5 * U)) : 0;
}

ACX_EXPORT int lstm_recurrence_f32(const float* gx, const float* w_hh,
                                   const float* h0, const float* c0,
                                   float* ys, float* h_out, float* c_out,
                                   int T, int B, int ldb, int H,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (T < 1 || B < 1 || ldb < B) return cudaErrorInvalidValue;
  switch (lstm_recurrence_units(H)) {
    case 1: return launch<1>(gx, w_hh, h0, c0, ys, h_out, c_out, T, B, ldb, H, s);
    case 2: return launch<2>(gx, w_hh, h0, c0, ys, h_out, c_out, T, B, ldb, H, s);
    case 4: return launch<4>(gx, w_hh, h0, c0, ys, h_out, c_out, T, B, ldb, H, s);
    case 8: return launch<8>(gx, w_hh, h0, c0, ys, h_out, c_out, T, B, ldb, H, s);
    default: return cudaErrorInvalidValue;
  }
}

ACX_EXPORT const char* lstm_recurrence_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
