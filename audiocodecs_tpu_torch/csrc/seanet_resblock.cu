// Fused SEANet residual block for sm_90a, in the reference kernel's forms:
// the exact form (fp32 on the CUDA cores, below) and the one-pass form (one
// bf16 pass on the tensor cores, namespace mma after it):
//
//     out = (ws . x + bs) + (w2 . ELU(w1 *k3 ELU(x_padded) + b1) + b2)
//
// Replaces the TPU kernel audiocodecs_tpu/ops/seanet_block_pallas.py::
// seanet_resblock_pallas (kernel `_kernel`): the causal, dilation-1 block of
// EnCodec with a 1x1 conv shortcut, Hc = C / 2 hidden channels. The port
// keeps PyTorch's [B, C, T] layout.
//
// Bound: 6 C^2 FLOPs a sample (k3 conv 3 C Hc 2, 1x1 conv Hc C 2, shortcut
// C C 2), so it is bound by operations in exact fp32 on the CUDA cores at
// every EnCodec shape: C = 64, T = 120000, B = 8 is 23.6 GFLOP, 0.35 ms at
// 67 TFLOP/s, against 491 MB, 0.15 ms of HBM. What held the first kernel
// at 0.15-0.20 of that peak was its load instructions, not FMAs: every
// (channel, tap) step read its weights with scalar __ldg from rows 3C apart
// and its activations one scalar a sample, and the whole ELU(x) tile of C
// channels sat in shared memory, which left a 64-sample tile and 16
// accumulators a thread at C = 256.
//
// Design: two implicit GEMMs on the CUDA cores, as csrc/dac_resunit.cu.
// - One block of 256 threads per (time tile of TT samples, batch) owns every
//   channel of its tile. A warp is 4 channel lanes x 8 time lanes; a thread
//   holds an output-stationary tile of RM channels x two runs of 4
//   consecutive samples, 32 apart. So one (input channel) step of the k3
//   conv reads the 6 window samples of each run (a float2 and a float4)
//   once for all three taps, the 8 time lanes of a warp read 128
//   contiguous bytes (no bank conflict) that its 4 channel lanes share, and
//   weights are float4 reads of 64 contiguous bytes a warp.
// - The k3 conv (M = Hc, K = 3C, N = TT) walks chunks of kChunk = 8 input
//   channels through a two-stage cp.async ring: the chunk's weights
//   [8][3][M1p] and its raw x window rows [8][TT + 4] (positions t0 - 4 on;
//   16-byte copies when T % 4 == 0, else 4-byte ones; positions -2 and -1
//   come from the halo, positions past T are cp.async's zero fill). Each
//   thread applies ELU to the elements it copied, after its own copies
//   land, so one barrier a chunk suffices, and the next chunk's copies
//   overlap this chunk's FMAs.
// - Epilogue: b1 and ELU turn the accumulators into h [M1p][TT] in shared
//   memory (rows >= Hc are zero). The 1x1 conv and the shortcut then run
//   as a second GEMM over P2 output channels a pass (one pass at every
//   EnCodec width): w2 chunks over h, then ws chunks over raw x rows reread
//   from L2 (the ring's copy of x has had ELU applied), through the same
//   kind of ring. One chain is live at a time, so a thread holds 8 x RM2
//   accumulators, not twice that: after the w2 chunks the pass's outputs
//   hold y + b2, parked in `out` (a write and, after the ws chunks, a read
//   by the same thread of a line still in L2); then out = (s + bs) + that.
// - At C <= 64 all of a block's weights (12 KB at C = 32, 48 KB at C = 64)
//   stay in shared memory for the block's whole life (RES), so only x goes
//   through the ring; wider blocks stream the weights.
// Weights come packed once per block by the wrapper
// (ops/seanet_resblock.py::pack_resblock_weights): w1p [Kp][3][M1p],
// w2p [Khp][Cp] and wsp [Kp][Cp], input channels zero-padded to multiples
// of 8 and output channels to the tile's M1p and Cp, so every chunk is one
// contiguous, 16-byte aligned block.
//
// Tiles (template <WM, RM1, RM2, MINB, RES>: WM of the 8 warps along
// channels, TT = 512 / WM): 32 accumulators a thread in the k3 conv and 64
// in the 1x1 convs at every EnCodec width, MINB 2 (at most 128 registers,
// two blocks an SM, so one block's barriers and epilogue hide behind the
// other's FMAs). Budget on the H100 (seanet_resblock_info reports it):
//   C = 32:  TT = 512, 77,824 bytes a block, RES
//   C = 64:  TT = 256, 98,304 bytes a block, RES
//   C = 128: TT = 128, 49,152 bytes a block
//   C = 256: TT = 64,  53,248 bytes a block; 752 blocks at B = 8,
//            T = 6000, 2.85 waves of 264
//   C = 384: TT = 64, 118,784 bytes a block, 96 k3 accumulators, MINB 1
// each with at most 128 registers and no spills (161 at C = 384).
// On the H100, tiles with twice the accumulators at one block an SM were
// slower, and deeper rings (3 and 4 stages) no faster over the four EnCodec
// shapes, spilling at C <= 64 (PERF.md).
//
// Summation order: every output is one fp32 FMA chain from zero, input
// channel outer and tap inner (padded channels add exact zeros), the bias
// added after the chain; the shortcut and the branch are two chains,
// combined as (s + bs) + (y + b2). No TF32, no split K, no atomics, and
// expm1f in ELU: the package is built without --use_fast_math. The kernel
// and the plain version (cuDNN, TF32 off) agree bit for bit on the card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 8;      // input channels a ring stage
constexpr int kStages = 2;     // ring depth
constexpr int kRT = 8;         // time samples a thread: two runs of 4
constexpr int kMaxChannels = 384;

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// 16-byte copy of the first `bytes` (0..16) of src; the rest of dst is
// filled with zero. src is 16-byte aligned.
__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float4 elu4(float4 v) {
  return make_float4(acx_elu(v.x), acx_elu(v.y), acx_elu(v.z), acx_elu(v.w));
}

// A block's 8 warps are WM channel groups x WT time groups. A warp is
// 4 channel lanes x 8 time lanes: each thread holds RM channels (RM1 in the
// k3 conv, RM2 in a pass of the 1x1 convs) x two runs of 4 samples, 32
// apart, so a warp covers 4 RM channels x 64 samples, its 8 time lanes read
// 128 contiguous bytes a load (no bank conflict), and its 4 channel lanes
// share them.
template <int WM, int RM1, int RM2, bool RES>
struct Tile {
  static_assert(8 % WM == 0 && RM1 % 4 == 0 && RM2 % 4 == 0, "");
  static constexpr int WT = 8 / WM;
  static constexpr int TT = 64 * WT;             // time samples a block
  static constexpr int Wp = TT + 4;              // t0 - 4 .. t0 + TT - 1
  static constexpr int M1p = 4 * WM * RM1;       // hidden channels, padded
  static constexpr int P2 = 4 * WM * RM2;        // output channels a pass
  static constexpr int kW1 = kChunk * 3 * M1p;   // k3 weights a chunk
  static constexpr int kW2 = RES ? 0 : kChunk * P2;  // w2/ws rows a stage
  static constexpr int kStage1 = (RES ? 0 : kW1) + kChunk * Wp;
  static constexpr int kStage2 = kW2 + kChunk * TT;
  // floats of shared memory a block for C input channels and Hc hidden
  static int floats(int C, int Hc) {
    const int Cp = (C + P2 - 1) / P2 * P2;
    const int res = RES ? round8(C) * (3 * M1p + Cp) + round8(Hc) * Cp : 0;
    const int ring = kStages * kStage1;
    const int tail = M1p * TT + kStages * kStage2;
    return res + (ring > tail ? ring : tail);
  }
};

// acc[r][i] += w[r] a[i] (run a) and acc[r][4 + i] += w[r] b[i] (run b)
template <int RM>
__device__ __forceinline__ void fma_tile(float (&acc)[RM][kRT],
                                         const float* __restrict__ w,
                                         const float* a, const float* b) {
  float wv[RM];
#pragma unroll
  for (int j = 0; j < RM / 4; ++j) {
    const float4 u = reinterpret_cast<const float4*>(w)[j];
    wv[4 * j] = u.x;
    wv[4 * j + 1] = u.y;
    wv[4 * j + 2] = u.z;
    wv[4 * j + 3] = u.w;
  }
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[r][i] = fmaf(wv[r], a[i], acc[r][i]);
      acc[r][4 + i] = fmaf(wv[r], b[i], acc[r][4 + i]);
    }
}

template <int WM, int RM1, int RM2, int MINB, bool RES>
__global__ void __launch_bounds__(kThreads, MINB)
    seanet_resblock_kernel(const float* __restrict__ x,     // [B, C, T]
                           const float* __restrict__ halo,  // [B, C, 2]
                           const float* __restrict__ w1p,   // [Kp, 3, M1p]
                           const float* __restrict__ b1,    // [Hc]
                           const float* __restrict__ w2p,   // [Khp, Cp]
                           const float* __restrict__ b2,    // [C]
                           const float* __restrict__ wsp,   // [Kp, Cp]
                           const float* __restrict__ bs,    // [C]
                           float* __restrict__ out, int C, int Hc, int T) {
  using L = Tile<WM, RM1, RM2, RES>;
  constexpr int TT = L::TT, Wp = L::Wp, M1p = L::M1p, P2 = L::P2;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cg = (warp % WM) * 4 + lane / 8;          // channel lane
  const int sa = (warp / WM) * 64 + (lane % 8) * 4;   // runs sa, sa + 32
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)b * C * T;
  const float* hb = halo + (size_t)b * C * 2;
  float* ob = out + (size_t)b * C * T;
  // rows start 16-byte aligned: x and out move in float4
  const bool vec = (T & 3) == 0 && ((reinterpret_cast<size_t>(x) |
                                     reinterpret_cast<size_t>(out)) & 15) == 0;
  const int Kp = round8(C), Khp = round8(Hc);
  const int n1 = Kp / kChunk, ny = Khp / kChunk;
  const int Cp = (C + P2 - 1) / P2 * P2;

  // resident weights (RES), then the work area
  float* rw1 = smem;
  float* rw2 = rw1 + Kp * 3 * M1p;
  float* rws = rw2 + Khp * Cp;
  float* work = RES ? rws + Kp * Cp : smem;
  if (RES) {
    for (int e = tid; e < Kp * 3 * M1p / 4; e += kThreads)
      acx_cp_async16(rw1 + 4 * e, w1p + 4 * e);
    for (int e = tid; e < Khp * Cp / 4; e += kThreads)
      acx_cp_async16(rw2 + 4 * e, w2p + 4 * e);
    for (int e = tid; e < Kp * Cp / 4; e += kThreads)
      acx_cp_async16(rws + 4 * e, wsp + 4 * e);
  }

  // x rows of chunk q, positions p0 .. p0 + n - 1, into dst rows of `stride`
  // floats; positions -2 and -1 come from the halo, the rest before 0 and
  // from T on are zero. ELU, when asked, over what this thread copied,
  // after its copies landed.
  auto copy_rows = [&](float* dst, int stride, int q, int p0, int n) {
    if (vec) {
      for (int e = tid; e < kChunk * n / 4; e += kThreads) {
        const int c = e / (n / 4), g = e - c * (n / 4);
        const int ch = q * kChunk + c, p = p0 + 4 * g;
        float* d = dst + c * stride + 4 * g;
        if (p < 0) {  // t0 = 0: the group -4 .. -1
          for (int u = 0; u < 4; ++u) {
            const bool ok = ch < C && p + u >= -2;
            acx_cp_async4(d + u, ok ? hb + ch * 2 + p + u + 2 : hb, ok);
          }
        } else {
          const int left = ch < C ? T - p : 0;
          const int bytes = left >= 4 ? 16 : left > 0 ? 4 * left : 0;
          cp_async16z(d, bytes ? xb + (size_t)ch * T + p : xb, bytes);
        }
      }
    } else {
      for (int e = tid; e < kChunk * n; e += kThreads) {
        const int c = e / n, j = e - c * n;
        const int ch = q * kChunk + c, p = p0 + j;
        bool ok = ch < C && p >= -2 && p < T;
        const float* src = !ok ? xb : p < 0 ? hb + ch * 2 + p + 2
                                            : xb + (size_t)ch * T + p;
        acx_cp_async4(dst + c * stride + j, src, ok);
      }
    }
  };
  auto elu_rows = [&](float* dst, int stride, int n) {
    if (vec) {
      for (int e = tid; e < kChunk * n / 4; e += kThreads) {
        const int c = e / (n / 4), g = e - c * (n / 4);
        float4* d = reinterpret_cast<float4*>(dst + c * stride + 4 * g);
        *d = elu4(*d);
      }
    } else {
      for (int e = tid; e < kChunk * n; e += kThreads) {
        const int c = e / n, j = e - c * n;
        dst[c * stride + j] = acx_elu(dst[c * stride + j]);
      }
    }
  };

  // ---- k3 conv: acc[r][t] = sum_{c, k} w1[m][c][k] * ELU(xpad)[c][t + k]
  // over the window t0 - 4 .. t0 + TT - 1 (two spare positions keep the
  // rows' float4 groups aligned with x's)
  auto load1 = [&](int q, int s) {
    float* st = work + s * L::kStage1;
    if (!RES) {
      const float* src = w1p + (size_t)q * L::kW1;
      for (int e = tid; e < L::kW1 / 4; e += kThreads)
        acx_cp_async16(st + 4 * e, src + 4 * e);
    }
    copy_rows(st + (RES ? 0 : L::kW1), Wp, q, t0 - 4, Wp);
  };

  float acc[RM1][kRT];
#pragma unroll
  for (int r = 0; r < RM1; ++r)
#pragma unroll
    for (int i = 0; i < kRT; ++i) acc[r][i] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n1) load1(s, s);
    acx_cp_async_commit();
  }
  for (int q = 0; q < n1; ++q) {
    const int s = q % kStages;
    float* st = work + s * L::kStage1;
    acx_cp_async_wait<kStages - 2>();  // this thread's copies of chunk q
    elu_rows(st + (RES ? 0 : L::kW1), Wp, Wp);
    __syncthreads();  // chunk q ready; every warp is done with chunk q - 1
    const int next = q + kStages - 1;
    if (next < n1) load1(next, next % kStages);
    acx_cp_async_commit();
    const float* wq = (RES ? rw1 + q * L::kW1 : st) + cg * RM1;
    const float* xs = st + (RES ? 0 : L::kW1) + sa;
#pragma unroll 2
    for (int c = 0; c < kChunk; ++c) {
      // output t = sa + i reads window t + 2 + k (and 32 on for run b)
      const float* xr = xs + c * Wp;
      const float2 a0 = *reinterpret_cast<const float2*>(xr + 2);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + 4);
      const float2 b0 = *reinterpret_cast<const float2*>(xr + 34);
      const float4 b1v = *reinterpret_cast<const float4*>(xr + 36);
      const float va[6] = {a0.x, a0.y, a1.x, a1.y, a1.z, a1.w};
      const float vb[6] = {b0.x, b0.y, b1v.x, b1v.y, b1v.z, b1v.w};
#pragma unroll
      for (int k = 0; k < 3; ++k)
        fma_tile<RM1>(acc, wq + (c * 3 + k) * M1p, va + k, vb + k);
    }
  }
  acx_cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // ---- the 1x1 convs, in passes of P2 output channels: per pass ny
  // chunks of w2 over h, then n1 chunks of ws over raw x
  float* hs = work;                // [M1p][TT]
  float* ring2 = work + M1p * TT;  // two stages of kStage2
  const int nq = ny + n1, n2 = nq * (Cp / P2);
  auto load2 = [&](int j, int s) {
    const int pass = j / nq, r = j - pass * nq;
    const bool sc = r >= ny;  // a shortcut chunk
    const int q = sc ? r - ny : r;
    float* st = ring2 + s * L::kStage2;
    if (!RES) {
      const float* src =
          (sc ? wsp : w2p) + (size_t)q * kChunk * Cp + pass * P2;
      for (int e = tid; e < kChunk * P2 / 4; e += kThreads) {
        const int row = e / (P2 / 4), c4 = e - row * (P2 / 4);
        acx_cp_async16(st + row * P2 + 4 * c4, src + row * Cp + 4 * c4);
      }
    }
    if (sc) copy_rows(st + L::kW2, TT, q, t0, TT);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n2) load2(s, s);
    acx_cp_async_commit();
  }
  // h[m][t] = ELU(acc + b1[m]); rows m >= Hc are zero
#pragma unroll
  for (int r = 0; r < RM1; ++r) {
    const int m = cg * RM1 + r;
    const bool live = m < Hc;
    const float bias = live ? __ldg(b1 + m) : 0.f;
    float v[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
      v[i] = live ? acx_elu(acc[r][i] + bias) : 0.f;
    float* hp = hs + m * TT + sa;
    *reinterpret_cast<float4*>(hp) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(hp + 32) = make_float4(v[4], v[5], v[6], v[7]);
  }

  // One chain at a time: after a pass's w2 chunks its outputs hold
  // y + b2 (parked in `out`, an L2 hit when read back by the same thread);
  // after its ws chunks they become (s + bs) + (y + b2).
  float acc2[RM2][kRT];
#pragma unroll
  for (int r = 0; r < RM2; ++r)
#pragma unroll
    for (int i = 0; i < kRT; ++i) acc2[r][i] = 0.f;

  for (int j = 0; j < n2; ++j) {
    const int s = j % kStages;
    const int pass = j / nq, r = j - pass * nq;
    acx_cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk j (and, at j = 0, h) ready
    const int next = j + kStages - 1;
    if (next < n2) load2(next, next % kStages);
    acx_cp_async_commit();
    const float* st = ring2 + s * L::kStage2;
    const bool sc = r >= ny;
    const int q = sc ? r - ny : r;
    const int wstride = RES ? Cp : P2;
    const float* wq =
        (RES ? (sc ? rws : rw2) + q * kChunk * Cp + pass * P2 : st) + cg * RM2;
    // acc2[o][t] += w2[o][m] h[m][t], then += ws[o][c] x[c][t]
    const float* vr = (sc ? st + L::kW2 : hs + q * kChunk * TT) + sa;
#pragma unroll 2
    for (int c = 0; c < kChunk; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(vr + c * TT);
      const float4 u = *reinterpret_cast<const float4*>(vr + c * TT + 32);
      const float va[4] = {a.x, a.y, a.z, a.w};
      const float vb[4] = {u.x, u.y, u.z, u.w};
      fma_tile<RM2>(acc2, wq + c * wstride, va, vb);
    }
    if (r != ny - 1 && r != nq - 1) continue;
    const bool last = r == nq - 1;  // else the branch is done: park it
#pragma unroll
    for (int r2 = 0; r2 < RM2; ++r2) {
      const int o = pass * P2 + cg * RM2 + r2;
      if (o < C) {
        const float bias = __ldg((last ? bs : b2) + o);
        float* orow = ob + (size_t)o * T + t0 + sa;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + sa + 32 * h;
          float* d = orow + 32 * h;
          if (vec) {
            if (t >= T) continue;
            float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
            if (last) y = *reinterpret_cast<const float4*>(d);
            const float* a = acc2[r2] + 4 * h;
            *reinterpret_cast<float4*>(d) =
                last ? make_float4((a[0] + bias) + y.x, (a[1] + bias) + y.y,
                                   (a[2] + bias) + y.z, (a[3] + bias) + y.w)
                     : make_float4(a[0] + bias, a[1] + bias, a[2] + bias,
                                   a[3] + bias);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (t + i < T) {
                const float v = acc2[r2][4 * h + i] + bias;
                d[i] = last ? v + d[i] : v;
              }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRT; ++i) acc2[r2][i] = 0.f;
    }
  }
  acx_cp_async_wait<0>();
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, const float*, float*, int, int, int);

struct Plan {
  Kernel kernel;
  size_t smem;  // bytes a block
  int tile;     // time samples a block
};

template <int WM, int RM1, int RM2, int MINB, bool RES>
Plan pick(int C, int Hc) {
  using L = Tile<WM, RM1, RM2, RES>;
  return {seanet_resblock_kernel<WM, RM1, RM2, MINB, RES>,
          sizeof(float) * (size_t)L::floats(C, Hc), L::TT};
}

// The tile for (C, Hc) and the attribute that lets it take its shared
// memory. The table is mirrored by ops/seanet_resblock.py::_TILES.
cudaError_t prepare(int C, int Hc, Plan* plan) {
  if (C < 1 || Hc < 1 || C > kMaxChannels || Hc > kMaxChannels)
    return cudaErrorInvalidValue;
  *plan = Hc <= 16 && C <= 32   ? pick<1, 4, 8, 2, true>(C, Hc)
          : Hc <= 32 && C <= 64 ? pick<2, 4, 8, 2, true>(C, Hc)
          : Hc <= 64            ? pick<4, 4, 8, 2, false>(C, Hc)
          : Hc <= 128           ? pick<8, 4, 8, 2, false>(C, Hc)
                                : pick<8, 12, 8, 1, false>(C, Hc);
  return cudaFuncSetAttribute(plan->kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)plan->smem);
}


// ---------------------------------------------------------------------------
// The one-pass form (precision "default"): the TPU kernel
// audiocodecs_tpu/ops/seanet_block_pallas.py:96 (seanet_resblock_pallas)
// at precision_name="default", its DEFAULT dots one bf16 pass with fp32
// sums, here on the tensor cores. Rounding points:
//
//     h   = bf16(ELU(x_padded))                (the k3 conv's operand)
//     h2  = bf16(ELU(sum h . bf16(w1) + b1))   (the 1x1 conv's operand)
//     out = (sum bf16(x) . bf16(ws) + bs) + (sum h2 . bf16(w2) + b2)
//
// in fp32 from the sums on, written once in x's type (float, or bf16: the
// reference's casts around its f32-only kernel, fused into the load and the
// store). Only the order of the fp32 sums inside a dot may differ from the
// plain version (ops/seanet_resblock.py::default_head, default_tail). The
// weights come packed by the wrapper as wgmma's B operand
// (ops/seanet_resblock.py::pack_resblock_weights, precision "default").
//
// Bound: 6 C^2 FLOPs a sample in one bf16 pass against x read once and out
// written once. At EnCodec's decoder shapes (B = 8 x 10 s at 24 kHz,
// C = 32 .. 256) it is bound by bytes: 0.198 ms over the four in bf16,
// 0.396 in fp32, at 3.35 TB/s. Beside the MMAs a sample takes 1.5 C ELUs
// (expm1f) on the CUDA cores: the window's C and h2's C / 2.
//
// Design: two implicit GEMMs with time on M (an item is 64 samples of one
// batch row, wgmma's M) and channels on N and K, on wgmma.mma_async (bf16
// operands in shared memory, fp32 sums), fed through mbarrier rings by
// warps of their own. Blocks are persistent: gridDim.x blocks (blocks an
// SM x SMs) walk the B * ceil(T / 64) items gridDim.x apart, so the rings
// run on from one item into the next. A block is warps 0-3, the consumer
// warpgroup; warps 4-7, the transform warps; and where weights stream,
// warp 8, the producer.
// - x: where the rows of x start on 16 bytes (T * sizeof(x) a multiple of
//   16), each item's raw tiles, RC channels x 72 samples from t0 - 8 in
//   x's own type, come by TMA (a 3-D tensor map over [B][C][T]; positions
//   before 0 or past T and channels past C arrive as zeros) into a ring
//   of SR stages, SR - 1 tiles ahead of the transform warps. Their
//   producer is the transform warps' thread 0 (resident weights) or the
//   producer warp's lane 0. Elsewhere the transform warps read x straight
//   from global memory (chosen at launch: flags bit 0).
// - The transform warps issue no MMA. They turn the raw tiles into the
//   item's stage of the op ring, two operands in wgmma's K-major layout
//   without swizzle (16-byte rows of 8 channels, planes of 8 channels):
//   bf16(ELU(x)) over the window t0 - 2 .. t0 + 63 (the k3 conv's) and
//   bf16(x) over t0 .. t0 + 63 (the shortcut's). A thread takes 8 channels
//   at two rows 32 apart a step: reads of consecutive samples across the
//   warp and whole 16-byte rows written (no bank conflict), 16 ELUs with
//   no branch (elu_for_bf16); the two halo rows go one element a thread,
//   positions -2 and -1 from halo [B, C, 2].
// - The consumer warpgroup issues every MMA:
//   - the k3 conv, m64nNP1k16 in ceil(Hc / NP1) passes: tap k reads the
//     window at a row offset of k (the descriptor's start + k * 16 bytes),
//     so the window is rounded once, not once a tap. While it runs, the
//     previous item's last outputs are stored. Epilogue: h2 =
//     bf16(ELU(acc + b1)) into a staging buffer in the same K-major
//     layout, the 1x1's A operand;
//   - then per pass of NP2 output channels the shortcut (K = C) and the
//     1x1 (K = Hc) into two accumulator sets; the op stage goes back to
//     the transform warps; (s + bs) + (y + b2) staged transposed to
//     [NP2][64] fp32 (XOR swizzled: no bank conflict on either side);
//     then each thread writes 16 bytes of a channel row (4 fp32 or 8 bf16
//     samples; scalars at a ragged edge or where the rows of out are not
//     16-byte aligned, flags bit 1).
//   - weights: at C <= 128 (98,304 bytes at most) a block loads them once,
//     three bulk copies (RES), and keeps them. Wider blocks stream them
//     item by item through a ring of SW stages of 12,288 bytes (two k3
//     chunks, or six of the 1x1 or the shortcut), refilled by the producer
//     warp's lane 1 with cp.async.bulk as soon as the 4 consumer warps
//     have released a stage. No consumer lane produces: a producer branch
//     inside the consumer serialises its wgmmas (ptxas C7520).
// - Occupancy: 2 blocks an SM at C <= 64, so that one block's waits and
//   epilogues overlap the other's transform and MMAs; one at C = 128 (the
//   resident weights) and above, where the op ring's two stages (69,632
//   bytes at C = 256) keep the item at 64 samples.
// - h2_out and k3_out (null on the model's path) receive h2 and the k3
//   conv's fp32 value before its rounding, so that a check can hold the
//   kernel to its plain version one rounding point at a time.
// What sets the time on the H100 (clock64 spans per role, PERF.md): the
// consumer's chain an item (k3 MMAs, h2's ELUs, the second GEMM, the
// staged store), each step short of work at C <= 64 and the wgmmas of
// N <= 64 far below the tensor cores' rate; at C = 256 the weight ring.
// Every instance's layout is Cfg below (ops/seanet_resblock.py::
// _mma_layout mirrors it); seanet_resblock_default_info() reports
// registers, local bytes, shared bytes and blocks an SM.
namespace mma {

using namespace sm90;

constexpr int kTile = 64;          // samples an item (wgmma's M)
constexpr int kRows = kTile + 8;   // window rows; raw tile samples
constexpr int kChunk = 16;         // input channels a K chunk
constexpr int kWG = 128;           // threads of a warpgroup
constexpr int kWStage = 12288;     // bytes of a streamed weight stage
constexpr int kSmemLimit = 232448;  // shared bytes a block may take
constexpr int kSmemSM = 233472;     // an SM's, 1,024 reserved a block

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int round128(int n) {
  return (n + 127) / 128 * 128;
}

// An instance: C <= CP and Hc <= HP; the k3 conv in passes of NP1 hidden
// channels, the 1x1 and the shortcut in passes of NP2 output channels;
// MINB blocks an SM; SO op stages; weights resident (RES) or streamed; raw
// tiles of RC channels.
// Shared memory, in this order: barriers; b1, bs, b2 as fp32; the weights
// (RES) or their ring (SW stages); the op ring; h2; the output staging;
// the raw ring (SR stages, as many as the budget leaves, at most 4).
template <typename TIn, int CP_, int HP_, int NP1_, int NP2_, int MINB_,
          int SO_, bool RES_, int RC_>
struct Cfg {
  using T = TIn;
  static constexpr int CP = CP_, HP = HP_, NP1 = NP1_, NP2 = NP2_;
  static constexpr int MINB = MINB_, SO = SO_, RC = RC_;
  static constexpr bool RES = RES_;
  static constexpr int XW = 4;  // transform warps
  // accumulator sets of the k3 conv over resident weights: one a tap
  // (three independent wgmma chains), but one for all taps where two
  // blocks an SM would spill three sets of 16 registers
  static constexpr int TS = MINB == 2 && NP1 > 16 ? 1 : 3;
  // the consumer warpgroup, the transform warps and, where weights
  // stream, the producer warp
  static constexpr int kThreads = 32 * (4 + XW + (RES ? 0 : 1));
  static constexpr int S1 = 3 * NP1 * 32;  // a k3 chunk's weights, 3 taps
  static constexpr int S2 = NP2 * 32;      // a 1x1 or shortcut chunk's
  static constexpr int G1 = kWStage / S1;  // k3 chunks a weight stage holds
  static constexpr int G2 = kWStage / S2;  // 1x1 or shortcut chunks
  static constexpr int kBudget =
      MINB == 1 ? kSmemLimit : kSmemSM / MINB - 1024;
  static constexpr int kBars = 256;
  static constexpr int kConsts = round128(4 * (HP + 2 * CP));
  static constexpr int kWRes = RES ? 8 * HP * CP + 2 * CP * CP : 0;
  static constexpr int kWin = kRows * CP * 2;        // the k3 operand
  static constexpr int kOp = kWin + kTile * CP * 2;  // + the shortcut's
  static constexpr int kH2 = kTile * HP * 2;
  static constexpr int kOst = NP2 * kTile * 4;
  static constexpr int kRaw = RC * kRows * (int)sizeof(TIn);
  static constexpr int kFixed =
      kBars + kConsts + kWRes + SO * kOp + kH2 + kOst;
  static constexpr int SR = RES ? cmin(4, (kBudget - kFixed) / kRaw) : 2;
  static constexpr int SW =
      RES ? 0 : cmin(8, (kBudget - kFixed - SR * kRaw) / kWStage);
  static constexpr int oConsts = kBars;
  static constexpr int oW = oConsts + kConsts;
  static constexpr int oOp = oW + (RES ? kWRes : SW * kWStage);
  static constexpr int oH2 = oOp + SO * kOp;
  static constexpr int oOst = oH2 + kH2;
  static constexpr int oRaw = oOst + kOst;
  static constexpr int kBytes = oRaw + SR * kRaw;
  static_assert(SR >= 2, "two raw stages");
  static_assert(RES || SW >= 2, "two weight stages");
  static_assert(kBytes <= kBudget, "the block's shared memory");
  static_assert(2 * (SO + SR + (RES ? 1 : SW)) <= kBars / 8, "the barriers");
  static_assert(G1 >= 1 && G2 >= 1 && HP % NP1 == 0 && CP % NP2 == 0,
                "the passes");
  static_assert(CP % RC == 0 && RC % 32 == 0, "whole raw tiles");
};

template <typename TIn>
using CfgA = Cfg<TIn, 32, 16, 16, 32, 2, 2, true, 32>;
template <typename TIn>
using CfgB = Cfg<TIn, 64, 32, 32, 32, 2, 2, true, 64>;
template <typename TIn>
using CfgC = Cfg<TIn, 128, 64, 64, 64, 1, 2, true, 64>;
template <typename TIn>
using CfgD = Cfg<TIn, 256, 128, 64, 64, 1, 2, false, 32>;
template <typename TIn>
using CfgE = Cfg<TIn, 384, 384, 64, 64, 1, 1, false, 32>;

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the box of a 3-D tensor map at (c0, c1, c2), innermost first
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
// the consumer warpgroup's barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWG) : "memory");
}

// m64nNk16 (accumulator lists: ACX_D8 in sm90.cuh)
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : ACX_D8(0)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : ACX_D8(0), ACX_D8(8)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACX_D8(0), ACX_D8(8), ACX_D8(16), ACX_D8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The rings' barriers: full (filled) and empty (released) of each stage.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;
};

// Where item `it` of a launch starts, and how many items block blockIdx.x
// walks.
__device__ __forceinline__ void item_at(int it, int ntt, int& b, int& t0) {
  b = it / ntt;
  t0 = (it - b * ntt) * kTile;
}
__device__ __forceinline__ int block_items(int nitems) {
  return ((int)blockIdx.x < nitems)
             ? (nitems - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
             : 0;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Values that round to bf16(acx_elu(v)) for every v, at a third of
// expm1f's instructions: for v <= 0, expm1(v) from a degree-8 polynomial
// (v > -0.5; truncation below 0.2 fp32 ulp) or ex2.approx (below), kept
// where it lies more than kEluMargin fp32 ulps from a bf16 rounding
// midpoint; expm1f itself where it does not (about one value in 4,000).
// The fast value and expm1f's then lie on the same side of every
// midpoint, so they round alike: seanet_resblock_elu_check() compares the
// two over every float (at most 3 ulps apart on the H100). The fast
// values of a whole array come first, without a branch, so that the
// compiler interleaves them; the rare fix-up after.
constexpr uint32_t kEluMargin = 8;
__device__ __forceinline__ float elu_fast(float v) {
  float p = fmaf(v, 2.48015873e-05f, 1.98412698e-04f);
  p = fmaf(v, p, 1.38888889e-03f);
  p = fmaf(v, p, 8.33333333e-03f);
  p = fmaf(v, p, 4.16666667e-02f);
  p = fmaf(v, p, 1.66666667e-01f);
  p = fmaf(v, p, 0.5f);
  p = fmaf(v, p, 1.f);
  const float near0 = v * p;
  const float far = ex2_approx(v * 1.44269504f) - 1.f;
  return v > 0.f ? v : v > -0.5f ? near0 : far;
}
// fast value y of v too near a bf16 rounding midpoint to keep
__device__ __forceinline__ bool elu_near(float v, float y) {
  const uint32_t low = __float_as_uint(y) & 0xFFFFu;
  return !(v > 0.f) && low - (0x8000u - kEluMargin) <= 2u * kEluMargin;
}
template <int N>
__device__ __forceinline__ void elu_for_bf16(const float (&v)[N],
                                             float (&y)[N]) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    y[i] = elu_fast(v[i]);
    any |= elu_near(v[i], y[i]);
  }
  if (any) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (elu_near(v[i], y[i])) y[i] = expm1f(v[i]);
  }
}

// The weights as the consumer reads them: resident (RES: loaded once,
// every chunk at a fixed address) or streamed through the weight ring.
// Stream item i of an item's per_item: the k3 chunks (p1n passes x nq
// chunks, G1 a stage), then for each of the p2n passes the shortcut's nq
// chunks and the 1x1's nqh, G2 a stage.
template <class L>
struct Weights {
  const __nv_bfloat16* w1f;
  const __nv_bfloat16* w2f;
  const __nv_bfloat16* wsf;
  unsigned char* base;  // the resident weights or the ring
  Ring wr;
  int nq, nqh, p1n, p2n, g1, gs, gh, per_item, total, k;

  __device__ void setup(int C, int Hc, int items) {
    nq = (C + kChunk - 1) / kChunk;
    nqh = (Hc + kChunk - 1) / kChunk;
    p1n = (Hc + L::NP1 - 1) / L::NP1;
    p2n = (C + L::NP2 - 1) / L::NP2;
    g1 = (nq + L::G1 - 1) / L::G1;
    gs = (nq + L::G2 - 1) / L::G2;
    gh = (nqh + L::G2 - 1) / L::G2;
    per_item = p1n * g1 + p2n * (gs + gh);
    total = items * per_item;
    k = 0;
  }
  // resident: the byte offsets of the three packed tensors
  __device__ int ws_at() const { return p1n * nq * L::S1; }
  __device__ int w2_at() const { return ws_at() + p2n * nq * L::S2; }

  // the producer's copy of stream item `item` into its stage
  __device__ void issue(int item) {
    const int s = item % wr.stages, i = item % per_item;
    const unsigned char* src;
    uint32_t bytes;
    if (i < p1n * g1) {
      const int p = i / g1, q0 = (i - p * g1) * L::G1;
      src = reinterpret_cast<const unsigned char*>(w1f) +
            ((size_t)p * nq + q0) * L::S1;
      bytes = cmin(L::G1, nq - q0) * L::S1;
    } else {
      const int j = i - p1n * g1, p = j / (gs + gh), g = j - p * (gs + gh);
      const bool sc = g < gs;
      const int q0 = (sc ? g : g - gs) * L::G2, n = sc ? nq : nqh;
      src = reinterpret_cast<const unsigned char*>(sc ? wsf : w2f) +
            ((size_t)p * n + q0) * L::S2;
      bytes = cmin(L::G2, n - q0) * L::S2;
    }
    mbar_expect_tx(&wr.full[s], bytes);
    bulk_copy(base + s * kWStage, src, bytes, &wr.full[s]);
  }
  // the producer: every weight of the block (resident: the three tensors
  // at once; streamed: each item once its stage is released)
  __device__ void produce() {
    if constexpr (L::RES) {
      const int ws = ws_at(), w2 = w2_at(), end = w2 + p2n * nqh * L::S2;
      mbar_expect_tx(wr.full, end);
      bulk_copy(base, w1f, ws, wr.full);
      bulk_copy(base + ws, wsf, w2 - ws, wr.full);
      bulk_copy(base + w2, w2f, end - w2, wr.full);
    } else {
      for (int i = 0; i < total; ++i) {
        mbar_wait(&wr.empty[i % wr.stages], ((i / wr.stages) & 1) ^ 1);
        issue(i);
      }
    }
  }
  // the consumer: the next streamed stage, once filled (its address)
  __device__ uint32_t acquire() {
    const int s = k % wr.stages;
    mbar_wait(&wr.full[s], (k / wr.stages) & 1);
    __syncwarp();  // each lane left its spin on its own
    ++k;
    return smem_u32(base + s * kWStage);
  }
  // the consumer: streamed item `item` read (its wgmma group complete)
  __device__ void release(int item) {
    mbar_arrive_warp(&wr.empty[item % wr.stages]);
  }
};

// The transform warps: each item's raw tiles into its op stage. A raw
// tile's main unit is 8 channels at two window rows 32 apart (rows
// 2 + jj and 34 + jj, positions t0 + jj and t0 + 32 + jj), so that
// consecutive threads read consecutive samples of a channel and write
// consecutive 16-byte rows, and a tile of 32 channels is one unit a
// thread; the two halo rows (positions t0 - 2, t0 - 1) go one element a
// thread. Through TMA the raw tile holds zeros past T and past C, so the
// main units take no branch. With resident weights their thread 0 is the
// producer of x (and of the weights, first), which keeps SR - 1 raw tiles
// in flight ahead of the warps; where weights stream, the producer warp
// is.
template <class L>
__device__ __forceinline__ void transform_role(
    const CUtensorMap* xmap, Weights<L>& w,
    const typename L::T* __restrict__ x,
    const typename L::T* __restrict__ halo, unsigned char* smem, Ring rr,
    Ring opr, int B, int C, int Hc, int T, bool tma) {
  using TIn = typename L::T;
  constexpr int kXT = L::XW * 32;     // transform threads
  constexpr int kGroups = L::RC / 8;  // 8-channel groups of a raw tile
  const int xt = threadIdx.x - kWG;  // 0 .. kXT - 1
  const int ntt = (T + kTile - 1) / kTile, nitems = B * ntt;
  const int my = block_items(nitems);
  const int nr = (C + L::RC - 1) / L::RC;  // raw tiles an item
  const int units = my * nr;
  unsigned char* raw_ring = smem + L::oRaw;

  // the producer: raw tile k of the block into stage k % SR, once the
  // transform warps have released the stage's previous tile
  const bool producer = L::RES && xt == 0;
  auto issue = [&](int k) {
    const int s = k % rr.stages, n = k / nr, r = k - n * nr;
    mbar_wait(&rr.empty[s], ((k / rr.stages) & 1) ^ 1);
    int b, t0;
    item_at((int)blockIdx.x + n * (int)gridDim.x, ntt, b, t0);
    mbar_expect_tx(&rr.full[s], L::kRaw);
    tma_load_3d(raw_ring + s * L::kRaw, xmap, t0 - 8, r * L::RC, b,
                &rr.full[s]);
  };
  if (producer) {
    if constexpr (L::RES) {
      w.setup(C, Hc, my);
      w.produce();
    }
    if (tma)
      for (int k = 0; k < rr.stages - 1 && k < units; ++k) issue(k);
  }
  __syncwarp();

  for (int n = 0; n < my; ++n) {
    int b, t0;
    item_at((int)blockIdx.x + n * (int)gridDim.x, ntt, b, t0);
    const int so = n % L::SO;
    mbar_wait(&opr.empty[so], ((n / L::SO) & 1) ^ 1);
    unsigned char* win = smem + L::oOp + so * L::kOp;
    unsigned char* sc = win + L::kWin;
    const TIn* xb = x + (size_t)b * C * T;
    for (int r = 0; r < nr; ++r) {
      const int u = n * nr + r, s = u % rr.stages;
      if (tma) {
        if (producer && u + rr.stages - 1 < units) issue(u + rr.stages - 1);
        __syncwarp();
        mbar_wait(&rr.full[s], (u / rr.stages) & 1);
      }
      const TIn* raw = reinterpret_cast<const TIn*>(raw_ring + s * L::kRaw);
#pragma unroll 1
      for (int e = xt; e < kGroups * 32; e += kXT) {
        const int g8 = e >> 5, jj = e & 31, c0 = r * L::RC + 8 * g8;
        float v[16];  // rows 2 + jj (v[0..7]) and 34 + jj (v[8..15])
        if (tma) {
          const TIn* src = raw + 8 * g8 * kRows + 8 + jj;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[i] = to_f(src[i * kRows]);
            v[8 + i] = to_f(src[i * kRows + 32]);
          }
        } else {
          const int pa = t0 + jj, pz = pa + 32;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool live = c0 + i < C;
            const TIn* src = xb + (size_t)(c0 + i) * T;
            v[i] = live && pa < T ? to_f(__ldg(src + pa)) : 0.f;
            v[8 + i] = live && pz < T ? to_f(__ldg(src + pz)) : 0.f;
          }
        }
        float h[16];
        elu_for_bf16(v, h);
        uint4* wrow = reinterpret_cast<uint4*>(win) + (c0 / 8) * kRows + 2 + jj;
        uint4* srow = reinterpret_cast<uint4*>(sc) + (c0 / 8) * kTile + jj;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* hh = h + 8 * half;
          const float* vv = v + 8 * half;
          wrow[32 * half] =
              make_uint4(bf16x2(hh[0], hh[1]), bf16x2(hh[2], hh[3]),
                         bf16x2(hh[4], hh[5]), bf16x2(hh[6], hh[7]));
          srow[32 * half] =
              make_uint4(bf16x2(vv[0], vv[1]), bf16x2(vv[2], vv[3]),
                         bf16x2(vv[4], vv[5]), bf16x2(vv[6], vv[7]));
        }
      }
      // the halo rows: channel c = r RC + e % RC, row j = e / RC
      for (int e = xt; e < 2 * L::RC; e += kXT) {
        const int cl = e % L::RC, j = e / L::RC, c = r * L::RC + cl;
        const int p = t0 - 2 + j;
        const float v[1] = {
            c >= C  ? 0.f
            : p < 0 ? to_f(halo[((size_t)b * C + c) * 2 + p + 2])
            : tma   ? to_f(raw[cl * kRows + 6 + j])
                    : to_f(__ldg(xb + (size_t)c * T + p))};
        float h[1];
        elu_for_bf16(v, h);
        *reinterpret_cast<__nv_bfloat16*>(win + ((c / 8) * kRows + j) * 16 +
                                          (c % 8) * 2) =
            __float2bfloat16_rn(h[0]);
      }
      if (tma) mbar_arrive_warp(&rr.empty[s]);
    }
    fence_proxy_async();
    mbar_arrive_warp(&opr.full[so]);
  }
}

// The producer warp, where weights stream: lane 0 loads x's raw tiles
// through TMA (each once the transform warps have released its stage),
// lane 1 moves every weight item of the block into the weight ring (each
// once the consumer has released its stage). The two lanes run apart;
// each spins only on its own ring.
template <class L>
__device__ __forceinline__ void producer_role(const CUtensorMap* xmap,
                                              Weights<L>& w,
                                              unsigned char* smem, Ring rr,
                                              int B, int C, int Hc, int T,
                                              bool tma) {
  const int lane = threadIdx.x % 32;
  const int ntt = (T + kTile - 1) / kTile;
  const int my = block_items(B * ntt);
  if (lane == 0 && tma) {
    const int nr = (C + L::RC - 1) / L::RC;
    unsigned char* raw_ring = smem + L::oRaw;
    for (int k = 0; k < my * nr; ++k) {
      const int s = k % rr.stages, n = k / nr, r = k - n * nr;
      mbar_wait(&rr.empty[s], ((k / rr.stages) & 1) ^ 1);
      int b, t0;
      item_at((int)blockIdx.x + n * (int)gridDim.x, ntt, b, t0);
      mbar_expect_tx(&rr.full[s], L::kRaw);
      tma_load_3d(raw_ring + s * L::kRaw, xmap, t0 - 8, r * L::RC, b,
                  &rr.full[s]);
    }
  } else if (lane == 1) {
    w.setup(C, Hc, my);
    w.produce();
  }
}

// The consumer's sums of a 1x1 GEMM over resident weights: acc (+)=
// sum over nc K chunks of A(q) . B(q); A's chunk q at a_at + q * a_step
// (LBO a_lbo), B's at b_at + q * bstride. Issued only: the caller fences
// before and commits and waits after.
template <int N>
__device__ __forceinline__ void mma_resident(float (&acc)[N / 2],
                                             uint32_t a_at, int a_step,
                                             int a_lbo, uint32_t b_at,
                                             int bstride, int nc) {
#pragma unroll 1
  for (int q = 0; q < nc; ++q)
    Wgmma<N>::run(acc, make_desc(a_at + q * a_step, a_lbo, 128),
                  make_desc(b_at + q * bstride, N * 16, 128), q != 0);
}

// The k3 conv over resident weights: tap k (A at a row offset of k, B at
// k * N * 32 bytes into the chunk) into accumulator set a_k where SETS is
// 3, three independent chains of wgmmas in place of one, which the caller
// sums, (a_0 + a_1) + a_2 (another order of the fp32 sum); every tap into
// a_0 where SETS is 1. Issued only.
template <int N, int SETS>
__device__ __forceinline__ void mma_taps(float (&a0)[N / 2],
                                         float (&a1)[N / 2],
                                         float (&a2)[N / 2], uint32_t a_at,
                                         int a_step, int a_lbo, uint32_t b_at,
                                         int bstride, int nc) {
  constexpr uint64_t kTapB = N * 32 / 16;
#pragma unroll 1
  for (int q = 0; q < nc; ++q) {
    const uint64_t da = make_desc(a_at + q * a_step, a_lbo, 128);
    const uint64_t db = make_desc(b_at + q * bstride, N * 16, 128);
    Wgmma<N>::run(a0, da, db, q != 0);
    if constexpr (SETS == 3) {
      Wgmma<N>::run(a1, da + 1, db + kTapB, q != 0);
      Wgmma<N>::run(a2, da + 2, db + 2 * kTapB, q != 0);
    } else {
      Wgmma<N>::run(a0, da + 1, db + kTapB, 1);
      Wgmma<N>::run(a0, da + 2, db + 2 * kTapB, 1);
    }
  }
}

// The same over streamed weights, g chunks a stage (bstride bytes a
// chunk), each stage released once the group that read it is done;
// complete on return.
template <class L, int N, int TAPS>
__device__ __forceinline__ void mma_streamed(float (&acc)[N / 2],
                                             Weights<L>& w, uint32_t a_at,
                                             int a_step, int a_lbo,
                                             int bstride, int nc, int g) {
  constexpr uint64_t kTapB = N * 32 / 16;
  const int ng = (nc + g - 1) / g;
  for (int gi = 0; gi < ng; ++gi) {
    const int item = w.k;
    const uint32_t st = w.acquire();
    wgmma_fence();
    const int n = cmin(g, nc - gi * g);
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const int q = gi * g + c;
      const uint64_t da = make_desc(a_at + q * a_step, a_lbo, 128);
      const uint64_t db = make_desc(st + c * bstride, N * 16, 128);
#pragma unroll 1
      for (int k = 0; k < TAPS; ++k)
        Wgmma<N>::run(acc, da + k, db + k * kTapB, (q | k) != 0);
    }
    wgmma_commit();
    if (gi > 0) {
      wgmma_wait<1>();  // the group before is done with its stage
      w.release(item - 1);
    }
  }
  wgmma_wait<0>();
  w.release(w.k - 1);
  fence_acc(acc);
}

// One pass's outputs from the staging into out: V samples of one channel
// row a thread, 16 bytes (4 fp32 or 8 bf16; scalars at a ragged edge or
// where the rows of out are not 16-byte aligned).
template <class L>
__device__ __forceinline__ void store_pass(const float* ost,
                                           typename L::T* __restrict__ out,
                                           int wt, int b, int t0, int p,
                                           int C, int T, bool vec) {
  using TIn = typename L::T;
  constexpr int N2 = L::NP2, V = 16 / (int)sizeof(TIn), kVecs = kTile / V;
  for (int i = wt; i < N2 * kVecs; i += kWG) {
    const int ol = i / kVecs, tv = (i - ol * kVecs) * V;
    const int o = p * N2 + ol, t = t0 + tv;
    if (o >= C || t >= T) continue;
    const float* src = ost + ol * kTile + (tv ^ (8 * ((ol / 2) % 4)));
    TIn* dst = out + ((size_t)b * C + o) * T + t;
    float f[V];
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    } else {
      // the two halves in the order that keeps a quarter warp on 32
      // distinct banks
      const bool first = ((tv >> 5) & 1) == 0;
      const float4 a = *reinterpret_cast<const float4*>(src + (first ? 0 : 4));
      const float4 c = *reinterpret_cast<const float4*>(src + (first ? 4 : 0));
      const float4 lo = first ? a : c, hi = first ? c : a;
      f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
      f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
    }
    if (vec && t + V <= T) {
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      else
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                       bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (t + e < T) dst[e] = from_f<TIn>(f[e]);
    }
  }
}

// The consumer warpgroup: every MMA, h2's epilogue and the output. An
// item's k3 conv is issued (resident weights), then the previous item's
// last outputs are stored while it runs.
template <class L>
__device__ __forceinline__ void consumer_role(
    Weights<L>& w, const float* consts, unsigned char* smem, Ring opr,
    typename L::T* __restrict__ out, __nv_bfloat16* __restrict__ h2_out,
    float* __restrict__ k3_out, int B, int C, int Hc, int T, bool vec) {
  constexpr int N1 = L::NP1, N2 = L::NP2;
  static_assert(!L::RES || L::HP == N1, "resident: one k3 pass");
  const int wt = threadIdx.x, warp = wt / 32, lane = wt % 32;
  const int g = lane / 4, tig = lane % 4, row0 = 16 * warp + g;
  const int ntt = (T + kTile - 1) / kTile, nitems = B * ntt;
  const int my = block_items(nitems);
  const bool stages = h2_out != nullptr || k3_out != nullptr;
  const float* b1 = consts;
  const float* bs = consts + L::HP;
  const float* b2 = consts + L::HP + L::CP;
  unsigned char* h2s = smem + L::oH2;
  float* ost = reinterpret_cast<float*>(smem + L::oOst);
  const uint32_t h2a = smem_u32(h2s);
  const uint32_t wres = smem_u32(w.base);
  w.setup(C, Hc, my);
  if constexpr (L::RES) mbar_wait(w.wr.full, 0);
  __syncwarp();
  int pend_b = -1, pend_t0 = 0;  // the item whose last pass awaits its store

  for (int n = 0; n < my; ++n) {
    int b, t0;
    item_at((int)blockIdx.x + n * (int)gridDim.x, ntt, b, t0);
    const int so = n % L::SO;
    mbar_wait(&opr.full[so], (n / L::SO) & 1);
    __syncwarp();
    const uint32_t wina = smem_u32(smem + L::oOp + so * L::kOp);
    const uint32_t sca = wina + L::kWin;
    // k3 conv: acc[t][m] = sum_{q, k} window[t + k][c] w1[m][c][k] (A:
    // the window at a row offset of k; resident weights: mma_taps)
    float acc[N1 / 2], acc1[N1 / 2], acc2[N1 / 2];
    if constexpr (L::RES) {
      wgmma_fence();
      mma_taps<N1, L::TS>(acc, acc1, acc2, wina, 2 * kRows * 16, kRows * 16,
                          wres, L::S1, w.nq);
      wgmma_commit();
    }
    if (pend_b >= 0) {  // the previous item's last pass, while these run
      store_pass<L>(ost, out, wt, pend_b, pend_t0, w.p2n - 1, C, T, vec);
      consumer_sync();  // the staging is free again
    }
    for (int p = 0; p < w.p1n; ++p) {
      if constexpr (L::RES) {
        wgmma_wait<0>();
        fence_acc(acc);
        if constexpr (L::TS == 3) {
          fence_acc(acc1);
          fence_acc(acc2);
#pragma unroll
          for (int r = 0; r < N1 / 2; ++r)
            acc[r] = (acc[r] + acc1[r]) + acc2[r];
        }
      } else {
        mma_streamed<L, N1, 3>(acc, w, wina, 2 * kRows * 16, kRows * 16,
                               L::S1, w.nq, L::G1);
      }
      // h2 = bf16(ELU(acc + b1)) of the hidden channels m of pass p into
      // h2s, channel m of row t at ((m / 8) * 64 + t) * 16 + (m % 8) * 2
      // (channels >= Hc come out 0: acc 0, b1 0), 8 accumulators a step
#pragma unroll
      for (int r0 = 0; r0 < N1 / 2; r0 += 8) {
        float v[8], h[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = acc[r0 + i] +
                 b1[p * N1 + 8 * ((r0 + i) / 4) + 2 * tig + i % 2];
        elu_for_bf16(v, h);
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const int r = r0 + i, m = p * N1 + 8 * (r / 4) + 2 * tig;
          const int row = row0 + 8 * ((r / 2) % 2);
          const uint32_t hv = bf16x2(h[i], h[i + 1]);
          *reinterpret_cast<uint32_t*>(h2s + ((m / 8) * kTile + row) * 16 +
                                       (m % 8) * 2) = hv;
          if (stages && t0 + row < T) {
            const size_t at = ((size_t)b * Hc + m) * T + t0 + row;
            const __nv_bfloat162 hh =
                *reinterpret_cast<const __nv_bfloat162*>(&hv);
            if (m < Hc) {
              if (h2_out != nullptr) h2_out[at] = hh.x;
              if (k3_out != nullptr) k3_out[at] = v[i];
            }
            if (m + 1 < Hc) {
              if (h2_out != nullptr) h2_out[at + T] = hh.y;
              if (k3_out != nullptr) k3_out[at + T] = v[i + 1];
            }
          }
        }
      }
    }
    fence_proxy_async();
    consumer_sync();  // h2 complete, visible to wgmma

    // per pass of N2 output channels o: the shortcut s and the 1x1 y in
    // two accumulator sets, then out = (s + bs) + (y + b2) into the
    // staging, channel ol = o - p N2 of row t at
    // ol * 64 + (t ^ 8 ((ol / 2) % 4))
    for (int p = 0; p < w.p2n; ++p) {
      float accs[N2 / 2], accy[N2 / 2];
      if constexpr (L::RES) {
        wgmma_fence();
        mma_resident<N2>(accs, sca, 2 * kTile * 16, kTile * 16,
                         wres + w.ws_at() + p * w.nq * L::S2, L::S2, w.nq);
        mma_resident<N2>(accy, h2a, 2 * kTile * 16, kTile * 16,
                         wres + w.w2_at() + p * w.nqh * L::S2, L::S2, w.nqh);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(accs);
        fence_acc(accy);
      } else {
        mma_streamed<L, N2, 1>(accs, w, sca, 2 * kTile * 16, kTile * 16,
                               L::S2, w.nq, L::G2);
        mma_streamed<L, N2, 1>(accy, w, h2a, 2 * kTile * 16, kTile * 16,
                               L::S2, w.nqh, L::G2);
      }
      if (p == w.p2n - 1) mbar_arrive_warp(&opr.empty[so]);  // op read
#pragma unroll
      for (int r0 = 0; r0 < N2 / 2; r0 += 8) {
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ol = p * N2 + 8 * ((r0 + i) / 4) + 2 * tig + i % 2;
          o[i] = (accs[r0 + i] + bs[ol]) + (accy[r0 + i] + b2[ol]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + i, ol = 8 * (r / 4) + 2 * tig + r % 2;
          const int row = row0 + 8 * ((r / 2) % 2);
          ost[ol * kTile + (row ^ (8 * ((ol / 2) % 4)))] = o[i];
        }
      }
      consumer_sync();  // the pass's outputs complete
      if (p < w.p2n - 1) {
        store_pass<L>(ost, out, wt, b, t0, p, C, T, vec);
        consumer_sync();  // the staging is free again
      }
    }
    pend_b = b, pend_t0 = t0;
  }
  if (pend_b >= 0)
    store_pass<L>(ost, out, wt, pend_b, pend_t0, w.p2n - 1, C, T, vec);
}

template <class L>
__global__ void __launch_bounds__(L::kThreads, L::MINB)
    seanet_resblock_mma_kernel(
        const __grid_constant__ CUtensorMap xmap,       // x as [B][C][T]
        const typename L::T* __restrict__ x,            // [B, C, T]
        const typename L::T* __restrict__ halo,         // [B, C, 2]
        const __nv_bfloat16* __restrict__ w1f,          // packed
        const typename L::T* __restrict__ b1,           // [Hc]
        const __nv_bfloat16* __restrict__ w2f,          // packed
        const typename L::T* __restrict__ b2,           // [C]
        const __nv_bfloat16* __restrict__ wsf,          // packed
        const typename L::T* __restrict__ bs,           // [C]
        typename L::T* __restrict__ out,                // [B, C, T]
        __nv_bfloat16* __restrict__ h2_out,             // or null
        float* __restrict__ k3_out,                     // or null
        int B, int C, int Hc, int T, int flags) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const Ring opr{bars, bars + L::SO, L::SO};
  const Ring rr{bars + 2 * L::SO, bars + 2 * L::SO + L::SR, L::SR};
  uint64_t* wb = bars + 2 * (L::SO + L::SR);
  const int ws = L::RES ? 1 : L::SW;
  const Ring wr{wb, wb + ws, ws};
  float* consts = reinterpret_cast<float*>(smem + L::oConsts);

  for (int i = threadIdx.x; i < L::HP; i += L::kThreads)
    consts[i] = i < Hc ? to_f(b1[i]) : 0.f;
  for (int i = threadIdx.x; i < L::CP; i += L::kThreads) {
    consts[L::HP + i] = i < C ? to_f(bs[i]) : 0.f;
    consts[L::HP + L::CP + i] = i < C ? to_f(b2[i]) : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::SO; ++s) {
      mbar_init(&opr.full[s], L::XW);      // the transform warps
      mbar_init(&opr.empty[s], kWG / 32);  // the consumer warps
    }
    for (int s = 0; s < L::SR; ++s) {
      mbar_init(&rr.full[s], 1);           // the producer's expect_tx
      mbar_init(&rr.empty[s], L::XW);      // the transform warps
    }
    for (int s = 0; s < ws; ++s) {
      mbar_init(&wr.full[s], 1);           // the producer's expect_tx
      mbar_init(&wr.empty[s], kWG / 32);   // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one branch a role, on a warp index the compiler sees is uniform:
  // warps 0-3 the consumer warpgroup, then the transform warps, then
  // (weights streamed) the producer warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  Weights<L> w{w1f, w2f, wsf, smem + L::oW, wr};
  if (warp < 4) {
    consumer_role<L>(w, consts, smem, opr, out, h2_out, k3_out, B, C, Hc, T,
                     (flags & 2) != 0);
  } else if (warp < 4 + L::XW) {
    transform_role<L>(&xmap, w, x, halo, smem, rr, opr, B, C, Hc, T,
                      (flags & 1) != 0);
  } else {
    producer_role<L>(&xmap, w, smem, rr, B, C, Hc, T, (flags & 1) != 0);
  }
}

// Every float v (NaNs aside): elu_for_bf16 of v against acx_elu(v) rounded
// to bf16; counts the v where they differ, and the largest distance in
// fp32 ulps of the fast value from expm1f where it was taken.
__global__ void elu_check_kernel(unsigned long long* mismatches,
                                 unsigned int* max_ulps) {
  unsigned long long bad = 0;
  unsigned int far = 0;
  for (unsigned long long i =
           (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float v = __uint_as_float((uint32_t)i);
    if (v != v) continue;
    const float in[1] = {v};
    float y[1];
    elu_for_bf16(in, y);
    const float fast = y[0], ref = acx_elu(v);
    const __nv_bfloat16 a = __float2bfloat16_rn(fast);
    const __nv_bfloat16 c = __float2bfloat16_rn(ref);
    if (*reinterpret_cast<const uint16_t*>(&a) !=
        *reinterpret_cast<const uint16_t*>(&c))
      ++bad;
    if (fast != ref) {
      const int d = (int)__float_as_uint(fast) - (int)__float_as_uint(ref);
      far = max(far, (unsigned int)(d < 0 ? -d : d));
    }
  }
  if (bad) atomicAdd(mismatches, bad);
  atomicMax(max_ulps, far);
}

// cuTensorMapEncodeTiled from the driver, which the runtime has loaded
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The instance for (C, Hc, bf16): its kernel, layout and blocks an SM.
struct Instance {
  const void* kernel;
  int id, smem, rc, threads, per_sm;
};

template <class L>
Instance instance(int id) {
  return {reinterpret_cast<const void*>(seanet_resblock_mma_kernel<L>), id,
          L::kBytes, L::RC, L::kThreads, 0};
}

template <typename TIn>
Instance pick(int C, int Hc, int id0) {
  return C <= 32 && Hc <= 16     ? instance<CfgA<TIn>>(id0)
         : C <= 64 && Hc <= 32   ? instance<CfgB<TIn>>(id0 + 1)
         : C <= 128 && Hc <= 64  ? instance<CfgC<TIn>>(id0 + 2)
         : C <= 256 && Hc <= 128 ? instance<CfgD<TIn>>(id0 + 3)
                                 : instance<CfgE<TIn>>(id0 + 4);
}

// The instance, with the attributes that let it take its shared memory at
// its blocks an SM, set once a device, and those blocks an SM.
constexpr int kDevices = 16, kInstances = 10;
cudaError_t prepare(int C, int Hc, bool bf16, Instance* inst) {
  if (C < 1 || Hc < 1 || C > kMaxChannels || Hc > kMaxChannels)
    return cudaErrorInvalidValue;
  *inst = bf16 ? pick<__nv_bfloat16>(C, Hc, 5) : pick<float>(C, Hc, 0);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int per_sm[kDevices][kInstances];  // 0 until prepared
  if (dev < kDevices && per_sm[dev][inst->id] > 0) {
    inst->per_sm = per_sm[dev][inst->id];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      inst->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, inst->smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(inst->kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &inst->per_sm, inst->kernel, inst->threads, inst->smem);
  if (err != cudaSuccess) return err;
  if (inst->per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < kDevices) per_sm[dev][inst->id] = inst->per_sm;
  return cudaSuccess;
}

}  // namespace mma

}  // namespace

ACX_EXPORT int seanet_resblock_f32(const float* x, const float* halo,
                                   const float* w1p, const float* b1,
                                   const float* w2p, const float* b2,
                                   const float* wsp, const float* bs,
                                   float* out, int B, int C, int Hc, int T,
                                   void* stream) {
  if (B < 1 || T < 1) return cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t err = prepare(C, Hc, &plan);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + plan.tile - 1) / plan.tile, B);
  plan.kernel<<<grid, kThreads, plan.smem, (cudaStream_t)stream>>>(
      x, halo, w1p, b1, w2p, b2, wsp, bs, out, C, Hc, T);
  return cudaGetLastError();
}

// Registers and local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM and time samples a block of the tile that
// seanet_resblock_f32 launches for (C, Hc).
ACX_EXPORT int seanet_resblock_info(int C, int Hc, int* regs,
                                    int* local_bytes, int* smem_bytes,
                                    int* blocks_per_sm, int* tile) {
  Plan plan;
  cudaError_t err = prepare(C, Hc, &plan);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, plan.kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, plan.kernel, kThreads, plan.smem);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)plan.smem;
  *tile = plan.tile;
  return cudaSuccess;
}

// The one-pass form: x, halo, b1, b2, bs and out are float, or bf16 when
// bf16 != 0; w1f, w2f and wsf are the packed weights
// (ops/seanet_resblock.py::pack_resblock_weights); h2_out (bf16
// [B, Hc, T]) and k3_out (float [B, Hc, T]) may be null.
ACX_EXPORT int seanet_resblock_default(const void* x, const void* halo,
                                       const void* w1f, const void* b1,
                                       const void* w2f, const void* b2,
                                       const void* wsf, const void* bs,
                                       void* out, void* h2_out, void* k3_out,
                                       int B, int C, int Hc, int T, int bf16,
                                       void* stream) {
  if (B < 1 || T < 1) return cudaErrorInvalidValue;
  mma::Instance inst;
  const cudaError_t err = mma::prepare(C, Hc, bf16 != 0, &inst);
  if (err != cudaSuccess) return err;
  const int sms = acx_num_sms();
  if (sms < 1) return cudaErrorInvalidDevice;
  // x through TMA where its rows start on 16 bytes; out in 16-byte
  // vectors likewise
  const size_t esize = bf16 ? 2 : 4;
  const bool rows16 = (size_t)T * esize % 16 == 0;
  int flags =
      (rows16 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 1 : 0) |
      (rows16 && reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 2 : 0);
  alignas(64) CUtensorMap xmap = {};
  if (flags & 1) {
    const mma::EncodeTiled encode = mma::encode_tiled();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    const cuuint64_t dims[3] = {(cuuint64_t)T, (cuuint64_t)C, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)T * esize,
                                   (cuuint64_t)T * C * esize};
    const cuuint32_t box[3] = {(cuuint32_t)mma::kRows, (cuuint32_t)inst.rc,
                               1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&xmap,
               bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               3, const_cast<void*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  void* args[] = {&xmap, &x,      &halo,   &w1f, &b1, &w2f, &b2, &wsf, &bs,
                  &out,  &h2_out, &k3_out, &B,   &C,  &Hc,  &T,  &flags};
  // persistent: per_sm blocks an SM, each walking items gridDim.x apart
  const long items = (long)B * ((T + mma::kTile - 1) / mma::kTile);
  const long slots = (long)inst.per_sm * sms;
  const dim3 grid((unsigned)(items < slots ? items : slots));
  const cudaError_t launch =
      cudaLaunchKernel(inst.kernel, grid, dim3(inst.threads), args,
                       inst.smem, (cudaStream_t)stream);
  return launch != cudaSuccess ? launch : cudaGetLastError();
}

// Registers and local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM and time samples an item of the one-pass instance
// for (C, Hc) on float (bf16 = 0) or bf16 operands.
ACX_EXPORT int seanet_resblock_default_info(int C, int Hc, int bf16,
                                            int* regs, int* local_bytes,
                                            int* smem_bytes,
                                            int* blocks_per_sm, int* tile) {
  mma::Instance inst;
  cudaError_t err = mma::prepare(C, Hc, bf16 != 0, &inst);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, inst.kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = inst.smem;
  *blocks_per_sm = inst.per_sm;
  *tile = mma::kTile;
  return cudaSuccess;
}

// The fast ELU of the one-pass kernel against expm1f over every float:
// the count of values whose bf16 roundings differ (0 is right) and the
// largest distance, in fp32 ulps, of a fast value from expm1f's.
ACX_EXPORT int seanet_resblock_elu_check(unsigned long long* mismatches,
                                         unsigned int* max_ulps) {
  unsigned long long* d_bad = nullptr;
  unsigned int* d_far = nullptr;
  cudaError_t err = cudaMalloc(&d_bad, sizeof(*d_bad));
  if (err == cudaSuccess) err = cudaMalloc(&d_far, sizeof(*d_far));
  if (err == cudaSuccess) err = cudaMemset(d_bad, 0, sizeof(*d_bad));
  if (err == cudaSuccess) err = cudaMemset(d_far, 0, sizeof(*d_far));
  if (err == cudaSuccess) {
    mma::elu_check_kernel<<<1024, 256>>>(d_bad, d_far);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(mismatches, d_bad, sizeof(*d_bad), cudaMemcpyDeviceToHost);
  if (err == cudaSuccess)
    err = cudaMemcpy(max_ulps, d_far, sizeof(*d_far), cudaMemcpyDeviceToHost);
  cudaFree(d_bad);
  cudaFree(d_far);
  return err;
}

ACX_EXPORT const char* seanet_resblock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
