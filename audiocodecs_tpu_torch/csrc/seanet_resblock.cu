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
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

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
// The one-pass form (precision "default"): the reference kernel's DEFAULT
// dots, one bf16 pass with fp32 sums, on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, fp32 accumulators). Rounding points:
//
//     h   = bf16(ELU(x_padded))                (the k3 conv's operand)
//     h2  = bf16(ELU(sum h . bf16(w1) + b1))   (the 1x1 conv's operand)
//     out = (sum bf16(x) . bf16(ws) + bs) + (sum h2 . bf16(w2) + b2)
//
// in fp32 from the sums on, written once in x's type (float, or bf16: the
// reference's casts around its f32-only kernel, fused into the load and the
// store). The weights come packed by the wrapper as bf16 B fragments
// (ops/seanet_resblock.py::pack_resblock_weights, precision "default").
//
// Bound: 6 C^2 FLOPs a sample, one bf16 pass: at EnCodec's decoder shapes
// (B = 8, C = 256..32) it is bound by bytes (x in, out written).
//
// Design: time on the MMA's M side, channels on N and K, so Hc = 16 at
// C = 32 is two n-tiles, not a padded m-tile.
// - One block of 256 threads (8 warps) per (time tile of TT samples,
//   batch): TT = 128 when C and Hc are at most 128, else 64.
// - The block first turns its window, positions t0 - 2 .. t0 + TT - 1 of
//   every channel (t < 0 from the halo, t >= T zero), into two bf16
//   windows in shared memory, time-major (a row holds every channel, 16
//   spare bytes a row against bank conflicts): ELU(x) for the k3 conv and
//   x for the shortcut. Each tap of the k3 conv is then an ldmatrix of the
//   same window shifted by one row.
// - k3 conv: M = TT, N = Hc, K = 3 x C. A warp takes items of one m-tile
//   (16 samples) x four n-tiles (32 hidden channels), and reads each B
//   fragment once per mma from global memory (L1/L2: every block reads the
//   same weights). Its epilogue writes h2 into shared memory.
// - 1x1 conv and shortcut: M = TT, N = C, K = Hc (over h2) and C (over the
//   raw window), two accumulator sets, combined in the reference's order.
// - h2_out and k3_out (null on the model's path) receive h2 and the k3
//   conv's fp32 value before its rounding, so that a check can hold the
//   kernel to its plain version one rounding point at a time.
// Shared memory: 2 (TT + 2) rows of C channels and TT rows of Hc, at most
// 153,664 bytes (C = Hc = 384). Budget on the H100 (seanet_resblock_
// default_info, PERF.md): 64 registers, no spills, at every EnCodec width;
// 26,944 / 47,680 / 89,152 / 87,104 shared bytes and 4 / 4 / 2 / 2 blocks
// an SM at C = 32 / 64 / 128 / 256. Right and simple first: the loads of
// the window are scalar, and each B fragment comes from L1 per mma.
namespace mma {

constexpr int kNW = 4;  // n-tiles of 8 channels in a warp's item

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
// bytes of a time-major row of n bf16 channels: 16 spare bytes keep the 8
// rows an ldmatrix reads on distinct banks
__host__ __device__ constexpr int row_bytes(int n) {
  return 2 * round16(n) + 16;
}

inline int tile_of(int C, int Hc) { return C <= 128 && Hc <= 128 ? 128 : 64; }

inline int smem_bytes(int C, int Hc) {
  const int TT = tile_of(C, Hc);
  return 2 * (TT + 2) * row_bytes(C) + TT * row_bytes(Hc);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a * b: a 16 x 16 bf16 A fragment (time x input channels), a 16 x 8
// bf16 B fragment (input x output channels), fp32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The A fragment of rows r0 .. r0 + 15 and the 16 channels of chunk q of a
// time-major window with rows of `row` bytes: lanes 0-15 address the rows'
// first 8 channels, lanes 16-31 their last 8 (ldmatrix's four matrices are
// then a0..a3 of mma.m16n8k16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const unsigned char* win, int row,
                                       int r0, int q, int lane) {
  ldmatrix_x4(a, win + (r0 + (lane & 15)) * row + q * 32 + (lane >> 4) * 16);
}

template <typename TIn, int TT>
__global__ void __launch_bounds__(kThreads)
    seanet_resblock_mma_kernel(const TIn* __restrict__ x,     // [B, C, T]
                               const TIn* __restrict__ halo,  // [B, C, 2]
                               const uint2* __restrict__ w1f,  // fragments
                               const TIn* __restrict__ b1,     // [Hc]
                               const uint2* __restrict__ w2f,  // fragments
                               const TIn* __restrict__ b2,     // [C]
                               const uint2* __restrict__ wsf,  // fragments
                               const TIn* __restrict__ bs,     // [C]
                               TIn* __restrict__ out,          // [B, C, T]
                               __nv_bfloat16* __restrict__ h2_out,  // or null
                               float* __restrict__ k3_out,          // or null
                               int C, int Hc, int T) {
  constexpr int W = TT + 2, MT = TT / 16, kWarps = kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // the MMA's group and thread
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int xrow = row_bytes(C), hrow = row_bytes(Hc);
  unsigned char* win = smem;                // [W] rows: bf16(ELU(x_pad))
  unsigned char* raw = smem + W * xrow;     // [W] rows: bf16(x_pad)
  unsigned char* h2s = raw + W * xrow;      // [TT] rows: h2
  const TIn* xb = x + (size_t)b * C * T;
  const TIn* hb = halo + (size_t)b * C * 2;

  // the windows, a channel pair at one position a step (consecutive
  // threads read consecutive samples of a row); zero past C and T
  const int npairs = round16(C) / 2;
  for (int e = tid; e < npairs * W; e += kThreads) {
    const int cp = e / W, j = e - cp * W, p = t0 - 2 + j;
    float v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ch = 2 * cp + u;
      v[u] = ch >= C  ? 0.f
             : p < 0  ? to_f(hb[ch * 2 + p + 2])
             : p < T  ? to_f(__ldg(xb + (size_t)ch * T + p))
                      : 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(win + j * xrow + 4 * cp) =
        __floats2bfloat162_rn(acx_elu(v[0]), acx_elu(v[1]));
    *reinterpret_cast<__nv_bfloat162*>(raw + j * xrow + 4 * cp) =
        __floats2bfloat162_rn(v[0], v[1]);
  }
  // h2's padding channels (Hc .. round16(Hc)) must read zero
  for (int e = tid; e < TT * hrow / 16; e += kThreads)
    reinterpret_cast<uint4*>(h2s)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // ---- k3 conv: acc[t][m] = sum_{c, k} h[t + k][c] w1[m][c][k]
  const int nq1 = round16(C) / 16, nt1 = (Hc + 7) / 8;
  const int ng1 = (nt1 + kNW - 1) / kNW;
  for (int item = warp; item < MT * ng1; item += kWarps) {
    const int mt = item % MT, nt0 = (item / MT) * kNW;
    float acc[kNW][4] = {};
    for (int q = 0; q < nq1; ++q)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint32_t a[4];
        load_a(a, win, xrow, mt * 16 + k, q, lane);
        const uint2* bf = w1f + ((size_t)(k * nq1 + q) * nt1 + nt0) * 32 + lane;
#pragma unroll
        for (int n = 0; n < kNW; ++n)
          if (nt0 + n < nt1) mma_bf16(acc[n], a, __ldg(bf + n * 32));
      }
    // h2[t][m] = bf16(ELU(acc + b1[m])); channels m >= Hc are zero
#pragma unroll
    for (int n = 0; n < kNW; ++n) {
      if (nt0 + n >= nt1) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = (nt0 + n) * 8 + 2 * tig + e;
        const bool live = m < Hc;
        const float bias = live ? to_f(b1[m]) : 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = mt * 16 + g + 8 * hr, t = t0 + r;
          const float v = acc[n][2 * hr + e] + bias;
          const __nv_bfloat16 hv = __float2bfloat16_rn(live ? acx_elu(v) : 0.f);
          *reinterpret_cast<__nv_bfloat16*>(h2s + r * hrow + 2 * m) = hv;
          if (live && t < T) {
            const size_t at = ((size_t)b * Hc + m) * T + t;
            if (h2_out != nullptr) h2_out[at] = hv;
            if (k3_out != nullptr) k3_out[at] = v;
          }
        }
      }
    }
  }
  __syncthreads();  // h2 complete

  // ---- the 1x1 conv over h2 and the shortcut over raw x
  const int nqh = round16(Hc) / 16, nt2 = (C + 7) / 8;
  const int ng2 = (nt2 + kNW - 1) / kNW;
  for (int item = warp; item < MT * ng2; item += kWarps) {
    const int mt = item % MT, nt0 = (item / MT) * kNW;
    float accy[kNW][4] = {}, accs[kNW][4] = {};
    for (int q = 0; q < nqh; ++q) {
      uint32_t a[4];
      load_a(a, h2s, hrow, mt * 16, q, lane);
      const uint2* bf = w2f + ((size_t)q * nt2 + nt0) * 32 + lane;
#pragma unroll
      for (int n = 0; n < kNW; ++n)
        if (nt0 + n < nt2) mma_bf16(accy[n], a, __ldg(bf + n * 32));
    }
    for (int q = 0; q < nq1; ++q) {
      uint32_t a[4];
      load_a(a, raw, xrow, mt * 16 + 2, q, lane);
      const uint2* bf = wsf + ((size_t)q * nt2 + nt0) * 32 + lane;
#pragma unroll
      for (int n = 0; n < kNW; ++n)
        if (nt0 + n < nt2) mma_bf16(accs[n], a, __ldg(bf + n * 32));
    }
    // out = (s + bs) + (y + b2), rounded once to x's type
#pragma unroll
    for (int n = 0; n < kNW; ++n) {
      if (nt0 + n >= nt2) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = (nt0 + n) * 8 + 2 * tig + e;
        if (o >= C) continue;
        const float sb = to_f(bs[o]), yb = to_f(b2[o]);
        TIn* orow = out + ((size_t)b * C + o) * T;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = t0 + mt * 16 + g + 8 * hr;
          if (t < T)
            orow[t] = from_f<TIn>((accs[n][2 * hr + e] + sb) +
                                  (accy[n][2 * hr + e] + yb));
        }
      }
    }
  }
}

// The instance for (C, Hc, bf16), its shared bytes a block and its time
// tile, and the attribute that lets it take its shared memory.
cudaError_t prepare(int C, int Hc, bool bf16, const void** kernel,
                    size_t* smem, int* tile) {
  if (C < 1 || Hc < 1 || C > kMaxChannels || Hc > kMaxChannels)
    return cudaErrorInvalidValue;
  *tile = tile_of(C, Hc);
  *smem = (size_t)smem_bytes(C, Hc);
  if (bf16)
    *kernel = *tile == 128
        ? reinterpret_cast<const void*>(
              seanet_resblock_mma_kernel<__nv_bfloat16, 128>)
        : reinterpret_cast<const void*>(
              seanet_resblock_mma_kernel<__nv_bfloat16, 64>);
  else
    *kernel = *tile == 128
        ? reinterpret_cast<const void*>(seanet_resblock_mma_kernel<float, 128>)
        : reinterpret_cast<const void*>(seanet_resblock_mma_kernel<float, 64>);
  return cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
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
// bf16 != 0; w1f, w2f and wsf are the packed B fragments; h2_out (bf16
// [B, Hc, T]) and k3_out (float [B, Hc, T]) may be null.
ACX_EXPORT int seanet_resblock_default(const void* x, const void* halo,
                                       const void* w1f, const void* b1,
                                       const void* w2f, const void* b2,
                                       const void* wsf, const void* bs,
                                       void* out, void* h2_out, void* k3_out,
                                       int B, int C, int Hc, int T, int bf16,
                                       void* stream) {
  if (B < 1 || T < 1) return cudaErrorInvalidValue;
  const void* kernel = nullptr;
  size_t smem = 0;
  int tile = 0;
  const cudaError_t err =
      mma::prepare(C, Hc, bf16 != 0, &kernel, &smem, &tile);
  if (err != cudaSuccess) return err;
  void* args[] = {&x,  &halo, &w1f,    &b1,     &w2f, &b2, &wsf,
                  &bs, &out,  &h2_out, &k3_out, &C,   &Hc, &T};
  const dim3 grid((T + tile - 1) / tile, B);
  const cudaError_t launch = cudaLaunchKernel(
      kernel, grid, dim3(kThreads), args, smem, (cudaStream_t)stream);
  return launch != cudaSuccess ? launch : cudaGetLastError();
}

// Registers and local (spill) bytes a thread, shared bytes a block,
// resident blocks an SM and time samples a block of the one-pass instance
// for (C, Hc) on float (bf16 = 0) or bf16 operands.
ACX_EXPORT int seanet_resblock_default_info(int C, int Hc, int bf16,
                                            int* regs, int* local_bytes,
                                            int* smem_bytes,
                                            int* blocks_per_sm, int* tile) {
  const void* kernel = nullptr;
  size_t smem = 0;
  cudaError_t err = mma::prepare(C, Hc, bf16 != 0, &kernel, &smem, tile);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)smem;
  return cudaSuccess;
}

ACX_EXPORT const char* seanet_resblock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
