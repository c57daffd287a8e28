// Fused SEANet residual block, fp32, for sm_90a:
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

ACX_EXPORT const char* seanet_resblock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
