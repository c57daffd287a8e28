// One LSTM layer's recurrence over precomputed input gates, fp32, for sm_90a.
//
// Replaces the TPU kernel audiocodecs_tpu/ops/lstm_pallas.py::_pallas_impl
// (kernel body `_kernel`), which keeps all of w_hh [H, 4H] in VMEM and walks
// time in one core's sequential grid. On Hopper w_hh does not fit in one SM
// (4 MB at H = 512 against 227 KB of shared memory), and blocks run in no
// order, so the layer is spread over the card: one persistent cooperative
// grid of H / U blocks; block j owns U hidden units and all four gate
// columns of them (G = 4U columns), so the cell update is block-local, and
// the time loop runs inside the kernel.
//
// Bound: the FLOPs (2*T*B*H*4H, 12.6 GFLOP at T=750, B=8, H=512) take
// ~0.19 ms at the FP32 CUDA-core peak. No T-step dependency chain reaches
// that: the floor is T hand-offs of h from SM to SM through L2 (measured by
// lstm_handoff_probe). A step is kept to one such hand-off and a short
// chain of on-chip work:
//
//   * No grid barrier in the time loop. h_t is published as 8-byte
//     {value, tag = t + 1} pairs, each one 64-bit st.relaxed.gpu, into a
//     double-buffered exchange [2][B][Hp]. The data carries its own
//     readiness, so there is no fence and no flag: a consumer loads its
//     pairs with ld.relaxed.gpu, all at once (up to kPoll a thread in
//     flight), and reloads those whose tag is not yet t until none is left.
//     Slot t % 2 is free again at step t + 2: a block gets there only after
//     reading every block's h_{t+1}, which each block wrote only after
//     reading h_t. The exchange is cleared before the loop behind the
//     kernel's one grid.sync(), so tags left by an earlier launch in reused
//     memory never match. The cooperative launch keeps every block
//     resident, which the spin-waits need.
//   * Each warp waits only for the k slice of h_{t-1} that its part of the
//     product reads, and starts on it at once (__syncwarp); one
//     __syncthreads a step gathers the warps' partial sums.
//   * gx off the critical path: each gate thread loads its gate input of
//     step t+1 into a register at the top of step t, before its wait.
//   * The [B, H] x [H, 4U] product uses all 8 warps whatever B is: thread
//     (c, kg) owns column c and a k range of KP rows, the k ranges split
//     across warps, and its KP weights stay in registers for the whole
//     sequence (32 at H = 512, 128 at H = 1024; no spills). Partial sums
//     meet by shuffles inside a warp and through a double-buffered shared
//     array across warps.
//   * The gate math runs one thread a gate column; the four gates of a unit
//     share a warp (G divides 32) and meet by shuffles.
//   * Every wait traps after kMaxPolls polls, so a broken exchange fails
//     the launch instead of hanging the card.
//
// Exactness: plain fp32 FMAs on the CUDA cores (no TF32, no fast math;
// expf and tanhf as in common.cuh). Only the summation order of the product
// differs from the plain version.
//
// Inputs: gates_x [T, ldb, 4H] (x @ w_ih + b, gate order i, f, g, o),
// w_hh [H, 4H], h0/c0 [B, H]. Outputs: ys [T, ldb, H], h_T, c_T [B, H].
// Scratch: the exchange, B * lstm_recurrence_exchange_row_bytes(H) bytes
// (none at T = 1, which exchanges nothing). One launch runs B <= ldb
// consecutive batch rows (the pointers are offset to the first); shared
// memory holds B rows of h and registers the gate inputs of B rows, so the
// wrapper splits a larger batch into launches of at most
// lstm_recurrence_max_batch rows.
//
// Wide mode, 1024 < H <= 1536 (BigCodec's LSTMs at H = 1536; the TPU
// kernel's vmem_limit_bytes branch). A 1536-wide w_hh is 37.7 MB: at most
// 132 blocks can be resident at one an SM, so a block owns U = 12 units
// (ceil(H / 12) = 128 blocks) and a 1536 x 48 slice of 295 KB, more than a
// block's shared memory (227 KB) and more than an SM's register file
// (256 KB). The slice is split between the two: a separate instance,
// lstm_recurrence_kernel_wide, with 384 threads keeps 80 of each thread's
// 192 weights in registers (120 KB of the register file) and 112 in shared
// memory (172 KB), beside the h rows (6.5 KB a batch row). w_hh stays on
// chip for the whole sequence, as in the narrow instances. A thread block
// cluster sharing slices over DSMEM adds no room (the 128 blocks already
// fill 128 of the 132 SMs), and reading part of w_hh from L2 every step
// would add to the exchange's 12.6 MB of L2 reads a step (B = 8).
//   * Gate mapping: warp w owns unit j = 12 * block + w and all four of its
//     gate columns; lane l owns those four columns over k rows
//     [48 l, 48 l + 48). A float4 of h feeds 16 FMAs, and every lane reads
//     other bytes of h (a lane's 48 floats are padded to 52, so a
//     quarter-warp's float4s fall in distinct banks). One lane owning one
//     column (the first design) read h four FMAs a float4, and the
//     quarter-warp phases of those loads set the step: 17.3 ms at
//     (800, 8, 1536) on the H100.
//   * The 32 lanes' partial sums (4 gates x R rows) meet by a reduce-scatter
//     of 31 shuffles (R = 8), after which lane (gate, kg) = (l >> 3, l & 7)
//     holds that gate of row kg; lanes (0, kg) gather the other three gates
//     of their row by shuffles and keep its cell in a register. No shared
//     reduction array.
//   * Rows: the product reads R rows of h a step (R = 8, or R = 1 when
//     B = 1). A launch takes at most 8 rows; the wrapper splits larger
//     batches.
//   * Every warp reads all of h_{t-1}, so the whole block polls the exchange
//     together (B x H tagged pairs, [2][B][H], 4 rows a pass) into one h
//     buffer between two __syncthreads a step.
//   * H need not be a multiple of 12: the last block's spare warps hold zero
//     weights and publish nothing.
// Its gx, exactness, exchange and trap rules are the narrow instances'.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // batch rows a pass of the product
constexpr int kPoll = 16;      // exchange loads a thread keeps in flight
constexpr int kGateIters = 2;  // gate columns a thread: B * 4U <= 512
// Polls of one wait (seconds on the card) after which the exchange is taken
// as broken: the kernel traps, so the launch fails instead of hanging.
constexpr unsigned kMaxPolls = 1u << 25;

using u64 = unsigned long long;

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void count_poll(unsigned& polls) {
  if (++polls > kMaxPolls) __trap();
}

// A block's tile: U units (G = 4U columns), one column and KP rows of k a
// thread; the product's k range is padded to Hp = (kThreads / G) * KP.
struct Tile {
  int U, KP;
};

// Shared memory of a block, in floats: h_s [Bp][Hp], red_s [2][kWarps][Bp][G]
// and c_s [B][U].
struct Layout {
  int G, Hp, Bp;
  size_t red, c, floats;
};

__host__ __device__ inline Layout layout(Tile tile, int B) {
  Layout L;
  L.G = 4 * tile.U;
  L.Hp = kThreads / L.G * tile.KP;
  L.Bp = (B + kRows - 1) / kRows * kRows;
  L.red = (size_t)L.Bp * L.Hp;
  L.c = L.red + 2 * (size_t)kWarps * L.Bp * L.G;
  L.floats = L.c + (size_t)B * tile.U;
  return L;
}

template <int U, int KP>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_kernel(const float* __restrict__ gx,
                           const float* __restrict__ w_hh,
                           const float* __restrict__ h0,
                           const float* __restrict__ c0,
                           float* __restrict__ ys, float* __restrict__ h_out,
                           float* __restrict__ c_out, u64* pairs, int T,
                           int B, int ldb, int H) {
  constexpr int G = 4 * U;
  constexpr int Hp = kThreads / G * KP;  // a power of two
  constexpr int KW = Hp / kWarps;        // a warp's k slice
  const Layout L = layout(Tile{U, KP}, B);
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;
  float* red_s = smem + L.red;
  float* c_s = smem + L.c;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tid % G, k0 = tid / G * KP;  // this thread's column, k range
  const int j0 = blockIdx.x * U;
  const int H4 = 4 * H, BG = B * G, BU = B * U, BHp = B * Hp;
  // pairs: the exchange, [2][B][Hp] tagged pairs in h_s's layout

  // local column c = gate*U + u  <->  global column gate*H + j0 + u
  auto column = [&](int cc) { return (cc / U) * H + j0 + cc % U; };
  float w_r[KP];
  {
    const int col = column(c);
#pragma unroll
    for (int i = 0; i < KP; ++i)
      w_r[i] = k0 + i < H ? w_hh[(size_t)(k0 + i) * H4 + col] : 0.f;
  }
  // h_0; the padded rows and columns stay zero for the whole sequence
  for (int idx = tid; idx < L.Bp * Hp; idx += kThreads) {
    const int b = idx / Hp, k = idx % Hp;
    h_s[idx] = b < B && k < H ? h0[b * H + k] : 0.f;
  }
  for (int idx = tid; idx < BU; idx += kThreads)
    c_s[idx] = c0[(idx / U) * H + j0 + idx % U];

  // gate thread idx = b*G + c (idx = tid + i*kThreads) holds its gate input
  auto gx_at = [&](int t, int i) {
    const int idx = tid + i * kThreads;
    return idx < BG ? __ldg(gx + ((size_t)t * ldb + idx / G) * H4 +
                            column(idx % G))
                    : 0.f;
  };
  float gx_cur[kGateIters], gx_next[kGateIters];
#pragma unroll
  for (int i = 0; i < kGateIters; ++i) {
    gx_cur[i] = gx_at(0, i);
    gx_next[i] = 0.f;
  }

  // clear this block's part of the exchange, then the one grid barrier
  // (a single step exchanges nothing)
  if (T > 1) {
    for (int idx = tid; idx < 2 * BU; idx += kThreads) {
      const int r = idx % BU;
      pairs[(size_t)(idx / BU) * BHp + (r / U) * Hp + j0 + r % U] = 0ull;
    }
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }

  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
#pragma unroll
      for (int i = 0; i < kGateIters; ++i) gx_next[i] = gx_at(t + 1, i);
    }

    // h_{t-1} into h_s, once every producer has published it
    if (t > 0) {
      // this warp's slice: rows b < B, columns [warp*KW, warp*KW + KW)
      const u64* src = pairs + (size_t)((t - 1) & 1) * BHp;
      const unsigned want = t;
      const int BKW = B * KW;
      unsigned polls = 0;
      for (int base = lane; base < BKW; base += 32 * kPoll) {
        auto at = [&](int i) {
          const int iw = base + 32 * i;
          return (iw / KW) * Hp + warp * KW + iw % KW;
        };
        u64 v[kPoll];
#pragma unroll
        for (int i = 0; i < kPoll; ++i)
          v[i] = base + 32 * i < BKW && (at(i) & (Hp - 1)) < H
                     ? ld_relaxed(src + at(i))
                     : u64{want} << 32;
        // one round trip a pass: reload every pair not yet of step t
        for (;; count_poll(polls)) {
          unsigned miss = 0;
#pragma unroll
          for (int i = 0; i < kPoll; ++i)
            if (static_cast<unsigned>(v[i] >> 32) != want) miss |= 1u << i;
          if (!miss) break;
#pragma unroll
          for (int i = 0; i < kPoll; ++i)
            if (miss >> i & 1) v[i] = ld_relaxed(src + at(i));
        }
#pragma unroll
        for (int i = 0; i < kPoll; ++i)
          if (base + 32 * i < BKW)
            h_s[at(i)] = __uint_as_float(static_cast<unsigned>(v[i]));
      }
      __syncwarp();
    }

    // Partial products of this thread's column over its k range, kRows
    // batch rows a pass. red_s is double-buffered by step: a warp may start
    // the next step's product while others still read these sums.
    float* red = red_s + (size_t)(t & 1) * kWarps * L.Bp * G;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const float* hb = h_s + b0 * Hp + k0;
#pragma unroll
      for (int i = 0; i < KP; i += 4) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(hb + r * Hp + i);
          acc[r] = fmaf(hv.x, w_r[i], acc[r]);
          acc[r] = fmaf(hv.y, w_r[i + 1], acc[r]);
          acc[r] = fmaf(hv.z, w_r[i + 2], acc[r]);
          acc[r] = fmaf(hv.w, w_r[i + 3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int off = G; off < 32; off <<= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      if (lane < G) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (b0 + r < B) red[(warp * L.Bp + b0 + r) * G + c] = acc[r];
      }
    }
    __syncthreads();

    // Gate math, one thread a gate column, and h_t published by the thread
    // of gate i: the four gates of unit u (columns u, U+u, 2U+u, 3U+u of a
    // row) sit in one warp, since G divides 32.
    const int slot = t & 1;
#pragma unroll
    for (int i = 0; i < kGateIters; ++i) {
      const int idx = tid + i * kThreads, b = idx / G, cc = idx % G;
      if (i * kThreads >= BG) break;  // uniform across the block
      float a = 0.f;
      if (idx < BG) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[(w * L.Bp + b) * G + cc];
        const float g = gx_cur[i] + s;
        a = cc / U == 2 ? tanhf(g) : acx_sigmoid(g);
      }
      const float gf = __shfl_down_sync(0xffffffffu, a, U);
      const float gg = __shfl_down_sync(0xffffffffu, a, 2 * U);
      const float go = __shfl_down_sync(0xffffffffu, a, 3 * U);
      if (idx < BG && cc < U) {
        const int j = j0 + cc;
        const float cn = gf * c_s[b * U + cc] + a * gg;
        const float h = go * tanhf(cn);
        c_s[b * U + cc] = cn;
        if (t + 1 < T)
          st_relaxed(pairs + (size_t)slot * BHp + b * Hp + j,
                     (static_cast<u64>(t + 1) << 32) | __float_as_uint(h));
        ys[((size_t)t * ldb + b) * H + j] = h;
        if (t == T - 1) {
          h_out[b * H + j] = h;
          c_out[b * H + j] = cn;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGateIters; ++i) gx_cur[i] = gx_next[i];
  }
}

namespace wide {
constexpr int kThreads = 384;                 // 12 warps
constexpr int kUnits = kThreads / 32;         // one hidden unit a warp
constexpr int kKL = 48;                       // k rows a lane: Hp = 32 * 48
constexpr int kKR = 20;                       // of them in registers (x 4),
constexpr int kKS = kKL - kKR;                // and in shared memory (x 4)
constexpr int kSeg = kKL + 4;                 // floats of a lane's h segment
constexpr int kHs = 32 * kSeg;                // floats of an h_s row
constexpr int kMaxRows = 8;                   // batch rows a launch
constexpr int kMaxHidden = 32 * kKL;          // 1536
constexpr int kMinHidden = 1024 + 32;         // narrower H: the narrow kernel
constexpr int kPollRows = kPoll / 4;          // rows a polling pass
constexpr int kColsPerThread = 4;             // ceil(1536 / 384) k a row

// Shared memory of a block reading R rows of h: w_s [kKS][kThreads] float4
// (the four gates) and h_s [R][kHs].
constexpr size_t smem_bytes(int R) {
  return sizeof(float) * (4 * (size_t)kKS * kThreads + (size_t)R * kHs);
}
}  // namespace wide

// Sums v[0..N) (N = 4R, a power of two <= 32) over the 32 lanes, scattered:
// the level of offset o halves the values a lane keeps while more than one
// is left (the lane's bit o picks the half), then adds. Afterwards lane L
// holds the total of value L >> 3 (R = 1, the same over each 8 lanes) or
// of value L (R = 8): in both cases gate L >> 3 of row L & 7, as the values
// are ordered gate * R + row.
template <int n, int o, int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  if constexpr (o == 0) {
    return v[0];
  } else if constexpr (n > 1) {
    const bool up = lane & o;
#pragma unroll
    for (int q = 0; q < n / 2; ++q) {
      const float send = up ? v[q] : v[q + n / 2];
      const float keep = up ? v[q + n / 2] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    return reduce_scatter<n / 2, o / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    return reduce_scatter<1, o / 2>(v, lane);
  }
}

template <int R>
__global__ void __launch_bounds__(wide::kThreads, 1)
    lstm_recurrence_kernel_wide(const float* __restrict__ gx,
                                const float* __restrict__ w_hh,
                                const float* __restrict__ h0,
                                const float* __restrict__ c0,
                                float* __restrict__ ys,
                                float* __restrict__ h_out,
                                float* __restrict__ c_out, u64* pairs, int T,
                                int B, int ldb, int H) {
  // the wide layout's constants (kThreads hides the narrow instances' 256)
  constexpr int kThreads = wide::kThreads, kUnits = wide::kUnits;
  constexpr int kKL = wide::kKL, kKR = wide::kKR, kKS = wide::kKS;
  constexpr int kSeg = wide::kSeg, kHs = wide::kHs;
  constexpr int kPollRows = wide::kPollRows, kCols = wide::kColsPerThread;
  extern __shared__ __align__(16) float smem[];
  float4* w_s = reinterpret_cast<float4*>(smem);  // [kKS][kThreads]
  float* h_s = smem + 4 * kKS * kThreads;         // [R][kHs]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = blockIdx.x * kUnits + warp;  // this warp's hidden unit
  const bool unit = j < H;                   // the last block may have fewer
  const int H4 = 4 * H, k0 = lane * kKL;     // this lane's k range
  // after the reduction lane (gate, kg) = (lane >> 3, lane & 7) holds that
  // gate of row kg
  const int gate = lane >> 3, b = lane & 7;
  const bool row = unit && b < R && b < B;
  const int col = gate * H + j;
  // pairs: the exchange, [2][B][H] tagged pairs

  auto w_at = [&](int k, int g) {
    return unit && k < H ? __ldg(w_hh + (size_t)k * H4 + g * H + j) : 0.f;
  };
  float w_r[kKR][4];
#pragma unroll
  for (int i = 0; i < kKR; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) w_r[i][g] = w_at(k0 + i, g);
  for (int i = 0; i < kKS; ++i) {
    const int k = k0 + kKR + i;
    w_s[i * kThreads + tid] =
        make_float4(w_at(k, 0), w_at(k, 1), w_at(k, 2), w_at(k, 3));
  }
  // h_0; rows >= B, columns >= H and the segments' pads stay zero for the
  // whole sequence
  for (int idx = tid; idx < R * kHs; idx += kThreads) {
    const int r = idx / kHs, i = idx % kSeg, k = idx % kHs / kSeg * kKL + i;
    h_s[idx] = r < B && i < kKL && k < H ? h0[r * H + k] : 0.f;
  }
  // the h_s offsets of the k positions this thread polls in every row
  int at[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    const int k = tid + kThreads * m;
    at[m] = k < H ? k / kKL * kSeg + k % kKL : -1;
  }
  // lane (0, kg) keeps the cell of row kg
  float c = row && gate == 0 ? c0[b * H + j] : 0.f;
  auto gx_at = [&](int t) {
    return row ? __ldg(gx + ((size_t)t * ldb + b) * H4 + col) : 0.f;
  };
  float gx_cur = gx_at(0), gx_next = 0.f;

  // clear this block's part of the exchange, then the one grid barrier
  // (a single step exchanges nothing)
  const int BH = B * H;
  if (T > 1) {
    for (int idx = tid; idx < 2 * B * kUnits; idx += kThreads) {
      const int r = idx % (B * kUnits);
      const int jj = blockIdx.x * kUnits + r % kUnits;
      if (jj < H)
        pairs[(size_t)(idx / (B * kUnits)) * BH + (r / kUnits) * H + jj] =
            0ull;
    }
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }

  const float* hb = h_s + lane * kSeg;  // this lane's k range, row 0
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) gx_next = gx_at(t + 1);

    // h_{t-1} into h_s, once every producer has published it, kPollRows
    // rows a pass; the first barrier waits until every warp is done with
    // h_{t-2}
    if (t > 0) {
      __syncthreads();
      const u64* src = pairs + (size_t)((t - 1) & 1) * BH;
      const unsigned want = t;
      unsigned polls = 0;
      for (int b0 = 0; b0 < B; b0 += kPollRows) {
        auto ok = [&](int q) {
          return b0 + q / kCols < B && at[q % kCols] >= 0;
        };
        auto addr = [&](int q) {
          return src + (size_t)(b0 + q / kCols) * H + tid +
                 kThreads * (q % kCols);
        };
        u64 v[kPoll];
#pragma unroll
        for (int q = 0; q < kPoll; ++q)
          v[q] = ok(q) ? ld_relaxed(addr(q)) : u64{want} << 32;
        // one round trip a pass: reload every pair not yet of step t
        for (;; count_poll(polls)) {
          unsigned miss = 0;
#pragma unroll
          for (int q = 0; q < kPoll; ++q)
            if (static_cast<unsigned>(v[q] >> 32) != want) miss |= 1u << q;
          if (!miss) break;
#pragma unroll
          for (int q = 0; q < kPoll; ++q)
            if (miss >> q & 1) v[q] = ld_relaxed(addr(q));
        }
#pragma unroll
        for (int q = 0; q < kPoll; ++q)
          if (ok(q))
            h_s[(b0 + q / kCols) * kHs + at[q % kCols]] =
                __uint_as_float(static_cast<unsigned>(v[q]));
      }
      __syncthreads();
    }

    // the four gate columns of this warp's unit over this lane's k range,
    // R rows: registers, then shared memory; 16 FMAs a float4 of h
    float acc[4 * R];
#pragma unroll
    for (int q = 0; q < 4 * R; ++q) acc[q] = 0.f;
#pragma unroll
    for (int i = 0; i < kKR; i += 4) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hb + r * kHs + i);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float& a = acc[g * R + r];
          a = fmaf(hv.x, w_r[i][g], a);
          a = fmaf(hv.y, w_r[i + 1][g], a);
          a = fmaf(hv.z, w_r[i + 2][g], a);
          a = fmaf(hv.w, w_r[i + 3][g], a);
        }
      }
    }
#pragma unroll 1
    for (int i = 0; i < kKS; i += 4) {
      float4 w4[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) w4[m] = w_s[(i + m) * kThreads + tid];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hb + r * kHs + kKR + i);
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[0 * R + r] = fmaf(hk[m], w4[m].x, acc[0 * R + r]);
          acc[1 * R + r] = fmaf(hk[m], w4[m].y, acc[1 * R + r]);
          acc[2 * R + r] = fmaf(hk[m], w4[m].z, acc[2 * R + r]);
          acc[3 * R + r] = fmaf(hk[m], w4[m].w, acc[3 * R + r]);
        }
      }
    }
    const float s = reduce_scatter<4 * R, 16>(acc, lane);

    // gate math for gate (lane >> 3) of row (lane & 7), and the cell update
    // by lane (0, kg), which gathers the f, g and o gates of its row from
    // lanes 8, 16, 24 + kg
    const float g = gx_cur + s;
    const float a = gate == 2 ? tanhf(g) : acx_sigmoid(g);
    const float gf = __shfl_sync(0xffffffffu, a, 8 + b);
    const float gg = __shfl_sync(0xffffffffu, a, 16 + b);
    const float go = __shfl_sync(0xffffffffu, a, 24 + b);
    if (row && gate == 0) {
      const float cn = gf * c + a * gg;
      const float h = go * tanhf(cn);
      c = cn;
      if (t + 1 < T)
        st_relaxed(pairs + (size_t)(t & 1) * BH + b * H + j,
                   (static_cast<u64>(t + 1) << 32) | __float_as_uint(h));
      ys[((size_t)t * ldb + b) * H + j] = h;
      if (t == T - 1) {
        h_out[b * H + j] = h;
        c_out[b * H + j] = cn;
      }
    }
    gx_cur = gx_next;
  }
}

// The latency floor of one step: blocks 0 and 1, each holding more than
// half an SM's shared memory so that they sit on two SMs, pass a tagged pair
// back and forth `iters` times through L2, two hand-offs a round.
__global__ void lstm_handoff_probe_kernel(u64* pair, int iters) {
  if (threadIdx.x != 0) return;
  u64* mine = pair + blockIdx.x;
  const u64* other = pair + (1 - blockIdx.x);
  for (int i = 1; i <= iters; ++i) {
    if (blockIdx.x == 0) st_relaxed(mine, static_cast<u64>(i) << 32);
    for (unsigned polls = 0; static_cast<int>(ld_relaxed(other) >> 32) != i;)
      count_poll(polls);
    if (blockIdx.x == 1) st_relaxed(mine, static_cast<u64>(i) << 32);
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, float*, float*, float*, u64*, int, int,
                        int, int);

// The kernel for H. U is the smallest of {1, 2, 4, 8} whose grid (H / U
// blocks) fits on the card at one block per SM and whose padded k range
// Hp = (kThreads / 4U) * KP covers H: 256 at U = 1 and 2, 512 at U = 4,
// and at U = 8 512 with KP = 64 (only a card of fewer than 128 SMs picks
// U = 8 for H <= 512) or 1024 with KP = 128.
cudaError_t pick(int H, Tile* tile, Kernel* kernel) {
  if (H < 32 || H % 32 || H > 1024) return cudaErrorInvalidValue;
  const int sms = acx_num_sms();
  int U = 1;
  while (U < 8 && (H / U > sms || H > (U == 4 ? 512 : 256))) U *= 2;
  if (H / U > sms) return cudaErrorInvalidValue;
  const int KP = U == 1 ? 4 : U == 2 ? 8 : U == 4 ? 32 : H <= 512 ? 64 : 128;
  *tile = Tile{U, KP};
  switch (U * 1000 + KP) {
    case 1004: *kernel = lstm_recurrence_kernel<1, 4>; break;
    case 2008: *kernel = lstm_recurrence_kernel<2, 8>; break;
    case 4032: *kernel = lstm_recurrence_kernel<4, 32>; break;
    case 8064: *kernel = lstm_recurrence_kernel<8, 64>; break;
    default: *kernel = lstm_recurrence_kernel<8, 128>;
  }
  return cudaSuccess;
}

// The wide instance for a launch of B rows at 1024 < H <= 1536: R = 1 for a
// single row, else R = 8; ceil(H / 12) blocks must fit the card.
cudaError_t pick_wide(int H, int B, Kernel* kernel, size_t* smem) {
  if (H < wide::kMinHidden || H % 32 || H > wide::kMaxHidden || B < 1 ||
      B > wide::kMaxRows ||
      (H + wide::kUnits - 1) / wide::kUnits > acx_num_sms())
    return cudaErrorInvalidValue;
  if (B == 1) {
    *kernel = lstm_recurrence_kernel_wide<1>;
    *smem = wide::smem_bytes(1);
  } else {
    *kernel = lstm_recurrence_kernel_wide<wide::kMaxRows>;
    *smem = wide::smem_bytes(wide::kMaxRows);
  }
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

bool is_wide(int H) { return H >= wide::kMinHidden; }

cudaError_t prepare(int H, int B, Tile* tile, Kernel* kernel, size_t* smem) {
  cudaError_t err = pick(H, tile, kernel);
  if (err != cudaSuccess) return err;
  *smem = sizeof(float) * layout(*tile, B).floats;
  return cudaFuncSetAttribute(*kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

// Bytes of the exchange a batch row needs at H: [2][Hp] tagged pairs.
ACX_EXPORT long lstm_recurrence_exchange_row_bytes(int H) {
  Tile tile;
  Kernel kernel;
  size_t smem = 0;
  if (is_wide(H))  // [2][H] tagged pairs
    return pick_wide(H, 1, &kernel, &smem) == cudaSuccess
               ? 2L * sizeof(u64) * H
               : 0;
  if (pick(H, &tile, &kernel) != cudaSuccess) return 0;
  return 2L * sizeof(u64) * layout(tile, 1).Hp;
}

// The most batch rows one launch takes at H: the largest B whose gate
// inputs fit the threads' registers (B * 4U <= kGateIters * kThreads) and
// whose shared memory fits the card's limit; in wide mode one row a k group.
ACX_EXPORT int lstm_recurrence_max_batch(int H) {
  Tile tile;
  Kernel kernel;
  int dev = 0, optin = 0;
  if (is_wide(H)) {
    size_t smem = 0;
    return pick_wide(H, wide::kMaxRows, &kernel, &smem) == cudaSuccess
               ? wide::kMaxRows
               : 0;
  }
  if (pick(H, &tile, &kernel) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  int B = 0;
  while ((B + 1) * 4 * tile.U <= kGateIters * kThreads &&
         sizeof(float) * layout(tile, B + 1).floats <= (size_t)optin)
    ++B;
  return B;
}

// exchange: B * lstm_recurrence_exchange_row_bytes(H) bytes of device
// memory, any contents; unused (may be null) at T = 1.
ACX_EXPORT int lstm_recurrence_f32(const float* gx, const float* w_hh,
                                   const float* h0, const float* c0,
                                   float* ys, float* h_out, float* c_out,
                                   void* exchange, int T, int B, int ldb,
                                   int H, void* stream) {
  if (T < 1 || B < 1 || ldb < B || (T > 1 && !exchange))
    return cudaErrorInvalidValue;
  Tile tile;
  Kernel kernel;
  size_t smem = 0;
  const bool wide_mode = is_wide(H);
  cudaError_t err = wide_mode ? pick_wide(H, B, &kernel, &smem)
                              : prepare(H, B, &tile, &kernel, &smem);
  if (err != cudaSuccess) return err;
  u64* pairs = static_cast<u64*>(exchange);
  void* args[] = {(void*)&gx,  (void*)&w_hh,  (void*)&h0,    (void*)&c0,
                  (void*)&ys,  (void*)&h_out, (void*)&c_out, (void*)&pairs,
                  (void*)&T,   (void*)&B,     (void*)&ldb,   (void*)&H};
  const dim3 grid(wide_mode ? (H + wide::kUnits - 1) / wide::kUnits
                            : H / tile.U),
      block(wide_mode ? wide::kThreads : kThreads);
  // The spin-waits need every block resident, which the cooperative launch
  // guarantees (it refuses a grid that does not fit). A single step
  // exchanges nothing, so no block waits on another: a plain launch.
  err = T > 1 ? cudaLaunchCooperativeKernel((void*)kernel, grid, block, args,
                                            smem, (cudaStream_t)stream)
              : cudaLaunchKernel((void*)kernel, grid, block, args, smem,
                                 (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel that a launch of B rows at H runs: its registers and local
// (spill) bytes a thread, shared bytes a block, blocks an SM and units a
// block.
ACX_EXPORT int lstm_recurrence_info(int H, int B, int* regs, int* local_bytes,
                                    int* smem_bytes, int* blocks_per_sm,
                                    int* units) {
  Tile tile;
  Kernel kernel;
  size_t smem = 0;
  const bool wide_mode = is_wide(H);
  cudaError_t err = wide_mode ? pick_wide(H, B, &kernel, &smem)
                              : prepare(H, B, &tile, &kernel, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, wide_mode ? wide::kThreads : kThreads, smem);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)smem;
  *units = wide_mode ? wide::kUnits : tile.U;
  return cudaSuccess;
}

// Launches the hand-off probe on `pair` (two zeroed 8-byte words).
ACX_EXPORT int lstm_handoff_probe(void* pair, int iters, void* stream) {
  const int smem = 120 * 1024;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_handoff_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  lstm_handoff_probe_kernel<<<2, 32, smem, (cudaStream_t)stream>>>(
      static_cast<u64*>(pair), iters);
  return cudaGetLastError();
}

ACX_EXPORT const char* lstm_recurrence_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
