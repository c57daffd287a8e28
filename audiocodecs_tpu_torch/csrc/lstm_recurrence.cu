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
  if (pick(H, &tile, &kernel) != cudaSuccess) return 0;
  return 2L * sizeof(u64) * layout(tile, 1).Hp;
}

// The most batch rows one launch takes at H: the largest B whose gate
// inputs fit the threads' registers (B * 4U <= kGateIters * kThreads) and
// whose shared memory fits the card's limit.
ACX_EXPORT int lstm_recurrence_max_batch(int H) {
  Tile tile;
  Kernel kernel;
  int dev = 0, optin = 0;
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
  cudaError_t err = prepare(H, B, &tile, &kernel, &smem);
  if (err != cudaSuccess) return err;
  u64* pairs = static_cast<u64*>(exchange);
  void* args[] = {(void*)&gx,  (void*)&w_hh,  (void*)&h0,    (void*)&c0,
                  (void*)&ys,  (void*)&h_out, (void*)&c_out, (void*)&pairs,
                  (void*)&T,   (void*)&B,     (void*)&ldb,   (void*)&H};
  const dim3 grid(H / tile.U), block(kThreads);
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
  cudaError_t err = prepare(H, B, &tile, &kernel, &smem);
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
  *units = tile.U;
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
