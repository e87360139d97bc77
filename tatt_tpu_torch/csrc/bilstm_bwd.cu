// Backward recurrence of a bidirectional LSTM, both directions in one launch,
// then the recurrent-weight gradient.
//
// Replaces the TPU kernel tatt_tpu/kernels/pallas_lstm.py:_lstm_bwd_kernel
// (launched by _bwd_call, pallas_call at pallas_lstm.py:142).
//
// Computes, for direction d and every row r, walking d's processing order
// in reverse (direction 0: t = L-1 .. 0; direction 1: t = 0 .. L-1), with
// torch gate order i, f, g, o and h_prev / c_prev the forward's h and c of
// the step before t in d's order (zeros at d's first step):
//   a = x + W_hh[d] h_prev + b_hh[d]        (recomputed, as the JAX kernel does)
//   i, f, o = s(a_i), s(a_f), s(a_o);  g = tanh(a_g)
//   dh = dh_carry + dy;  do = dh tanh(c) o(1-o);  dc = dc_carry + dh o (1-tanh(c)^2)
//   di = dc g i(1-i);  dg = dc i (1-g^2);  df = dc c_prev f(1-f)
//   dgates = [di, df, dg, do];  dh_carry = W_hh[d]^T dgates;  dc_carry = dc f
// and afterwards dW_hh[d] = sum_{t,r} dgates h_prev^T, db_hh[d] = sum dgates.
//
// Layouts (contiguous), those of csrc/bilstm_fwd.cu:
//   gates, dgates [2, R, L, 4H]   (input projections / their gradient)
//   w_hh [2, 4H, H], b_hh [2, 4H]; dw_hh [2, 4H, H], db_hh [2, 4H] (float32)
//   out, cseq, dy [R, L, 2H]       (the forward's h and c, and dL/dout)
// gates, w_hh, b_hh, out, cseq, dy and dgates are float32, or bfloat16 in
// the bf16 instantiation (entry bilstm_bwd_bf16), the TPU kernel under
// --dtype bfloat16: every input widened to f32 as it is loaded (W_hh f32 in
// shared memory, so the plans are the f32 kernel's), the carries and every
// sum in f32.  Its activations and f32 d(gates) live in a float32 scratch
// dg32 [2, R, L, 4H] (where the f32 kernel uses dgates itself); the
// recurrence also stores d(gates) rounded to bf16 into dgates, and the
// weight gradient sums the f32 ones, as the TPU kernel's does.
//
// What bounds it on an H100: the dh carry is serial in t.  Its least time
// by operations (three [4H x H] matvec-sized products a row-step at the
// f32 peak) or by bytes does not count the latency each step of the chain
// pays: shared-memory loads, a block barrier, the exchange of partial sums
// between blocks and their barrier.  At H=256 W_hh is 1 MB per direction,
// too large for one block's 227 KB of shared memory, and R is only 64.
// The design before this one recomputed the gates on the chain (half of each step's
// FMAs, behind a global-to-shared copy of h_prev and a barrier), had three
// barriers a step, and launched 64 blocks of 4 warps: 29-30 us a step.
//
// Design.
//   Kernel 0 (bilstm_bwd_gates_kernel) recomputes the gate activations of
//   every (direction, row, t) at once, before the walk: none of them
//   depends on the carry, since h_prev is the forward's output.  It fills
//   the card, and writes them into the dgates buffer, which kernel 1
//   overwrites in place with d(gates).
//   Kernel 1 (bilstm_bwd_rec_kernel) walks the chain.  A cluster of cs
//   blocks serves one (direction, tile of RT rows); block `rank` keeps the
//   4U rows of W_hh of its hidden units [rank*U, rank*U+U) in shared memory
//   for the whole launch.  A step is the elementwise d(gates), one block
//   barrier, and W_hh^T d(gates), whose partial sums are reduce-scattered
//   through distributed shared memory to the rank that owns each unit.
//   - Off the chain: each step's inputs (activations, c_t, c_prev, dy) are
//     loaded during the previous step's product and turned into
//     coefficients after it, so a step's elementwise part is 6 FMAs.
//   - k groups split the 4U-long contraction, so a block has 12-16 warps;
//     each unit sums its cs * kg partials in a fixed order.
//   - cs is the smallest cluster that divides H and fits shared memory and
//     512 threads (8 at H=256, 1 at H=64); RT (4, 8, 12 or 16) is the
//     fewest rows with which every cluster is resident, by the occupancy
//     API (12 at H=256, R=64: the card holds fewer than 16 clusters of 8).
//     The plan is made once per (device, H, R).  The backward serves
//     exactly the H that csrc/bilstm_fwd.cu serves; any other H is refused
//     before a launch.
//   - The cluster barrier is split: the global d(gates) stores go between
//     its arrive and its wait.  Partials are double-buffered, so it is the
//     only barrier across blocks.
//   Kernel 2 (bilstm_bwd_dw_kernel) is the weight gradient, a
//   register-tiled f32 GEMM over the R * L (row, t) pairs, cp.async
//   double-buffered, with db_hh summed beside it by the blocks of the first
//   column tile.  TPU grid steps run in order and add into one dW block;
//   Hopper blocks do not, so each output is one block's, summed over all
//   pairs in a fixed order: no atomics, two launches are bitwise equal.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 6, L=26,
// R=64, H=256, 15 clusters of the plan resident): ~0.29 ms a launch, of
// which the pre-pass 0.073 ms, the recurrence 0.149 ms (5.4 us a step) and
// the weight gradient 0.064 ms; the design before took 1.16-1.20 ms in
// the same runs.
//
// No tensor cores and no reduced precision: every product is an f32 FMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;     // threads of a recurrence block
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kMaxKGroups = 16;

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// 4- and 16-byte asynchronous copies from global to shared memory, their
// groups, and the wait for all but the newest N groups of this thread
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the streamed element types: loads widen to f32, stores round to nearest
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, float>) return v;
  else return __float2bfloat16_rn(v);
}
// four consecutive elements as f32 (16 or 8 bytes, aligned to that)
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// GR elements (1 or 4) into shared memory as f32, or zeros where the source
// is cut off: asynchronous copies for f32, loads and conversions for bf16
template <int GR, typename T>
__device__ __forceinline__ void copy_or_zero(float* dst, const T* src, bool ok) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (GR == 4) {
      if (ok) cp_async16(dst, src);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      if (ok) cp_async4(dst, src);
      else *dst = 0.0f;
    }
  } else if constexpr (GR == 4) {
    *reinterpret_cast<float4*>(dst) = ok ? load4(src) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    *dst = ok ? to_f(*src) : 0.0f;
  }
}

// The gate pre-pass: for every (direction d, row, t) at once,
//   a = x + W_hh[d] h_prev + b_hh[d];  act = [s(a_i), s(a_f), tanh(a_g), s(a_o)]
// into `act` ([2, R, L, 4H], the dgates buffer).  Per direction a
// register-tiled f32 product [R*L x H] x [H x 4H]: a block of 4 warps forms
// a tile of kGM (row, t) pairs m by kGN gate rows n, a thread 4 x 4 of
// them (m = tm + 16 i, n = tn + 8 j, so a warp's lanes walk n: its W reads
// hit eight neighbouring rows, its h reads four, and its stores run along
// n), over k in chunks of kGK copied into shared memory with cp.async, two
// stages.  Small blocks, so that the last wave of the grid is short: at
// H=256, R=64 (1,664 tiles) 0.073 ms a pass against 0.079 for 64 x 64
// tiles on 8 warps (H100 80GB HBM3, 700 W).
// Row m = row * L + t of h_prev is row m -/+ 1 of `out` (direction 0 / 1),
// zero at the direction's first step.  VEC: 16-byte copies (H % 4 == 0).
constexpr int kGM = 64, kGN = 32, kGK = 32, kGKS = kGK + 4, kGThreads = 128;
template <bool VEC, typename T>
__global__ void __launch_bounds__(kGThreads)
bilstm_bwd_gates_kernel(const T* __restrict__ gates, const T* __restrict__ w_hh,
                        const T* __restrict__ b_hh, const T* __restrict__ out,
                        float* __restrict__ act, int L, int H, int R) {
  constexpr int GR = VEC ? 4 : 1;                    // floats a copy
  constexpr int PER_ROW = kGK / GR;                  // copies a row of a chunk
  constexpr int STRIDE = kGThreads / PER_ROW;        // rows between a thread's copies
  constexpr int HSLOTS = kGM * PER_ROW / kGThreads;  // copies a thread: h_prev tile
  constexpr int WSLOTS = kGN * PER_ROW / kGThreads;  // W_hh tile
  __shared__ __align__(16) float hs[2][kGM][kGKS];
  __shared__ __align__(16) float ws[2][kGN][kGKS];
  const int G = 4 * H, M = R * L, dir = blockIdx.z;
  const int n0 = blockIdx.x * kGN, m0 = blockIdx.y * kGM;
  const int tn = threadIdx.x % 8, tm = threadIdx.x / 8;
  const size_t H2 = 2 * (size_t)H;
  // this thread's copy slots: rows crow + STRIDE j of each tile, column ccol
  const int crow = threadIdx.x / PER_ROW, ccol = (threadIdx.x % PER_ROW) * GR;
  const T* hsrc[HSLOTS];
  const T* wsrc[WSLOTS];
  bool hok[HSLOTS], wok[WSLOTS];
#pragma unroll
  for (int j = 0; j < HSLOTS; ++j) {
    const int m = m0 + crow + STRIDE * j;
    const int t = m % L, tp = dir == 0 ? t - 1 : t + 1;
    hok[j] = m < M && tp >= 0 && tp < L;
    hsrc[j] = out + (hok[j] ? (size_t)(m + tp - t) * H2 + (size_t)dir * H : 0);
  }
#pragma unroll
  for (int j = 0; j < WSLOTS; ++j) {
    const int n = n0 + crow + STRIDE * j;
    wok[j] = n < G;
    wsrc[j] = w_hh + (wok[j] ? ((size_t)dir * G + n) * H : 0);
  }
  const auto issue = [&](int k0, int st) {
    const int k = k0 + ccol;
#pragma unroll
    for (int j = 0; j < HSLOTS; ++j)
      copy_or_zero<GR>(&hs[st][crow + STRIDE * j][ccol], hsrc[j] + k, hok[j] && k < H);
#pragma unroll
    for (int j = 0; j < WSLOTS; ++j)
      copy_or_zero<GR>(&ws[st][crow + STRIDE * j][ccol], wsrc[j] + k, wok[j] && k < H);
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  const int nch = (H + kGK - 1) / kGK;
  issue(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int st = c & 1;
    if (c + 1 < nch) issue((c + 1) * kGK, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c landed; c + 1 may be in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 4) {
      float4 hv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = *reinterpret_cast<const float4*>(&hs[st][tm + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = *reinterpret_cast<const float4*>(&ws[st][tn + 8 * j][kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(hv[i].x, wv[j].x, acc[i][j]);
          acc[i][j] = fmaf(hv[i].y, wv[j].y, acc[i][j]);
          acc[i][j] = fmaf(hv[i].z, wv[j].z, acc[i][j]);
          acc[i][j] = fmaf(hv[i].w, wv[j].w, acc[i][j]);
        }
    }
    __syncthreads();  // stage st is free for chunk c + 2
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tn + 8 * j;
    if (n >= G) continue;
    const bool cell = n / H == 2;  // the g gate: tanh
    const float bias = to_f(b_hh[dir * G + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tm + 16 * i;
      if (m >= M) continue;
      const size_t o = ((size_t)dir * M + m) * G + n;
      const float a = acc[i][j] + to_f(gates[o]) + bias;
      act[o] = cell ? tanhf(a) : sigm(a);
    }
  }
}

// The two halves of a cluster barrier (cg's cluster.sync() is both back to
// back): arrive releases this thread's earlier stores, distributed shared
// memory included; wait returns once every thread of the cluster arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The recurrence: RT rows per cluster (4, 8, 12 or 16); kCluster: cs > 1
// blocks exchange partials through distributed shared memory.  kg k groups
// split the 4U-long contraction of W_hh^T d(gates).
//
// Two kinds of thread (a thread may be both):
//   - product thread (k, kgi), tid < H * kg: the partial of dh_carry[k]
//     over its group's gate rows gu of this block, for all RT rows, stored
//     into the shared memory of the rank that owns unit k;
//   - unit thread (u, r), tid < U * RT: the elementwise step of unit
//     rank*U + u of row r: carries, d(gates), the loads a step ahead.
// A step: unit threads form d(gates) from the carries and the step's
// coefficients (computed the step before) into dg_s; one __syncthreads;
// unit threads issue the next step's loads; product threads form and
// store the partials; unit threads turn the next step's loads into
// coefficients; the cluster barrier, split around the global d(gates)
// stores; unit threads sum their cs * kg partials in a fixed order.
//
// dgates: the f32 activations, overwritten in place with the f32 d(gates);
// dg_out: the d(gates) rounded to bf16 (bf16 only; null for f32).
template <typename T, int RT, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_bwd_rec_kernel(const T* __restrict__ w_hh, const T* __restrict__ cseq,
                      const T* __restrict__ dy, float* __restrict__ dgates,
                      T* __restrict__ dg_out, int L, int H, int R, int kg) {
  const int cs = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int U = H / cs;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                        // [4U][H]: row g*U+u is W_hh[dir] row g*H+rank*U+u
  float* dg_s = w_s + (size_t)4 * U * H;    // [4U][RT]: the block's d(gates)
  float* red = dg_s + 4 * U * RT;           // [2][cs][kg][RT][U]: partials from each rank
  const int red_buf = cs * kg * RT * U;

  const int dir = blockIdx.y;
  const int tile = blockIdx.x / cs;
  const size_t H2 = 2 * (size_t)H;

  const T* w_d = w_hh + (size_t)dir * G * H;
  if ((H & 3) == 0) {
    const int h4 = H / 4;
    for (int i = tid; i < 4 * U * h4; i += blockDim.x) {
      const int gu = i / h4, k = (i % h4) * 4;
      const int src = (gu / U) * H + rank * U + gu % U;
      *reinterpret_cast<float4*>(w_s + (size_t)gu * H + k) = load4(w_d + (size_t)src * H + k);
    }
  } else {
    for (int i = tid; i < 4 * U * H; i += blockDim.x) {
      const int gu = i / H, k = i % H;
      w_s[i] = to_f(w_d[(size_t)((gu / U) * H + rank * U + gu % U) * H + k]);
    }
  }

  // product thread: output k, gate rows [g0, g1) of the block
  const bool prod = tid < H * kg;
  const int k = tid % H, kgi = tid / H;
  const int kr = (4 * U + kg - 1) / kg;
  const int g0 = min(4 * U, kgi * kr), g1 = min(4 * U, g0 + kr);
  const int owner = k / U;
  const int pbase = ((rank * kg + kgi) * RT) * U + k % U;
  // unit thread: unit eu of row er
  const bool unit_t = tid < U * RT;
  const int eu = tid % U, er = tid / U;
  const int unit = rank * U + eu;
  const int row = tile * RT + er;
  const bool live = unit_t && row < R;
  const auto t_of = [&](int s) { return dir == 0 ? L - 1 - s : s; };
  // a step's inputs: the gate activations, c_t, c_prev (0 at the
  // direction's first step) and dy
  float xa[4] = {0.0f, 0.0f, 0.0f, 0.0f}, xc = 0.0f, xcp = 0.0f, xdy = 0.0f;
  const auto load = [&](int s) {
    if (!live) return;
    const int t = t_of(s), tp = dir == 0 ? t - 1 : t + 1;
    const float* ax = dgates + (((size_t)dir * R + row) * L + t) * G + unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) xa[g] = ax[g * H];
    const size_t o = ((size_t)row * L + t) * H2 + (size_t)dir * H + unit;
    xc = to_f(cseq[o]);
    xdy = to_f(dy[o]);
    xcp = tp >= 0 && tp < L ? to_f(cseq[((size_t)row * L + tp) * H2 + (size_t)dir * H + unit])
                            : 0.0f;
  };
  // a step's coefficients, so that with dh = dh_carry + dy:
  //   dc = dc_carry + dh kc;  d(gates) = [dc ci, dc cf, dc cg, dh ko];  dc_carry = dc f
  float kc = 0.0f, ko = 0.0f, ci = 0.0f, cf = 0.0f, cgg = 0.0f, fg = 0.0f, dyc = 0.0f;
  const auto coefficients = [&]() {
    const float ig = xa[0], f = xa[1], gg = xa[2], og = xa[3];
    const float tc = tanhf(xc);
    kc = og * (1.0f - tc * tc);
    ko = tc * og * (1.0f - og);
    ci = gg * ig * (1.0f - ig);
    cf = xcp * f * (1.0f - f);
    cgg = ig * (1.0f - gg * gg);
    fg = f;
    dyc = xdy;
  };
  load(0);
  coefficients();
  float dhc = 0.0f, dcc = 0.0f;
  if constexpr (kCluster) cg::this_cluster().sync();  // every block runs and holds its W_hh
  else __syncthreads();

  for (int s = 0; s < L; ++s) {
    float* redb = red + (s & 1) * red_buf;
    float d[4];
    if (unit_t) {
      const float dh = dhc + dyc;
      const float dc = dcc + dh * kc;
      d[0] = dc * ci;
      d[1] = dc * cf;
      d[2] = dc * cgg;
      d[3] = dh * ko;
      dcc = dc * fg;
#pragma unroll
      for (int g = 0; g < 4; ++g) dg_s[(g * U + eu) * RT + er] = d[g];
    }
    __syncthreads();  // the block's d(gates) are in dg_s
    if (s + 1 < L) load(s + 1);  // lands during the products
    if (prod) {
      float p[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) p[r] = 0.0f;
#pragma unroll 4
      for (int gu = g0; gu < g1; ++gu) {
        const float w = w_s[(size_t)gu * H + k];
#pragma unroll
        for (int q = 0; q < RT / 4; ++q) {
          const float4 dv = *reinterpret_cast<const float4*>(dg_s + gu * RT + 4 * q);
          p[4 * q] = fmaf(w, dv.x, p[4 * q]);
          p[4 * q + 1] = fmaf(w, dv.y, p[4 * q + 1]);
          p[4 * q + 2] = fmaf(w, dv.z, p[4 * q + 2]);
          p[4 * q + 3] = fmaf(w, dv.w, p[4 * q + 3]);
        }
      }
      float* dst = redb;
      if constexpr (kCluster) dst = cg::this_cluster().map_shared_rank(redb, owner);
#pragma unroll
      for (int r = 0; r < RT; ++r) dst[pbase + r * U] = p[r];
    }
    if (s + 1 < L) coefficients();
    // the barrier that publishes every rank's partials; also, no block
    // moves on to overwrite dg_s, or to store into a partial buffer another
    // block still reads (step s+1 writes the other buffer, step s+2 this
    // one), before all have passed it.  In a cluster it is split: the
    // d(gates) stores, which no block waits on, go between arrive and wait.
    if constexpr (kCluster) cluster_arrive();
    if (live) {
      const size_t o = (((size_t)dir * R + row) * L + t_of(s)) * G + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) dgates[o + g * H] = d[g];
      if constexpr (!std::is_same_v<T, float>) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dg_out[o + g * H] = from_f<T>(d[g]);
      }
    }
    if constexpr (kCluster) cluster_wait();
    else __syncthreads();
    if (unit_t) {  // dh_carry: the partials of every rank and k group, in order
      float v = 0.0f;
      for (int j = 0; j < cs * kg; ++j) v += redb[(j * RT + er) * U + eu];
      dhc = v;
    }
  }
}

// The weight gradient: dW_hh[d] = sum_m dgates[d, m] h_prev[m]^T and
// db_hh[d] = sum_m dgates[d, m] over the R * L pairs m = row * L + t, a
// register-tiled f32 GEMM.  A block forms a kWM x kWN tile of dW_hh[d]
// (gate rows n0.., hidden columns k0..) over the whole of m, a thread 4 x
// 4 of it (rows n0 + 4 ty + i, columns k0 + 4 tx + j), in chunks of kWK
// pairs copied into shared memory with cp.async, two stages, so the next
// chunk's copies fly during this chunk's products.  Each copy slot walks
// its pair's (m, t) by additions (no divide in the loop).  The blocks of
// column tile 0 also sum their gate rows over m (db_hh): thread tid sums
// column tid % kWM of rows tid / kWM + 4 q of every chunk, and the four
// runs are added in order at the end.  No atomics: each output is one
// block's, summed in a fixed order.  VEC: 16-byte copies (H % 4 == 0).
constexpr int kWM = 64, kWN = 64, kWK = 32, kWThreads = 256;
// dgates: the f32 d(gates); out: h in T.
template <bool VEC, typename T>
__global__ void __launch_bounds__(kWThreads)
bilstm_bwd_dw_kernel(const float* __restrict__ dgates, const T* __restrict__ out,
                     float* __restrict__ dw_hh, float* __restrict__ db_hh, int L, int H, int R) {
  constexpr int GR = VEC ? 4 : 1;                  // floats a copy
  constexpr int PER_ROW = kWM / GR;                // copies a row of a chunk
  constexpr int STRIDE = kWThreads / PER_ROW;      // rows between a thread's copies
  constexpr int SLOTS = kWK * PER_ROW / kWThreads; // copies a thread, each operand
  constexpr int BROWS = kWThreads / kWM;           // bias runs
  __shared__ __align__(16) float as[2][kWK][kWM];  // d(gates): pairs x gate rows
  __shared__ __align__(16) float bs[2][kWK][kWN];  // h_prev: pairs x hidden columns
  __shared__ float bsum_s[BROWS][kWM];
  const int G = 4 * H, M = R * L, dir = blockIdx.z;
  const int n0 = blockIdx.x * kWM, k0 = blockIdx.y * kWN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t H2 = 2 * (size_t)H;
  const bool sums = blockIdx.y == 0;
  const int crow = threadIdx.x / PER_ROW, ccol = (threadIdx.x % PER_ROW) * GR;
  const bool a_in = n0 + ccol < G, b_in = k0 + ccol < H;
  const float* abase = dgates + (size_t)dir * M * G + n0 + ccol;
  const T* bbase = out + (size_t)dir * H + k0 + ccol;
  // the pair of each copy slot, and its t; a chunk moves both on by kWK
  int pm[SLOTS], pt[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    pm[j] = crow + STRIDE * j;
    pt[j] = pm[j] % L;
  }
  const int step_t = kWK % L;
  const auto issue = [&](int st) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int m = pm[j], t = pt[j];
      const int tp = dir == 0 ? t - 1 : t + 1;
      const bool live = m < M;
      copy_or_zero<GR>(&as[st][crow + STRIDE * j][ccol], abase + (size_t)(live ? m : 0) * G,
                       live && a_in);
      const bool prev = live && b_in && tp >= 0 && tp < L;
      copy_or_zero<GR>(&bs[st][crow + STRIDE * j][ccol],
                       bbase + (prev ? (size_t)(m + tp - t) * H2 : 0), prev);
      pm[j] = m + kWK;
      pt[j] = t + step_t >= L ? t + step_t - L : t + step_t;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float bsum = 0.0f;
  const int nch = (M + kWK - 1) / kWK;
  issue(0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int st = c & 1;
    if (c + 1 < nch) issue(st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c landed; c + 1 may be in flight
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kWK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[st][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[st][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (sums) {
#pragma unroll
      for (int q = 0; q < kWK / BROWS; ++q)
        bsum += as[st][threadIdx.x / kWM + BROWS * q][threadIdx.x % kWM];
    }
    __syncthreads();  // stage st is free for chunk c + 2
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= G) continue;
    float* dst = dw_hh + ((size_t)dir * G + n) * H + k0 + tx * 4;
    if (VEC && k0 + tx * 4 < H) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx * 4 + j < H) dst[j] = acc[i][j];
    }
  }
  if (sums) {
    bsum_s[threadIdx.x / kWM][threadIdx.x % kWM] = bsum;
    __syncthreads();
    if ((int)threadIdx.x < kWM && n0 + (int)threadIdx.x < G) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < BROWS; ++q) v += bsum_s[q][threadIdx.x];
      db_hh[(size_t)dir * G + n0 + threadIdx.x] = v;
    }
  }
}

bool aligned(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// Returned, before any launch, for an H that no plan serves: the value and
// the rule of csrc/bilstm_fwd.cu, so that the backward serves exactly the H
// the forward serves.
constexpr int kNoFit = -1;

// Whether csrc/bilstm_fwd.cu serves H: some cluster size cs in 1, 2, 4, 8
// divides H with U = H / cs <= 128 units a block (512 threads, 4 k groups)
// and a block of 4 rows and 4 k groups fits shared memory (its make_plan).
bool forward_serves(int H) {
  for (int cs = 1; cs <= 8; cs *= 2) {
    const size_t U = (size_t)H / cs;
    if (H % cs == 0 && U <= 128 &&
        sizeof(float) * (4 * U * H + 2 * (size_t)H * 4 + 4 * 4 * U * 4) <= kMaxSmem)
      return true;
  }
  return false;
}

// The recurrence's launch: cluster size, rows per cluster, k groups,
// threads and shared memory of a block.
struct Plan {
  int cs, rt, kg, threads;
  size_t smem;
};

template <typename T>
using RecKernel = void (*)(const T*, const T*, const T*, float*, T*, int, int, int, int);

template <typename T>
RecKernel<T> kernel_of(const Plan& p) {
  const bool c = p.cs > 1;
  switch (p.rt) {
    case 4: return c ? bilstm_bwd_rec_kernel<T, 4, true> : bilstm_bwd_rec_kernel<T, 4, false>;
    case 8: return c ? bilstm_bwd_rec_kernel<T, 8, true> : bilstm_bwd_rec_kernel<T, 8, false>;
    case 12: return c ? bilstm_bwd_rec_kernel<T, 12, true> : bilstm_bwd_rec_kernel<T, 12, false>;
    default: return c ? bilstm_bwd_rec_kernel<T, 16, true> : bilstm_bwd_rec_kernel<T, 16, false>;
  }
}

// Shared-memory bytes of one recurrence block: the W_hh slice, the tile's
// d(gates), two buffers of partials from every (rank, k group).
size_t rec_smem_bytes(int H, int cs, int rt, int kg) {
  const size_t U = (size_t)H / cs;
  return sizeof(float) * (4 * U * H + 4 * U * rt + (size_t)2 * kg * rt * H);
}

// The block for cluster size cs and rt rows: the most k groups (up to 16,
// at most one a gate row) whose product threads fit the thread limit and
// whose partials fit shared memory, and a unit thread for every (unit,
// row).  False when none fits.
bool block_plan(int H, int cs, int rt, Plan* p) {
  const int U = H / cs;
  int kg = std::min(std::min(kMaxKGroups, kMaxThreads / H), 4 * U);
  while (kg > 1 && rec_smem_bytes(H, cs, rt, kg) > kMaxSmem) kg /= 2;
  const int threads = std::max(H * kg, U * rt);
  const size_t smem = rec_smem_bytes(H, cs, rt, kg);
  if (kg < 1 || threads > kMaxThreads || smem > kMaxSmem) return false;
  *p = Plan{cs, rt, kg, threads, smem};
  return true;
}

cudaLaunchConfig_t launch_config(const Plan& p, dim3 grid, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1 ? 1 : 0;
  return cfg;
}

// Clusters (single blocks at cs = 1) of plan p that the card runs at once.
template <typename T>
int resident_clusters(const Plan& p, int device, cudaError_t* e) {
  const RecKernel<T> kernel = kernel_of<T>(p);
  *e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (*e != cudaSuccess) return 0;
  int n = 0;
  if (p.cs == 1) {
    int sms = 0;
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (*e == cudaSuccess)
      *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p.threads, p.smem);
    return n * sms;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, dim3(p.cs), &attr);
  *e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return n;
}

// The launch for hidden size H and R rows.  cs: the smallest cluster size
// that divides H and whose block fits the threads the kernel is compiled
// for and shared memory.  rt: the fewest rows per cluster (4, 8, 12 or 16)
// with which all 2 * ceil(R / rt) clusters run at once, or else the most
// that fit.  False (and *e unset) for an H the forward does not serve.
template <typename T>
bool make_plan(int H, int R, int device, Plan* out, cudaError_t* e) {
  *e = cudaSuccess;
  if (!forward_serves(H)) return false;
  for (int cs = 1; cs <= 8; cs *= 2) {
    if (H % cs != 0) continue;
    bool found = false;
    for (int rt = 4; rt <= 16; rt += 4) {
      Plan p;
      if (!block_plan(H, cs, rt, &p)) break;  // more rows need more threads and memory
      *out = p;
      found = true;
      const int resident = resident_clusters<T>(p, device, e);
      if (*e != cudaSuccess) return false;
      if (2 * ((R + rt - 1) / rt) <= resident) break;
    }
    if (found) return true;
  }
  return false;
}

// Plans already made, by (device, H, R, element size): the occupancy
// queries stay off every launch but the first of a shape.
std::mutex plans_mu;
std::map<std::tuple<int, int, int, int>, Plan> plans;

// The plan for hidden size H and R rows on the current device, made once.
template <typename T>
int plan_of(int H, int R, Plan* p, int* device) {
  cudaError_t e = cudaGetDevice(device);
  if (e != cudaSuccess) return clear_and_return(e);
  std::lock_guard<std::mutex> lock(plans_mu);
  const auto key = std::make_tuple(*device, H, R, (int)sizeof(T));
  const auto it = plans.find(key);
  if (it != plans.end()) {
    *p = it->second;
    return 0;
  }
  if (!make_plan<T>(H, R, *device, p, &e)) return e != cudaSuccess ? clear_and_return(e) : kNoFit;
  plans[key] = *p;
  return 0;
}

// The gate activations into the f32 work buffer (dgates itself for f32,
// dg32 for bf16), then the recurrence over them, then the weight gradient.
template <typename T>
int launch(const T* gates, const T* w_hh, const T* b_hh, const T* out, const T* cseq,
           const T* dy, T* dgates, float* dg32, float* dw_hh, float* db_hh, int L, int H, int R,
           cudaStream_t stream) {
  Plan p;
  int device = 0;
  const int err = plan_of<T>(H, R, &p, &device);
  if (err != 0) return err;  // before any launch
  float* work;
  T* dg_out = nullptr;
  if constexpr (std::is_same_v<T, float>) {
    work = dgates;
  } else {
    work = dg32;
    dg_out = dgates;
  }
  const bool vec = H % 4 == 0 && aligned(gates) && aligned(w_hh) && aligned(out) &&
                   aligned(work) && aligned(dw_hh);
  const dim3 ggrid((4 * H + kGN - 1) / kGN, (R * L + kGM - 1) / kGM, 2);
  if (vec) bilstm_bwd_gates_kernel<true, T><<<ggrid, kGThreads, 0, stream>>>(gates, w_hh, b_hh, out, work, L, H, R);
  else bilstm_bwd_gates_kernel<false, T><<<ggrid, kGThreads, 0, stream>>>(gates, w_hh, b_hh, out, work, L, H, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return clear_and_return(e);
  const RecKernel<T> kernel = kernel_of<T>(p);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return clear_and_return(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(p, dim3(p.cs * ((R + p.rt - 1) / p.rt), 2), &attr);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, kernel, w_hh, cseq, dy, work, dg_out, L, H, R, p.kg);
  if (e != cudaSuccess) return clear_and_return(e);
  const dim3 wgrid((4 * H + kWM - 1) / kWM, (H + kWN - 1) / kWN, 2);
  if (vec) bilstm_bwd_dw_kernel<true, T><<<wgrid, kWThreads, 0, stream>>>(work, out, dw_hh, db_hh, L, H, R);
  else bilstm_bwd_dw_kernel<false, T><<<wgrid, kWThreads, 0, stream>>>(work, out, dw_hh, db_hh, L, H, R);
  return (int)cudaGetLastError();
}

template <typename T>
int plan_query(int H, int R, int* plan) {
  Plan p;
  int device = 0;
  const int err = plan_of<T>(H, R, &p, &device);
  if (err != 0) return err;
  cudaError_t e;
  const int resident = resident_clusters<T>(p, device, &e);
  if (e != cudaSuccess) return clear_and_return(e);
  const int values[7] = {p.cs, p.rt, p.kg, p.threads, (int)p.smem, 2 * ((R + p.rt - 1) / p.rt),
                         resident};
  for (int i = 0; i < 7; ++i) plan[i] = values[i];
  return 0;
}

}  // namespace

extern "C" int bilstm_bwd(const float* gates, const float* w_hh, const float* b_hh,
                          const float* out, const float* cseq, const float* dy,
                          float* dgates, float* dw_hh, float* db_hh,
                          int L, int H, int R, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, cseq, dy, dgates, nullptr, dw_hh, db_hh, L, H, R, stream);
}

// dg32 [2, R, L, 4H] float32: the activations and the unrounded d(gates)
extern "C" int bilstm_bwd_bf16(const __nv_bfloat16* gates, const __nv_bfloat16* w_hh,
                               const __nv_bfloat16* b_hh, const __nv_bfloat16* out,
                               const __nv_bfloat16* cseq, const __nv_bfloat16* dy,
                               __nv_bfloat16* dgates, float* dg32, float* dw_hh, float* db_hh,
                               int L, int H, int R, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, cseq, dy, dgates, dg32, dw_hh, db_hh, L, H, R, stream);
}

// The recurrence's launch for hidden size H and R rows, for logs: plan[0..6]
// = cluster size, rows per cluster, k groups, threads and shared-memory
// bytes of a block, clusters of the grid, clusters the card runs at once.
// Launches nothing.
extern "C" int bilstm_bwd_plan(int H, int R, int* plan) { return plan_query<float>(H, R, plan); }

extern "C" int bilstm_bwd_bf16_plan(int H, int R, int* plan) {
  return plan_query<__nv_bfloat16>(H, R, plan);
}
