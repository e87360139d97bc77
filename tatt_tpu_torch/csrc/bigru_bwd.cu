// Backward recurrence of a bidirectional GRU, both directions in one launch,
// then the recurrent-weight and bias gradients.
//
// Replaces the TPU kernel tatt_tpu/kernels/pallas_gru.py:_gru_bwd_kernel
// (with _gru_bwd_step; launched by _bwd_call, pallas_call at pallas_gru.py:282).
//
// Computes, for direction d and every row independently, walking d's
// processing order in reverse (direction 0: t = L-1 .. 0; direction 1:
// t = 0 .. L-1), with h_prev the forward's h of the step before t in d's
// order (zeros at d's first step) and x = gates[d, t] the input projection:
//   gh = W_hh[d] h_prev + b_hh[d]   (recomputed);  r, z, n as the forward
//   dh = dh_carry + dy;  dz = dh (h_prev - n) z(1-z);  dn = dh (1-z)(1-n^2)
//   dr = dn gh_n r(1-r)
//   d(gates_x) = [dr, dz, dn]        (xn enters tanh directly)
//   d(gh)      = [dr, dz, dn r]      (gh_n is scaled by r)
//   dh_carry = dh z + W_hh[d]^T d(gh)
// and over all (t, row): dW_hh = sum d(gh) h_prev^T, db_hh = sum d(gh), and
// the input-bias gradient dbx = sum d(gates_x).
//
// Layouts (contiguous), those of csrc/bigru_fwd.cu:
//   gates, dgates [2, L, 3H, R]   (rows minor, gate order r, z, n)
//   w_hh [2, 3H, H], b_hh [2, 3H]; out, dy [L, 2H, R]
//   scratch (float32): dghn [2, L, H, R] (dn r), bias_part [2, S, 4H],
//            dw_part [2, S, 3H, H]
//   dw_hh [2, 3H, H]; bias4 [2, 4H] = sums of [dr, dz, dn r, dn] (float32)
//     (db_hh = bias4[:, :3H]; dbx = bias4[:, :2H] ++ bias4[:, 3H:])
// gates, w_hh, b_hh, out, dy and dgates are float32, or bfloat16 in the
// bf16 instantiation (entry bigru_bwd_bf16), the TPU kernel under --dtype
// bfloat16: every input widened to f32 as it is loaded (W_hh f32 in shared
// memory, so the plans are the f32 kernel's), the dh carry and every sum in
// f32, d(gates) stored rounded to bf16 and, unrounded, into a float32
// scratch dg32 [2, L, 3H, R] that the weight-gradient pass reads in the
// place of dgates: dW_hh, db_hh and dbx are sums of the f32 d(gates), as the
// TPU kernel's are.
//
// What bounds it on an H100.  Not the bytes it must move (gates, h and dy
// in, dgates out: 0.080 ms at HBM rate at gru1 and gru2 of the fused 2B=128
// batch, H=32) nor the f32 products (three 3H x H matvec-sized products a
// row-step): the serial chain of L steps, each of which finishes its
// products for every row of a block before the next step starts, paying
// shared-memory, barrier and global latency; and, where rows are few
// (gru2: 4,096 rows over 132 SMs), too few warps to hide it.  The design
// before this one took 22 us a step at gru1 and 14 at gru2: global loads
// and the gh recompute on the chain, two barriers a step, 336 bytes of
// spills at a 512-thread launch bound, and a weight-gradient pass of
// 0.245 ms a launch (32x32x32 tiles, h_prev read three times).
//
// Design.
//   Recurrence (bigru_bwd_rec_kernel): one block per (tile of rows,
//   direction) walks all L steps with W_hh[d] in shared memory.
//   - Off the chain: after step s's barrier the thread loads step s+1's gx
//     and dy into registers and copies h_prev of step s+2 into a double
//     buffer (cp.async), then forms gh(s+1) = W_hh h_prev + b_hh and the
//     gate coefficients of step s+1 after its W^T product.  The chain of a
//     step is dh -> d(gh) into shared memory (double-buffered), one
//     barrier, dh_carry = dh z + W_hh^T d(gh).
//   - A thread owns JT units (4 or 8) of RT rows (1 or 2): each W_hh word
//     read from shared memory feeds RT rows, and W_hh^T d(gh) reads W_hh's
//     row g 16 bytes at a time along the thread's units, so the one
//     [3H][kp] copy serves both products (no room for W^T too at H=128).
//   - The plan (units and rows a thread, rows a block) comes from the
//     occupancy API, per (device, H, R), cached: the fewest waves, then the
//     most resident warps.  At H=32 it takes 4 units x 1 row in 32-row
//     tiles at gru2 (8 warps on 128 SMs, one wave) and 4 units x 2 rows in
//     64-row tiles at gru1 (two waves of 132 blocks of 256 threads: the
//     register file holds one such block an SM).
//   Weight gradient (bigru_bwd_dw_kernel): a register-tiled f32 GEMM over K
//   = (t, row), one block per K slice (two an SM) forming all 3H x 32
//   outputs of a column tile; chunks of rows double-buffered with
//   cp.async; the bias sums are row sums of its A operand.  The TPU kernel
//   adds dW_hh into one output block from every grid step in order; Hopper
//   blocks run in no order, so each slice writes a partial and
//   sum_partials_kernel adds them in a fixed order: no atomics, and two
//   launches give bitwise-equal results.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 6, L=16,
// R=8192 / L=64, R=2048): 0.368 / 0.400 ms a launch, of which the
// recurrence 0.254 / 0.285 ms (15.1 / 4.4 us a step), the weight-gradient
// pass 0.090 ms and the sums 0.006 ms; the design before took 0.647 /
// 1.163 ms in the same run.
//
// No tensor cores and no reduced precision: every product is an f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

namespace {

constexpr int kMaxThreads = 256;  // threads of a recurrence block

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// 4- and 16-byte asynchronous copies from global to shared memory, their
// groups, and the waits for this thread's copies to land
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
// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the streamed element types: loads widen to f32, stores round to nearest
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, float>) return v;
  else return __float2bfloat16_rn(v);
}
// 1 or 4 elements into shared memory as f32: asynchronous copies for f32,
// a load (8 bytes for 4) and a conversion for bf16
__device__ __forceinline__ void stage1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void stage1(float* dst, const __nv_bfloat16* src) { *dst = to_f(*src); }
__device__ __forceinline__ void stage4(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  *reinterpret_cast<float4*>(dst) = make_float4(lo.x, lo.y, hi.x, hi.y);
}

// N consecutive floats of shared memory (N = 1 or 2; 4N-byte aligned)
template <int N>
__device__ __forceinline__ void load_n(const float* src, float (&v)[N]) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = src[0];
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* dst, const float (&v)[N]) {
  if constexpr (N == 2) *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else dst[0] = v[0];
}

// One block per (tile of RB rows, direction).  A thread owns JT hidden
// units (JT = 4 or 8) of RT neighbouring rows (RT = 1 or 2): Q =
// ceil(H / JT) unit groups times P row groups, RB = P * RT, thread (q, p)
// = threadIdx.x / P, % P, so a warp's lanes walk the rows.  kp: the row
// stride of W_hh in shared memory (a multiple of 4, at least Q * JT).
//
// Step s's loads are issued a step ahead: after step s-1's barrier its
// gx and dy go into registers and the h_prev of step s+1 into shared
// memory (cp.async), and gh(s) = W_hh h_prev with r, z, n is formed after
// step s-1's products.  Step s itself is then the chain alone: dh ->
// d(gates) into shared memory, one barrier, dh_carry = dh z + W^T d(gh).
// h_prev and d(gh) are double-buffered, so that barrier is the only one.
// dg32: the f32 copy of d(gates) (bf16 only; null for f32).
template <typename T, int JT, int RT>
__global__ void __launch_bounds__(kMaxThreads)
bigru_bwd_rec_kernel(const T* __restrict__ gates, const T* __restrict__ w_hh,
                     const T* __restrict__ b_hh, const T* __restrict__ out,
                     const T* __restrict__ dy, T* __restrict__ dgates,
                     float* __restrict__ dg32, float* __restrict__ dghn, int L, int H, int R,
                     int kp) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = (H + 3) & ~3;  // hidden axis padded to a float4 multiple
  const int G = 3 * H;
  const int Q = (H + JT - 1) / JT;
  const int P = blockDim.x / Q;
  const int RB = P * RT;
  float* w_s = smem;                 // [3H][kp]: W_hh[d] rows, zero-padded along k
  float* hp_s = w_s + G * kp;        // [2][H4/4][RT][P][4]: h_prev[k][row] packed by 4 k's
  float* dg_s = hp_s + 2 * H4 * RB;  // [2][3H][RB]: d(gh) of the tile
  float* b_s = dg_s + 2 * G * RB;    // [3H]

  const int dir = blockIdx.y;
  const int q = threadIdx.x / P, p = threadIdx.x % P;
  const int row0 = blockIdx.x * RB + p * RT;  // this thread's rows: row0 .. row0 + RT - 1
  const size_t RS = (size_t)R;

  const T* w_d = w_hh + (size_t)dir * G * H;
  for (int i = threadIdx.x; i < G * kp; i += blockDim.x) {
    const int g = i / kp, k = i % kp;
    w_s[i] = k < H ? to_f(w_d[(size_t)g * H + k]) : 0.0f;
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) b_s[i] = to_f(b_hh[dir * G + i]);
  for (int i = threadIdx.x; i < 2 * H4 * RB; i += blockDim.x) hp_s[i] = 0.0f;
  __syncthreads();  // the zeros land before any copy into hp_s

  // this thread's units and rows; out-of-range units clamp to H-1 for their
  // (unused) reads so every address stays valid
  int jc[JT];
  bool jv[JT], rv[RT];
#pragma unroll
  for (int u = 0; u < JT; ++u) {
    const int j = q * JT + u;
    jv[u] = j < H;
    jc[u] = jv[u] ? j : H - 1;
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) rv[i] = row0 + i < R;
  // h_prev[k] of the thread's row i in a buffer of hp_s
  const auto hp_at = [&](const float* hb, int k, int i) -> const float* {
    return hb + ((k >> 2) * RT + i) * P * 4 + p * 4 + (k & 3);
  };
  const auto t_of = [&](int s) { return dir == 0 ? L - 1 - s : s; };
  // h_prev of step s (the step before t in d's order; zeros at d's first
  // step) into hp_s[buf]
  const auto copy_hp = [&](int s, int buf) {
    const int t = t_of(s), tp = dir == 0 ? t - 1 : t + 1;
    const bool copy = tp >= 0 && tp < L;
    const T* src = out + ((size_t)(copy ? tp : 0) * 2 * H + (size_t)dir * H) * RS + row0;
    float* hb = hp_s + buf * H4 * RB;
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      if (!jv[u]) continue;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float* d = const_cast<float*>(hp_at(hb, jc[u], i));
        if (copy && rv[i]) stage1(d, src + (size_t)jc[u] * RS + i);
        else *d = 0.0f;
      }
    }
  };
  float xr[JT][RT], xz[JT][RT], xn[JT][RT], dyn[JT][RT];  // step s+1's inputs
  const auto load_x = [&](int s) {
    const int t = t_of(s);
    const T* gx = gates + (size_t)(dir * L + t) * G * RS + row0;
    const T* dyg = dy + ((size_t)t * 2 * H + (size_t)dir * H) * RS + row0;
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      const size_t j = (size_t)jc[u];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const bool ok = jv[u] && rv[i];
        xr[u][i] = ok ? to_f(gx[j * RS + i]) : 0.0f;
        xz[u][i] = ok ? to_f(gx[(H + j) * RS + i]) : 0.0f;
        xn[u][i] = ok ? to_f(gx[(2 * H + j) * RS + i]) : 0.0f;
        dyn[u][i] = ok ? to_f(dyg[j * RS + i]) : 0.0f;
      }
    }
  };
  // a step's coefficients, so that with dh = dh_carry + dy:
  // dz = dh cz, dn = dh cn, dr = dn cr, d(gh)_n = dn r, dh z
  float cz[JT][RT], cn[JT][RT], cr[JT][RT], rr[JT][RT], zz[JT][RT], dyc[JT][RT];
  const auto coefficients = [&](int buf) {  // gh = W_hh h_prev + b_hh from hp_s[buf]
    const float* hb = hp_s + buf * H4 * RB;
    float ar[JT][RT], az[JT][RT], an[JT][RT];
#pragma unroll
    for (int u = 0; u < JT; ++u)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ar[u][i] = b_s[jc[u]];
        az[u][i] = b_s[H + jc[u]];
        an[u][i] = b_s[2 * H + jc[u]];
      }
    for (int k4 = 0; k4 < H4; k4 += 4) {
      float4 hv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) hv[i] = *reinterpret_cast<const float4*>(hp_at(hb, k4, i));
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        const float4 wr = *reinterpret_cast<const float4*>(w_s + jc[u] * kp + k4);
        const float4 wz = *reinterpret_cast<const float4*>(w_s + (H + jc[u]) * kp + k4);
        const float4 wn = *reinterpret_cast<const float4*>(w_s + (2 * H + jc[u]) * kp + k4);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          ar[u][i] = fmaf(wr.x, hv[i].x, ar[u][i]); ar[u][i] = fmaf(wr.y, hv[i].y, ar[u][i]);
          ar[u][i] = fmaf(wr.z, hv[i].z, ar[u][i]); ar[u][i] = fmaf(wr.w, hv[i].w, ar[u][i]);
          az[u][i] = fmaf(wz.x, hv[i].x, az[u][i]); az[u][i] = fmaf(wz.y, hv[i].y, az[u][i]);
          az[u][i] = fmaf(wz.z, hv[i].z, az[u][i]); az[u][i] = fmaf(wz.w, hv[i].w, az[u][i]);
          an[u][i] = fmaf(wn.x, hv[i].x, an[u][i]); an[u][i] = fmaf(wn.y, hv[i].y, an[u][i]);
          an[u][i] = fmaf(wn.z, hv[i].z, an[u][i]); an[u][i] = fmaf(wn.w, hv[i].w, an[u][i]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < JT; ++u)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float hp = *hp_at(hb, jc[u], i);
        const float r = sigm(xr[u][i] + ar[u][i]);
        const float z = sigm(xz[u][i] + az[u][i]);
        const float n = tanhf(xn[u][i] + r * an[u][i]);
        cz[u][i] = (hp - n) * z * (1.0f - z);
        cn[u][i] = (1.0f - z) * (1.0f - n * n);
        cr[u][i] = an[u][i] * r * (1.0f - r);
        rr[u][i] = r;
        zz[u][i] = z;
        dyc[u][i] = dyn[u][i];
      }
  };

  copy_hp(0, 0);
  if (L > 1) copy_hp(1, 1);
  load_x(0);
  cp_async_wait_all();
  __syncthreads();
  coefficients(0);
  float dhc[JT][RT];
#pragma unroll
  for (int u = 0; u < JT; ++u)
#pragma unroll
    for (int i = 0; i < RT; ++i) dhc[u][i] = 0.0f;

  for (int s = 0; s < L; ++s) {
    float* dgb = dg_s + (s & 1) * G * RB;
    float dr[JT][RT], dz[JT][RT], dn[JT][RT], dnr[JT][RT], acc[JT][RT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float dh = dhc[u][i] + dyc[u][i];
        dz[u][i] = dh * cz[u][i];
        dn[u][i] = dh * cn[u][i];
        dr[u][i] = dn[u][i] * cr[u][i];
        dnr[u][i] = dn[u][i] * rr[u][i];
        acc[u][i] = dh * zz[u][i];
      }
      if (jv[u]) {
        store_n<RT>(dgb + jc[u] * RB + p * RT, dr[u]);
        store_n<RT>(dgb + (H + jc[u]) * RB + p * RT, dz[u]);
        store_n<RT>(dgb + (2 * H + jc[u]) * RB + p * RT, dnr[u]);
      }
    }
    cp_async_wait_all();  // this thread's copies of h_prev(s+1)
    __syncthreads();      // d(gh) of step s and h_prev of step s+1 are complete
    {
      const int t = t_of(s);
      const size_t base = (size_t)(dir * L + t) * G * RS + row0;
      T* dgo = dgates + base;
      float* dno = dghn + (size_t)(dir * L + t) * H * RS + row0;
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        if (!jv[u]) continue;
        const size_t j = (size_t)jc[u];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          if (!rv[i]) continue;
          dgo[j * RS + i] = from_f<T>(dr[u][i]);
          dgo[(H + j) * RS + i] = from_f<T>(dz[u][i]);
          dgo[(2 * H + j) * RS + i] = from_f<T>(dn[u][i]);
          if constexpr (!std::is_same_v<T, float>) {
            float* d32 = dg32 + base;
            d32[j * RS + i] = dr[u][i];
            d32[(H + j) * RS + i] = dz[u][i];
            d32[(2 * H + j) * RS + i] = dn[u][i];
          }
          dno[j * RS + i] = dnr[u][i];
        }
      }
    }
    // the next step's loads: hp_s[s & 1] (h_prev of step s) was last read
    // before this barrier
    if (s + 1 < L) load_x(s + 1);
    if (s + 2 < L) copy_hp(s + 2, s & 1);
    // dh_carry = dh z + W_hh^T d(gh): W_hh row g along this thread's units,
    // 16 bytes a load
    const float* wq = w_s + q * JT;
    for (int g = 0; g < G; ++g) {
      float dv[RT];
      load_n<RT>(dgb + g * RB + p * RT, dv);
      float wv[JT];
#pragma unroll
      for (int u4 = 0; u4 < JT; u4 += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wq + g * kp + u4);
        wv[u4] = w4.x; wv[u4 + 1] = w4.y; wv[u4 + 2] = w4.z; wv[u4 + 3] = w4.w;
      }
#pragma unroll
      for (int u = 0; u < JT; ++u)
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[u][i] = fmaf(wv[u], dv[i], acc[u][i]);
    }
#pragma unroll
    for (int u = 0; u < JT; ++u)
#pragma unroll
      for (int i = 0; i < RT; ++i) dhc[u][i] = acc[u][i];
    if (s + 1 < L) coefficients((s + 1) & 1);
  }
}

constexpr int kDwThreads = 256;
// 16-byte copies a thread issues for one chunk, at most: (4H + 32) rows of
// KC / 4 float4 over 256 threads (10 at H <= 32, 9 at H <= 128)
constexpr int kMaxSlots = 10;
// rows of a step a chunk, for TM rows a thread
__host__ __device__ constexpr int dw_chunk(int tm) { return tm == 3 ? 64 : tm == 6 ? 32 : 16; }

// dW_hh partials of K slice sl, K = (t, row): A x h_prev^T with A = [dr,
// dz, dn r, dn] (4H rows; the first 3H are d(gh), the last H dgates' n
// slot, which only the bias sums read).  A block forms the 3H x 32 outputs
// of one column tile k0 .. k0 + 31 over its slice, as a register tile of
// TM x 4 a thread (rows gi + 32 m, columns k0 + ki + 8 j); chunks of KC
// rows of one step are copied into shared memory with cp.async, two stages
// (the next chunk is issued before the wait for this one), so each A and
// h_prev word of the slice is read once.  The blocks of column tile 0 also
// sum each A row over the slice (the bias partials [dr, dz, dn r, dn]).
// Every sum runs in a fixed order.
// TM = 3 ceil(H / 32); KC = 64, 32 or 16 at H <= 32, 64, 128, so that the
// two stages take ~87 KB at every H.  Up to H = 64 two blocks share an SM
// (at most 128 registers a thread); the taller register tiles of H > 64
// would spill there, and take one.
// dgates: the f32 d(gates) (the bf16 instantiation's dg32); out: h in T.
template <int TM, typename T>
__global__ void __launch_bounds__(kDwThreads, TM <= 6 ? 2 : 1)
bigru_bwd_dw_kernel(const float* __restrict__ dgates, const float* __restrict__ dghn,
                    const T* __restrict__ out, float* __restrict__ dw_part,
                    float* __restrict__ bias_part, int L, int H, int R, int S, bool vec) {
  constexpr int KC = dw_chunk(TM);
  constexpr int KS = KC + 4;  // row stride: 8 neighbouring rows on 8 bank groups
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  const int MA = max(4 * H, 32 * TM);  // A rows of a stage (zeros past 4H)
  const int ST = (MA + 32) * KS;       // a stage: [MA A rows, then 32 h_prev rows][KS]
  const int k0 = blockIdx.x * 32;
  const int dir = blockIdx.y / S, sl = blockIdx.y % S;
  const int nrc = (R + KC - 1) / KC;
  const long long nch = (long long)L * nrc;  // chunk c = (t, row chunk)
  const int c0 = (int)(nch * sl / S), c1 = (int)(nch * (sl + 1) / S);
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  // a warp: 8 row groups x 4 column groups, so its A reads hit 8 rows and
  // its h_prev reads 4 neighbouring rows (no bank conflict)
  const int gi = lane % 8 + 8 * (wp % 4), ki = lane / 8 + 4 * (wp / 4);
  const bool sums = blockIdx.x == 0;
  const int rows_a = sums ? 4 * H : 3 * H;
  const int rows_b = min(32, H - k0);
  const size_t RS = (size_t)R;

  for (int i = threadIdx.x; i < 2 * ST; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();  // the zeros (rows past 4H and past H) land before any copy

  // A row m of a chunk: dgates' r and z rows, d(gh)_n, dgates' n row;
  // whether it is dghn's, and its row within its tensor's step
  const auto a_src = [&](int m, bool* n_slot) {
    *n_slot = m >= 2 * H && m < 3 * H;
    return m < 2 * H ? m : m < 3 * H ? m - 2 * H : m - H;
  };
  const auto has_prev = [&](int c) {
    const int t = c / nrc, tp = dir == 0 ? t - 1 : t + 1;
    return tp >= 0 && tp < L;
  };
  // chunk c into stage st; h_prev only where the step has one (else the
  // products are skipped)
  const auto issue = [&](int c, int st) {
    const int t = c / nrc, r0 = (c % nrc) * KC;
    const int tp = dir == 0 ? t - 1 : t + 1;
    const bool prev = has_prev(c);
    float* stage = smem + st * ST;
    const size_t step = (size_t)(dir * L + t);
    if (vec) {
      // 16-byte copies: element i = tid + j * threads of the stage's rows
      // of KC / 4 float4 (32-bit offsets within one step of a tensor)
      const float* gb = dgates + step * G * RS + r0;
      const float* nb = dghn + step * H * RS + r0;
      const T* hb = out + ((size_t)(prev ? tp : 0) * 2 * H + (size_t)dir * H + k0) * RS + r0;
      constexpr int n4 = KC / 4;
#pragma unroll
      for (int j = 0; j < kMaxSlots; ++j) {
        const int i = threadIdx.x + j * kDwThreads;
        const int m = i / n4, c4 = (i % n4) * 4;
        const bool in = r0 + c4 < R;
        if (m < rows_a) {
          bool n_slot;
          const int g = a_src(m, &n_slot);
          float* d = stage + m * KS + c4;
          if (in) cp_async16(d, (n_slot ? nb : gb) + g * R + c4);
          else *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if (prev && m < rows_a + rows_b) {
          float* d = stage + (MA + m - rows_a) * KS + c4;
          if (in) stage4(d, hb + (m - rows_a) * R + c4);
          else *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    } else {
      const int nb = prev ? rows_b : 0;
      for (int i = threadIdx.x; i < (rows_a + nb) * KC; i += blockDim.x) {
        const int m = i / KC, cc = i % KC;
        const bool in = r0 + cc < R;
        if (m < rows_a) {
          bool n_slot;
          const int g = a_src(m, &n_slot);
          const float* src = n_slot ? dghn + (step * H + g) * RS : dgates + (step * G + g) * RS;
          float* d = stage + m * KS + cc;
          if (in) cp_async4(d, src + r0 + cc);
          else *d = 0.0f;
        } else {
          const T* src = out + ((size_t)tp * 2 * H + (size_t)dir * H + k0 + (m - rows_a)) * RS;
          float* d = stage + (MA + m - rows_a) * KS + cc;
          if (in) stage1(d, src + r0 + cc);
          else *d = 0.0f;
        }
      }
    }
  };

  // the row sums: item (row, segment of KC / nseg columns), at most two a
  // thread (4H * nseg <= 512)
  int nseg = 1;
  while (nseg * 2 * 4 * H <= kDwThreads && nseg * 2 * 4 <= KC) nseg *= 2;
  const int seg = KC / nseg;
  float bsum0 = 0.0f, bsum1 = 0.0f;
  float acc[TM][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;

  // one commit group per chunk (empty past the slice): chunk c is the
  // (c - c0 + 1)-th group
  if (c0 < c1) issue(c0, 0);
  cp_async_commit();
  for (int c = c0; c < c1; ++c) {
    const int st = (c - c0) & 1;
    if (c + 1 < c1) issue(c + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c landed; c + 1 may be in flight
    __syncthreads();     // every thread's copies of chunk c are visible
    const float* as = smem + st * ST;
    const float* bs = as + MA * KS;
    if (has_prev(c)) {
#pragma unroll 4
      for (int rr = 0; rr < KC; rr += 4) {
        float4 bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + (ki + 8 * j) * KS + rr);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float4 av = *reinterpret_cast<const float4*>(as + (gi + 32 * m) * KS + rr);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m][j] = fmaf(av.x, bv[j].x, acc[m][j]);
            acc[m][j] = fmaf(av.y, bv[j].y, acc[m][j]);
            acc[m][j] = fmaf(av.z, bv[j].z, acc[m][j]);
            acc[m][j] = fmaf(av.w, bv[j].w, acc[m][j]);
          }
        }
      }
    }
    if (sums) {
      const auto row_sum = [&](int item, float& v) {
        const float* src = as + (item / nseg) * KS + (item % nseg) * seg;
        for (int cc = 0; cc < seg; cc += 4) {
          const float4 x = *reinterpret_cast<const float4*>(src + cc);
          v += x.x;
          v += x.y;
          v += x.z;
          v += x.w;
        }
      };
      if ((int)threadIdx.x < 4 * H * nseg) row_sum(threadIdx.x, bsum0);
      if ((int)threadIdx.x + kDwThreads < 4 * H * nseg) row_sum(threadIdx.x + kDwThreads, bsum1);
    }
    __syncthreads();  // stage st is free for chunk c + 2
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int g = gi + 32 * m;
    if (g >= G) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ki + 8 * j;
      if (k < H) dw_part[(((size_t)dir * S + sl) * G + g) * H + k] = acc[m][j];
    }
  }
  if (sums) {  // each row's segments, summed in order
    if ((int)threadIdx.x < 4 * H * nseg) smem[threadIdx.x] = bsum0;
    if ((int)threadIdx.x + kDwThreads < 4 * H * nseg) smem[threadIdx.x + kDwThreads] = bsum1;
    __syncthreads();
    for (int g = threadIdx.x; g < 4 * H; g += blockDim.x) {
      float v = 0.0f;
      for (int i = 0; i < nseg; ++i) v += smem[g * nseg + i];
      bias_part[((size_t)dir * S + sl) * 4 * H + g] = v;
    }
  }
}

// out[d][i] = sum over s < S of part[d][s][i], i < n: each of kSumSegs
// threads sums a run of s in order, then one adds the runs in order, so
// every call adds in the same order
constexpr int kSumOuts = 32, kSumSegs = 8;
__global__ void __launch_bounds__(kSumOuts * kSumSegs)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int S, int n) {
  __shared__ float run_s[kSumSegs][kSumOuts];
  const int o = threadIdx.x % kSumOuts, sg = threadIdx.x / kSumOuts;
  const int i = blockIdx.x * kSumOuts + o, d = blockIdx.y;
  const int s0 = S * sg / kSumSegs, s1 = S * (sg + 1) / kSumSegs;
  float acc = 0.0f;
  if (i < n)
    for (int s = s0; s < s1; ++s) acc += part[((size_t)d * S + s) * n + i];
  run_s[sg][o] = acc;
  __syncthreads();
  if (sg == 0 && i < n) {
    float v = 0.0f;
    for (int k = 0; k < kSumSegs; ++k) v += run_s[k][o];
    out[(size_t)d * n + i] = v;
  }
}

// The recurrence's launch: units and rows a thread, rows a block, threads
// and shared memory of a block, W_hh's row stride in shared memory.
struct Plan {
  int jt, rt, rows, threads, kp;
  size_t smem;
};

template <typename T>
using RecKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, float*, float*,
                           int, int, int, int);

template <typename T>
RecKernel<T> kernel_of(const Plan& p) {
  if (p.jt == 8) return bigru_bwd_rec_kernel<T, 8, 1>;
  return p.rt == 2 ? bigru_bwd_rec_kernel<T, 4, 2> : bigru_bwd_rec_kernel<T, 4, 1>;
}

// shared memory of a recurrence block: W_hh, two h_prev and two d(gh)
// buffers of `rows` rows, the bias
size_t rec_smem(int H, int kp, int rows) {
  const int H4 = (H + 3) & ~3;
  return sizeof(float) *
         ((size_t)3 * H * kp + (size_t)2 * H4 * rows + (size_t)2 * 3 * H * rows + 3 * H);
}

// The plan with jt units and rt rows a thread and p row groups a block;
// W_hh's rows are padded by 4 floats where that fits (so that the rows the
// lanes of one warp read start on other banks).  False when it does not fit.
bool block_plan(int H, int jt, int rt, int p, int smem_max, Plan* out) {
  const int q = (H + jt - 1) / jt;
  if (q * p > kMaxThreads) return false;
  for (int kp : {q * jt + 4, q * jt}) {
    const size_t smem = rec_smem(H, kp, p * rt);
    if (smem <= (size_t)smem_max) {
      *out = Plan{jt, rt, p * rt, q * p, kp, smem};
      return true;
    }
  }
  return false;
}

// Blocks of plan p that the card runs at once.
template <typename T>
int resident_blocks(const Plan& p, int device, cudaError_t* e) {
  const RecKernel<T> kernel = kernel_of<T>(p);
  *e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  int sms = 0, n = 0;
  if (*e == cudaSuccess) *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*e == cudaSuccess)
    *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p.threads, p.smem);
  return n * sms;
}

// The plan for H and R, by the occupancy API: the fewest waves of blocks;
// then the most warps in the first wave (at gru2 of the fused batch, 4096
// rows, a thread of 4 units and 1 row keeps 8 warps on every SM, where one
// of 4 units and 2 rows leaves 4); then the most units and rows a thread
// (each word of W_hh and d(gh) read from shared memory feeds more FMAs);
// then the most rows a block.  Tiles of at least 8 row groups, so a block
// holds whole warps at H=32.  (8 units of 2 rows a thread needs 255
// registers and spills: not a candidate.)
template <typename T>
bool make_plan(int H, int R, int device, Plan* out, cudaError_t* e) {
  int smem_max = 0;
  *e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (*e != cudaSuccess) return false;
  bool found = false;
  std::tuple<int, int, int, int> best;
  for (const auto jr : {std::make_pair(4, 2), std::make_pair(8, 1), std::make_pair(4, 1)}) {
    for (int p = 32; p >= 8; p /= 2) {
      Plan plan;
      if (!block_plan(H, jr.first, jr.second, p, smem_max, &plan)) continue;
      const int resident = resident_blocks<T>(plan, device, e);
      if (*e != cudaSuccess) return false;
      if (resident == 0) continue;
      const int blocks = 2 * ((R + plan.rows - 1) / plan.rows);
      const int waves = (blocks + resident - 1) / resident;
      const int warps = std::min(blocks, resident) * ((plan.threads + 31) / 32);
      const auto key = std::make_tuple(-waves, warps, plan.jt * plan.rt, plan.rows);
      if (!found || key > best) {
        best = key;
        *out = plan;
        found = true;
      }
    }
  }
  return found;
}

// Plans already made, by (device, H, R, element size): the occupancy
// queries stay off every launch but the first of a shape.
std::mutex plans_mu;
std::map<std::tuple<int, int, int, int>, Plan> plans;

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// Returned, before any launch, for an H that no plan serves (none up to
// H = 128, the wrapper's limit: 4 units of 1 row in 8-row tiles fit).
constexpr int kNoFit = -1;

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

template <typename T>
cudaError_t launch_rec(const Plan& p, const T* gates, const T* w_hh, const T* b_hh, const T* out,
                       const T* dy, T* dgates, float* dg32, float* dghn, int L, int H, int R,
                       cudaStream_t stream) {
  const RecKernel<T> kernel = kernel_of<T>(p);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((R + p.rows - 1) / p.rows, 2), dim3(p.threads), p.smem, stream>>>(
      gates, w_hh, b_hh, out, dy, dgates, dg32, dghn, L, H, R, p.kp);
  return cudaGetLastError();
}

// The weight-gradient pass: TM = 3 ceil(H / 32) rows a thread, KC rows of
// a step a chunk (64 at H <= 32, fewer where A is taller), shared memory
// for two stages (~87 KB at every H).
template <typename T>
cudaError_t launch_dw(const float* dgates, const float* dghn, const T* out, float* dw_part,
                      float* bias_part, int L, int H, int R, int S, cudaStream_t stream) {
  const int tm = 3 * ((H + 31) / 32);
  const size_t smem =
      sizeof(float) * 2 * (std::max(4 * H, 32 * tm) + 32) * (dw_chunk(tm) + 4);
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  // 16-byte copies need R % 4 == 0 and aligned rows; their slots hold
  // 32-bit offsets within one step of a tensor (3H * R elements)
  const bool vec = R % 4 == 0 && aligned(dgates) && aligned(dghn) && aligned(out) &&
                   (size_t)3 * H * R < (size_t)1 << 30;
  const auto kernel = tm == 3   ? bigru_bwd_dw_kernel<3, T>
                      : tm == 6 ? bigru_bwd_dw_kernel<6, T>
                      : tm == 9 ? bigru_bwd_dw_kernel<9, T>
                                : bigru_bwd_dw_kernel<12, T>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((H + 31) / 32, 2 * S), kDwThreads, smem, stream>>>(
      dgates, dghn, out, dw_part, bias_part, L, H, R, S, vec);
  return cudaGetLastError();
}

// The recurrence, the weight-gradient pass over the f32 d(gates) (dgates
// itself for f32, dg32 for bf16) and the two fixed-order sums.
template <typename T>
int launch(const T* gates, const T* w_hh, const T* b_hh, const T* out, const T* dy, T* dgates,
           float* dg32, float* dghn, float* bias_part, float* dw_part, float* dw_hh,
           float* bias4, int L, int H, int R, int S, cudaStream_t stream) {
  Plan p;
  int device = 0;
  const int err = plan_of<T>(H, R, &p, &device);
  if (err != 0) return err;  // before any launch
  cudaError_t e =
      launch_rec<T>(p, gates, w_hh, b_hh, out, dy, dgates, dg32, dghn, L, H, R, stream);
  if (e != cudaSuccess) return clear_and_return(e);
  const float* d32;
  if constexpr (std::is_same_v<T, float>) d32 = dgates;
  else d32 = dg32;
  e = launch_dw<T>(d32, dghn, out, dw_part, bias_part, L, H, R, S, stream);
  if (e != cudaSuccess) return clear_and_return(e);
  const int nw = 3 * H * H;
  const int threads = kSumOuts * kSumSegs;
  sum_partials_kernel<<<dim3((nw + kSumOuts - 1) / kSumOuts, 2), threads, 0, stream>>>(
      dw_part, dw_hh, S, nw);
  sum_partials_kernel<<<dim3((4 * H + kSumOuts - 1) / kSumOuts, 2), threads, 0, stream>>>(
      bias_part, bias4, S, 4 * H);
  return (int)cudaGetLastError();
}

template <typename T>
int plan_query(int H, int R, int* plan) {
  Plan p;
  int device = 0;
  const int err = plan_of<T>(H, R, &p, &device);
  if (err != 0) return err;
  cudaError_t e;
  const int resident = resident_blocks<T>(p, device, &e);
  if (e != cudaSuccess) return clear_and_return(e);
  const int values[7] = {p.jt, p.rt, p.rows, p.threads, (int)p.smem,
                         2 * ((R + p.rows - 1) / p.rows), resident};
  for (int i = 0; i < 7; ++i) plan[i] = values[i];
  return 0;
}

}  // namespace

extern "C" int bigru_bwd(const float* gates, const float* w_hh, const float* b_hh,
                         const float* out, const float* dy, float* dgates, float* dghn,
                         float* bias_part, float* dw_part, float* dw_hh, float* bias4,
                         int L, int H, int R, int S, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, dy, dgates, nullptr, dghn, bias_part, dw_part, dw_hh,
                bias4, L, H, R, S, stream);
}

// dg32 [2, L, 3H, R] float32: the unrounded d(gates) for the weight gradient
extern "C" int bigru_bwd_bf16(const __nv_bfloat16* gates, const __nv_bfloat16* w_hh,
                              const __nv_bfloat16* b_hh, const __nv_bfloat16* out,
                              const __nv_bfloat16* dy, __nv_bfloat16* dgates, float* dg32,
                              float* dghn, float* bias_part, float* dw_part, float* dw_hh,
                              float* bias4, int L, int H, int R, int S, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, dy, dgates, dg32, dghn, bias_part, dw_part, dw_hh, bias4,
                L, H, R, S, stream);
}

// The recurrence's launch for hidden size H and R rows, for logs: plan[0..6]
// = units and rows a thread, rows, threads and shared-memory bytes of a
// block, blocks of the grid, blocks the card runs at once.  Launches nothing.
extern "C" int bigru_bwd_plan(int H, int R, int* plan) { return plan_query<float>(H, R, plan); }

extern "C" int bigru_bwd_bf16_plan(int H, int R, int* plan) {
  return plan_query<__nv_bfloat16>(H, R, plan);
}
