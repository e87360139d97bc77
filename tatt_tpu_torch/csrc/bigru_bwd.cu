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
// Layouts (float32, contiguous), those of csrc/bigru_fwd.cu:
//   gates, dgates [2, L, 3H, R]   (rows minor, gate order r, z, n)
//   w_hh [2, 3H, H], b_hh [2, 3H]; out, dy [L, 2H, R]
//   scratch: dghn [2, L, H, R] (dn r), bias_part [2, nblk, 4H],
//            dw_part [2, S, 3H, H]
//   dw_hh [2, 3H, H]; bias4 [2, 4H] = sums of [dr, dz, dn r, dn]
//     (db_hh = bias4[:, :3H]; dbx = bias4[:, :2H] ++ bias4[:, 3H:])
//
// What bounds it on an H100: as the forward, the serial chain of L steps,
// each a few small matrix-vector products per row (W_hh h_prev and
// W_hh^T d(gh), 3H x H multiply-adds each) paying shared-memory and
// barrier latency; the bytes (gates, h and dy in, dgates out) are small.
// The weight gradient is a [3H x L*R] x [L*R x H] product (K = 131072 at
// gru1 of the fused batch), off the serial chain.
//
// Design.  Kernel 1 (the recurrence) is the forward's: one block per
// (tile of RB rows, direction) loops over all L steps with W_hh[d] in
// shared memory; RB (32 or 16) neighbouring rows share a hidden-unit group
// and a thread owns JT=8 hidden units of one row, so loads and stores
// coalesce along the rows.
// h_prev comes from the forward's output, so each step loads it into
// shared memory (float4-packed along the hidden axis, as the forward keeps
// h) and recomputes gh with the forward's loop; d(gh) of the tile goes to
// shared memory for the W_hh^T product.  Kernel 1 stores d(gates_x) and,
// for the n slot, d(gh) = dn r; it also keeps each thread's bias sums in
// registers and reduces them across the tile's RB lanes at the end, one
// partial per block.  The TPU kernel adds dW_hh into one output block
// from every grid step in order; Hopper blocks run in no order, so
// kernel 2 forms dW_hh as a tiled f32 product over K = (t, row), split
// into S slices of K with one partial per slice, and kernel 3 sums the
// partials (weights and biases) in a fixed order: no atomics, so the sums
// are deterministic.  Kernel 1 holds W_hh, h_prev and d(gh) of the tile in
// shared memory: with RB = 32 rows that fits a block's 227 KiB up to
// H = 118 (257.5 KiB at H = 128), so wider BiGRUs take tiles of RB = 16
// rows (225.5 KiB at H = 128, the forward's limit too).  Where 32 rows
// fit they stay: 16-row tiles timed slower at both GruBlock shapes.

#include <cuda_runtime.h>

namespace {

constexpr int JT = 8;  // hidden units per thread

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// RB rows per block (32 or 16): RB consecutive lanes of a warp span the
// tile's rows for one group of JT hidden units
template <int RB>
__global__ void __launch_bounds__(512)
bigru_bwd_rec_kernel(const float* __restrict__ gates, const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh, const float* __restrict__ out,
                     const float* __restrict__ dy, float* __restrict__ dgates,
                     float* __restrict__ dghn, float* __restrict__ bias_part,
                     int L, int H, int R) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = (H + 3) & ~3;  // hidden axis padded to a float4 multiple
  const int G = 3 * H;
  float* w_s = smem;              // [3H][H4], zero-padded along k
  float* hp_s = w_s + G * H4;     // [H4/4][RB][4]: h_prev[k][row] packed by 4 k's
  float* dg_s = hp_s + H4 * RB;   // [3H][RB]: d(gh) of the tile
  float* b_s = dg_s + G * RB;     // [3H]

  const int dir = blockIdx.y;
  const int lane = threadIdx.x % RB;  // row within the tile
  const int q = threadIdx.x / RB;     // which group of JT hidden units
  const int row = blockIdx.x * RB + lane;
  const bool live = row < R;
  const size_t RS = (size_t)R;

  const float* w_d = w_hh + (size_t)dir * G * H;
  for (int i = threadIdx.x; i < G * H4; i += blockDim.x) {
    const int g = i / H4, k = i % H4;
    w_s[i] = k < H ? w_d[(size_t)g * H + k] : 0.0f;
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) b_s[i] = b_hh[dir * G + i];
  for (int i = threadIdx.x; i < H4 * RB; i += blockDim.x) hp_s[i] = 0.0f;
  __syncthreads();

  // this thread's units; out-of-range units clamp to H-1 for their (unused)
  // reads so every address stays valid
  int jc[JT];
  bool jv[JT];
#pragma unroll
  for (int u = 0; u < JT; ++u) {
    const int j = q * JT + u;
    jv[u] = j < H;
    jc[u] = jv[u] ? j : H - 1;
  }
  float dhc[JT], sr[JT], sz[JT], snh[JT], snx[JT];
#pragma unroll
  for (int u = 0; u < JT; ++u) dhc[u] = sr[u] = sz[u] = snh[u] = snx[u] = 0.0f;

  for (int s = 0; s < L; ++s) {
    const int t = dir == 0 ? L - 1 - s : s;
    const int tp = dir == 0 ? t - 1 : t + 1;  // the step before t in d's order
    const bool has_prev = tp >= 0 && tp < L;
    const float* gx = gates + (size_t)(dir * L + t) * G * RS + row;
    const float* hg = out + ((size_t)(has_prev ? tp : 0) * 2 * H + (size_t)dir * H) * RS + row;
    const float* dyg = dy + ((size_t)t * 2 * H + (size_t)dir * H) * RS + row;
    float xr[JT], xz[JT], xn[JT], hp[JT], dyv[JT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      const bool ok = live && jv[u];
      const size_t j = (size_t)jc[u];
      xr[u] = ok ? gx[j * RS] : 0.0f;
      xz[u] = ok ? gx[(H + j) * RS] : 0.0f;
      xn[u] = ok ? gx[(2 * H + j) * RS] : 0.0f;
      hp[u] = (ok && has_prev) ? hg[j * RS] : 0.0f;
      dyv[u] = ok ? dyg[j * RS] : 0.0f;
      if (jv[u]) hp_s[(jc[u] >> 2) * RB * 4 + lane * 4 + (jc[u] & 3)] = hp[u];
    }
    __syncthreads();  // h_prev of the tile is complete
    float ar[JT], az[JT], an[JT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      ar[u] = b_s[jc[u]];
      az[u] = b_s[H + jc[u]];
      an[u] = b_s[2 * H + jc[u]];
    }
    for (int k4 = 0; k4 < H4; k4 += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hp_s + k4 * RB + lane * 4);
#pragma unroll
      for (int u = 0; u < JT; ++u) {
        const float4 wr = *reinterpret_cast<const float4*>(w_s + jc[u] * H4 + k4);
        const float4 wz = *reinterpret_cast<const float4*>(w_s + (H + jc[u]) * H4 + k4);
        const float4 wn = *reinterpret_cast<const float4*>(w_s + (2 * H + jc[u]) * H4 + k4);
        ar[u] = fmaf(wr.x, hv.x, ar[u]); ar[u] = fmaf(wr.y, hv.y, ar[u]);
        ar[u] = fmaf(wr.z, hv.z, ar[u]); ar[u] = fmaf(wr.w, hv.w, ar[u]);
        az[u] = fmaf(wz.x, hv.x, az[u]); az[u] = fmaf(wz.y, hv.y, az[u]);
        az[u] = fmaf(wz.z, hv.z, az[u]); az[u] = fmaf(wz.w, hv.w, az[u]);
        an[u] = fmaf(wn.x, hv.x, an[u]); an[u] = fmaf(wn.y, hv.y, an[u]);
        an[u] = fmaf(wn.z, hv.z, an[u]); an[u] = fmaf(wn.w, hv.w, an[u]);
      }
    }
    float dhz[JT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      const float r = sigm(xr[u] + ar[u]);
      const float z = sigm(xz[u] + az[u]);
      const float n = tanhf(xn[u] + r * an[u]);
      const float dh = dhc[u] + dyv[u];
      const float dz = dh * (hp[u] - n) * z * (1.0f - z);
      const float dn = dh * (1.0f - z) * (1.0f - n * n);
      const float dr = dn * an[u] * r * (1.0f - r);
      const float dnr = dn * r;
      dhz[u] = dh * z;
      if (jv[u]) {
        const size_t j = (size_t)jc[u];
        dg_s[j * RB + lane] = dr;
        dg_s[(H + j) * RB + lane] = dz;
        dg_s[(2 * H + j) * RB + lane] = dnr;
        if (live) {
          float* dgo = dgates + (size_t)(dir * L + t) * G * RS + row;
          dgo[j * RS] = dr;
          dgo[(H + j) * RS] = dz;
          dgo[(2 * H + j) * RS] = dn;
          dghn[((size_t)(dir * L + t) * H + j) * RS + row] = dnr;
        }
        sr[u] += dr;
        sz[u] += dz;
        snh[u] += dnr;
        snx[u] += dn;
      }
    }
    __syncthreads();  // d(gh) of the tile is complete
    // dh_carry = dh z + W_hh^T d(gh); the next step's first barrier keeps
    // hp_s and dg_s from being overwritten before every thread is past here
    for (int g = 0; g < G; ++g) {
      const float dv = dg_s[g * RB + lane];
#pragma unroll
      for (int u = 0; u < JT; ++u) dhz[u] = fmaf(w_s[g * H4 + jc[u]], dv, dhz[u]);
    }
#pragma unroll
    for (int u = 0; u < JT; ++u) dhc[u] = dhz[u];
  }

  // bias sums of the block: RB consecutive lanes are one unit group over
  // the tile's rows (with RB = 16 a block may end in a half warp, so each
  // half shuffles under its own mask)
  const unsigned mask = RB == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  float* bp = bias_part + ((size_t)dir * gridDim.x + blockIdx.x) * 4 * H;
#pragma unroll
  for (int u = 0; u < JT; ++u) {
    float v[4] = {sr[u], sz[u], snh[u], snx[u]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = RB / 2; off > 0; off >>= 1) v[i] += __shfl_xor_sync(mask, v[i], off);
    if (lane == 0 && jv[u]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) bp[i * H + jc[u]] = v[i];
    }
  }
}

constexpr int TG = 32;  // d(gh) rows per tile
constexpr int TH = 32;  // hidden columns per tile
constexpr int KR = 32;  // rows of one time step per chunk

__global__ void __launch_bounds__(256)
bigru_bwd_dw_kernel(const float* __restrict__ dgates, const float* __restrict__ dghn,
                    const float* __restrict__ out, float* __restrict__ dw_part,
                    int L, int H, int R, int S) {
  __shared__ float a_s[TG][KR + 1];  // padded: conflict-free column reads
  __shared__ float b_s[TH][KR + 1];
  const int G = 3 * H;
  const int g0 = blockIdx.x * TG, k0 = blockIdx.y * TH;
  const int dir = blockIdx.z / S, sl = blockIdx.z % S;
  const int nrc = (R + KR - 1) / KR;
  const long long nch = (long long)L * nrc;  // chunk c = (t, row chunk)
  const int c0 = (int)(nch * sl / S), c1 = (int)(nch * (sl + 1) / S);
  const int gi = threadIdx.x / 8, kc = threadIdx.x % 8;
  const size_t RS = (size_t)R;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = c0; c < c1; ++c) {
    const int t = c / nrc, r0 = (c % nrc) * KR;
    const int tp = dir == 0 ? t - 1 : t + 1;
    if (tp < 0 || tp >= L) continue;  // h_prev = 0: nothing to add (uniform per block)
    for (int i = threadIdx.x; i < TG * KR; i += blockDim.x) {
      const int m = i / KR, rr = i % KR;
      const int r = r0 + rr;
      const int g = g0 + m, k = k0 + m;
      float av = 0.0f, bv = 0.0f;
      if (r < R && g < G) {
        av = g < 2 * H ? dgates[((size_t)(dir * L + t) * G + g) * RS + r]
                       : dghn[((size_t)(dir * L + t) * H + (g - 2 * H)) * RS + r];
      }
      if (r < R && k < H) bv = out[((size_t)tp * 2 * H + (size_t)dir * H + k) * RS + r];
      a_s[m][rr] = av;
      b_s[m][rr] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < KR; ++rr) {
      const float a = a_s[gi][rr];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(a, b_s[kc * 4 + j][rr], acc[j]);
    }
    __syncthreads();
  }
  const int g = g0 + gi;
  if (g < G) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + kc * 4 + j;
      if (k < H) dw_part[(((size_t)dir * S + sl) * G + g) * H + k] = acc[j];
    }
  }
}

// out[d][i] = sum over s < S of part[d][s][i], i < n, in order of s
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int S, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  if (i >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[((size_t)d * S + s) * n + i];
  out[(size_t)d * n + i] = acc;
}

}  // namespace

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
static int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// shared memory of the recurrence kernel for a tile of rb rows
static size_t rec_smem(int H, int rb) {
  const int H4 = (H + 3) & ~3;
  return sizeof(float) * ((size_t)3 * H * H4 + (size_t)H4 * rb + (size_t)3 * H * rb + 3 * H);
}

template <int RB>
static cudaError_t launch_rec(const float* gates, const float* w_hh, const float* b_hh,
                              const float* out, const float* dy, float* dgates, float* dghn,
                              float* bias_part, int L, int H, int R, cudaStream_t stream) {
  const size_t smem = rec_smem(H, RB);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bigru_bwd_rec_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tpr = (H + JT - 1) / JT;  // threads per row
  bigru_bwd_rec_kernel<RB><<<dim3((R + RB - 1) / RB, 2), dim3(RB * tpr), smem, stream>>>(
      gates, w_hh, b_hh, out, dy, dgates, dghn, bias_part, L, H, R);
  return cudaGetLastError();
}

// bias_part holds [2, ceil(R/16), 4H] floats: room for the smaller tile
extern "C" int bigru_bwd(const float* gates, const float* w_hh, const float* b_hh,
                         const float* out, const float* dy, float* dgates, float* dghn,
                         float* bias_part, float* dw_part, float* dw_hh, float* bias4,
                         int L, int H, int R, int S, cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return clear_and_return(e);
  const bool wide = rec_smem(H, 32) > (size_t)smem_max;
  e = wide ? launch_rec<16>(gates, w_hh, b_hh, out, dy, dgates, dghn, bias_part, L, H, R, stream)
           : launch_rec<32>(gates, w_hh, b_hh, out, dy, dgates, dghn, bias_part, L, H, R, stream);
  if (e != cudaSuccess) return clear_and_return(e);
  const int nblk = (R + (wide ? 16 : 32) - 1) / (wide ? 16 : 32);
  const dim3 grid((3 * H + TG - 1) / TG, (H + TH - 1) / TH, 2 * S);
  bigru_bwd_dw_kernel<<<grid, 256, 0, stream>>>(dgates, dghn, out, dw_part, L, H, R, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return clear_and_return(e);
  const int nw = 3 * H * H;
  sum_partials_kernel<<<dim3((nw + 255) / 256, 2), 256, 0, stream>>>(dw_part, dw_hh, S, nw);
  sum_partials_kernel<<<dim3((4 * H + 255) / 256, 2), 256, 0, stream>>>(
      bias_part, bias4, nblk, 4 * H);
  return (int)cudaGetLastError();
}
