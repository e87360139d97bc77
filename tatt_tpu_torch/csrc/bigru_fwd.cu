// Forward recurrence of a bidirectional GRU, both directions in one launch.
//
// Replaces the TPU kernel tatt_tpu/kernels/pallas_gru.py:_gru_fwd_kernel
// (launched by _fwd_call, pallas_call at pallas_gru.py:241).
//
// Computes, for direction d in {0, 1} and every row r independently:
//   gh = W_hh[d] h + b_hh[d];  r = s(x_r + gh_r);  z = s(x_z + gh_z)
//   n  = tanh(x_n + r * gh_n);  h' = (1 - z) n + z h
// where x = gates[d, t, :, r] is the input projection (computed outside by
// one matmul, with GruBlock's 1x1 conv folded in).  Direction 0 walks
// t = 0 .. L-1, direction 1 walks t = L-1 .. 0 through mirrored indices and
// writes each output at its forward-time slot: no flipped copy exists.
//
// Layouts (float32, contiguous):
//   gates [2, L, 3H, R]   (rows minor, gate order r, z, n)
//   w_hh  [2, 3H, H],  b_hh [2, 3H]
//   out   [L, 2H, R]      (direction d at channels d*H .. d*H+H-1)
//
// What bounds it on an H100: the recurrence is serial in t, and each step
// is a small matrix-vector product per row (3H x H multiply-adds) -- far
// below the card's float32 rate per byte, and the bytes (gates in once,
// out once) are small.  So the bound is the serial chain of L steps, each
// paying shared-memory and synchronisation latency, plus the bytes.
//
// Design: one block per (tile of RB=32 rows, direction), looping over all
// L steps inside the block (Hopper's blocks run in no order, so the carry
// cannot live across blocks the way the TPU grid carries it in VMEM).
//   - W_hh[d] and b_hh[d] are staged once in shared memory (96x32 f32 =
//     12 KB at H=32); every warp reads the same weight word, a broadcast.
//   - A warp spans 32 neighbouring rows and a thread owns JT=8 hidden
//     units of one row, so gate loads and output stores are coalesced
//     along the rows (the [.., 3H, R] layout of the JAX kernel).
//   - The previous h of the tile lives in shared memory, float4-packed
//     along the hidden axis so each k-step of the matvec is one 16-byte
//     load of h and three 16-byte broadcast loads of W per unit.
//   - The step's gate inputs are loaded before the matvec so their
//     latency hides behind it.
//   - The ragged last tile is masked (rows >= R load zeros, store nothing).
// Hidden sizes up to 128 are supported (smem 210 KB at H=128, opted in).

#include <cuda_runtime.h>

namespace {

constexpr int RB = 32;  // rows per block: one warp spans 32 neighbouring rows
constexpr int JT = 8;   // hidden units per thread

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(512)
bigru_fwd_kernel(const float* __restrict__ gates, const float* __restrict__ w_hh,
                 const float* __restrict__ b_hh, float* __restrict__ out,
                 int L, int H, int R) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = (H + 3) & ~3;  // hidden axis padded to a float4 multiple
  const int G = 3 * H;
  float* w_s = smem;              // [3H][H4], zero-padded along k
  float* h_s = w_s + G * H4;      // [H4/4][RB][4]: h[k][row] packed by 4 k's
  float* b_s = h_s + H4 * RB;     // [3H]

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
  for (int i = threadIdx.x; i < H4 * RB; i += blockDim.x) h_s[i] = 0.0f;
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
  float h_own[JT];
#pragma unroll
  for (int u = 0; u < JT; ++u) h_own[u] = 0.0f;

  for (int s = 0; s < L; ++s) {
    const int t = dir == 0 ? s : L - 1 - s;
    const float* gx = gates + (size_t)(dir * L + t) * G * RS + row;
    float xr[JT], xz[JT], xn[JT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      const bool ok = live && jv[u];
      xr[u] = ok ? gx[(size_t)jc[u] * RS] : 0.0f;
      xz[u] = ok ? gx[(size_t)(H + jc[u]) * RS] : 0.0f;
      xn[u] = ok ? gx[(size_t)(2 * H + jc[u]) * RS] : 0.0f;
    }
    float ar[JT], az[JT], an[JT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      ar[u] = b_s[jc[u]];
      az[u] = b_s[H + jc[u]];
      an[u] = b_s[2 * H + jc[u]];
    }
    for (int k4 = 0; k4 < H4; k4 += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h_s + k4 * RB + lane * 4);
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
    float hn[JT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      const float r = sigm(xr[u] + ar[u]);
      const float z = sigm(xz[u] + az[u]);
      const float n = tanhf(xn[u] + r * an[u]);
      hn[u] = (1.0f - z) * n + z * h_own[u];
    }
    __syncthreads();  // every thread has read the previous h
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      if (jv[u]) {
        const int j = jc[u];
        h_own[u] = hn[u];
        h_s[(j >> 2) * RB * 4 + lane * 4 + (j & 3)] = hn[u];
        if (live) out[((size_t)t * 2 * H + (size_t)dir * H + j) * RS + row] = hn[u];
      }
    }
    __syncthreads();  // the new h is complete before the next step reads it
  }
}

}  // namespace

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
static int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

extern "C" int bigru_fwd(const float* gates, const float* w_hh, const float* b_hh,
                         float* out, int L, int H, int R, cudaStream_t stream) {
  const int tpr = (H + JT - 1) / JT;  // threads per row
  const int H4 = (H + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)3 * H * H4 + (size_t)H4 * RB + 3 * H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bigru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return clear_and_return(e);
  }
  const dim3 grid((R + RB - 1) / RB, 2);
  const dim3 block(RB * tpr);
  bigru_fwd_kernel<<<grid, block, smem, stream>>>(gates, w_hh, b_hh, out, L, H, R);
  return (int)cudaGetLastError();
}
