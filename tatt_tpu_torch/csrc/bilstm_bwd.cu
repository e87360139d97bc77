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
//   dh = dh_carry + dy;  do = dh tanh(c) o(1-o);  dc = dc_carry + dh o (1-tanh(c)^2)
//   di = dc g i(1-i);  dg = dc i (1-g^2);  df = dc c_prev f(1-f)
//   dgates = [di, df, dg, do];  dh_carry = W_hh[d]^T dgates;  dc_carry = dc f
// and afterwards dW_hh[d] = sum_{t,r} dgates h_prev^T, db_hh[d] = sum dgates.
//
// Layouts (float32, contiguous), those of csrc/bilstm_fwd.cu:
//   gates, dgates [2, R, L, 4H]   (input projections / their gradient)
//   w_hh [2, 4H, H], b_hh [2, 4H]; dw_hh [2, 4H, H], db_hh [2, 4H]
//   out, cseq, dy [R, L, 2H]       (the forward's h and c, and dL/dout)
//
// What bounds it on an H100: the dh carry is serial in t.  Each step is
// two [4H x H] matrix-vector products per row (the gate recompute and
// W_hh^T dgates); at H=256 W_hh is 1 MB per direction, too large for one
// block's 227 KB of shared memory, and R is only 64.  The weight gradient
// is a [4H x R*L] x [R*L x H] product, off the serial chain.
//
// Design.  Kernel 1 (the recurrence) keeps the forward's cluster split:
// a cluster of CS=8 blocks serves one (direction, tile of RT=16 rows), and
// block `rank` keeps the 4U rows of W_hh of its hidden units
// [rank*U, rank*U+U) in shared memory for the whole launch.  A thread owns
// one unit (all four gates) for RPT=4 rows, with the dh and dc carries in
// registers.  Per step:
//   - h_prev of the tile comes from the forward's output (not from the
//     carry), so the gate recompute is the forward's loop over shared memory;
//   - the block's dgates go to shared memory, and each thread forms the
//     partial W_hh^T dgates of its block's rows for CS hidden units, one
//     per rank, and stores each into that rank's shared memory (distributed
//     shared memory): a reduce-scatter;
//   - one cluster barrier per step; then each thread sums the CS partials
//     of its own unit.  The partial buffers are double-buffered, so that
//     barrier is the only one across blocks.
// Kernel 2 (the weight gradient) is a tiled f32 product over K = R*L: TPU
// grid steps run in order and add into one dW block, Hopper blocks do not,
// so each block owns a 64x64 tile of [dW_hh | db_hh] (db_hh as a column of
// ones beside h_prev) over the whole K: no atomics, deterministic sums.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RT = 16;  // rows per cluster
constexpr int RPT = 4;  // rows per thread
constexpr int RG = RT / RPT;

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(256)
bilstm_bwd_rec_kernel(const float* __restrict__ gates, const float* __restrict__ w_hh,
                      const float* __restrict__ b_hh, const float* __restrict__ out,
                      const float* __restrict__ cseq, const float* __restrict__ dy,
                      float* __restrict__ dgates, int L, int H, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int U = H / cs;
  const int WS = 4 * U + 1;  // padded row of the transposed slice: no bank conflicts
  extern __shared__ __align__(16) float smem[];
  float* hp_s = smem;                    // [H][RT]: h_prev of the tile
  float* dg_s = hp_s + H * RT;           // [4U][RT]: this block's dgates
  float* red_s = dg_s + 4 * U * RT;      // [2][cs][U][RT]: partial dh from each rank
  float* w_s = red_s + 2 * cs * U * RT;  // [H][WS]

  const int dir = blockIdx.y;
  const int tile = blockIdx.x / cs;
  const int u = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int unit = rank * U + u;
  const int row0 = tile * RT + rg * RPT;
  const int G = 4 * H;
  const size_t H2 = 2 * (size_t)H;

  // this block's 4U rows of W_hh[dir], read along k (coalesced), stored [k][g*U+u]
  const float* w_d = w_hh + (size_t)dir * G * H;
  for (int i = threadIdx.x; i < 4 * U * H; i += blockDim.x) {
    const int gu = i / H, k = i % H;
    const int g = gu / U, uu = gu % U;
    w_s[k * WS + gu] = w_d[(size_t)(g * H + rank * U + uu) * H + k];
  }
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = b_hh[dir * G + g * H + unit];
  float dhc[RPT], dcc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dhc[r] = dcc[r] = 0.0f;
  cluster.sync();  // every block of the cluster runs before any remote store

  for (int s = 0; s < L; ++s) {
    const int t = dir == 0 ? L - 1 - s : s;
    const int tp = dir == 0 ? t - 1 : t + 1;  // the step before t in d's order
    const bool has_prev = tp >= 0 && tp < L;
    for (int i = threadIdx.x; i < H * RT; i += blockDim.x) {
      const int rr = i / H, k = i % H;  // k fastest: coalesced along the hidden axis
      const int row = tile * RT + rr;
      hp_s[k * RT + rr] = (has_prev && row < R)
          ? out[((size_t)row * L + tp) * H2 + (size_t)dir * H + k] : 0.0f;
    }
    float acc[4][RPT], ct[RPT], cp[RPT], dyv[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r;
      const bool live = row < R;
      const size_t rl = (size_t)(live ? row : 0) * L;
      const float* gx = gates + (((size_t)dir * R + (live ? row : 0)) * L + t) * G + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][r] = bias[g] + (live ? gx[g * H] : 0.0f);
      const size_t o = (rl + t) * H2 + (size_t)dir * H + unit;
      ct[r] = live ? cseq[o] : 0.0f;
      dyv[r] = live ? dy[o] : 0.0f;
      cp[r] = (live && has_prev) ? cseq[(rl + tp) * H2 + (size_t)dir * H + unit] : 0.0f;
    }
    __syncthreads();  // h_prev of the tile is in shared memory
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(hp_s + k * RT + rg * RPT);
      const float* wk = w_s + k * WS + u;
      const float w0 = wk[0], w1 = wk[U], w2 = wk[2 * U], w3 = wk[3 * U];
      const float hr[RPT] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[0][r] = fmaf(w0, hr[r], acc[0][r]);
        acc[1][r] = fmaf(w1, hr[r], acc[1][r]);
        acc[2][r] = fmaf(w2, hr[r], acc[2][r]);
        acc[3][r] = fmaf(w3, hr[r], acc[3][r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float ig = sigm(acc[0][r]);
      const float fg = sigm(acc[1][r]);
      const float gg = tanhf(acc[2][r]);
      const float og = sigm(acc[3][r]);
      const float tc = tanhf(ct[r]);
      const float dh = dhc[r] + dyv[r];
      const float dc = dcc[r] + dh * og * (1.0f - tc * tc);
      const float d[4] = {dc * gg * ig * (1.0f - ig), dc * cp[r] * fg * (1.0f - fg),
                          dc * ig * (1.0f - gg * gg), dh * tc * og * (1.0f - og)};
      dcc[r] = dc * fg;
      const int row = row0 + r;
      float* dgo = dgates + (((size_t)dir * R + (row < R ? row : 0)) * L + t) * G + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dg_s[(g * U + u) * RT + rg * RPT + r] = d[g];
        if (row < R) dgo[g * H] = d[g];
      }
    }
    __syncthreads();  // the block's dgates are in shared memory
    float* red = red_s + (s & 1) * cs * U * RT;
    for (int j = 0; j < cs; ++j) {  // partial dh_prev of unit j*U+u, owned by rank j
      const float* wk = w_s + (j * U + u) * WS;
      float p[RPT] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int gu = 0; gu < 4 * U; ++gu) {
        const float w = wk[gu];
        const float4 dv = *reinterpret_cast<const float4*>(dg_s + gu * RT + rg * RPT);
        p[0] = fmaf(w, dv.x, p[0]);
        p[1] = fmaf(w, dv.y, p[1]);
        p[2] = fmaf(w, dv.z, p[2]);
        p[3] = fmaf(w, dv.w, p[3]);
      }
      float* remote = cluster.map_shared_rank(red, j);
      *reinterpret_cast<float4*>(remote + (rank * U + u) * RT + rg * RPT) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    // publishes every rank's partials; also no block moves on to overwrite
    // hp_s / dg_s, or to store into a buffer another block still reads
    // (step s+1 writes the other buffer, step s+2 this one), before all
    // have passed this point
    cluster.sync();
#pragma unroll
    for (int r = 0; r < RPT; ++r) dhc[r] = 0.0f;
    for (int src = 0; src < cs; ++src) {
      const float4 v = *reinterpret_cast<const float4*>(red + (src * U + u) * RT + rg * RPT);
      dhc[0] += v.x;
      dhc[1] += v.y;
      dhc[2] += v.z;
      dhc[3] += v.w;
    }
  }
}

constexpr int TM = 64;  // gate rows per tile
constexpr int TN = 64;  // hidden columns per tile (column H is the bias)
constexpr int TK = 16;  // (row, time) pairs per chunk

__global__ void __launch_bounds__(256)
bilstm_bwd_dw_kernel(const float* __restrict__ dgates, const float* __restrict__ out,
                     float* __restrict__ dw_hh, float* __restrict__ db_hh,
                     int L, int H, int R) {
  __shared__ __align__(16) float a_s[TK][TM];
  __shared__ __align__(16) float b_s[TK][TN];
  const int dir = blockIdx.z;
  const int G = 4 * H;
  const int K = R * L;  // kk = row * L + t
  const int g0 = blockIdx.x * TM, k0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t H2 = 2 * (size_t)H;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < K; kb += TK) {
    for (int i = threadIdx.x; i < TK * TM; i += blockDim.x) {
      const int kk = i / TM, m = i % TM;
      const int kg = kb + kk;
      const int g = g0 + m, k = k0 + m;
      a_s[kk][m] = (kg < K && g < G) ? dgates[((size_t)dir * K + kg) * G + g] : 0.0f;
      float bv = 0.0f;
      if (kg < K) {
        const int row = kg / L, t = kg % L;
        const int tp = dir == 0 ? t - 1 : t + 1;
        if (k < H) {
          if (tp >= 0 && tp < L) bv = out[((size_t)row * L + tp) * H2 + (size_t)dir * H + k];
        } else if (k == H) {
          bv = 1.0f;
        }
      }
      b_s[kk][m] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = g0 + ty * 4 + i;
    if (g >= G) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < H) dw_hh[((size_t)dir * G + g) * H + k] = acc[i][j];
      else if (k == H) db_hh[(size_t)dir * G + g] = acc[i][j];
    }
  }
}

}  // namespace

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
static int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// Shared-memory bytes of one recurrence block for hidden size H and cluster size cs.
static size_t rec_smem_bytes(int H, int cs) {
  const int U = H / cs;
  return sizeof(float) *
         ((size_t)H * RT + (size_t)4 * U * RT + (size_t)2 * cs * U * RT + (size_t)H * (4 * U + 1));
}

extern "C" int bilstm_bwd(const float* gates, const float* w_hh, const float* b_hh,
                          const float* out, const float* cseq, const float* dy,
                          float* dgates, float* dw_hh, float* db_hh,
                          int L, int H, int R, cudaStream_t stream) {
  int cs = 8;
  while (H % cs) cs /= 2;
  const size_t smem = rec_smem_bytes(H, cs);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_bwd_rec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return clear_and_return(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * ((R + RT - 1) / RT), 2);
  cfg.blockDim = dim3((H / cs) * RG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, bilstm_bwd_rec_kernel, gates, w_hh, b_hh, out, cseq, dy,
                         dgates, L, H, R);
  if (e != cudaSuccess) return clear_and_return(e);
  const dim3 grid((4 * H + TM - 1) / TM, (H + 1 + TN - 1) / TN, 2);
  bilstm_bwd_dw_kernel<<<grid, 256, 0, stream>>>(dgates, out, dw_hh, db_hh, L, H, R);
  return (int)cudaGetLastError();
}
