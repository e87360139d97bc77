// Forward recurrence of a bidirectional LSTM, both directions in one launch.
//
// Replaces the TPU kernel tatt_tpu/kernels/pallas_lstm.py:_lstm_fwd_kernel
// (launched by _fwd_call, pallas_call at pallas_lstm.py:110).
//
// Computes, for direction d in {0, 1} and every row r independently, with
// torch gate order i, f, g, o:
//   a = x + W_hh[d] h + b_hh[d];  i, f, o = s(a_i), s(a_f), s(a_o);  g = tanh(a_g)
//   c' = f c + i g;  h' = o tanh(c')
// where x = gates[d, r, t, :] is the input projection, computed outside by
// one matmul.  Direction 0 walks t = 0 .. L-1, direction 1 walks
// t = L-1 .. 0 and writes each output at its forward-time slot, so no
// time-flipped copy is made (the JAX wrapper flips outside its kernel).
// c lives in registers; when `cseq` is not null every c is also stored, in
// the `out` layout, for the backward pass (csrc/bilstm_bwd.cu), as the JAX
// kernel stores it (pallas_lstm.py:50).  Inference passes null and writes
// no extra bytes.
//
// Layouts (float32, contiguous):
//   gates [2, R, L, 4H]   (gates minor: the matmul x @ W_ih^T writes this
//                          layout directly, with no transpose)
//   w_hh  [2, 4H, H],  b_hh [2, 4H]
//   out   [R, L, 2H]      (the public BiLSTM layout; direction d at
//                          channels d*H .. d*H+H-1)
//   cseq  [R, L, 2H] or null
//
// What bounds it on an H100: the recurrence is serial in t, and at H=256
// each step is a [4H x H] x [H x rows] product whose W_hh (1 MB f32 per
// direction) does not fit one block's 227 KB of shared memory.  A first
// version, one block per (direction, 8 rows) re-reading W_hh from L2 every
// step, ran at one SM's share of L2 bandwidth: ~57 us a step, 1.5 ms a
// launch at the CRNN's R=64 (PERF.md).  The least time for the work is
// ~26 us (the f32 operations at the card's peak).
//
// Design: W_hh stays in shared memory for the whole launch, split across
// the CS=8 blocks of a thread-block cluster.  A cluster serves one
// (direction, tile of RT=16 rows); block `rank` owns hidden units
// [rank*U, rank*U+U), U = H/CS, and keeps their 4U rows of W_hh
// (128 KB at H=256) transposed as [k][4U] so neighbouring threads --
// neighbouring units -- read neighbouring words.  A thread owns one unit
// (all four gates, so the cell update needs no exchange) for RPT=4 rows,
// with c in registers.  Each step a block reads the full previous h of the
// tile from its own shared memory, computes its units' new h, and stores
// that slice into the next-step h buffer of every block of the cluster
// (distributed shared memory); one cluster barrier per step publishes it.
// The h buffer is double-buffered, so that barrier is the only one.
// At R=64 this runs 2 x 4 clusters = 64 blocks, one per SM.
// Any H up to 256 whose W_hh slice fits: CS is the largest of 8, 4, 2, 1
// dividing H, and the launch fails (cudaFuncSetAttribute refuses) when a
// block would need more than 227 KB of shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int RT = 16;  // rows per cluster
constexpr int RPT = 4;  // rows per thread
constexpr int RG = RT / RPT;

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(256)
bilstm_fwd_kernel(const float* __restrict__ gates, const float* __restrict__ w_hh,
                  const float* __restrict__ b_hh, float* __restrict__ out,
                  float* __restrict__ cseq, int L, int H, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int U = H / cs;
  const int WS = 4 * U + 1;  // padded row of the transposed slice: no bank conflicts
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                 // [2][H][RT]
  float* w_s = smem + 2 * H * RT;    // [H][WS]

  const int dir = blockIdx.y;
  const int tile = blockIdx.x / cs;
  const int u = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int unit = rank * U + u;
  const int row0 = tile * RT + rg * RPT;
  const int G = 4 * H;

  // this block's 4U rows of W_hh[dir], read along k (coalesced), stored [k][g*U+u]
  const float* w_d = w_hh + (size_t)dir * G * H;
  for (int i = threadIdx.x; i < 4 * U * H; i += blockDim.x) {
    const int gu = i / H, k = i % H;
    const int g = gu / U, uu = gu % U;
    w_s[k * WS + gu] = w_d[(size_t)(g * H + rank * U + uu) * H + k];
  }
  for (int i = threadIdx.x; i < H * RT; i += blockDim.x) h_s[i] = 0.0f;  // h_0 = 0
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = b_hh[dir * G + g * H + unit];
  float c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) c[r] = 0.0f;
  cluster.sync();  // every block of the cluster runs and holds h_0

  for (int s = 0; s < L; ++s) {
    const int t = dir == 0 ? s : L - 1 - s;
    const float* h_cur = h_s + (s & 1) * H * RT;
    float* h_nxt = h_s + ((s + 1) & 1) * H * RT;
    float acc[4][RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r;
      const bool live = row < R;
      const float* gx = gates + (((size_t)dir * R + (live ? row : 0)) * L + t) * G + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][r] = bias[g] + (live ? gx[g * H] : 0.0f);
    }
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(h_cur + k * RT + rg * RPT);
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
    float hn[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float ig = sigm(acc[0][r]);
      const float fg = sigm(acc[1][r]);
      const float gg = tanhf(acc[2][r]);
      const float og = sigm(acc[3][r]);
      c[r] = fg * c[r] + ig * gg;
      hn[r] = og * tanhf(c[r]);
    }
    const float4 h4 = make_float4(hn[0], hn[1], hn[2], hn[3]);
    for (int dst = 0; dst < cs; ++dst) {
      float* remote = cluster.map_shared_rank(h_nxt, dst);
      *reinterpret_cast<float4*>(remote + unit * RT + rg * RPT) = h4;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r;
      if (row < R) {
        const size_t o = ((size_t)row * L + t) * 2 * H + (size_t)dir * H + unit;
        out[o] = hn[r];
        if (cseq != nullptr) cseq[o] = c[r];
      }
    }
    // publishes every block's slice of h_{s+1}; also, no block moves on to
    // overwrite h_cur (step s+1 writes the other buffer, step s+2 this one)
    // before all have read it
    cluster.sync();
  }
}

}  // namespace

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
static int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// Shared-memory bytes of one block for hidden size H and cluster size cs.
static size_t smem_bytes(int H, int cs) {
  const int U = H / cs;
  return sizeof(float) * ((size_t)2 * H * RT + (size_t)H * (4 * U + 1));
}

extern "C" int bilstm_fwd(const float* gates, const float* w_hh, const float* b_hh,
                          float* out, float* cseq, int L, int H, int R, cudaStream_t stream) {
  int cs = 8;
  while (H % cs) cs /= 2;
  const size_t smem = smem_bytes(H, cs);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  e = cudaLaunchKernelEx(&cfg, bilstm_fwd_kernel, gates, w_hh, b_hh, out, cseq, L, H, R);
  if (e != cudaSuccess) return clear_and_return(e);
  return (int)cudaGetLastError();
}

