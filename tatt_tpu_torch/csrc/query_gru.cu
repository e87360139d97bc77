// Recurrence of a bidirectional GRU over one row at hidden sizes above the
// narrow kernels' 128: the TP Interpreter's query GRU (H=512 over L=64
// steps at the default geometry), forward and backward chains.
//
// Replaces no TPU kernel: the JAX package keeps this GRU on lax.scan
// (tatt_tpu/kernels/rnn.py:bigru_apply), and so did the port, as a Python
// loop of 64 steps of about ten launches each, replayed again by autograd
// in the backward.  The card finished each launch in microseconds and
// waited on the host for the next: ~50-100 ms of host time a TATT step.
//
// Computes, for direction d in {0, 1}:
//   gh = W_hh[d] h + b_hh[d];  r = s(x_r + gh_r);  z = s(x_z + gh_z)
//   n  = tanh(x_n + r * gh_n);  h' = (1 - z) n + z h
// with x = gates[d, t] the input projection (computed outside by one
// matmul).  Direction 0 walks t = 0 .. L-1, direction 1 walks t = L-1 .. 0
// and writes each output at its forward-time slot.  The backward chain
// walks each direction's order in reverse:
//   dh = carry + dy_t;  dz = dh (h_prev - n) z (1 - z);  dn = dh (1 - z)(1 - n^2)
//   dr = dn gh_n r (1 - r);  d(gh) = (dr, dz, dn r);  d(gates) = (dr, dz, dn)
//   carry = dh z + W_hh[d]^T d(gh)
// and stores d(gates) and d(gh) of every step; the weight and bias
// gradients (sums over steps of d(gh) h_prev^T and d(gh)) are one matmul
// and one sum in the wrapper, off the chain.
//
// Layouts (contiguous, float32; the row axis R = 1 is dropped):
//   gates [2, L, 3H] (gate order r, z, n),  w_hh [2, 3H, H],  b_hh [2, 3H]
//   out   [L, 2H]    (direction d at channels d*H .. d*H+H-1)
//   gh    [2, L, 3H] (W_hh h_prev + b_hh: the wrapper recomputes it from
//                     out with one matmul, since h_prev is known)
//   hprev [2, L, H]  (the h each step of direction d read: out shifted)
//   dout  [L, 2H],  dgates, dgh [2, L, 3H]
//
// What bounds it on an H100.  Not the bytes (W_hh, 6 MB, read once) nor
// the operations (2 x 64 steps of a 1536 x 512 matvec: 0.2 GFLOP, ~3 us at
// the f32 peak): the chain of L steps, each a matvec that needs the whole
// h of the step before.  One SM cannot hold a direction's W_hh (3 MB); its
// shared memory streams 128 bytes a cycle, so even 3 MB held there would
// take ~12 us a step.  A grid of blocks that meet at a barrier in global
// memory pays an L2 round trip or two (~1-2 us) a step.
//
// Design: one launch, two thread-block clusters of C = 16 blocks (Hopper's
// non-portable largest), one cluster per direction.  Block `rank` keeps
// the 3U rows of W_hh[d] of its U = ceil(H / C) hidden units
// in shared memory for all L steps (192 KB at H=512): a step's 3 MB of
// shared-memory reads are spread over 16 SMs, ~0.8 us each at 128 bytes a
// cycle, and the h exchange and barrier stay inside one GPC.
//   - Forward step: each warp forms whole dot products of its rows with h
//     (16-byte loads, lanes on neighbouring words, a shuffle tree in a
//     fixed order); then U * C threads each update one unit (u, dst) -- the
//     same arithmetic on the same inputs in all C copies -- and store the
//     new h into block dst's next h buffer through distributed shared
//     memory.  h is double-buffered, so one cluster barrier ends a step;
//     the barrier is split around the global store of the output and the
//     next step's gate loads.
//   - Backward step: U threads form d(gh) of their units; one block
//     barrier; thread k forms the block's partial of (W_hh^T d(gh))[k] over
//     its 3U rows (d(gh) read four rows a load) and stores it into the
//     block that owns unit k; the cluster barrier; each unit sums the C
//     partials in rank order into its carry.
//     Partials are double-buffered: one cluster barrier a step.
//   - Every sum runs in a fixed order with no atomics: two launches are
//     bitwise equal.
//   - The plan (units and threads of a block) is made once per (device,
//     H) and checked with the occupancy API: the card must hold one
//     cluster of 16 such blocks at once (it holds 7 at H=512).  An H whose
//     block does not fit shared memory (above ~550) is refused before a
//     launch, as is any R but 1 (the wrapper's check).
//
// No tensor cores and no reduced precision: every product is an f32 FMA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;   // threads of a block
constexpr int kMaxRowsPerWarp = 8;  // dot products a warp forms at once
constexpr int kCluster = 16;        // blocks of a cluster, one cluster a direction

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// The two halves of a cluster barrier: arrive releases this thread's
// earlier stores, distributed shared memory included; wait returns once
// every thread of the cluster arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// W_hh[dir]'s rows of this block's units into shared memory: local row
// q * U + u holds global row q * H + rank * U + u, zero past H (and past
// column H up to kp), so padded units and words add nothing.
__device__ void stage_w(float* w_s, const float* __restrict__ w_hh, int dir, int H, int U,
                        int kp, int rank) {
  const float* w_d = w_hh + (size_t)dir * 3 * H * H;
  for (int i = threadIdx.x; i < 3 * U * kp; i += blockDim.x) {
    const int lr = i / kp, k = i - lr * kp;
    const int q = lr / U, j = rank * U + lr - q * U;
    w_s[i] = (k < H && j < H) ? w_d[(size_t)(q * H + j) * H + k] : 0.0f;
  }
}

// gh_s[row] = w_s[row] . h for the block's 3U rows: warp w forms rows w,
// w + warps, ... up to kMaxRowsPerWarp at a time, sharing each h load.
__device__ __forceinline__ void matvec_rows(const float* w_s, const float* h, float* gh_s,
                                            int rows, int kp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int k4n = kp >> 2;
  const float4* hv = reinterpret_cast<const float4*>(h);
  for (int row0 = warp; row0 < rows; row0 += warps * kMaxRowsPerWarp) {
    float acc[kMaxRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) acc[i] = 0.0f;
    for (int k4 = lane; k4 < k4n; k4 += 32) {
      const float4 b = hv[k4];
#pragma unroll
      for (int i = 0; i < kMaxRowsPerWarp; ++i) {
        const int row = row0 + i * warps;
        if (row < rows) {
          const float4 a = reinterpret_cast<const float4*>(w_s + (size_t)row * kp)[k4];
          acc[i] = fmaf(a.x, b.x, acc[i]);
          acc[i] = fmaf(a.y, b.y, acc[i]);
          acc[i] = fmaf(a.z, b.z, acc[i]);
          acc[i] = fmaf(a.w, b.w, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      float v = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int row = row0 + i * warps;
      if (lane == 0 && row < rows) gh_s[row] = v;
    }
  }
}

// The forward chain.  Grid (C, 2), clusters of C blocks along x: block
// `rank` = blockIdx.x of direction blockIdx.y owns units [rank*U, rank*U+U).
__global__ void __launch_bounds__(kMaxThreads)
query_gru_fwd_chain(const float* __restrict__ gates, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, float* __restrict__ out, int L, int H,
                    int U, int kp) {
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, rank = blockIdx.x, dir = blockIdx.y;
  const int G = 3 * H, rows = 3 * U;
  float* w_s = smem;              // [3U][kp]
  float* h_s = w_s + rows * kp;   // [2][kp]: h of the step before, h being formed
  float* gh_s = h_s + 2 * kp;     // [3U]
  stage_w(w_s, w_hh, dir, H, U, kp, rank);
  for (int i = threadIdx.x; i < 2 * kp; i += blockDim.x) h_s[i] = 0.0f;

  // this thread's unit u and the block dst it sends h to; the copy with
  // dst == rank also writes the output
  const int u = threadIdx.x % U, dst = threadIdx.x / U, j = rank * U + u;
  const bool unit = dst < C && j < H;
  const bool writer = unit && dst == rank;
  float* h_dst = unit ? cg::this_cluster().map_shared_rank(h_s, dst) : nullptr;
  float br = 0.0f, bz = 0.0f, bn = 0.0f, xr = 0.0f, xz = 0.0f, xn = 0.0f;
  const float* g_d = gates + (size_t)dir * L * G;
  const auto load_x = [&](int s) {
    const float* x = g_d + (size_t)(dir == 0 ? s : L - 1 - s) * G + j;
    xr = x[0];
    xz = x[H];
    xn = x[2 * H];
  };
  if (unit) {
    br = b_hh[dir * G + j];
    bz = b_hh[dir * G + H + j];
    bn = b_hh[dir * G + 2 * H + j];
    load_x(0);
  }
  // every block's h buffers are zero before any block stores into them
  cluster_arrive();
  cluster_wait();

  for (int s = 0; s < L; ++s) {
    const float* h_cur = h_s + (s & 1) * kp;
    matvec_rows(w_s, h_cur, gh_s, rows, kp);
    __syncthreads();
    float h = 0.0f;
    if (unit) {
      const float r = sigm(xr + gh_s[u] + br);
      const float z = sigm(xz + gh_s[U + u] + bz);
      const float n = tanhf(xn + r * (gh_s[2 * U + u] + bn));
      h = (1.0f - z) * n + z * h_cur[j];
      h_dst[((s + 1) & 1) * kp + j] = h;
    }
    cluster_arrive();
    if (writer) out[(size_t)(dir == 0 ? s : L - 1 - s) * 2 * H + dir * H + j] = h;
    if (unit && s + 1 < L) load_x(s + 1);
    cluster_wait();
  }
}

// The backward chain, on the forward's grid and clusters.  gh and hprev as
// the header says; thread u < U carries unit rank * U + u.
__global__ void __launch_bounds__(kMaxThreads)
query_gru_bwd_chain(const float* __restrict__ gates, const float* __restrict__ w_hh,
                    const float* __restrict__ gh, const float* __restrict__ hprev,
                    const float* __restrict__ dout, float* __restrict__ dgates,
                    float* __restrict__ dgh, int L, int H, int U, int kp) {
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, rank = blockIdx.x, dir = blockIdx.y;
  const int G = 3 * H, rows = 3 * U;
  float* w_s = smem;              // [3U][kp]
  float* dg_s = w_s + rows * kp;  // [3U]: d(gh) of the block's rows this step
  float* part = dg_s + rows;      // [2][C][U]: partials from each rank
  stage_w(w_s, w_hh, dir, H, U, kp, rank);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) dg_s[i] = 0.0f;  // padded units stay 0

  const int u = threadIdx.x, j = rank * U + u;
  const bool unit = u < U && j < H;
  // a step's inputs, loaded a step ahead
  float xr = 0.0f, xz = 0.0f, xn = 0.0f, gr = 0.0f, gz = 0.0f, gn = 0.0f, hp = 0.0f, dy = 0.0f;
  const auto load = [&](int s) {
    const int t = dir == 0 ? s : L - 1 - s;
    const size_t o = ((size_t)dir * L + t) * G + j;
    xr = gates[o];
    xz = gates[o + H];
    xn = gates[o + 2 * H];
    gr = gh[o];
    gz = gh[o + H];
    gn = gh[o + 2 * H];
    hp = hprev[((size_t)dir * L + t) * H + j];
    dy = dout[(size_t)t * 2 * H + dir * H + j];
  };
  if (unit) load(L - 1);
  float carry = 0.0f;
  // every block is running before any stores a partial into it
  cluster_arrive();
  cluster_wait();

  for (int s = L - 1; s >= 0; --s) {
    const int buf = s & 1;
    float keep = 0.0f;
    if (unit) {
      const float r = sigm(xr + gr), z = sigm(xz + gz), n = tanhf(xn + r * gn);
      const float dh = carry + dy;
      const float dz = dh * (hp - n) * z * (1.0f - z);
      const float dn = dh * (1.0f - z) * (1.0f - n * n);
      const float dr = dn * gn * r * (1.0f - r);
      keep = dh * z;
      const size_t o = ((size_t)dir * L + (dir == 0 ? s : L - 1 - s)) * G + j;
      dgates[o] = dr;
      dgates[o + H] = dz;
      dgates[o + 2 * H] = dn;
      dgh[o] = dr;
      dgh[o + H] = dz;
      dgh[o + 2 * H] = dn * r;
      dg_s[u] = dr;
      dg_s[U + u] = dz;
      dg_s[2 * U + u] = dn * r;
      if (s > 0) load(s - 1);
    }
    __syncthreads();
    // the block's partial of (W_hh^T d(gh))[k], into rank k / U's buffer
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
      const float* w = w_s + k;
      float acc = 0.0f;
      int row = 0;
      for (; row + 4 <= rows; row += 4) {
        const float4 d = *reinterpret_cast<const float4*>(dg_s + row);
        acc = fmaf(w[(size_t)row * kp], d.x, acc);
        acc = fmaf(w[(size_t)(row + 1) * kp], d.y, acc);
        acc = fmaf(w[(size_t)(row + 2) * kp], d.z, acc);
        acc = fmaf(w[(size_t)(row + 3) * kp], d.w, acc);
      }
      for (; row < rows; ++row) acc = fmaf(w[(size_t)row * kp], dg_s[row], acc);
      const int owner = k / U;
      float* p = cg::this_cluster().map_shared_rank(part, owner);
      p[(buf * C + rank) * U + (k - owner * U)] = acc;
    }
    cluster_arrive();
    cluster_wait();
    if (unit) {
      float sum = 0.0f;
      for (int src = 0; src < C; ++src) sum += part[(buf * C + src) * U + u];
      carry = keep + sum;
    }
  }
}

// The launch of hidden size H: units and threads of a block, W_hh's row
// stride in shared memory, each chain's shared memory and clusters the card
// holds at once (cluster 0 marks a refused H).
struct Plan {
  int cluster, units, threads, kp;
  size_t fwd_smem, bwd_smem;
  int fwd_clusters, bwd_clusters;
};

Plan shape_of(int H) {
  Plan p{};
  p.cluster = kCluster;
  p.units = (H + kCluster - 1) / kCluster;
  p.threads = (p.units * kCluster + 31) / 32 * 32;
  p.kp = (H + 3) & ~3;
  const size_t w = (size_t)3 * p.units * p.kp;
  p.fwd_smem = sizeof(float) * (w + 2 * (size_t)p.kp + 3 * p.units);
  p.bwd_smem = sizeof(float) * (w + 3 * (size_t)p.units + 2 * (size_t)kCluster * p.units);
  return p;
}

cudaLaunchConfig_t launch_config(const Plan& p, size_t smem, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, 2);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// `kernel`'s attributes for a block of `smem` bytes in clusters of up to
// 16.  Set before every launch: the shared-memory size is the kernel's,
// not the launch's, and another H's plan may have set it since.
template <typename K>
cudaError_t set_attributes(K kernel, size_t smem) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Clusters of plan p that the card holds at once for `kernel`.
template <typename K>
int active_clusters(K kernel, const Plan& p, size_t smem, cudaError_t* e) {
  *e = set_attributes(kernel, smem);
  int n = 0;
  if (*e != cudaSuccess) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, smem, &attr);
  *e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return n;
}

// The plan for H when its blocks fit the thread limit and shared memory
// and the card holds a cluster of them at once for both chains.  False
// (and *e cudaSuccess) when not.
bool make_plan(int H, int device, Plan* out, cudaError_t* e) {
  int smem_max = 0;
  *e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (*e != cudaSuccess) return false;
  Plan p = shape_of(H);
  if (H < kCluster || p.threads > kMaxThreads || p.fwd_smem > (size_t)smem_max ||
      p.bwd_smem > (size_t)smem_max)
    return false;
  p.fwd_clusters = active_clusters(query_gru_fwd_chain, p, p.fwd_smem, e);
  if (*e != cudaSuccess) return false;
  p.bwd_clusters = active_clusters(query_gru_bwd_chain, p, p.bwd_smem, e);
  if (*e != cudaSuccess || p.fwd_clusters < 1 || p.bwd_clusters < 1) return false;
  *out = p;
  return true;
}

std::mutex plans_mu;
std::map<std::pair<int, int>, Plan> plans;

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// Returned, before any launch, for an H that no plan serves.
constexpr int kNoFit = -1;

// The plan for hidden size H on the current device, made once; a refusal
// is kept too (cluster 0), so a refused H costs no query on later calls.
int plan_of(int H, Plan* p) {
  if (H < 1) return kNoFit;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return clear_and_return(e);
  std::lock_guard<std::mutex> lock(plans_mu);
  const auto key = std::make_pair(device, H);
  auto it = plans.find(key);
  if (it == plans.end()) {
    Plan made{};
    if (!make_plan(H, device, &made, &e) && e != cudaSuccess) return clear_and_return(e);
    it = plans.emplace(key, made).first;
  }
  *p = it->second;
  return p->cluster == 0 ? kNoFit : 0;
}

}  // namespace

extern "C" int query_gru_fwd(const float* gates, const float* w_hh, const float* b_hh,
                             float* out, int L, int H, cudaStream_t stream) {
  Plan p;
  const int err = plan_of(H, &p);
  if (err != 0) return err;  // before any launch
  cudaError_t e = set_attributes(query_gru_fwd_chain, p.fwd_smem);
  if (e != cudaSuccess) return clear_and_return(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(p, p.fwd_smem, &attr);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, query_gru_fwd_chain, gates, w_hh, b_hh, out, L, H, p.units, p.kp);
  if (e != cudaSuccess) return clear_and_return(e);
  return (int)cudaGetLastError();
}

extern "C" int query_gru_bwd(const float* gates, const float* w_hh, const float* gh,
                             const float* hprev, const float* dout, float* dgates, float* dgh,
                             int L, int H, cudaStream_t stream) {
  Plan p;
  const int err = plan_of(H, &p);
  if (err != 0) return err;
  cudaError_t e = set_attributes(query_gru_bwd_chain, p.bwd_smem);
  if (e != cudaSuccess) return clear_and_return(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(p, p.bwd_smem, &attr);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, query_gru_bwd_chain, gates, w_hh, gh, hprev, dout, dgates, dgh,
                         L, H, p.units, p.kp);
  if (e != cudaSuccess) return clear_and_return(e);
  return (int)cudaGetLastError();
}

// The launch for hidden size H, for logs: plan[0..6] = blocks of a
// cluster, hidden units and threads of a block, each chain's shared-memory
// bytes of a block, and clusters of each chain the card holds at once.
// Launches nothing; returns -1 for an H that no plan serves.
extern "C" int query_gru_plan(int H, int* plan) {
  Plan p;
  const int err = plan_of(H, &p);
  if (err != 0) return err;
  const int values[7] = {p.cluster, p.units, p.threads, (int)p.fwd_smem, (int)p.bwd_smem,
                         p.fwd_clusters, p.bwd_clusters};
  for (int i = 0; i < 7; ++i) plan[i] = values[i];
  return 0;
}
