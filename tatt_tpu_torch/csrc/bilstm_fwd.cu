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
// When `cseq` is not null every c is also stored, in the `out` layout, for
// the backward pass (csrc/bilstm_bwd.cu), as the JAX kernel stores it
// (pallas_lstm.py:50).  Inference passes null and writes no extra bytes.
//
// Layouts (contiguous; float32, or bfloat16 in the bf16 instantiation):
//   gates [2, R, L, 4H]   (gates minor: the matmul x @ W_ih^T writes this
//                          layout directly, with no transpose)
//   w_hh  [2, 4H, H],  b_hh [2, 4H]
//   out   [R, L, 2H]      (the public BiLSTM layout; direction d at
//                          channels d*H .. d*H+H-1)
//   cseq  [R, L, 2H] or null
// The bf16 instantiation (entry bilstm_fwd_bf16) is the TPU kernel under
// --dtype bfloat16: bf16 gates, W_hh and b_hh widened to f32 as they are
// loaded (W_hh stays f32 in shared memory, so the plans are the f32
// kernel's), the h and c carries and every sum in f32, h and c stored
// rounded to bf16.
//
// What bounds it.  The recurrence is serial in t: each step needs the whole
// previous h of its rows.  Its least time by bytes or by operations (the
// f32 products at the card's peak, ~1 us a step at H=256 over 64 rows) does
// not count the latency of the chain each step pays: shared-memory loads,
// a block barrier, the exchange of h between blocks and their barrier.
// A design for this card therefore keeps W_hh on chip, spreads one step's
// products over as many warps and SMs as can run at once, and keeps every
// global access off that chain.
//
// Design.  W_hh stays in shared memory for the whole launch.  A cluster of
// cs blocks serves one (direction, tile of RT rows); block `rank` owns the
// hidden units [rank*U, rank*U+U), U = H/cs, and keeps their 4U rows of
// W_hh as [k][U][4 gates], so that one 16-byte load gives a thread the four
// gates of its unit.  Each step:
//   1. every thread (k group, unit) forms the 4 x RT partial sums of
//      W_hh h over its slice of k, for all rows of the tile, so each word
//      of W_hh is read once a step;
//   2. the partials go through shared memory, one __syncthreads, and one
//      thread per (unit, row) sums them in a fixed k-group order (the
//      result does not depend on timing), adds x and the bias, and updates
//      c (in a register) and h;
//   3. h goes into the next-step h buffer of every block of the cluster
//      (distributed shared memory), and one cluster barrier publishes it.
// The h buffer is double-buffered, so that barrier is the only one across
// blocks.  What each part of the design does about the chain:
//   - cs is the smallest of 1, 2, 4, 8 that divides H and whose block fits
//     shared memory: at H <= ~100 (cs = 1) a plain block exchanges h in its
//     own shared memory with no cluster barrier; H=256 needs cs = 8.  An H
//     that no cs serves (H=250) is refused before any launch.
//   - RT (4, 8, 12 or 16) is the fewest rows with which all 2 * ceil(R / RT)
//     clusters are resident at once, by the occupancy API: at H=256 the
//     card holds 15 clusters of 8 such blocks, so 8-row tiles (16 clusters
//     at R=64) ran in two waves and 12-row tiles run in one.
//   - k groups (up to 16, at least RT) give a block 12-16 warps, which hide
//     one another's shared-memory latency, where one thread walking all of
//     k left one or four warps on an SM.
//   - x is loaded before the step's products and used after them.
//   - In a cluster the barrier is split: the stores of out and c, which no
//     block waits on, go between its arrive and its wait.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2, L=26,
// R=64): H=256 0.137 ms a launch, 4.9 us a step after 13.6 us of set-up
// (loading W_hh) and the first step; H=64 0.043-0.045 ms, 1.5-1.6 us a step.
// The design before this one (one thread per unit over all of k, 16-row
// tiles, cs = 8 at any H) took 0.342 and 0.117 ms.
//
// No tensor cores and no reduced precision: every product is an f32 FMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kMaxKGroups = 16;
constexpr int kMaxRows = 16;  // rows per cluster

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

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

// The two halves of a cluster barrier (cg's cluster.sync() is both back to
// back): arrive releases this thread's earlier stores, distributed shared
// memory included; wait returns once every thread of the cluster arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// RT rows per cluster, each thread's products cover all of them;
// kCluster: cs > 1 blocks share h through distributed shared memory.
template <typename T, int RT, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
bilstm_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ w_hh,
                  const T* __restrict__ b_hh, T* __restrict__ out,
                  T* __restrict__ cseq, int L, int H, int R, int kg) {
  const int cs = kCluster ? (int)cg::this_cluster().num_blocks() : 1;
  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int U = H / cs;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                        // [H][U][4]
  float* h_s = w_s + (size_t)H * 4 * U;     // [2][H][RT]
  float* red = h_s + 2 * H * RT;            // [kg][4][U][RT]

  const int dir = blockIdx.y;
  const int tile = blockIdx.x / cs;

  // this block's 4U rows of W_hh[dir] as [k][u][g]: a thread reads 16 bytes
  // of one row along k and writes four neighbours' words (no bank conflict)
  const T* w_d = w_hh + (size_t)dir * G * H;
  if ((H & 3) == 0) {
#pragma unroll 4
    for (int i = tid; i < U * H; i += blockDim.x) {  // (k4, u, g), g fastest
      const int gu = i % (4 * U), k = 4 * (i / (4 * U));
      const float4 v = load4(w_d + (size_t)((gu & 3) * H + rank * U + (gu >> 2)) * H + k);
      float* dst = w_s + (size_t)k * 4 * U + gu;
      dst[0] = v.x;
      dst[4 * U] = v.y;
      dst[8 * U] = v.z;
      dst[12 * U] = v.w;
    }
  } else {
    for (int i = tid; i < 4 * U * H; i += blockDim.x) {
      const int gu = i % (4 * U), k = i / (4 * U);
      w_s[(size_t)k * 4 * U + gu] =
          to_f(w_d[(size_t)((gu & 3) * H + rank * U + (gu >> 2)) * H + k]);
    }
  }
  for (int i = tid; i < H * RT; i += blockDim.x) h_s[i] = 0.0f;  // h_0 = 0

  // part 1's thread: unit u, all RT rows, k in [k0, k1)
  const int u = tid % U;
  const int kgi = tid / U;
  const int kr = (H + kg - 1) / kg;
  const int k0 = min(H, kgi * kr), k1 = min(H, k0 + kr);
  // part 2's thread: one (unit fu, row frt) pair, fu-major so that a warp's
  // h stores land on neighbouring words
  const bool fin = tid < U * RT;
  const int fu = tid / RT, frt = tid % RT;
  const int funit = rank * U + fu;
  const int row = tile * RT + frt;
  const bool live = fin && row < R;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = fin ? to_f(b_hh[dir * G + g * H + funit]) : 0.0f;
  float c = 0.0f;
  if constexpr (kCluster) cg::this_cluster().sync();  // every block runs and holds h_0
  else __syncthreads();

  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  for (int s = 0; s < L; ++s) {
    const int t = dir == 0 ? s : L - 1 - s;
    const float* h_cur = h_s + (s & 1) * H * RT;
    float* h_nxt = h_s + ((s + 1) & 1) * H * RT;

    // this step's input projection: issued now, used after the products
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      const T* gx = gates + (((size_t)dir * R + row) * L + t) * G + funit;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[g] = to_f(gx[g * H]);
    }

    // 1. partial products over this thread's k slice
    float acc[4][RT];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[g][r] = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 w = w4[k * U + u];
      const float* hk = h_cur + k * RT;
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {
        const float4 hv = *reinterpret_cast<const float4*>(hk + 4 * q);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][4 * q + j] = fmaf(w.x, hr[j], acc[0][4 * q + j]);
          acc[1][4 * q + j] = fmaf(w.y, hr[j], acc[1][4 * q + j]);
          acc[2][4 * q + j] = fmaf(w.z, hr[j], acc[2][4 * q + j]);
          acc[3][4 * q + j] = fmaf(w.w, hr[j], acc[3][4 * q + j]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < RT / 4; ++q)
        *reinterpret_cast<float4*>(red + ((size_t)(kgi * 4 + g) * U + u) * RT + 4 * q) =
            make_float4(acc[g][4 * q], acc[g][4 * q + 1], acc[g][4 * q + 2], acc[g][4 * q + 3]);
    __syncthreads();

    // 2. one thread per (unit, row): sum the partials in k-group order
    float hn = 0.0f;
    if (fin) {
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        a[g] = x[g] + bias[g];
        for (int j = 0; j < kg; ++j) a[g] += red[(size_t)(j * 4 + g) * U * RT + tid];
      }
      c = sigm(a[1]) * c + sigm(a[0]) * tanhf(a[2]);
      hn = sigm(a[3]) * tanhf(c);
      // 3. h into every block's next-step buffer
      if constexpr (kCluster) {
        for (int dst = 0; dst < cs; ++dst)
          cg::this_cluster().map_shared_rank(h_nxt, dst)[funit * RT + frt] = hn;
      } else {
        h_nxt[funit * RT + frt] = hn;
      }
    }
    // 4. the barrier that publishes every block's slice of h_{s+1}; also, no
    // block moves on to overwrite h_cur (step s+1 writes the other buffer,
    // step s+2 this one) or the partials before all have read them.  In a
    // cluster it is split: the stores of out and c, which no block waits
    // on, go between its arrive and its wait.
    if constexpr (kCluster) cluster_arrive();
    if (live) {
      const size_t o = ((size_t)row * L + t) * 2 * H + (size_t)dir * H + funit;
      out[o] = from_f<T>(hn);
      if (cseq != nullptr) cseq[o] = from_f<T>(c);
    }
    if constexpr (kCluster) cluster_wait();
    else __syncthreads();
  }
}

// A refused call also sets the runtime's last error; clear it so that the
// next launch's cudaGetLastError() reports only its own.
int clear_and_return(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// Returned, before any launch, for an H that no cluster size serves.
constexpr int kNoFit = -1;

struct Plan {
  int cs, rt, kg;
  size_t smem;
};

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, T*, int, int, int, int);

template <typename T>
Kernel<T> kernel_of(const Plan& p) {
  switch (p.rt) {
    case 4: return p.cs > 1 ? bilstm_fwd_kernel<T, 4, true> : bilstm_fwd_kernel<T, 4, false>;
    case 8: return p.cs > 1 ? bilstm_fwd_kernel<T, 8, true> : bilstm_fwd_kernel<T, 8, false>;
    case 12: return p.cs > 1 ? bilstm_fwd_kernel<T, 12, true> : bilstm_fwd_kernel<T, 12, false>;
    default: return p.cs > 1 ? bilstm_fwd_kernel<T, 16, true> : bilstm_fwd_kernel<T, 16, false>;
  }
}

int threads_of(const Plan& p, int H) { return p.kg * (H / p.cs); }

// Shared-memory bytes of one block: W_hh slice, two h buffers, partials.
size_t smem_bytes(int H, int U, int rt, int kg) {
  return sizeof(float) * ((size_t)H * 4 * U + (size_t)2 * H * rt + (size_t)kg * 4 * U * rt);
}

// The block for cluster size cs and rt rows: the most k groups (up to 16)
// that fit its threads and shared memory, and at least rt, so that every
// (unit, row) has a thread of its own to update it.  False when none fits.
bool block_plan(int H, int cs, int rt, Plan* p) {
  const int U = H / cs;
  int kg = std::min(kMaxKGroups, kMaxThreads / U);
  while (kg > rt && smem_bytes(H, U, rt, kg) > kMaxSmem) kg = std::max(rt, kg / 2);
  if (kg < rt || smem_bytes(H, U, rt, kg) > kMaxSmem) return false;
  *p = Plan{cs, rt, kg, smem_bytes(H, U, rt, kg)};
  return true;
}

// The launch of plan p on `grid` blocks; `attr` holds the cluster
// attribute that the config points to (none for cs = 1).
cudaLaunchConfig_t launch_config(const Plan& p, int H, dim3 grid, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads_of(p, H));
  cfg.dynamicSmemBytes = p.smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1 ? 1 : 0;
  return cfg;
}

// Clusters of plan p that the card runs at once.
template <typename T>
int resident_clusters(const Plan& p, int H, int device, cudaError_t* e) {
  const Kernel<T> kernel = kernel_of<T>(p);
  *e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (*e != cudaSuccess) return 0;
  int n = 0;
  if (p.cs == 1) {
    int sms = 0;
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (*e == cudaSuccess)
      *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads_of(p, H), p.smem);
    return n * sms;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(p, H, dim3(p.cs), &attr);
  *e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return n;
}

// The launch for hidden size H and R rows.  cs: the smallest cluster size
// that divides H and whose block fits.  rt: the fewest rows per cluster (4,
// 8, 12 or 16) with which all 2 * ceil(R / rt) clusters run at once, or
// else the most that fit.  False (and *e unset) when no cluster size fits.
template <typename T>
bool make_plan(int H, int R, int device, Plan* out, cudaError_t* e) {
  *e = cudaSuccess;
  for (int cs = 1; cs <= 8; cs *= 2) {
    if (H % cs != 0) continue;
    bool found = false;
    for (int rt = 4; rt <= kMaxRows; rt += 4) {
      Plan p;
      if (!block_plan(H, cs, rt, &p)) break;  // more rows need more threads and memory
      *out = p;
      found = true;
      const int resident = resident_clusters<T>(p, H, device, e);
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

template <typename T>
int launch(const T* gates, const T* w_hh, const T* b_hh, T* out, T* cseq, int L, int H, int R,
           cudaStream_t stream) {
  Plan p;
  int device = 0;
  const int err = plan_of<T>(H, R, &p, &device);
  if (err != 0) return err;  // before any launch
  const Kernel<T> kernel = kernel_of<T>(p);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return clear_and_return(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(p, H, dim3(p.cs * ((R + p.rt - 1) / p.rt), 2), &attr);
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, kernel, gates, w_hh, b_hh, out, cseq, L, H, R, p.kg);
  if (e != cudaSuccess) return clear_and_return(e);
  return (int)cudaGetLastError();
}

template <typename T>
int plan_query(int H, int R, int* plan) {
  Plan p;
  int device = 0;
  const int err = plan_of<T>(H, R, &p, &device);
  if (err != 0) return err;
  cudaError_t e;
  const int resident = resident_clusters<T>(p, H, device, &e);
  if (e != cudaSuccess) return clear_and_return(e);
  const int values[6] = {p.cs, p.rt, p.kg, threads_of(p, H), (int)p.smem, resident};
  for (int i = 0; i < 6; ++i) plan[i] = values[i];
  return 0;
}

}  // namespace

extern "C" int bilstm_fwd(const float* gates, const float* w_hh, const float* b_hh,
                          float* out, float* cseq, int L, int H, int R, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, cseq, L, H, R, stream);
}

extern "C" int bilstm_fwd_bf16(const __nv_bfloat16* gates, const __nv_bfloat16* w_hh,
                               const __nv_bfloat16* b_hh, __nv_bfloat16* out,
                               __nv_bfloat16* cseq, int L, int H, int R, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, cseq, L, H, R, stream);
}

// The launch for hidden size H and R rows, for logs: plan[0..5] = cluster
// size, rows per cluster, k groups, threads and shared-memory bytes of a
// block, clusters the card runs at once.  Launches nothing.
extern "C" int bilstm_fwd_plan(int H, int R, int* plan) { return plan_query<float>(H, R, plan); }

extern "C" int bilstm_fwd_bf16_plan(int H, int R, int* plan) {
  return plan_query<__nv_bfloat16>(H, R, plan);
}
