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
// Layouts (contiguous; float32, or bfloat16 in the bf16 instantiation):
//   gates [2, L, 3H, R]   (rows minor, gate order r, z, n)
//   w_hh  [2, 3H, H],  b_hh [2, 3H]
//   out   [L, 2H, R]      (direction d at channels d*H .. d*H+H-1)
// The bf16 instantiation (entry bigru_fwd_bf16) is the TPU kernel under
// --dtype bfloat16: bf16 gates, W_hh and b_hh converted to f32 as they are
// loaded (W_hh stays f32 in shared memory, so the plans are the f32
// kernel's), the h carry and every sum in f32, h stored rounded to bf16.
//
// What bounds it on an H100.  Not the bytes (gates in, h out: 0.040 ms at
// HBM rate at gru1 and gru2 of the fused 2B=128 batch, H=32) nor the f32
// FMAs (3H x H a row-step, 0.026 ms at gru1): the serial chain of L steps,
// each a matvec per row from shared memory, the gate nonlinearity (accurate
// expf, division and tanhf: about a third of a step) and a barrier.  Where
// rows are many (gru1) a step waits on how fast shared memory hands words
// to the lanes: a warp-wide 16-byte load hands them 512 bytes, four cycles
// of the SM's 128 bytes a cycle, broadcast or not; where rows are few
// (gru2) it waits on each thread's own chain.
//
// Design: one block per (tile of rows, direction) walks all L steps with
// W_hh[d] in shared memory (Hopper's blocks run in no order, so the carry
// cannot live across blocks the way the TPU grid carries it in VMEM).
//   - A thread owns JT hidden units of RT rows; a warp's lanes walk
//     neighbouring rows, so gate loads and output stores are coalesced, and
//     each 16-byte W_hh load from shared memory feeds RT rows.
//   - The plan (units and rows a thread, rows a block) comes from the
//     occupancy API, per (device, H, R), cached: the fewest waves, every SM
//     busy, two warps a scheduler, then the fewest shared-memory loads an
//     FMA.  At H=32: 2 units x 4 rows at gru1 (R=8192), 2 x 2 at the eval
//     batch's gru1, 2 x 1 at both gru2 row counts.
//   - A step's gate inputs are loaded into registers a step ahead, as soon
//     as the step before has used its own; W_hh and b_hh are staged by
//     cp.async with every copy in flight.  h lives in one shared buffer,
//     float4-packed along the hidden axis, behind two barriers a step: a
//     double buffer with one barrier measured slower at gru2 (its 2 x 1
//     kernel spilled a register that it reloaded every step).
//   - The ragged last tile is masked (rows >= R load zeros, store nothing).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2, H=32):
// 0.0958 / 0.1285 ms a launch at gru1 (L=16, R=8192) / gru2 (L=64, R=2048)
// of the fused training batch, 0.0575 / 0.0930 ms at the eval batch's
// (R=4096 / 1024); the design before took 0.1245 / 0.2216 / 0.0822 /
// 0.2220 ms in the same run.
//
// No tensor cores and no reduced precision: every product is an f32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;  // threads of a block
constexpr int kWarpsPerSm = 8;    // warps an SM that the plan still counts

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// a 4-byte asynchronous copy from global to shared memory, and the wait for
// all of this thread's copies to land
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
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
// one element into shared memory as f32: an asynchronous copy for f32, a
// load and a conversion for bf16
__device__ __forceinline__ void stage1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void stage1(float* dst, const __nv_bfloat16* src) { *dst = to_f(*src); }

// One block per (tile of RB rows, direction).  A thread owns JT hidden
// units (JT = 2 or 4) of RT rows (RT = 1, 2 or 4): Q = ceil(H / JT) unit
// groups times P row groups, RB = P * RT, thread (q, p) = threadIdx.x / P,
// % P; its rows are blockIdx.x * RB + i * P + p (i < RT), so a warp's lanes
// walk neighbouring rows.  kp: the row stride of W_hh in shared memory (a
// multiple of 4, at least H4).
template <typename T, int JT, int RT>
__global__ void __launch_bounds__(kMaxThreads)
bigru_fwd_kernel(const T* __restrict__ gates, const T* __restrict__ w_hh,
                 const T* __restrict__ b_hh, T* __restrict__ out,
                 int L, int H, int R, int kp) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = (H + 3) & ~3;  // hidden axis padded to a float4 multiple
  const int G = 3 * H;
  const int Q = (H + JT - 1) / JT;
  const int P = blockDim.x / Q;
  const int RB = P * RT;
  float* w_s = smem;           // [3H][kp]: W_hh[d] rows, zero-padded along k
  float* h_s = w_s + G * kp;   // [H4/4][RT][P][4]: h[k][row] packed by 4 k's
  float* b_s = h_s + H4 * RB;  // [3H]

  const int dir = blockIdx.y;
  const int q = threadIdx.x / P, p = threadIdx.x % P;
  const int row0 = blockIdx.x * RB + p;  // the thread's row i is row0 + i * P
  const size_t RS = (size_t)R;

  // W_hh[d] and b_hh[d] by asynchronous copies, all in flight at once;
  // element i = g * kp + k of w_s, (g, k) advanced without a division
  const T* w_d = w_hh + (size_t)dir * G * H;
  {
    int g = threadIdx.x / kp, k = threadIdx.x - g * kp;
    const int sg = blockDim.x / kp, sk = blockDim.x - sg * kp;
    for (int i = threadIdx.x; i < G * kp; i += blockDim.x) {
      if (k < H) stage1(w_s + i, w_d + g * H + k);
      else w_s[i] = 0.0f;
      g += sg;
      k += sk;
      if (k >= kp) {
        k -= kp;
        ++g;
      }
    }
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) stage1(b_s + i, b_hh + dir * G + i);
  for (int i = threadIdx.x; i < H4 * RB; i += blockDim.x) h_s[i] = 0.0f;  // h before step 0

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
  for (int i = 0; i < RT; ++i) rv[i] = row0 + i * P < R;

  // the gate inputs of step s into registers
  float xr[JT][RT], xz[JT][RT], xn[JT][RT];
  const auto load_x = [&](int s) {
    const int t = dir == 0 ? s : L - 1 - s;
    const T* gx = gates + (size_t)(dir * L + t) * G * RS + row0;
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      const size_t j = (size_t)jc[u];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const bool ok = jv[u] && rv[i];
        const size_t o = j * RS + (size_t)i * P;
        xr[u][i] = ok ? to_f(gx[o]) : 0.0f;
        xz[u][i] = ok ? to_f(gx[o + (size_t)H * RS]) : 0.0f;
        xn[u][i] = ok ? to_f(gx[o + (size_t)2 * H * RS]) : 0.0f;
      }
    }
  };
  float h_own[JT][RT];
#pragma unroll
  for (int u = 0; u < JT; ++u)
#pragma unroll
    for (int i = 0; i < RT; ++i) h_own[u][i] = 0.0f;

  load_x(0);
  cp_async_wait_all();
  __syncthreads();  // W_hh, b_hh and the zero h are in place

  for (int s = 0; s < L; ++s) {
    const int t = dir == 0 ? s : L - 1 - s;
    float ar[JT][RT], az[JT][RT], an[JT][RT];
#pragma unroll
    for (int u = 0; u < JT; ++u) {
      const float br = b_s[jc[u]], bz = b_s[H + jc[u]], bn = b_s[2 * H + jc[u]];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        ar[u][i] = br;
        az[u][i] = bz;
        an[u][i] = bn;
      }
    }
    for (int k4 = 0; k4 < H4; k4 += 4) {
      float4 hv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        hv[i] = *reinterpret_cast<const float4*>(h_s + ((k4 >> 2) * RT + i) * P * 4 + p * 4);
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
    // the new h; units past H hold zeros, so the padded words of h_s stay 0
#pragma unroll
    for (int u = 0; u < JT; ++u)
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float r = sigm(xr[u][i] + ar[u][i]);
        const float z = sigm(xz[u][i] + az[u][i]);
        const float n = tanhf(xn[u][i] + r * an[u][i]);
        h_own[u][i] = jv[u] ? (1.0f - z) * n + z * h_own[u][i] : 0.0f;
      }
    // the next step's gate inputs: they land during the stores, the
    // barriers and the next step's products
    if (s + 1 < L) load_x(s + 1);
    __syncthreads();  // every thread has read the h of the step before
    // h, 16 (JT = 4) or 8 bytes a store; only words below H4 exist
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* hrow = h_s + i * P * 4 + p * 4;
      if constexpr (JT == 4) {
#pragma unroll
        for (int v = 0; v < JT; v += 4) {
          const int j4 = q * JT + v;
          if (j4 < H4)
            *reinterpret_cast<float4*>(hrow + (j4 >> 2) * RT * P * 4) =
                make_float4(h_own[v][i], h_own[v + 1][i], h_own[v + 2][i], h_own[v + 3][i]);
        }
      } else {
        const int j2 = q * JT;
        if (j2 < H4)
          *reinterpret_cast<float2*>(hrow + (j2 >> 2) * RT * P * 4 + (j2 & 3)) =
              make_float2(h_own[0][i], h_own[1][i]);
      }
    }
    T* o = out + ((size_t)t * 2 * H + (size_t)dir * H) * RS + row0;
#pragma unroll
    for (int u = 0; u < JT; ++u)
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (jv[u] && rv[i]) o[(size_t)jc[u] * RS + (size_t)i * P] = from_f<T>(h_own[u][i]);
    __syncthreads();  // this step's h is complete
  }
}

// The launch: units and rows a thread, rows, threads and shared memory of a
// block, W_hh's row stride in shared memory.
struct Plan {
  int jt, rt, rows, threads, kp;
  size_t smem;
};

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, int, int, int, int);

// (units, rows) a thread that a plan may take
constexpr int kShapes[4][2] = {{2, 4}, {4, 2}, {2, 2}, {2, 1}};

template <typename T>
FwdKernel<T> kernel_of(const Plan& p) {
  if (p.jt == 4) return bigru_fwd_kernel<T, 4, 2>;
  return p.rt == 4 ? bigru_fwd_kernel<T, 2, 4> : p.rt == 2 ? bigru_fwd_kernel<T, 2, 2>
                                                           : bigru_fwd_kernel<T, 2, 1>;
}

// shared memory of a block: W_hh, the h of `rows` rows, the bias
size_t fwd_smem(int H, int kp, int rows) {
  const int H4 = (H + 3) & ~3;
  return sizeof(float) * ((size_t)3 * H * kp + (size_t)H4 * rows + 3 * H);
}

// The plan with jt units and rt rows a thread and p row groups a block;
// W_hh's rows are padded by 4 floats where that fits (so that the rows two
// unit groups of one warp read start on other banks).  False when it does
// not fit.
bool block_plan(int H, int jt, int rt, int p, int smem_max, Plan* out) {
  const int q = (H + jt - 1) / jt;
  if (q * p > kMaxThreads) return false;
  const int H4 = (H + 3) & ~3;
  for (int kp : {H4 + 4, H4}) {
    const size_t smem = fwd_smem(H, kp, p * rt);
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
  const FwdKernel<T> kernel = kernel_of<T>(p);
  *e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  int sms = 0, n = 0;
  if (*e == cudaSuccess) *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*e == cudaSuccess)
    *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p.threads, p.smem);
  return n * sms;
}

// The plan for H and R, by the occupancy API: the fewest waves of blocks;
// then the most SMs with a block in the first wave; then the most warps in
// it, up to kWarpsPerSm an SM; then the fewest 16-byte shared-memory loads
// an FMA (3 JT + RT loads for 12 JT RT FMAs a thread and k4); then the most
// rows a block.  Tiles of at least 8 row groups.  The products wait on how
// fast shared memory hands words to the lanes: a warp-wide 16-byte load
// takes four cycles of the SM's, broadcast or not, so past two warps a
// scheduler more warps add nothing and fewer loads an FMA do.
template <typename T>
bool make_plan(int H, int R, int device, Plan* out, cudaError_t* e) {
  int smem_max = 0, sms = 0;
  *e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (*e == cudaSuccess) *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*e != cudaSuccess) return false;
  bool found = false;
  std::tuple<int, int, int, float, int> best;
  for (const auto& jr : kShapes) {
    for (int p = 32; p >= 8; p /= 2) {
      Plan plan;
      if (!block_plan(H, jr[0], jr[1], p, smem_max, &plan)) continue;
      const int resident = resident_blocks<T>(plan, device, e);
      if (*e != cudaSuccess) return false;
      if (resident == 0) continue;
      const int blocks = 2 * ((R + plan.rows - 1) / plan.rows);
      const int waves = (blocks + resident - 1) / resident;
      const int first = std::min(blocks, resident);
      const int warps = std::min(first * ((plan.threads + 31) / 32), kWarpsPerSm * sms);
      const float loads = (3.0f * plan.jt + plan.rt) / (plan.jt * plan.rt);
      const auto key =
          std::make_tuple(-waves, std::min(first, sms), warps, -loads, plan.rows);
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
// H = 128, the wrapper's limit: 4 units of 2 rows in 16-row tiles fit).
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
int launch(const T* gates, const T* w_hh, const T* b_hh, T* out, int L, int H, int R,
           cudaStream_t stream) {
  Plan p;
  int device = 0;
  const int err = plan_of<T>(H, R, &p, &device);
  if (err != 0) return err;  // before any launch
  const FwdKernel<T> kernel = kernel_of<T>(p);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return clear_and_return(e);
  kernel<<<dim3((R + p.rows - 1) / p.rows, 2), dim3(p.threads), p.smem, stream>>>(
      gates, w_hh, b_hh, out, L, H, R, p.kp);
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

extern "C" int bigru_fwd(const float* gates, const float* w_hh, const float* b_hh,
                         float* out, int L, int H, int R, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, L, H, R, stream);
}

extern "C" int bigru_fwd_bf16(const __nv_bfloat16* gates, const __nv_bfloat16* w_hh,
                              const __nv_bfloat16* b_hh, __nv_bfloat16* out, int L, int H,
                              int R, cudaStream_t stream) {
  return launch(gates, w_hh, b_hh, out, L, H, R, stream);
}

// The launch for hidden size H and R rows, for logs: plan[0..6] = units and
// rows a thread, rows, threads and shared-memory bytes of a block, blocks of
// the grid, blocks the card runs at once.  Launches nothing.
extern "C" int bigru_fwd_plan(int H, int R, int* plan) { return plan_query<float>(H, R, plan); }

extern "C" int bigru_fwd_bf16_plan(int H, int R, int* plan) {
  return plan_query<__nv_bfloat16>(H, R, plan);
}
