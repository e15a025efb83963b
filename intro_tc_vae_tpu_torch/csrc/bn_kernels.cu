// Train-mode grouped BatchNorm + leaky ReLU, forward and backward, for
// Hopper (sm_90a).
//
// These kernels replace no TPU kernel: the JAX package leaves BatchNorm to
// XLA, which fuses its passes on the TPU. Eager PyTorch runs the module
// (models/blocks.py::GroupedBatchNorm, then F.leaky_relu) as a chain of
// full-tensor passes over float32 temporaries, about 27 kernels and 140-150
// bytes an element per call forward and backward, and the flagship's
// training step spends most of its device time in such memory-bound passes
// (PERF.md section 5). These kernels move 16 bytes an element of bf16:
//   bn_stats       reads x                       -> per-run fp32 partials
//   bn_finalize    folds the partials            -> mean, rstd, a; EMA
//   bn_apply       reads x, writes y
//   bn_bwd_reduce  reads x and dy                -> per-run fp32 partials
//   bn_bwd_dx      folds the partials, reads x and dy, writes dx
//                  (and dweight, dbias)
// so they are bound by device memory bandwidth; the plain version, the
// numerics and the gradient's form are in ops/batchnorm.py.
//
// The function, per (group g, channel c) pair of x [N, C, HW], whose batch
// is G groups of N / G samples:
//   mean = sum / n, var = max(0, sumsq / n - mean^2), n = (N / G) HW,
//   rstd = 1 / sqrt(var + eps), a = rstd weight[c],
//   y = act(T((x - mean) a + bias[c])), act(v) = v > 0 ? v : T(v slope),
// with T the rounding to x's dtype and every operation in fp32; and, for
// the incoming dy, dy' = dy act'(y), the mask recomputed from x,
//   dx = a dy' - a S1 / n - (x - mean) a rstd^2 S2 / n [var not clamped],
//   S1 = sum dy', S2 = sum dy' (x - mean),
//   dweight[c] = sum_g rstd_g S2_g, dbias[c] = sum_g S1_g.
//
// Design. Blocks run in no order, so every reduction is a second pass over
// partials, summed in a fixed order: no floating-point atomics, the same
// bits in every run. A pair's samples are cut into `slices` runs of
// `per_slice` samples (ops/batchnorm.py::launch_plan: about 32K elements a
// run, more runs where the pairs are too few to fill the card), one block a
// run, pair-major: block b is run b % slices of pair b / slices. The four
// streaming kernels share that cut. A run is per_slice planes of HW
// contiguous elements, C HW apart; a block walks it in 16-byte vectors
// (whole planes of 8 bf16 or 4 fp32), thread t taking vector t, t +
// threads, ..., the (sample, offset) of the next found by an add and a
// compare (for_each_vector), 4 vectors a thread in flight. A thread sums
// its elements in order, a block by a fixed butterfly in each warp and then
// over the warps; bn_finalize folds a pair's runs one warp a channel (lane
// l adds runs l, l + 32, ..., then a butterfly) and applies the G EMA
// updates of the running statistics in group order; bn_bwd_dx folds its
// pair's runs in its first warp before it streams, and the blocks of run 0
// of group 0 fold every group of their channel for dweight and dbias. At
// the 4x4 planes bn_bwd_dx takes about 3.3 launch floors: the fold is one
// global round trip in front of its loads (PERF.md section 6).
// Where the forward clamped a variance, the `keep` flag of its statistics
// is 0 and the variance path passes no gradient, as autograd's clamp.
//
// Statistics kept for the backward: stat[g, c] = {mean, rstd, a, keep}
// (float4); y is not kept, the backward recomputes the mask from x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int UNROLL = 4;  // vectors a thread has in flight

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ float to_f<f16>(f16 v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ f16 from_f<f16>(float v) { return __float2half_rn(v); }

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

struct Shape {
  int n, c, hw, groups;   // x [n, c, hw], groups of n / groups samples
  int slices, per_slice;  // runs a pair, samples a run
};

struct Run {
  int g, c, n0, count;  // pair (g, c); samples n0 .. n0 + count - 1 of x
};

__device__ __forceinline__ Run run_of(const Shape& sh, int b) {
  Run r;
  const int s = b % sh.slices, pair = b / sh.slices;
  r.g = pair / sh.c;
  r.c = pair % sh.c;
  const int per_group = sh.n / sh.groups, first = s * sh.per_slice;
  r.n0 = r.g * per_group + first;
  r.count = min(sh.per_slice, per_group - first);
  return r;
}

// Calls body(idx, ok) on UNROLL vector indices of x at a time: thread t's
// vectors t, t + blockDim.x, ... of the run, in order (ok false past its
// end). tests/test_torch_batchnorm.py::thread_vectors models the stepping.
template <int VW, typename F>
__device__ __forceinline__ void for_each_vector(const Shape& sh, const Run& r, F&& body) {
  const int plane = sh.hw / VW;
  const int q = (int)blockDim.x / plane, rem = (int)blockDim.x % plane;
  int smp = (int)threadIdx.x / plane, o = (int)threadIdx.x % plane;
  const size_t row = (size_t)sh.c * plane;
  const size_t base = ((size_t)r.n0 * sh.c + r.c) * plane;
  while (smp < r.count) {
    size_t idx[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = smp < r.count;
      idx[u] = base + (size_t)smp * row + o;
      o += rem;
      smp += q;
      if (o >= plane) {
        o -= plane;
        ++smp;
      }
    }
    body(idx, ok);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums of s1 and s2, in thread 0 (fixed order: a butterfly in
// each warp, then one over the warps' sums).
__device__ __forceinline__ void block_sum2(float& s1, float& s2) {
  __shared__ float sh1[32], sh2[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh1[warp] = s1;
    sh2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = (blockDim.x + 31) >> 5;
    s1 = warp_sum(lane < warps ? sh1[lane] : 0.f);
    s2 = warp_sum(lane < warps ? sh2[lane] : 0.f);
  }
}

// Lanes of one warp: the sums over runs of pair's partials, in every lane.
__device__ __forceinline__ float2 fold(const float2* __restrict__ part, int slices) {
  const int lane = threadIdx.x & 31;
  float a = 0.f, b = 0.f;
  for (int s = lane; s < slices; s += 32) {
    const float2 p = part[s];
    a += p.x;
    b += p.y;
  }
  return make_float2(warp_sum(a), warp_sum(b));
}

// The activation's output from the BatchNorm's fp32 value t; and whether
// its gradient passes unscaled, T(t) > 0, recomputed as the forward did.
template <typename T>
__device__ __forceinline__ T act(float t, float slope) {
  const T r = from_f<T>(t);
  if (slope == 1.f) return r;
  const float f = to_f<T>(r);
  return f > 0.f ? r : from_f<T>(f * slope);
}

template <typename T>
__device__ __forceinline__ bool passes(float t, float slope) {
  return slope == 1.f || to_f<T>(from_f<T>(t)) > 0.f;
}

template <typename T, int VW>
__global__ void __launch_bounds__(256) bn_stats(const T* __restrict__ x, float2* __restrict__ part,
                                                Shape sh) {
  const Run r = run_of(sh, blockIdx.x);
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  float s1 = 0.f, s2 = 0.f;
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const bool* ok) {
    Pack<T, VW> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) v[u] = xv[idx[u]];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float f = to_f<T>(v[u].v[e]);
        s1 += f;
        s2 = fmaf(f, f, s2);
      }
    }
  });
  block_sum2(s1, s2);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(s1, s2);
}

// One warp a channel: each group's statistics, then its EMA update.
__global__ void __launch_bounds__(256) bn_finalize(const float2* __restrict__ part,
                                                   const float* __restrict__ weight,
                                                   float4* __restrict__ stat,
                                                   float* __restrict__ running_mean,
                                                   float* __restrict__ running_var, int c_count,
                                                   int groups, int slices, int count, float eps,
                                                   float keep, float momentum) {
  const int c = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= c_count) return;
  const bool update = running_mean != nullptr;
  float rm = 0.f, rv = 0.f;
  if (update && lane == 0) {
    rm = running_mean[c];
    rv = running_var[c];
  }
  const float nf = (float)count;
  for (int g = 0; g < groups; ++g) {
    const float2 s = fold(part + (size_t)(g * c_count + c) * slices, slices);
    if (lane == 0) {
      const float mean = s.x / nf;
      const float raw = __fsub_rn(s.y / nf, __fmul_rn(mean, mean));
      const float var = raw < 0.f ? 0.f : raw;
      const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
      stat[g * c_count + c] =
          make_float4(mean, rstd, __fmul_rn(rstd, weight[c]), raw >= 0.f ? 1.f : 0.f);
      if (update) {
        rm = __fadd_rn(__fmul_rn(keep, rm), __fmul_rn(momentum, mean));
        rv = __fadd_rn(__fmul_rn(keep, rv), __fmul_rn(momentum, var));
      }
    }
  }
  if (update && lane == 0) {
    running_mean[c] = rm;
    running_var[c] = rv;
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(256) bn_apply(const T* __restrict__ x,
                                                const float4* __restrict__ stat,
                                                const float* __restrict__ bias, T* __restrict__ y,
                                                Shape sh, float slope) {
  const Run r = run_of(sh, blockIdx.x);
  const float4 st = stat[r.g * sh.c + r.c];
  const float mean = st.x, a = st.z, b = bias[r.c];
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  Pack<T, VW>* yv = reinterpret_cast<Pack<T, VW>*>(y);
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const bool* ok) {
    Pack<T, VW> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) v[u] = xv[idx[u]];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      Pack<T, VW> out;
#pragma unroll
      for (int e = 0; e < VW; ++e)
        out.v[e] = act<T>(fmaf(to_f<T>(v[u].v[e]) - mean, a, b), slope);
      yv[idx[u]] = out;
    }
  });
}

template <typename T, int VW>
__global__ void __launch_bounds__(256) bn_bwd_reduce(const T* __restrict__ x,
                                                     const T* __restrict__ dy,
                                                     const float4* __restrict__ stat,
                                                     const float* __restrict__ bias,
                                                     float2* __restrict__ part, Shape sh,
                                                     float slope) {
  const Run r = run_of(sh, blockIdx.x);
  const float4 st = stat[r.g * sh.c + r.c];
  const float mean = st.x, a = st.z, b = bias[r.c];
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  const Pack<T, VW>* dv = reinterpret_cast<const Pack<T, VW>*>(dy);
  float s1 = 0.f, s2 = 0.f;
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const bool* ok) {
    Pack<T, VW> v[UNROLL], d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) {
        v[u] = xv[idx[u]];
        d[u] = dv[idx[u]];
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xc = to_f<T>(v[u].v[e]) - mean;
        float g = to_f<T>(d[u].v[e]);
        if (!passes<T>(fmaf(xc, a, b), slope)) g *= slope;
        s1 += g;
        s2 = fmaf(g, xc, s2);
      }
    }
  });
  block_sum2(s1, s2);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(s1, s2);
}

// dx of the run, after its first warp folds the pair's partials into the
// two coefficients (k1 = -a S1 / n, k2 = -a rstd^2 S2 / n keep); the block
// of run 0 of group 0 of each channel also folds every group's for dweight
// and dbias. dx null: only dweight and dbias. dweight, dbias null: not
// asked for.
template <typename T, int VW>
__global__ void __launch_bounds__(256) bn_bwd_dx(const T* __restrict__ x,
                                                 const T* __restrict__ dy,
                                                 const float4* __restrict__ stat,
                                                 const float* __restrict__ bias,
                                                 const float2* __restrict__ part,
                                                 T* __restrict__ dx, float* __restrict__ dweight,
                                                 float* __restrict__ dbias, Shape sh, int count,
                                                 float slope) {
  const Run r = run_of(sh, blockIdx.x);
  const float4 st = stat[r.g * sh.c + r.c];
  const float mean = st.x, a = st.z, b = bias[r.c];
  __shared__ float coef[2];
  if (threadIdx.x < 32) {
    const float nf = (float)count;
    const float2 s = fold(part + (size_t)(r.g * sh.c + r.c) * sh.slices, sh.slices);
    if (threadIdx.x == 0) {
      coef[0] = -a * s.x / nf;
      coef[1] = -a * st.y * st.y * s.y / nf * st.w;
    }
    const bool first = r.g == 0 && blockIdx.x % sh.slices == 0;
    if (first && (dweight != nullptr || dbias != nullptr)) {
      float dw = 0.f, db = 0.f;
      for (int g = 0; g < sh.groups; ++g) {
        const float2 t = fold(part + (size_t)(g * sh.c + r.c) * sh.slices, sh.slices);
        dw = fmaf(stat[g * sh.c + r.c].y, t.y, dw);
        db += t.x;
      }
      if (threadIdx.x == 0) {
        if (dweight != nullptr) dweight[r.c] = dw;
        if (dbias != nullptr) dbias[r.c] = db;
      }
    }
  }
  if (dx == nullptr) return;
  __syncthreads();
  const float k1 = coef[0], k2 = coef[1];
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  const Pack<T, VW>* dv = reinterpret_cast<const Pack<T, VW>*>(dy);
  Pack<T, VW>* ov = reinterpret_cast<Pack<T, VW>*>(dx);
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const bool* ok) {
    Pack<T, VW> v[UNROLL], d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) {
        v[u] = xv[idx[u]];
        d[u] = dv[idx[u]];
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      Pack<T, VW> out;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xc = to_f<T>(v[u].v[e]) - mean;
        float g = to_f<T>(d[u].v[e]);
        if (!passes<T>(fmaf(xc, a, b), slope)) g *= slope;
        out.v[e] = from_f<T>(fmaf(xc, k2, fmaf(a, g, k1)));
      }
      ov[idx[u]] = out;
    }
  });
}

bool shape_ok(const Shape& sh, int vec, int threads) {
  const int per_group = sh.groups > 0 ? sh.n / sh.groups : 0;
  return sh.n > 0 && sh.c > 0 && sh.hw > 0 && sh.groups > 0 && sh.n % sh.groups == 0 &&
         sh.slices > 0 && sh.per_slice > 0 && (sh.slices - 1) * sh.per_slice < per_group &&
         sh.slices * sh.per_slice >= per_group && vec > 0 && sh.hw % vec == 0 &&
         threads >= 32 && threads <= 256 && threads % 32 == 0;
}

int grid_of(const Shape& sh) { return sh.groups * sh.c * sh.slices; }

// One launcher a streaming kernel, instantiated for each (dtype, vector).
template <typename T, int VW>
struct Stats {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, void* part) {
    bn_stats<T, VW><<<grid_of(sh), threads, 0, s>>>((const T*)x, (float2*)part, sh);
  }
};

template <typename T, int VW>
struct Apply {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* stat,
                  const float* bias, void* y, float slope) {
    bn_apply<T, VW><<<grid_of(sh), threads, 0, s>>>((const T*)x, (const float4*)stat, bias,
                                                    (T*)y, sh, slope);
  }
};

template <typename T, int VW>
struct BwdReduce {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* dy,
                  const void* stat, const float* bias, void* part, float slope) {
    bn_bwd_reduce<T, VW><<<grid_of(sh), threads, 0, s>>>(
        (const T*)x, (const T*)dy, (const float4*)stat, bias, (float2*)part, sh, slope);
  }
};

template <typename T, int VW>
struct BwdDx {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* dy,
                  const void* stat, const float* bias, const void* part, void* dx,
                  float* dweight, float* dbias, int count, float slope) {
    bn_bwd_dx<T, VW><<<grid_of(sh), threads, 0, s>>>(
        (const T*)x, (const T*)dy, (const float4*)stat, bias, (const float2*)part, (T*)dx,
        dweight, dbias, sh, count, slope);
  }
};

// L<T, VW>::run for dtype code `dtype` (0 float32, 1 bfloat16, 2 float16)
// and `vec` elements a vector (16 bytes of T, or 1); the launch's error.
template <template <typename, int> class L, typename... A>
int dispatch(int dtype, int vec, int device, void* stream, int threads, const Shape& sh,
             A... args) {
  if (!shape_ok(sh, vec, threads)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vec == 4) L<float, 4>::run(s, threads, sh, args...);
  else if (dtype == 0 && vec == 1) L<float, 1>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 8) L<bf16, 8>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 1) L<bf16, 1>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 8) L<f16, 8>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 1) L<f16, 1>::run(s, threads, sh, args...);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises. x, dy, y, dx: [n, c, hw] contiguous in
// `dtype` (0 float32, 1 bfloat16, 2 float16), 16-byte aligned where vec >
// 1; part: float2 [groups * c * slices]; stat: float4 [groups, c]; weight,
// bias, the running statistics, dweight and dbias: float32 [c]. The
// streaming kernels run groups * c * slices blocks of `threads`.
extern "C" {

int bn_stats_launch(const void* x, void* part, int n, int c, int hw, int groups, int slices,
                    int per_slice, int vec, int threads, int dtype, int device, void* stream) {
  return dispatch<Stats>(dtype, vec, device, stream, threads,
                         Shape{n, c, hw, groups, slices, per_slice}, x, part);
}

// running_mean, running_var: both null for no update (a remat recompute).
int bn_finalize_launch(const void* part, const float* weight, void* stat, float* running_mean,
                       float* running_var, int c, int groups, int slices, int count, float eps,
                       float keep, float momentum, int device, void* stream) {
  if (c < 1 || groups < 1 || slices < 1 || count < 1 ||
      (running_mean == nullptr) != (running_var == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const int threads = 256, blocks = (c * 32 + threads - 1) / threads;
  bn_finalize<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float2*)part, weight, (float4*)stat, running_mean, running_var, c, groups, slices,
      count, eps, keep, momentum);
  return (int)cudaGetLastError();
}

int bn_apply_launch(const void* x, const void* stat, const float* bias, void* y, int n, int c,
                    int hw, int groups, int slices, int per_slice, int vec, int threads,
                    float slope, int dtype, int device, void* stream) {
  return dispatch<Apply>(dtype, vec, device, stream, threads,
                         Shape{n, c, hw, groups, slices, per_slice}, x, stat, bias, y, slope);
}

int bn_bwd_reduce_launch(const void* x, const void* dy, const void* stat, const float* bias,
                         void* part, int n, int c, int hw, int groups, int slices, int per_slice,
                         int vec, int threads, float slope, int dtype, int device, void* stream) {
  return dispatch<BwdReduce>(dtype, vec, device, stream, threads,
                             Shape{n, c, hw, groups, slices, per_slice}, x, dy, stat, bias, part,
                             slope);
}

// dx null: dweight and dbias only; dweight, dbias null: not computed.
int bn_bwd_dx_launch(const void* x, const void* dy, const void* stat, const float* bias,
                     const void* part, void* dx, float* dweight, float* dbias, int n, int c,
                     int hw, int groups, int slices, int per_slice, int vec, int threads,
                     float slope, int dtype, int device, void* stream) {
  const int count = n / (groups > 0 ? groups : 1) * hw;
  return dispatch<BwdDx>(dtype, vec, device, stream, threads,
                         Shape{n, c, hw, groups, slices, per_slice}, x, dy, stat, bias, part, dx,
                         dweight, dbias, count, slope);
}

}  // extern "C"
