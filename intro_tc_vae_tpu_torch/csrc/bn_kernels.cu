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
//
// Resample variants. Where a stage's 2x2 average pool (stride 2) or nearest
// 2x upsample follows the call (models/blocks.py), the kernels take it:
//   bn_apply_pool  writes T(0.25 (((y00 + y01) + y10) + y11)) of each 2x2
//                  window of y, the sum in fp32 in that order, for no y
//   bn_apply_up    writes each y to its 2x2 block
//   bn_bwd_reduce_pool, bn_bwd_dx_pool
//                  read dy = T(0.25 dy_p) from the pooled gradient dy_p
//   bn_bwd_reduce_up
//                  reads dy = T(((g00 + g01) + g10) + g11), the fp32 sum of
//                  the element's 2x2 block of the upsampled gradient, and
//                  writes it (x's shape) for bn_bwd_dx to read
// These are the values avg_pool2d, upsample_nearest2d and their backward
// passes store, so a resampled call gives the bits of the call followed by
// the stock pass. The backward kernels walk x's vectors as the plain ones
// do, so their sums keep their order. A pooled call moves 4.5 B an element
// of bf16 x forward and 7 backward, where the call and the stock pass move
// 8.5 and 12.5; an upsampled one 12 and 18 where they move 16 and 20.
// `rows` (a template flag): every vector lies in one row (W % VW == 0) and
// the resampled tensor is aligned to 16 bytes, so its rows are read or
// written in vectors; otherwise element by element (one element a vector,
// the 4x4 planes of bf16, a misaligned gradient).

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
  int w;                  // a plane's width: hw = h w (the resample variants)
};

enum Resample { NONE = 0, POOL = 1, UP = 2 };

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

// Calls body(idx, o, ok) on UNROLL unit indices at a time, a plane of the
// run being `plane` units: thread t's units t, t + blockDim.x, ... of the
// run, in order (ok false past its end); idx = (sample c_count + channel)
// plane + o, o the unit within its plane. The units are x's vectors
// (for_each_vector) but in bn_apply_pool, which walks its output.
// tests/test_torch_batchnorm.py::thread_vectors models the stepping.
template <typename F>
__device__ __forceinline__ void for_each_unit(const Shape& sh, const Run& r, int plane, F&& body) {
  const int q = (int)blockDim.x / plane, rem = (int)blockDim.x % plane;
  int smp = (int)threadIdx.x / plane, o = (int)threadIdx.x % plane;
  const size_t row = (size_t)sh.c * plane;
  const size_t base = ((size_t)r.n0 * sh.c + r.c) * plane;
  while (smp < r.count) {
    size_t idx[UNROLL];
    int off[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = smp < r.count;
      idx[u] = base + (size_t)smp * row + o;
      off[u] = o;
      o += rem;
      smp += q;
      if (o >= plane) {
        o -= plane;
        ++smp;
      }
    }
    body(idx, off, ok);
  }
}

template <int VW, typename F>
__device__ __forceinline__ void for_each_vector(const Shape& sh, const Run& r, F&& body) {
  for_each_unit(sh, r, sh.hw / VW, body);
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
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const int*, const bool* ok) {
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

// The element of x at plane offset p: its row and column.
struct Pos {
  size_t h, w;
};

__device__ __forceinline__ Pos pos_of(const Shape& sh, int p) {
  const int h = p / sh.w;
  return Pos{(size_t)h, (size_t)(p - h * sh.w)};
}

// The stock resamples' roundings: avg_pool2d_backward stores T(0 + dy / 4),
// avg_pool2d T((((0 + y00) + y01) + y10) + y11) / 4) and
// upsample_nearest2d_backward T((((0 + g00) + g01) + g10) + g11), in fp32.
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.f, a), b), c), d);
}

template <typename T>
__device__ __forceinline__ float pooled_grad(T d) {
  return to_f<T>(from_f<T>(__fadd_rn(0.f, __fmul_rn(to_f<T>(d), 0.25f))));
}

template <typename T>
__device__ __forceinline__ float summed_grad(T a, T b, T c, T d) {
  return to_f<T>(from_f<T>(sum4(to_f<T>(a), to_f<T>(b), to_f<T>(c), to_f<T>(d))));
}

// The incoming gradient of the VW elements of x's vector idx (o within its
// plane), as the BatchNorm's backward reads it: load() issues the loads,
// get(e) gives element e's value.
// dy itself (no resample).
template <typename T, int VW>
struct Direct {
  Pack<T, VW> p;
  __device__ __forceinline__ void load(const T* __restrict__ dy, const Shape&, size_t idx, int) {
    p = reinterpret_cast<const Pack<T, VW>*>(dy)[idx];
  }
  __device__ __forceinline__ float get(int e) const { return to_f<T>(p.v[e]); }
};

// dy_p of a 2x2 average pool: [n, c, h / 2, w / 2].
template <typename T, int VW, bool ROWS>
struct Pooled {
  static constexpr int K = ROWS ? (VW > 1 ? VW / 2 : 1) : VW;
  T q[K];
  __device__ __forceinline__ void load(const T* __restrict__ dy, const Shape& sh, size_t idx,
                                       int o) {
    const size_t plane = (idx - o) * VW / 4;  // the pooled plane's first element
    const size_t half = sh.w / 2;
    if constexpr (ROWS) {
      const Pos at = pos_of(sh, o * VW);
      const size_t el = plane + (at.h >> 1) * half + (at.w >> 1);
      const Pack<T, K> p = reinterpret_cast<const Pack<T, K>*>(dy)[el / K];
#pragma unroll
      for (int k = 0; k < K; ++k) q[k] = p.v[k];
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const Pos at = pos_of(sh, o * VW + e);
        q[e] = dy[plane + (at.h >> 1) * half + (at.w >> 1)];
      }
    }
  }
  __device__ __forceinline__ float get(int e) const {
    return pooled_grad<T>(q[ROWS ? e >> 1 : e]);
  }
};

// g of a nearest 2x upsample: [n, c, 2h, 2w]; each element sums its 2x2.
template <typename T, int VW, bool ROWS>
struct Upsampled {
  T q[VW][4];  // per element: g00, g01, g10, g11
  __device__ __forceinline__ void load(const T* __restrict__ dy, const Shape& sh, size_t idx,
                                       int o) {
    const size_t plane = (idx - o) * VW * 4, wide = 2 * (size_t)sh.w;
    if constexpr (ROWS) {
      const Pos at = pos_of(sh, o * VW);
      const size_t el = plane + 2 * at.h * wide + 2 * at.w;
      const Pack<T, VW>* dv = reinterpret_cast<const Pack<T, VW>*>(dy);
      Pack<T, VW> top[2], bot[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        top[k] = dv[el / VW + k];
        bot[k] = dv[(el + wide) / VW + k];
      }
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int k = 2 * e / VW, j = 2 * e % VW;
        q[e][0] = top[k].v[j];
        q[e][1] = top[k].v[j + 1];
        q[e][2] = bot[k].v[j];
        q[e][3] = bot[k].v[j + 1];
      }
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const Pos at = pos_of(sh, o * VW + e);
        const size_t el = plane + 2 * at.h * wide + 2 * at.w;
        q[e][0] = dy[el];
        q[e][1] = dy[el + 1];
        q[e][2] = dy[el + wide];
        q[e][3] = dy[el + wide + 1];
      }
    }
  }
  __device__ __forceinline__ float get(int e) const {
    return summed_grad<T>(q[e][0], q[e][1], q[e][2], q[e][3]);
  }
};

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
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const int*, const bool* ok) {
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

// y_p [n, c, h / 2, w / 2], walked in its own units: with rows, VW / 2
// outputs from a vector of each of two rows of x; else one from four
// elements.
template <typename T, int VW, bool ROWS>
__global__ void __launch_bounds__(256) bn_apply_pool(const T* __restrict__ x,
                                                     const float4* __restrict__ stat,
                                                     const float* __restrict__ bias,
                                                     T* __restrict__ y, Shape sh, float slope) {
  constexpr int IN = ROWS ? VW : 2, OUT = IN / 2;  // x columns, outputs a unit
  const Run r = run_of(sh, blockIdx.x);
  const float4 st = stat[r.g * sh.c + r.c];
  const float mean = st.x, a = st.z, b = bias[r.c];
  const int across = sh.w / IN;  // units a row pair
  for_each_unit(sh, r, sh.hw / (2 * IN), [&](const size_t* idx, const int* o, const bool* ok) {
    Pack<T, IN> v[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      const int pair = o[u] / across, k = o[u] - pair * across;
      const size_t top = (idx[u] - o[u]) * 2 * IN + (size_t)2 * pair * sh.w + (size_t)k * IN;
      if constexpr (ROWS) {
        const Pack<T, IN>* xv = reinterpret_cast<const Pack<T, IN>*>(x);
        v[u][0] = xv[top / IN];
        v[u][1] = xv[(top + sh.w) / IN];
      } else {
#pragma unroll
        for (int j = 0; j < IN; ++j) {
          v[u][0].v[j] = x[top + j];
          v[u][1].v[j] = x[top + sh.w + j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      float f[2][IN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < IN; ++j)
          f[i][j] = to_f<T>(act<T>(fmaf(to_f<T>(v[u][i].v[j]) - mean, a, b), slope));
      Pack<T, OUT> out;
#pragma unroll
      for (int j = 0; j < OUT; ++j)
        out.v[j] = from_f<T>(
            __fmul_rn(sum4(f[0][2 * j], f[0][2 * j + 1], f[1][2 * j], f[1][2 * j + 1]), 0.25f));
      reinterpret_cast<Pack<T, OUT>*>(y)[idx[u]] = out;
    }
  });
}

// y_u [n, c, 2h, 2w]: each element of x's vector to its 2x2 block.
template <typename T, int VW, bool ROWS>
__global__ void __launch_bounds__(256) bn_apply_up(const T* __restrict__ x,
                                                   const float4* __restrict__ stat,
                                                   const float* __restrict__ bias,
                                                   T* __restrict__ y, Shape sh, float slope) {
  const Run r = run_of(sh, blockIdx.x);
  const float4 st = stat[r.g * sh.c + r.c];
  const float mean = st.x, a = st.z, b = bias[r.c];
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  const size_t wide = 2 * (size_t)sh.w;
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const int* o, const bool* ok) {
    Pack<T, VW> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) v[u] = xv[idx[u]];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      T t[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) t[e] = act<T>(fmaf(to_f<T>(v[u].v[e]) - mean, a, b), slope);
      const size_t plane = (idx[u] - o[u]) * VW * 4;
      if constexpr (ROWS) {
        const Pos at = pos_of(sh, o[u] * VW);
        const size_t el = plane + 2 * at.h * wide + 2 * at.w;
        Pack<T, VW>* yv = reinterpret_cast<Pack<T, VW>*>(y);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          Pack<T, VW> out;
#pragma unroll
          for (int j = 0; j < VW; ++j) out.v[j] = t[(k * VW + j) / 2];
          yv[el / VW + k] = out;
          yv[(el + wide) / VW + k] = out;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const Pos at = pos_of(sh, o[u] * VW + e);
          const size_t el = plane + 2 * at.h * wide + 2 * at.w;
          y[el] = t[e];
          y[el + 1] = t[e];
          y[el + wide] = t[e];
          y[el + wide + 1] = t[e];
        }
      }
    }
  });
}

// The run's partial sums of dy' and dy' (x - mean), dy read through G
// (Direct, Pooled or Upsampled); with `dsum`, also the values G gives,
// stored in x's layout for bn_bwd_dx.
template <typename T, int VW, class G>
__device__ __forceinline__ void bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                                           const float4* __restrict__ stat,
                                           const float* __restrict__ bias,
                                           float2* __restrict__ part, T* __restrict__ dsum,
                                           const Shape& sh, float slope) {
  const Run r = run_of(sh, blockIdx.x);
  const float4 st = stat[r.g * sh.c + r.c];
  const float mean = st.x, a = st.z, b = bias[r.c];
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  float s1 = 0.f, s2 = 0.f;
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const int* o, const bool* ok) {
    Pack<T, VW> v[UNROLL];
    G d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) {
        v[u] = xv[idx[u]];
        d[u].load(dy, sh, idx[u], o[u]);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      Pack<T, VW> kept;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xc = to_f<T>(v[u].v[e]) - mean;
        float g = d[u].get(e);
        if (dsum != nullptr) kept.v[e] = from_f<T>(g);
        if (!passes<T>(fmaf(xc, a, b), slope)) g *= slope;
        s1 += g;
        s2 = fmaf(g, xc, s2);
      }
      if (dsum != nullptr) reinterpret_cast<Pack<T, VW>*>(dsum)[idx[u]] = kept;
    }
  });
  block_sum2(s1, s2);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(s1, s2);
}

template <typename T, int VW>
__global__ void __launch_bounds__(256) bn_bwd_reduce(const T* __restrict__ x,
                                                     const T* __restrict__ dy,
                                                     const float4* __restrict__ stat,
                                                     const float* __restrict__ bias,
                                                     float2* __restrict__ part, Shape sh,
                                                     float slope) {
  bwd_reduce<T, VW, Direct<T, VW>>(x, dy, stat, bias, part, nullptr, sh, slope);
}

template <typename T, int VW, bool ROWS>
__global__ void __launch_bounds__(256) bn_bwd_reduce_pool(const T* __restrict__ x,
                                                          const T* __restrict__ dy,
                                                          const float4* __restrict__ stat,
                                                          const float* __restrict__ bias,
                                                          float2* __restrict__ part, Shape sh,
                                                          float slope) {
  bwd_reduce<T, VW, Pooled<T, VW, ROWS>>(x, dy, stat, bias, part, nullptr, sh, slope);
}

template <typename T, int VW, bool ROWS>
__global__ void __launch_bounds__(256) bn_bwd_reduce_up(const T* __restrict__ x,
                                                        const T* __restrict__ dy,
                                                        const float4* __restrict__ stat,
                                                        const float* __restrict__ bias,
                                                        float2* __restrict__ part,
                                                        T* __restrict__ dsum, Shape sh,
                                                        float slope) {
  bwd_reduce<T, VW, Upsampled<T, VW, ROWS>>(x, dy, stat, bias, part, dsum, sh, slope);
}

// dx of the run, after its first warp folds the pair's partials into the
// two coefficients (k1 = -a S1 / n, k2 = -a rstd^2 S2 / n keep); the block
// of run 0 of group 0 of each channel also folds every group's for dweight
// and dbias. dx null: only dweight and dbias. dweight, dbias null: not
// asked for. dy read through G (Direct or Pooled).
template <typename T, int VW, class G>
__device__ __forceinline__ void bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
                                       const float4* __restrict__ stat,
                                       const float* __restrict__ bias,
                                       const float2* __restrict__ part, T* __restrict__ dx,
                                       float* __restrict__ dweight, float* __restrict__ dbias,
                                       const Shape& sh, int count, float slope) {
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
  Pack<T, VW>* ov = reinterpret_cast<Pack<T, VW>*>(dx);
  for_each_vector<VW>(sh, r, [&](const size_t* idx, const int* o, const bool* ok) {
    Pack<T, VW> v[UNROLL];
    G d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) {
        v[u] = xv[idx[u]];
        d[u].load(dy, sh, idx[u], o[u]);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!ok[u]) continue;
      Pack<T, VW> out;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xc = to_f<T>(v[u].v[e]) - mean;
        float g = d[u].get(e);
        if (!passes<T>(fmaf(xc, a, b), slope)) g *= slope;
        out.v[e] = from_f<T>(fmaf(xc, k2, fmaf(a, g, k1)));
      }
      ov[idx[u]] = out;
    }
  });
}

template <typename T, int VW>
__global__ void __launch_bounds__(256) bn_bwd_dx(const T* __restrict__ x,
                                                 const T* __restrict__ dy,
                                                 const float4* __restrict__ stat,
                                                 const float* __restrict__ bias,
                                                 const float2* __restrict__ part,
                                                 T* __restrict__ dx, float* __restrict__ dweight,
                                                 float* __restrict__ dbias, Shape sh, int count,
                                                 float slope) {
  bwd_dx<T, VW, Direct<T, VW>>(x, dy, stat, bias, part, dx, dweight, dbias, sh, count, slope);
}

template <typename T, int VW, bool ROWS>
__global__ void __launch_bounds__(256) bn_bwd_dx_pool(const T* __restrict__ x,
                                                      const T* __restrict__ dy,
                                                      const float4* __restrict__ stat,
                                                      const float* __restrict__ bias,
                                                      const float2* __restrict__ part,
                                                      T* __restrict__ dx,
                                                      float* __restrict__ dweight,
                                                      float* __restrict__ dbias, Shape sh,
                                                      int count, float slope) {
  bwd_dx<T, VW, Pooled<T, VW, ROWS>>(x, dy, stat, bias, part, dx, dweight, dbias, sh, count,
                                     slope);
}

bool shape_ok(const Shape& sh, int vec, int threads) {
  const int per_group = sh.groups > 0 ? sh.n / sh.groups : 0;
  return sh.n > 0 && sh.c > 0 && sh.hw > 0 && sh.groups > 0 && sh.n % sh.groups == 0 &&
         sh.slices > 0 && sh.per_slice > 0 && (sh.slices - 1) * sh.per_slice < per_group &&
         sh.slices * sh.per_slice >= per_group && vec > 0 && sh.hw % vec == 0 &&
         threads >= 32 && threads <= 256 && threads % 32 == 0;
}

// A resample the plane allows: a pool needs even H and W, an upsample any.
bool resample_ok(const Shape& sh, int resample) {
  if (resample == NONE) return true;
  if (sh.w < 1 || sh.hw % sh.w) return false;
  if (resample == POOL) return sh.w % 2 == 0 && (sh.hw / sh.w) % 2 == 0;
  return resample == UP;
}

// Rows of the resampled tensor `t` in vectors: each of x's vectors in one
// row and t aligned to 16 bytes.
bool rows_of(const Shape& sh, int vec, int resample, const void* t) {
  return resample != NONE && vec > 1 && sh.w % vec == 0 && (size_t)t % 16 == 0;
}

int grid_of(const Shape& sh) { return sh.groups * sh.c * sh.slices; }

// One launcher a streaming kernel, instantiated for each (dtype, vector,
// rows); the kernel follows `resample`.
template <typename T, int VW, bool ROWS>
struct Stats {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, void* part) {
    bn_stats<T, VW><<<grid_of(sh), threads, 0, s>>>((const T*)x, (float2*)part, sh);
  }
};

template <typename T, int VW, bool ROWS>
struct Apply {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* stat,
                  const float* bias, void* y, int resample, float slope) {
    const T* xt = (const T*)x;
    const float4* st = (const float4*)stat;
    if (resample == POOL)
      bn_apply_pool<T, VW, ROWS><<<grid_of(sh), threads, 0, s>>>(xt, st, bias, (T*)y, sh, slope);
    else if (resample == UP)
      bn_apply_up<T, VW, ROWS><<<grid_of(sh), threads, 0, s>>>(xt, st, bias, (T*)y, sh, slope);
    else
      bn_apply<T, VW><<<grid_of(sh), threads, 0, s>>>(xt, st, bias, (T*)y, sh, slope);
  }
};

template <typename T, int VW, bool ROWS>
struct BwdReduce {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* dy,
                  const void* stat, const float* bias, void* part, void* dsum, int resample,
                  float slope) {
    const T *xt = (const T*)x, *dt = (const T*)dy;
    const float4* st = (const float4*)stat;
    if (resample == POOL)
      bn_bwd_reduce_pool<T, VW, ROWS><<<grid_of(sh), threads, 0, s>>>(xt, dt, st, bias,
                                                                       (float2*)part, sh, slope);
    else if (resample == UP)
      bn_bwd_reduce_up<T, VW, ROWS><<<grid_of(sh), threads, 0, s>>>(
          xt, dt, st, bias, (float2*)part, (T*)dsum, sh, slope);
    else
      bn_bwd_reduce<T, VW><<<grid_of(sh), threads, 0, s>>>(xt, dt, st, bias, (float2*)part, sh,
                                                           slope);
  }
};

template <typename T, int VW, bool ROWS>
struct BwdDx {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* dy,
                  const void* stat, const float* bias, const void* part, void* dx,
                  float* dweight, float* dbias, int count, int resample, float slope) {
    const T *xt = (const T*)x, *dt = (const T*)dy;
    const float4* st = (const float4*)stat;
    const float2* pt = (const float2*)part;
    if (resample == POOL)
      bn_bwd_dx_pool<T, VW, ROWS><<<grid_of(sh), threads, 0, s>>>(
          xt, dt, st, bias, pt, (T*)dx, dweight, dbias, sh, count, slope);
    else
      bn_bwd_dx<T, VW><<<grid_of(sh), threads, 0, s>>>(xt, dt, st, bias, pt, (T*)dx, dweight,
                                                       dbias, sh, count, slope);
  }
};

// L<T, VW, ROWS>::run for dtype code `dtype` (0 float32, 1 bfloat16, 2
// float16), `vec` elements a vector (16 bytes of T, or 1) and `rows`; the
// launch's error.
template <template <typename, int, bool> class L, typename... A>
int dispatch(int dtype, int vec, bool rows, int device, void* stream, int threads,
             const Shape& sh, A... args) {
  if (!shape_ok(sh, vec, threads)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && vec == 4 && rows) L<float, 4, true>::run(s, threads, sh, args...);
  else if (dtype == 0 && vec == 4) L<float, 4, false>::run(s, threads, sh, args...);
  else if (dtype == 0 && vec == 1) L<float, 1, false>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 8 && rows) L<bf16, 8, true>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 8) L<bf16, 8, false>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 1) L<bf16, 1, false>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 8 && rows) L<f16, 8, true>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 8) L<f16, 8, false>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 1) L<f16, 1, false>::run(s, threads, sh, args...);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises. x, dx, dsum: [n, c, hw] contiguous in `dtype`
// (0 float32, 1 bfloat16, 2 float16), 16-byte aligned where vec > 1; y and
// dy the same, or, with `resample` (0 none, 1 the 2x2 average pool, 2 the
// nearest 2x upsample; hw = h w, w the plane's width), the resampled
// [n, c, h / 2, w / 2] or [n, c, 2h, 2w], any alignment; part: float2
// [groups * c * slices]; stat: float4 [groups, c]; weight, bias, the
// running statistics, dweight and dbias: float32 [c]. The streaming
// kernels run groups * c * slices blocks of `threads`.
extern "C" {

int bn_stats_launch(const void* x, void* part, int n, int c, int hw, int groups, int slices,
                    int per_slice, int vec, int threads, int dtype, int device, void* stream) {
  return dispatch<Stats>(dtype, vec, false, device, stream, threads,
                         Shape{n, c, hw, groups, slices, per_slice, 0}, x, part);
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

// y: the output of the resample `resample` of the BatchNorm's output.
int bn_apply_launch(const void* x, const void* stat, const float* bias, void* y, int n, int c,
                    int hw, int groups, int slices, int per_slice, int vec, int threads, int w,
                    int resample, float slope, int dtype, int device, void* stream) {
  const Shape sh{n, c, hw, groups, slices, per_slice, w};
  if (!resample_ok(sh, resample)) return (int)cudaErrorInvalidValue;
  return dispatch<Apply>(dtype, vec, rows_of(sh, vec, resample, y), device, stream, threads,
                         sh, x, stat, bias, y, resample, slope);
}

// dy: the gradient of the resampled output; with resample 2, dsum (x's
// shape) receives the gradient of the BatchNorm's output, for
// bn_bwd_dx_launch's dy (resample 0). dsum null otherwise.
int bn_bwd_reduce_launch(const void* x, const void* dy, const void* stat, const float* bias,
                         void* part, void* dsum, int n, int c, int hw, int groups, int slices,
                         int per_slice, int vec, int threads, int w, int resample, float slope,
                         int dtype, int device, void* stream) {
  const Shape sh{n, c, hw, groups, slices, per_slice, w};
  if (!resample_ok(sh, resample) || (resample == UP) != (dsum != nullptr))
    return (int)cudaErrorInvalidValue;
  return dispatch<BwdReduce>(dtype, vec, rows_of(sh, vec, resample, dy), device, stream,
                             threads, sh, x, dy, stat, bias, part, dsum, resample, slope);
}

// dx null: dweight and dbias only; dweight, dbias null: not computed.
// resample 0 or 1 (an upsample's dy is bn_bwd_reduce_launch's dsum).
int bn_bwd_dx_launch(const void* x, const void* dy, const void* stat, const float* bias,
                     const void* part, void* dx, float* dweight, float* dbias, int n, int c,
                     int hw, int groups, int slices, int per_slice, int vec, int threads, int w,
                     int resample, float slope, int dtype, int device, void* stream) {
  const Shape sh{n, c, hw, groups, slices, per_slice, w};
  if (!resample_ok(sh, resample) || resample == UP) return (int)cudaErrorInvalidValue;
  const int count = n / (groups > 0 ? groups : 1) * hw;
  return dispatch<BwdDx>(dtype, vec, rows_of(sh, vec, resample, dy), device, stream, threads,
                         sh, x, dy, stat, bias, part, dx, dweight, dbias, count, resample,
                         slope);
}

}  // extern "C"
