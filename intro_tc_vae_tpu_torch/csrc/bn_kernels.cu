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
//
// Channels-last bodies (the template flag NHWC). A tensor of logical shape
// [N, C, H, W] may lie channels-last ([N, H, W, C] in memory), as the stock
// convs around a BatchNorm write it (models/blocks.py::conv_layout). Every
// kernel takes either layout; y, dx and an upsample's summed gradient are
// written in x's, dy is read in y's. In NHWC a run is `per_slice` image rows
// of one group, every channel (ops/batchnorm.py::launch_plan), one block a
// run, group-major: block b is run b % slices of group b / slices. Thread t
// keeps one 16-byte vector of channels, t % (C / VW) (one channel where C is
// no whole number of vectors), for the whole run and takes pixels
// t / (C / VW), + threads / (C / VW), ... of it (for_each_pixel), 4 in
// flight, so its channels' statistics stay in registers. The block folds
// each channel's sums over its pixel rows in shared memory, in row order,
// into part[(g C + c) slices + s], the NCHW order of the partials, which
// bn_finalize folds as it does the NCHW ones. A block holds every channel,
// so bn_bwd_dx cannot fold its pair's partials in front of its loads as the
// NCHW body does (that would be C slices loads a block): its launcher runs
// bn_bwd_fold first, one warp a channel, which folds each group's partials
// into the two coefficients (coef[g, c]) and every group's into dweight and
// dbias, in the NCHW body's arithmetic, and the streaming kernel reads coef.
// The resample variants read and write whole channel vectors of each 2x2
// window, whatever W (the 4x4 planes too); a pooled call's runs hold an
// even number of rows, and its forward and backward walk the pooled
// pixels' windows (for_each_window), one load of dy_p for four pixels, so
// its backward sums run in another order than the plain kernels': its y
// and running statistics are those of the call followed by the stock pool,
// bit for bit, its gradients within rounding. An upsampled call keeps the
// bits as in NCHW.
// Also here, so that it costs no nvcc run of its own: relayout, the tiled
// transpose of ops/layout_cuda.py (a conv input moved between the layouts).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

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
  int slices, per_slice;  // runs a pair (NHWC: a group), samples (NHWC: rows) a run
  int w;                  // a plane's width: hw = h w
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

// NHWC: run b's group g and index s within it, its first pixel and its
// pixels (x as n h rows of w pixels; a group's rows lie together).
struct Span {
  int g, s, p0, count;
};

__device__ __forceinline__ Span span_of(const Shape& sh, int b) {
  Span r;
  r.s = b % sh.slices;
  r.g = b / sh.slices;
  const int rows = sh.n / sh.groups * (sh.hw / sh.w), first = r.s * sh.per_slice;
  r.p0 = (r.g * rows + first) * sh.w;
  r.count = min(sh.per_slice, rows - first) * sh.w;
  return r;
}

// NHWC: the first of the VW channels thread t keeps.
template <int VW>
__device__ __forceinline__ int first_channel(const Shape& sh) {
  return (int)threadIdx.x % (sh.c / VW) * VW;
}

// NHWC: calls body(idx, i, j, ok) on UNROLL pixels at a time of the
// `count` pixels from p0 of planes `width` wide: thread t's channel vector
// of pixels t / (C / VW), + rows, ... in order (rows = threads / (C / VW);
// ok false past the end); idx is the vector's index, i the pixel's row
// (n h + y, over the whole tensor) and j its column, stepped by an add and a
// compare. tests/test_torch_batchnorm.py::thread_pixels models the walk.
template <int VW, typename F>
__device__ __forceinline__ void for_each_pixel(const Shape& sh, int p0, int count, int width,
                                               F&& body) {
  const int cvs = sh.c / VW, rows = (int)blockDim.x / cvs, cv = (int)threadIdx.x % cvs;
  const int q = rows / width, rem = rows - q * width;
  int p = (int)threadIdx.x / cvs;
  int i = (p0 + p) / width, j = p0 + p - i * width;
  while (p < count) {
    size_t idx[UNROLL];
    int ii[UNROLL], jj[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ok[u] = p < count;
      ii[u] = i;
      jj[u] = j;
      idx[u] = ((size_t)i * width + j) * cvs + cv;
      p += rows;
      i += q;
      j += rem;
      if (j >= width) {
        j -= width;
        ++i;
      }
    }
    body(idx, ii, jj, ok);
  }
}

// NHWC, a pooled call: calls body(out, top, ok) on UNROLL 2x2 windows at a
// time, the run's pooled pixels walked as for_each_pixel walks a plane w / 2
// wide: out is the pooled vector's index, top that of x's vector at (2i, 2j);
// the window is top, top + C / VW and the two a row of x below. A window's
// four pixels lie in one run (runs of an even number of rows).
template <int VW, typename F>
__device__ __forceinline__ void for_each_window(const Shape& sh, const Span& r, F&& body) {
  const int cvs = sh.c / VW, cv = (int)threadIdx.x % cvs;
  for_each_pixel<VW>(sh, r.p0 / 4, r.count / 4, sh.w / 2, [&](const size_t* out, const int* oi,
                                                              const int* oj, const bool* ok) {
    size_t top[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) top[u] = ((size_t)2 * oi[u] * sh.w + 2 * oj[u]) * cvs + cv;
    body(out, top, ok);
  });
}

// NHWC: each channel's sums of the block, folded over its pixel rows in
// row order in shared memory, to part[(g C + c) slices + s].
template <int VW>
__device__ __forceinline__ void store_channels(const float (&s1)[VW], const float (&s2)[VW],
                                               float2* __restrict__ part, const Shape& sh,
                                               const Span& r) {
  __shared__ float red[2][256 * VW];
  const int cvs = sh.c / VW, rows = (int)blockDim.x / cvs;
  const int at = (int)threadIdx.x / cvs * sh.c + first_channel<VW>(sh);
#pragma unroll
  for (int e = 0; e < VW; ++e) {
    red[0][at + e] = s1[e];
    red[1][at + e] = s2[e];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < sh.c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < rows; ++q) {
      a += red[0][q * sh.c + ch];
      b += red[1][q * sh.c + ch];
    }
    part[(size_t)(r.g * sh.c + ch) * sh.slices + r.s] = make_float2(a, b);
  }
}

// NHWC: mean, a and bias of the VW channels thread t keeps, of group g.
template <int VW>
struct Chans {
  float mean[VW], a[VW], b[VW];
  __device__ __forceinline__ Chans(const float4* __restrict__ stat,
                                   const float* __restrict__ bias, const Shape& sh, int g) {
    const int c0 = first_channel<VW>(sh);
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const float4 st = stat[g * sh.c + c0 + e];
      mean[e] = st.x;
      a[e] = st.z;
      b[e] = bias[c0 + e];
    }
  }
};

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

template <typename T, int VW, bool NHWC>
__global__ void __launch_bounds__(256) bn_stats(const T* __restrict__ x, float2* __restrict__ part,
                                                Shape sh) {
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  if constexpr (NHWC) {
    const Span r = span_of(sh, blockIdx.x);
    float s1[VW] = {}, s2[VW] = {};
    for_each_pixel<VW>(sh, r.p0, r.count, sh.w, [&](const size_t* idx, const int*, const int*,
                                                    const bool* ok) {
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
          s1[e] += f;
          s2[e] = fmaf(f, f, s2[e]);
        }
      }
    });
    store_channels<VW>(s1, s2, part, sh, r);
  } else {
    const Run r = run_of(sh, blockIdx.x);
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

// NHWC: the readers take x's vector idx of the pixel at row i, column j,
// whose channel vector is idx - (i w + j) C / VW (a pooled call's backward
// walks the pooled gradient's windows instead: for_each_window). dy itself:
template <typename T, int VW>
struct DirectNhwc {
  Pack<T, VW> p;
  __device__ __forceinline__ void load(const T* __restrict__ dy, const Shape&, size_t idx, int,
                                       int) {
    p = reinterpret_cast<const Pack<T, VW>*>(dy)[idx];
  }
  __device__ __forceinline__ float get(int e) const { return to_f<T>(p.v[e]); }
};

// NHWC: g of a nearest 2x upsample, [n, 2h, 2w, c]: the four vectors of the
// pixel's 2x2 block.
template <typename T, int VW>
struct UpsampledNhwc {
  Pack<T, VW> q[4];  // g00, g01, g10, g11
  __device__ __forceinline__ void load(const T* __restrict__ dy, const Shape& sh, size_t idx,
                                       int i, int j) {
    const int cvs = sh.c / VW;
    const size_t cv = idx - ((size_t)i * sh.w + j) * cvs;
    const size_t tl = ((size_t)2 * i * 2 * sh.w + 2 * j) * cvs + cv;
    const size_t below = (size_t)2 * sh.w * cvs;
    const Pack<T, VW>* dv = reinterpret_cast<const Pack<T, VW>*>(dy);
    q[0] = dv[tl];
    q[1] = dv[tl + cvs];
    q[2] = dv[tl + below];
    q[3] = dv[tl + below + cvs];
  }
  __device__ __forceinline__ float get(int e) const {
    return summed_grad<T>(q[0].v[e], q[1].v[e], q[2].v[e], q[3].v[e]);
  }
};

template <typename T, int VW, bool NHWC>
__global__ void __launch_bounds__(256) bn_apply(const T* __restrict__ x,
                                                const float4* __restrict__ stat,
                                                const float* __restrict__ bias, T* __restrict__ y,
                                                Shape sh, float slope) {
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  Pack<T, VW>* yv = reinterpret_cast<Pack<T, VW>*>(y);
  if constexpr (NHWC) {
    const Span r = span_of(sh, blockIdx.x);
    const Chans<VW> ch(stat, bias, sh, r.g);
    for_each_pixel<VW>(sh, r.p0, r.count, sh.w, [&](const size_t* idx, const int*, const int*,
                                                    const bool* ok) {
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
          out.v[e] = act<T>(fmaf(to_f<T>(v[u].v[e]) - ch.mean[e], ch.a[e], ch.b[e]), slope);
        yv[idx[u]] = out;
      }
    });
  } else {
    const Run r = run_of(sh, blockIdx.x);
    const float4 st = stat[r.g * sh.c + r.c];
    const float mean = st.x, a = st.z, b = bias[r.c];
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
}

// y_p [n, c, h / 2, w / 2], walked in its own units: with rows, VW / 2
// outputs from a vector of each of two rows of x; else one from four
// elements. NHWC: y_p [n, h / 2, w / 2, c], a vector of channels of each
// output pixel from the four vectors of its window.
template <typename T, int VW, bool ROWS, bool NHWC>
__global__ void __launch_bounds__(256) bn_apply_pool(const T* __restrict__ x,
                                                     const float4* __restrict__ stat,
                                                     const float* __restrict__ bias,
                                                     T* __restrict__ y, Shape sh, float slope) {
  if constexpr (NHWC) {
    const Span r = span_of(sh, blockIdx.x);
    const Chans<VW> ch(stat, bias, sh, r.g);
    const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
    const size_t right = sh.c / VW, below = (size_t)sh.w * right;
    for_each_window<VW>(sh, r, [&](const size_t* idx, const size_t* top, const bool* ok) {
      Pack<T, VW> v[UNROLL][4];  // x at (2i, 2j), (2i, 2j + 1), (2i + 1, 2j), (2i + 1, 2j + 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!ok[u]) continue;
        v[u][0] = xv[top[u]];
        v[u][1] = xv[top[u] + right];
        v[u][2] = xv[top[u] + below];
        v[u][3] = xv[top[u] + below + right];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!ok[u]) continue;
        Pack<T, VW> out;
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          float f[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            f[k] = to_f<T>(act<T>(fmaf(to_f<T>(v[u][k].v[e]) - ch.mean[e], ch.a[e], ch.b[e]),
                                  slope));
          out.v[e] = from_f<T>(__fmul_rn(sum4(f[0], f[1], f[2], f[3]), 0.25f));
        }
        reinterpret_cast<Pack<T, VW>*>(y)[idx[u]] = out;
      }
    });
  } else {
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
}

// y_u [n, c, 2h, 2w]: each element of x's vector to its 2x2 block. NHWC:
// y_u [n, 2h, 2w, c], each vector of channels to the four pixels of its block.
template <typename T, int VW, bool ROWS, bool NHWC>
__global__ void __launch_bounds__(256) bn_apply_up(const T* __restrict__ x,
                                                   const float4* __restrict__ stat,
                                                   const float* __restrict__ bias,
                                                   T* __restrict__ y, Shape sh, float slope) {
  if constexpr (NHWC) {
    const Span r = span_of(sh, blockIdx.x);
    const Chans<VW> ch(stat, bias, sh, r.g);
    const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
    Pack<T, VW>* yv = reinterpret_cast<Pack<T, VW>*>(y);
    const int cvs = sh.c / VW, cv = (int)threadIdx.x % cvs;
    const size_t below = (size_t)2 * sh.w * cvs;  // a row of y_u, in vectors
    for_each_pixel<VW>(sh, r.p0, r.count, sh.w, [&](const size_t* idx, const int* pi,
                                                    const int* pj, const bool* ok) {
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
          out.v[e] = act<T>(fmaf(to_f<T>(v[u].v[e]) - ch.mean[e], ch.a[e], ch.b[e]), slope);
        const size_t tl = ((size_t)2 * pi[u] * 2 * sh.w + 2 * pj[u]) * cvs + cv;
        yv[tl] = out;
        yv[tl + cvs] = out;
        yv[tl + below] = out;
        yv[tl + below + cvs] = out;
      }
    });
  } else {
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
}

// The run's partial sums of dy' and dy' (x - mean), dy read through G
// (Direct, Pooled or Upsampled); with `dsum`, also the values G gives,
// stored in x's layout for bn_bwd_dx.
template <typename T, int VW, class G, bool NHWC>
__device__ __forceinline__ void bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                                           const float4* __restrict__ stat,
                                           const float* __restrict__ bias,
                                           float2* __restrict__ part, T* __restrict__ dsum,
                                           const Shape& sh, float slope) {
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  if constexpr (NHWC) {
    const Span r = span_of(sh, blockIdx.x);
    const Chans<VW> ch(stat, bias, sh, r.g);
    float s1[VW] = {}, s2[VW] = {};
    for_each_pixel<VW>(sh, r.p0, r.count, sh.w, [&](const size_t* idx, const int* pi,
                                                    const int* pj, const bool* ok) {
      Pack<T, VW> v[UNROLL];
      G d[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (ok[u]) {
          v[u] = xv[idx[u]];
          d[u].load(dy, sh, idx[u], pi[u], pj[u]);
        }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!ok[u]) continue;
        Pack<T, VW> kept;
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const float xc = to_f<T>(v[u].v[e]) - ch.mean[e];
          float g = d[u].get(e);
          if (dsum != nullptr) kept.v[e] = from_f<T>(g);
          if (!passes<T>(fmaf(xc, ch.a[e], ch.b[e]), slope)) g *= slope;
          s1[e] += g;
          s2[e] = fmaf(g, xc, s2[e]);
        }
        if (dsum != nullptr) reinterpret_cast<Pack<T, VW>*>(dsum)[idx[u]] = kept;
      }
    });
    store_channels<VW>(s1, s2, part, sh, r);
  } else {
    const Run r = run_of(sh, blockIdx.x);
    const float4 st = stat[r.g * sh.c + r.c];
    const float mean = st.x, a = st.z, b = bias[r.c];
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
}

// NHWC, a pooled call's backward: each thread takes whole 2x2 windows
// (for_each_window), the pooled gradient's vector once and x's four, so the
// four pixels of a window share one load of dy_p. bwd_reduce_pool_nhwc sums
// dy' and dy' (x - mean) of the run, a window's pixels in the order of
// bn_apply_pool's sum; bwd_dx_pool_nhwc writes the four pixels' dx from
// bn_bwd_fold's coefficients.
template <typename T, int VW, typename F>
__device__ __forceinline__ void for_each_window_grad(const T* __restrict__ x,
                                                     const T* __restrict__ dy, const Shape& sh,
                                                     const Span& r, F&& body) {
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  const Pack<T, VW>* dv = reinterpret_cast<const Pack<T, VW>*>(dy);
  const size_t right = sh.c / VW, below = (size_t)sh.w * right;
  for_each_window<VW>(sh, r, [&](const size_t* out, const size_t* top, const bool* ok) {
    Pack<T, VW> v[UNROLL][4], d[UNROLL];
    size_t at[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u][0] = top[u];
      at[u][1] = top[u] + right;
      at[u][2] = top[u] + below;
      at[u][3] = top[u] + below + right;
      if (!ok[u]) continue;
      d[u] = dv[out[u]];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[u][k] = xv[at[u][k]];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) body(v[u], d[u], at[u]);
  });
}

template <typename T, int VW>
__device__ __forceinline__ void bwd_reduce_pool_nhwc(const T* __restrict__ x,
                                                     const T* __restrict__ dy,
                                                     const float4* __restrict__ stat,
                                                     const float* __restrict__ bias,
                                                     float2* __restrict__ part, const Shape& sh,
                                                     float slope) {
  const Span r = span_of(sh, blockIdx.x);
  const Chans<VW> ch(stat, bias, sh, r.g);
  float s1[VW] = {}, s2[VW] = {};
  for_each_window_grad<T, VW>(x, dy, sh, r, [&](const Pack<T, VW>* v, const Pack<T, VW>& d,
                                                const size_t*) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xc = to_f<T>(v[k].v[e]) - ch.mean[e];
        float g = pooled_grad<T>(d.v[e]);
        if (!passes<T>(fmaf(xc, ch.a[e], ch.b[e]), slope)) g *= slope;
        s1[e] += g;
        s2[e] = fmaf(g, xc, s2[e]);
      }
  });
  store_channels<VW>(s1, s2, part, sh, r);
}

template <typename T, int VW>
__device__ __forceinline__ void bwd_dx_pool_nhwc(const T* __restrict__ x,
                                                 const T* __restrict__ dy,
                                                 const float4* __restrict__ stat,
                                                 const float* __restrict__ bias,
                                                 const float2* __restrict__ coef,
                                                 T* __restrict__ dx, const Shape& sh,
                                                 float slope) {
  const Span r = span_of(sh, blockIdx.x);
  const Chans<VW> ch(stat, bias, sh, r.g);
  float k1[VW], k2[VW];
  const int c0 = first_channel<VW>(sh);
#pragma unroll
  for (int e = 0; e < VW; ++e) {
    const float2 k = coef[r.g * sh.c + c0 + e];
    k1[e] = k.x;
    k2[e] = k.y;
  }
  Pack<T, VW>* ov = reinterpret_cast<Pack<T, VW>*>(dx);
  for_each_window_grad<T, VW>(x, dy, sh, r, [&](const Pack<T, VW>* v, const Pack<T, VW>& d,
                                                const size_t* at) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Pack<T, VW> out;
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const float xc = to_f<T>(v[k].v[e]) - ch.mean[e];
        float g = pooled_grad<T>(d.v[e]);
        if (!passes<T>(fmaf(xc, ch.a[e], ch.b[e]), slope)) g *= slope;
        out.v[e] = from_f<T>(fmaf(xc, k2[e], fmaf(ch.a[e], g, k1[e])));
      }
      ov[at[k]] = out;
    }
  });
}

// A reader's layout: G for x in NCHW (with `rows`), or its NHWC counterpart.
template <bool NHWC, class NCHW_G, class NHWC_G>
using Reader = typename std::conditional<NHWC, NHWC_G, NCHW_G>::type;

template <typename T, int VW, bool NHWC>
__global__ void __launch_bounds__(256) bn_bwd_reduce(const T* __restrict__ x,
                                                     const T* __restrict__ dy,
                                                     const float4* __restrict__ stat,
                                                     const float* __restrict__ bias,
                                                     float2* __restrict__ part, Shape sh,
                                                     float slope) {
  bwd_reduce<T, VW, Reader<NHWC, Direct<T, VW>, DirectNhwc<T, VW>>, NHWC>(x, dy, stat, bias,
                                                                           part, nullptr, sh,
                                                                           slope);
}

template <typename T, int VW, bool ROWS, bool NHWC>
__global__ void __launch_bounds__(256) bn_bwd_reduce_pool(const T* __restrict__ x,
                                                          const T* __restrict__ dy,
                                                          const float4* __restrict__ stat,
                                                          const float* __restrict__ bias,
                                                          float2* __restrict__ part, Shape sh,
                                                          float slope) {
  if constexpr (NHWC)
    bwd_reduce_pool_nhwc<T, VW>(x, dy, stat, bias, part, sh, slope);
  else
    bwd_reduce<T, VW, Pooled<T, VW, ROWS>, false>(x, dy, stat, bias, part, nullptr, sh, slope);
}

template <typename T, int VW, bool ROWS, bool NHWC>
__global__ void __launch_bounds__(256) bn_bwd_reduce_up(const T* __restrict__ x,
                                                        const T* __restrict__ dy,
                                                        const float4* __restrict__ stat,
                                                        const float* __restrict__ bias,
                                                        float2* __restrict__ part,
                                                        T* __restrict__ dsum, Shape sh,
                                                        float slope) {
  bwd_reduce<T, VW, Reader<NHWC, Upsampled<T, VW, ROWS>, UpsampledNhwc<T, VW>>, NHWC>(
      x, dy, stat, bias, part, dsum, sh, slope);
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

// NHWC: one warp a channel folds each group's partials of bn_bwd_reduce
// into bn_bwd_dx's two coefficients, coef[g, c] = {k1, k2}, and every
// group's into dweight and dbias (null: not asked for): the NCHW body's
// arithmetic, in its order.
__global__ void __launch_bounds__(256) bn_bwd_fold(const float2* __restrict__ part,
                                                   const float4* __restrict__ stat,
                                                   float2* __restrict__ coef,
                                                   float* __restrict__ dweight,
                                                   float* __restrict__ dbias, int c_count,
                                                   int groups, int slices, int count) {
  const int c = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= c_count) return;
  const float nf = (float)count;
  float dw = 0.f, db = 0.f;
  for (int g = 0; g < groups; ++g) {
    const float2 s = fold(part + (size_t)(g * c_count + c) * slices, slices);
    const float4 st = stat[g * c_count + c];
    if (lane == 0)
      coef[g * c_count + c] = make_float2(-st.z * s.x / nf, -st.z * st.y * st.y * s.y / nf * st.w);
    dw = fmaf(st.y, s.y, dw);
    db += s.x;
  }
  if (lane == 0) {
    if (dweight != nullptr) dweight[c] = dw;
    if (dbias != nullptr) dbias[c] = db;
  }
}

// NHWC: dx of the run from bn_bwd_fold's coefficients.
template <typename T, int VW>
__device__ __forceinline__ void bwd_dx_nhwc(const T* __restrict__ x, const T* __restrict__ dy,
                                            const float4* __restrict__ stat,
                                            const float* __restrict__ bias,
                                            const float2* __restrict__ coef, T* __restrict__ dx,
                                            const Shape& sh, float slope) {
  const Span r = span_of(sh, blockIdx.x);
  const Chans<VW> ch(stat, bias, sh, r.g);
  float k1[VW], k2[VW];
  const int c0 = first_channel<VW>(sh);
#pragma unroll
  for (int e = 0; e < VW; ++e) {
    const float2 k = coef[r.g * sh.c + c0 + e];
    k1[e] = k.x;
    k2[e] = k.y;
  }
  const Pack<T, VW>* xv = reinterpret_cast<const Pack<T, VW>*>(x);
  const Pack<T, VW>* dv = reinterpret_cast<const Pack<T, VW>*>(dy);
  Pack<T, VW>* ov = reinterpret_cast<Pack<T, VW>*>(dx);
  for_each_pixel<VW>(sh, r.p0, r.count, sh.w, [&](const size_t* idx, const int*, const int*,
                                                  const bool* ok) {
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
        const float xc = to_f<T>(v[u].v[e]) - ch.mean[e];
        float g = to_f<T>(d[u].v[e]);
        if (!passes<T>(fmaf(xc, ch.a[e], ch.b[e]), slope)) g *= slope;
        out.v[e] = from_f<T>(fmaf(xc, k2[e], fmaf(ch.a[e], g, k1[e])));
      }
      ov[idx[u]] = out;
    }
  });
}

template <typename T, int VW, bool NHWC>
__global__ void __launch_bounds__(256) bn_bwd_dx(const T* __restrict__ x,
                                                 const T* __restrict__ dy,
                                                 const float4* __restrict__ stat,
                                                 const float* __restrict__ bias,
                                                 const float2* __restrict__ part,
                                                 const float2* __restrict__ coef,
                                                 T* __restrict__ dx, float* __restrict__ dweight,
                                                 float* __restrict__ dbias, Shape sh, int count,
                                                 float slope) {
  if constexpr (NHWC)
    bwd_dx_nhwc<T, VW>(x, dy, stat, bias, coef, dx, sh, slope);
  else
    bwd_dx<T, VW, Direct<T, VW>>(x, dy, stat, bias, part, dx, dweight, dbias, sh, count, slope);
}

template <typename T, int VW, bool ROWS, bool NHWC>
__global__ void __launch_bounds__(256) bn_bwd_dx_pool(const T* __restrict__ x,
                                                      const T* __restrict__ dy,
                                                      const float4* __restrict__ stat,
                                                      const float* __restrict__ bias,
                                                      const float2* __restrict__ part,
                                                      const float2* __restrict__ coef,
                                                      T* __restrict__ dx,
                                                      float* __restrict__ dweight,
                                                      float* __restrict__ dbias, Shape sh,
                                                      int count, float slope) {
  if constexpr (NHWC)
    bwd_dx_pool_nhwc<T, VW>(x, dy, stat, bias, coef, dx, sh, slope);
  else
    bwd_dx<T, VW, Pooled<T, VW, ROWS>>(x, dy, stat, bias, part, dx, dweight, dbias, sh, count,
                                       slope);
}

// The cut's checks: NCHW, runs of samples and vectors of a plane, whole
// warps; NHWC, runs of a group's rows, whole channel vectors, a whole number
// of them a block.
bool shape_ok(const Shape& sh, int vec, int threads, bool nhwc) {
  const int per_group = sh.groups > 0 ? sh.n / sh.groups : 0;
  if (!(sh.n > 0 && sh.c > 0 && sh.hw > 0 && sh.groups > 0 && sh.n % sh.groups == 0 &&
        sh.slices > 0 && sh.per_slice > 0 && vec > 0 && threads >= 1 && threads <= 256))
    return false;
  if (nhwc) {
    if (sh.w < 1 || sh.hw % sh.w || sh.c % vec || threads % (sh.c / vec)) return false;
    const int rows = per_group * (sh.hw / sh.w);
    return (sh.slices - 1) * sh.per_slice < rows && sh.slices * sh.per_slice >= rows;
  }
  return (sh.slices - 1) * sh.per_slice < per_group && sh.slices * sh.per_slice >= per_group &&
         sh.hw % vec == 0 && threads >= 32 && threads % 32 == 0;
}

// A resample the plane allows: a pool needs even H and W (NHWC: and runs of
// an even number of rows), an upsample any.
bool resample_ok(const Shape& sh, int resample, bool nhwc) {
  if (resample == NONE) return true;
  if (sh.w < 1 || sh.hw % sh.w) return false;
  if (resample == POOL)
    return sh.w % 2 == 0 && (sh.hw / sh.w) % 2 == 0 && (!nhwc || sh.per_slice % 2 == 0);
  return resample == UP;
}

// Rows of the resampled tensor `t` in vectors (NCHW): each of x's vectors in
// one row and t aligned to 16 bytes.
bool rows_of(const Shape& sh, int vec, int resample, const void* t, bool nhwc) {
  return !nhwc && resample != NONE && vec > 1 && sh.w % vec == 0 && (size_t)t % 16 == 0;
}

// NHWC reads and writes every tensor in vectors: each aligned to 16 bytes.
bool aligned(int vec, bool nhwc, const void* a, const void* b = nullptr) {
  return !nhwc || vec == 1 || ((size_t)a % 16 == 0 && (size_t)b % 16 == 0);
}

int grid_of(const Shape& sh, bool nhwc) {
  return nhwc ? sh.groups * sh.slices : sh.groups * sh.c * sh.slices;
}

// One launcher a streaming kernel, instantiated for each (dtype, vector,
// rows, layout); the kernel follows `resample`.
template <typename T, int VW, bool ROWS, bool NHWC>
struct Stats {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, void* part) {
    bn_stats<T, VW, NHWC><<<grid_of(sh, NHWC), threads, 0, s>>>((const T*)x, (float2*)part, sh);
  }
};

template <typename T, int VW, bool ROWS, bool NHWC>
struct Apply {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* stat,
                  const float* bias, void* y, int resample, float slope) {
    const T* xt = (const T*)x;
    const float4* st = (const float4*)stat;
    const int grid = grid_of(sh, NHWC);
    if (resample == POOL)
      bn_apply_pool<T, VW, ROWS, NHWC><<<grid, threads, 0, s>>>(xt, st, bias, (T*)y, sh, slope);
    else if (resample == UP)
      bn_apply_up<T, VW, ROWS, NHWC><<<grid, threads, 0, s>>>(xt, st, bias, (T*)y, sh, slope);
    else
      bn_apply<T, VW, NHWC><<<grid, threads, 0, s>>>(xt, st, bias, (T*)y, sh, slope);
  }
};

template <typename T, int VW, bool ROWS, bool NHWC>
struct BwdReduce {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* dy,
                  const void* stat, const float* bias, void* part, void* dsum, int resample,
                  float slope) {
    const T *xt = (const T*)x, *dt = (const T*)dy;
    const float4* st = (const float4*)stat;
    const int grid = grid_of(sh, NHWC);
    if (resample == POOL)
      bn_bwd_reduce_pool<T, VW, ROWS, NHWC><<<grid, threads, 0, s>>>(xt, dt, st, bias,
                                                                     (float2*)part, sh, slope);
    else if (resample == UP)
      bn_bwd_reduce_up<T, VW, ROWS, NHWC><<<grid, threads, 0, s>>>(
          xt, dt, st, bias, (float2*)part, (T*)dsum, sh, slope);
    else
      bn_bwd_reduce<T, VW, NHWC><<<grid, threads, 0, s>>>(xt, dt, st, bias, (float2*)part, sh,
                                                          slope);
  }
};

template <typename T, int VW, bool ROWS, bool NHWC>
struct BwdDx {
  static void run(cudaStream_t s, int threads, const Shape& sh, const void* x, const void* dy,
                  const void* stat, const float* bias, const void* part, const void* coef,
                  void* dx, float* dweight, float* dbias, int count, int resample, float slope) {
    const T *xt = (const T*)x, *dt = (const T*)dy;
    const float4* st = (const float4*)stat;
    const float2 *pt = (const float2*)part, *ct = (const float2*)coef;
    const int grid = grid_of(sh, NHWC);
    if (resample == POOL)
      bn_bwd_dx_pool<T, VW, ROWS, NHWC><<<grid, threads, 0, s>>>(
          xt, dt, st, bias, pt, ct, (T*)dx, dweight, dbias, sh, count, slope);
    else
      bn_bwd_dx<T, VW, NHWC><<<grid, threads, 0, s>>>(xt, dt, st, bias, pt, ct, (T*)dx, dweight,
                                                      dbias, sh, count, slope);
  }
};

// L<T, VW, ROWS, NHWC>::run for dtype code `dtype` (0 float32, 1 bfloat16,
// 2 float16), `vec` elements a vector (16 bytes of T, or 1), `rows` and
// `nhwc`; the launch's error.
template <template <typename, int, bool, bool> class L, typename... A>
int dispatch(int dtype, int vec, bool rows, bool nhwc, int device, void* stream, int threads,
             const Shape& sh, A... args) {
  if (!shape_ok(sh, vec, threads, nhwc)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nhwc) {
    if (dtype == 0 && vec == 4) L<float, 4, false, true>::run(s, threads, sh, args...);
    else if (dtype == 0 && vec == 1) L<float, 1, false, true>::run(s, threads, sh, args...);
    else if (dtype == 1 && vec == 8) L<bf16, 8, false, true>::run(s, threads, sh, args...);
    else if (dtype == 1 && vec == 1) L<bf16, 1, false, true>::run(s, threads, sh, args...);
    else if (dtype == 2 && vec == 8) L<f16, 8, false, true>::run(s, threads, sh, args...);
    else if (dtype == 2 && vec == 1) L<f16, 1, false, true>::run(s, threads, sh, args...);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (dtype == 0 && vec == 4 && rows) L<float, 4, true, false>::run(s, threads, sh, args...);
  else if (dtype == 0 && vec == 4) L<float, 4, false, false>::run(s, threads, sh, args...);
  else if (dtype == 0 && vec == 1) L<float, 1, false, false>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 8 && rows) L<bf16, 8, true, false>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 8) L<bf16, 8, false, false>::run(s, threads, sh, args...);
  else if (dtype == 1 && vec == 1) L<bf16, 1, false, false>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 8 && rows) L<f16, 8, true, false>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 8) L<f16, 8, false, false>::run(s, threads, sh, args...);
  else if (dtype == 2 && vec == 1) L<f16, 1, false, false>::run(s, threads, sh, args...);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The layout transposes of models/blocks.py::as_layout (ops/layout_cuda.py):
// each of n images, a [rows, cols] matrix of E (2- or 4-byte elements),
// written as [cols, rows]: rows C and cols H W from NCHW to channels-last,
// the other way back. A block moves a 32 x 32 tile through shared memory,
// reading rows of the source and writing rows of the destination, so both
// sides move whole 32-element runs.
template <typename E>
__global__ void __launch_bounds__(256) relayout(const E* __restrict__ in, E* __restrict__ out,
                                                int rows, int cols) {
  __shared__ E tile[32][33];
  const size_t image = (size_t)blockIdx.z * rows * cols;
  int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 32 + threadIdx.y;
#pragma unroll
  for (int k = 0; k < 32; k += 8)
    if (x < cols && y + k < rows)
      tile[threadIdx.y + k][threadIdx.x] = in[image + (size_t)(y + k) * cols + x];
  __syncthreads();
  x = blockIdx.y * 32 + threadIdx.x;
  y = blockIdx.x * 32 + threadIdx.y;
#pragma unroll
  for (int k = 0; k < 32; k += 8)
    if (x < rows && y + k < cols)
      out[image + (size_t)(y + k) * rows + x] = tile[threadIdx.x][threadIdx.y + k];
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` (bn_bwd_dx_launch in NHWC two: bn_bwd_fold, then the streaming
// kernel) and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises. x, dx, dsum: [n, c, hw] in `dtype` (0
// float32, 1 bfloat16, 2 float16), contiguous (nhwc 0) or channels-last
// ([n, hw / w, w, c] in memory, nhwc 1), 16-byte aligned where vec > 1; y
// and dy the same, or, with `resample` (0 none, 1 the 2x2 average pool, 2
// the nearest 2x upsample; hw = h w, w the plane's width), the resampled
// [n, c, h / 2, w / 2] or [n, c, 2h, 2w] in x's layout, any alignment in
// NCHW; part: float2 [groups * c * slices]; stat: float4 [groups, c]; coef
// (NHWC): float2 [groups, c]; weight, bias, the running statistics, dweight
// and dbias: float32 [c]. The streaming kernels run groups * c * slices
// blocks (NHWC: groups * slices) of `threads`.
extern "C" {

int bn_stats_launch(const void* x, void* part, int n, int c, int hw, int w, int groups,
                    int slices, int per_slice, int vec, int threads, int nhwc, int dtype,
                    int device, void* stream) {
  const Shape sh{n, c, hw, groups, slices, per_slice, w};
  if (nhwc && (sh.w < 1 || !aligned(vec, nhwc, x))) return (int)cudaErrorInvalidValue;
  return dispatch<Stats>(dtype, vec, false, nhwc != 0, device, stream, threads, sh, x, part);
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
                    int hw, int w, int groups, int slices, int per_slice, int vec, int threads,
                    int nhwc, int resample, float slope, int dtype, int device, void* stream) {
  const Shape sh{n, c, hw, groups, slices, per_slice, w};
  if (!resample_ok(sh, resample, nhwc) || !aligned(vec, nhwc, x, y))
    return (int)cudaErrorInvalidValue;
  return dispatch<Apply>(dtype, vec, rows_of(sh, vec, resample, y, nhwc), nhwc != 0, device,
                         stream, threads, sh, x, stat, bias, y, resample, slope);
}

// dy: the gradient of the resampled output; with resample 2, dsum (x's
// shape and layout) receives the gradient of the BatchNorm's output, for
// bn_bwd_dx_launch's dy (resample 0). dsum null otherwise.
int bn_bwd_reduce_launch(const void* x, const void* dy, const void* stat, const float* bias,
                         void* part, void* dsum, int n, int c, int hw, int w, int groups,
                         int slices, int per_slice, int vec, int threads, int nhwc, int resample,
                         float slope, int dtype, int device, void* stream) {
  const Shape sh{n, c, hw, groups, slices, per_slice, w};
  if (!resample_ok(sh, resample, nhwc) || (resample == UP) != (dsum != nullptr) ||
      !aligned(vec, nhwc, x, dy) || (dsum != nullptr && !aligned(vec, nhwc, dsum)))
    return (int)cudaErrorInvalidValue;
  return dispatch<BwdReduce>(dtype, vec, rows_of(sh, vec, resample, dy, nhwc), nhwc != 0, device,
                             stream, threads, sh, x, dy, stat, bias, part, dsum, resample, slope);
}

// dx null: dweight and dbias only; dweight, dbias null: not computed.
// resample 0 or 1 (an upsample's dy is bn_bwd_reduce_launch's dsum). coef:
// NHWC's scratch for bn_bwd_fold (null in NCHW).
int bn_bwd_dx_launch(const void* x, const void* dy, const void* stat, const float* bias,
                     const void* part, void* coef, void* dx, float* dweight, float* dbias, int n,
                     int c, int hw, int w, int groups, int slices, int per_slice, int vec,
                     int threads, int nhwc, int resample, float slope, int dtype, int device,
                     void* stream) {
  const Shape sh{n, c, hw, groups, slices, per_slice, w};
  if (!resample_ok(sh, resample, nhwc) || resample == UP || (nhwc != 0) != (coef != nullptr) ||
      !aligned(vec, nhwc, x, dy) || (dx != nullptr && !aligned(vec, nhwc, dx)))
    return (int)cudaErrorInvalidValue;
  const int count = n / (groups > 0 ? groups : 1) * hw;
  if (nhwc) {
    if (!shape_ok(sh, vec, threads, true)) return (int)cudaErrorInvalidValue;
    int err = (int)cudaSetDevice(device);
    if (err) return err;
    const int blocks = (c * 32 + 255) / 256;
    bn_bwd_fold<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float2*)part, (const float4*)stat, (float2*)coef, dweight, dbias, c, groups,
        slices, count);
    err = (int)cudaGetLastError();
    if (err || dx == nullptr) return err;
  }
  return dispatch<BwdDx>(dtype, vec, rows_of(sh, vec, resample, dy, nhwc), nhwc != 0, device,
                         stream, threads, sh, x, dy, stat, bias, part, (const void*)coef, dx,
                         dweight, dbias, count, resample, slope);
}

// in, out: n images of rows x cols elements of elem_bytes (2 or 4) each;
// out[i][c][r] = in[i][r][c].
int relayout_launch(const void* in, void* out, int n, int rows, int cols, int elem_bytes,
                    int device, void* stream) {
  if (n < 1 || n > 65535 || rows < 1 || cols < 1 || (rows + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32, n), block(32, 8);
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    relayout<unsigned short><<<grid, block, 0, s>>>((const unsigned short*)in,
                                                   (unsigned short*)out, rows, cols);
  else if (elem_bytes == 4)
    relayout<unsigned int><<<grid, block, 0, s>>>((const unsigned int*)in, (unsigned int*)out,
                                                 rows, cols);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
