// Total-correlation (β-TC-VAE) logsumexp kernels for Hopper (sm_90a).
//
// These three kernels replace the TPU Pallas kernels of
// intro_tc_vae_tpu/ops/tc_pallas.py:
//   tc_fwd      <- _tc_fwd_kernel      (tc_pallas.py:109)
//   tc_bwd_dz   <- _tc_bwd_dz_kernel   (tc_pallas.py:174, with _dp_block :157)
//   tc_bwd_dmu  <- _tc_bwd_dmu_kernel  (tc_pallas.py:202)
//
// They compute, without ever writing the [B_j, B_i, Z] tensor,
//   P[j,i,l] = max(-0.5*(log v[j,l] + (z[j,l]-mu[i,l])^2 / v[j,l] + log 2π), -50),
//   v = max(exp(logvar), 1e-4),
//   lm[j,l]  = logsumexp_i(iw[j,i] + P[j,i,l])        (marginals)
//   lj[j]    = logsumexp_i(iw[j,i] + sum_l P[j,i,l])  (joint)
//   pm[j]    = sum_l lm[j,l]
// and the gradients of (pm, lj) with incoming g_m[j], g_j[j]:
//   dP = g_m[j]*exp(iw+P-lm[j,l]) + g_j[j]*exp(iw+sum_l P-lj[j]), 0 where the
//        raw P <= -50 (the clamp passes no gradient),
//   dz[j,l]      = sum_i dP * (-(z-mu)/v)
//   dlogvar[j,l] = 1[v not floored] * sum_i dP * (-0.5)*(1 - (z-mu)^2/v)
//   dmu[i,l]     = sum_j dP * (z-mu)/v
// iw is the column-structured stratified log-weight matrix
// (intro_tc_vae_tpu/ops/density.py), generated from the row and column
// index with its float32 values; row_off and global_batch place local rows
// in a larger batch.
//
// Design. On the TPU the grid runs in order and the online logsumexp and
// the gradient sums are carried in VMEM scratch across grid steps. Here
// blocks run in no order, so each block owns one output row and loops
// over the whole reduced axis itself: tc_fwd and tc_bwd_dz take one block
// per z row j and reduce over i; tc_bwd_dmu takes one block per mu row i
// and reduces over j, so dmu is summed in a fixed order, deterministically
// and without atomics. A thread owns one latent column l (blockDim = Z
// rounded up to a warp, Z <= 1024). The reduced axis is walked in tiles of
// 32 rows; a tile's sum over l of P (needed for the joint term) is a
// 32-wide butterfly reduce-transpose inside each warp (31 shuffles for 32
// sums) and one shared-memory pass across warps, double-buffered so one
// __syncthreads per tile suffices.
//
// Precision. Inputs and outputs are float32; the arithmetic inside is
// float64, and the forward keeps lm and lj in float64 for the backward.
// Where the variance is floored at 1e-4, (z-mu)^2/v reaches ~1e2 before
// the clamp and each gradient term ~1e3 times dP, and terms of both signs
// cancel. A log-density carries |P|*6e-8 of float32 rounding, which exp
// turns into a relative error of each term: an all-float32 version of
// these kernels and the float32 plain version differed by up to 4e-5 on
// small gradient entries (H100), above the 1e-5 the port is held to.
//
// What bounds it on an H100. Work is B_j*B_i*Z elements of ~25 float64
// operations and one or two float64 exps each; bytes are O(B*Z), read from
// L2. At the training shape (B=64, Z=128) that is ~0.5M elements: each
// kernel is bound by launch latency, a few microseconds, and B=64 blocks
// cover half of the 132 SMs. At B in the thousands it becomes bound by the
// float64 pipes (half the float32 rate, and exp in software); a later
// version can keep float32 where the cancellation allows it and give a
// block several rows so that mu (or z) is read from L2 once per rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TILE = 32;        // rows of the reduced axis per tile (= warp size)
constexpr int MAX_WARPS = 32;   // blockDim.x <= 1024
constexpr double LOG_2PI = 1.8378770664093453;
constexpr double LOG_PROB_FLOOR = -50.0;
constexpr double VAR_FLOOR = 1e-4;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct IwConsts {
  float log1m;      // log(1/M), M = global_batch - 1
  float log1n;      // log(1/N), N = dataset_size
  float logstrat;   // log((N-M)/(N*M))
  int special_row;  // M - 1: the row whose column 0 holds logstrat
};

__device__ __forceinline__ double log_iw(int row, int col, const IwConsts& c) {
  if (col == 0) return row == c.special_row ? c.logstrat : c.log1n;
  if (col == 1) return c.logstrat;
  return c.log1m;
}

__device__ __forceinline__ double log_density(double d, double lvf, double inv_v) {
  return -0.5 * (lvf + d * d * inv_v + LOG_2PI);  // unclamped
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x = fmax(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

// v[t] in every lane -> returns, in lane t, the sum over the warp's lanes
// of v[t]. Recursive halving: each step exchanges half of the remaining
// entries with the partner lane, 16+8+4+2+1 shuffles in all. v is clobbered.
__device__ __forceinline__ double warp_transpose_sum(double (&v)[TILE]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const double send = upper ? v[k] : v[k + o];
      const double keep = upper ? v[k + o] : v[k];
      v[k] = keep + __shfl_xor_sync(FULL_MASK, send, o);
    }
  }
  return v[0];
}

// Sum over the block's warps of each warp's transpose-sum: lane t of every
// warp gets the sum over all threads (all l) of r[t]. One __syncthreads;
// the caller alternates buf between tiles.
__device__ __forceinline__ double block_tile_sum(double (&r)[TILE],
                                                 double (*red)[MAX_WARPS][TILE],
                                                 int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  red[buf][warp][lane] = warp_transpose_sum(r);
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < nwarps; ++w) s += red[buf][w][lane];
  return s;
}

struct RowStats {  // per (j, l): log of the floored variance and its inverse
  double lvf, inv_v;
  bool not_floored;
};

__device__ __forceinline__ RowStats row_stats(float logvar) {
  const double e = exp((double)logvar);
  const double v = fmax(e, VAR_FLOOR);
  return RowStats{log(v), 1.0 / v, e > VAR_FLOOR};
}

__global__ void tc_fwd(const float* __restrict__ z, const float* __restrict__ mu,
                       const float* __restrict__ logvar, double* __restrict__ lm,
                       double* __restrict__ lj, float* __restrict__ pm_out,
                       float* __restrict__ lj_out, int B_i, int Z, int row_off,
                       IwConsts c) {
  __shared__ double red[2][MAX_WARPS][TILE];
  const int j = blockIdx.x, l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5, nwarps = blockDim.x >> 5;
  const bool active = l < Z;
  const int row = row_off + j;
  const size_t jl = (size_t)j * Z + l;

  double zl = 0.0;
  RowStats st{0.0, 0.0, false};
  if (active) {
    zl = z[jl];
    st = row_stats(logvar[jl]);
  }
  double m_m = -INFINITY, s_m = 0.0;  // marginal online logsumexp of (j, l)
  double m_j = -INFINITY, s_j = 0.0;  // joint online logsumexp of j (all lanes)

  int buf = 0;
  for (int i0 = 0; i0 < B_i; i0 += TILE, buf ^= 1) {
    double x[TILE], r[TILE];
    double tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int i = i0 + t;
      double p = 0.0;
      if (active && i < B_i) {
        const double d = zl - (double)__ldg(&mu[(size_t)i * Z + l]);
        p = fmax(log_density(d, st.lvf, st.inv_v), LOG_PROB_FLOOR);
      }
      r[t] = p;
      x[t] = i < B_i ? log_iw(row, i, c) + p : -INFINITY;
      tmax = fmax(tmax, x[t]);
    }
    if (active) {
      const double new_m = fmax(m_m, tmax);
      double acc = 0.0;
#pragma unroll
      for (int t = 0; t < TILE; ++t) acc += exp(x[t] - new_m);
      s_m = s_m * exp(m_m - new_m) + acc;
      m_m = new_m;
    }
    // lane t: S = sum_l P[j, i0+t, l]
    const double S = block_tile_sum(r, red, buf);
    const int i = i0 + lane;
    const double xj = i < B_i ? log_iw(row, i, c) + S : -INFINITY;
    const double new_mj = fmax(m_j, warp_max(xj));
    s_j = s_j * exp(m_j - new_mj) + warp_sum(exp(xj - new_mj));
    m_j = new_mj;
  }

  double lm_jl = 0.0;
  if (active) {
    lm_jl = log(s_m) + m_m;
    lm[jl] = lm_jl;
  }
  const double part = warp_sum(lm_jl);
  __syncthreads();  // every warp is done reading red
  if (lane == 0) red[0][warp][0] = part;
  __syncthreads();
  if (l == 0) {
    double tot = 0.0;
    for (int w = 0; w < nwarps; ++w) tot += red[0][w][0];
    const double lj_j = log(s_j) + m_j;
    lj[j] = lj_j;
    pm_out[j] = (float)tot;
    lj_out[j] = (float)lj_j;
  }
}

__global__ void tc_bwd_dz(const float* __restrict__ z, const float* __restrict__ mu,
                          const float* __restrict__ logvar,
                          const double* __restrict__ lm, const double* __restrict__ lj,
                          const float* __restrict__ g_m, const float* __restrict__ g_j,
                          float* __restrict__ dz, float* __restrict__ dlogvar,
                          int B_i, int Z, int row_off, IwConsts c) {
  __shared__ double red[2][MAX_WARPS][TILE];
  const int j = blockIdx.x, l = threadIdx.x;
  const bool active = l < Z;
  const int row = row_off + j;
  const size_t jl = (size_t)j * Z + l;

  double zl = 0.0, lm_jl = 0.0;
  RowStats st{0.0, 0.0, false};
  if (active) {
    zl = z[jl];
    st = row_stats(logvar[jl]);
    lm_jl = lm[jl];
  }
  const double lj_j = lj[j], gm = g_m[j], gj = g_j[j];
  double acc_dz = 0.0, acc_dlv = 0.0;

  int buf = 0;
  for (int i0 = 0; i0 < B_i; i0 += TILE, buf ^= 1) {
    double r[TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int i = i0 + t;
      r[t] = 0.0;
      if (active && i < B_i) {
        const double d = zl - (double)__ldg(&mu[(size_t)i * Z + l]);
        r[t] = fmax(log_density(d, st.lvf, st.inv_v), LOG_PROB_FLOOR);
      }
    }
    const double s_mine = block_tile_sum(r, red, buf);
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const double S = __shfl_sync(FULL_MASK, s_mine, t);
      const int i = i0 + t;
      if (active && i < B_i) {
        const double d = zl - (double)__ldg(&mu[(size_t)i * Z + l]);
        const double p = log_density(d, st.lvf, st.inv_v);
        if (p > LOG_PROB_FLOOR) {
          const double iw = log_iw(row, i, c);
          const double dp = gm * exp(iw + p - lm_jl) + gj * exp(iw + S - lj_j);
          const double q = d * st.inv_v;
          acc_dz -= dp * q;
          acc_dlv += dp * -0.5 * (1.0 - d * q);
        }
      }
    }
  }
  if (active) {
    dz[jl] = (float)acc_dz;
    dlogvar[jl] = st.not_floored ? (float)acc_dlv : 0.0f;
  }
}

__global__ void tc_bwd_dmu(const float* __restrict__ z, const float* __restrict__ mu,
                           const float* __restrict__ logvar,
                           const double* __restrict__ lm, const double* __restrict__ lj,
                           const float* __restrict__ g_m, const float* __restrict__ g_j,
                           float* __restrict__ dmu, int B_j, int Z, int row_off,
                           IwConsts c) {
  __shared__ double red[2][MAX_WARPS][TILE];
  const int i = blockIdx.x, l = threadIdx.x;
  const bool active = l < Z;
  const double mu_il = active ? (double)mu[(size_t)i * Z + l] : 0.0;
  double acc = 0.0;

  int buf = 0;
  for (int j0 = 0; j0 < B_j; j0 += TILE, buf ^= 1) {
    double r[TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const int j = j0 + t;
      r[t] = 0.0;
      if (active && j < B_j) {
        const size_t jl = (size_t)j * Z + l;
        const RowStats st = row_stats(__ldg(&logvar[jl]));
        const double d = (double)__ldg(&z[jl]) - mu_il;
        r[t] = fmax(log_density(d, st.lvf, st.inv_v), LOG_PROB_FLOOR);
      }
    }
    const double s_mine = block_tile_sum(r, red, buf);
#pragma unroll
    for (int t = 0; t < TILE; ++t) {
      const double S = __shfl_sync(FULL_MASK, s_mine, t);
      const int j = j0 + t;
      if (active && j < B_j) {
        const size_t jl = (size_t)j * Z + l;
        const RowStats st = row_stats(__ldg(&logvar[jl]));
        const double d = (double)__ldg(&z[jl]) - mu_il;
        const double p = log_density(d, st.lvf, st.inv_v);
        if (p > LOG_PROB_FLOOR) {
          const double iw = log_iw(row_off + j, i, c);
          const double dp = (double)__ldg(&g_m[j]) * exp(iw + p - __ldg(&lm[jl]))
                          + (double)__ldg(&g_j[j]) * exp(iw + S - __ldg(&lj[j]));
          acc += dp * d * st.inv_v;
        }
      }
    }
  }
  if (active) dmu[(size_t)i * Z + l] = (float)acc;
}

// The weight constants of intro_tc_vae_tpu/ops/tc_pallas.py::_iw_consts,
// computed in double and rounded once to float, as there.
IwConsts iw_consts(int global_batch, long long dataset_size) {
  const double n = (double)dataset_size;
  const int m = global_batch - 1;
  const double strat = (n - m) / (n * m);
  return IwConsts{(float)log(1.0 / m), (float)log(1.0 / n), (float)log(strat), m - 1};
}

int threads_for(int Z) { return ((Z + 31) / 32) * 32; }

int check_args(int B_j, int B_i, int Z, long long dataset_size, int global_batch) {
  if (B_j < 1 || B_i < 1 || Z < 1 || Z > 32 * MAX_WARPS || global_batch < 2 ||
      dataset_size < global_batch) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises. lm [B_j, Z] and lj [B_j] are float64.
extern "C" {

int tc_fwd_launch(const float* z, const float* mu, const float* logvar,
                  double* lm, double* lj, float* pm, float* qz,
                  int B_j, int B_i, int Z, long long dataset_size, int row_off,
                  int global_batch, int device, void* stream) {
  int bad = check_args(B_j, B_i, Z, dataset_size, global_batch);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tc_fwd<<<B_j, threads_for(Z), 0, (cudaStream_t)stream>>>(
      z, mu, logvar, lm, lj, pm, qz, B_i, Z, row_off,
      iw_consts(global_batch, dataset_size));
  return (int)cudaGetLastError();
}

int tc_bwd_dz_launch(const float* z, const float* mu, const float* logvar,
                     const double* lm, const double* lj, const float* g_m,
                     const float* g_j, float* dz, float* dlogvar,
                     int B_j, int B_i, int Z, long long dataset_size, int row_off,
                     int global_batch, int device, void* stream) {
  int bad = check_args(B_j, B_i, Z, dataset_size, global_batch);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tc_bwd_dz<<<B_j, threads_for(Z), 0, (cudaStream_t)stream>>>(
      z, mu, logvar, lm, lj, g_m, g_j, dz, dlogvar, B_i, Z, row_off,
      iw_consts(global_batch, dataset_size));
  return (int)cudaGetLastError();
}

int tc_bwd_dmu_launch(const float* z, const float* mu, const float* logvar,
                      const double* lm, const double* lj, const float* g_m,
                      const float* g_j, float* dmu,
                      int B_j, int B_i, int Z, long long dataset_size, int row_off,
                      int global_batch, int device, void* stream) {
  int bad = check_args(B_j, B_i, Z, dataset_size, global_batch);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tc_bwd_dmu<<<B_i, threads_for(Z), 0, (cudaStream_t)stream>>>(
      z, mu, logvar, lm, lj, g_m, g_j, dmu, B_j, Z, row_off,
      iw_consts(global_batch, dataset_size));
  return (int)cudaGetLastError();
}

}  // extern "C"
