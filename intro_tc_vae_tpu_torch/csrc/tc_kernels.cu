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
// blocks run in no order.
//
// tc_fwd takes one block per z row j and reduces over i itself; a thread
// owns one latent column l (blockDim = Z rounded up to a warp, Z <= 1024).
// The reduced axis is walked in tiles of 32 rows; a tile's sum over l of P
// (the joint term) is a 32-wide butterfly reduce-transpose inside each warp
// (31 shuffles for 32 sums) and one shared-memory pass across warps,
// double-buffered so one __syncthreads per tile suffices. Beside pm and lj it
// writes what the two backward kernels would otherwise recompute per
// (i, j, l): `terms` [B_j, Z] of four float64 each, {z, 1/v, c, c - lm} with
// c = -0.5*(log v + log 2pi), so that P = c - 0.5*d*d/v; and `psum`
// [B_j, B_i] float64, psum[j,i] = sum_l P[j,i,l], the only quantity of the
// backward that needs a sum over l. psum is O(B^2), 32 KB at B = 64 and
// 2.1 GB at B = 16384, against the O(B^2 Z) tensor the kernels avoid.
//
// tc_bwd_dz and tc_bwd_dmu share one shape. With psum given, an output
// element (row, l) needs no other column, so the card is filled by cutting
// three ways: a warp's 32 lanes are 32 consecutive l; the reduced axis
// (i for dz, j for dmu) is cut into at most 16 slices of `slice_len` rows,
// one warp each, all slices of an output in one block; a thread takes `R`
// output rows (R grows with the batch, so that the other operand's row is
// loaded, and converted, once for R rows). A warp walks
// its slice in chunks of 32: lane t first evaluates the joint weight
// g_j*exp(iw + psum - lj) of the chunk's t-th pair, one exp per (j, i), and
// leaves it in the warp's own table in shared memory, from which the loop
// over the chunk reads entry k with one broadcast load (by shuffle a double
// is two instructions: 6 % more time at B=2048); the loop body is the density,
// one exp for the marginal weight and the gradient products, with no
// reduction, no barrier and no second pass. Each warp leaves its partial sums
// in shared memory and, after the block's one __syncthreads, the warp of
// slice 0 adds the slices in ascending order. slice_len is a function of the
// reduced length alone (tc_cuda.reduce_slices), the order inside a slice is
// the row order, and there are no atomics: the result does not depend on R,
// the grid, the SM count or row_off, two runs are bit-equal, and a
// rank's dz and dlogvar rows are bit-equal to the single-device kernel's.
//
// Precision. Inputs and outputs are float32; the arithmetic inside is
// float64, and the forward keeps terms, psum and lj in float64 for the
// backward. Where the variance is floored at 1e-4, (z-mu)^2/v reaches ~1e2
// before the clamp and each gradient term ~1e3 times dP, and terms of both
// signs cancel. A log-density carries |P|*6e-8 of float32 rounding, which
// exp turns into a relative error of each term: an all-float32 version of
// these kernels and the float32 plain version differed by up to 4e-5 on
// small gradient entries (H100), above the 1e-5 the port is held to.
//
// What bounds it on an H100. Work is B_j*B_i*Z elements; an element of a
// backward kernel is 23-25 float64 instructions, 15 of them the exp
// (software: a rounding, a two-constant reduction, a degree-11 polynomial),
// beside ~12 others (selects, the load of the joint weight, address and
// loop arithmetic), and bytes are O(B*Z + B^2), read from L2. The card issues
// 64 float64 instructions a clock and SM. At the training shape (B=64, Z=128)
// that is 0.5M elements, ~1 us of issue: the kernels are bound by launch
// latency and by the chain load -> exp -> loop -> barrier of one warp, which
// is why the slices are short (8 rows up to B=128). At B in the thousands
// they are bound by the float64 arithmetic itself: with every load of the
// loop replaced by arithmetic the time is the same (tc_bwd_dz, B=2048). They
// reach about half the float64 rate of the data sheet; a block holds 512
// threads of up to 128 registers, so an SM scheduler has 4 warps to cover the
// latency of each warp's dependent chains (8 exps in flight a warp; unrolling
// to 16 gains 2 % at B=2048 and loses 10 % at B=64).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TILE = 32;        // rows of the reduced axis per tile (= warp size)
constexpr int MAX_WARPS = 32;   // blockDim.x <= 1024
constexpr int MAX_SLICES = 16;  // warps of a backward block, one a slice
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
                       const float* __restrict__ logvar, double2* __restrict__ terms,
                       double* __restrict__ psum, double* __restrict__ lj,
                       float* __restrict__ pm_out, float* __restrict__ lj_out,
                       int B_i, int Z, int row_off, IwConsts c) {
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
    if (warp == 0 && i < B_i) psum[(size_t)j * B_i + i] = S;
    const double xj = i < B_i ? log_iw(row, i, c) + S : -INFINITY;
    const double new_mj = fmax(m_j, warp_max(xj));
    s_j = s_j * exp(m_j - new_mj) + warp_sum(exp(xj - new_mj));
    m_j = new_mj;
  }

  double lm_jl = 0.0;
  if (active) {
    lm_jl = log(s_m) + m_m;
    terms[2 * jl] = make_double2(zl, st.inv_v);
    const double c_jl = -0.5 * (st.lvf + LOG_2PI);
    terms[2 * jl + 1] = make_double2(c_jl, c_jl - lm_jl);
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

// exp(x) for |x| <= 700 without a branch, so that the exps of an unrolled
// loop interleave (the library's exp ends in a range check that the compiler
// turns into a branch around each call). k = round(x / ln 2) is read from the
// low word of x / ln 2 + 1.5 * 2^52; r = x - k ln 2 with ln 2 in two parts;
// exp(r), |r| <= 0.347, by its Taylor polynomial of degree 11 (the next term
// is 6e-15 of the result); 2^k goes into the exponent bits. 15 float64
// instructions, as many as the library's.
// Degree 8 (next term 2e-10) is 10 % faster at B >= 512 and leaves the
// kernels' errors against the float64 plain version as they are to every
// digit printed, but not the train step: Adam's first update is lr * sign(g),
// and with it 15,971 of the flagship's 19.7 million parameters moved more than
// 1e-5 away from the float64 plain step (chip_smoke.py phase 5), where this
// polynomial leaves none. So the degree stays.
__device__ __forceinline__ double exp_in_range(double x) {
  const double t = fma(x, 1.4426950408889634, 6755399441055744.0);
  const double k = t - 6755399441055744.0;
  double r = fma(k, -6.93147180559945286e-01, x);
  r = fma(k, -2.31904681384629956e-17, r);
  double e = 1.0 / 39916800.0;
  e = fma(e, r, 1.0 / 3628800.0);
  e = fma(e, r, 1.0 / 362880.0);
  e = fma(e, r, 1.0 / 40320.0);
  e = fma(e, r, 1.0 / 5040.0);
  e = fma(e, r, 1.0 / 720.0);
  e = fma(e, r, 1.0 / 120.0);
  e = fma(e, r, 1.0 / 24.0);
  e = fma(e, r, 1.0 / 6.0);
  e = fma(e, r, 0.5);
  e = fma(e, r, 1.0);
  e = fma(e, r, 1.0);
  const int scale = (int)((unsigned)__double2loint(t) << 20);
  return __hiloint2double(__double2hiint(e) + scale, __double2loint(e));
}

// The joint weight g_j * exp(x), x = iw + psum - lj <= 0 up to rounding;
// below -700 it is 0 to every digit kept.
__device__ __forceinline__ double joint_weight(double g_j, double x) {
  return g_j * exp_in_range(fmax(x, -700.0));
}

// g_m * exp(x) + w_joint where the raw density lp passes the clamp, else 0
// (the clamp passes no gradient). x = iw + lp - lm lies in [-120, 0] there.
// The selects sit on the operands, so that no lane skips the exp and the
// loop stays free of branches.
__device__ __forceinline__ double density_grad(double lp, double x, double g_m,
                                               double w_joint) {
  const bool ok = lp > LOG_PROB_FLOOR;
  const double e = exp_in_range(ok ? x : 0.0);
  return fma(ok ? g_m : 0.0, e, ok ? w_joint : 0.0);
}

// What tc_fwd left per (j, l): z, 1/v, c and cl = c - lm, so that for
// d = z - mu[i,l] the raw density is P = c - 0.5*d*d/v and the exponent of
// its marginal weight, iw + P - lm, is (iw + cl) - 0.5*d*d/v.
struct Terms {
  double z, inv_v, c, cl;
};

__device__ __forceinline__ Terms load_terms(const double2* __restrict__ terms, size_t jl) {
  const double2 a = __ldg(&terms[2 * jl]), b = __ldg(&terms[2 * jl + 1]);
  return Terms{a.x, a.y, b.x, b.y};
}

template <int K> struct Kind { static constexpr int value = K; };

// The place of a warp in a backward block (see "Design"): its slice of the
// reduced axis (the warp's number), the first of its thread's R output rows,
// its lanes' column.
struct BwdPlace {
  int lane, warp, slice, row0, l, ll;
  bool l_active;
};

template <int R>
__device__ __forceinline__ BwdPlace bwd_place(int Z) {
  BwdPlace p;
  p.lane = threadIdx.x & 31;
  p.warp = threadIdx.x >> 5;
  p.slice = p.warp;
  const int n_chunks = (Z + 31) >> 5;
  p.row0 = (blockIdx.x / n_chunks) * R;
  p.l = (blockIdx.x % n_chunks) * 32 + p.lane;
  p.l_active = p.l < Z;
  p.ll = min(p.l, Z - 1);  // lanes past Z redo the last column and store nothing
  return p;
}

// The block's one barrier: every warp leaves its N partial sums per lane in
// `part` [warp][N][32]; the warp of slice 0 then adds the slices in ascending
// order and returns true with the totals in v.
template <int N>
__device__ __forceinline__ bool sum_slices(double (&v)[N], double* part, const BwdPlace& p,
                                           int n_slices) {
  double* mine = part + (size_t)p.warp * (N * 32) + p.lane;
#pragma unroll
  for (int k = 0; k < N; ++k) mine[k * 32] = v[k];
  __syncthreads();
  if (p.slice != 0) return false;
  for (int s = 1; s < n_slices; ++s) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += mine[(size_t)s * (N * 32) + k * 32];
  }
  return true;
}


template <int R>
__global__ void __launch_bounds__(512, 1)
tc_bwd_dz(const double2* __restrict__ terms, const float* __restrict__ mu,
          const float* __restrict__ logvar, const double* __restrict__ psum,
          const double* __restrict__ lj, const float* __restrict__ g_m,
          const float* __restrict__ g_j, float* __restrict__ dz,
          float* __restrict__ dlogvar, int B_j, int B_i, int Z, int row_off,
          int slice_len, int n_slices, IwConsts c) {
  extern __shared__ double part[];
  __shared__ double wsm[MAX_SLICES][R][32];  // a warp's joint weights of a chunk
  const BwdPlace p = bwd_place<R>(Z);
  const double lg_m = c.log1m, lg_n = c.log1n, lg_s = c.logstrat;

  // the thread's R rows j
  Terms t[R];
  double xm[R], gm[R], gj[R], lj_r[R], iw0[R];
  size_t prow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = min(p.row0 + r, B_j - 1);  // rows past B_j redo the last one
    t[r] = load_terms(terms, (size_t)j * Z + p.ll);
    iw0[r] = row_off + j == c.special_row ? lg_s : lg_n;  // the row's weight in column 0
    xm[r] = lg_m + t[r].cl;
    gm[r] = g_m[j];
    gj[r] = g_j[j];
    lj_r[r] = lj[j];
    prow[r] = (size_t)j * B_i;
  }
  double acc[2 * R];  // per row: sum of -dP*q, then sum of dP*(d*q - 1), q = d/v
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) acc[k] = 0.0;

  const int i_end = min(B_i, (p.slice + 1) * slice_len);
  for (int c0 = p.slice * slice_len; c0 < i_end; c0 += 32) {
    const int n = min(32, i_end - c0);
    // lane t: the joint weight of (j, c0 + t), once per pair
    const int ic = min(c0 + p.lane, B_i - 1);
    double w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const double iw = ic == 0 ? iw0[r] : ic == 1 ? lg_s : lg_m;
      w[r] = joint_weight(gj[r], iw + __ldg(&psum[prow[r] + ic]) - lj_r[r]);
    }
    __syncwarp();  // the last chunk's reads are done
#pragma unroll
    for (int r = 0; r < R; ++r) wsm[p.warp][r][p.lane] = w[r];
    __syncwarp();
    // column c0 + k against the R rows; KIND: 0 and 1 for the columns 0 and
    // 1, which carry their own weights, 2 for the rest
    auto column = [&](int k, auto kind) {
      constexpr int KIND = decltype(kind)::value;
      const double m = (double)__ldg(&mu[(size_t)(c0 + k) * Z + p.ll]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double wj = wsm[p.warp][r][k];
        const double x0 = KIND == 2 ? xm[r] : (KIND == 0 ? iw0[r] : lg_s) + t[r].cl;
        const double d = t[r].z - m;
        const double q = d * t[r].inv_v;
        const double dq = d * q;
        const double dp = density_grad(fma(-0.5, dq, t[r].c), fma(-0.5, dq, x0), gm[r], wj);
        acc[2 * r] = fma(-dp, q, acc[2 * r]);
        acc[2 * r + 1] = fma(dp, dq - 1.0, acc[2 * r + 1]);
      }
    };
    int k = 0;
    if (c0 == 0) {
      column(0, Kind<0>());
      if (n > 1) column(1, Kind<1>());
      k = min(2, n);
    }
#pragma unroll 4
    for (; k < n; ++k) column(k, Kind<2>());
  }

  if (!sum_slices<2 * R>(acc, part, p, n_slices) || !p.l_active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = p.row0 + r;
    if (j >= B_j) break;
    const size_t jl = (size_t)j * Z + p.l;
    dz[jl] = (float)acc[2 * r];
    // d P / d logvar = -0.5 * (1 - d*d/v), and none where v is floored
    const bool not_floored = exp((double)logvar[jl]) > VAR_FLOOR;
    dlogvar[jl] = not_floored ? (float)(0.5 * acc[2 * r + 1]) : 0.0f;
  }
}

template <int R>
__global__ void __launch_bounds__(512, 1)
tc_bwd_dmu(const double2* __restrict__ terms, const float* __restrict__ mu,
           const double* __restrict__ psum, const double* __restrict__ lj,
           const float* __restrict__ g_m, const float* __restrict__ g_j,
           float* __restrict__ dmu, int B_j, int B_i, int Z, int row_off,
           int slice_len, int n_slices, IwConsts c) {
  extern __shared__ double part[];
  __shared__ double wsm[MAX_SLICES][R + 1][32];  // a warp's joint weights and g_m of a chunk
  const BwdPlace p = bwd_place<R>(Z);
  const double lg_m = c.log1m, lg_n = c.log1n, lg_s = c.logstrat;

  // the thread's R rows i of mu
  double m[R];
  int col[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    col[r] = min(p.row0 + r, B_i - 1);  // rows past B_i redo the last one
    m[r] = mu[(size_t)col[r] * Z + p.ll];
  }
  double acc[R];  // per row: sum of dP*q, q = d/v
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0;

  const int j_end = min(B_j, (p.slice + 1) * slice_len);
  for (int c0 = p.slice * slice_len; c0 < j_end; c0 += 32) {
    const int n = min(32, j_end - c0);
    // lane t: row c0 + t's incoming gradients, its weight in column 0, and
    // the joint weights of (c0 + t, i), once per pair
    const int jc = min(c0 + p.lane, B_j - 1);
    const double gm_lane = __ldg(&g_m[jc]);
    const double iw0_lane = row_off + jc == c.special_row ? lg_s : lg_n;
    const double gj = __ldg(&g_j[jc]), lj_j = __ldg(&lj[jc]);
    double w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const double iw = col[r] == 0 ? iw0_lane : col[r] == 1 ? lg_s : lg_m;
      w[r] = joint_weight(gj, iw + __ldg(&psum[(size_t)jc * B_i + col[r]]) - lj_j);
    }
    __syncwarp();  // the last chunk's reads are done
#pragma unroll
    for (int r = 0; r < R; ++r) wsm[p.warp][r][p.lane] = w[r];
    wsm[p.warp][R][p.lane] = gm_lane;
    __syncwarp();
    // row c0 + k against the R columns; FIRST: the block holds column 0 or 1,
    // which carry their own weights. Every other block runs a loop without
    // that test (10 % less time at B = 2048).
    auto row = [&](int k, auto first) {
      constexpr bool FIRST = decltype(first)::value != 0;
      const Terms t = load_terms(terms, (size_t)(c0 + k) * Z + p.ll);
      const double gm = wsm[p.warp][R][k];
      const double xm = lg_m + t.cl;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double wj = wsm[p.warp][r][k];
        double x0 = xm;
        if (FIRST && col[r] < 2)
          x0 = (col[r] == 0 ? __shfl_sync(FULL_MASK, iw0_lane, k) : lg_s) + t.cl;
        const double d = t.z - m[r];
        const double q = d * t.inv_v;
        const double dq = d * q;
        const double dp = density_grad(fma(-0.5, dq, t.c), fma(-0.5, dq, x0), gm, wj);
        acc[r] = fma(dp, q, acc[r]);
      }
    };
    if (p.row0 < 2) {
#pragma unroll 4
      for (int k = 0; k < n; ++k) row(k, Kind<1>());
    } else {
#pragma unroll 4
      for (int k = 0; k < n; ++k) row(k, Kind<0>());
    }
  }

  if (!sum_slices<R>(acc, part, p, n_slices) || !p.l_active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = p.row0 + r;
    if (i >= B_i) break;
    dmu[(size_t)i * Z + p.l] = (float)acc[r];
  }
}

// Nothing: its time is what a launch costs (chip_smoke.py's launch floor).
__global__ void tc_empty() {}

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

// The launch of a backward kernel over n_out output rows, n_red reduced
// ones: the caller's plan (tc_cuda.backward_plan) is checked, not chosen,
// here. Dynamic shared memory: one double per thread and partial sum (the
// kernels' static tables of joint weights come on top: 36 KB in all at most).
struct BwdLaunch {
  int blocks, threads;
  size_t shared;
};

int bwd_launch(int n_out, int n_red, int Z, int rows, int max_rows, int slice_len,
               int n_slices, int sums_per_row, BwdLaunch* out) {
  if ((rows != 1 && rows != 2 && rows != 4) || rows > max_rows || slice_len < 1 ||
      n_slices < 1 || n_slices > MAX_SLICES ||
      (long long)slice_len * n_slices < n_red ||
      (long long)slice_len * (n_slices - 1) >= n_red) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)((n_out + rows - 1) / rows) * ((Z + 31) / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  out->blocks = (int)blocks;
  out->threads = n_slices * 32;
  out->shared = (size_t)out->threads * rows * sums_per_row * sizeof(double);
  return 0;
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises. terms [B_j, Z, 4], psum [B_j, B_i] and lj [B_j]
// are float64. The backward launchers take the plan of
// tc_cuda.backward_plan: rows a thread, slice_len, n_slices.
extern "C" {

int tc_fwd_launch(const float* z, const float* mu, const float* logvar,
                  double* terms, double* psum, double* lj, float* pm, float* qz,
                  int B_j, int B_i, int Z, long long dataset_size, int row_off,
                  int global_batch, int device, void* stream) {
  int bad = check_args(B_j, B_i, Z, dataset_size, global_batch);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tc_fwd<<<B_j, threads_for(Z), 0, (cudaStream_t)stream>>>(
      z, mu, logvar, (double2*)terms, psum, lj, pm, qz, B_i, Z, row_off,
      iw_consts(global_batch, dataset_size));
  return (int)cudaGetLastError();
}

int tc_bwd_dz_launch(const double* terms, const float* mu, const float* logvar,
                     const double* psum, const double* lj, const float* g_m,
                     const float* g_j, float* dz, float* dlogvar,
                     int B_j, int B_i, int Z, long long dataset_size, int row_off,
                     int global_batch, int rows, int slice_len, int n_slices,
                     int device, void* stream) {
  int bad = check_args(B_j, B_i, Z, dataset_size, global_batch);
  BwdLaunch l;
  if (!bad) bad = bwd_launch(B_j, B_i, Z, rows, 2, slice_len, n_slices, 2, &l);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const IwConsts c = iw_consts(global_batch, dataset_size);
  const double2* t = (const double2*)terms;
  cudaStream_t s = (cudaStream_t)stream;
#define TC_BWD_DZ(R)                                                              \
  tc_bwd_dz<R><<<l.blocks, l.threads, l.shared, s>>>(                             \
      t, mu, logvar, psum, lj, g_m, g_j, dz, dlogvar, B_j, B_i, Z, row_off,       \
      slice_len, n_slices, c)
  if (rows == 1) TC_BWD_DZ(1);
  else TC_BWD_DZ(2);
#undef TC_BWD_DZ
  return (int)cudaGetLastError();
}

int tc_bwd_dmu_launch(const double* terms, const float* mu, const double* psum,
                      const double* lj, const float* g_m, const float* g_j,
                      float* dmu,
                      int B_j, int B_i, int Z, long long dataset_size, int row_off,
                      int global_batch, int rows, int slice_len, int n_slices,
                      int device, void* stream) {
  int bad = check_args(B_j, B_i, Z, dataset_size, global_batch);
  BwdLaunch l;
  if (!bad) bad = bwd_launch(B_i, B_j, Z, rows, 4, slice_len, n_slices, 1, &l);
  if (bad) return bad;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const IwConsts c = iw_consts(global_batch, dataset_size);
  const double2* t = (const double2*)terms;
  cudaStream_t s = (cudaStream_t)stream;
#define TC_BWD_DMU(R)                                                             \
  tc_bwd_dmu<R><<<l.blocks, l.threads, l.shared, s>>>(                            \
      t, mu, psum, lj, g_m, g_j, dmu, B_j, B_i, Z, row_off, slice_len, n_slices, c)
  if (rows == 1) TC_BWD_DMU(1);
  else if (rows == 2) TC_BWD_DMU(2);
  else TC_BWD_DMU(4);
#undef TC_BWD_DMU
  return (int)cudaGetLastError();
}

int tc_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tc_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
