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
// tc_fwd takes one block per z row j. Beside pm and lj it writes what the
// two backward kernels would otherwise recompute per (i, j, l): `terms`
// [B_j, Z] of four float64 each, {z, 1/v, c, c - lm} with
// c = -0.5*(log v + log 2pi), so that P = c - 0.5*d*d/v; and `psum`
// [B_j, B_i] float64, psum[j,i] = sum_l P[j,i,l], the only quantity of the
// backward that needs a sum over l. psum is O(B^2), 32 KB at B = 64 and
// 2.1 GB at B = 16384, against the O(B^2 Z) tensor the kernels avoid.
// The bank (the reduced axis i) is cut into the backward kernels' slices
// (tc_cuda.reduce_slices), one warp each. A lane takes the latents l = lane,
// lane + 32, ... of the row (tc_cuda.forward_plan), whose z, 1/v and c the
// block computes once, into shared memory, while the first mu values load.
// A warp walks its slice in chunks of 8 rows, and a chunk's latents a group
// of 32 at a time in a loop (so that the code is small: at B = 64 every
// instruction runs a few times a launch), each group's mu values copied by
// cp.async into a warp's ring 2 items ahead, so that the loop waits for no
// load (the first two load beside z and logvar). After
// the last group, a lane's 8 sums over its
// latents of P are summed over the warp by recursive halving (each of 3
// steps hands half of the remaining rows to the partner lane, 7 shuffles,
// then 2 butterfly steps: lane t ends with the chunk's row t / 4); there is
// no barrier in the loop.
// The marginal logsumexp needs no running max and no rescaling: iw <=
// log(1/M), the largest of the three weights (N > M), and -50 <= P <= 3.69
// (v >= 1e-4), so with the shift log(1/M), known in advance, every exponent
// x = P + (iw - log(1/M)) lies in [-50 - log N, 3.69]: the weights differ by
// at most max(log(N/M), log(N/(N-M))) <= log N, N - M >= 1. That is above
// -94 for any N < 2^63: no float64 term underflows or overflows, and the
// slices' sums add as they are. (A shift by max(c, -50) as well would put
// every x under 0 at one more operation an element; float64 does not need
// it.) The joint has no such bound (psum reaches -50 Z): the
// lane that completes a row of psum keeps an online logsumexp over its rows,
// one row a chunk (two exps a chunk, against the chunk's 8 a latent), and
// the warp combines its lanes once. The slices' sums meet after the block's
// second __syncthreads, where warp w adds them in ascending order for the
// latent groups w, w + n_slices, ... (the logs of the groups run in
// parallel) and the last warp the joint's; warp 0 adds the warps' sums of
// lm, in order, after the third.
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
// to 16 gains 2 % at B=2048 and loses 10 % at B=64). An element of tc_fwd is
// 20 float64 instructions (the density 3, the clamp, the l-sum, the exp 15,
// the marginal sum) and a conversion of mu, beside a shared load a row and
// the halving's 9 shuffles a chunk; at B = 2048 it reaches a little under
// half the bound, about where the backward kernels are. At B = 64 a row is one block on one SM (64 of
// 132 busy) and the time is its chain: z and logvar, then the group loop,
// float64-bound on that SM, then the slices' sums, the logs and a barrier
// (PERF.md, section 6).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_Z = 1024;
constexpr int MAX_SLICES = 16;    // slices of the reduced axis, one warp each
constexpr int MIN_SLICE_LEN = 8;  // rows of the reduced axis a warp takes at least
constexpr int LOG_CHUNK = 3;
constexpr int CHUNK = 1 << LOG_CHUNK;  // bank rows a forward warp sums over l at once
constexpr int RING = 2;           // items of mu a forward warp keeps in flight
constexpr double LOG_2PI = 1.8378770664093453;
constexpr double LOG_PROB_FLOOR = -50.0;
constexpr double VAR_FLOOR = 1e-4;
constexpr double LOG_VAR_FLOOR = -9.210340371976182;  // log(1e-4)
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

template <int K> struct Kind { static constexpr int value = K; };

// What tc_fwd keeps per latent l of its row, in shared memory: z, a = -0.5/v
// and c = -0.5*(log v + log 2pi), so that P = max(fma(d*a, d, c), -50) for
// d = z - mu[i,l]. A slot past Z (the last group's) has z = a = c = 0 and
// reads column Z - 1 of mu: its P is 0 for every row, so it adds nothing to
// psum.
struct Latent {
  double z, a, c;
};

__device__ __forceinline__ Latent latent_of(float z, float logvar, bool active) {
  if (!active) return Latent{0.0, 0.0, 0.0};
  // v = max(exp(logvar), 1e-4), so log v is logvar itself or log(1e-4), and
  // 1/v = exp(-logvar) where it is not floored
  const double lv = logvar;
  const bool floored = !(exp_in_range(fmin(lv, 700.0)) > VAR_FLOOR);
  return Latent{z, -0.5 * (floored ? 1.0 / VAR_FLOOR : exp_in_range(fmax(-lv, -700.0))),
                -0.5 * ((floored ? LOG_VAR_FLOOR : lv) + LOG_2PI)};
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
}

// A warp's ring of mu values in shared memory: RING stages of [CHUNK][32]
// floats, one (chunk, latent group) item each, filled by cp.async RING items
// ahead of their use, so that the loop waits for no load. Lane t copies and
// reads column 32 g + t only (rows past the slice read its last row, which
// is never counted): the ring needs no barrier.
struct MuRing {
  float* stages;  // this warp's [RING][CHUNK][32], at its lane's column
  int c0, g, i_end, G, Z;  // the next item to copy

  __device__ __forceinline__ void issue(const float* __restrict__ mu, int q, int lane) {
    if (c0 < i_end) {
      const float* src = mu + min(g * 32 + lane, Z - 1);
      float* dst = stages + (q % RING) * CHUNK * 32;
#pragma unroll
      for (int r = 0; r < CHUNK; ++r) cp_async4(dst + r * 32, src + (size_t)min(c0 + r, i_end - 1) * Z);
      if (++g == G) g = 0, c0 += CHUNK;
    }
    cp_async_commit();  // an empty group past the slice's end keeps the count
  }
};

// The chunk's sums over the warp by recursive halving (see "Design"): node
// (H, K) of the tree over v[k], k < CHUNK, a lane's sum over its latents
// for the chunk's row k. A node of level H pairs the nodes K and
// K + CHUNK / 2^H of level H - 1 across lane bit 16 / 2^(H-1): the lane with
// that bit set keeps the second and sends the first, so that after level
// LOG_CHUNK lane t holds its quarter-warp's sum of row t / 4.
template <int H, int K>
__device__ __forceinline__ double halve(const double (&v)[CHUNK], int lane) {
  if constexpr (H == 0) {
    return v[K];
  } else {
    const double lo = halve<H - 1, K>(v, lane);
    const double hi = halve<H - 1, K + (CHUNK >> H)>(v, lane);
    constexpr int O = 16 >> (H - 1);
    const bool upper = (lane & O) != 0;
    return (upper ? hi : lo) + __shfl_xor_sync(FULL_MASK, upper ? lo : hi, O);
  }
}

// One chunk of a warp's slice, rows c0.. (FULL: all CHUNK of them lie before
// i_end), against every latent of the row, a group of 32 (one a lane) at a
// time: adds each latent's sum of exp(x) over the chunk's rows to the warp's
// marginal sums `mine` [G][32] in shared memory and returns, in lane t,
// psum of the chunk's row t / 4. q counts the items taken from the ring. x0
// and x1 are the weights of the columns 0 and 1 less log(1/M), 0 unless
// c0 == 0.
template <bool FULL>
__device__ __forceinline__ double chunk_sum(MuRing& ring, int& q, const float* __restrict__ mu,
                                            const Latent* st, double* mine, int c0, int i_end,
                                            int G, double x0, double x1, int lane) {
  double rows[CHUNK];
#pragma unroll
  for (int r = 0; r < CHUNK; ++r) rows[r] = 0.0;
  for (int g = 0; g < G; ++g, ++q) {
    cp_async_wait_ring();
    float m[CHUNK];
    const float* stage = ring.stages + (q % RING) * CHUNK * 32;
#pragma unroll
    for (int r = 0; r < CHUNK; ++r) m[r] = stage[r * 32];
    ring.issue(mu, q, lane);  // into the stage just read
    const Latent t = st[g * 32 + lane];
    double se = 0.0;
#pragma unroll
    for (int r = 0; r < CHUNK; ++r) {
      const double d = t.z - (double)m[r];
      const double p = fmax(fma(d * t.a, d, t.c), LOG_PROB_FLOOR);
      rows[r] += p;
      double x = p;
      if (r == 0) x += x0;
      if (r == 1) x += x1;
      const double e = exp_in_range(x);
      se += (FULL || c0 + r < i_end) ? e : 0.0;
    }
    mine[g * 32] += se;
  }
  double v = halve<LOG_CHUNK, 0>(rows, lane);
#pragma unroll
  for (int o = 16 >> LOG_CHUNK; o >= 1; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Dynamic shared memory of tc_fwd: the row's latents [G * 32], each
// slice's marginal sums [n_slices][G][32], G = ceil(Z / 32), and each
// slice's ring of mu values [n_slices][RING][CHUNK][32].
size_t fwd_shared_bytes(int Z, int n_slices) {
  const size_t slots = (size_t)(Z + 31) / 32 * 32;
  return slots * sizeof(Latent) + (size_t)n_slices * slots * sizeof(double) +
         (size_t)n_slices * RING * CHUNK * 32 * sizeof(float);
}

__global__ void __launch_bounds__(MAX_SLICES * 32, 1)
tc_fwd(const float* __restrict__ z, const float* __restrict__ mu,
       const float* __restrict__ logvar, double2* __restrict__ terms,
       double* __restrict__ psum, double* __restrict__ lj, float* __restrict__ pm_out,
       float* __restrict__ lj_out, int B_i, int Z, int row_off, int slice_len,
       int n_slices, IwConsts c) {
  extern __shared__ double smem[];
  __shared__ double2 joint[MAX_SLICES];  // the slices' joint max and sum
  __shared__ double pm_part[MAX_SLICES];  // the warps' sums of lm
  const int G = (Z + 31) / 32;
  Latent* st = (Latent*)smem;
  double* part = (double*)(st + G * 32);
  const int j = blockIdx.x, lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int row = row_off + j;
  const int i_begin = slice * slice_len, i_end = min(B_i, i_begin + slice_len);
  const size_t zrow = (size_t)j * Z;
  double* prow = psum + (size_t)j * B_i;
  double* mine = part + (size_t)slice * G * 32 + lane;
  const double lg_m = c.log1m;
  const double w0 = log_iw(row, 0, c) - lg_m, w1 = log_iw(row, 1, c) - lg_m;

  // z and logvar of the thread's first latent, then the first RING items of
  // mu: all of them load at once
  const int l0 = threadIdx.x;
  const float z0 = l0 < Z ? z[zrow + l0] : 0.0f, lv0 = l0 < Z ? logvar[zrow + l0] : 0.0f;
  MuRing ring{(float*)(part + (size_t)n_slices * G * 32) + (size_t)slice * RING * CHUNK * 32 + lane,
              i_begin, 0, i_end, G, Z};
#pragma unroll
  for (int q = 0; q < RING; ++q) ring.issue(mu, q, lane);
  if (l0 < G * 32) st[l0] = latent_of(z0, lv0, l0 < Z);
  for (int l = l0 + blockDim.x; l < G * 32; l += blockDim.x)
    st[l] = latent_of(l < Z ? z[zrow + l] : 0.0f, l < Z ? logvar[zrow + l] : 0.0f, l < Z);
  for (int g = 0; g < G; ++g) mine[g * 32] = 0.0;
  __syncthreads();

  // the row of psum a lane completes in each chunk (lanes 0, 4, ..., 28),
  // and its online logsumexp over those rows for the joint
  const bool writer = (lane & ((32 >> LOG_CHUNK) - 1)) == 0;
  double jm = -INFINITY, js = 0.0;
  int q = 0;
  for (int c0 = i_begin; c0 < i_end; c0 += CHUNK) {
    const double x0 = c0 == 0 ? w0 : 0.0, x1 = c0 == 0 ? w1 : 0.0;
    const double v = c0 + CHUNK <= i_end
                         ? chunk_sum<true>(ring, q, mu, st, mine, c0, i_end, G, x0, x1, lane)
                         : chunk_sum<false>(ring, q, mu, st, mine, c0, i_end, G, x0, x1, lane);
    const int i = c0 + (lane >> (5 - LOG_CHUNK));
    if (writer && i < i_end) {
      prow[i] = v;
      const double x = log_iw(row, i, c) + v, nm = fmax(jm, x);
      js = js * exp_in_range(fmax(jm - nm, -700.0)) + exp_in_range(fmax(x - nm, -700.0));
      jm = nm;
    }
  }
  {
    const double m = warp_max(jm);
    const double sum = warp_sum(js * exp_in_range(fmax(jm - m, -700.0)));
    if (lane == 0) joint[slice] = make_double2(m, sum);
  }
  __syncthreads();

  // the last warp: the joint over the slices, against their largest max
  if (slice == n_slices - 1) {
    double mj = joint[0].x;
    for (int sl = 1; sl < n_slices; ++sl) mj = fmax(mj, joint[sl].x);
    double sj = 0.0;
#pragma unroll 4
    for (int sl = 0; sl < n_slices; ++sl)
      sj += joint[sl].y * exp_in_range(fmax(joint[sl].x - mj, -700.0));
    if (lane == 0) {
      const double lj_j = mj + log(sj);
      lj[j] = lj_j;
      lj_out[j] = (float)lj_j;
    }
  }
  // the slices' sums, in ascending order: warp w takes the latent groups
  // w, w + n_slices, ...; then its sum of lm, which warp 0 adds up in the
  // warps' order after the block's last barrier
  double pm_lane = 0.0;
  for (int g = slice; g < G; g += n_slices) {
    const int l = g * 32 + lane;
    double tot = part[(size_t)g * 32 + lane];
    for (int sl = 1; sl < n_slices; ++sl) tot += part[((size_t)sl * G + g) * 32 + lane];
    if (l < Z) {
      const Latent t = st[l];
      const double lm = log(tot) + lg_m;
      terms[2 * (zrow + l)] = make_double2(t.z, -2.0 * t.a);
      terms[2 * (zrow + l) + 1] = make_double2(t.c, t.c - lm);
      pm_lane += lm;
    }
  }
  const double pm_w = warp_sum(pm_lane);
  if (lane == 0) pm_part[slice] = pm_w;
  __syncthreads();
  if (threadIdx.x == 0) {
    double pm = pm_part[0];
    for (int w = 1; w < n_slices; ++w) pm += pm_part[w];
    pm_out[j] = (float)pm;
  }
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

// The cut of tc_cuda.forward_plan, a function of the bank's length alone:
// the slices of tc_cuda.reduce_slices. (The latents a lane holds follow from
// Z inside the kernel.)
struct FwdCut {
  int slice_len, n_slices;
};

FwdCut forward_cut(int B_i) {
  const int per_slice = (B_i + MAX_SLICES - 1) / MAX_SLICES;
  const int slice_len = per_slice <= MIN_SLICE_LEN ? MIN_SLICE_LEN : (per_slice + 7) / 8 * 8;
  return FwdCut{slice_len, (B_i + slice_len - 1) / slice_len};
}

// The dynamic shared memory tc_fwd may take on each device so far: above the
// 48 KB a kernel gets without asking it is raised once per device and size,
// not on every launch.
constexpr int MAX_DEVICES = 64;
size_t fwd_shared_granted[MAX_DEVICES];

int check_args(int B_j, int B_i, int Z, long long dataset_size, int global_batch) {
  if (B_j < 1 || B_i < 1 || Z < 1 || Z > MAX_Z || global_batch < 2 ||
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
// are float64. The forward launcher takes tc_cuda.forward_plan's cut
// (slice_len, n_slices) and refuses any other; the backward launchers
// the plan of tc_cuda.backward_plan: rows a thread, slice_len, n_slices.
extern "C" {

int tc_fwd_launch(const float* z, const float* mu, const float* logvar,
                  double* terms, double* psum, double* lj, float* pm, float* qz,
                  int B_j, int B_i, int Z, long long dataset_size, int row_off,
                  int global_batch, int slice_len, int n_slices, int device, void* stream) {
  int bad = check_args(B_j, B_i, Z, dataset_size, global_batch);
  if (bad) return bad;
  const FwdCut cut = forward_cut(B_i);
  if (slice_len != cut.slice_len || n_slices != cut.n_slices || device < 0 ||
      device >= MAX_DEVICES) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // 51 KB at Z = 128 and 16 slices, 184 KB at Z = 1024: from Z = 128 with
  // 16 slices (a bank of 128 or more) above the 48 KB given without asking
  const size_t shared = fwd_shared_bytes(Z, n_slices);
  if (shared > 48 * 1024 && shared > fwd_shared_granted[device]) {
    err = cudaFuncSetAttribute(tc_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
    fwd_shared_granted[device] = shared;
  }
  tc_fwd<<<B_j, n_slices * 32, shared, (cudaStream_t)stream>>>(
      z, mu, logvar, (double2*)terms, psum, lj, pm, qz, B_i, Z, row_off, slice_len, n_slices,
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
