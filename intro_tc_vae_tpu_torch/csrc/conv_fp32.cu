// 3x3 convolution, 64 -> 64 channels, stride 1, zero padding 1, in fp32 (true
// fp32 products and sums, no TF32): the fp32 bodies of conv3x3_fwd and
// conv3x3_dw for Hopper (sm_90a). They take every [N, 64, H, W] the wrappers
// accept; bf16 runs the kernels of conv_wgmma.cu.
//
// They replace the TPU Pallas kernels of intro_tc_vae_tpu/ops/conv_pallas.py:
//   conv3x3_fwd_fp32 <- _fwd_kernel (conv_pallas.py:238): y = conv3x3(x, w),
//                       and dx = conv3x3(gy, rot_t(w)) on weights packed with
//                       rot = 1 (conv3x3_pack_w, conv_wgmma.cu)
//   conv3x3_dw_fp32  <- _dwp_kernel (conv_pallas.py:253): one fp32 partial dW
//                       per persistent block; conv3x3_dw_reduce
//                       (conv_kernels.cu) sums the partials in block order, so
//                       dW has the same bits in every run (no atomics)
//
// Bound on an H100 (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s).
// A pixel costs 2 x 64 x 576 = 73,728 operations against 512 bytes of
// activations: 144 operations a byte, seven times the fp32 ridge of 20, so
// both kernels are bound by the FFMA rate: 0.288 ms at [64, 64, 64, 64]. An
// SM starts four warp instructions a clock and has 128 FFMA lanes: the peak
// needs an FFMA in every one of those slots. The design is therefore about
// the instruction mix: what share of the instructions are FFMAs, and
// whether anything (a load, a barrier) keeps the FFMA pipe waiting. The
// bodies these replace did one shared-memory load for every 3 (dW) and 6
// (forward) FFMAs, staged every tile synchronously through a transposing
// scalar copy, and read x and gy three times over for dW.
//
// Design, both kernels.
//   * Rows stay as they lie in memory. An NCHW image row is [64 ch][W px]
//     with the pixels contiguous; it is copied as it is into shared memory,
//     [channel][pitch]. Nothing is transposed. The copies are cp.async,
//     zero-filled (src-size 0) outside the image, which is the padding: 16
//     bytes a lane where the rows are multiples of 16 bytes (W a multiple of
//     4) and the destination is aligned, else 4 bytes a lane, coalesced
//     along the row, which takes any W and any alignment: the ragged shapes
//     and W = 4 or 6 run the same kernels.
//   * One persistent block an SM walks units b, b + P, ...: a unit is TR x TC
//     pixels of one image, 512 pixels (8 x 64, or 16 x 32 where W <= 32),
//     numbered columns fastest, then row chunks, then images
//     (ops/conv.py::fp32_tile_schedule). The copies run ahead of the
//     arithmetic through a ring of stages, across unit boundaries, one
//     __syncthreads a stage.
//   * The kx shift happens in registers: a thread loads a run of
//     neighbouring pixels once and uses it for kx = 0, 1, 2.
// Forward (512 threads, 127 registers, no spills): a thread owns 8
//   neighbouring pixels of one row x 8 output channels (co = 4 cg .. 4 cg + 3
//   and 32 + 4 cg ..: two 16-byte loads that the 8 channel groups of a warp
//   spread over all 32 banks). The reduction runs over K = 64 ci x 9 taps in
//   stages of 8 input channels: a stage holds the unit's (TR + 2) x (TC + 2)
//   input pixels of 8 channels and the [9][8][64] weights of those channels
//   (40.5 KB; 4 stages). Pixel p of the unit lies at word 4 + p of its line,
//   so the copies are 16 bytes wide and a thread's 10 pixels c0 - 1 .. c0 + 8
//   are a 4-byte, two 16-byte and a 4-byte load; with the 3 x 8 weights (6
//   loads) that is 10 loads to 192 FFMAs, against 30 before. A warp is 8
//   channel groups x 4 pixel groups: x loads are 4 addresses broadcast to 8
//   lanes each, weight loads 8 addresses broadcast to 4. The weights are
//   streamed with the channels rather than held resident: all nine taps are
//   147 KB in fp32, which leaves room for 4 input rows and so for a tile of
//   one output row, 16 sums a thread; streamed from L2 they cost 147 KB per
//   512 pixels, 0.5 TB/s at the FFMA peak, and the tile keeps 64 sums a
//   thread.
// dW (384 threads, 168 registers, no spills): M = 3 kx x 64 ci (x 3 ky), N =
//   64 co, K = pixels. Warps 0-3, 4-7, 8-11 take ky = 0, 1, 2; a thread owns
//   (3 kx x 4 ci) x 8 co = 96 sums (ci = cig + 16 i, co = cog + 8 j, so that
//   the lanes of a warp differ by the pitch, which is 4 mod 32 words: 4 or 8
//   addresses on distinct banks) for the whole walk. A stage is one image
//   row of x and one of gy; output row h needs x rows h - 1, h, h + 1 and gy
//   row h, the last three stages, so x and gy come from device memory once
//   (plus the two halo rows a unit) for all 9 taps. A thread walks a row 4
//   pixels a step: per ci one 8-byte and one 16-byte load of x (pixel p lies
//   at word 3 + p: pixels 4q - 1 .. 4q + 4 are words 4q + 2 .. 4q + 7), per
//   co one 16-byte load of gy: 16 loads for 384 FFMAs, against 16 for 48
//   before. That offset of 3 keeps x on 4-byte copies (gy's are 16 bytes
//   wide); with x at word 4 + p the copies are all wide but the run costs a
//   third load per ci, and dW, the kernel with the fewest warps, was
//   slower for it. Ragged edges: gy is zero-filled outside the image, so
//   those pixels add nothing.
//   Sum order: a thread adds its block's pixels one at a time, in walk
//   order: at [128, 64, 64, 64] on 132 blocks 8 units x 512 pixels = 4,096
//   sequential additions, then the reduce adds 132 partials in order.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, TF32 off), fp32
// [64, 64, 64, 64]: forward 0.451 ms (the body before: 0.903; cuDNN 0.470),
// dW 0.446 ms + reduce 0.007 (before: 1.771 + 0.011; cuDNN wgrad 0.758): 64 %
// of the bound each, 43 TFLOP/s. What holds them there, largest first: the
// FFMA / shared-load mix as nvcc schedules it (four and three warps a
// scheduler, loads placed shortly before their use); the stage boundaries
// and the tail (512 units on 132 blocks is 3.9 waves); starting the
// copies. Not device memory (no faster with every copy hitting L2) and not
// the power limit (the SM clock read inside the kernels held its maximum).
// Tried and left out, none worth its code: 16 pixels a thread at 256
// threads and copies spread through the stage (both slower), per-stage
// mbarriers instead of __syncthreads, 16 channels a stage in 2 stages,
// 4-byte copies only (each within a percent or two).
//
// nvcc 12.8, -O3, sm_90a, -Xptxas -v: conv3x3_fwd_fp32 127 registers,
// conv3x3_dw_fp32 167 (TC 64) and 168 (TC 32); no spills in any of the four.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;
constexpr int TAPS = 9;
constexpr int TILE_PIXELS = 512;

// A unit is ROWS x TC pixels of one image.
template <int TC>
struct Tile {
  static constexpr int ROWS = TILE_PIXELS / TC;
};

struct Unit {
  int n, h0, w0, rows;
};

// unit u of the walk: columns fastest, then row chunks, then images
// (ops/conv.py::fp32_tile_schedule)
template <int TC>
__device__ __forceinline__ Unit unit_of(int u, int H, int W) {
  constexpr int TR = Tile<TC>::ROWS;
  const int wcn = (W + TC - 1) / TC, hcn = (H + TR - 1) / TR;
  Unit t;
  t.w0 = (u % wcn) * TC;
  u /= wcn;
  t.h0 = (u % hcn) * TR;
  t.n = u / hcn;
  t.rows = ::min(TR, H - t.h0);
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes global -> shared, or 4 bytes of zeros where !valid (src-size 0:
// nothing is read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes (both addresses on 16 bytes), or 16 bytes of zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid = true) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N committed groups of this thread are complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `lines` rows of TC pixels, columns w0 .. w0 + TC - 1, into shared memory,
// zero outside the image, by all of the block's THREADS threads. Line l is
// the row at src + row_of(l) (an element offset; negative: the row is
// outside the image) and lands at dst + l * pitch words. With `halo` also
// the pixels w0 - 1 and w0 + TC, one word before and TC words after.
// vec (W a multiple of 4, src and dst on 16 bytes): 16-byte copies, 32 /
// (TC / 4) lines a warp instruction, the two halo pixels as 4-byte copies;
// else 4-byte copies, a warp's lanes along a line.
template <int TC, int THREADS, typename RowOf>
__device__ __forceinline__ void load_rows(uint32_t dst, int pitch, const float* src, int lines,
                                          RowOf row_of, int w0, int W, bool halo, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (vec) {
    constexpr int CPL = TC / 4, LPI = 32 / CPL;  // chunks a line, lines an instruction
    const int k = lane % CPL, w = w0 + 4 * k;
    for (int l = warp * LPI + lane / CPL; l < lines; l += THREADS / 32 * LPI) {
      const long long row = row_of(l);
      const bool ok = row >= 0 && w < W;
      cp_async16(dst + (l * pitch + 4 * k) * 4, src + (ok ? row + w : 0), ok);
    }
    if (halo) {
      for (int e = threadIdx.x; e < 2 * lines; e += THREADS) {
        const int l = e >> 1, right = e & 1, w = right ? w0 + TC : w0 - 1;
        const long long row = row_of(l);
        const bool ok = row >= 0 && w >= 0 && w < W;
        cp_async4(dst + (l * pitch + (right ? TC : -1)) * 4, src + (ok ? row + w : 0), ok);
      }
    }
  } else {
    const int first = halo ? -1 : 0, count = halo ? TC + 2 : TC;
    for (int l = warp; l < lines; l += THREADS / 32) {
      const long long row = row_of(l);
      for (int e = first + lane; e < first + count; e += 32) {
        const int w = w0 + e;
        const bool ok = row >= 0 && w >= 0 && w < W;
        cp_async4(dst + (l * pitch + e) * 4, src + (ok ? row + w : 0), ok);
      }
    }
  }
}

// ---------------------------------------------------------------- forward
constexpr int PXT = 8;                              // neighbouring pixels a thread
constexpr int FWD_THREADS = TILE_PIXELS / PXT * 8;  // x 8 channel groups
constexpr int KC = 8;                               // input channels a stage
constexpr int CHUNKS = C / KC;                      // stages a unit
constexpr int FWD_STAGES = 4;

// A stage: KC channels of the unit's (ROWS + 2) x (TC + 2) input pixels, a
// row of one channel XPITCH words with pixel p of the unit at word PAD + p
// (the halo pixels -1 and TC at words 3 and TC + 4), then the weights
// [9][KC][64] of those channels.
template <int TC>
struct FwdStage {
  static constexpr int PAD = 4, XPITCH = TC + 8;
  static constexpr int X_FLOATS = KC * (Tile<TC>::ROWS + 2) * XPITCH;
  static constexpr int W_FLOATS = TAPS * KC * C;
  static constexpr int FLOATS = X_FLOATS + W_FLOATS;
  static constexpr int SMEM = FWD_STAGES * FLOATS * 4;  // 165,888 (TC 64), 165,888 (TC 32)
  static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
  static_assert(X_FLOATS % 4 == 0, "the weights of a stage start on 16 bytes");
};

// Stage = x[ci0 + cl][h0 - 1 + rr][w0 + p] at ((cl * (TR + 2) + rr) * XPITCH
// + PAD + p), p = -1 .. TC, zero outside the image, then
// wp[tap][ci0 + cl][co] at ((tap * KC + cl) * 64 + co).
template <int TC>
__device__ __forceinline__ void fwd_load(const float* __restrict__ x,
                                         const float* __restrict__ wp, float* stage, Unit t,
                                         int chunk, int H, int W, bool vec) {
  using S = FwdStage<TC>;
  constexpr int TR = Tile<TC>::ROWS;
  const uint32_t sx = smem_u32(stage);
  const float* src = x + ((size_t)t.n * C + chunk * KC) * H * W;
  auto row_of = [&](int line) -> long long {
    const int cl = line / (TR + 2), h = t.h0 - 1 + line - cl * (TR + 2);
    return h >= 0 && h < H ? ((long long)cl * H + h) * W : -1;
  };
  load_rows<TC, FWD_THREADS>(sx + S::PAD * 4, S::XPITCH, src, KC * (TR + 2), row_of, t.w0, W,
                             true, vec);
  const uint32_t sw = sx + S::X_FLOATS * 4;
  constexpr int PER_TAP = KC * C / 4;  // 16-byte chunks of one tap's KC channels
  for (int q = threadIdx.x; q < TAPS * PER_TAP; q += FWD_THREADS) {
    const int tap = q / PER_TAP, rem = q - tap * PER_TAP;
    cp_async16(sw + q * 16, wp + (tap * C + chunk * KC) * C + rem * 4);
  }
}

// acc[j][i] += sum over the stage's KC channels and the 9 taps; j: output
// channel 4 cg + j (j < 4) or 32 + 4 cg + j - 4, i: pixel c0 + i of `row`.
template <int TC>
__device__ __forceinline__ void fwd_compute(const float* stage, float (&acc)[8][PXT], int row,
                                            int c0, int cg) {
  using S = FwdStage<TC>;
  constexpr int TR = Tile<TC>::ROWS;
  const float* sx = stage + row * S::XPITCH + S::PAD + c0;
  const float* sw = stage + S::X_FLOATS + cg * 4;
#pragma unroll 1
  for (int cl = 0; cl < KC; ++cl) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      // xv[i] = pixel c0 - 1 + i of the row, i = 0 .. PXT + 1
      const float* xr = sx + (cl * (TR + 2) + ky) * S::XPITCH;
      float xv[PXT + 2];
      xv[0] = xr[-1];
#pragma unroll
      for (int i = 0; i < PXT; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(xr + i);
        xv[i + 1] = a.x, xv[i + 2] = a.y, xv[i + 3] = a.z, xv[i + 4] = a.w;
      }
      xv[PXT + 1] = xr[PXT];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wr = sw + ((ky * 3 + kx) * KC + cl) * C;
        const float4 b0 = *reinterpret_cast<const float4*>(wr);
        const float4 b1 = *reinterpret_cast<const float4*>(wr + 32);
        const float wv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < PXT; ++i) acc[j][i] = fmaf(xv[i + kx], wv[j], acc[j][i]);
      }
    }
  }
}

// vec: W is a multiple of 4 and x and y start on 16 bytes (16-byte copies
// and stores)
template <int TC>
__global__ void __launch_bounds__(FWD_THREADS, 1)
conv3x3_fwd_fp32(const float* __restrict__ x, const float* __restrict__ wp,
                 float* __restrict__ y, int H, int W, int n_units, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int FLOATS = FwdStage<TC>::FLOATS;
  constexpr int GROUPS = TC / PXT;  // pixel groups a row
  const int cg = threadIdx.x & 7, pg = threadIdx.x >> 3;
  const int row = pg / GROUPS, c0 = (pg % GROUPS) * PXT;

  const int total = (n_units - blockIdx.x + gridDim.x - 1) / gridDim.x * CHUNKS;
  // the copies' cursor runs FWD_STAGES - 1 steps ahead of the arithmetic's
  int l_step = 0, l_unit = blockIdx.x, l_chunk = 0;
  Unit lt = unit_of<TC>(l_unit, H, W);
  auto prefetch = [&]() {
    if (l_step < total) {
      fwd_load<TC>(x, wp, smem + (l_step % FWD_STAGES) * FLOATS, lt, l_chunk, H, W, vec);
      if (++l_chunk == CHUNKS) {
        l_chunk = 0;
        l_unit += gridDim.x;
        if (l_unit < n_units) lt = unit_of<TC>(l_unit, H, W);
      }
    }
    ++l_step;
    cp_async_commit();  // a group every step, empty past the end
  };
  for (int i = 0; i < FWD_STAGES - 1; ++i) prefetch();

  float acc[8][PXT];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < PXT; ++i) acc[j][i] = 0.f;

  int unit = blockIdx.x;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<FWD_STAGES - 2>();  // this thread's copies of step s have landed
    __syncthreads();                  // everyone's have, and step s - 1 is computed
    prefetch();                       // into the stage step s - 1 read
    fwd_compute<TC>(smem + (s % FWD_STAGES) * FLOATS, acc, row, c0, cg);
    if (s % CHUNKS == CHUNKS - 1) {
      const Unit t = unit_of<TC>(unit, H, W);
      const int h = t.h0 + row, w = t.w0 + c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = j < 4 ? 4 * cg + j : 32 + 4 * cg + j - 4;
        if (h < H) {
          float* yr = y + (((size_t)t.n * C + co) * H + h) * W + w;
          if (vec && w + PXT <= W) {
#pragma unroll
            for (int i = 0; i < PXT; i += 4) {
              *reinterpret_cast<float4*>(yr + i) =
                  make_float4(acc[j][i], acc[j][i + 1], acc[j][i + 2], acc[j][i + 3]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < PXT; ++i)
              if (w + i < W) yr[i] = acc[j][i];
          }
        }
#pragma unroll
        for (int i = 0; i < PXT; ++i) acc[j][i] = 0.f;
      }
      unit += gridDim.x;
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- dW
constexpr int DW_THREADS = 384;
constexpr int DW_STAGES = 6;
constexpr int DW_AHEAD = DW_STAGES - 3;  // the arithmetic reads the last three stages

// A stage: one image row of x, [64 ci][PITCH] with pixel p of the unit at
// word PAD + p (the run of pixels 4q - 1 .. 4q + 4 then is an 8-byte and a
// 16-byte load, both aligned), and one of gy, [64 co][PITCH] with pixel p
// at word p. PITCH is 4 mod 32 words, so that the 4 input or 8 output
// channels a warp reads at once, a pitch apart, start 4 banks apart.
template <int TC>
struct DwStage {
  static constexpr int PAD = 3, PITCH = TC + 4;
  static constexpr int X_FLOATS = C * PITCH;
  static constexpr int FLOATS = 2 * X_FLOATS;          // x row, gy row
  static constexpr int SMEM = DW_STAGES * FLOATS * 4;  // 208,896 (TC 64), 110,592 (TC 32)
  static_assert(PITCH % 32 == 4, "the row pitch must spread channels over the banks");
  static_assert(SMEM <= 232448, "a block may use 227 KB of shared memory");
};

// Stage = x[ci][r][w0 + p] at (ci * XPITCH + PAD + p), p = -1 .. TC, zero
// outside the image, r = h0 - 1 + j; then, for the unit's own rows,
// gy[co][r][w0 + p] at (co * GPITCH + p), zero past W.
template <int TC>
__device__ __forceinline__ void dw_load(const float* __restrict__ x,
                                        const float* __restrict__ gy, float* stage, Unit t,
                                        int j, int H, int W, bool vec) {
  using S = DwStage<TC>;
  const int r = t.h0 - 1 + j;
  const bool row_ok = r >= 0 && r < H;
  const uint32_t sx = smem_u32(stage);
  const size_t row0 = ((size_t)t.n * C * H + (row_ok ? r : 0)) * W;
  auto row_of = [&](int ch) -> long long { return row_ok ? (long long)ch * H * W : -1; };
  // x lands 3 words into its line, off 16 bytes: 4-byte copies
  load_rows<TC, DW_THREADS>(sx + S::PAD * 4, S::PITCH, x + row0, C, row_of, t.w0, W, true,
                            false);
  if (j >= 1 && j <= t.rows) {
    load_rows<TC, DW_THREADS>(sx + S::X_FLOATS * 4, S::PITCH, gy + row0, C, row_of, t.w0, W,
                              false, vec);
  }
}

// One output row: acc[kx][i][j] += sum over the row's pixels p of
// gy[cog + 8 j][p] * x[cig + 16 i][p + kx - 1], 4 pixels a step.
template <int TC>
__device__ __forceinline__ void dw_row(const float* xs, const float* gs,
                                       float (&acc)[3][4][8]) {
  using S = DwStage<TC>;
#pragma unroll 2
  for (int q = 0; q < TC / 4; ++q) {
    float g[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(gs + j * 8 * S::PITCH + 4 * q);
      g[j][0] = v.x, g[j][1] = v.y, g[j][2] = v.z, g[j][3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // xv[p] = pixel 4q - 1 + p, p = 0 .. 5: words 4q + 2 .. 4q + 7 of the line
      const float* xr = xs + i * 16 * S::PITCH + 4 * q;
      const float2 lo = *reinterpret_cast<const float2*>(xr - 1);
      const float4 hi = *reinterpret_cast<const float4*>(xr + 1);
      const float xv[6] = {lo.x, lo.y, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            acc[kx][i][j] = fmaf(xv[p + kx], g[j][p], acc[kx][i][j]);
    }
  }
}

// Block b writes part[b][(ky * 3 + kx) * 64 + ci][co]. vec: W is a multiple
// of 4 and gy starts on 16 bytes (16-byte copies of gy).
template <int TC>
__global__ void __launch_bounds__(DW_THREADS, 1)
conv3x3_dw_fp32(const float* __restrict__ x, const float* __restrict__ gy,
                float* __restrict__ part, int H, int W, int n_units, int vec) {
  extern __shared__ __align__(16) float smem[];
  using S = DwStage<TC>;
  const int ky = threadIdx.x >> 7, cog = threadIdx.x & 7, cig = (threadIdx.x >> 3) & 15;

  // the copies' cursor runs DW_AHEAD steps (image rows) ahead
  int l_step = 0, l_unit = blockIdx.x, l_j = 0;
  Unit lt = unit_of<TC>(l_unit, H, W);
  auto prefetch = [&]() {
    if (l_unit < n_units) {
      dw_load<TC>(x, gy, smem + (l_step % DW_STAGES) * S::FLOATS, lt, l_j, H, W, vec);
      if (++l_j == lt.rows + 2) {
        l_j = 0;
        l_unit += gridDim.x;
        if (l_unit < n_units) lt = unit_of<TC>(l_unit, H, W);
      }
    }
    ++l_step;
    cp_async_commit();
  };
  for (int i = 0; i < DW_AHEAD; ++i) prefetch();

  float acc[3][4][8];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[kx][i][j] = 0.f;

  int unit = blockIdx.x, j = 0, rows = unit_of<TC>(unit, H, W).rows;
  for (int s = 0; unit < n_units; ++s) {
    cp_async_wait<DW_AHEAD - 1>();  // this thread's copies of step s have landed
    __syncthreads();                // everyone's have, and step s - 1 is computed
    prefetch();                     // into the stage of step s - 3, read last at step s - 1
    if (j >= 2) {
      // output row h0 + j - 2: gy from step s - 1, x row + ky - 1 from step s - 2 + ky
      const float* xs = smem + ((s + DW_STAGES - 2 + ky) % DW_STAGES) * S::FLOATS + S::PAD +
                        cig * S::PITCH;
      const float* gs = smem + ((s + DW_STAGES - 1) % DW_STAGES) * S::FLOATS + S::X_FLOATS +
                        cog * S::PITCH;
      dw_row<TC>(xs, gs, acc);
    }
    if (++j == rows + 2) {
      j = 0;
      unit += gridDim.x;
      if (unit < n_units) rows = unit_of<TC>(unit, H, W).rows;
    }
  }
  cp_async_wait<0>();

  float* out = part + (size_t)blockIdx.x * TAPS * C * C;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        out[((ky * 3 + kx) * C + cig + 16 * i) * C + cog + 8 * jj] = acc[kx][i][jj];
      }
}

// ---------------------------------------------------------------- host
int units_of(int N, int H, int W, int tc) {
  const int tr = TILE_PIXELS / tc;
  return N * ((H + tr - 1) / tr) * ((W + tc - 1) / tc);
}

// 1 <= n_blocks <= units: every block has a unit (and writes its partial)
int check(int N, int H, int W, int n_blocks, int units) {
  if (N < 1 || H < 1 || W < 1 || (long long)N * C * H * W >= (1LL << 31) || n_blocks < 1 ||
      n_blocks > units) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// 16-byte copies and stores: rows of a multiple of 16 bytes from bases on 16
bool vec_ok(int W, const void* a, const void* b) {
  return W % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// `done` is the caller's flag for this kernel: the attribute is set at the
// kernel's first launch (one device a process)
template <typename K>
int allow_smem(K kernel, int bytes, int& done) {
  if (done != 0) {
    done = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return done;
}

template <int TC>
int launch_fwd(const float* x, const float* wp, float* y, int H, int W, int units, int n_blocks,
               cudaStream_t s) {
  static int attr = -1;
  const int err = allow_smem(conv3x3_fwd_fp32<TC>, FwdStage<TC>::SMEM, attr);
  if (err) return err;
  conv3x3_fwd_fp32<TC><<<n_blocks, FWD_THREADS, FwdStage<TC>::SMEM, s>>>(x, wp, y, H, W, units,
                                                                         vec_ok(W, x, y));
  return (int)cudaGetLastError();
}

template <int TC>
int launch_dw(const float* x, const float* gy, float* part, int H, int W, int units,
              int n_blocks, cudaStream_t s) {
  static int attr = -1;
  const int err = allow_smem(conv3x3_dw_fp32<TC>, DwStage<TC>::SMEM, attr);
  if (err) return err;
  conv3x3_dw_fp32<TC><<<n_blocks, DW_THREADS, DwStage<TC>::SMEM, s>>>(x, gy, part, H, W, units,
                                                                      vec_ok(W, gy, gy));
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns 0 or a cudaError; it neither allocates nor
// synchronises. All tensors are float32. n_blocks: the persistent blocks,
// at most the units of ops/conv.py::fp32_tile_schedule.
extern "C" {

// x, y: [N, 64, H, W]; wp: packed weights [9, 64 ci, 64 co].
int conv3x3_fwd_fp32_launch(const void* x, const void* wp, void* y, int N, int H, int W,
                            int n_blocks, int device, void* stream) {
  const int tc = W > 32 ? 64 : 32, units = units_of(N, H, W, tc);
  int err = check(N, H, W, n_blocks, units);
  if (err) return err;
  if ((err = (int)cudaSetDevice(device))) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *wf = (const float*)wp;
  return tc == 64 ? launch_fwd<64>(xf, wf, (float*)y, H, W, units, n_blocks, s)
                  : launch_fwd<32>(xf, wf, (float*)y, H, W, units, n_blocks, s);
}

// part: [n_blocks, 9 * 64, 64], one partial per block.
int conv3x3_dw_fp32_launch(const void* x, const void* gy, float* part, int N, int H, int W,
                           int n_blocks, int device, void* stream) {
  const int tc = W > 32 ? 64 : 32, units = units_of(N, H, W, tc);
  int err = check(N, H, W, n_blocks, units);
  if (err) return err;
  if ((err = (int)cudaSetDevice(device))) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *xf = (const float*)x, *gf = (const float*)gy;
  return tc == 64 ? launch_dw<64>(xf, gf, part, H, W, units, n_blocks, s)
                  : launch_dw<32>(xf, gf, part, H, W, units, n_blocks, s);
}

}  // extern "C"
