// 3x3 convolution kernels, 64 -> 64 channels, stride 1, zero padding 1,
// for Hopper (sm_90a): the general bf16 bodies (any [N, 64, H, W]) and the
// ordered reduce of dW's partials that every body shares.
//
// They replace the TPU Pallas kernels of intro_tc_vae_tpu/ops/conv_pallas.py:
//   conv3x3_fwd        <- _fwd_kernel (conv_pallas.py:238): y = conv3x3(x, w),
//                         and dx = conv3x3(gy, rot_t(w)) on the rotated weights
//   conv3x3_dw         <- _dwp_kernel (conv_pallas.py:253): per-block partial
//                         sums of dW over slices of the pixels
//   conv3x3_dw_reduce     sums the partials in a fixed order (the TPU grid
//                         accumulated into one block across its ordered steps)
//
// Layout. Activations are the port's NCHW tensors [N, 64, H, W], read and
// written in place (no layout copy around the kernels); weights are OIHW
// [64, 64, 3, 3]; dW is OIHW in the operands' dtype. The TPU kernel's
// output-pair packing into Wp[6, 128, 128] and its 16-row halo served the
// TPU's 128 lanes and DMA tiling; there is none of that here.
//
// Design. Implicit GEMM with M = output pixels, N = 64 output channels and
// K = 9 taps x 64 input channels. A block owns a tile of 8 rows x 32 columns
// of one image (256 pixels) and stages its input rows plus a one-pixel halo,
// zero outside the image, in shared memory, channels innermost; it then walks
// the 9 taps, staging each tap's 64x64 weights. Ragged edges (W not a
// multiple of 32, H not a multiple of 8) are masked.
// wmma 16x16x16 on the tensor cores with fp32 accumulators; eight warps each
// own one tile row (32 pixels x 64 channels, 8 fragments). The output is
// rounded to bf16 once, through a per-warp staging buffer that turns the
// fragments into coalesced NCHW rows.
// dW: dW[co, ci, ky, kx] = sum over n, h, w of gy[n, co, h, w] *
// x[n, ci, h+ky-1, w+kx-1], a GEMM with M = 3 kx x 64 ci, N = 64 co and K =
// all pixels (524,288 at the flagship's paired [128, 64, 64, 64]). Hopper
// blocks run in no order, so the pixel reduction is split: block (p, ky) walks
// tiles p, p + P, p + 2P, ... and writes an fp32 partial [3 x 64, 64]; the
// reduce kernel sums the P partials in order p = 0..P-1. No atomics: dW is
// bit-reproducible from run to run.
//
// What bounds it on an H100. Per pixel the forward does 2 x 64 x 576 =
// 73,728 flops against 2 x 64 x 2 bytes of activations in bf16: about 288
// flops per byte, at the card's bf16 ridge, so a fast version is bound by
// the tensor cores. This version is bound by its instruction rate instead:
// wmma (mma.sync) fragments loaded from shared memory each k-step, no
// asynchronous copies, two barriers per tap, and 8 KB of weights re-staged
// per tap from L2. These are the general bodies: they take any [N, 64, H, W]
// in bf16. bf16 with W in {32, 64, 128} runs the wgmma kernels of
// conv_wgmma.cu instead and fp32 the kernels of conv_fp32.cu
// (ops/conv.py::kernel_body); all share conv3x3_dw_reduce with these.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int C = 64;                       // input = output channels
constexpr int TAPS = 9;
constexpr int TH = 8, TW = 32, PIX = TH * TW;  // output tile: 8 rows x 32 columns
constexpr int SH = TH + 2, SW = TW + 2;     // staged input tile with its halo
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Shared-memory leading dimensions, in elements.
// bf16: every wmma pointer must be 32-byte aligned. A staged input pixel is
// 80 elements (160 bytes) apart, so any (row, column) start is aligned.
constexpr int LDX_H = 80;        // input  [SH][SW][LDX_H]
constexpr int LDW_H = 72;        // tap weights [ci][LDW_H] (co innermost)
constexpr int LDG_H = PIX + 16;  // gy [co][LDG_H] (pixels innermost)
constexpr int LDO = 36;          // fp32 epilogue staging [co][LDO]

constexpr size_t SMEM_FWD_H = (size_t)SH * SW * LDX_H * 2 + (size_t)C * LDW_H * 2;
constexpr size_t SMEM_DW_H = (size_t)SH * SW * LDX_H * 2 + (size_t)C * LDG_H * 2;
static_assert((size_t)WARPS * 32 * LDO * 4 <= (size_t)SH * SW * LDX_H * 2,
              "the epilogue staging must fit in the staged input it reuses");

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

struct Tile {
  int n, h0, w0;
};

__device__ __forceinline__ Tile tile_of(int t, int H, int W) {
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  Tile tl;
  tl.w0 = (t % tiles_w) * TW;
  t /= tiles_w;
  tl.h0 = (t % tiles_h) * TH;
  tl.n = t / tiles_h;
  return tl;
}

// s[(sr * SW + sc) * LD + ci] = x[n, ci, h0 - 1 + sr, w0 - 1 + sc], zero
// outside the image. Consecutive threads read consecutive columns.
template <typename T, int LD>
__device__ void stage_input(const T* __restrict__ x, T* s, Tile tl, int H, int W) {
  for (int idx = threadIdx.x; idx < C * SH * SW; idx += THREADS) {
    const int ci = idx / (SH * SW);
    const int rem = idx - ci * (SH * SW);
    const int sr = rem / SW, sc = rem - sr * SW;
    const int h = tl.h0 - 1 + sr, w = tl.w0 - 1 + sc;
    T v = from_float<T>(0.f);
    if (h >= 0 && h < H && w >= 0 && w < W) {
      v = x[(((size_t)tl.n * C + ci) * H + h) * W + w];
    }
    s[(sr * SW + sc) * LD + ci] = v;
  }
}

// s[co * LD + p] = gy[n, co, h0 + p / TW, w0 + p % TW], zero outside the image.
template <typename T, int LD>
__device__ void stage_grad(const T* __restrict__ gy, T* s, Tile tl, int H, int W) {
  for (int idx = threadIdx.x; idx < C * PIX; idx += THREADS) {
    const int co = idx / PIX, p = idx - co * PIX;
    const int h = tl.h0 + p / TW, w = tl.w0 + p % TW;
    T v = from_float<T>(0.f);
    if (h < H && w < W) v = gy[(((size_t)tl.n * C + co) * H + h) * W + w];
    s[co * LD + p] = v;
  }
}

// s[ci * LD + co] = w[co, ci, tap / 3, tap % 3] (OIHW).
template <typename T, int LD>
__device__ void stage_tap(const T* __restrict__ w, T* s, int tap) {
  for (int idx = threadIdx.x; idx < C * C; idx += THREADS) {
    const int co = idx / C, ci = idx - co * C;
    s[ci * LD + co] = w[idx * TAPS + tap];
  }
}

__global__ void __launch_bounds__(THREADS)
conv3x3_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 bf16* __restrict__ y, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_x + SH * SW * LDX_H;
  const Tile tl = tile_of(blockIdx.x, H, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_input<bf16, LDX_H>(x, s_x, tl, H, W);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(acc[mt][nt], 0.f);

  for (int tap = 0; tap < TAPS; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    __syncthreads();  // the previous tap's weights are read; the input is staged
    stage_tap<bf16, LDW_H>(w, s_w, tap);
    __syncthreads();
#pragma unroll
    for (int ci0 = 0; ci0 < C; ci0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        wmma::load_matrix_sync(b[nt], s_w + ci0 * LDW_H + nt * 16, LDW_H);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // 16 output pixels of tile row `warp`, columns mt*16.. : A[m][k] =
        // input at (row warp + ky, column mt*16 + m + kx), channel ci0 + k
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, s_x + ((warp + ky) * SW + mt * 16 + kx) * LDX_H + ci0,
                               LDX_H);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) wmma::mma_sync(acc[mt][nt], a, b[nt], acc[mt][nt]);
      }
    }
  }

  __syncthreads();  // every warp is done with s_x: reuse it for the epilogue
  float* s_o = reinterpret_cast<float*>(smem) + warp * 32 * LDO;
  const int h = tl.h0 + warp, wc = tl.w0 + lane;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // s_o[co_local * LDO + pixel]
        wmma::store_matrix_sync(s_o + j * 16 * LDO + mt * 16, acc[mt][2 * half + j], LDO,
                                wmma::mem_col_major);
      }
    __syncwarp();
    if (h < H && wc < W) {
      for (int co = 0; co < 32; ++co) {
        y[(((size_t)tl.n * C + half * 32 + co) * H + h) * W + wc] =
            __float2bfloat16(s_o[co * LDO + lane]);
      }
    }
    __syncwarp();
  }
}

// Block (p, ky) writes part[p][(ky * 3 + kx) * 64 + ci][co] for kx = 0..2.
__global__ void __launch_bounds__(THREADS)
conv3x3_dw_bf16(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                float* __restrict__ part, int H, int W, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_x = reinterpret_cast<bf16*>(smem);
  bf16* s_g = s_x + SH * SW * LDX_H;
  const int ky = blockIdx.y, warp = threadIdx.x >> 5;
  // 12 M-tiles (kx, ci0) x 4 N-tiles (co0): a warp owns 3 x 2 fragments
  const int mt0 = 3 * (warp >> 1), nt0 = 2 * (warp & 1);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, H, W);
    __syncthreads();  // the previous tile is read
    stage_input<bf16, LDX_H>(x, s_x, tl, H, W);
    stage_grad<bf16, LDG_H>(gy, s_g, tl, H, W);
    __syncthreads();
    for (int ks = 0; ks < PIX / 16; ++ks) {
      const int r = ks >> 1, c = (ks & 1) * 16;  // 16 pixels of tile row r
      // B[k][n] = gy at pixel ks*16 + k, channel co0 + n
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b[j], s_g + (nt0 + j) * 16 * LDG_H + ks * 16, LDG_H);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int mt = mt0 + i, kx = mt >> 2, ci0 = (mt & 3) * 16;
        // A[m][k] = input channel ci0 + m at (row r + ky, column c + k + kx)
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, s_x + ((r + ky) * SW + c + kx) * LDX_H + ci0, LDX_H);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }

  float* out = part + (size_t)blockIdx.x * TAPS * C * C;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mt = mt0 + i, kx = mt >> 2, ci0 = (mt & 3) * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(out + ((ky * 3 + kx) * C + ci0) * C + (nt0 + j) * 16,
                              acc[i][j], C, wmma::mem_row_major);
    }
  }
}

// dw[co, ci, ky, kx] = sum over p = 0..n_parts-1, in that order, of
// part[p][(ky * 3 + kx) * 64 + ci][co], rounded once to T.
template <typename T>
__global__ void conv3x3_dw_reduce(const float* __restrict__ part, T* __restrict__ dw,
                                  int n_parts) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= TAPS * C * C) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * TAPS * C * C + idx];
  const int co = idx % C, ci = (idx / C) % C, tap = idx / (C * C);
  dw[(co * C + ci) * TAPS + tap] = from_float<T>(s);
}

int check_shape(int N, int H, int W) {
  if (N < 1 || H < 1 || W < 1 || (long long)N * C * H * W >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int n_tiles(int N, int H, int W) { return N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW); }

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises. Activations and weights are bfloat16; the
// reduce writes dW in `dtype`: 0 = float32, 1 = bfloat16.
extern "C" {

int conv3x3_fwd_launch(const void* x, const void* w, void* y, int N, int H, int W,
                       int device, void* stream) {
  int err = check_shape(N, H, W);
  if (err) return err;
  if ((err = (int)cudaSetDevice(device))) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = n_tiles(N, H, W);
  if ((err = allow_smem(conv3x3_fwd_bf16, SMEM_FWD_H))) return err;
  conv3x3_fwd_bf16<<<blocks, THREADS, SMEM_FWD_H, s>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)y, H, W);
  return (int)cudaGetLastError();
}

// part: float32 [n_parts, 9 * 64, 64]; 1 <= n_parts.
int conv3x3_dw_launch(const void* x, const void* gy, float* part, int N, int H, int W,
                      int n_parts, int device, void* stream) {
  int err = check_shape(N, H, W);
  if (err) return err;
  if (n_parts < 1) return (int)cudaErrorInvalidValue;
  if ((err = (int)cudaSetDevice(device))) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_parts, 3);
  if ((err = allow_smem(conv3x3_dw_bf16, SMEM_DW_H))) return err;
  conv3x3_dw_bf16<<<grid, THREADS, SMEM_DW_H, s>>>(
      (const bf16*)x, (const bf16*)gy, part, H, W, n_tiles(N, H, W));
  return (int)cudaGetLastError();
}

// dw: [64, 64, 3, 3] in `dtype`.
int conv3x3_dw_reduce_launch(const float* part, void* dw, int n_parts, int dtype,
                             int device, void* stream) {
  if (n_parts < 1) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (TAPS * C * C + THREADS - 1) / THREADS;
  if (dtype == 1) {
    conv3x3_dw_reduce<bf16><<<blocks, THREADS, 0, s>>>(part, (bf16*)dw, n_parts);
  } else if (dtype == 0) {
    conv3x3_dw_reduce<float><<<blocks, THREADS, 0, s>>>(part, (float*)dw, n_parts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
