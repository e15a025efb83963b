// The ordered reduce of the 3x3 conv's dW partials (64 -> 64 channels), for
// Hopper (sm_90a), shared by every body of conv3x3_dw: the bf16 kernels of
// conv_wgmma.cu and the fp32 kernels of conv_fp32.cu each write one fp32
// partial [9 taps x 64 ci][64 co] per persistent block, and this kernel sums
// them.
//
// It replaces the cross-step accumulation of the TPU Pallas kernel
// intro_tc_vae_tpu/ops/conv_pallas.py:253 (_dwp_kernel), whose grid ran in
// order on one core and carried dW in one block across its steps. Hopper
// blocks run in no order, so the sum is a second pass: thread t adds entry t
// of the partials in order p = 0..n_parts-1, then rounds once to dW's dtype.
// No atomics: dW has the same bits in every run.
//
// What bounds it: n_parts x 147 KB of fp32 partials read once (18.9 MB at
// 128 partials, 0.0056 ms at 3.35 TB/s); 2,304 threads in 9 blocks of 256,
// each a chain of n_parts dependent loads and adds.
//
// Also here, so that it costs no nvcc run of its own: phase_stamp, the train
// step's device clock stamp (utils/tracing.py). One thread stores %globaltimer
// (ns) into slot i of a static int64 buffer; launched in stream order, it runs
// once the kernels queued before it have finished. The step's last stamp also
// writes each segment's length, seg[k] = slots[k + 1] - slots[k], in ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;  // input = output channels
constexpr int TAPS = 9;
constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
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

__global__ void phase_stamp(long long* slots, int i, float* seg) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[i] = (long long)t;
  if (seg != nullptr)
    for (int k = 0; k < i; ++k) seg[k] = (float)(slots[k + 1] - slots[k]) * 1e-6f;
}

}  // namespace

// C interface, loaded with ctypes. The launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it neither
// allocates nor synchronises. The reduce writes dW in `dtype`: 0 = float32,
// 1 = bfloat16.
extern "C" {

// part: float32 [n_parts, 9 * 64, 64]; dw: [64, 64, 3, 3] in `dtype`.
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

// slots: int64 [> i]; seg: float32 [>= i], or NULL for a stamp that is not
// the step's last.
int phase_stamp_launch(long long* slots, int i, float* seg, int device, void* stream) {
  if (i < 0) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  phase_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(slots, i, seg);
  return (int)cudaGetLastError();
}

}  // extern "C"
