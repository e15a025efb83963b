// 3x3 convolution, 64 -> 64 channels, stride 1, zero padding 1, bf16 with
// fp32 accumulation: the Hopper (sm_90a) bodies of conv3x3_fwd and conv3x3_dw
// for every bf16 shape. W in {32, 64, 128} runs the "wgmma" entry points and
// every other even W the "ragged" ones; both are the kernels below, the same
// pipeline instantiated at another box width and row landing. fp32 runs the
// kernels of conv_fp32.cu; the choice is the wrapper's shape rule
// (ops/conv.py::kernel_body).
//
// They replace the TPU Pallas kernels of intro_tc_vae_tpu/ops/conv_pallas.py:
//   conv3x3_fwd_wgmma, conv3x3_fwd_ragged
//                     <- _fwd_kernel (conv_pallas.py:238): y = conv3x3(x, w),
//                        and dx = conv3x3(gy, rot_t(w)) on weights packed with
//                        rot = 1
//   conv3x3_dw_wgmma, conv3x3_dw_ragged
//                     <- _dwp_kernel (conv_pallas.py:253): one fp32 partial dW
//                        per block; conv3x3_dw_reduce (conv_kernels.cu) sums
//                        the partials in block order, so dW has the same bits
//                        in every run (no atomics)
//   conv3x3_pack_w       OIHW weights -> [9 taps][64 co][64 ci] (bf16, this
//                        file's forward) or [9 taps][64 ci][64 co] (fp32, the
//                        forward of conv_fp32.cu), optionally rot180 with the
//                        channels swapped, in one pass
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s). [128, 64, 64, 64] is
// 524,288 pixels x 2 x 64 x 576 = 38.65 GFLOP = 0.0391 ms of tensor cores
// and 134 MB of activations = 0.0401 ms of device memory, so both kernels
// sit on the ridge: each input byte may be read from device memory once and
// the tensor cores must stay fed from shared memory. Measured there on an
// H100 at 700 W (chip_smoke.py): forward 0.079 ms, about half of its bound;
// dW 0.067 ms, 0.073 ms with its reduce, about 0.6 and 0.55 of the bound of
// the one function they compute. What holds them is shared-memory bandwidth
// (both wgmma operands come from shared memory) and, for dW, the 18.9 MB of
// fp32 partials it writes and the reduce reads again, traffic of this
// implementation that the bound does not count.
// The ragged entry points, measured the same way: at [128, 64, 48, 48] (one
// box of 64 a row, a quarter of it zero-fill) forward 0.063 ms and dW 0.056
// ms, 0.36 and 0.40 of their bound, under half of cuDNN's time. Where the
// rows land by cp.async (W % 8 != 0) the producer warp's copies, not the
// tensor cores, set the pace: at [64, 64, 64, 36] dW takes 0.083 ms for
// fewer products than at 48 x 48 (two rows' copies a row, x and gy); a
// deeper ring, sleeping waiters and register-staged loads did not move it.
// Small images are a latency chain a row long: ops/conv.py::row_chunk
// gives them short units on many blocks.
//
// Design, both kernels.
//   * Layout. In NCHW a row of one image is [64 channels][W pixels] with the
//     pixels contiguous. A box of BW pixels of such a row, BW = 16 (W <= 16),
//     32 (W <= 32) or 64 (wider rows: ceil(W / 64) boxes a row), lands as one
//     swizzled "slab" [64][BW] of 64 x 2 BW bytes (128-, 64- or 32-byte
//     swizzle), which is a wgmma operand as it lies: K-major when the pixels
//     are reduced (dW), MN-major B (tnspB) when the channels are reduced
//     (forward). Nothing is transposed in shared memory.
//   * Landing a row. Where the row stride is a multiple of 16 bytes (W % 8 =
//     0) a tensor map over the activations viewed as (w, h, c, n) with box
//     (BW, 1, 64, 1) lands it: TMA (template TMA = true). Its out-of-bounds
//     fill gives the zero padding in H (box rows -1 and H) and the zeros of a
//     box's columns past W, which are also the padding right of the image;
//     the TMA store of y clips the same columns. Other rows (W = 6, 20, 36,
//     ...) TMA cannot describe: the producer warp's 32 lanes copy them with
//     cp.async, 4 bytes (two pixels) a lane, zero-filled (src-size 0) outside
//     the image, to the same swizzled offsets, and signal the same mbarrier
//     (cp.async.mbarrier.arrive.noinc); the forward then stores y from its
//     staging tile with 4-byte stores masked at W.
//   * The kx shift is one pixel = 2 bytes along the contiguous axis. A wgmma
//     descriptor addresses 16-byte units, and a TMA box must start on 16
//     bytes of the innermost axis too (a start of w0 - 1 is an illegal
//     instruction on the card), so neither can carry it. Three warps make the
//     two shifted copies in shared memory instead: for each landed row they
//     read the slab in 16-byte chunks, take the neighbouring chunks' edge
//     pixels by warp shuffle, funnel-shift, and write slab kx = 0 (out[p] =
//     in[p-1]) and kx = 2 (out[p] = in[p+1]) at the same swizzled offsets;
//     the pixel beside the slab is the zero padding or, where a row has more
//     than one box, the neighbouring box's, read from x. That costs 24 KB of
//     shared-memory traffic a row beside the wgmmas' 100-150 KB. The ky shift
//     is a whole-slab offset.
//   * One persistent block per SM walks units (image n, rc rows, BW columns,
//     the last box of a row cut at W) u = b, b + P, ...; the schedule is
//     ops/conv.py::tile_schedule. Walking down a unit, a ring of S row stages
//     holds input rows h0-1 .. h0+rc; each row is fetched once per unit and
//     used by the three output rows around it, for all 9 taps.
//   * Warp specialisation in a block of 512 threads (128 registers each, no
//     spills, so no setmaxnreg): warpgroups 0-2 consume (wgmma), warp 12
//     produces (its first thread issues TMA; with cp.async all 32 lanes copy),
//     warps 13-15 shift. Three mbarriers a stage: full (row landed) -> ready
//     (copies made, after fence.proxy.async) -> empty (every consumer warp is
//     done with it). With cp.async a consumer also fences the proxies after
//     each ready wait, so its wgmmas see the copied rows.
//   * wgmma with both operands from shared memory. Holding the operand all
//     taps share in registers would cut the shared-memory reads further (an
//     m64n64k16 from shared memory reads 4 KB per 32 clocks, the SM's whole
//     128 B/clk); this version keeps both in shared memory, which needs no
//     ldmatrix through the swizzle. A narrower box costs more shared-memory
//     reads per product (A, 2 KB, is read for every k-step of every box), so
//     the box is the widest that a row needs: BW = 16 for W <= 16, 32 for W
//     <= 32, else 64 (at W = 48 one box of 64 with a quarter zero-fill is
//     cheaper than three of 16).
// Forward: D[co, pixel] += Wtap[co, ci] X[ci, pixel + shift]: A = packed
//   weights, all 9 taps resident (72 KB, loaded once per block by TMA), B =
//   the slab of row h + ky - 1, copy kx; m64nBWk16, 36 a row. Consumer
//   warpgroup g owns the output rows o = g mod 3 of the block's walk, so the
//   warpgroups run staggered. Epilogue: fp32 -> bf16 -> swizzled staging
//   tile -> one TMA store of the whole [64][BW] row (clipped at W), which
//   overlaps the other warpgroups' products, or the masked stores above.
// dW: D[co, kx ci] += GY[co, pixels] X[kx ci, pixels + shift]: A = the gy
//   slab of row h, B = the three kx slabs of row h + ky - 1, which lie one
//   after the other and so are one K-major operand of 192 rows: one
//   m64n192k16 a k-step reads gy once for three taps; k-steps whose 16
//   pixels all lie past W are skipped. Consumer warpgroup ky holds the 96
//   accumulators a thread for the whole walk, keeps one wgmma group in
//   flight, and writes part[block][(ky*3+kx)*64 + ci][co] at the end. With
//   P <= 132 partials the ordered reduce reads 19 MB.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached by dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;
constexpr int TAPS = 9;
constexpr int CONSUMER_WGS = 3;
constexpr int PRODUCER_TID = CONSUMER_WGS * 128;   // warp 12 lands the rows
constexpr int SHIFT_TID = PRODUCER_TID + 32;       // warps 13-15 make the kx copies
constexpr int SHIFT_THREADS = 96;
constexpr int THREADS = SHIFT_TID + SHIFT_THREADS;  // 512: 128 registers a thread
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // 227 KB
constexpr int W_BYTES = TAPS * C * C * 2;  // packed weights, 72 KB

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase differs from `parity`. No wait of these
// kernels lasts a second: one that does is a fault, reported as a trap
// instead of a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, uint64_t map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, uint64_t map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(uint64_t map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// E (4 or 8) bytes global -> shared, or E bytes of zeros where !valid
// (src-size 0: nothing is read)
template <int E>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(E),
               "r"(valid ? E : 0)
               : "memory");
}

// the barrier receives one arrival once this thread's earlier cp.async
// copies have landed (noinc: the arrival counts against its expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the committed stores are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// all but the newest committed group are complete
__device__ __forceinline__ void wgmma_wait_prev() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets in 16-byte units, layout 1 = 128-byte swizzle, 2 = 64-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | ((uint64_t)layout << 62);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 operands from shared memory,
// fp32 accumulators. TB = 1: B is MN-major (its N axis contiguous).
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32].
template <int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16].
template <int TB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// D[64 x 192] (+)= A[64 x 16] B[16 x 192], both K-major: B is three slabs
// of 64 rows that lie one after the other.
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <int TB>
__device__ __forceinline__ void wgmma_px(float (&d)[32], uint64_t a, uint64_t b, int s) {
  wgmma_n64<TB>(d, a, b, s);
}
template <int TB>
__device__ __forceinline__ void wgmma_px(float (&d)[16], uint64_t a, uint64_t b, int s) {
  wgmma_n32<TB>(d, a, b, s);
}
template <int TB>
__device__ __forceinline__ void wgmma_px(float (&d)[8], uint64_t a, uint64_t b, int s) {
  wgmma_n16<TB>(d, a, b, s);
}

// ---------------------------------------------------------------- shapes
// BW pixels of a row make one slab [64 channels][BW] of ROWB-byte rows.
template <int BW>
struct Slab {
  static_assert(BW == 16 || BW == 32 || BW == 64, "a box is 16, 32 or 64 pixels");
  static constexpr int ROWB = BW * 2;        // 128, 64 or 32: the swizzle span
  static constexpr int BYTES = C * ROWB;     // 8, 4 or 2 KB
  // wgmma descriptor layout: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr int LAYOUT = BW == 64 ? 1 : (BW == 32 ? 2 : 3);
  static constexpr int ATOM = 8 * ROWB;      // 8 rows: one swizzle atom
  // the 16-byte chunk index is XORed with the row's low bits
  static constexpr int SWZ_MASK = BW == 64 ? 7 : (BW == 32 ? 3 : 1);
  __device__ static __forceinline__ uint32_t swizzle(uint32_t off) {
    return off ^ (((off >> 7) & SWZ_MASK) << 4);
  }
};

struct Unit {
  int n, h0, w0;
};

// unit u of the walk: columns fastest, then row chunks, then images; the
// last box of a row reaches past W where bw does not divide it
// (ops/conv.py::tile_schedule)
__device__ __forceinline__ Unit unit_of(int u, int H, int W, int rc, int bw) {
  const int wcn = (W + bw - 1) / bw, hcn = H / rc;
  Unit t;
  t.w0 = (u % wcn) * bw;
  u /= wcn;
  t.h0 = (u % hcn) * rc;
  t.n = u / hcn;
  return t;
}

struct Ring {
  uint32_t full, ready, empty;  // shared addresses of the barrier arrays
  int s, phase, stages;
  __device__ __forceinline__ void advance() {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// A walk over the copy units (E bytes: E/2 pixels) of the 64 channel rows of
// a slab, `span` units a channel row, `stride` threads abreast: thread t
// takes units t, t + stride, ... as (channel c, unit q), advanced without a
// division.
struct RowWalk {
  int c, q, dc, dq, span;
  __device__ __forceinline__ RowWalk(int t, int span_, int stride)
      : c(t / span_), q(t % span_), dc(stride / span_), dq(stride % span_), span(span_) {}
  __device__ __forceinline__ void advance() {
    c += dc;
    q += dq;
    if (q >= span) {
      q -= span;
      ++c;
    }
  }
};

// cp.async landing (W % 8 != 0): the units of one slab row (one x or gy row
// of the image) that this lane copies, E bytes each. A unit inside the image
// is copied; one outside it (rows -1 and H; columns past W) is zero-filled,
// except where a row has a single box: there the columns past W were zeroed
// at the start and no unit past W is walked at all.
template <int BW, int E>
__device__ __forceinline__ void copy_row(uint32_t dst, const bf16* __restrict__ src, Unit t,
                                         int h, int H, int W, int span) {
  using SL = Slab<BW>;
  const bool row_in = h >= 0 && h < H;
  const size_t plane = (size_t)H * W;
  const bf16* row = src + ((size_t)t.n * C * H + (row_in ? h : 0)) * W + t.w0;
  RowWalk it(threadIdx.x & 31, span, 32);
  for (int i = threadIdx.x & 31; i < C * span; i += 32) {
    const int col = it.q * (E / 2);
    const bool in = row_in && t.w0 + col < W;
    cp_async<E>(dst + SL::swizzle(it.c * SL::ROWB + it.q * E), in ? row + it.c * plane + col : src,
                in);
    it.advance();
  }
}

// The producer. For every unit of this block, rows h0-1 .. h0+rc: the x row
// into slab 1 of the stage and, for dW and rows inside the unit, the gy row
// into slab 3. Rows outside the image, and a box's columns past W, arrive as
// zeros. TMA: one thread (warp 12's first) issues the box loads. Otherwise
// warp 12's 32 lanes copy the rows with cp.async (copy_row), 8 bytes a copy
// where W % 4 = 0 (the row stride is then a multiple of 8 bytes), else 4,
// and each lane's arrival on `full` follows its copies (the barrier expects
// 32).
template <int BW, bool DW, bool TMA>
__device__ __forceinline__ void produce(uint64_t xmap, uint64_t gmap, const bf16* __restrict__ x,
                                        const bf16* __restrict__ gy, uint32_t ring_base, Ring r,
                                        int H, int W, int rc, int n_units) {
  using SL = Slab<BW>;
  constexpr int STAGE = (DW ? 4 : 3) * SL::BYTES;
  const bool wide = W % 4 == 0;                 // 8-byte copies
  const int per_unit = wide ? 4 : 2;            // pixels a copy
  // units walked a channel row: those inside a single box, else the box
  const int span = W <= BW ? (W + per_unit - 1) / per_unit : BW / per_unit;
  r.phase = 1;  // the ring starts empty: the first waits pass
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit t = unit_of(u, H, W, rc, BW);
    for (int j = 0; j < rc + 2; ++j) {
      const int h = t.h0 - 1 + j;
      const bool with_gy = DW && j >= 1 && j <= rc;
      mbar_wait(r.empty + 8 * r.s, r.phase);
      const uint32_t full = r.full + 8 * r.s;
      const uint32_t dst = ring_base + r.s * STAGE;
      if constexpr (TMA) {
        mbar_expect_tx(full, (with_gy ? 2 : 1) * SL::BYTES);
        tma_load_4d(dst + SL::BYTES, xmap, full, t.w0, h, 0, t.n);
        if (with_gy) tma_load_4d(dst + 3 * SL::BYTES, gmap, full, t.w0, h, 0, t.n);
      } else {
        if (wide) {
          copy_row<BW, 8>(dst + SL::BYTES, x, t, h, H, W, span);
          if (with_gy) copy_row<BW, 8>(dst + 3 * SL::BYTES, gy, t, h, H, W, span);
        } else {
          copy_row<BW, 4>(dst + SL::BYTES, x, t, h, H, W, span);
          if (with_gy) copy_row<BW, 4>(dst + 3 * SL::BYTES, gy, t, h, H, W, span);
        }
        cp_async_mbar_arrive(full);
      }
      r.advance();
    }
  }
}

// The shifter warps (13-15). A kx shift is one pixel = 2 bytes along the
// contiguous axis; a wgmma descriptor addresses 16-byte units and so does a
// TMA box start, so neither can carry it. For every row that has landed in
// slab 1 these 96 threads write slab 0 (out[p] = in[p-1], kx = 0) and slab
// 2 (out[p] = in[p+1], kx = 2) at the same swizzled offsets: each thread
// takes 16-byte chunks, gets the neighbouring chunks' edge pixels by warp
// shuffle, and funnel-shifts. The pixels beside the slab are zero padding,
// or, where a row has more than one box, the neighbouring box's, read from
// x (a box's columns past W are zeros already).
template <int BW, bool DW>
__device__ __forceinline__ void shift_rows(const bf16* __restrict__ x, uint32_t ring_base,
                                           Ring r, int H, int W, int rc, int n_units) {
  using SL = Slab<BW>;
  constexpr int STAGE = (DW ? 4 : 3) * SL::BYTES;
  constexpr int CH = BW / 8;                  // 16-byte chunks in a slab row
  constexpr int ROWS = SHIFT_THREADS / CH;    // slab rows (channels) per pass
  constexpr int PASSES = (C + ROWS - 1) / ROWS;
  const int tid = threadIdx.x - SHIFT_TID, q = tid % CH, c_in = tid / CH;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit t = unit_of(u, H, W, rc, BW);
    for (int j = 0; j < rc + 2; ++j) {
      const int h = t.h0 - 1 + j;
      uint32_t edge_l[PASSES], edge_r[PASSES];
#pragma unroll
      for (int it = 0; it < PASSES; ++it) {
        edge_l[it] = 0;
        edge_r[it] = 0;
      }
      if (W != BW && h >= 0 && h < H) {
#pragma unroll
        for (int it = 0; it < PASSES; ++it) {
          const int c = min(it * ROWS + c_in, C - 1);
          const size_t row = (((size_t)t.n * C + c) * H + h) * W;
          if (q == 0 && t.w0 > 0) edge_l[it] = xs[row + t.w0 - 1];
          if (q == CH - 1 && t.w0 + BW < W) edge_r[it] = xs[row + t.w0 + BW];
        }
      }
      mbar_wait(r.full + 8 * r.s, r.phase);
      const uint32_t stage = ring_base + r.s * STAGE;
#pragma unroll
      for (int it = 0; it < PASSES; ++it) {
        // the last pass runs past channel 63: its lanes shuffle and skip
        const bool live = it * ROWS + c_in < C;
        const uint32_t off = SL::swizzle(min(it * ROWS + c_in, C - 1) * SL::ROWB + q * 16);
        uint32_t w0, w1, w2, w3;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(w0), "=r"(w1), "=r"(w2), "=r"(w3)
                     : "r"(stage + SL::BYTES + off)
                     : "memory");
        uint32_t prev = __shfl_up_sync(0xffffffffu, w3, 1);
        uint32_t next = __shfl_down_sync(0xffffffffu, w0, 1);
        if (q == 0) prev = edge_l[it] << 16;
        if (q == CH - 1) next = edge_r[it];
        if (!live) continue;
        // __funnelshift_r(lo, hi, 16) = (lo >> 16) | (hi << 16)
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(stage + off),
                     "r"(__funnelshift_r(prev, w0, 16)), "r"(__funnelshift_r(w0, w1, 16)),
                     "r"(__funnelshift_r(w1, w2, 16)), "r"(__funnelshift_r(w2, w3, 16))
                     : "memory");
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(stage + 2 * SL::BYTES + off),
                     "r"(__funnelshift_r(w0, w1, 16)), "r"(__funnelshift_r(w1, w2, 16)),
                     "r"(__funnelshift_r(w2, w3, 16)), "r"(__funnelshift_r(w3, next, 16))
                     : "memory");
      }
      fence_proxy_async();  // the wgmmas read these generic-proxy writes
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(r.ready + 8 * r.s);
      r.advance();
    }
  }
}

// The whole block zeroes [addr, addr + bytes) (a multiple of 16): the ring
// of a cp.async kernel, whose columns past W a single-box row never writes.
__device__ __forceinline__ void zero_smem(uint32_t addr, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += THREADS * 16) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr + i), "r"(0) : "memory");
  }
}

__device__ __forceinline__ void release(uint32_t empty, int stage) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * stage);
}

// The forward's epilogue where TMA cannot store a row (W % 8 != 0): the
// `cols` pixels of the staged [64][BW] row that lie inside the image, E
// bytes a store, the warpgroup's 128 threads abreast over (channel, unit).
template <int BW, int E>
__device__ __forceinline__ void store_row(bf16* __restrict__ yrow, uint32_t staged,
                                          size_t plane, int cols, int tid) {
  using SL = Slab<BW>;
  using Word = typename std::conditional<E == 8, uint2, uint32_t>::type;
  const int span = cols / (E / 2);  // W % (E / 2) = 0, and so is cols
  RowWalk it(tid, span, 128);
  for (int i = tid; i < C * span; i += 128) {
    const uint32_t a = staged + SL::swizzle(it.c * SL::ROWB + it.q * E);
    Word v;
    if constexpr (E == 8) {
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
    } else {
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
    }
    *reinterpret_cast<Word*>(yrow + it.c * plane + it.q * (E / 2)) = v;
    it.advance();
  }
}

// ---------------------------------------------------------------- forward
template <int BW, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_fwd_wgmma(__grid_constant__ const CUtensorMap xmap,
                  __grid_constant__ const CUtensorMap wmap,
                  __grid_constant__ const CUtensorMap ymap, const bf16* __restrict__ x,
                  bf16* __restrict__ y, int H, int W, int rc, int n_units, int stages) {
  using SL = Slab<BW>;
  constexpr int STAGE = 3 * SL::BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_w = base;                                  // [9][64 co][64 ci]
  const uint32_t s_out = s_w + W_BYTES;                       // [3 warpgroups][64][BW]
  const uint32_t s_ring = s_out + CONSUMER_WGS * SL::BYTES;   // [stages][3 kx][64][BW]
  const uint32_t s_bar = s_ring + stages * STAGE;
  Ring r{s_bar, s_bar + 8 * MAX_STAGES, s_bar + 16 * MAX_STAGES, 0, 0, stages};
  const uint32_t wbar = s_bar + 24 * MAX_STAGES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(r.full + 8 * i, TMA ? 1 : 32);
      mbar_init(r.ready + 8 * i, SHIFT_THREADS / 32);
      mbar_init(r.empty + 8 * i, CONSUMER_WGS * 4);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!TMA) zero_smem(s_ring, stages * STAGE);
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMER_WGS) {
    if (threadIdx.x < PRODUCER_TID + 32) {
      if (threadIdx.x == PRODUCER_TID) {
        mbar_expect_tx(wbar, W_BYTES);
#pragma unroll
        for (int tap = 0; tap < TAPS; ++tap) {
          tma_load_2d(s_w + tap * C * C * 2, reinterpret_cast<uint64_t>(&wmap), wbar, 0,
                      tap * C);
        }
      }
      if (TMA ? threadIdx.x == PRODUCER_TID : true) {
        produce<BW, false, TMA>(reinterpret_cast<uint64_t>(&xmap), 0, x, nullptr, s_ring, r, H,
                                W, rc, n_units);
      }
    } else if (threadIdx.x >= SHIFT_TID) {
      shift_rows<BW, false>(x, s_ring, r, H, W, rc, n_units);
    }
  } else {
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const uint32_t my_out = s_out + wg * SL::BYTES;
    float acc[BW / 2];
    int sm2 = 0, sm1 = 0;  // the stages of the two rows before r.s
    int o = 0;             // output rows of this block's walk so far
    mbar_wait(wbar, 0);
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit t = unit_of(u, H, W, rc, BW);
      for (int j = 0; j < rc + 2; ++j) {
        mbar_wait(r.ready + 8 * r.s, r.phase);
        if (!TMA) fence_proxy_async();  // the cp.async rows, for the wgmmas
        if (j >= 2) {
          if (o % CONSUMER_WGS == wg) {
            const int h = t.h0 + j - 2;
            wgmma_fence();
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              const int st = ky == 0 ? sm2 : (ky == 1 ? sm1 : r.s);
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                const uint32_t b0 = s_ring + st * STAGE + kx * SL::BYTES;
                const uint32_t a0 = s_w + (ky * 3 + kx) * C * C * 2;
#pragma unroll
                for (int ks = 0; ks < C / 16; ++ks) {
                  // A: weights [co][ci], K-major, 128-byte rows
                  const uint64_t a = make_desc(a0 + ks * 32, 16, 1024, 1);
                  // B: slab [ci][pixels], MN-major: k-steps advance by 16 rows
                  const uint64_t b = make_desc(b0 + ks * 16 * SL::ROWB, SL::ATOM, SL::ATOM,
                                               SL::LAYOUT);
                  wgmma_px<1>(acc, a, b, (ky | kx | ks) != 0);
                }
              }
            }
            wgmma_commit();
            wgmma_wait_all();
            // epilogue: the previous row's store has read the staging tile
            if (TMA && tid == 0) bulk_wait_read();
            named_bar_sync(1 + wg, 128);
#pragma unroll
            for (int jj = 0; jj < BW / 8; ++jj) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = warp * 16 + (lane >> 2) + 8 * half;
                const uint32_t off = SL::swizzle(row * SL::ROWB + jj * 16 + (lane & 3) * 4);
                const __nv_bfloat162 v =
                    __floats2bfloat162_rn(acc[4 * jj + 2 * half], acc[4 * jj + 2 * half + 1]);
                asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(my_out + off),
                             "r"(*reinterpret_cast<const uint32_t*>(&v))
                             : "memory");
              }
            }
            if constexpr (TMA) {
              fence_proxy_async();
              named_bar_sync(1 + wg, 128);
              if (tid == 0) {
                tma_store_4d(reinterpret_cast<uint64_t>(&ymap), my_out, t.w0, h, 0, t.n);
                bulk_commit();
              }
            } else {
              named_bar_sync(1 + wg, 128);
              bf16* yrow = y + ((size_t)t.n * C * H + h) * W + t.w0;
              const size_t plane = (size_t)H * W;
              if (W % 4 == 0) {
                store_row<BW, 8>(yrow, my_out, plane, min(BW, W - t.w0), tid);
              } else {
                store_row<BW, 4>(yrow, my_out, plane, min(BW, W - t.w0), tid);
              }
            }
          }
          ++o;
          release(r.empty, sm2);
        }
        if (j == rc + 1) {
          release(r.empty, sm1);
          release(r.empty, r.s);
        }
        sm2 = sm1;
        sm1 = r.s;
        r.advance();
      }
    }
    if (TMA && tid == 0) bulk_wait_all();
  }
}

// ---------------------------------------------------------------- dW
// CUT: a row's last box may reach past W (the ragged entry points); the
// k-steps past W are skipped. The wgmma entry points' boxes tile the row, and
// their instances keep the unconditional k-loop (a branch in it cost dW 2-3 %).
template <int BW, bool TMA, bool CUT>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_dw_wgmma(__grid_constant__ const CUtensorMap xmap,
                 __grid_constant__ const CUtensorMap gmap, const bf16* __restrict__ x,
                 const bf16* __restrict__ gy, float* __restrict__ part, int H, int W, int rc,
                 int n_units, int stages) {
  using SL = Slab<BW>;
  constexpr int STAGE = 4 * SL::BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_ring = base;  // [stages][x kx 0..2, gy][64][BW]
  const uint32_t s_bar = s_ring + stages * STAGE;
  Ring r{s_bar, s_bar + 8 * MAX_STAGES, s_bar + 16 * MAX_STAGES, 0, 0, stages};

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(r.full + 8 * i, TMA ? 1 : 32);
      mbar_init(r.ready + 8 * i, SHIFT_THREADS / 32);
      mbar_init(r.empty + 8 * i, CONSUMER_WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!TMA) zero_smem(s_ring, stages * STAGE);
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == CONSUMER_WGS) {
    if (TMA ? threadIdx.x == PRODUCER_TID : threadIdx.x < PRODUCER_TID + 32) {
      produce<BW, true, TMA>(reinterpret_cast<uint64_t>(&xmap), reinterpret_cast<uint64_t>(&gmap),
                             x, gy, s_ring, r, H, W, rc, n_units);
    } else if (threadIdx.x >= SHIFT_TID) {
      shift_rows<BW, true>(x, s_ring, r, H, W, rc, n_units);
    }
  } else {
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int ky = wg;
    float acc[96];  // [kx][32]: D[co][kx * 64 + ci]
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[i] = 0.f;
    int sm2 = 0, sm1 = 0, done = 0;  // done: the stage the previous group read last
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      // k-steps that hold a pixel of the image: the unit's box may reach past W
      const int k_steps = CUT ? min(BW, W - unit_of(u, H, W, rc, BW).w0 + 15) / 16 : BW / 16;
      for (int j = 0; j < rc + 2; ++j) {
        mbar_wait(r.ready + 8 * r.s, r.phase);
        if (!TMA) fence_proxy_async();  // the cp.async rows, for the wgmmas
        if (j >= 2) {
          // output row j-2 of the unit: gy is in the stage of loaded row
          // j-1, x (row + ky - 1) in the stage of loaded row j-2+ky, whose
          // three kx slabs are one B operand of 192 rows
          const int st = ky == 0 ? sm2 : (ky == 1 ? sm1 : r.s);
          const uint32_t g0 = s_ring + sm1 * STAGE + 3 * SL::BYTES;
          const uint32_t x0 = s_ring + st * STAGE;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BW / 16; ++ks) {
            if (!CUT || ks < k_steps) {
              // both K-major: [channels][pixels], k-steps advance 32 bytes
              const uint64_t a = make_desc(g0 + ks * 32, 16, SL::ATOM, SL::LAYOUT);
              const uint64_t b = make_desc(x0 + ks * 32, 16, SL::ATOM, SL::LAYOUT);
              wgmma_n192(acc, a, b);
            }
          }
          wgmma_commit();
          // one group stays in flight: the stage of loaded row j-3 is free
          // once the group before this one is complete
          wgmma_wait_prev();
          if (j > 2) release(r.empty, done);
          done = sm2;
        }
        if (j == rc + 1) {
          wgmma_wait_all();
          release(r.empty, sm2);
          release(r.empty, sm1);
          release(r.empty, r.s);
        }
        sm2 = sm1;
        sm1 = r.s;
        r.advance();
      }
    }
    wgmma_wait_all();
    // acc[32 kx + 4 jj + 2 half + e] = D[co = 16 warp + lane/4 + 8 half]
    //                               [ci = 8 jj + 2 (lane%4) + e]
    float* out = part + (size_t)blockIdx.x * TAPS * C * C;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = warp * 16 + (lane >> 2) + 8 * half;
            const int ci = jj * 8 + (lane & 3) * 2 + e;
            out[((ky * 3 + kx) * C + ci) * C + co] = acc[kx * 32 + 4 * jj + 2 * half + e];
          }
  }
}

// out[tap][co][ci] (or, CO_INNER, out[tap][ci][co]) = w[co][ci][tap], or with
// rot: rot_t(w)[co][ci][tap] = w[ci][co][8 - tap] (rot180, channels swapped).
template <typename T, bool CO_INNER>
__global__ void conv3x3_pack_w(const T* __restrict__ w, T* __restrict__ out, int rot) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= TAPS * C * C) return;
  const int inner = idx % C, outer = (idx / C) % C, tap = idx / (C * C);
  const int co = CO_INNER ? inner : outer, ci = CO_INNER ? outer : inner;
  out[idx] = rot ? w[(ci * C + co) * TAPS + (TAPS - 1 - tap)] : w[(co * C + ci) * TAPS + tap];
}

// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!lib) return nullptr;
    return reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// activations [N, 64, H, W] bf16 as (w, h, c, n), box (bw, 1, 64, 1)
int act_map(CUtensorMap* m, const void* p, int N, int H, int W, int bw) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 (cuuint64_t)C * H * W * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bw, 1, (cuuint32_t)C, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                         strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         bw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                         : bw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                    : CU_TENSOR_MAP_SWIZZLE_32B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// packed weights [576][64] bf16, box [64][64]
int weight_map(CUtensorMap* m, const void* p) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)TAPS * C};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {(cuuint32_t)C, (cuuint32_t)C};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                         strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Pixels of a box (ops/conv.py::box_width): the widest a row needs.
int box_width(int W) { return W <= 16 ? 16 : (W <= 32 ? 32 : 64); }

// W even (W in {32, 64, 128} for the wgmma entry points), rc divides H,
// 1 <= n_blocks <= units; the activations 16-byte aligned where TMA lands
// the rows (W % 8 = 0), else aligned to the cp.async copies' 8 or 4 bytes
int check(const void* a, const void* b, int N, int H, int W, int rc, int n_blocks, bool fast) {
  const uintptr_t align = W % 8 == 0 ? 16 : (W % 4 == 0 ? 8 : 4);
  if (N < 1 || H < 1 || W < 2 || W % 2 != 0 || (fast && W != 32 && W != 64 && W != 128) ||
      rc < 1 || H % rc != 0 || (long long)N * C * H * W >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(a) % align != 0 || reinterpret_cast<uintptr_t>(b) % align != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int bw = box_width(W);
  const long long units = (long long)N * (H / rc) * ((W + bw - 1) / bw);
  if (n_blocks < 1 || n_blocks > units) return (int)cudaErrorInvalidValue;
  return 0;
}

constexpr int BAR_BYTES = 24 * MAX_STAGES + 8;

// `done` is the caller's flag for this kernel: the attribute is set at the
// kernel's first launch (one device a process)
template <typename K>
int allow_smem(K kernel, int bytes, int& done) {
  if (done != 0) {
    done = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return done;
}

// the tensor map of activations where TMA lands the rows; zeros (unused)
// where cp.async does
template <bool TMA>
int rows_map(CUtensorMap* m, const void* p, int N, int H, int W, int bw) {
  if (!TMA) {
    memset(m, 0, sizeof(*m));
    return 0;
  }
  return act_map(m, p, N, H, W, bw);
}

template <int BW, bool TMA>
int launch_fwd(const void* x, const void* wp, void* y, int N, int H, int W, int rc,
               int n_blocks, cudaStream_t s) {
  using SL = Slab<BW>;
  const int fixed = 1024 + W_BYTES + CONSUMER_WGS * SL::BYTES + BAR_BYTES;
  int stages = (SMEM_LIMIT - fixed) / (3 * SL::BYTES);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  const int smem = fixed + stages * 3 * SL::BYTES;
  CUtensorMap xm, wm, ym;
  int err;
  if ((err = rows_map<TMA>(&xm, x, N, H, W, BW))) return err;
  if ((err = rows_map<TMA>(&ym, y, N, H, W, BW))) return err;
  if ((err = weight_map(&wm, wp))) return err;
  static int attr = -1;
  if ((err = allow_smem(conv3x3_fwd_wgmma<BW, TMA>, smem, attr))) return err;
  const int units = N * (H / rc) * ((W + BW - 1) / BW);
  conv3x3_fwd_wgmma<BW, TMA><<<n_blocks, THREADS, smem, s>>>(
      xm, wm, ym, (const bf16*)x, (bf16*)y, H, W, rc, units, stages);
  return (int)cudaGetLastError();
}

template <int BW, bool TMA, bool CUT>
int launch_dw(const void* x, const void* gy, float* part, int N, int H, int W, int rc,
              int n_blocks, cudaStream_t s) {
  using SL = Slab<BW>;
  const int fixed = 1024 + BAR_BYTES;
  int stages = (SMEM_LIMIT - fixed) / (4 * SL::BYTES);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  const int smem = fixed + stages * 4 * SL::BYTES;
  CUtensorMap xm, gm;
  int err;
  if ((err = rows_map<TMA>(&xm, x, N, H, W, BW))) return err;
  if ((err = rows_map<TMA>(&gm, gy, N, H, W, BW))) return err;
  static int attr = -1;
  if ((err = allow_smem(conv3x3_dw_wgmma<BW, TMA, CUT>, smem, attr))) return err;
  const int units = N * (H / rc) * ((W + BW - 1) / BW);
  conv3x3_dw_wgmma<BW, TMA, CUT><<<n_blocks, THREADS, smem, s>>>(
      xm, gm, (const bf16*)x, (const bf16*)gy, part, H, W, rc, units, stages);
  return (int)cudaGetLastError();
}

// the instance of the pipeline for this W: box width, and TMA where the row
// stride is a multiple of 16 bytes
int fwd_any(const void* x, const void* wp, void* y, int N, int H, int W, int rc, int n_blocks,
            cudaStream_t s) {
  const bool tma = W % 8 == 0;
  switch (box_width(W)) {
    case 16:
      return tma ? launch_fwd<16, true>(x, wp, y, N, H, W, rc, n_blocks, s)
                 : launch_fwd<16, false>(x, wp, y, N, H, W, rc, n_blocks, s);
    case 32:
      return tma ? launch_fwd<32, true>(x, wp, y, N, H, W, rc, n_blocks, s)
                 : launch_fwd<32, false>(x, wp, y, N, H, W, rc, n_blocks, s);
    default:
      return tma ? launch_fwd<64, true>(x, wp, y, N, H, W, rc, n_blocks, s)
                 : launch_fwd<64, false>(x, wp, y, N, H, W, rc, n_blocks, s);
  }
}

// the ragged entry point's instance: CUT, any box width, either landing
int dw_ragged(const void* x, const void* gy, float* part, int N, int H, int W, int rc,
              int n_blocks, cudaStream_t s) {
  const bool tma = W % 8 == 0;
  switch (box_width(W)) {
    case 16:
      return tma ? launch_dw<16, true, true>(x, gy, part, N, H, W, rc, n_blocks, s)
                 : launch_dw<16, false, true>(x, gy, part, N, H, W, rc, n_blocks, s);
    case 32:
      return tma ? launch_dw<32, true, true>(x, gy, part, N, H, W, rc, n_blocks, s)
                 : launch_dw<32, false, true>(x, gy, part, N, H, W, rc, n_blocks, s);
    default:
      return tma ? launch_dw<64, true, true>(x, gy, part, N, H, W, rc, n_blocks, s)
                 : launch_dw<64, false, true>(x, gy, part, N, H, W, rc, n_blocks, s);
  }
}

}  // namespace

// C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns 0 or a cudaError; it neither allocates nor
// synchronises. All tensors are bfloat16 except `part` (float32) and the
// weights conv3x3_pack_w takes in float32.
extern "C" {

// w: OIHW [64, 64, 3, 3]; out: [9, 64, 64], bfloat16 [tap][co][ci] (dtype 1)
// or float32 [tap][ci][co] (dtype 0).
int conv3x3_pack_w_launch(const void* w, void* out, int rot, int dtype, int device,
                          void* stream) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const int blocks = (TAPS * C * C + 255) / 256;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    conv3x3_pack_w<bf16, false><<<blocks, 256, 0, s>>>((const bf16*)w, (bf16*)out, rot);
  } else if (dtype == 0) {
    conv3x3_pack_w<float, true><<<blocks, 256, 0, s>>>((const float*)w, (float*)out, rot);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, y: [N, 64, H, W]; wp: packed weights [9, 64, 64]; rc: rows per unit;
// n_blocks: persistent blocks (ops/conv.py::tile_schedule). W in {32, 64,
// 128}.
int conv3x3_fwd_wgmma_launch(const void* x, const void* wp, void* y, int N, int H, int W,
                             int rc, int n_blocks, int device, void* stream) {
  int err = check(x, y, N, H, W, rc, n_blocks, true);
  if (err) return err;
  if ((err = (int)cudaSetDevice(device))) return err;
  return fwd_any(x, wp, y, N, H, W, rc, n_blocks, (cudaStream_t)stream);
}

// part: float32 [n_blocks, 9 * 64, 64], one partial per block.
int conv3x3_dw_wgmma_launch(const void* x, const void* gy, float* part, int N, int H, int W,
                            int rc, int n_blocks, int device, void* stream) {
  int err = check(x, gy, N, H, W, rc, n_blocks, true);
  if (err) return err;
  if ((err = (int)cudaSetDevice(device))) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  return W >= 64 ? launch_dw<64, true, false>(x, gy, part, N, H, W, rc, n_blocks, s)
                 : launch_dw<32, true, false>(x, gy, part, N, H, W, rc, n_blocks, s);
}

// The same for any even W (the wrappers send W outside {32, 64, 128}).
int conv3x3_fwd_ragged_launch(const void* x, const void* wp, void* y, int N, int H, int W,
                              int rc, int n_blocks, int device, void* stream) {
  int err = check(x, y, N, H, W, rc, n_blocks, false);
  if (err) return err;
  if ((err = (int)cudaSetDevice(device))) return err;
  return fwd_any(x, wp, y, N, H, W, rc, n_blocks, (cudaStream_t)stream);
}

int conv3x3_dw_ragged_launch(const void* x, const void* gy, float* part, int N, int H, int W,
                             int rc, int n_blocks, int device, void* stream) {
  int err = check(x, gy, N, H, W, rc, n_blocks, false);
  if (err) return err;
  if ((err = (int)cudaSetDevice(device))) return err;
  return dw_ragged(x, gy, part, N, H, W, rc, n_blocks, (cudaStream_t)stream);
}

}  // extern "C"
