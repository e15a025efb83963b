// Native data-loader core: the host-side hot path of the input pipeline.
//
// A copy of the JAX package's runtime/data_core.cpp (same six C entry
// points, same arithmetic): batch gather + uint8->float normalization,
// PIL-compatible bicubic resampling, and horizontal flips, all
// OpenMP-parallel, exposed through a C ABI consumed via ctypes
// (intro_tc_vae_tpu_torch/runtime/native.py, which builds it at first use).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC data_core.cpp -o libdatacore.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// out[i, ...] = imgs[indices[i], ...] / 255.0f
void gather_normalize_u8(const uint8_t* imgs, const int64_t* indices,
                         int64_t n_idx, int64_t img_elems, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_idx; ++i) {
    const uint8_t* src = imgs + indices[i] * img_elems;
    float* dst = out + i * img_elems;
    // divide (not multiply-by-reciprocal) for bit parity with numpy's /255.0
    for (int64_t k = 0; k < img_elems; ++k) dst[k] = src[k] / 255.0f;
  }
}

// out[i] = imgs[indices[i]] (float32 passthrough gather)
void gather_f32(const float* imgs, const int64_t* indices, int64_t n_idx,
                int64_t img_elems, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(out + i * img_elems, imgs + indices[i] * img_elems,
                sizeof(float) * img_elems);
  }
}

namespace {

// Keys's cubic convolution kernel with a = -0.5 (PIL BICUBIC).
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precompute, per destination coordinate, the source window and weights
// using PIL's stretched-support scheme (filter widened when downscaling).
struct Taps {
  std::vector<int> start;
  std::vector<int> size;
  std::vector<double> weights;  // [dst, max_size]
  int max_size = 0;
};

Taps make_taps(int src, int dst) {
  Taps t;
  double scale = static_cast<double>(src) / dst;
  double filterscale = std::max(scale, 1.0);
  double support = 2.0 * filterscale;  // bicubic support = 2
  t.max_size = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.start.resize(dst);
  t.size.resize(dst);
  t.weights.assign(static_cast<size_t>(dst) * t.max_size, 0.0);
  for (int i = 0; i < dst; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = std::max(0, static_cast<int>(center - support + 0.5));
    int xmax = std::min(src, static_cast<int>(center + support + 0.5));
    double wsum = 0.0;
    int n = xmax - xmin;
    for (int x = 0; x < n; ++x) {
      double w = cubic((x + xmin - center + 0.5) / filterscale);
      t.weights[static_cast<size_t>(i) * t.max_size + x] = w;
      wsum += w;
    }
    if (wsum != 0.0) {
      for (int x = 0; x < n; ++x)
        t.weights[static_cast<size_t>(i) * t.max_size + x] /= wsum;
    }
    t.start[i] = xmin;
    t.size[i] = n;
  }
  return t;
}

}  // namespace

// Batched separable bicubic resize, float32 HWC -> HWC.
// src: [n, sh, sw, c], dst: [n, dh, dw, c]. Values clamped to [0, 1].
void resize_bicubic_f32(const float* src, int64_t n, int sh, int sw, int c,
                        float* dst, int dh, int dw) {
  Taps tx = make_taps(sw, dw);
  Taps ty = make_taps(sh, dh);
#pragma omp parallel
  {
    std::vector<float> tmp(static_cast<size_t>(sh) * dw * c);
#pragma omp for schedule(static)
    for (int64_t img = 0; img < n; ++img) {
      const float* s = src + img * sh * sw * c;
      float* d = dst + img * static_cast<int64_t>(dh) * dw * c;
      // horizontal pass: [sh, sw, c] -> [sh, dw, c]
      for (int y = 0; y < sh; ++y) {
        for (int x = 0; x < dw; ++x) {
          const double* w = &tx.weights[static_cast<size_t>(x) * tx.max_size];
          int x0 = tx.start[x], nx = tx.size[x];
          for (int ch = 0; ch < c; ++ch) {
            double acc = 0.0;
            for (int k = 0; k < nx; ++k)
              acc += w[k] * s[(static_cast<int64_t>(y) * sw + x0 + k) * c + ch];
            // PIL's 8bpc pipeline clips+rounds the horizontal pass to
            // uint8 before the vertical pass; emulate for bit parity.
            double q = std::round(std::min(1.0, std::max(0.0, acc)) * 255.0);
            tmp[(static_cast<size_t>(y) * dw + x) * c + ch] =
                static_cast<float>(q * (1.0 / 255.0));
          }
        }
      }
      // vertical pass: [sh, dw, c] -> [dh, dw, c]
      for (int y = 0; y < dh; ++y) {
        const double* w = &ty.weights[static_cast<size_t>(y) * ty.max_size];
        int y0 = ty.start[y], ny = ty.size[y];
        for (int x = 0; x < dw; ++x) {
          for (int ch = 0; ch < c; ++ch) {
            double acc = 0.0;
            for (int k = 0; k < ny; ++k)
              acc += w[k] * tmp[(static_cast<size_t>(y0 + k) * dw + x) * c + ch];
            double q = std::round(std::min(1.0, std::max(0.0, acc)) * 255.0);
            d[(static_cast<int64_t>(y) * dw + x) * c + ch] =
                static_cast<float>(q * (1.0 / 255.0));
          }
        }
      }
    }
  }
}

// In-place horizontal flip of selected images. flags: [n] (0/1).
void flip_horizontal_f32(float* imgs, int64_t n, int h, int w, int c,
                         const uint8_t* flags) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    if (!flags[i]) continue;
    float* img = imgs + i * static_cast<int64_t>(h) * w * c;
    for (int y = 0; y < h; ++y) {
      float* row = img + static_cast<int64_t>(y) * w * c;
      for (int x = 0; x < w / 2; ++x) {
        for (int ch = 0; ch < c; ++ch) {
          std::swap(row[x * c + ch], row[(w - 1 - x) * c + ch]);
        }
      }
    }
  }
}

// out[i, ...] = imgs[indices[i], ...] (raw uint8 gather, no normalize).
// Feeds the device-normalize transfer path: uint8 batches are 4x fewer
// bytes over the host->device link; the /255 runs on-device instead.
void gather_u8(const uint8_t* imgs, const int64_t* indices, int64_t n_idx,
               int64_t img_elems, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_idx; ++i) {
    std::memcpy(out + i * img_elems, imgs + indices[i] * img_elems,
                static_cast<size_t>(img_elems));
  }
}

// In-place horizontal flip of selected uint8 images. flags: [n] (0/1).
// A flip is a pure permutation, so flipping before or after the /255
// normalization is bit-identical.
void flip_horizontal_u8(uint8_t* imgs, int64_t n, int h, int w, int c,
                        const uint8_t* flags) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    if (!flags[i]) continue;
    uint8_t* img = imgs + i * static_cast<int64_t>(h) * w * c;
    for (int y = 0; y < h; ++y) {
      uint8_t* row = img + static_cast<int64_t>(y) * w * c;
      for (int x = 0; x < w / 2; ++x) {
        for (int ch = 0; ch < c; ++ch) {
          std::swap(row[x * c + ch], row[(w - 1 - x) * c + ch]);
        }
      }
    }
  }
}

}  // extern "C"
