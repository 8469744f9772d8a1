// Native image preprocessing: threaded batch bilinear resize for the host
// input pipeline.
//
// The port's copy of gpv_tpu/native/imageproc.cc (same code, same g++
// flags, so the same pixels). Role: the reference burns 30 dataloader
// workers on skimage resize per image (datasets/coco_generic_dataset.py:61,
// train_distr.py:213-222). Here the host-side hot path (resize to the fixed
// 480x640, `host_resize: native`) is a compact C++ function, called through
// ctypes from gpv_tpu_torch/datasets; normalization happens on the card.
//
// Exposed C ABI:
//   resize_bilinear_u8(src, H, W, C, dst, out_h, out_w)
//   resize_bilinear_u8_batch(srcs*, Hs, Ws, C, dst, out_h, out_w, n, threads)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline void resize_one(const uint8_t* src, int H, int W, int C, uint8_t* dst,
                       int out_h, int out_w) {
  // PIL-style bilinear with half-pixel centers.
  const float sy = static_cast<float>(H) / out_h;
  const float sx = static_cast<float>(W) / out_w;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(H - 1)));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, H - 1);
    float wy = fy - y0;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(W - 1)));
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, W - 1);
      float wx = fx - x0;
      for (int c = 0; c < C; ++c) {
        float v00 = src[(y0 * W + x0) * C + c];
        float v01 = src[(y0 * W + x1) * C + c];
        float v10 = src[(y1 * W + x0) * C + c];
        float v11 = src[(y1 * W + x1) * C + c];
        float top = v00 + wx * (v01 - v00);
        float bot = v10 + wx * (v11 - v10);
        float val = top + wy * (bot - top);
        dst[(oy * out_w + ox) * C + c] =
            static_cast<uint8_t>(val + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

void resize_bilinear_u8(const uint8_t* src, int H, int W, int C,
                        uint8_t* dst, int out_h, int out_w) {
  resize_one(src, H, W, C, dst, out_h, out_w);
}

// srcs: array of n pointers; Hs/Ws per-image dims; dst: contiguous
// (n, out_h, out_w, C).
void resize_bilinear_u8_batch(const uint8_t** srcs, const int* Hs,
                              const int* Ws, int C, uint8_t* dst,
                              int out_h, int out_w, int n, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      resize_one(srcs[i], Hs[i], Ws[i], C,
                 dst + static_cast<size_t>(i) * out_h * out_w * C,
                 out_h, out_w);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < std::min(threads, n); ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Color jitter: fused float32 brightness/contrast/saturation/hue/grayscale
// passes over an HxWx3 image, in place.
//
// Role: the pure-NumPy jitter (gpv_tpu_torch/datasets/transforms.py) costs
// ~130 ms per 480x640 image (hue's np.select allocates 6 full images) and
// dominates the host input pipeline; this kernel applies the SAME math
// (ported op-for-op from transforms.py, which reproduces torchvision's
// sampling semantics) at C speed. Factor sampling and op-order permutation
// stay in Python so the rng stream is unchanged.
//
// Exposed C ABI:
//   color_jitter_f32(img /*H*W*3 in place*/, H, W, ops, factors, n_ops)
//     op codes: 0=brightness 1=contrast 2=saturation 3=hue 4=grayscale
// ---------------------------------------------------------------------------

namespace {

inline float clip255(float v) {
  return v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
}

inline float luma(const float* px) {
  return px[0] * 0.299f + px[1] * 0.587f + px[2] * 0.114f;
}

inline float wrap1(float v) {  // numpy `% 1.0` (result in [0,1))
  float r = v - static_cast<float>(static_cast<long long>(v));
  if (r < 0.0f) r += 1.0f;
  return r;
}

void jitter_one(float* img, int H, int W, const int* ops,
                const float* factors, int n_ops) {
  const long long n = static_cast<long long>(H) * W;
  for (int k = 0; k < n_ops; ++k) {
    const float f = factors[k];
    switch (ops[k]) {
      case 0: {  // brightness: blend with zeros
        for (long long i = 0; i < 3 * n; ++i) img[i] = clip255(img[i] * f);
        break;
      }
      case 1: {  // contrast: blend with the grayscale mean
        double acc = 0.0;
        for (long long i = 0; i < n; ++i) acc += luma(img + 3 * i);
        const float mean = static_cast<float>(acc / n);
        const float off = (1.0f - f) * mean;
        for (long long i = 0; i < 3 * n; ++i)
          img[i] = clip255(img[i] * f + off);
        break;
      }
      case 2: {  // saturation: per-pixel blend with own luma
        for (long long i = 0; i < n; ++i) {
          float* px = img + 3 * i;
          const float g = luma(px);
          const float off = (1.0f - f) * g;
          px[0] = clip255(px[0] * f + off);
          px[1] = clip255(px[1] * f + off);
          px[2] = clip255(px[2] * f + off);
        }
        break;
      }
      case 3: {  // hue: rgb->hsv, shift h, hsv->rgb (transforms.adjust_hue)
        for (long long i = 0; i < n; ++i) {
          float* px = img + 3 * i;
          const float r = px[0] / 255.0f, g = px[1] / 255.0f,
                      b = px[2] / 255.0f;
          const float maxc = std::max(r, std::max(g, b));
          const float minc = std::min(r, std::min(g, b));
          const float v = maxc;
          const float deltac = maxc - minc;
          const float s =
              maxc > 0.0f ? deltac / std::max(maxc, 1e-12f) : 0.0f;
          const float inv_dc = 1.0f / std::max(deltac, 1e-12f);
          float h;
          if (deltac == 0.0f) {
            h = wrap1(f);  // gray pixel: h=0 before the shift
          } else {
            if (r == maxc)
              h = (g - b) * inv_dc;  // bc - gc
            else if (g == maxc)
              h = 2.0f + (b - r) * inv_dc;  // 2 + rc - bc
            else
              h = 4.0f + (r - g) * inv_dc;  // 4 + gc - rc
            h = wrap1(wrap1(h / 6.0f) + f);
          }
          // hsv -> rgb
          const float h6 = h * 6.0f;
          int ii = static_cast<int>(h6);  // floor for h6 >= 0
          const float fr = h6 - ii;
          ii %= 6;
          const float p = v * (1.0f - s);
          const float q = v * (1.0f - s * fr);
          const float t = v * (1.0f - s * (1.0f - fr));
          float ro, go, bo;
          switch (ii) {
            case 0: ro = v; go = t; bo = p; break;
            case 1: ro = q; go = v; bo = p; break;
            case 2: ro = p; go = v; bo = t; break;
            case 3: ro = p; go = q; bo = v; break;
            case 4: ro = t; go = p; bo = v; break;
            default: ro = v; go = p; bo = q; break;
          }
          px[0] = clip255(ro * 255.0f);
          px[1] = clip255(go * 255.0f);
          px[2] = clip255(bo * 255.0f);
        }
        break;
      }
      case 4: {  // grayscale: replicate luma into all channels
        for (long long i = 0; i < n; ++i) {
          float* px = img + 3 * i;
          const float g = luma(px);
          px[0] = g;
          px[1] = g;
          px[2] = g;
        }
        break;
      }
      default:
        break;
    }
  }
}

}  // namespace

extern "C" {

void color_jitter_f32(float* img, int H, int W, const int* ops,
                      const float* factors, int n_ops) {
  jitter_one(img, H, W, ops, factors, n_ops);
}

}  // extern "C"
