// The data plane's pixel work, shared by both decoders: crop + resize
// (cv2's rule: area averaging when either axis shrinks, bilinear with
// align_corners=False otherwise) + horizontal flip + optional color jitter +
// (x/255 - mean) / std, on an RGB8 image that a decoder produced; and the
// batch loop that fans images over OpenMP threads.
//
// The float arithmetic is the JAX package's data plane's
// (virtex_tpu/native/dataplane.cpp), operation for operation, so that the
// same decoded pixels give the same bits.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

namespace vdp {

// Bilinear sample of a crop region into a float32 HWC target, fusing the
// flip and (x - mean) * inv_std.
inline void resize_linear(const uint8_t* src, int src_w, int cy, int cx,
                          int ch, int cw, int out_size, bool flip,
                          const float* mean, const float* inv_std,
                          float* dst) {
  const float sy = float(ch) / out_size;
  const float sx = float(cw) / out_size;
  for (int oy = 0; oy < out_size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    fy = std::min(std::max(fy, 0.0f), float(ch - 1));
    int y0 = int(fy);
    int y1 = std::min(y0 + 1, ch - 1);
    float wy = fy - y0;
    for (int ox = 0; ox < out_size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      fx = std::min(std::max(fx, 0.0f), float(cw - 1));
      int x0 = int(fx);
      int x1 = std::min(x0 + 1, cw - 1);
      float wx = fx - x0;
      const int out_x = flip ? (out_size - 1 - ox) : ox;
      float* px = dst + (size_t(oy) * out_size + out_x) * 3;
      for (int c = 0; c < 3; ++c) {
        const uint8_t* p00 = src + (size_t(cy + y0) * src_w + (cx + x0)) * 3 + c;
        const uint8_t* p01 = src + (size_t(cy + y0) * src_w + (cx + x1)) * 3 + c;
        const uint8_t* p10 = src + (size_t(cy + y1) * src_w + (cx + x0)) * 3 + c;
        const uint8_t* p11 = src + (size_t(cy + y1) * src_w + (cx + x1)) * 3 + c;
        float top = *p00 + wx * (*p01 - *p00);
        float bot = *p10 + wx * (*p11 - *p10);
        float val = (top + wy * (bot - top)) * (1.0f / 255.0f);
        px[c] = (val - mean[c]) * inv_std[c];
      }
    }
  }
}

// Area-averaged downscale (cv2 INTER_AREA): each output pixel is the mean of
// its source footprint [oy·sy, (oy+1)·sy) × [ox·sx, (ox+1)·sx), with
// fractional edge weights.
inline void resize_area(const uint8_t* src, int src_w, int cy, int cx, int ch,
                        int cw, int out_size, bool flip, const float* mean,
                        const float* inv_std, float* dst) {
  const float sy = float(ch) / out_size;
  const float sx = float(cw) / out_size;
  const float inv_area = 1.0f / (sy * sx);
  for (int oy = 0; oy < out_size; ++oy) {
    const float fy0 = oy * sy;
    const float fy1 = fy0 + sy;
    const int iy0 = int(fy0);
    const int iy1 = std::min(int(std::ceil(fy1)), ch);
    for (int ox = 0; ox < out_size; ++ox) {
      const float fx0 = ox * sx;
      const float fx1 = fx0 + sx;
      const int ix0 = int(fx0);
      const int ix1 = std::min(int(std::ceil(fx1)), cw);
      float acc[3] = {0.f, 0.f, 0.f};
      for (int y = iy0; y < iy1; ++y) {
        const float wy = std::min(fy1, float(y + 1)) - std::max(fy0, float(y));
        const uint8_t* row = src + (size_t(cy + y) * src_w + cx) * 3;
        for (int x = ix0; x < ix1; ++x) {
          const float w =
              wy * (std::min(fx1, float(x + 1)) - std::max(fx0, float(x)));
          const uint8_t* p = row + size_t(x) * 3;
          acc[0] += w * p[0];
          acc[1] += w * p[1];
          acc[2] += w * p[2];
        }
      }
      const int out_x = flip ? (out_size - 1 - ox) : ox;
      float* px = dst + (size_t(oy) * out_size + out_x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = acc[c] * inv_area * (1.0f / 255.0f);
        px[c] = (v - mean[c]) * inv_std[c];
      }
    }
  }
}

inline void resize(const uint8_t* src, int src_w, int cy, int cx, int ch,
                   int cw, int out_size, bool flip, const float* mean,
                   const float* inv_std, float* dst) {
  if (ch > out_size || cw > out_size) {
    resize_area(src, src_w, cy, cx, ch, cw, out_size, flip, mean, inv_std,
                dst);
  } else {
    resize_linear(src, src_w, cy, cx, ch, cw, out_size, flip, mean, inv_std,
                  dst);
  }
}

inline void rgb_to_hsv(float r, float g, float b, float* h, float* s,
                       float* v) {
  float mx = std::max(r, std::max(g, b));
  float mn = std::min(r, std::min(g, b));
  float d = mx - mn;
  *v = mx;
  *s = mx <= 0.f ? 0.f : d / mx;
  if (d <= 0.f) { *h = 0.f; return; }
  float hh;
  if (mx == r)      hh = (g - b) / d + (g < b ? 6.f : 0.f);
  else if (mx == g) hh = (b - r) / d + 2.f;
  else              hh = (r - g) / d + 4.f;
  *h = hh / 6.f;
}

inline void hsv_to_rgb(float h, float s, float v, float* r, float* g,
                       float* b) {
  h = h - std::floor(h);
  float hh = h * 6.f;
  int i = int(hh) % 6;
  float f = hh - std::floor(hh);
  float p = v * (1.f - s), q = v * (1.f - s * f), t = v * (1.f - s * (1.f - f));
  switch (i) {
    case 0: *r = v; *g = t; *b = p; break;
    case 1: *r = q; *g = v; *b = p; break;
    case 2: *r = p; *g = v; *b = t; break;
    case 3: *r = p; *g = q; *b = v; break;
    case 4: *r = t; *g = p; *b = v; break;
    default: *r = v; *g = p; *b = q; break;
  }
}

// Jitter parameters, 9 floats: [enabled, op0..op3, brightness, contrast,
// saturation, hue shift]; ops 0..3 = brightness, contrast, saturation, hue,
// applied in the given order on [0, 255] floats.
inline void apply_jitter(float* img, int n_px, const float* jp) {
  for (int k = 1; k <= 4; ++k) {
    int op = int(jp[k]);
    if (op == 0 && jp[5] != 1.f) {
      float f = jp[5];
      for (int i = 0; i < n_px * 3; ++i) img[i] *= f;
    } else if (op == 1 && jp[6] != 1.f) {
      // contrast blends toward the mean of the grayscale image (Rec.601)
      double sum = 0.0;
      for (int i = 0; i < n_px; ++i) {
        const float* px = img + i * 3;
        sum += 0.299 * px[0] + 0.587 * px[1] + 0.114 * px[2];
      }
      float mean = float(sum / n_px);
      float f = jp[6];
      for (int i = 0; i < n_px * 3; ++i) img[i] = (img[i] - mean) * f + mean;
    } else if (op == 2 && jp[7] != 1.f) {
      float f = jp[7];
      for (int i = 0; i < n_px; ++i) {
        float* px = img + i * 3;
        float gray = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
        px[0] = (px[0] - gray) * f + gray;
        px[1] = (px[1] - gray) * f + gray;
        px[2] = (px[2] - gray) * f + gray;
      }
    } else if (op == 3 && jp[8] != 0.f) {
      float shift = jp[8];
      for (int i = 0; i < n_px; ++i) {
        float* px = img + i * 3;
        float r = std::min(std::max(px[0], 0.f), 255.f) / 255.f;
        float g = std::min(std::max(px[1], 0.f), 255.f) / 255.f;
        float b = std::min(std::max(px[2], 0.f), 255.f) / 255.f;
        float h, s, v;
        rgb_to_hsv(r, g, b, &h, &s, &v);
        hsv_to_rgb(h + shift, s, v, &r, &g, &b);
        px[0] = r * 255.f; px[1] = g * 255.f; px[2] = b * 255.f;
      }
    }
  }
}

// One decoded RGB8 image (h, w) → crop (cy, cx, ch, cw; ch or cw <= 0: the
// whole image) → out_size² → flip → jitter (jp null or jp[0] == 0: none) →
// (x/255 - mean) / std into dst (float32 HWC). Returns 0, or 2 for a crop
// outside the image.
inline int transform(const uint8_t* rgb, int h, int w, int cy, int cx, int ch,
                     int cw, int out_size, bool flip, const float* jp,
                     const float* mean, const float* std, float* dst) {
  if (ch <= 0 || cw <= 0) {
    cy = 0; cx = 0; ch = h; cw = w;
  }
  if (cy < 0 || cx < 0 || cy + ch > h || cx + cw > w) return 2;
  if (jp == nullptr || jp[0] == 0.f) {
    float inv_std[3] = {1.0f / std[0], 1.0f / std[1], 1.0f / std[2]};
    resize(rgb, w, cy, cx, ch, cw, out_size, flip, mean, inv_std, dst);
    return 0;
  }
  // sample to [0, 255] floats, jitter, then normalize in place
  float raw_mean[3] = {0.f, 0.f, 0.f};
  float raw_inv_std[3] = {255.f, 255.f, 255.f};
  resize(rgb, w, cy, cx, ch, cw, out_size, flip, raw_mean, raw_inv_std, dst);
  const int n_px = out_size * out_size;
  apply_jitter(dst, n_px, jp);
  for (int i = 0; i < n_px; ++i) {
    float* px = dst + i * 3;
    for (int c = 0; c < 3; ++c) {
      float v = std::min(std::max(px[c], 0.f), 255.f) / 255.f;
      px[c] = (v - mean[c]) / std[c];
    }
  }
  return 0;
}

// Decode then transform n images over `threads` OpenMP threads (0: the
// runtime's default). `Decode` is bool(const uint8_t*, size_t,
// std::vector<uint8_t>*, int* h, int* w). Writes float32 images, or, with
// out_u8, the values clipped to [0, 255] and truncated to uint8. Returns the
// number of images that failed; their slots are zeroed.
template <class Decode>
int batch_transform(Decode decode, const uint8_t** bufs, const size_t* lens,
                    const int* rects, const int* flips, const float* jitters,
                    int n, int out_size, const float* mean, const float* std,
                    int out_u8, void* out, int threads) {
  const size_t per = size_t(out_size) * out_size * 3;
  const int team = threads > 0 ? threads : omp_get_max_threads();
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures) \
    num_threads(team)
  for (int i = 0; i < n; ++i) {
    thread_local std::vector<uint8_t> rgb;
    thread_local std::vector<float> scratch;
    float* dst;
    if (out_u8) {
      scratch.resize(per);
      dst = scratch.data();
    } else {
      dst = static_cast<float*>(out) + per * i;
    }
    int h = 0, w = 0;
    int rc = decode(bufs[i], lens[i], &rgb, &h, &w) ? 0 : 1;
    if (rc == 0) {
      rc = transform(rgb.data(), h, w, rects[i * 4], rects[i * 4 + 1],
                     rects[i * 4 + 2], rects[i * 4 + 3], out_size,
                     flips[i] != 0, jitters ? jitters + i * 9 : nullptr, mean,
                     std, dst);
    }
    if (out_u8) {
      uint8_t* o = static_cast<uint8_t*>(out) + per * i;
      if (rc != 0) {
        std::memset(o, 0, per);
      } else {
        for (size_t k = 0; k < per; ++k)
          o[k] = uint8_t(std::min(std::max(dst[k], 0.f), 255.f));
      }
    } else if (rc != 0) {
      std::memset(dst, 0, sizeof(float) * per);
    }
    if (rc != 0) ++failures;
  }
  return failures;
}

}  // namespace vdp
