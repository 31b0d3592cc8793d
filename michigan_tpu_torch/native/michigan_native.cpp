// Native host-side data-pipeline kernels of the PyTorch port: the trainer's
// per-sample noise pyramid, a half-pixel bilinear resize and the circular
// hole rasterization.
//
// The per-sample noise pyramid (reference base_dataset.py:387-396) is the
// loader's hottest op: ~7 full-resolution bilinear upsamples plus Gaussian
// sampling per sample.  This C++ implementation (counter-based splitmix64
// RNG + Box-Muller, half-pixel bilinear matching cv2 INTER_LINEAR) replaces
// a chain of numpy/cv2 calls with one pass and is deterministic in the seed.
// Its algorithms are those of michigan_tpu/native/michigan_native.cpp; built
// with the same g++ flags on the same host it gives the same bits, so the
// port's loader draws the JAX package's noise.
//
// Build (michigan_tpu_torch/native/__init__.py, at first use):
//   g++ -O3 -march=native -ffast-math -shared -fPIC
//       -o _build/libmichigan_native.so michigan_native.cpp -lmvec -lm
// Bound via ctypes; there is no fallback: a failed build raises.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline double uniform01(uint64_t bits) {
  // 53-bit mantissa uniform in (0,1)
  return ((bits >> 11) + 0.5) * (1.0 / 9007199254740992.0);
}

// Fill `n` deterministic N(mu, sigma) samples; one Box-Muller pair yields
// two outputs (sin + cos), halving the transcendental count.  Structured
// as flat array passes over a block so the compiler can vectorize the
// transcendental loops through libmvec (-ffast-math): the counter-based
// RNG pass, the sqrt(-2 log u) pass, and the sincos pass each become one
// SIMD loop instead of an interleaved scalar chain.
inline void gauss_fill(float* dst, size_t n, uint64_t seed, float mu,
                       float sigma) {
  constexpr size_t kPairs = 2048;  // per-block Box-Muller pairs (~32 KB)
  alignas(64) float u1[kPairs], u2[kPairs], cs[kPairs], sn[kPairs];
  size_t base = 0;  // output index of the block start (always even)
  while (base < n) {
    const size_t m = n - base < 2 * kPairs ? n - base : 2 * kPairs;
    const size_t pairs = (m + 1) / 2;
    for (size_t i = 0; i < pairs; ++i) {
      const uint64_t a = splitmix64(seed ^ (base + 2 * i));
      const uint64_t b =
          splitmix64(seed ^ (base + 2 * i + 1) ^ 0xA5A5A5A5A5A5A5A5ULL);
      u1[i] = static_cast<float>(uniform01(a));
      u2[i] = static_cast<float>(uniform01(b));
    }
    for (size_t i = 0; i < pairs; ++i) {
      u1[i] = std::sqrt(-2.0f * std::log(u1[i]));  // radius
    }
    // two separate loops: a single loop gets fused into scalar sincosf,
    // which glibc has no SIMD variant for — split, each vectorizes
    for (size_t i = 0; i < pairs; ++i) cs[i] = std::cos(6.2831853f * u2[i]);
    for (size_t i = 0; i < pairs; ++i) sn[i] = std::sin(6.2831853f * u2[i]);
    float* out = dst + base;
    for (size_t i = 0; i < pairs; ++i) {
      out[2 * i] = mu + sigma * u1[i] * cs[i];
      if (2 * i + 1 < m) out[2 * i + 1] = mu + sigma * u1[i] * sn[i];
    }
    base += m;
  }
}

// Half-pixel bilinear sample (cv2 INTER_LINEAR / torch align_corners=False).
inline float bilinear_at(const float* src, int sh, int sw, int c, int ch,
                         float y, float x) {
  int y0 = static_cast<int>(std::floor(y));
  int x0 = static_cast<int>(std::floor(x));
  float fy = y - y0;
  float fx = x - x0;
  int y1 = y0 + 1;
  int x1 = x0 + 1;
  if (y0 < 0) { y0 = 0; }
  if (x0 < 0) { x0 = 0; }
  if (y1 > sh - 1) { y1 = sh - 1; }
  if (x1 > sw - 1) { x1 = sw - 1; }
  if (y0 > sh - 1) { y0 = sh - 1; }
  if (x0 > sw - 1) { x0 = sw - 1; }
  const float v00 = src[(y0 * sw + x0) * c + ch];
  const float v01 = src[(y0 * sw + x1) * c + ch];
  const float v10 = src[(y1 * sw + x0) * c + ch];
  const float v11 = src[(y1 * sw + x1) * c + ch];
  return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
         v10 * fy * (1 - fx) + v11 * fy * fx;
}

}  // namespace

extern "C" {

// dst (dh,dw,c) <- bilinear(src (sh,sw,c)), half-pixel mapping.  Bilinear
// is exactly separable: a horizontal pass into a (sh,dw,c) intermediate,
// then a vertical blend of two intermediate rows.  For the pyramid's
// upsampling shapes this roughly halves the arithmetic, and the vertical
// pass is a contiguous two-row lerp the compiler fully vectorizes.
void bilinear_resize_f32(const float* src, int sh, int sw, int c, float* dst,
                         int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = static_cast<int>(std::floor(fx));
    fxs[x] = fx - x0;
    x0s[x] = x0 < 0 ? 0 : (x0 > sw - 1 ? sw - 1 : x0);
    x1s[x] = x0 + 1 < 0 ? 0 : (x0 + 1 > sw - 1 ? sw - 1 : x0 + 1);
  }
  const int64_t row = static_cast<int64_t>(dw) * c;
  std::vector<float> tmp(static_cast<int64_t>(sh) * row);
  for (int y = 0; y < sh; ++y) {
    const float* srow = src + static_cast<int64_t>(y) * sw * c;
    float* trow = tmp.data() + static_cast<int64_t>(y) * row;
    for (int x = 0; x < dw; ++x) {
      const int xa = x0s[x] * c, xb = x1s[x] * c;
      const float wx = fxs[x];
      for (int ch = 0; ch < c; ++ch) {
        trow[x * c + ch] = srow[xa + ch] * (1 - wx) + srow[xb + ch] * wx;
      }
    }
  }
  for (int y = 0; y < dh; ++y) {
    const float fy0 = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy0));
    const float wy = fy0 - y0;
    const int y1 = (y0 + 1 < 0) ? 0 : (y0 + 1 > sh - 1 ? sh - 1 : y0 + 1);
    y0 = y0 < 0 ? 0 : (y0 > sh - 1 ? sh - 1 : y0);
    const float* r0 = tmp.data() + static_cast<int64_t>(y0) * row;
    const float* r1 = tmp.data() + static_cast<int64_t>(y1) * row;
    float* drow = dst + static_cast<int64_t>(y) * row;
    for (int64_t i = 0; i < row; ++i) {
      drow[i] = r0[i] * (1 - wy) + r1[i] * wy;
    }
  }
}

// Multi-octave background noise (reference base_dataset.py:387-396):
// octaves of N(0.5, 0.25) from (h,w) halving down to >=8, each bilinear-
// upsampled to (h,w), equally weighted, normalized.  out is (h, w, 3).
void noise_pyramid(float* out, int height, int width, uint64_t seed) {
  const int64_t total = static_cast<int64_t>(height) * width * 3;
  std::memset(out, 0, total * sizeof(float));
  std::vector<float> octave;
  std::vector<float> up(total);
  int w = width, h = height;
  int n_oct = 0;
  uint64_t oct_idx = 0;
  while (w >= 8 && h >= 8) {
    octave.resize(static_cast<size_t>(h) * w * 3);
    const uint64_t oseed = splitmix64(seed + 0x1000 * (oct_idx + 1));
    gauss_fill(octave.data(), octave.size(), oseed, 0.5f, 0.25f);
    if (h == height && w == width) {
      for (int64_t i = 0; i < total; ++i) out[i] += octave[i];
    } else {
      bilinear_resize_f32(octave.data(), h, w, 3, up.data(), height, width);
      for (int64_t i = 0; i < total; ++i) out[i] += up[i];
    }
    ++n_oct;
    ++oct_idx;
    w /= 2;
    h /= 2;
  }
  if (n_oct > 0) {
    const float inv = 1.0f / n_oct;
    for (int64_t i = 0; i < total; ++i) out[i] *= inv;
  }
}

// Circular-hole rasterization (reference base_dataset.py:335-361 inner
// loop): hole = orient_mask * [dist^2 < rr] + (mask - orient_mask).
void rasterize_hole(const float* mask, const float* orient_mask, int h, int w,
                    int ch_, int cw_, float rr, float* out) {
  for (int y = 0; y < h; ++y) {
    const float dy = static_cast<float>(y - ch_);
    for (int x = 0; x < w; ++x) {
      const float dx = static_cast<float>(x - cw_);
      const float inside = (dy * dy + dx * dx) < rr ? 1.0f : 0.0f;
      const int64_t i = static_cast<int64_t>(y) * w + x;
      out[i] = orient_mask[i] * inside + (mask[i] - orient_mask[i]);
    }
  }
}

}  // extern "C"
