// The implicit-GEMM 3x3 convolution tile shared by conv_in_act.cu and
// conv_lowch.cu: float32, NCHW input, OIHW weights, no tensor cores.
//
// A block of kThreads = 256 threads computes a 64-output-channel x
// 64-pixel tile of one sample (pixels of the flattened H*W plane); each
// thread keeps a 4 x 4 micro-tile of running sums in registers.  The
// reduction walks the (input channel, tap) pairs 16 at a time: a 16 x 64
// slice of the weights and the matching 16 x 64 slice of the im2col
// matrix, gathered straight from the input, are staged in shared memory;
// per pair a thread reads one float4 of each and issues 16 FMAs.  The next
// slice is loaded into registers while the current one is used, so the
// global loads overlap the FMAs.
//
// Where the taps come from is the Input policy: PaddedInput reads a plane
// that the caller already padded by the dilation d (no bounds checks),
// ZeroPaddedInput reads an unpadded plane and gives 0 outside it ('same'
// zero padding by 1, no padded copy).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

constexpr int kBM = 64;           // output channels per block
constexpr int kBN = 64;           // output pixels per block (of the flattened plane)
constexpr int kBK = 16;           // (input channel, tap) pairs per slice
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kTM = 4;            // output channels per thread
constexpr int kTN = 4;            // pixels per thread
constexpr int kLoads = kBK * kBM / kThreads;  // 4 weights and 4 inputs per thread per slice

// One sample's (C, H+2d, W+2d) plane, padded by the caller; dilation d.
struct PaddedInput {
  const float* x;
  int64_t plane;  // (H+2d) * (W+2d)
  int wp, d;
  const float* pix = nullptr;
  __device__ void at_pixel(int py, int px) { pix = x + (int64_t)py * wp + px; }
  __device__ float operator()(int ci, int t) const {
    return pix[ci * plane + (t / 3) * d * wp + (t % 3) * d];
  }
};

// One sample's unpadded (C, H, W) plane; taps outside it read 0.
struct ZeroPaddedInput {
  const float* x;
  int64_t plane;  // H * W
  int h, w;
  int py = 0, px = 0;
  __device__ void at_pixel(int y, int x_) {
    py = y;
    px = x_;
  }
  __device__ float operator()(int ci, int t) const {
    const int y = py + t / 3 - 1, xx = px + t % 3 - 1;
    return (y >= 0 && y < h && xx >= 0 && xx < w) ? x[ci * plane + (int64_t)y * w + xx] : 0.f;
  }
};

// acc[i][j] = sum over (ci, tap) of w[co0 + ty*4 + i][ci][tap] * input at
// pixel p0 + tx*4 + j, where tx = threadIdx.x % 16, ty = threadIdx.x / 16;
// out-of-range channels and pixels give 0.  w is (co, c, 3, 3); wd is the
// output width, hw = H * W of the output plane.
template <class Input>
__device__ __forceinline__ void conv_tile(Input in, const float* __restrict__ w, int c, int co,
                                          int co0, int p0, int hw, int wd,
                                          float (&acc)[kTM][kTN]) {
  __shared__ __align__(16) float s_w[kBK][kBM];  // weights, [pair][channel]
  __shared__ __align__(16) float s_x[kBK][kBN];  // im2col, [pair][pixel]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // pixel group
  const int ty = tid / 16;  // channel group
  const int ktot = c * 9;

  // loader roles.  Weights: thread loads 4 consecutive pairs of one output
  // channel (a row of w is contiguous in (C, 3, 3)).  Inputs: thread loads
  // one pixel for 4 pairs; neighbouring threads take neighbouring pixels.
  const int wm = tid / 4;
  const int wk = (tid % 4) * kLoads;
  const bool w_row_ok = co0 + wm < co;
  const float* w_row = w + (int64_t)(co0 + wm) * ktot;
  const int xp = tid % kBN;
  const int xk = tid / kBN;  // 0..3; pairs xk, xk + 4, xk + 8, xk + 12
  const int pix = p0 + xp;
  const bool pix_ok = pix < hw;
  in.at_pixel(pix_ok ? pix / wd : 0, pix_ok ? pix % wd : 0);

  float rw[kLoads], rx[kLoads];
  auto load_slice = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int kw = k0 + wk + j;
      rw[j] = (w_row_ok && kw < ktot) ? w_row[kw] : 0.f;
      const int kx_ = k0 + xk + 4 * j;
      rx[j] = (pix_ok && kx_ < ktot) ? in(kx_ / 9, kx_ % 9) : 0.f;
    }
  };

#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load_slice(0);
  for (int k0 = 0; k0 < ktot; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      s_w[wk + j][wm] = rw[j];
      s_x[xk + 4 * j][xp] = rx[j];
    }
    __syncthreads();
    if (k0 + kBK < ktot) load_slice(k0 + kBK);  // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&s_w[k][ty * kTM]);
      const float4 xv = *reinterpret_cast<const float4*>(&s_x[k][tx * kTN]);
      const float wr[kTM] = {wv.x, wv.y, wv.z, wv.w};
      const float xr[kTN] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(wr[i], xr[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace conv3x3
