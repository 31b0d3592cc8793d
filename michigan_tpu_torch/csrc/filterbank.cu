// Dense orientation by a bank of 32 oriented 17x17 filters, for Hopper
// (sm_90a), float32.
//
// filterbank_orientation replaces michigan_tpu/ops/pallas/filterbank.py:
//   filterbank_orientation (its inner `kernel`), which computes exactly
//   michigan_tpu/ops/filters.py:orientation_response: the 'same'
//   zero-padded correlation of a (N, H, W) gray plane with each of the 32
//   filters, each response clamped at 0, then per pixel the first index of
//   the largest response (int32) and that response (float32).
//
// What bounds it: arithmetic.  Per pixel 32 x 289 = 9,248 FMAs against 4 B
// read and 8 B written, so a 512^2 plane is 4.85 GFLOP (72 us at the card's
// 67 TFLOP/s fp32 FMA peak) and moves 3 MB (1 us at 3.35 TB/s).
//
// What the design does about it:
// - one block takes a 32 x 16 output tile and stages the gray tile with its
//   8-pixel zero halo (48 x 32 floats) in shared memory, so every input is
//   read from device memory once per tile;
// - the bank (289 taps x 32 orientations, 37 KB) comes from the caller as a
//   device pointer in [tap][orientation] order (the JAX package's HWIO bank
//   with I = 1, made by michigan_tpu_torch/ops/filters.py) and is copied
//   into shared memory once per block; nothing of it is written in here;
// - each thread owns 4 pixels of one column and keeps their 4 x 32 running
//   sums in registers.  Per tap it reads 4 inputs (a warp reads 32
//   neighbouring columns: no bank conflicts) and the tap's 32 weights as 8
//   float4 broadcasts, then issues 128 FMAs: the FMA pipe, not shared
//   memory, is the limit;
// - the clamp, the argmax (strict '>' over 0..31, so the first index wins
//   ties and an all-zero pixel gets 0) and the max happen in registers:
//   the (N, 32, H, W) response never reaches device memory, as on the TPU.
//
// filterbank_orientation_backward is the gradient of conf with respect to
//   gray, which the training step's ORIENT / CONFIDENCE loss needs (the
//   JAX package differentiates through the bank conv and its max:
//   michigan_tpu/ops/filters.py:207-250, a transposed bank conv of the
//   (N, H, W, 32) cotangent).  Only the argmax orientation carries a
//   gradient, and only where the clamped max is positive:
//     dgray[p] = sum over q with |p - q|_inf <= 8, q in the image, of
//                dconf[q] * [conf[q] > 0] * bank[p - q + 8][idx[q]].
//   The gather form costs 289 FMAs per pixel, where the dense transposed
//   conv costs 9,248 and builds a 32-channel cotangent.
//
// What bounds it: shared-memory reads.  At (8, 1, 512^2) it is 606 M FMAs
// (18 us at the fp32 peak) against 24 MB of device memory traffic (7 us).
// What the design does about it:
// - one block per 32 x 16 output tile stages dconf * [conf > 0] and idx of
//   the tile with its 8-pixel halo (48 x 32 each) and the whole bank in
//   shared memory;
// - each thread owns 4 pixels of one column; per column offset it reads
//   the 20 (gradient, orientation) pairs its window needs into registers
//   once and reuses each for up to 4 pixels;
// - the bank read bank[tap][idx[q]] has the same tap across a warp and at
//   most 32 distinct orientations, one per shared-memory bank: no
//   conflicts.
//
// The launchers return cudaGetLastError().  Nothing here allocates or
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNum = 32;                    // orientations
constexpr int kK = 17;                      // filter size
constexpr int kR = kK / 2;                  // 'same' zero padding
constexpr int kTaps = kK * kK;              // 289
constexpr int kThreads = 128;               // 4 warps
constexpr int kTileW = 32;                  // one warp spans a tile row
constexpr int kRows = 4;                    // pixels (rows) per thread
constexpr int kTileH = kThreads / kTileW * kRows;  // 16
constexpr int kInW = kTileW + 2 * kR;       // 48
constexpr int kInH = kTileH + 2 * kR;       // 32

__global__ void __launch_bounds__(kThreads)
filterbank_kernel(const float* __restrict__ gray, const float* __restrict__ bank,
                  int32_t* __restrict__ idx, float* __restrict__ conf, int h, int w) {
  __shared__ __align__(16) float s_bank[kTaps * kNum];  // [tap][orientation]
  __shared__ float s_in[kInH][kInW];

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int64_t plane = (int64_t)blockIdx.z * h * w;
  const float* g = gray + plane;

  const float4* bank4 = reinterpret_cast<const float4*>(bank);
  float4* s_bank4 = reinterpret_cast<float4*>(s_bank);
  for (int i = tid; i < kTaps * kNum / 4; i += kThreads) s_bank4[i] = bank4[i];
  for (int i = tid; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    const int y = y0 + r - kR, x = x0 + c - kR;
    s_in[r][c] = (y >= 0 && y < h && x >= 0 && x < w) ? g[(int64_t)y * w + x] : 0.f;
  }
  __syncthreads();

  const int tx = tid % kTileW;         // column in the tile
  const int ty = tid / kTileW * kRows;  // first of this thread's rows

  float acc[kRows][kNum];
#pragma unroll
  for (int p = 0; p < kRows; ++p)
#pragma unroll
    for (int k = 0; k < kNum; ++k) acc[p][k] = 0.f;

  for (int dy = 0; dy < kK; ++dy) {
#pragma unroll 1
    for (int dx = 0; dx < kK; ++dx) {
      float v[kRows];
#pragma unroll
      for (int p = 0; p < kRows; ++p) v[p] = s_in[ty + p + dy][tx + dx];
      const float4* wt = s_bank4 + (dy * kK + dx) * (kNum / 4);
#pragma unroll
      for (int q = 0; q < kNum / 4; ++q) {
        const float4 wq = wt[q];
#pragma unroll
        for (int p = 0; p < kRows; ++p) {
          acc[p][4 * q + 0] = fmaf(v[p], wq.x, acc[p][4 * q + 0]);
          acc[p][4 * q + 1] = fmaf(v[p], wq.y, acc[p][4 * q + 1]);
          acc[p][4 * q + 2] = fmaf(v[p], wq.z, acc[p][4 * q + 2]);
          acc[p][4 * q + 3] = fmaf(v[p], wq.w, acc[p][4 * q + 3]);
        }
      }
    }
  }

  const int x = x0 + tx;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const int y = y0 + ty + p;
    float best = fmaxf(acc[p][0], 0.f);
    int best_k = 0;
#pragma unroll
    for (int k = 1; k < kNum; ++k) {
      const float r = fmaxf(acc[p][k], 0.f);
      if (r > best) {
        best = r;
        best_k = k;
      }
    }
    if (y < h && x < w) {
      const int64_t o = plane + (int64_t)y * w + x;
      idx[o] = best_k;
      conf[o] = best;
    }
  }
}

// Backward: one block per kTileW x kTileH output tile, the same geometry as
// the forward.  s_g holds dconf * [conf > 0] and s_k the argmax, both zero
// outside the image; halo coordinates are (y - y0 + kR, x - x0 + kR).
__global__ void __launch_bounds__(kThreads)
filterbank_backward_kernel(const float* __restrict__ dconf, const int32_t* __restrict__ idx,
                           const float* __restrict__ conf, const float* __restrict__ bank,
                           float* __restrict__ dgray, int h, int w) {
  __shared__ __align__(16) float s_bank[kTaps * kNum];  // [tap][orientation]
  __shared__ float s_g[kInH][kInW];
  __shared__ uint8_t s_k[kInH][kInW];  // bytes: the three arrays fit 48 KB (44.7 KB)

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int64_t plane = (int64_t)blockIdx.z * h * w;

  const float4* bank4 = reinterpret_cast<const float4*>(bank);
  float4* s_bank4 = reinterpret_cast<float4*>(s_bank);
  for (int i = tid; i < kTaps * kNum / 4; i += kThreads) s_bank4[i] = bank4[i];
  for (int i = tid; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    const int y = y0 + r - kR, x = x0 + c - kR;
    float g = 0.f;
    uint8_t k = 0;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const int64_t o = plane + (int64_t)y * w + x;
      if (conf[o] > 0.f) g = dconf[o];
      k = (uint8_t)idx[o];  // 0..31
    }
    s_g[r][c] = g;
    s_k[r][c] = k;
  }
  __syncthreads();

  const int tx = tid % kTileW;         // column in the tile
  const int ty = tid / kTileW * kRows;  // first of this thread's rows
  constexpr int kWin = kRows + kK - 1;  // 20 halo rows feed this thread's 4 pixels

  float acc[kRows];
#pragma unroll
  for (int p = 0; p < kRows; ++p) acc[p] = 0.f;

  // pixel (ty + p, tx) reads q at halo (ty + p + 2kR - oy, tx + 2kR - ox)
  // with tap (oy, ox) = p - q + kR
#pragma unroll 1
  for (int ox = 0; ox < kK; ++ox) {
    const int hx = tx + 2 * kR - ox;
    float g[kWin];
    int k[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      g[j] = s_g[ty + j][hx];
      k[j] = s_k[ty + j][hx];
    }
#pragma unroll
    for (int oy = 0; oy < kK; ++oy) {
      const float* tap = s_bank + (oy * kK + ox) * kNum;
#pragma unroll
      for (int p = 0; p < kRows; ++p) {
        const int j = p + 2 * kR - oy;
        acc[p] = fmaf(g[j], tap[k[j]], acc[p]);
      }
    }
  }

  const int x = x0 + tx;
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const int y = y0 + ty + p;
    if (y < h && x < w) dgray[plane + (int64_t)y * w + x] = acc[p];
  }
}

}  // namespace

extern "C" {

// gray (n, h, w) f32; bank (289, 32) f32 in [tap][orientation] order, 16-byte
// aligned; idx (n, h, w) int32 and conf (n, h, w) f32 out.
int filterbank_orientation_f32(const void* gray, const void* bank, void* idx, void* conf,
                               int64_t n, int64_t h, int64_t w, void* stream) {
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH), (unsigned)n);
  filterbank_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), static_cast<const float*>(bank),
      static_cast<int32_t*>(idx), static_cast<float*>(conf), (int)h, (int)w);
  return (int)cudaGetLastError();
}

// dconf (n, h, w) f32, idx (n, h, w) int32 and conf (n, h, w) f32 as the
// forward wrote them; bank as above; dgray (n, h, w) f32 out.
int filterbank_orientation_backward_f32(const void* dconf, const void* idx, const void* conf,
                                        const void* bank, void* dgray, int64_t n, int64_t h,
                                        int64_t w, void* stream) {
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW),
                  (unsigned)((h + kTileH - 1) / kTileH), (unsigned)n);
  filterbank_backward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dconf), static_cast<const int32_t*>(idx),
      static_cast<const float*>(conf), static_cast<const float*>(bank),
      static_cast<float*>(dgray), (int)h, (int)w);
  return (int)cudaGetLastError();
}

}  // extern "C"
