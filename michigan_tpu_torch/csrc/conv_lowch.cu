// SAME 3x3 stride-1 convolution for Hopper (sm_90a), float32, NCHW, no bias.
//
// conv3x3_same_lowch replaces michigan_tpu/ops/pallas/conv_lowch.py:
//   conv3x3_same_lowch (its `_kernel`): y = the 3x3 correlation of x with
//   w, zero padding 1, stride 1, fp32 accumulation.  x (N, C, H, W), w
//   (Co, C, 3, 3), y (N, Co, H, W).  The TPU kernel was written for the
//   low-channel / large-plane class (C = 64 on 256^2 and larger planes).
//   In the port it runs VGG19's features_2 (64 -> 64 at 512^2) in the
//   training step's no-grad tower of the tag and ref images, batch 16 at
//   batch 8: the bias and the ReLU stay outside, as on the TPU.
//
// What bounds it: arithmetic.  At (16, 64, 512^2) it is 16 x 262144 x 64 x
// 576 = 154.6 G FMAs, 309.2 GFLOP: 1.87 ms at the 165 TFLOP/s that the
// tensor cores give a float32-accurate product through 3xTF32 (4.6 ms at
// the 67 TFLOP/s of float32 FMAs), against 2.15 GB of input and output
// (1.07 GB each; 0.64 ms at 3.35 TB/s).
//
// What the design does about it:
// - the tensor-core tile of conv3x3_tile.cuh, shared with conv_in_act.cu:
//   a 4 x 32-pixel patch x 64 output channels per block, mma.sync m16n8k8
//   TF32 with every operand split into big + small TF32 halves (3 products
//   per pair, float32-accurate), the input halo and the weights of 8 input
//   channels at a time staged by cp.async through a 3-stage shared-memory
//   ring; 32,768 blocks at (16, 64, 512^2), two per SM;
// - the zero padding is the zero-fill of cp.async outside the plane: no
//   padded copy of x is written, where the TPU kernel pads in HBM first;
// - each input element leaves device memory once per block, in 16-byte
//   copies where W % 4 == 0 (the halo's origin is rounded down to 4 floats:
//   6 rows x 40 columns per channel for a 4 x 32 patch), and the output is
//   stored from the accumulator fragments: 32-byte runs of one channel's
//   row.
//
// The launcher returns cudaGetLastError().  Nothing here allocates or
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_tile.cuh"

namespace {

using conv3x3::kCo;
using conv3x3::kCols;
using conv3x3::kMT;
using conv3x3::kNT;
using conv3x3::kRows;
using conv3x3::kThreads;
// one group of 8 warps and a 3-stage ring (84 KB): two blocks per SM.  (Two
// groups per block take 10% longer here, tools/tile_variants.py: 16 warps
// either way, but one barrier for all of them.)
constexpr int kStages = 3;
constexpr int kGroups = 1;
constexpr int kBlock = kThreads * kGroups;

__global__ void __launch_bounds__(kBlock, 2 / kGroups)
conv3x3_same_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, int c, int co, int h, int wd, int tiles_x, int v) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCo;
  const int y0 = (blockIdx.x / tiles_x) * kRows;
  const int x0 = (blockIdx.x % tiles_x) * kCols;
  const int64_t hw = (int64_t)h * wd;
  const conv3x3::Plane in{x + (int64_t)n * c * hw, h, wd, 1};

  float acc[kMT][kNT][4];
  conv3x3::conv_tile<kStages, kGroups>(in, w, c, co, co0, y0, x0,
                                       conv3x3::geometry(1, kGroups, v, 1), smem, acc);

  const int yy = y0 + conv3x3::frag_row();
  if (threadIdx.x >= kThreads || yy >= h) return;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int oc = co0 + conv3x3::frag_ch(j, r);
      if (oc >= co) continue;
      float* yo = y + ((int64_t)n * co + oc) * hw + (int64_t)yy * wd;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int xx = x0 + conv3x3::frag_col(i, r);
        if (xx < wd) yo[xx] = acc[i][j][r];
      }
    }
}

}  // namespace

extern "C" {

// x (n, c, h, w), wt (co, c, 3, 3), out (n, co, h, w); all f32, contiguous.
int conv3x3_same_f32(const void* x, const void* wt, void* out, int64_t n, int64_t c,
                     int64_t co, int64_t h, int64_t w, void* stream) {
  const int64_t tiles_x = (w + kCols - 1) / kCols;
  const int64_t tiles = tiles_x * ((h + kRows - 1) / kRows);
  const int v = conv3x3::halo_vec(x, w);
  const size_t smem = conv3x3::smem_bytes(conv3x3::geometry(1, kGroups, v, 1), kStages);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_same_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCo - 1) / kCo), (unsigned)n);
  conv3x3_same_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(out),
      (int)c, (int)co, (int)h, (int)w, (int)tiles_x, v);
  return (int)cudaGetLastError();
}

}  // extern "C"
