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
// 576 FMAs = 155 GFLOP (2.3 ms at the card's 67 TFLOP/s fp32 FMA peak)
// against 1.07 GB of input and output (0.32 ms at 3.35 TB/s).  No TF32, no
// tensor cores: the product is computed in fp32 FMAs, with no cuDNN or
// cuBLAS call.
//
// What the design does about it:
// - the tile of conv3x3_tile.cuh, shared with conv_in_act.cu: 64 output
//   channels x 64 pixels per block, 4 x 4 running sums per thread, the
//   (channel, tap) reduction staged 16 pairs at a time through shared
//   memory with the next slice prefetched into registers;
// - the zero padding happens in the gather (ZeroPaddedInput): no padded
//   copy of x is written, where the TPU kernel pads in HBM first;
// - at C = Co = 64 one block covers every output channel, so each input
//   element is gathered by the 4096 blocks of a plane's 64-pixel tiles
//   about 9 times (once per tap), mostly from L1 and L2.
//
// The launcher returns cudaGetLastError().  Nothing here allocates or
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_tile.cuh"

namespace {

using conv3x3::kBM;
using conv3x3::kBN;
using conv3x3::kThreads;
using conv3x3::kTM;
using conv3x3::kTN;

__global__ void __launch_bounds__(kThreads)
conv3x3_same_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, int c, int co, int h, int wd) {
  const int tx = threadIdx.x % 16;  // pixel group
  const int ty = threadIdx.x / 16;  // channel group
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kBM;
  const int p0 = blockIdx.x * kBN;
  const int hw = h * wd;
  const conv3x3::ZeroPaddedInput in{x + (int64_t)n * c * hw, (int64_t)hw, h, wd};

  float acc[kTM][kTN];
  conv3x3::conv_tile(in, w, c, co, co0, p0, hw, wd, acc);

  const int pb = p0 + tx * kTN;
  const bool vec = hw % 4 == 0;  // then pb < hw means all four pixels are in
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int oc = co0 + ty * kTM + i;
    if (oc >= co) continue;
    float* yo = y + ((int64_t)n * co + oc) * hw;
    if (vec && pb < hw) {
      *reinterpret_cast<float4*>(yo + pb) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (pb + j < hw) yo[pb + j] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x (n, c, h, w), wt (co, c, 3, 3), out (n, co, h, w); all f32, contiguous,
// 16-byte aligned.
int conv3x3_same_f32(const void* x, const void* wt, void* out, int64_t n, int64_t c,
                     int64_t co, int64_t h, int64_t w, void* stream) {
  const int64_t tiles = (h * w + kBN - 1) / kBN;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kBM - 1) / kBM), (unsigned)n);
  conv3x3_same_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(out),
      (int)c, (int)co, (int)h, (int)w);
  return (int)cudaGetLastError();
}

}  // extern "C"
