// Fused 3x3 convolution + instance norm + activation (+ residual) for Hopper
// (sm_90a), float32, NCHW.
//
// conv3x3_in_act replaces michigan_tpu/ops/pallas/epilogue.py:conv3x3_in_act
//   (its `_kernel`): a 3x3 convolution with dilation d on an input that the
//   caller has already reflect-padded by d, (N, C, H+2d, W+2d); plus the
//   bias; instance norm per (n, co) over H*W with the biased variance and
//   eps inside the rsqrt; then relu, leaky relu (0.2) or nothing; then an
//   optional residual add.  In the inpainters' dilated resblocks it runs at
//   C = Co = 256 on 64 x 64 planes, 24 calls per inpainter forward.
//
// What bounds it: arithmetic.  One call at that shape is 256 x 4096 x 2304
// FMAs = 4.83 GFLOP (72 us at the card's 67 TFLOP/s fp32 FMA peak) against
// 4.7 MB of input and 4 MB of output (3 us at 3.35 TB/s).  No TF32, no
// tensor cores: the product is computed in fp32 FMAs in this file, with no
// cuDNN or cuBLAS call.
//
// What the design does about it:
// - pass 1 is an implicit GEMM, (Co) x (H*W pixels) x (C*9 taps): the tile
//   of conv3x3_tile.cuh (64 channels x 64 pixels per block, 4 x 4 running
//   sums per thread, the reduction staged 16 pairs at a time through shared
//   memory), reading the caller's padded input with no bounds checks.
// - The instance-norm statistics span a whole 64 x 64 plane, which no tile
//   owns.  On the TPU one grid cell holds the plane in VMEM; here that
//   would give 4-8 blocks per sample and leave most of the 132 SMs idle.
//   So pass 1 writes the pre-norm output and, per (n, co, tile), the
//   tile's count, mean and M2 (merged across the tile's threads by Chan's
//   rule); at batch 1 that is 256 blocks, about two per SM.
// - pass 2 takes one block per (n, co) plane: it merges the plane's tile
//   statistics by Chan's rule, then normalises the plane in place (16 B
//   loads and stores), applies the activation and adds the residual.  The
//   plane it reads was written by pass 1 a moment before and is mostly in
//   the 50 MB L2.
//
// The launcher returns cudaGetLastError() after both launches.  Nothing here
// allocates or synchronises: the caller passes the output and the scratch
// for the tile statistics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_tile.cuh"
#include "welford.cuh"

namespace {

using conv3x3::kBM;
using conv3x3::kBN;
using conv3x3::kThreads;
using conv3x3::kTM;
using conv3x3::kTN;
constexpr int kNormThreads = 256;

enum Act { kActNone = 0, kActRelu = 1, kActLrelu = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == kActRelu) return fmaxf(y, 0.f);
  if (act == kActLrelu) return y > 0.f ? y : 0.2f * y;
  return y;
}

struct ConvArgs {
  const float* x;     // (N, C, Hp, Wp), padded by d
  const float* w;     // (Co, C, 3, 3)
  const float* bias;  // (Co) or null
  float* y;           // (N, Co, H, W): pre-norm output of pass 1
  float* part;        // (N, Co, tiles, 3): count, mean, M2 of each tile
  int c, co, h, wd, d, tiles;
  bool vec;           // H*W % 4 == 0: float4 stores of y
};

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const ConvArgs a) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // pixel group
  const int ty = tid / 16;  // channel group
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kBM;
  const int p0 = blockIdx.x * kBN;
  const int hw = a.h * a.wd;
  const int wp = a.wd + 2 * a.d;
  const int64_t plane_in = (int64_t)(a.h + 2 * a.d) * wp;
  const conv3x3::PaddedInput in{a.x + (int64_t)n * a.c * plane_in, plane_in, wp, a.d};

  float acc[kTM][kTN];
  conv3x3::conv_tile(in, a.w, a.c, a.co, co0, p0, hw, a.wd, acc);

  // epilogue: bias, pre-norm store, and the tile's statistics per channel
  const int pb = p0 + tx * kTN;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int oc = co0 + ty * kTM + i;
    const bool oc_ok = oc < a.co;
    const float b = (a.bias != nullptr && oc_ok) ? a.bias[oc] : 0.f;
    float v[kTN];
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      v[j] = acc[i][j] + b;
      if (oc_ok && pb + j < hw) welford_add(v[j], mean, m2, cnt);
    }
    if (oc_ok) {
      float* yo = a.y + ((int64_t)n * a.co + oc) * hw;
      if (a.vec && pb < hw) {
        *reinterpret_cast<float4*>(yo + pb) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (pb + j < hw) yo[pb + j] = v[j];
      }
    }
    // merge over the 16 pixel groups of this channel: lanes tx = 0..15 of
    // one half-warp (all 32 lanes take part in every shuffle)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
      const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
      const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
      welford_merge(mean, m2, cnt, mb, m2b, nb);
    }
    if (tx == 0 && oc_ok) {
      float* s = a.part + (((int64_t)n * a.co + oc) * a.tiles + blockIdx.x) * 3;
      s[0] = cnt;
      s[1] = mean;
      s[2] = m2;
    }
  }
}

// One block per (n, co) plane: merge the tile statistics, then normalise in
// place, activate, add the residual.
__global__ void __launch_bounds__(kNormThreads)
norm_act_kernel(float* __restrict__ y, const float* __restrict__ part,
                const float* __restrict__ residual, int tiles, int64_t hw, float eps,
                int act, bool vec) {
  const int64_t plane = blockIdx.x;
  float mean = 0.f, m2 = 0.f, n = 0.f;
  for (int t = threadIdx.x; t < tiles; t += kNormThreads) {
    const float* s = part + (plane * tiles + t) * 3;
    welford_merge(mean, m2, n, s[1], s[2], s[0]);
  }
  const float2 stats = block_mean_rstd<kNormThreads>(mean, m2, n, eps);

  float* yp = y + plane * hw;
  const float* rp = residual ? residual + plane * hw : nullptr;
  if (vec) {
    for (int64_t i = (int64_t)threadIdx.x * 4; i < hw; i += kNormThreads * 4) {
      float4 v = *reinterpret_cast<const float4*>(yp + i);
      v.x = apply_act((v.x - stats.x) * stats.y, act);
      v.y = apply_act((v.y - stats.x) * stats.y, act);
      v.z = apply_act((v.z - stats.x) * stats.y, act);
      v.w = apply_act((v.w - stats.x) * stats.y, act);
      if (rp) {
        const float4 r = *reinterpret_cast<const float4*>(rp + i);
        v.x += r.x;
        v.y += r.y;
        v.z += r.z;
        v.w += r.w;
      }
      *reinterpret_cast<float4*>(yp + i) = v;
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kNormThreads) {
      float v = apply_act((yp[i] - stats.x) * stats.y, act);
      if (rp) v += rp[i];
      yp[i] = v;
    }
  }
}

}  // namespace

extern "C" {

// Pixels per tile of pass 1; the caller sizes the scratch for the tile
// statistics as n * co * ceil(h * w / tile) * 3 floats.
int conv3x3_in_act_tile_pixels() { return kBN; }

// x (n, c, h+2d, w+2d), wt (co, c, 3, 3), bias (co) or null, residual
// (n, co, h, w) or null, out (n, co, h, w), scratch as above; all f32,
// contiguous, 16-byte aligned.  act: 0 none, 1 relu, 2 leaky relu (0.2).
int conv3x3_in_act_f32(const void* x, const void* wt, const void* bias,
                       const void* residual, void* out, void* scratch,
                       int64_t scratch_floats, int64_t n, int64_t c, int64_t co,
                       int64_t h, int64_t w, int64_t d, float eps, int act,
                       void* stream) {
  const int64_t hw = h * w;
  const int64_t tiles = (hw + kBN - 1) / kBN;
  if (scratch_floats < n * co * tiles * 3) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<float*>(out);
  a.part = static_cast<float*>(scratch);
  a.c = (int)c;
  a.co = (int)co;
  a.h = (int)h;
  a.wd = (int)w;
  a.d = (int)d;
  a.tiles = (int)tiles;
  a.vec = hw % 4 == 0;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kBM - 1) / kBM), (unsigned)n);
  conv3x3_kernel<<<grid, kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_act_kernel<<<(unsigned)(n * co), kNormThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(scratch),
      static_cast<const float*>(residual), (int)tiles, hw, eps, act, hw % 4 == 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
