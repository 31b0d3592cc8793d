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
// = 2.42 G FMAs, 4.83 GFLOP: 29.3 us at the 165 TFLOP/s that the tensor
// cores give a float32-accurate product through 3xTF32 (72 us at the 67
// TFLOP/s of float32 FMAs), against 4.5 MB of input and 4.2 MB of output
// (3 us at 3.35 TB/s).
//
// What the design does about it:
// - pass 1 is the tensor-core implicit GEMM of conv3x3_tile.cuh (a 4 x 32
//   pixel patch x 64 output channels per block, mma.sync m16n8k8 TF32 with
//   the 3xTF32 split, a 3-stage cp.async ring of input halo and weights),
//   reading the caller's padded input with no bounds checks in the inner
//   loop.  At (1, 256, 64^2) that is 32 patches x 4 channel blocks = 128
//   blocks on the 132 SMs, each of 16 warps in two groups that split the
//   input channels.
// - The instance-norm statistics span a whole 64 x 64 plane, which no block
//   owns.  On the TPU one grid cell holds the plane in VMEM; here that
//   would give 4-8 blocks per sample and leave most of the SMs idle.  So
//   pass 1 writes the pre-norm output and, per (n, co, patch), the patch's
//   count, mean and M2: Welford over the thread's 4 pixels of a channel,
//   Chan's merge across the 8 lanes that share the channel, then across
//   the 4 warps (patch rows) through shared memory.
// - pass 2 takes one block per (n, co) plane: it merges the plane's patch
//   statistics by Chan's rule, then normalises the plane in place (16 B
//   loads and stores), applies the activation and adds the residual.  The
//   plane it reads was written by pass 1 a moment before and is mostly in
//   the 50 MB L2.
//
// The launcher returns cudaGetLastError() after both launches.  Nothing here
// allocates or synchronises: the caller passes the output and the scratch
// for the patch statistics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_tile.cuh"
#include "welford.cuh"

namespace {

using conv3x3::kCo;
using conv3x3::kCols;
using conv3x3::kMT;
using conv3x3::kNT;
using conv3x3::kRows;
using conv3x3::kThreads;
using conv3x3::kWarpsN;
constexpr int kNormThreads = 256;
// two groups of 8 warps, each on every other 8 input channels, and a
// 3-stage ring (3 x 57 KB at dilation 2; dilation 4 is the most that fits
// 227 KB): the path's 128 blocks run one per SM, so the second group rather
// than a second block hides the latencies (one group takes 14% longer at
// (1, 256, 64^2), tools/tile_variants.py)
constexpr int kStages = 3;
constexpr int kGroups = 2;
constexpr int kBlock = kThreads * kGroups;

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
  float* part;        // (N, Co, tiles, 3): count, mean, M2 of each patch
  int c, co, h, wd, d, tiles_x, tiles, v;  // v: floats per halo copy
};

__global__ void __launch_bounds__(kBlock, 2 / kGroups)
conv3x3_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_stat[kRows][kCo][3];  // per patch row: count, mean, M2
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCo;
  const int y0 = (blockIdx.x / a.tiles_x) * kRows;
  const int x0 = (blockIdx.x % a.tiles_x) * kCols;
  const int hp = a.h + 2 * a.d;
  const int wp = a.wd + 2 * a.d;
  const conv3x3::Plane in{a.x + (int64_t)n * a.c * hp * wp, hp, wp, 0};

  float acc[kMT][kNT][4];
  conv3x3::conv_tile<kStages, kGroups>(in, a.w, a.c, a.co, co0, y0, x0,
                                       conv3x3::geometry(a.d, kGroups, a.v, 0), smem, acc);

  // epilogue: bias, pre-norm store, and the patch's statistics per channel
  const int64_t hw = (int64_t)a.h * a.wd;
  const int row = conv3x3::frag_row();
  const int yy = y0 + row;
  const bool row_ok = yy < a.h;
  // the first group holds the sums (warp-uniform: the shuffles stay whole)
  if (threadIdx.x < kThreads) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {  // channels 2t and 2t + 1 of the n8 tile
        const int ch = conv3x3::frag_ch(j, b);
        const int oc = co0 + ch;
        const bool oc_ok = oc < a.co;
        const float bias = (a.bias != nullptr && oc_ok) ? a.bias[oc] : 0.f;
        float* yo = a.y + ((int64_t)n * a.co + (oc_ok ? oc : 0)) * hw + (int64_t)yy * a.wd;
        float cnt = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int r = b; r < 4; r += 2) {  // pixels lane/4 and lane/4 + 8
            const int xx = x0 + conv3x3::frag_col(i, r);
            if (oc_ok && row_ok && xx < a.wd) {
              const float v = acc[i][j][r] + bias;
              yo[xx] = v;
              welford_add(v, mean, m2, cnt);
            }
          }
        // merge over the 8 lanes of this channel (lane bits 2-4; all 32 lanes
        // take part in every shuffle)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
          const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
          const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
          welford_merge(mean, m2, cnt, mb, m2b, nb);
        }
        if ((threadIdx.x & 31) < 4) {
          s_stat[row][ch][0] = cnt;
          s_stat[row][ch][1] = mean;
          s_stat[row][ch][2] = m2;
        }
      }
  }
  __syncthreads();
  // merge over the patch rows: one thread per channel
  if (threadIdx.x < kCo && co0 + (int)threadIdx.x < a.co) {
    const int ch = threadIdx.x;
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      welford_merge(mean, m2, cnt, s_stat[r][ch][1], s_stat[r][ch][2], s_stat[r][ch][0]);
    float* s = a.part + (((int64_t)n * a.co + co0 + ch) * a.tiles + blockIdx.x) * 3;
    s[0] = cnt;
    s[1] = mean;
    s[2] = m2;
  }
  static_assert(kThreads / 32 == kRows * kWarpsN, "one patch row per warp pair");
  static_assert(kCo <= kThreads, "one thread per channel merges the rows");
}

// One block per (n, co) plane: merge the patch statistics, then normalise in
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

// Patches of pass 1 per (h, w) output plane; the caller sizes the scratch
// for the patch statistics as n * co * tiles * 3 floats.
int conv3x3_in_act_tiles(int64_t h, int64_t w) {
  return (int)(((h + kRows - 1) / kRows) * ((w + kCols - 1) / kCols));
}

// x (n, c, h+2d, w+2d), wt (co, c, 3, 3), bias (co) or null, residual
// (n, co, h, w) or null, out (n, co, h, w), scratch as above; all f32,
// contiguous; out and residual 16-byte aligned.  act: 0 none, 1 relu, 2
// leaky relu (0.2).
int conv3x3_in_act_f32(const void* x, const void* wt, const void* bias,
                       const void* residual, void* out, void* scratch,
                       int64_t scratch_floats, int64_t n, int64_t c, int64_t co,
                       int64_t h, int64_t w, int64_t d, float eps, int act,
                       void* stream) {
  const int64_t hw = h * w;
  const int64_t tiles = conv3x3_in_act_tiles(h, w);
  if (scratch_floats < n * co * tiles * 3) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = conv3x3::halo_vec(x, w + 2 * d);
  const size_t smem = conv3x3::smem_bytes(conv3x3::geometry((int)d, kGroups, v, 0), kStages);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
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
  a.tiles_x = (int)((w + kCols - 1) / kCols);
  a.tiles = (int)tiles;
  a.v = v;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCo - 1) / kCo), (unsigned)n);
  conv3x3_kernel<<<grid, kBlock, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_act_kernel<<<(unsigned)(n * co), kNormThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(scratch),
      static_cast<const float*>(residual), (int)tiles, hw, eps, act, hw % 4 == 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
