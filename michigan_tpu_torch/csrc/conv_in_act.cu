// Fused 3x3 convolution + instance norm + activation (+ residual) for Hopper
// (sm_90a), NCHW, float32 or bf16.
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
// (3 us at 3.35 TB/s).  In bf16 (the --dtype bfloat16 policy) the same call
// is 4.9 us at 989 TFLOP/s of dense bf16 product, against ~2 us of bytes.
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
//   statistics by Chan's rule, then normalises the plane (16 B loads and
//   stores), applies the activation and adds the residual.  The plane it
//   reads was written by pass 1 a moment before and is mostly in the 50 MB
//   L2.
//
// bf16 (x_pad, residual and output bf16, weights rounded to bf16, bias
// float32), as the TPU kernel under the bf16 policy: the convolution sums in
// float32 and the statistics, normalisation, activation and residual add
// run on that float32 sum; the output is rounded to bf16 once.
// - pass 0 (pair_kernel, bf16_pairs.cuh) rewrites x_pad as bf16 channel
//   pairs, one 32-bit word per pixel, rows padded to 16 bytes, and the
//   weights as (co, pair, tap) words rounded to bf16: the layout the bf16
//   tile's mma.sync m16n8k16 fragments load as they are (conv3x3_tile.cuh),
//   in 16-byte cp.async copies at either dilation.  ~2.4 MB each way, one
//   thread a word in 32-bit indices.
// - pass 1 is the same tile with one bf16 product per step of 16 channels,
//   a fresh accumulator chain per step; it writes the pre-norm sum in
//   float32 to scratch, not to the bf16 output (a bf16 pre-norm would round
//   before the norm).
// - pass 2 reads that float32 plane and the bf16 residual and writes bf16.
//
// The launchers return cudaGetLastError() after their launches.  Nothing
// here allocates or synchronises: the caller passes the output and the
// scratch (the patch statistics; in bf16 also the pair planes and the
// float32 pre-norm output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_pairs.cuh"
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
using bf16_pairs::bf16_bits;
constexpr int kNormThreads = 256;
// two groups of 8 warps, each on every other 8 input channels, and a
// 3-stage ring (3 x 57 KB at dilation 2; dilation 4 is the most that fits
// 227 KB): the path's 128 blocks run one per SM, so the second group rather
// than a second block hides the latencies (one group takes 14% longer at
// (1, 256, 64^2), tools/tile_variants.py)
constexpr int kStages = 3;
constexpr int kGroups = 2;
constexpr int kBlock = kThreads * kGroups;
// the bf16 pair planes' rows are padded to a multiple of this many words
// (16 bytes), so that every halo copy is a 16-byte cp.async
constexpr int kRowWords = 4;

enum Act { kActNone = 0, kActRelu = 1, kActLrelu = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == kActRelu) return fmaxf(y, 0.f);
  if (act == kActLrelu) return y > 0.f ? y : 0.2f * y;
  return y;
}

struct ConvArgs {
  const float* x;     // (N, C, Hp, pw) words, padded by d (bf16: pairs, C = pairs)
  const float* w;     // (Co, C, 3, 3) words (bf16: (Co, pairs, 9))
  const void* bias;   // (Co) float32, or bf16 with bias_bf16; or null
  float* y;           // (N, Co, H, W): pre-norm output of pass 1
  float* part;        // (N, Co, tiles, 3): count, mean, M2 of each patch
  int c, co, h, wd, d, tiles_x, tiles, v, pw;  // v: words per halo copy; pw: row words
  int bias_bf16;
};

template <bool kBf16>
__global__ void __launch_bounds__(kBlock, 2 / kGroups)
conv3x3_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_stat[kRows][kCo][3];  // per patch row: count, mean, M2
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCo;
  const int y0 = (blockIdx.x / a.tiles_x) * kRows;
  const int x0 = (blockIdx.x % a.tiles_x) * kCols;
  const int hp = a.h + 2 * a.d;
  const conv3x3::Plane in{a.x + (int64_t)n * a.c * hp * a.pw, hp, a.pw, 0};

  float acc[kMT][kNT][4];
  conv3x3::conv_tile<kStages, kGroups, kBf16>(in, a.w, a.c, a.co, co0, y0, x0,
                                              conv3x3::geometry(a.d, kGroups, a.v, 0), smem,
                                              acc);

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
        float bias = 0.f;
        if (a.bias != nullptr && oc_ok)
          bias = a.bias_bf16 ? __uint_as_float(
                                   (unsigned)static_cast<const uint16_t*>(a.bias)[oc] << 16)
                             : static_cast<const float*>(a.bias)[oc];
        float* yo = a.y + ((int64_t)n * a.co + (oc_ok ? oc : 0)) * hw + (int64_t)yy * a.wd;
        float cnt = 0.f, mean = 0.f, m2 = 0.f;
        if (oc_ok && row_ok && x0 + kCols <= a.wd) {
          // all four pixels: welford_add's steps with their divisors known,
          // so 1, 2 and 4 become exact products (the same results)
          float v[4];
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int r = b; r < 4; r += 2) {
              v[i * 2 + r / 2] = acc[i][j][r] + bias;
              yo[x0 + conv3x3::frag_col(i, r)] = v[i * 2 + r / 2];
            }
          mean = 0.f + v[0];
          m2 = 0.f + v[0] * (v[0] - mean);
          float d = v[1] - mean;
          mean += d * 0.5f;
          m2 += d * (v[1] - mean);
          d = v[2] - mean;
          mean += d / 3.f;
          m2 += d * (v[2] - mean);
          d = v[3] - mean;
          mean += d * 0.25f;
          m2 += d * (v[3] - mean);
          cnt = 4.f;
        } else {
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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                                            bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One block per (n, co) plane: merge the patch statistics, then normalise the
// float32 pre-norm plane y, activate, add the residual and write T.  In
// float32 y is the output itself (in place); vec: hw % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
norm_act_kernel(const float* y, T* out, const T* __restrict__ residual,
                const float* __restrict__ part, int tiles, int64_t hw, float eps, int act,
                bool vec) {
  const int64_t plane = blockIdx.x;
  float mean = 0.f, m2 = 0.f, n = 0.f;
  for (int t = threadIdx.x; t < tiles; t += kNormThreads) {
    const float* s = part + (plane * tiles + t) * 3;
    welford_merge(mean, m2, n, s[1], s[2], s[0]);
  }
  const float2 stats = block_mean_rstd<kNormThreads>(mean, m2, n, eps);

  const float* yp = y + plane * hw;
  T* op = out + plane * hw;
  const T* rp = residual ? residual + plane * hw : nullptr;
  if (vec) {
    for (int64_t i = (int64_t)threadIdx.x * 4; i < hw; i += kNormThreads * 4) {
      float4 v = load4(yp + i);
      v.x = apply_act((v.x - stats.x) * stats.y, act);
      v.y = apply_act((v.y - stats.x) * stats.y, act);
      v.z = apply_act((v.z - stats.x) * stats.y, act);
      v.w = apply_act((v.w - stats.x) * stats.y, act);
      if (rp) {
        const float4 r = load4(rp + i);
        v.x += r.x;
        v.y += r.y;
        v.z += r.z;
        v.w += r.w;
      }
      store4(op + i, v);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kNormThreads) {
      float v = apply_act((yp[i] - stats.x) * stats.y, act);
      if (rp) v += load1(rp + i);
      store1(op + i, v);
    }
  }
}

// Byte offsets of the bf16 form's scratch, each part 256-byte aligned.
struct Bf16Scratch {
  int64_t xi, wi, y, part, total;
};

inline int64_t align256(int64_t b) { return (b + 255) / 256 * 256; }


inline Bf16Scratch bf16_scratch(int64_t n, int64_t c, int64_t co, int64_t h, int64_t w,
                                int64_t d, int64_t tiles) {
  const int64_t p = (c + 1) / 2;
  const int64_t wq = (w + 2 * d + kRowWords - 1) / kRowWords * kRowWords;
  Bf16Scratch s;
  s.xi = 0;
  s.wi = s.xi + align256(4 * n * p * (h + 2 * d) * wq);
  s.y = s.wi + align256(4 * co * p * 9);
  s.part = s.y + align256(4 * n * co * h * w);
  s.total = s.part + align256(4 * n * co * tiles * 3);
  return s;
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
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ConvArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(wt);
  a.bias = bias;
  a.bias_bf16 = 0;
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
  a.pw = (int)(w + 2 * d);
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCo - 1) / kCo), (unsigned)n);
  conv3x3_kernel<false><<<grid, kBlock, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_act_kernel<float><<<(unsigned)(n * co), kNormThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<float*>(out), static_cast<const float*>(residual),
      static_cast<const float*>(scratch), (int)tiles, hw, eps, act, hw % 4 == 0);
  return (int)cudaGetLastError();
}

// Bytes of scratch the bf16 form needs for these shapes.
int64_t conv3x3_in_act_bf16_scratch(int64_t n, int64_t c, int64_t co, int64_t h, int64_t w,
                                    int64_t d) {
  return bf16_scratch(n, c, co, h, w, d, conv3x3_in_act_tiles(h, w)).total;
}

// The bf16 form: x (n, c, h+2d, w+2d) bf16, wt (co, c, 3, 3) float32
// (w_f32 != 0) or bf16, rounded to bf16; bias (co) float32, or bf16 (b_bf16
// != 0, widened exactly), or null; residual (n, co, h, w) bf16 or null; out
// (n, co, h, w) bf16; scratch of conv3x3_in_act_bf16_scratch bytes, 256-byte
// aligned; all contiguous, out and residual 16-byte aligned.
int conv3x3_in_act_bf16(const void* x, const void* wt, int w_f32, const void* bias, int b_bf16,
                        const void* residual, void* out, void* scratch, int64_t scratch_bytes,
                        int64_t n, int64_t c, int64_t co, int64_t h, int64_t w, int64_t d,
                        float eps, int act, void* stream) {
  const int64_t hw = h * w;
  const int64_t tiles = conv3x3_in_act_tiles(h, w);
  const Bf16Scratch sc = bf16_scratch(n, c, co, h, w, d, tiles);
  if (scratch_bytes < sc.total || reinterpret_cast<uintptr_t>(scratch) % 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  uint32_t* xi = reinterpret_cast<uint32_t*>(base + sc.xi);
  uint32_t* wi = reinterpret_cast<uint32_t*>(base + sc.wi);
  float* y = reinterpret_cast<float*>(base + sc.y);
  float* part = reinterpret_cast<float*>(base + sc.part);
  const int64_t p = (c + 1) / 2;
  const int64_t hp = h + 2 * d, wp = w + 2 * d;
  const int64_t wq = (wp + kRowWords - 1) / kRowWords * kRowWords;
  const int64_t nx = n * p * hp * wq, nw = co * p * 9;
  // every element index of x, w and their pair buffers within 32 bits
  if (!bf16_pairs::pairs_fit(nx, nw, n, c, hp, wp, co)) return (int)cudaErrorInvalidValue;
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  cudaError_t err =
      w_f32 ? bf16_pairs::launch_pairs(xb, xi, nx, c, p, hp, wp, wq,
                                       static_cast<const float*>(wt), wi, nw, s)
            : bf16_pairs::launch_pairs(xb, xi, nx, c, p, hp, wp, wq,
                                       static_cast<const uint16_t*>(wt), wi, nw, s);
  if (err != cudaSuccess) return (int)err;
  const int v = conv3x3::halo_vec(xi, wq);
  const size_t smem = conv3x3::smem_bytes(conv3x3::geometry((int)d, kGroups, v, 0), kStages);
  err = cudaFuncSetAttribute(conv3x3_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ConvArgs a;
  a.x = reinterpret_cast<const float*>(xi);
  a.w = reinterpret_cast<const float*>(wi);
  a.bias = bias;
  a.bias_bf16 = b_bf16;
  a.y = y;
  a.part = part;
  a.c = (int)p;
  a.co = (int)co;
  a.h = (int)h;
  a.wd = (int)w;
  a.d = (int)d;
  a.tiles_x = (int)((w + kCols - 1) / kCols);
  a.tiles = (int)tiles;
  a.v = v;
  a.pw = (int)wq;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCo - 1) / kCo), (unsigned)n);
  conv3x3_kernel<true><<<grid, kBlock, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_act_kernel<__nv_bfloat16><<<(unsigned)(n * co), kNormThreads, 0, s>>>(
      y, static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(residual), part,
      (int)tiles, hw, eps, act, hw % 4 == 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
