// SAME 3x3 stride-1 convolution for Hopper (sm_90a), float32 or bf16, NCHW,
// no bias.
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
// bf16 (x and the output bf16, the weight rounded to bf16), as the TPU
// kernel under the --dtype bfloat16 policy, where VGG19 is stored in bf16:
// it casts w to x's dtype, sums in float32 and writes x's dtype.  At (16,
// 64, 512^2) the products are 309.2 GFLOP, 0.31 ms at the 989 TFLOP/s of
// dense bf16, against 1.07 GB of bf16 input and output, 0.32 ms at 3.35
// TB/s: about even, bytes first.
// - pass 0 (pair_kernel, bf16_pairs.cuh) packs x as bf16 channel pairs, one
//   32-bit word per pixel and pair, rows padded to 16 bytes, and the
//   weights as (co, pair, tap) words rounded to bf16, the layout of the
//   tile's bf16 form; the plane stays unpadded, and the SAME zero border is
//   again cp.async's zero-fill (with the pair pass's zero columns past W);
// - pass 1 is the same tile with one mma.sync m16n8k16 bf16 product per 16
//   input channels and tap (fp32 sums, a fresh chain per step), and the
//   output is rounded to bf16 once from the fp32 sums.  The pair pass moves
//   x once more each way (1.07 GB in all at that shape), which the bound
//   above does not count.
//
// The launchers return cudaGetLastError().  Nothing here allocates or
// synchronises: the bf16 form's pair planes are the caller's scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_pairs.cuh"
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
// the bf16 pair planes' rows are padded to a multiple of this many words
// (16 bytes), so that every halo copy is a 16-byte cp.async
constexpr int kRowWords = 4;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x: (N, C, H, pw) words (floats, or with kBf16 bf16 channel pairs and C
// the pairs); y (N, Co, H, W) floats or bf16.
template <bool kBf16, typename T>
__global__ void __launch_bounds__(kBlock, 2 / kGroups)
conv3x3_same_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, int c, int co, int h, int wd, int pw, int tiles_x, int v) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCo;
  const int y0 = (blockIdx.x / tiles_x) * kRows;
  const int x0 = (blockIdx.x % tiles_x) * kCols;
  const int64_t hw = (int64_t)h * wd;
  if (!kBf16) pw = wd;  // float32 rows are not padded
  const conv3x3::Plane in{x + (int64_t)n * c * h * pw, h, pw, 1};

  float acc[kMT][kNT][4];
  conv3x3::conv_tile<kStages, kGroups, kBf16>(in, w, c, co, co0, y0, x0,
                                              conv3x3::geometry(1, kGroups, v, 1), smem, acc);

  const int yy = y0 + conv3x3::frag_row();
  if (threadIdx.x >= kThreads || yy >= h) return;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int oc = co0 + conv3x3::frag_ch(j, r);
      if (oc >= co) continue;
      T* yo = y + ((int64_t)n * co + oc) * hw + (int64_t)yy * wd;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int xx = x0 + conv3x3::frag_col(i, r);
        if (xx < wd) store(yo + xx, acc[i][j][r]);
      }
    }
}

// Byte offsets of the bf16 form's scratch: the pair planes of x, then of
// the weights, 256-byte aligned.
struct Bf16Scratch {
  int64_t p, wq, xi, wi, total;
};

inline Bf16Scratch bf16_scratch(int64_t n, int64_t c, int64_t co, int64_t h, int64_t w) {
  Bf16Scratch s;
  s.p = (c + 1) / 2;
  s.wq = (w + kRowWords - 1) / kRowWords * kRowWords;
  s.xi = 0;
  s.wi = (4 * n * s.p * h * s.wq + 255) / 256 * 256;
  s.total = s.wi + 4 * co * s.p * 9;
  return s;
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
  auto kernel = conv3x3_same_kernel<false, float>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCo - 1) / kCo), (unsigned)n);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<float*>(out),
      (int)c, (int)co, (int)h, (int)w, (int)w, (int)tiles_x, v);
  return (int)cudaGetLastError();
}

// Bytes of scratch the bf16 form needs for these shapes.
int64_t conv3x3_same_bf16_scratch(int64_t n, int64_t c, int64_t co, int64_t h, int64_t w) {
  return bf16_scratch(n, c, co, h, w).total;
}

// x (n, c, h, w) bf16, wt (co, c, 3, 3) float32 (w_f32 != 0) or bf16,
// rounded to bf16; out (n, co, h, w) bf16; scratch of
// conv3x3_same_bf16_scratch bytes, 256-byte aligned; all contiguous.
int conv3x3_same_bf16(const void* x, const void* wt, int w_f32, void* out, void* scratch,
                      int64_t scratch_bytes, int64_t n, int64_t c, int64_t co, int64_t h,
                      int64_t w, void* stream) {
  const Bf16Scratch sc = bf16_scratch(n, c, co, h, w);
  if (scratch_bytes < sc.total || reinterpret_cast<uintptr_t>(scratch) % 256)
    return (int)cudaErrorInvalidValue;
  const int64_t nx = n * sc.p * h * sc.wq, nw = co * sc.p * 9;
  if (!bf16_pairs::pairs_fit(nx, nw, n, c, h, w, co)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  uint32_t* xi = reinterpret_cast<uint32_t*>(base + sc.xi);
  uint32_t* wi = reinterpret_cast<uint32_t*>(base + sc.wi);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  cudaError_t err =
      w_f32 ? bf16_pairs::launch_pairs(xb, xi, nx, c, sc.p, h, w, sc.wq,
                                       static_cast<const float*>(wt), wi, nw, s)
            : bf16_pairs::launch_pairs(xb, xi, nx, c, sc.p, h, w, sc.wq,
                                       static_cast<const uint16_t*>(wt), wi, nw, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles_x = (w + kCols - 1) / kCols;
  const int64_t tiles = tiles_x * ((h + kRows - 1) / kRows);
  const int v = conv3x3::halo_vec(xi, sc.wq);
  const size_t smem = conv3x3::smem_bytes(conv3x3::geometry(1, kGroups, v, 1), kStages);
  auto kernel = conv3x3_same_kernel<true, __nv_bfloat16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCo - 1) / kCo), (unsigned)n);
  kernel<<<grid, kBlock, smem, s>>>(reinterpret_cast<const float*>(xi),
                                    reinterpret_cast<const float*>(wi),
                                    static_cast<__nv_bfloat16*>(out), (int)sc.p, (int)co, (int)h,
                                    (int)w, (int)sc.wq, (int)tiles_x, v);
  return (int)cudaGetLastError();
}

}  // extern "C"
