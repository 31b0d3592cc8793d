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
// TB/s: about even, bytes first.  One launch, no scratch:
// - the tile of conv3x3_bf16.cuh (wgmma m64n64k16 on a 4 x 64-pixel tile,
//   one consumer warpgroup; two producer warpgroups stage x straight from
//   its NCHW rows and turn it into the operand layout in shared memory);
// - each stage's halo, 16 channels x 6 rows x 80 columns, is one TMA box
//   of a 4-d tensor map over x (w, h, c, n) whose zero fill outside the
//   tensor is the SAME border, where W % 8 == 0 and x is 16-byte aligned
//   (chosen by shape; a map the driver refuses is an error); else a bulk
//   copy per row;
// - a persistent grid of one block per SM (per 64-channel block of Co):
//   each block rounds and stores its 64 x C x 9 weights in shared memory
//   once (73.7 KB at C = 64; streamed per stage where C is too large to
//   stay) and then walks tiles n-major, a 3-stage halo ring running across
//   tile boundaries;
// - the output is rounded to bf16 once, staged as the tile's 64 channel
//   rows in shared memory and written in 16-byte stores (2-byte stores
//   where W % 8 != 0).
//
// The launchers return cudaGetLastError().  Nothing here allocates or
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_bf16.cuh"
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

// x (N, C, H, W) floats; y (N, Co, H, W) floats.
__global__ void __launch_bounds__(kBlock, 2 / kGroups)
conv3x3_same_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, int c, int co, int h, int wd, int tiles_x, int v) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCo;
  const int y0 = (blockIdx.x / tiles_x) * kRows;
  const int x0 = (blockIdx.x % tiles_x) * kCols;
  const int64_t hw = (int64_t)h * wd;
  const conv3x3::Plane in{x + (int64_t)n * c * h * wd, h, wd, 1};

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

// ------------------------------------------------------------- bf16 ---

namespace cb = conv_bf16;

constexpr int kN16 = 64;   // output channels per block
constexpr int kProd = 256;  // producer threads (two warpgroups)
constexpr int kBlock16 = cb::kConsumers + kProd;
constexpr int kLook = 3;   // halo stages requested ahead
// the output staging: per channel the tile's 4 x 64 bf16, +16 bytes so that
// the accumulator stores of 4 channels fall in different banks
constexpr int kStgCo = cb::kTileRows * cb::kTileCols * 2 + 16;
constexpr int kStgBytes = kN16 * kStgCo;

struct LowchEpi {
  uint16_t* y;
  int co, co0, h, w, vec;
  char* stg;

  // in the consumer warpgroup
  __device__ __forceinline__ void operator()(float (&acc)[cb::kRowsPerWg][kN16 / 2], int,
                                             const cb::Item& it, bool) {
    cb::consumer_sync();  // every consumer is done with the last tile's staging
    // an add before the first read of each sum: without it ptxas serialises
    // every wgmma of the kernel (its warning C7514; tools/tile_variants.py's
    // "lowch epilogue without the add"); it changes no value but -0 to +0
#pragma unroll
    for (int i = 0; i < cb::kRowsPerWg; ++i)
#pragma unroll
      for (int r = 0; r < kN16 / 2; ++r) acc[i][r] += 0.f;
#pragma unroll
    for (int i = 0; i < cb::kRowsPerWg; ++i)
#pragma unroll
      for (int j = 0; j < kN16 / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<uint16_t*>(
                stg + cb::frag_co(j, e) * kStgCo +
                (cb::frag_row(i) * cb::kTileCols + cb::frag_px(hh)) * 2) =
                cb::bf16_bits(acc[i][4 * j + 2 * hh + e]);
    cb::consumer_sync();
    // 16-byte runs of a channel's row: (channel, row, 8 columns)
    for (int t = threadIdx.x; t < kN16 * cb::kTileRows * 8; t += cb::kConsumers) {
      const int v = t & 7;
      const int rr = t >> 3;
      const int r = rr % cb::kTileRows;
      const int m = rr / cb::kTileRows;
      const int oc = co0 + m, yy = it.y0 + r, xx = it.x0 + 8 * v;
      if (oc >= co || yy >= h || xx >= w) continue;
      const char* src = stg + m * kStgCo + (r * cb::kTileCols + 8 * v) * 2;
      uint16_t* dst = y + (((int64_t)it.n * co + oc) * h + yy) * w + xx;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && xx + e < w; ++e)
          dst[e] = reinterpret_cast<const uint16_t*>(src)[e];
      }
    }
  }
};

__global__ void __launch_bounds__(kBlock16, 1)
conv3x3_same_bf16_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
                         int w_f32, uint16_t* __restrict__ y, int co, int n,
                         const __grid_constant__ cb::Geo g, int vec,
                         const __grid_constant__ CUtensorMap map, int use_map) {
  extern __shared__ __align__(128) char dsmem[];
  const int co0 = blockIdx.y * kN16;
  LowchEpi epi{y, co, co0, g.h, g.w, vec, dsmem + g.epi_off};
  cb::conv_tiles<kN16, kLook, kProd>(x, use_map ? &map : nullptr, w, w_f32, co, co0, g,
                                           blockIdx.x, gridDim.x, n * g.tiles, 0, dsmem, epi);
}

// Whether the bf16 form stages x through a tensor map (one TMA box a
// stage): where its rows are 16-byte multiples and its base 16-byte aligned,
// as the map requires; by shape alone, never because something failed.
bool uses_map(const void* x, int64_t w) {
  return w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// x as a tensor map of boxes (cols, rows, 16, 1) over (w, h, c, n), zero
// outside the tensor
cudaError_t encode_map(CUtensorMap* map, const void* x, int64_t n, int64_t c, int64_t h,
                       int64_t w, const cb::Geo& g) {
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)c, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)w * 2, (cuuint64_t)(h * w * 2),
                                 (cuuint64_t)(c * h * w * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)g.cols, (cuuint32_t)g.rows, cb::kStageCh, 1};
  return cb::encode_bf16_map(map, 4, x, dims, strides, box);
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

// Whether the bf16 form takes x's halo through a tensor map (else by a
// bulk copy per row): 1 or 0.
int conv3x3_same_bf16_uses_map(const void* x, int64_t w) { return uses_map(x, w) ? 1 : 0; }

// x (n, c, h, w) bf16, wt (co, c, 3, 3) float32 (w_f32 != 0) or bf16,
// rounded to bf16; out (n, co, h, w) bf16; all contiguous.
int conv3x3_same_bf16(const void* x, const void* wt, int w_f32, void* out, int64_t n, int64_t c,
                      int64_t co, int64_t h, int64_t w, void* stream) {
  cb::Geo g = cb::make_geo<kN16, kLook>((int)c, (int)h, (int)w, 1, 1, (int)h, (int)w, x, wt,
                                        w_f32 != 0, kStgBytes, true);
  g.x_bytes = n * c * h * w * 2;
  if (g.smem > cb::kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_same_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int64_t co_blocks = (co + kN16 - 1) / kN16;
  const int64_t items = n * g.tiles;
  int64_t per = sms / co_blocks;
  if (per < 1) per = 1;
  const dim3 grid((unsigned)(items < per ? items : per), (unsigned)co_blocks);
  const int vec = w % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap map;
  const int use_map = uses_map(x, w);
  if (use_map && (err = encode_map(&map, x, n, c, h, w, g)) != cudaSuccess) return (int)err;
  conv3x3_same_bf16_kernel<<<grid, kBlock16, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), wt, w_f32, static_cast<uint16_t*>(out), (int)co,
      (int)n, g, vec, map, use_map);
  return (int)cudaGetLastError();
}

}  // extern "C"
