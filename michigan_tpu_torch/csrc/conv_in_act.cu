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
// What the float32 design does about it:
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
// float32 or bf16), as the TPU kernel under the bf16 policy: the
// convolution sums in float32 and the statistics, normalisation,
// activation and residual add run on that float32 sum; the output is
// rounded to bf16 once.  Two launches, no float32 plane at 64^2:
// - a layout pass writes x_pad as 8-channel chunks of each pixel, (n, 2
//   ceil(C/16), H+2d, W+2d, 8), and the weight, rounded to bf16, in the
//   B-operand layout, per 32-channel block and 16-channel K stage (tap,
//   chunk, co, 8) (2.4 + 1.2 MB at the edit's shape, once per call, not
//   once per block);
// - the convolution: wgmma m64n32k16 on a 4 x 64-pixel tile x 32 output
//   channels by one consumer warpgroup, both operands from shared memory; a
//   producer thread only issues copies, per K stage one TMA box of the
//   layout pass's x (the A operand, zero past the plane) and one bulk copy
//   of its weights, straight into the operand layout, up to 3-6 stages
//   ahead in a ring on full / empty mbarriers, so neither the copies'
//   latency nor the hand-offs stand between the products.  (The one-launch form of the same tile, a
//   producer warpgroup transposing NCHW rows and storing weights per stage
//   through a 2-stage ring, took 100 us a call: its floor with no staging
//   at all was 31-34 us of hand-offs; tools/tile_variants.py.)
// - up to 16 blocks per (n, 32-channel block) plane, one 4 x 64 tile each
//   (at 64^2: 8 channel blocks x 16 = 128 blocks at batch 1, one per SM).
//   Each block adds the bias to its float32 sums and takes its tile's
//   (count, mean, M2) per channel (Welford over a thread's 4 pixels, Chan's
//   merge across lanes and warps), writes them to a small exchange buffer
//   and counts its arrival on the plane's counter; once the plane's blocks
//   have all arrived, every block merges their parts in rank order (the
//   same result in every block), normalises its own registers, applies the
//   act, stages the tile in shared memory, adds the residual and writes
//   bf16 in 16-byte stores: no float32 plane, no norm pass.  The grid is
//   sized so that the card holds all of it at once (else one block per
//   plane, which waits for none).  (A 16-block thread-block cluster per
//   plane, merging through distributed shared memory, fits on only 7 of
//   this card's GPCs: at batch 1 one of the 8 clusters shared 16 SMs with
//   another, or waited for a second wave; tools/tile_variants.py's probe.)
// - a plane of more tiles than blocks: the same kernels, the blocks walking
//   several tiles each; every tile but a block's last goes to a float32
//   pre-norm plane that the caller provides, and is read back and
//   normalised after the merge.  The form is chosen by shape and the card's
//   capacity (conv3x3_in_act_bf16_prenorm), never on a failure.
//
// The launchers return cudaGetLastError() after their launches.  Nothing
// here allocates or synchronises: the caller passes the output and the
// scratch (float32: the patch statistics; bf16: the layout pass's x_pad
// and weight, the statistics' exchange and, for planes of more tiles than
// blocks, the pre-norm plane).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_bf16.cuh"
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
  const float* x;     // (N, C, Hp, pw), padded by d
  const float* w;     // (Co, C, 3, 3)
  const float* bias;  // (Co) or null
  float* y;           // (N, Co, H, W): pre-norm output of pass 1
  float* part;        // (N, Co, tiles, 3): count, mean, M2 of each patch
  int c, co, h, wd, d, tiles_x, tiles, v, pw;  // v: floats per halo copy; pw: row floats
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
  const conv3x3::Plane in{a.x + (int64_t)n * a.c * hp * a.pw, hp, a.pw, 0};

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
        float bias = 0.f;
        if (a.bias != nullptr && oc_ok) bias = a.bias[oc];
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

// One block per (n, co) plane: merge the patch statistics, then normalise the
// pre-norm plane y, activate, add the residual and write out (y itself:
// in place); vec: hw % 4 == 0.
__global__ void __launch_bounds__(kNormThreads)
norm_act_kernel(const float* y, float* out, const float* __restrict__ residual,
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
  float* op = out + plane * hw;
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
      *reinterpret_cast<float4*>(op + i) = v;
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kNormThreads) {
      float v = apply_act((yp[i] - stats.x) * stats.y, act);
      if (rp) v += rp[i];
      op[i] = v;
    }
  }
}

// ------------------------------------------------------------- bf16 ---

namespace cb = conv_bf16;

constexpr int kN16 = 32;        // output channels per block
constexpr int kMaxBlocks = 16;  // blocks per (sample, co block) plane at most
constexpr int kProd = 32;        // the producer warp: one thread issues the copies
constexpr int kBlock16 = cb::kConsumers + kProd;
constexpr int kWarps = cb::kConsumers / 32;
constexpr int kRingMax = 6;         // operand stages in flight at most
constexpr int kRingBytes = 110592;  // the ring's shared memory: two blocks an SM
constexpr int kBStage = 9 * 2 * kN16 * 16;  // a stage's weights: [tap][chunk][co][8] bf16
constexpr int kLayoutThreads = 256;
// the output staging, float32, over the ring once the products are done:
// per channel the tile's 4 x 64 values, +16 bytes so that the accumulator
// stores of 4 channels fall in different banks
constexpr int kStgCo = cb::kTileRows * cb::kTileCols + 4;  // floats
constexpr int kStgBytes = kN16 * kStgCo * 4;

// One launch's shapes and shared-memory plan (host and device).  The layout
// pass writes x_pad as xt (n, 2 nk, ph, pw, 8) bf16, 8-channel chunks with
// zeros past c, and the weight as wl (co blocks, nk, 9, 2, 32, 8) bf16, zero
// past co and c: one K stage's operands are then whole 16-byte units, the
// A operand's [chunk][halo row][column][8 channels] a copy per (chunk, halo
// row) and the B operand's [tap][chunk][co][8 channels] one copy.
struct Geo16 {
  int c, ph, pw, d, h, w;       // input channels and plane, dilation, output plane
  int tiles_x, tiles;           // tiles per plane
  int rows, cols, nk;           // a tile's halo rows and columns; K stages
  int a_chunk, a_stage, stage;  // bytes: an A chunk, a stage's A operand, a ring stage
  int ring, smem;               // ring stages; dynamic shared memory
};

inline Geo16 make_geo16(int c, int h, int w, int d) {
  Geo16 g;
  g.c = c;
  g.d = d;
  g.h = h;
  g.w = w;
  g.ph = h + 2 * d;
  g.pw = w + 2 * d;
  g.tiles_x = (w + cb::kTileCols - 1) / cb::kTileCols;
  g.tiles = g.tiles_x * ((h + cb::kTileRows - 1) / cb::kTileRows);
  g.rows = cb::kTileRows + 2 * d;
  g.cols = cb::kTileCols + 2 * d;
  g.nk = (c + cb::kStageCh - 1) / cb::kStageCh;
  g.a_chunk = g.rows * g.cols * 16;
  g.a_stage = 2 * g.a_chunk;
  g.stage = (g.a_stage + kBStage + 127) / 128 * 128;
  g.ring = kRingBytes / g.stage < kRingMax ? kRingBytes / g.stage : kRingMax;
  g.smem = g.ring * g.stage > kStgBytes ? g.ring * g.stage : kStgBytes;
  return g;
}

// The layout pass (see Geo16): for blockIdx.y < planes (= n * 2 nk) the
// (sample, chunk) plane blockIdx.y of xt, two 16-byte units (8 channels of
// two pixels) per thread, reads coalesced along the pixels (4-byte reads
// where hw is even and x 4-byte aligned: pairs); above, with
// blockIdx.x = 0, the weights of one (co block, K stage), rounded to bf16:
// its 32 x 16 x 9 values read in rows through shared memory, written as
// 576 consecutive units.  Block (0, 0) also zeroes the convolution's
// arrival counters.
__global__ void __launch_bounds__(kLayoutThreads)
in_act_layout_kernel(const uint16_t* __restrict__ x, const void* __restrict__ w, int w_f32,
                     uint4* __restrict__ xt, uint4* __restrict__ wl, unsigned* __restrict__ count,
                     int counters, int c, int co, int planes, int hw, int nk, int pairs) {
  __shared__ uint16_t s_wt[kN16][cb::kStageCh * 9];
  const int tid = threadIdx.x;
  unsigned v[8];
  if ((int)blockIdx.y < planes) {
    if (blockIdx.x == 0 && blockIdx.y == 0)
      for (int i = tid; i < counters; i += kLayoutThreads) count[i] = 0u;
    const int u = 2 * (blockIdx.x * kLayoutThreads + tid);
    if (u >= hw) return;
    const int n = blockIdx.y / (2 * nk), q = blockIdx.y - n * 2 * nk;
    const uint16_t* src = x + ((int64_t)n * c + q * 8) * hw + u;
    uint4* dst = xt + (int64_t)blockIdx.y * hw + u;
    if (pairs) {  // v[e]: channel e of pixels u (low half) and u + 1
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = q * 8 + e < c ? *reinterpret_cast<const unsigned*>(src + (int64_t)e * hw) : 0u;
      dst[0] = make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                          __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
      dst[1] = make_uint4(__byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632),
                          __byte_perm(v[4], v[5], 0x7632), __byte_perm(v[6], v[7], 0x7632));
      return;
    }
    for (int p = 0; p < 2 && u + p < hw; ++p) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = q * 8 + e < c ? src[(int64_t)e * hw + p] : 0u;
      dst[p] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                          v[6] | v[7] << 16);
    }
    return;
  }
  if (blockIdx.x != 0) return;
  const int cob = (blockIdx.y - planes) / nk, k = (blockIdx.y - planes) % nk;
  constexpr int kRow = cb::kStageCh * 9;  // a co's 16 channels x 9 taps, contiguous in w
  const int valid = (c - k * cb::kStageCh < cb::kStageCh ? c - k * cb::kStageCh : cb::kStageCh) * 9;
  for (int t = tid; t < kN16 * kRow; t += kLayoutThreads) {
    const int m = t / kRow, r = t - m * kRow;
    const int oc = cob * kN16 + m;
    unsigned b = 0u;
    if (oc < co && r < valid) {
      const int64_t at = ((int64_t)oc * c + k * cb::kStageCh) * 9 + r;
      b = w_f32 ? cb::bf16_bits(static_cast<const float*>(w)[at])
                : static_cast<const uint16_t*>(w)[at];
    }
    s_wt[m][r] = (uint16_t)b;
  }
  __syncthreads();
  uint4* dst = wl + ((int64_t)cob * nk + k) * (kBStage / 16);
  for (int u = tid; u < kBStage / 16; u += kLayoutThreads) {  // ((tap * 2 + q) * 32 + m)
    const int m = u % kN16, tq = u / kN16;
    const int q = tq & 1, tap = tq >> 1;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = s_wt[m][(q * 8 + e) * 9 + tap];
    dst[u] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                        v[6] | v[7] << 16);
  }
}

struct Bf16Args {
  const uint4* wl;             // the layout pass's weight (Geo16)
  const void* bias;            // (Co) float32, or bf16 (bias_bf16), or null
  const uint16_t* residual;    // (N, Co, H, W) bf16 or null
  uint16_t* out;               // (N, Co, H, W) bf16
  float* prenorm;              // (N, Co, H, W) float32: planes of more tiles than blocks
  float* xchg;                 // per plane, block and channel: count, mean, M2
  unsigned* count;             // per plane: the blocks that wrote their part to xchg
  int bias_bf16, co, act, vec;  // vec: 16-byte output rows (W % 8 == 0, aligned)
  float eps;
  Geo16 g;
};

struct InActEpi {
  const Bf16Args& a;
  int co0;
  char* stg;
  float (*s_w)[kN16][3];    // per warp and channel: count, mean, M2
  float (*s_run)[3];        // per channel: the block's tiles so far
  float2* s_stat;           // per channel: mean, rstd of the plane
  const float* s_bias;      // per channel: the bias, 0 past co

  // before the products: the block's bias into shared memory (by the first
  // kN16 consumer threads)
  __device__ __forceinline__ void load_bias(float* dst) const {
    const int oc = co0 + threadIdx.x;
    float b = 0.f;
    if (a.bias != nullptr && oc < a.co)
      b = a.bias_bf16
              ? __uint_as_float((unsigned)static_cast<const uint16_t*>(a.bias)[oc] << 16)
              : static_cast<const float*>(a.bias)[oc];
    dst[threadIdx.x] = b;
  }

  __device__ __forceinline__ float finish(float v, int m, float res) const {
    return apply_act((v - s_stat[m].x) * s_stat[m].y, a.act) + res;
  }

  // in the consumer warpgroup
  __device__ __forceinline__ void operator()(float (&acc)[cb::kRowsPerWg][kN16 / 2], int li,
                                             const cb::Item& it, bool last) {
    cb::consumer_sync();  // every consumer is done with the last tile's s_w
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const Geo16& g = a.g;
    // the bias, and the tile's statistics per channel: a thread's 4 pixels
    // of each of its 8 channels, then its 8 lanes, then the 8 warps
#pragma unroll
    for (int j = 0; j < kN16 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = s_bias[cb::frag_co(j, e)];
        // the thread's (up to) 8 values: their mean, then the squares about
        // it
        float cnt = 0.f, sum = 0.f;
        bool in[cb::kRowsPerWg][2];
#pragma unroll
        for (int i = 0; i < cb::kRowsPerWg; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& v = acc[i][4 * j + 2 * hh + e];
            v += b;
            in[i][hh] = it.y0 + cb::frag_row(i) < g.h && it.x0 + cb::frag_px(hh) < g.w;
            if (in[i][hh]) {
              sum += v;
              cnt += 1.f;
            }
          }
        const float mean_ = cnt == 8.f ? sum * 0.125f : cnt > 0.f ? sum / cnt : 0.f;
        float m2 = 0.f;
#pragma unroll
        for (int i = 0; i < cb::kRowsPerWg; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float dv = acc[i][4 * j + 2 * hh + e] - mean_;
            if (in[i][hh]) m2 += dv * dv;
          }
        float mean = cnt > 0.f ? mean_ : 0.f;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
          const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
          const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
          welford_merge(mean, m2, cnt, mb, m2b, nb);
        }
        if (lane < 4) {
          float* s = s_w[tid >> 5][cb::frag_co(j, e)];
          s[0] = cnt;
          s[1] = mean;
          s[2] = m2;
        }
      }
    cb::consumer_sync();
    if (tid < kN16) {
      float cnt = 0.f, mean = 0.f, m2 = 0.f;
      if (li > 0) {
        cnt = s_run[tid][0];
        mean = s_run[tid][1];
        m2 = s_run[tid][2];
      }
#pragma unroll
      for (int k = 0; k < kWarps; ++k)
        welford_merge(mean, m2, cnt, s_w[k][tid][1], s_w[k][tid][2], s_w[k][tid][0]);
      s_run[tid][0] = cnt;
      s_run[tid][1] = mean;
      s_run[tid][2] = m2;
    }
    if (!last) {  // a tile before the block's last: its pre-norm sums out
#pragma unroll
      for (int i = 0; i < cb::kRowsPerWg; ++i)
#pragma unroll
        for (int r = 0; r < kN16 / 2; ++r) {
          const int oc = co0 + cb::frag_co(r / 4, r & 1);
          const int yy = it.y0 + cb::frag_row(i), xx = it.x0 + cb::frag_px((r >> 1) & 1);
          if (oc < a.co && yy < g.h && xx < g.w)
            a.prenorm[(((int64_t)it.n * a.co + oc) * g.h + yy) * g.w + xx] = acc[i][r];
        }
      return;
    }

    // the plane's statistics: every block writes its partial ones to
    // xchg, fences them and counts its arrival on the plane's counter; once
    // all gridDim.x blocks of the plane have arrived (the launch holds them
    // all at once, or has one block per plane), every block merges the
    // parts in rank order (the same result in every block)
    const int plane = blockIdx.z * gridDim.y + blockIdx.y;
    const float* part = a.xchg + (int64_t)plane * kMaxBlocks * kN16 * 3;
    if (tid < kN16) {
      float* p = a.xchg + (((int64_t)plane * kMaxBlocks + blockIdx.x) * kN16 + tid) * 3;
      p[0] = s_run[tid][0];
      p[1] = s_run[tid][1];
      p[2] = s_run[tid][2];
      __threadfence();
    }
    cb::consumer_sync();
    if (tid == 0) {
      atomicAdd(&a.count[plane], 1u);
      unsigned arrived = 0;
      // a wait of seconds means the plane's blocks cannot all arrive: an
      // error, not a hung card
      for (unsigned tries = 0;; ++tries) {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(arrived)
                     : "l"(&a.count[plane])
                     : "memory");
        if (arrived >= gridDim.x) break;
        if (tries > (1u << 26)) __trap();
        __nanosleep(32);
      }
    }
    cb::consumer_sync();
    // thread (group g, channel m) merges the parts of ranks g, g + 4, ...
    // (their loads all in flight at once), then the first kN16 threads
    // merge the 4 groups in order: the same tree in every block
    __threadfence();
    {
      constexpr int kPer = kMaxBlocks / kWarps;
      const int m = tid % kN16, grp = tid / kN16;
      float q[kPer][3];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const unsigned r = grp + j * kWarps;
        const float* at = part + (r * kN16 + m) * 3;
#pragma unroll
        for (int e = 0; e < 3; ++e) q[j][e] = r < gridDim.x ? __ldcg(at + e) : 0.f;
      }
      float cnt = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) welford_merge(mean, m2, cnt, q[j][1], q[j][2], q[j][0]);
      s_w[grp][m][0] = cnt;
      s_w[grp][m][1] = mean;
      s_w[grp][m][2] = m2;
    }
    cb::consumer_sync();
    if (tid < kN16) {
      float cnt = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k)
        welford_merge(mean, m2, cnt, s_w[k][tid][1], s_w[k][tid][2], s_w[k][tid][0]);
      s_stat[tid] = make_float2(mean, rsqrtf(m2 / cnt + a.eps));
    }
    cb::consumer_sync();  // s_stat complete

    // this tile: normalised and activated in registers, staged, then the
    // residual added and bf16 written in runs of 8 columns
    float* st = reinterpret_cast<float*>(stg);
#pragma unroll
    for (int i = 0; i < cb::kRowsPerWg; ++i)
#pragma unroll
      for (int r = 0; r < kN16 / 2; ++r) {
        const int m = cb::frag_co(r / 4, r & 1);
        st[m * kStgCo + cb::frag_row(i) * cb::kTileCols + cb::frag_px((r >> 1) & 1)] =
            finish(acc[i][r], m, 0.f);
      }
    cb::consumer_sync();
#pragma unroll
    for (int t = tid; t < kN16 * cb::kTileRows * 8; t += cb::kConsumers) {
      const int v = t & 7;
      const int rr = t >> 3;
      const int r = rr % cb::kTileRows;
      const int m = rr / cb::kTileRows;
      const int oc = co0 + m, yy = it.y0 + r, xx = it.x0 + 8 * v;
      if (oc >= a.co || yy >= g.h || xx >= g.w) continue;
      const float* src = st + m * kStgCo + r * cb::kTileCols + 8 * v;
      const int64_t at = (((int64_t)it.n * a.co + oc) * g.h + yy) * g.w + xx;
      if (a.vec) {
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        float o[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (a.residual != nullptr) {
          const uint4 rv = *reinterpret_cast<const uint4*>(a.residual + at);
          const unsigned rw[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[2 * e] += __uint_as_float(rw[e] << 16);
            o[2 * e + 1] += __uint_as_float(rw[e] & 0xffff0000u);
          }
        }
        unsigned ow[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ow[e] = cb::bf16_bits(o[2 * e]) | (cb::bf16_bits(o[2 * e + 1]) << 16);
        *reinterpret_cast<uint4*>(a.out + at) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
      } else {
        for (int e = 0; e < 8 && xx + e < g.w; ++e) {
          float o = src[e];
          if (a.residual != nullptr) o += __uint_as_float((unsigned)a.residual[at + e] << 16);
          a.out[at + e] = (uint16_t)cb::bf16_bits(o);
        }
      }
    }
    // the block's earlier tiles, from the pre-norm plane
    for (int l = 0; l < li; ++l) {
      const cb::Item e = cb::item_at(g, blockIdx.z, blockIdx.x + l * gridDim.x);
      for (int t = tid; t < kN16 * cb::kTileRows * cb::kTileCols; t += cb::kConsumers) {
        const int x = t % cb::kTileCols;
        const int rr = t / cb::kTileCols;
        const int r = rr % cb::kTileRows;
        const int m = rr / cb::kTileRows;
        const int oc = co0 + m, yy = e.y0 + r, xx = e.x0 + x;
        if (oc >= a.co || yy >= g.h || xx >= g.w) continue;
        const int64_t at = (((int64_t)e.n * a.co + oc) * g.h + yy) * g.w + xx;
        const float res =
            a.residual != nullptr ? __uint_as_float((unsigned)a.residual[at] << 16) : 0.f;
        a.out[at] = (uint16_t)cb::bf16_bits(finish(a.prenorm[at], m, res));
      }
    }
  }
};

// The tiles blockIdx.x, blockIdx.x + gridDim.x, ... of plane (blockIdx.z,
// co block blockIdx.y): a producer thread copies each K stage's operands
// from xt (map: a TMA box) and wl into a ring of g.ring stages (completion
// counted in bytes on the stage's full mbarrier; it waits on the stage's
// empty one before reusing it), one consumer warpgroup runs the stage's 36 wgmma m64n32k16
// (4 output rows x 9 taps), both operands read through shared-memory
// descriptors (a tap's shift moves A's start by whole 16-byte units), and
// releases the stage once wgmma.wait_group has retired it; then the
// epilogue.
__global__ void __launch_bounds__(kBlock16, 2)
conv3x3_in_act_bf16_kernel(const __grid_constant__ Bf16Args a,
                           const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) char dsmem[];
  __shared__ float s_w[kWarps][kN16][3];
  __shared__ float s_run[kN16][3];
  __shared__ float2 s_stat[kN16];
  __shared__ float s_bias[kN16];
  __shared__ __align__(8) uint64_t full_bar[kRingMax];
  __shared__ __align__(8) uint64_t empty_bar[kRingMax];
  const Geo16& g = a.g;
  const int tid = threadIdx.x;
  const int co0 = blockIdx.y * kN16;
  // blockIdx.x: the block's rank in its (n, channel block) plane, whose
  // tiles are dealt out in rank order
  const int first = blockIdx.x, stride = gridDim.x;
  const int n_items = first < g.tiles ? (g.tiles - first + stride - 1) / stride : 0;
  InActEpi epi{a, co0, dsmem, s_w, s_run, s_stat, s_bias};
  if (tid == 0)
    for (int i = 0; i < g.ring; ++i) {
      cb::mbar_init(&full_bar[i], 1);
      cb::mbar_init(&empty_bar[i], cb::kConsumers);
    }
  if (tid < kN16) epi.load_bias(s_bias);
  __syncthreads();

  if (tid >= cb::kConsumers) {
    // ------------------------------------------------------ producer ---
    // one thread: per stage one TMA box of xt, the A operand [chunk][halo
    // row][column][8] (zero past the plane), and one bulk copy of wl, B
    if (tid != cb::kConsumers) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
    int k = 0, li = 0;
    cb::Item it = cb::item_at(g, blockIdx.z, first);
#pragma unroll 1
    for (int s = 0; s < n_items * g.nk; ++s) {
      const int slot = s % g.ring;
      if (s >= g.ring) cb::mbar_wait(&empty_bar[slot], (s / g.ring - 1) & 1);
      char* base = dsmem + slot * g.stage;
      cb::mbar_arrive_tx(&full_bar[slot], g.a_stage + kBStage);
      cb::tma_load_4d(base, &map, 0, it.x0, it.y0, it.n * 2 * g.nk + 2 * k, &full_bar[slot]);
      cb::bulk_copy(base + g.a_stage, a.wl + ((int64_t)blockIdx.y * g.nk + k) * (kBStage / 16),
                    kBStage, &full_bar[slot]);
      if (++k == g.nk) {
        k = 0;
        if (++li < n_items) it = cb::item_at(g, blockIdx.z, first + li * stride);
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers ---
  float acc[cb::kRowsPerWg][kN16 / 2];
  int s = 0;
#pragma unroll 1
  for (int li = 0; li < n_items; ++li) {
#pragma unroll 1
    for (int k = 0; k < g.nk; ++k, ++s) {
      const int slot = s % g.ring;
      cb::mbar_wait(&full_bar[slot], (s / g.ring) & 1);
      const char* a_base = dsmem + slot * g.stage;
      const char* b_base = a_base + g.a_stage;
      cb::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const uint64_t db =
            cb::make_desc(cb::smem_u32(b_base + tap * 2 * kN16 * 16), kN16 * 16, 128);
#pragma unroll
        for (int i = 0; i < cb::kRowsPerWg; ++i) {
          const uint64_t da = cb::make_desc(
              cb::smem_u32(a_base + ((i + dy * g.d) * g.cols + dx * g.d) * 16), g.a_chunk, 128);
          cb::wgmma<kN16>(acc[i], da, db, k == 0 && tap == 0 ? 0 : 1);
        }
      }
      cb::wgmma_commit();
      cb::wgmma_wait<1>();  // stage s - 1's products are done
      if (k > 0) cb::mbar_arrive(&empty_bar[(s - 1) % g.ring]);
    }
    cb::wgmma_wait<0>();
    cb::mbar_arrive(&empty_bar[(s - 1) % g.ring]);  // the item's last stage
#pragma unroll
    for (int i = 0; i < cb::kRowsPerWg; ++i) cb::reg_fence<kN16 / 2>(acc[i]);
    epi(acc, li, cb::item_at(g, blockIdx.z, first + li * stride), li == n_items - 1);
  }
}

// The launch of the bf16 form's convolution for these shapes: its geometry,
// grid and shared memory.  Blocks per plane (gridDim.x): the plane's tiles,
// at most kMaxBlocks, and no more than lets the card hold the whole grid at
// once (each block waits for its plane's others), else one, which waits
// for none; by shape and the card's capacity, never on a failure.
struct Bf16Launch {
  Geo16 g;
  dim3 grid;
};

inline cudaError_t bf16_launch(Bf16Launch& l, int64_t n, int64_t c, int64_t co, int64_t h,
                               int64_t w, int64_t d) {
  l.g = make_geo16((int)c, (int)h, (int)w, (int)d);
  if (l.g.ring < 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_in_act_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.g.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_in_act_bf16_kernel,
                                                           kBlock16, l.g.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t planes = n * ((co + kN16 - 1) / kN16);
  int64_t blocks = (int64_t)per_sm * sms / planes;
  if (blocks > l.g.tiles) blocks = l.g.tiles;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  l.grid = dim3((unsigned)blocks, (unsigned)((co + kN16 - 1) / kN16), (unsigned)n);
  return cudaSuccess;
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
  a.pw = (int)(w + 2 * d);
  const dim3 grid((unsigned)tiles, (unsigned)((co + kCo - 1) / kCo), (unsigned)n);
  conv3x3_kernel<<<grid, kBlock, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_act_kernel<<<(unsigned)(n * co), kNormThreads, 0, s>>>(
      static_cast<float*>(out), static_cast<float*>(out), static_cast<const float*>(residual),
      static_cast<const float*>(scratch), (int)tiles, hw, eps, act, hw % 4 == 0);
  return (int)cudaGetLastError();
}

// The bf16 form's blocks per (sample, co block) plane for these shapes on
// this card, or -cudaError.
int conv3x3_in_act_bf16_blocks(int64_t n, int64_t c, int64_t co, int64_t h, int64_t w,
                               int64_t d) {
  Bf16Launch l;
  const cudaError_t err = bf16_launch(l, n, c, co, h, w, d);
  return err == cudaSuccess ? (int)l.grid.x : -(int)err;
}

// Whether the bf16 form needs a float32 pre-norm plane (n, co, h, w) for
// these shapes: more tiles per plane than blocks (1 or 0), or -cudaError.
int conv3x3_in_act_bf16_prenorm(int64_t n, int64_t c, int64_t co, int64_t h, int64_t w,
                                int64_t d) {
  Bf16Launch l;
  const cudaError_t err = bf16_launch(l, n, c, co, h, w, d);
  return err == cudaSuccess ? (l.g.tiles > (int)l.grid.x ? 1 : 0) : -(int)err;
}

// The bf16 form: x (n, c, h+2d, w+2d) bf16, wt (co, c, 3, 3) float32
// (w_f32 != 0) or bf16, rounded to bf16; bias (co) float32, or bf16 (b_bf16
// != 0, widened exactly), or null; residual (n, co, h, w) bf16 or null; out
// (n, co, h, w) bf16; prenorm (n, co, h, w) float32 where
// conv3x3_in_act_bf16_prenorm, else null; for the layout pass xt (n, 2 nk,
// h+2d, w+2d, 8) and wl (ceil(co / 32), nk, 9, 2, 32, 8) bf16 (nk =
// ceil(c / 16)), 16-byte aligned; xchg: n ceil(co / 32) (16 x 32 x 3 + 1)
// floats for the statistics' exchange; all contiguous.  Two launches: the
// layout pass, then the convolution with its epilogue.
int conv3x3_in_act_bf16(const void* x, const void* wt, int w_f32, const void* bias, int b_bf16,
                        const void* residual, void* out, void* prenorm, void* xt, void* wl,
                        void* xchg, int64_t n, int64_t c, int64_t co, int64_t h, int64_t w,
                        int64_t d, float eps, int act, void* stream) {
  if (reinterpret_cast<uintptr_t>(xt) % 16 != 0 || reinterpret_cast<uintptr_t>(wl) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  Bf16Launch l;
  cudaError_t err = bf16_launch(l, n, c, co, h, w, d);
  if (err != cudaSuccess) return (int)err;
  if (l.g.tiles > (int)l.grid.x && prenorm == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = (int)(n * 2 * l.g.nk);
  const int counters = (int)(n * l.grid.y);
  const int hw = l.g.ph * l.g.pw;
  const int pairs = hw % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const dim3 lgrid((unsigned)((hw + 2 * kLayoutThreads - 1) / (2 * kLayoutThreads)),
                   (unsigned)(planes + l.grid.y * l.g.nk));
  float* xf = static_cast<float*>(xchg);
  unsigned* count = reinterpret_cast<unsigned*>(xf + (int64_t)counters * kMaxBlocks * kN16 * 3);
  in_act_layout_kernel<<<lgrid, kLayoutThreads, 0, s>>>(
      static_cast<const uint16_t*>(x), wt, w_f32, static_cast<uint4*>(xt),
      static_cast<uint4*>(wl), count, counters, (int)c, (int)co, planes, hw, l.g.nk, pairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Bf16Args a;
  a.wl = static_cast<const uint4*>(wl);
  a.bias = bias;
  a.residual = static_cast<const uint16_t*>(residual);
  a.out = static_cast<uint16_t*>(out);
  a.prenorm = static_cast<float*>(prenorm);
  a.xchg = xf;
  a.count = count;
  a.bias_bf16 = b_bf16;
  a.co = (int)co;
  a.act = act;
  a.vec = w % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(residual) % 16 == 0;
  a.eps = eps;
  a.g = l.g;
  // xt as (8, pw, ph, n 2 nk) with boxes of a stage's A operand
  CUtensorMap map;
  const cuuint64_t dims[4] = {8, (cuuint64_t)l.g.pw, (cuuint64_t)l.g.ph,
                              (cuuint64_t)(n * 2 * l.g.nk)};
  const cuuint64_t strides[3] = {16, (cuuint64_t)l.g.pw * 16, (cuuint64_t)hw * 16};
  const cuuint32_t box[4] = {8, (cuuint32_t)l.g.cols, (cuuint32_t)l.g.rows, 2};
  if ((err = cb::encode_bf16_map(&map, 4, xt, dims, strides, box)) != cudaSuccess) return (int)err;
  conv3x3_in_act_bf16_kernel<<<l.grid, kBlock16, l.g.smem, s>>>(a, map);
  return (int)cudaGetLastError();
}

}  // extern "C"
