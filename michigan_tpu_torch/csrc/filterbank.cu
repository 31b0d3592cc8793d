// Dense orientation by a bank of 32 oriented 17x17 filters, for Hopper
// (sm_90a), float32, or bf16-rounded operands.
//
// filterbank_orientation replaces michigan_tpu/ops/pallas/filterbank.py:
//   filterbank_orientation (its inner `kernel`), which computes exactly
//   michigan_tpu/ops/filters.py:orientation_response: the 'same'
//   zero-padded correlation of a (N, H, W) gray plane with each of the 32
//   filters, each response clamped at 0, then per pixel the first index of
//   the largest response (int32) and that response (float32).
//
// What bounds it: arithmetic.  Per pixel 32 x 289 = 9,248 FMAs against 4 B
// read and 8 B written.  As a product it is dense: M = pixels, N = 32
// orientations, K = 289 taps, with the bank as B and the gray plane as a
// Toeplitz A.  So it runs on the tensor cores, float32-accurate through the
// 3xTF32 split of tf32x3.cuh (three mma.sync m16n8k8 per product).
//
// What the design does:
// - K is padded to 296 = 37 steps of 8 and ordered so that every A
//   fragment is a fixed offset from one of two per-thread pointers: steps
//   0-33 take filter row dy = s / 2, columns 8 (s % 2) .. + 7; steps 34-36
//   take column 16 of rows 8 (s - 34) .. + 7, rows past 16 with zero bank
//   rows (they read 7 zero rows below the halo).  The inner loop has no
//   division and no bounds check;
// - the blocks are persistent (as many as fit on the SMs, two each), so the
//   bank is read from device memory and split into (big, small) TF32 pairs
//   once per block, straight into the mma B-fragment order: per step and
//   lane 16 words, loaded as four conflict-free 16-byte reads;
// - each block walks 32 x 8-pixel tiles (one row of 32 pixels, two m16
//   tiles, per warp); the tile's gray halo (48 x 24) is staged by cp.async
//   into one of two buffers while the block multiplies the other.  A gray
//   value feeds up to 289 products of its warp, so the staged halo is split
//   once into (big, small) planes.  (Splitting each A fragment in registers
//   instead, as the 3x3 tile does where a value feeds 9 taps, took 5-6%
//   longer: tools/filterbank_variants.py);
// - the tensor cores add with truncation, so each run of kChain = 4 steps
//   (96 mma per warp) sums into fresh registers that are added to the
//   running sums with rounded float32 adds.  Against a float64 bank conv the
//   largest response error is 0.4-0.5x cuDNN's in float32; one chain over
//   all of K erred 1.6-2.3x (tools/filterbank_variants.py);
// - in the accumulator layout a thread holds 8 of the 32 orientations of 4
//   pixels; the clamp, the max and the first-index argmax (strict '>' in
//   increasing orientation, the smaller index on equal values across the
//   quad; an all-zero pixel gets 0) are a quad-shuffle reduction.  Nothing
//   of the (N, 32, H, W) response reaches device memory.
//
// filterbank_orientation_bf16ops is the JAX package's forward under --dtype
//   bfloat16 without --orient_bank_fp32 (michigan_tpu/ops/filters.py:
//   207-225, fwd_bf16): gray and bank rounded to bf16 (to nearest even), the
//   products summed in float32, each response rounded to bf16 (the dtype of
//   XLA's bf16 conv) before the clamp and the argmax, so that responses
//   equal in bf16 tie to the first index there too.  A kernel of its own
//   (filterbank_bf16_kernel below).
//
// What bounds it: the bf16 products, 9,248 FMAs per pixel at the 989
// TFLOP/s of dense bf16 (0.039 ms at 8 x 512^2), against 12 B of HBM per
// pixel (0.008 ms).  What the design does about it:
// - the products are bf16 x bf16 -> f32 on the tensor cores, wgmma
//   m64n32k16 with A from registers (the Toeplitz A has no shared-memory
//   layout a descriptor could read) and the bank by descriptor: a
//   warpgroup's 4 warps each give 16 pixels of a row.  mma.sync m16n8k16
//   on the same registers took 0.152 against 0.121 ms at (8, 1, 512^2) on
//   an H100 (tools/filterbank_variants.py, "bf16 mma.sync").  M = pixels, N = the 32
//   orientations, K = taps in 20 steps of 16: steps 0-16 are filter row s,
//   taps 0-15 in order; steps 17-19 are tap column 16 as (16, 17) pairs of
//   rows 8 (s - 17) + j, tap 17 and rows past 16 with zero bank entries.
//   K = 320 for 289 taps;
// - the halo is staged once per tile as bf16 pair words: word c of a halo
//   row holds (bf16 g[c], bf16 g[c + 1]), so the two taps of an A register
//   are one aligned 32-bit load whatever the pixel's column.  In a row step
//   a thread's A registers of m16 tile i are the words at columns 16 i,
//   16 i + 8 (twice: pixel + 8 at a tap equals pixel at tap + 8) and
//   16 i + 16, so the 4 m16 tiles of a warp take 9 loads a step, not 16.
//   The row stride (88 words, 24 mod 32) keeps the column steps' loads, a
//   row per lane of a quad, conflict-free;
// - a block of 16 warps takes a 64 x 16-pixel tile (a row of 64 pixels per
//   warp, 64 float32 sums a thread): 81 x 32 halo values per 1,024 pixels
//   (2.5 a pixel; the 3xTF32 form's 32 x 8 tile reads 4.5; two blocks of 8
//   warps an SM took 2% longer at (8, 1, 512^2) and 17% at (1, 1, 512^2)).
//   The float32 halo of the next tile arrives by cp.async while the block
//   multiplies; the pair words are made from it in one pass per tile;
// - persistent blocks (one an SM) convert the bank to bf16 once, into the
//   canonical K-major layout of a wgmma B operand without swizzle
//   ([step][k half][n][8 k], 20 KB);
// - one float32 chain over all of K: the tensor cores add with truncation,
//   ~2^-23 of the running sum per add, below the bf16 ulp the response is
//   rounded to: against float64 its argmax is off on no more pixels than
//   the plain version's (cuDNN's float32 sums), and 4-step chains flushed
//   into rounded sums (mma.sync, "bf16 chain 4") spill and took 0.213 ms;
// - the clamp, the max and the first-index argmax are the 3xTF32 form's
//   quad-shuffle reduction; nothing of the (N, 32, H, W) response reaches
//   device memory.
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
// What bounds it: shared-memory reads, 289 bank gathers per pixel (one
// wavefront per warp each).  What the design does about it:
// - one block per 64 x 64-pixel tile copies the bank (37 KB) into shared
//   memory by cp.async, once per 4,096 pixels, and stages dconf * [conf > 0]
//   and idx of the tile with its 8-pixel halo as (gradient, orientation)
//   pairs, so one 8-byte load brings both.  The blocks are not persistent:
//   the card's block scheduler then balances tiles with and without
//   gradient (a persistent grid, two tiles a block, took 0.116 ms on the
//   step's hair-masked dconf against 0.086: tools/filterbank_variants.py);
// - a warp takes 32 columns x 16 rows, one column per thread: per column
//   offset it loads the 32 pairs its window needs once and reuses each for
//   up to 16 pixels;
// - where no gradient arrives there is no work: while staging, the block
//   marks each (halo row, 16-column chunk) that holds a nonzero gradient; a
//   warp whose window holds none writes zeros and gathers nothing.  This is
//   exact, the skipped terms are zero.  The training loss multiplies by the
//   hair mask, so most of a step's planes are skipped;
// - the bank read bank[tap][idx[q]] has the same tap across a warp and at
//   most 32 distinct orientations, one per shared-memory bank: no
//   conflicts.
//
// The launchers return the first CUDA error.  Nothing here allocates or
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_bf16.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kNum = 32;        // orientations
constexpr int kK = 17;          // filter size
constexpr int kR = kK / 2;      // 'same' zero padding
constexpr int kTaps = kK * kK;  // 289

// ---- forward ----
constexpr int kThreads = 256;               // 8 warps, one tile row each
constexpr int kTileW = 32;                  // two m16 tiles per warp
constexpr int kTileH = kThreads / 32;       // 8
constexpr int kSteps = 37;                  // K = 296 in steps of 8
constexpr int kRowSteps = 2 * kK;           // steps 0-33: filter row s / 2
constexpr int kChain = 4;                   // steps per fresh tensor-core chain
constexpr int kInW = kTileW + 2 * kR;       // 48 halo columns
constexpr int kStageH = kTileH + 2 * kR;    // 24 halo rows
constexpr int kInH = kStageH + 7;           // and 7 zero rows for the pad taps
constexpr int kRS = 56;                     // row stride, 24 mod 32: conflict-free A loads
constexpr int kPlane = kInH * kRS;          // floats per halo plane
constexpr int kHalo = 2 * kPlane;           // a buffer: the big plane, then the small
constexpr int kBankWords = kSteps * 4 * 32 * 4;  // per step: 4 x 16 bytes per lane
constexpr size_t kSmem = sizeof(float) * (kBankWords + 2 * kHalo);

// The tap of the filter at K index 8 s + t, or -1 for a pad row.
__device__ __forceinline__ int tap_of(int s, int t) {
  if (s < kRowSteps) return (s >> 1) * kK + 8 * (s & 1) + t;
  const int dy = 8 * (s - kRowSteps) + t;
  return dy < kK ? dy * kK + kK - 1 : -1;
}

// v rounded to bf16 (to nearest even), as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Tile {
  int64_t plane;  // offset of the sample's plane
  int y0, x0;     // output origin
};

__device__ __forceinline__ Tile tile_at(int64_t t, int tiles_x, int per_plane, int h, int w,
                                        int tile_w, int tile_h) {
  const int64_t b = t / per_plane;
  const int rem = (int)(t - b * per_plane);
  const int ty = rem / tiles_x;
  return {b * h * w, ty * tile_h, (rem - ty * tiles_x) * tile_w};
}

__global__ void __launch_bounds__(kThreads, 2)
filterbank_kernel(const float* __restrict__ gray, const float* __restrict__ bank,
                  int32_t* __restrict__ idx, float* __restrict__ conf, int n, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  unsigned* s_b = reinterpret_cast<unsigned*>(smem);  // [step][4][lane][4]
  float* s_halo = smem + kBankWords;                   // two buffers of two [kInH][kRS] planes

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // mma groupID
  const int tig = lane & 3;   // mma threadID_in_group
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int per_plane = tiles_x * ((h + kTileH - 1) / kTileH);
  const int64_t ntiles = (int64_t)n * per_plane;

  auto stage = [&](int64_t t, float* buf) {
    const Tile tl = tile_at(t, tiles_x, per_plane, h, w, kTileW, kTileH);
    for (int i = tid; i < kStageH * kInW; i += kThreads) {
      const int r = i / kInW, c = i - r * kInW;
      const int y = tl.y0 - kR + r, x = tl.x0 - kR + c;
      const bool ok = y >= 0 && y < h && x >= 0 && x < w;
      cp_async4(buf + r * kRS + c, ok ? gray + tl.plane + (int64_t)y * w + x : gray, ok);
    }
  };

  int64_t t = blockIdx.x;
  if (t < ntiles) stage(t, s_halo);
  cp_async_commit();

  // the bank in B-fragment order: word (s, q, lane, e) is the big (q < 2)
  // or small part of B[k][n] with k = 8 s + tig + 4 (e & 1) and orientation
  // n = 8 (2 (q & 1) + (e >> 1)) + gid
  for (int e = tid; e < kBankWords; e += kThreads) {
    const int s = e >> 9, q = (e >> 7) & 3, l = (e >> 2) & 31, el = e & 3;
    const int tap = tap_of(s, (l & 3) + 4 * (el & 1));
    const int o = 8 * (2 * (q & 1) + (el >> 1)) + (l >> 2);
    const float b = tap < 0 ? 0.f : bank[tap * kNum + o];
    const uint2 p = split_tf32(b);
    s_b[e] = q < 2 ? p.x : p.y;
  }
  for (int i = tid; i < 2 * (kInH - kStageH) * kRS; i += kThreads) {
    const int buf = i / ((kInH - kStageH) * kRS);
    s_halo[buf * kHalo + kStageH * kRS + i % ((kInH - kStageH) * kRS)] = 0.f;
  }

  const uint4* b_frag = reinterpret_cast<const uint4*>(s_b) + lane;
  const int a_row = warp * kRS + gid + tig;                 // steps 0-33
  const int a_col = warp * kRS + gid + tig * kRS + kK - 1;  // steps 34-36

  for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
    float* cur = s_halo + (it & 1) * kHalo;
    if (t + gridDim.x < ntiles) stage(t + gridDim.x, s_halo + ((it + 1) & 1) * kHalo);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // split the staged halo once: big in place, small into the second plane
    for (int i = tid; i < kPlane; i += kThreads) {
      const uint2 p = split_tf32(cur[i]);
      cur[i] = __uint_as_float(p.x);
      cur[kPlane + i] = __uint_as_float(p.y);
    }
    __syncthreads();

    float acc[2][4][4], part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll 4  // fully unrolled, the 37 steps spill 20 B and run 2% slower
    for (int s = 0; s < kSteps; ++s) {
      // A: rows gid, gid + 8 of m tile i; K columns tig, tig + 4 (tap
      // columns in a row step, tap rows in a column step)
      const float* a = cur + (s < kRowSteps ? a_row + (s >> 1) * kRS + 8 * (s & 1)
                                            : a_col + 8 * (s - kRowSteps) * kRS);
      const int k4 = s < kRowSteps ? 4 : 4 * kRS;
      unsigned a_big[2][4], a_small[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off[4] = {16 * i, 16 * i + 8, 16 * i + k4, 16 * i + k4 + 8};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a_big[i][r] = __float_as_uint(a[off[r]]);
          a_small[i][r] = __float_as_uint(a[kPlane + off[r]]);
        }
      }
      const uint4 q0 = b_frag[(4 * s + 0) * 32], q1 = b_frag[(4 * s + 1) * 32];
      const uint4 q2 = b_frag[(4 * s + 2) * 32], q3 = b_frag[(4 * s + 3) * 32];
      const unsigned b_big[4][2] = {{q0.x, q0.y}, {q0.z, q0.w}, {q1.x, q1.y}, {q1.z, q1.w}};
      const unsigned b_small[4][2] = {{q2.x, q2.y}, {q2.z, q2.w}, {q3.x, q3.y}, {q3.z, q3.w}};
      // the three passes in turn over the 8 tiles, so that no mma waits on
      // the one before it
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (s % kChain == 0) {
            mma_tf32_first(part[i][j], a_small[i], b_big[j]);
          } else {
            mma_tf32(part[i][j], a_small[i], b_big[j]);
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], a_big[i], b_big[j]);
      if (s % kChain == kChain - 1 || s == kSteps - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
      }
    }

    // acc[i][j][2 hf + c]: pixel 16 i + 8 hf + gid of the warp's row,
    // orientation 8 j + 2 tig + c.  Per pixel the first index of the largest
    // clamped response, in this thread's 8 orientations, then across the quad
    float best[4];
    int best_k[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = m >> 1, hf = m & 1;
      best[m] = fmaxf(acc[i][0][2 * hf], 0.f);
      best_k[m] = 2 * tig;
#pragma unroll
      for (int o = 1; o < 8; ++o) {
        const float v = fmaxf(acc[i][o >> 1][2 * hf + (o & 1)], 0.f);
        if (v > best[m]) {
          best[m] = v;
          best_k[m] = 8 * (o >> 1) + 2 * tig + (o & 1);
        }
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[m], d);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k[m], d);
        if (ov > best[m] || (ov == best[m] && ok < best_k[m])) {
          best[m] = ov;
          best_k[m] = ok;
        }
      }
    }
    // lane (gid, tig) stores pixel 8 tig + gid: m = tig
    const float v = tig == 0 ? best[0] : tig == 1 ? best[1] : tig == 2 ? best[2] : best[3];
    const int k = tig == 0 ? best_k[0] : tig == 1 ? best_k[1] : tig == 2 ? best_k[2] : best_k[3];
    const Tile tl = tile_at(t, tiles_x, per_plane, h, w, kTileW, kTileH);
    const int y = tl.y0 + warp, x = tl.x0 + 8 * tig + gid;
    if (y < h && x < w) {
      const int64_t o = tl.plane + (int64_t)y * w + x;
      idx[o] = k;
      conf[o] = v;
    }
    __syncthreads();  // every warp is done with `cur` before it is staged again
  }
  cp_async_wait<0>();
}

// ---- forward on bf16 operands ----
namespace bf16ops {

constexpr int kWarps = 16;                    // one output row each
constexpr int kThreads = 32 * kWarps;
constexpr int kTileW = 64;                    // pixels per warp row
constexpr int kMT = kTileW / 16;              // m16 tiles per warp
constexpr int kTileH = kWarps;
constexpr int kRowSteps = kK;                 // steps 0-16: filter row s, taps 0-15
constexpr int kSteps = kRowSteps + 3;         // 17-19: tap column 16; K = 320
constexpr int kInW = kTileW + kK;             // 81 halo columns: x0 - 8 .. x0 + 72
constexpr int kWords = kTileW + 2 * kR;       // 80 pair words a halo row
constexpr int kStageH = kTileH + 2 * kR;      // 32 halo rows
constexpr int kPairH = kStageH + 7;           // and 7 zero rows for the pad pairs
// the column steps' A loads reach row (warp) + (tig) + 8 (s - 17) + 4
static_assert(kPairH > (kWarps - 1) + 3 + 8 * (kSteps - kRowSteps - 1) + 4,
              "the pair words cover the column steps' rows");
constexpr int kPS = 88;                       // pair-word row stride, 24 mod 32
constexpr int kFS = 84;                       // float staging row stride
constexpr int kStepBytes = 2 * kNum * 16;     // a step's bank: [k half][n][8 k] bf16
constexpr int kBankBytes = kSteps * kStepBytes;
constexpr size_t kSmem = kBankBytes + sizeof(unsigned) * kPairH * kPS +
                         sizeof(float) * kStageH * kFS;

// The bank entry at K index k of step s (row steps: tap (s, k); column
// steps: pair j = (k % 8) / 2 + 4 (k / 8) of tap column 16 at row
// 8 (s - 17) + j, its second tap zero), or -1 for a zero entry.
__device__ __forceinline__ int tap16_of(int s, int k) {
  if (s < kRowSteps) return s * kK + k;
  const int dy = 8 * (s - kRowSteps) + (k & 7) / 2 + 4 * (k >> 3);
  return (k & 1) == 0 && dy < kK ? dy * kK + kK - 1 : -1;
}

// d += A * B on m64n32k16, bf16 operands, f32 sums: A from registers (each
// warp of the warpgroup gives 16 rows in the m16n8k16 A-fragment layout), B
// by the shared-memory descriptor db
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, "
      "p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The products of one K step: the warp's kMT m16 tiles x the 32
// orientations.  Per m16 tile i, one m64n32k16 wgmma of the warpgroup: its 4
// warps each give the 16 pixels of their tile i.  acc[i][4 j + r] is then
// the m16n8 accumulator r of orientations 8 j .. 8 j + 7; b the step's
// bank slice, [k half][n][8 k].
__device__ __forceinline__ void step_products(float (&acc)[kMT][16], const unsigned (&a)[kMT][4],
                                              const char* b) {
  namespace cb = conv_bf16;
  const uint64_t db = cb::make_desc(cb::smem_u32(b), kStepBytes / 2, 128);
  cb::wgmma_fence();
#pragma unroll
  for (int i = 0; i < kMT; ++i) wgmma_rs(acc[i], a[i], db);
  cb::wgmma_commit();
  cb::wgmma_wait<0>();  // a's registers are free, acc is readable
#pragma unroll
  for (int i = 0; i < kMT; ++i) cb::reg_fence<16>(acc[i]);
}

__global__ void __launch_bounds__(kThreads, 1)
filterbank_bf16_kernel(const float* __restrict__ gray, const float* __restrict__ bank,
                       int32_t* __restrict__ idx, float* __restrict__ conf, int n, int h,
                       int w) {
  extern __shared__ __align__(128) char smem16[];
  char* s_b = smem16;                                                   // kSteps x kStepBytes
  unsigned* s_pair = reinterpret_cast<unsigned*>(smem16 + kBankBytes);  // [kPairH][kPS]
  float* s_stage = reinterpret_cast<float*>(s_pair + kPairH * kPS);     // [kStageH][kFS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // mma groupID
  const int tig = lane & 3;   // mma threadID_in_group
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int per_plane = tiles_x * ((h + kTileH - 1) / kTileH);
  const int64_t ntiles = (int64_t)n * per_plane;

  auto stage = [&](int64_t t) {  // the float32 halo of tile t, zero outside the image
    const Tile tl = tile_at(t, tiles_x, per_plane, h, w, kTileW, kTileH);
    for (int i = tid; i < kStageH * kInW; i += kThreads) {
      const int r = i / kInW, c = i - r * kInW;
      const int y = tl.y0 - kR + r, x = tl.x0 - kR + c;
      const bool ok = y >= 0 && y < h && x >= 0 && x < w;
      cp_async4(s_stage + r * kFS + c, ok ? gray + tl.plane + (int64_t)y * w + x : gray, ok);
    }
  };

  int64_t t = blockIdx.x;
  if (t < ntiles) stage(t);
  cp_async_commit();

  // the bank in bf16, [step][k half][n][8 k]: the canonical K-major layout
  // of a wgmma B operand without swizzle
  __nv_bfloat16* s_bh = reinterpret_cast<__nv_bfloat16*>(s_b);
  for (int e = tid; e < kBankBytes / 2; e += kThreads) {
    const int s = e / (kStepBytes / 2), r = e % (kStepBytes / 2);
    const int k = 8 * (r / (8 * kNum)) + (r & 7), o = (r / 8) % kNum;
    const int tap = tap16_of(s, k);
    s_bh[e] = __float2bfloat16_rn(tap < 0 ? 0.f : bank[tap * kNum + o]);
  }
  for (int i = tid; i < (kPairH - kStageH) * kPS; i += kThreads) s_pair[kStageH * kPS + i] = 0u;

  // a thread's A words: row steps at a_row + s kPS + 16 i + {0, 8, 16};
  // column steps at a_col + (8 (s - 17) + {0, 4}) kPS + 16 i + {0, 8}
  const unsigned* a_row = s_pair + warp * kPS + gid + 2 * tig;
  const unsigned* a_col = s_pair + (warp + tig) * kPS + gid + kK - 1;

  for (; t < ntiles; t += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // tile t's halo has arrived; every warp is done with the pair words
    // the pair words: (bf16 g[c], bf16 g[c + 1]), the lower column in the low half
    for (int i = tid; i < kStageH * kWords; i += kThreads) {
      const int r = i / kWords, c = i - r * kWords;
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(s_stage[r * kFS + c], s_stage[r * kFS + c + 1]);
      s_pair[r * kPS + c] = *reinterpret_cast<const unsigned*>(&p);
    }
    __syncthreads();
    if (t + gridDim.x < ntiles) stage(t + gridDim.x);
    cp_async_commit();

    float acc[kMT][16];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[i][r] = 0.f;

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      // A of m16 tile i: rows (pixels) gid, gid + 8; K pairs 2 tig, 2 tig + 8
      unsigned a[kMT][4];
      if (s < kRowSteps) {  // pixel + 8 at tap k equals pixel at tap k + 8
        unsigned wd[2 * kMT + 1];
#pragma unroll
        for (int u = 0; u <= 2 * kMT; ++u) wd[u] = a_row[s * kPS + 8 * u];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          a[i][0] = wd[2 * i];
          a[i][1] = a[i][2] = wd[2 * i + 1];
          a[i][3] = wd[2 * i + 2];
        }
      } else {
        const unsigned* p = a_col + 8 * (s - kRowSteps) * kPS;
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          a[i][0] = p[16 * i];
          a[i][1] = p[16 * i + 8];
          a[i][2] = p[4 * kPS + 16 * i];
          a[i][3] = p[4 * kPS + 16 * i + 8];
        }
      }
      step_products(acc, a, s_b + s * kStepBytes);
    }

    // acc[i][4 j + 2 hf + c]: pixel 16 i + 8 hf + gid of the warp's row,
    // orientation 8 j + 2 tig + c.  Each response rounded to bf16, as XLA's
    // bf16 conv returns it, then per pixel the first index of the largest
    // clamped response, in this thread's 8 orientations, then across the quad
    float best[2 * kMT];
    int best_k[2 * kMT];
#pragma unroll
    for (int m = 0; m < 2 * kMT; ++m) {
      const int i = m >> 1, hf = m & 1;
      best[m] = fmaxf(round_bf16(acc[i][2 * hf]), 0.f);
      best_k[m] = 2 * tig;
#pragma unroll
      for (int o = 1; o < 8; ++o) {
        const float v = fmaxf(round_bf16(acc[i][4 * (o >> 1) + 2 * hf + (o & 1)]), 0.f);
        if (v > best[m]) {
          best[m] = v;
          best_k[m] = 8 * (o >> 1) + 2 * tig + (o & 1);
        }
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[m], d);
        const int ok = __shfl_xor_sync(0xffffffffu, best_k[m], d);
        if (ov > best[m] || (ov == best[m] && ok < best_k[m])) {
          best[m] = ov;
          best_k[m] = ok;
        }
      }
    }
    // lane (gid, tig) stores slots m = 4 q + tig: pixels 32 q + 8 tig + gid
    const Tile tl = tile_at(t, tiles_x, per_plane, h, w, kTileW, kTileH);
    const int y = tl.y0 + warp;
#pragma unroll
    for (int q = 0; q < kMT / 2; ++q) {
      float v = best[4 * q];
      int k = best_k[4 * q];
#pragma unroll
      for (int u = 1; u < 4; ++u) {
        if (tig == u) {
          v = best[4 * q + u];
          k = best_k[4 * q + u];
        }
      }
      const int x = tl.x0 + 32 * q + 8 * tig + gid;
      if (y < h && x < w) {
        const int64_t o = tl.plane + (int64_t)y * w + x;
        idx[o] = k;
        conf[o] = v;
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace bf16ops

// ---- backward ----
constexpr int kBRows = 16;                          // pixels (rows) per thread
constexpr int kBWarpsX = 2;                         // warps across a tile, 32 columns each
constexpr int kBTileW = 32 * kBWarpsX;              // 64
constexpr int kBTileH = kThreads / kBTileW * kBRows;  // 4 warps down: 64
constexpr int kBInW = kBTileW + 2 * kR;             // 80
constexpr int kBInH = kBTileH + 2 * kR;             // 80
constexpr int kChunkW = 16;                         // columns per gradient flag
constexpr int kChunks = kBInW / kChunkW;            // 5
constexpr int kWin = kBRows + kK - 1;               // 32 halo rows feed a thread's pixels
constexpr int kFlags = kChunks * kBInH;
constexpr int kBPer = kBInH * kBInW / kThreads;     // 25 halo elements per thread
static_assert(kBInH * kBInW % kThreads == 0, "the halo divides among the threads");
constexpr size_t kBSmem = sizeof(float) * kTaps * kNum + sizeof(float2) * kBInH * kBInW +
                          sizeof(int) * kFlags;

// One block per tile.  s_gk holds (dconf * [conf > 0], idx as int bits) of
// the tile with its halo, zero outside the image; halo coordinates are
// (y - y0 + kR, x - x0 + kR).  s_flags[c][r] is 1 where halo row r, columns
// 16 c .. 16 c + 15, hold a nonzero gradient.
__global__ void __launch_bounds__(kThreads, 2)
filterbank_backward_kernel(const float* __restrict__ dconf, const int32_t* __restrict__ idx,
                           const float* __restrict__ conf, const float* __restrict__ bank,
                           float* __restrict__ dgray, int h, int w) {
  extern __shared__ __align__(16) float smem[];
  float* s_bank = smem;                                            // [tap][orientation]
  float2* s_gk = reinterpret_cast<float2*>(s_bank + kTaps * kNum);  // [kBInH][kBInW]
  int* s_flags = reinterpret_cast<int*>(s_gk + kBInH * kBInW);     // [kChunks][kBInH]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = (warp % kBWarpsX) * 32 + lane;  // this thread's column in the tile
  const int ty = (warp / kBWarpsX) * kBRows;     // its first row
  const int tiles_x = (w + kBTileW - 1) / kBTileW;
  const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_x * ((h + kBTileH - 1) / kBTileH), h, w,
                          kBTileW, kBTileH);

  for (int i = tid; i < kTaps * kNum / 4; i += kThreads) cp_async16(s_bank + 4 * i, bank + 4 * i, true);
  cp_async_commit();
  for (int i = tid; i < kFlags; i += kThreads) s_flags[i] = 0;
  // the halo of the three planes, every load of a thread in flight at once
  float cf[kBPer], dc[kBPer];
  int id[kBPer];
#pragma unroll
  for (int u = 0; u < kBPer; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / kBInW, c = i - r * kBInW;
    const int y = tl.y0 - kR + r, x = tl.x0 - kR + c;
    const bool ok = y >= 0 && y < h && x >= 0 && x < w;
    const int64_t o = ok ? tl.plane + (int64_t)y * w + x : 0;
    cf[u] = ok ? conf[o] : 0.f;
    dc[u] = ok ? dconf[o] : 0.f;
    id[u] = ok ? idx[o] : 0;
  }
  __syncthreads();  // the flags are clear
#pragma unroll
  for (int u = 0; u < kBPer; ++u) {
    const int i = tid + u * kThreads;
    const float g = cf[u] > 0.f ? dc[u] : 0.f;
    s_gk[i] = make_float2(g, __int_as_float(id[u] & (kNum - 1)));
    if (g != 0.f) s_flags[(i % kBInW) / kChunkW * kBInH + i / kBInW] = 1;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warp's window: halo rows ty .. ty + kWin - 1, chunks 2 wx .. 2 wx + 2
  const int* f = s_flags + (tx - lane) / kChunkW * kBInH + ty + lane;
  const bool live = __any_sync(0xffffffffu, lane < kWin && (f[0] | f[kBInH] | f[2 * kBInH]));
  float acc[kBRows];
#pragma unroll
  for (int p = 0; p < kBRows; ++p) acc[p] = 0.f;
  if (live) {
    // pixel (ty + p, tx) reads q at halo (ty + p + 2kR - oy, tx + 2kR - ox)
    // with tap (oy, ox) = p - q + kR
#pragma unroll 1
    for (int ox = 0; ox < kK; ++ox) {
      const float2* col = s_gk + ty * kBInW + tx + 2 * kR - ox;
      float g[kWin];
      int tap[kWin];  // s_bank index of q's orientation at tap (0, ox)
#pragma unroll
      for (int j = 0; j < kWin; ++j) {
        const float2 gk = col[j * kBInW];
        g[j] = gk.x;
        tap[j] = ox * kNum + __float_as_int(gk.y);
      }
#pragma unroll
      for (int oy = 0; oy < kK; ++oy)
#pragma unroll
        for (int p = 0; p < kBRows; ++p) {
          const int j = p + 2 * kR - oy;
          acc[p] = fmaf(g[j], s_bank[tap[j] + oy * kK * kNum], acc[p]);
        }
    }
  }
  const int x = tl.x0 + tx;
#pragma unroll
  for (int p = 0; p < kBRows; ++p) {
    const int y = tl.y0 + ty + p;
    if (y < h && x < w) dgray[tl.plane + (int64_t)y * w + x] = acc[p];
  }
}

// A persistent grid for `kernel`: as many blocks as fit on the card at
// once, at most `tiles`.  0 blocks and an error code where the card refuses.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int64_t tiles,
                            int* blocks) {
  *blocks = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t most = (int64_t)per_sm * sms;
  *blocks = (int)(tiles < most ? tiles : most);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// gray (n, h, w) f32; bank (289, 32) f32 in [tap][orientation] order, 16-byte
// aligned; idx (n, h, w) int32 and conf (n, h, w) f32 out.
int filterbank_orientation_f32(const void* gray, const void* bank, void* idx, void* conf,
                               int64_t n, int64_t h, int64_t w, void* stream) {
  const int64_t tiles = n * ((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  int blocks;
  const cudaError_t e = persistent_grid(filterbank_kernel, kThreads, kSmem, tiles, &blocks);
  if (e != cudaSuccess) return (int)e;
  filterbank_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), static_cast<const float*>(bank),
      static_cast<int32_t*>(idx), static_cast<float*>(conf), (int)n, (int)h, (int)w);
  return (int)cudaGetLastError();
}

// The bf16-operand form, on the same float32 arguments: gray and bank are
// rounded to bf16 in the kernel, conf holds bf16 values.
int filterbank_orientation_bf16ops(const void* gray, const void* bank, void* idx, void* conf,
                                   int64_t n, int64_t h, int64_t w, void* stream) {
  namespace b16 = bf16ops;
  const int64_t tiles =
      n * ((w + b16::kTileW - 1) / b16::kTileW) * ((h + b16::kTileH - 1) / b16::kTileH);
  int blocks;
  const cudaError_t e =
      persistent_grid(b16::filterbank_bf16_kernel, b16::kThreads, b16::kSmem, tiles, &blocks);
  if (e != cudaSuccess) return (int)e;
  b16::filterbank_bf16_kernel<<<blocks, b16::kThreads, b16::kSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), static_cast<const float*>(bank),
      static_cast<int32_t*>(idx), static_cast<float*>(conf), (int)n, (int)h, (int)w);
  return (int)cudaGetLastError();
}

// dconf (n, h, w) f32, idx (n, h, w) int32 and conf (n, h, w) f32 as the
// forward wrote them; bank as above; dgray (n, h, w) f32 out.
int filterbank_orientation_backward_f32(const void* dconf, const void* idx, const void* conf,
                                        const void* bank, void* dgray, int64_t n, int64_t h,
                                        int64_t w, void* stream) {
  const int64_t tiles = n * ((w + kBTileW - 1) / kBTileW) * ((h + kBTileH - 1) / kBTileH);
  const cudaError_t e = cudaFuncSetAttribute(
      filterbank_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBSmem);
  if (e != cudaSuccess) return (int)e;
  filterbank_backward_kernel<<<(unsigned)tiles, kThreads, kBSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dconf), static_cast<const int32_t*>(idx),
      static_cast<const float*>(conf), static_cast<const float*>(bank),
      static_cast<float*>(dgray), (int)h, (int)w);
  return (int)cudaGetLastError();
}

}  // extern "C"
