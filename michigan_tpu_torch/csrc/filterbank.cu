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
// The bf16-operand form (filterbank_orientation_bf16ops) is the JAX
//   package's forward under --dtype bfloat16 without --orient_bank_fp32
//   (michigan_tpu/ops/filters.py:207-225, fwd_bf16): gray and bank rounded
//   to bf16, the products summed in float32, each response rounded to bf16
//   (the dtype of XLA's bf16 conv) before the clamp and the argmax, so that
//   responses equal in bf16 tie to the first index there too.  It is the
//   same kernel with one template flag: the staged halo and the bank are
//   rounded to bf16 (to nearest even) before the split, so every small half
//   is zero and one TF32 mma (big x big) per step replaces three.  A bf16
//   value is exact in TF32 and the product of two is exact in float32, so
//   the one product is exact.  Its bound: 9,248 FMAs per pixel at the 495
//   TFLOP/s of TF32, a third of the 3xTF32 form's.
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

// kBf16Ops: the bf16-operand form (above).
template <bool kBf16Ops>
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
    const uint2 p = split_tf32(kBf16Ops ? round_bf16(b) : b);
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
    if (kBf16Ops) {  // the same thread splits element i below: no barrier
      for (int i = tid; i < kPlane; i += kThreads) cur[i] = round_bf16(cur[i]);
    }
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
      if constexpr (kBf16Ops) {  // the small halves are zero: big x big only
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (s % kChain == 0) {
              mma_tf32_first(part[i][j], a_big[i], b_big[j]);
            } else {
              mma_tf32(part[i][j], a_big[i], b_big[j]);
            }
          }
      } else {
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
      }
      if (s % kChain == kChain - 1 || s == kSteps - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
      }
    }

    if (kBf16Ops) {  // the responses in bf16, as XLA's bf16 conv returns them
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = round_bf16(acc[i][j][r]);
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

// The forward's persistent grid: as many blocks as fit on the card at once,
// at most `tiles`.  0 blocks and an error code where the card refuses.
template <bool kBf16Ops>
cudaError_t persistent_grid(int64_t tiles, int* blocks) {
  *blocks = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(filterbank_kernel<kBf16Ops>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, filterbank_kernel<kBf16Ops>,
                                                      kThreads, kSmem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t most = (int64_t)per_sm * sms;
  *blocks = (int)(tiles < most ? tiles : most);
  return cudaSuccess;
}

template <bool kBf16Ops>
int launch_forward(const void* gray, const void* bank, void* idx, void* conf, int64_t n,
                   int64_t h, int64_t w, void* stream) {
  const int64_t tiles = n * ((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  int blocks;
  cudaError_t e = persistent_grid<kBf16Ops>(tiles, &blocks);
  if (e != cudaSuccess) return (int)e;
  filterbank_kernel<kBf16Ops><<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gray), static_cast<const float*>(bank),
      static_cast<int32_t*>(idx), static_cast<float*>(conf), (int)n, (int)h, (int)w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gray (n, h, w) f32; bank (289, 32) f32 in [tap][orientation] order, 16-byte
// aligned; idx (n, h, w) int32 and conf (n, h, w) f32 out.
int filterbank_orientation_f32(const void* gray, const void* bank, void* idx, void* conf,
                               int64_t n, int64_t h, int64_t w, void* stream) {
  return launch_forward<false>(gray, bank, idx, conf, n, h, w, stream);
}

// The bf16-operand form, on the same float32 arguments: gray and bank are
// rounded to bf16 in the kernel, conf holds bf16 values.
int filterbank_orientation_bf16ops(const void* gray, const void* bank, void* idx, void* conf,
                                   int64_t n, int64_t h, int64_t w, void* stream) {
  return launch_forward<true>(gray, bank, idx, conf, n, h, w, stream);
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
