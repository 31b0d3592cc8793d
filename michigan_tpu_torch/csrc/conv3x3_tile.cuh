// The implicit-GEMM 3x3 convolution tile shared by conv_in_act.cu and
// conv_lowch.cu, for Hopper's tensor cores (sm_90a): float32 NCHW input,
// OIHW weights, float32-accurate products through the 3xTF32 split.
//
// GEMM view of one block: M = a patch of kRows x kCols = 4 x 32 = 128 output
// pixels of one sample's plane, N = kCo = 64 output channels, K = (tap,
// input channel), walked as steps of kChunk = 8 input channels for each of
// the 9 taps.  A group of 8 warps covers the block's output, each warp a
// 32-pixel x 32-channel warp tile (one patch row, half the channels): 2 x 4
// mma.sync.m16n8k8 tiles per tap and step.  With kGroups = 2 a second group
// of 8 warps takes every other 8 channels of each stage, and its sums are
// added to the first group's at the end: twice the warps on an SM where the
// grid gives one block per SM.
//
// 3xTF32.  TF32 keeps 10 mantissa bits; one pass would keep about three
// digits.  Each operand x is split in registers as it leaves shared memory,
// big = tf32(x) (round to nearest, ties away, as cvt.rna, in integer form:
// with cvt.rna the kernels take 9-11% longer), small = x - big, read as TF32
// by the tensor cores, and each product is accumulated as small*big +
// big*small + big*big in float32: the dropped small*small term is ~2^-22 of
// the product, the error of a float32 FMA. The tensor cores add with
// truncation, not rounding: summed in one chain over all of K the error
// against float64 comes out 7x F.conv2d's in float32 at VGG's (64 -> 64,
// 512^2) shape (tools/tile_variants.py).  So each 8-channel step (9 taps x 3
// products) sums into fresh registers that are then added to the running sums
// with ordinary rounded float32 adds.  Three tensor-core passes at the card's
// 495 TFLOP/s TF32 rate give 165 TFLOP/s of float32-accurate product, against
// 67 TFLOP/s for float32 FMAs outside the tensor cores; mma.sync (not wgmma)
// reaches ~320 TFLOP/s TF32 on the H100 (tools/tile_variants.py), so ~107
// float32-accurate.  The split, the mma and the cp.async helpers are in
// tf32x3.cuh, shared with filterbank.cu.
//
// Staging.  For each stage of 8 * kGroups input channels, the patch's input
// halo ((kRows + 2d) x (kCols + 2d) per channel) and the stage's weights (64
// channels x 8 * kGroups x 9) go by cp.async into a ring of kStages stages in
// dynamic shared memory, so the next stages are in flight while one is
// multiplied.  The halo goes in 16- or 8-byte copies where every row of the
// plane starts on such a boundary (its origin rounded down to 4 or 2 floats),
// else 4-byte, zero-filled outside the plane; the weights in 16-byte copies
// where C % 4 == 0, else 4-byte.  (With 4-byte halo copies conv3x3_in_act
// takes 30% longer at dilation 2, tools/tile_variants.py.)  Each input element
// leaves device memory once per block, not once per tap; a tap is a fixed
// (dy*d, dx*d) offset into the halo, so the inner loop has no division and no
// bounds check.  The halo's channel stride is 8 mod 32 words and a weight row
// 76 (148) words, which keeps the A- and B-fragment loads free of bank
// conflicts. (A draft that split each stage once into a buffer of (big, small)
// pairs, instead of in the inner loop, ran slower: it doubles the shared-
// memory reads and adds a barrier per stage.)
//
// Where the halo comes from is a Plane: the caller's reflect-padded plane
// (conv_in_act.cu: origin at the patch, no padding) or an unpadded plane
// with SAME zero padding by 1 (conv_lowch.cu: origin one pixel up and left;
// the zero-fill of cp.async is the padding).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace conv3x3 {

using namespace tf32x3;

constexpr int kRows = 4;                        // output rows per block (patch)
constexpr int kCols = 32;                       // output columns per block
constexpr int kCo = 64;                         // output channels per block
constexpr int kChunk = 8;                       // input channels per K step
constexpr int kWarpsN = 2;                      // warps across the 64 channels
constexpr int kThreads = 32 * kRows * kWarpsN;  // 256 per group: a row per warp pair
constexpr int kMT = 2;                          // m16 tiles per warp (32 pixels)
constexpr int kNT = 4;                          // n8 tiles per warp (32 channels)

// One sample's input plane, (C, ph, pw); the halo of the patch at output
// (y0, x0) starts at plane row y0 - pad, column x0 - pad; reads outside the
// plane give 0.
struct Plane {
  const float* x;
  int ph, pw, pad;
};

// Floats per halo copy: 4 or 2 where every row of the plane starts on a
// 16- or 8-byte boundary, else 1.
inline int halo_vec(const void* x, int64_t pw) {
  for (int v = 4; v > 1; v /= 2)
    if (pw % v == 0 && reinterpret_cast<uintptr_t>(x) % (4 * v) == 0) return v;
  return 1;
}

// Shared-memory geometry of one ring stage for dilation d, kGroups groups,
// halo copies of v floats and padding pad (host and device): the halo's
// rows; its columns, from the plane column x0 - pad - shift on (x0 - pad
// rounded down to v floats); its channel stride (8 mod 32 words); the
// channels of a stage; a weight row's floats and stride; floats per stage.
struct Geometry {
  int d, v, shift, rows, cols, cs, ch, wrow, ws, stage;
};

__host__ __device__ inline Geometry geometry(int d, int groups, int v, int pad) {
  Geometry g;
  g.d = d;
  g.v = v;
  g.shift = (pad + v - 1) / v * v - pad;
  g.rows = kRows + 2 * d;
  g.cols = (g.shift + kCols + 2 * d + v - 1) / v * v;
  g.cs = ((g.rows * g.cols - 8 + 31) / 32) * 32 + 8;  // >= rows * cols, = 8 mod 32
  g.ch = kChunk * groups;
  g.wrow = g.ch * 9;
  g.ws = groups == 1 ? 76 : 148;  // = 12 or 20 mod 32: conflict-free B fragments
  g.stage = g.ch * g.cs + kCo * g.ws;
  return g;
}

inline size_t smem_bytes(const Geometry& g, int stages) { return sizeof(float) * stages * g.stage; }

// Fragment coordinates of a thread of the first group (mma.m16n8k8
// layouts): accumulator acc[i][j][r] holds patch row frag_row(), column
// frag_col(i, r) and block channel frag_ch(j, r).
__device__ __forceinline__ int frag_row() { return ((threadIdx.x >> 5) & 7) / kWarpsN; }
__device__ __forceinline__ int frag_col(int i, int r) {
  return i * 16 + ((threadIdx.x & 31) >> 2) + (r >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_ch(int j, int r) {
  return ((threadIdx.x >> 5) % kWarpsN) * (kNT * 8) + j * 8 + 2 * (threadIdx.x & 3) + (r & 1);
}

// acc = the 3x3 correlation (dilation g.d) of the plane with w (co, c, 3, 3)
// for the patch at output (y0, x0) and channels co0 .. co0 + 63, in the
// fragment layout above, in the first group's threads (threadIdx.x <
// kThreads; the other group's acc is spent).  Channels >= co and pixels
// outside the output give values that the caller must not store.  The block
// has kThreads * kGroups threads; g = geometry(d, kGroups, v, in.pad) with
// v = halo_vec(in.x, in.pw); smem: smem_bytes(g, kStages), dynamic.
template <int kStages, int kGroups>
__device__ __forceinline__ void conv_tile(const Plane in, const float* __restrict__ w, int c,
                                          int co, int co0, int y0, int x0, const Geometry g,
                                          float* smem, float (&acc)[kMT][kNT][4]) {
  constexpr int kBlock = kThreads * kGroups;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = tid / kThreads;
  const int oy = y0 - in.pad;
  const int ox = x0 - in.pad - g.shift;  // a multiple of g.v
  const int64_t plane = (int64_t)in.ph * in.pw;
  // 16-byte weight copies need every channel's row of 9c floats to start
  // on a 16-byte boundary
  const bool w_vec = c % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  auto load_stage = [&](int s, int slot) {
    float* s_in = smem + slot * g.stage;  // [g.ch][cs]: rows x cols each
    float* s_w = s_in + g.ch * g.cs;      // [64][ws]: wrow used
    const int ci0 = s * g.ch;
    // the halo, (channel, halo row) by (channel, halo row); a vector lies
    // wholly inside or outside the plane, whose rows are multiples of v
    if (g.v > 1) {  // rpi rows per warp step, a lane per vector
      const int nv = g.cols / g.v;
      const int rpi = 32 / nv;
      const int lane_row = lane / nv;
      const int lane_x = (lane - lane_row * nv) * g.v;
      for (int r = warp * rpi + lane_row; lane_row < rpi && r < g.ch * g.rows;
           r += (kBlock / 32) * rpi) {
        const int ci = r / g.rows;
        const int hr = r - ci * g.rows;
        const int yy = oy + hr;
        const int xx = ox + lane_x;
        const bool ok = ci0 + ci < c && yy >= 0 && yy < in.ph && xx >= 0 && xx < in.pw;
        const float* src = ok ? in.x + (ci0 + ci) * plane + (int64_t)yy * in.pw + xx : in.x;
        float* dst = s_in + ci * g.cs + hr * g.cols + lane_x;
        if (g.v == 4) {
          cp_async16(dst, src, ok);
        } else {
          cp_async8(dst, src, ok);
        }
      }
    } else {  // one row per warp step, lanes along it
      for (int r = warp; r < g.ch * g.rows; r += kBlock / 32) {
        const int ci = r / g.rows;
        const int hr = r - ci * g.rows;
        const int yy = oy + hr;
        const bool row_ok = ci0 + ci < c && yy >= 0 && yy < in.ph;
        const float* src = in.x + (row_ok ? (ci0 + ci) * plane + (int64_t)yy * in.pw : 0);
        float* dst = s_in + ci * g.cs + hr * g.cols;
        for (int col = lane; col < g.cols; col += 32) {
          const int xx = ox + col;
          const bool ok = row_ok && xx >= 0 && xx < in.pw;
          cp_async4(dst + col, ok ? src + xx : in.x, ok);
        }
      }
    }
    // the weights: channel co0 + m, floats (ci0 * 9) .. (ci0 * 9 + wrow - 1) of its row
    const int valid = (c - ci0) * 9;  // floats of the row left from ci0 on
    if (w_vec) {
      const int per_row = g.wrow / 4;
      for (int e = tid; e < kCo * per_row; e += kBlock) {
        const int m = e / per_row;
        const int q = (e - m * per_row) * 4;
        const bool ok = co0 + m < co && q < valid;
        cp_async16(s_w + m * g.ws + q, ok ? w + ((int64_t)(co0 + m) * c + ci0) * 9 + q : w, ok);
      }
    } else {
      for (int e = tid; e < kCo * g.wrow; e += kBlock) {
        const int m = e / g.wrow;
        const int q = e - m * g.wrow;
        const bool ok = co0 + m < co && q < valid;
        cp_async4(s_w + m * g.ws + q, ok ? w + ((int64_t)(co0 + m) * c + ci0) * 9 + q : w, ok);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nstages = (c + g.ch - 1) / g.ch;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) load_stage(s, s);
    cp_async_commit();
  }

  // this thread's fragment origins within a stage: A (pixels x channels) at
  // halo row frag_row(), column lane/4, channel 8 * group + lane%4; B
  // (channels x outputs) at output channel lane/4 of the warp's 32, input
  // channel 8 * group + lane%4
  const int a_off =
      (kChunk * group + (lane & 3)) * g.cs + frag_row() * g.cols + g.shift + (lane >> 2);
  const int b_off = g.ch * g.cs + ((warp % kWarpsN) * (kNT * 8) + (lane >> 2)) * g.ws +
                    (kChunk * group + (lane & 3)) * 9;
  const int a_hi = 4 * g.cs;  // channels + 4

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1
    const int next = s + kStages - 1;
    if (next < nstages) load_stage(next, next % kStages);
    cp_async_commit();
    const float* sa = smem + (s % kStages) * g.stage + a_off;
    const float* sb = smem + (s % kStages) * g.stage + b_off;

    float part[kMT][kNT][4];  // this step's chain: written first at tap 0

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* a = sa + ((tap / 3) * g.cols + (tap % 3)) * g.d;
      unsigned a_big[kMT][4], a_small[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float v[4] = {a[i * 16], a[i * 16 + 8], a[a_hi + i * 16], a[a_hi + i * 16 + 8]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint2 p = split_tf32(v[r]);
          a_big[i][r] = p.x;
          a_small[i][r] = p.y;
        }
      }
      unsigned b_big[kNT][2], b_small[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint2 u0 = split_tf32(sb[j * 8 * g.ws + tap]);
        const uint2 u1 = split_tf32(sb[j * 8 * g.ws + tap + 36]);  // channel + 4
        b_big[j][0] = u0.x;
        b_small[j][0] = u0.y;
        b_big[j][1] = u1.x;
        b_small[j][1] = u1.y;
      }
      // the three passes in turn over the 8 tiles, so that no mma waits on
      // the one before it
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (tap == 0) {
            mma_tf32_first(part[i][j], a_small[i], b_big[j]);
          } else {
            mma_tf32(part[i][j], a_small[i], b_big[j]);
          }
        }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(part[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(part[i][j], a_big[i], b_big[j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }

  if (kGroups > 1) {
    // the second group's sums into the first's, through the drained ring:
    // element-major, so that each store and load is one contiguous row
    cp_async_wait<0>();
    __syncthreads();
    const int t = tid % kThreads;
    if (group == 1) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) smem[((i * kNT + j) * 4 + r) * kThreads + t] = acc[i][j][r];
    }
    __syncthreads();
    if (group == 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += smem[((i * kNT + j) * 4 + r) * kThreads + t];
    }
  }
}

}  // namespace conv3x3
