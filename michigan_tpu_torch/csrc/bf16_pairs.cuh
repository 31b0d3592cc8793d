// The pair pass of the bf16 3x3 convolutions for Hopper (sm_90a), shared by
// conv_in_act.cu (reflect-padded input) and conv_lowch.cu (unpadded input,
// SAME zero padding by cp.async's zero-fill): it rewrites a bf16 NCHW
// plane as channel pairs and the weights as (co, pair, tap) words, the
// layout the bf16 form of conv3x3_tile.cuh loads its mma.sync m16n8k16
// fragments from.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16_pairs {

constexpr int kPairThreads = 256;

// The bits of v rounded to bf16 (to nearest even, as torch's cast).
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned pair_bits(uint16_t v) { return v; }
__device__ __forceinline__ unsigned pair_bits(float v) { return bf16_bits(v); }

// x (n, c, hp, wp) bf16 -> xi (n, p, hp, wq) words and w (co, c, 9) float32
// or bf16 -> wi (co, p, 9) words rounded to bf16 (to nearest even, as
// torch's cast); p = ceil(c / 2), the even channel in the low half; zero
// past channel c and past column wp.  One thread a word, over xi's words
// and then wi's, in 32-bit indices (the launchers refuse more than 2^31
// words in all): 64-bit division is a long software routine.
template <typename WT>
__global__ void __launch_bounds__(kPairThreads)
pair_kernel(const uint16_t* __restrict__ x, uint32_t* __restrict__ xi, unsigned nx, unsigned c,
            unsigned p, unsigned hp, unsigned wp, unsigned wq, const WT* __restrict__ w,
            uint32_t* __restrict__ wi, unsigned nw) {
  const unsigned i = blockIdx.x * kPairThreads + threadIdx.x;
  if (i < nx) {
    const unsigned col = i % wq;
    unsigned r = i / wq;
    const unsigned row = r % hp;
    r /= hp;
    const unsigned pp = r % p;
    const unsigned nn = r / p;
    unsigned lo = 0, hi = 0;
    if (col < wp) {
      const unsigned src = ((nn * c + 2 * pp) * hp + row) * wp + col;
      lo = x[src];
      if (2 * pp + 1 < c) hi = x[src + hp * wp];
    }
    xi[i] = lo | (hi << 16);
  } else if (i - nx < nw) {
    const unsigned j = i - nx;
    const unsigned tap = j % 9;
    const unsigned r = j / 9;
    const unsigned pp = r % p;
    const unsigned src = ((r / p) * c + 2 * pp) * 9 + tap;
    const unsigned lo = pair_bits(w[src]);
    const unsigned hi = 2 * pp + 1 < c ? pair_bits(w[src + 9]) : 0u;
    wi[j] = lo | (hi << 16);
  }
}

// Launch the pair pass on stream s; returns cudaGetLastError().
template <typename WT>
inline cudaError_t launch_pairs(const uint16_t* x, uint32_t* xi, int64_t nx, int64_t c,
                                int64_t p, int64_t hp, int64_t wp, int64_t wq, const WT* w,
                                uint32_t* wi, int64_t nw, cudaStream_t s) {
  const unsigned blocks = (unsigned)((nx + nw + kPairThreads - 1) / kPairThreads);
  pair_kernel<WT><<<blocks, kPairThreads, 0, s>>>(x, xi, (unsigned)nx, (unsigned)c, (unsigned)p,
                                                  (unsigned)hp, (unsigned)wp, (unsigned)wq, w,
                                                  wi, (unsigned)nw);
  return cudaGetLastError();
}

// Whether every element index of x (n, c, hp, wp), w (co, c, 9) and their
// pair buffers (nx + nw words) fits the pass's 32-bit indices.
inline bool pairs_fit(int64_t nx, int64_t nw, int64_t n, int64_t c, int64_t hp, int64_t wp,
                      int64_t co) {
  return nx + nw + kPairThreads < (int64_t(1) << 31) && n * c * hp * wp < (int64_t(1) << 31) &&
         co * c * 9 < (int64_t(1) << 31);
}

}  // namespace bf16_pairs
