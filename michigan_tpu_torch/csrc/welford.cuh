// Welford running statistics and Chan's merge, shared by the normalising
// kernels (spade_norm.cu, conv_in_act.cu).  A state is (mean, m2, n): the
// mean, the sum of squared deviations from it, and the count.  The variance
// never comes from E[x^2] - mean^2, which cancels for large means.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void welford_add(float v, float& mean, float& m2, float& n) {
  n += 1.f;
  const float d = v - mean;
  mean += d / n;
  m2 += d * (v - mean);
}

// Chan's rule: merge (mean_b, m2_b, n_b) into (mean, m2, n).  Equal counts,
// the common case of the tree merges, take wb = 0.5 without the division,
// which gives exactly that.
__device__ __forceinline__ void welford_merge(float& mean, float& m2, float& n,
                                              float mean_b, float m2_b, float n_b) {
  const float total = n + n_b;
  if (n_b == 0.f) return;
  const float d = mean_b - mean;
  const float wb = n_b == n ? 0.5f : n_b / total;
  mean += d * wb;
  m2 += m2_b + d * d * n * wb;
  n = total;
}

// Merge the states of the 32 lanes of a warp into lane 0.
__device__ __forceinline__ void warp_merge(float& mean, float& m2, float& n) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    welford_merge(mean, m2, n, mb, m2b, nb);
  }
}

// Merge the states of a whole block (kThreads a multiple of 32, at most
// 1024) and return (mean, rstd = rsqrt(m2 / n + eps)) to every thread: the
// biased variance of nn.InstanceNorm2d.
template <int kThreads>
__device__ __forceinline__ float2 block_mean_rstd(float mean, float m2, float n, float eps) {
  __shared__ float s_mean[kThreads / 32];
  __shared__ float s_m2[kThreads / 32];
  __shared__ float s_n[kThreads / 32];
  __shared__ float2 s_stats;
  warp_merge(mean, m2, n);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_mean[warp] = mean;
    s_m2[warp] = m2;
    s_n[warp] = n;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kThreads / 32;
    mean = lane < kWarps ? s_mean[lane] : 0.f;
    m2 = lane < kWarps ? s_m2[lane] : 0.f;
    n = lane < kWarps ? s_n[lane] : 0.f;
    warp_merge(mean, m2, n);
    if (lane == 0) s_stats = make_float2(mean, rsqrtf(m2 / n + eps));
  }
  __syncthreads();
  return s_stats;
}
