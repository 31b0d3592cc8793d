// Fused SPADE normalisation kernels for Hopper (sm_90a), NCHW layout.
//
// spade_modulate  replaces michigan_tpu/ops/pallas/spade.py:spade_modulate
//                 (_mod_kernel): y = (x - mean[c]) * invstd[c] * (1 + gamma) + beta
//                 with the per-channel statistics supplied by the caller (the
//                 generator's eval-mode running stats).
// instance_norm   replaces spade.py:fused_instance_norm, both its VMEM-resident
//                 form (_in_kernel, _in_mod_kernel) and its streaming form for
//                 large planes (_in_stream_kernel, _in_stream_mod_kernel):
//                 per-(n, c) mean and biased variance over H*W, eps inside the
//                 rsqrt, then optional (1 + gamma) * xhat + beta, then optional
//                 relu / leaky relu(0.2).
//
// What bounds them: both are memory-bound elementwise/reduction passes with no
// tensor-core work.  spade_modulate moves 16 B per f32 element (x, gamma, beta
// in, y out); instance_norm reads x twice and writes y once (12 B per f32
// element, 20 B with gamma/beta), against 3.35 TB/s of HBM.
//
// spade_modulate reads gamma and beta where the SPADE conv wrote them: the two
// channel halves of one (N, 2C, H, W) output, each sample's (C, H, W) block
// contiguous, samples gb_sample_stride elements apart.  Copying the halves out
// first would add another 16 B per element at batch > 1.
//
// What the design does about it:
// - every load and store is 16 B per thread (float4, or four bf16 in 8 B) when
//   H*W % 4 == 0, neighbouring threads on neighbouring addresses; a group of
//   four never crosses a plane, so one channel index serves all four;
// - all arithmetic is in f32 and the result is written in the input's dtype;
// - instance_norm gives one block to each (n, c) plane, which is contiguous in
//   NCHW.  Pass 1 keeps a per-thread Welford accumulator and merges threads by
//   Chan's rule (warp shuffles, then shared memory), so the variance never
//   comes from E[x^2] - mean^2.  Pass 2 re-reads the plane, which mostly hits
//   the 50 MB L2, and normalises.  The Pallas kernel's split into a resident
//   and a streaming form exists only for VMEM residency and has no
//   counterpart here.
// - Known limit, left for a later change: with fewer planes than the 132 SMs
//   (e.g. the inpainter's 64 planes of 256x256 at batch 1) the grid underfills
//   the card; splitting a plane over several blocks needs a cross-block merge.
//
// Every launcher returns cudaGetLastError() so the caller can raise on a
// refused launch.  Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "welford.cuh"

namespace {

constexpr int kModThreads = 256;
constexpr int kNormThreads = 512;
constexpr int kMaxModBlocks = 1 << 20;

enum Act { kActNone = 0, kActRelu = 1, kActLrelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements; p must be aligned to 4 elements.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == kActRelu) return fmaxf(y, 0.f);
  if (act == kActLrelu) return y > 0.f ? y : 0.2f * y;
  return y;
}

// ---------------------------------------------------------------------------
// spade_modulate
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kModThreads)
spade_modulate_vec4(const T* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ invstd, const T* __restrict__ gamma,
                    const T* __restrict__ beta, T* __restrict__ out,
                    int64_t groups, int64_t hw4, int64_t c, int64_t gb_skip) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const int64_t plane = g / hw4;
    const int64_t ch = plane % c;
    const float m = mean[ch];
    const float s = invstd[ch];
    const int64_t i = g * 4;
    const int64_t j = i + (plane / c) * gb_skip;
    float xv[4], gv[4], bv[4], y[4];
    load4(x + i, xv);
    load4(gamma + j, gv);
    load4(beta + j, bv);
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = (xv[k] - m) * s * (1.f + gv[k]) + bv[k];
    store4(out + i, y);
  }
}

template <typename T>
__global__ void __launch_bounds__(kModThreads)
spade_modulate_scalar(const T* __restrict__ x, const float* __restrict__ mean,
                      const float* __restrict__ invstd, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ out,
                      int64_t total, int64_t hw, int64_t c, int64_t gb_skip) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t plane = i / hw;
    const int64_t ch = plane % c;
    const int64_t j = i + (plane / c) * gb_skip;
    const float y = (to_f32(x[i]) - mean[ch]) * invstd[ch] * (1.f + to_f32(gamma[j])) +
                    to_f32(beta[j]);
    out[i] = from_f32<T>(y);
  }
}

// The four-wide path needs H*W % 4 == 0 and every pointer aligned to four
// elements; views with an odd storage offset take the scalar path.
template <typename T>
bool can_vec4(int64_t hw, const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d);
  return hw % 4 == 0 && bits % (4 * sizeof(T)) == 0;
}

template <typename T>
int launch_spade_modulate(const void* x, const void* mean, const void* invstd,
                          const void* gamma, const void* beta, void* out, int64_t n,
                          int64_t c, int64_t hw, int64_t gb_sample_stride, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = n * c * hw;
  // gamma and beta may be the two channel halves of one (N, 2C, H, W) conv
  // output: sample k's block starts gb_sample_stride elements after sample
  // k-1's, that is gb_skip elements further than in x
  const int64_t gb_skip = gb_sample_stride - c * hw;
  const bool vec = gb_skip % 4 == 0 && can_vec4<T>(hw, x, gamma, beta, out);
  const int64_t work = vec ? total / 4 : total;
  int64_t blocks = (work + kModThreads - 1) / kModThreads;
  if (blocks > kMaxModBlocks) blocks = kMaxModBlocks;
  if (vec) {
    spade_modulate_vec4<T><<<(unsigned)blocks, kModThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(invstd), static_cast<const T*>(gamma),
        static_cast<const T*>(beta), static_cast<T*>(out), work, hw / 4, c, gb_skip);
  } else {
    spade_modulate_scalar<T><<<(unsigned)blocks, kModThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(invstd), static_cast<const T*>(gamma),
        static_cast<const T*>(beta), static_cast<T*>(out), total, hw, c, gb_skip);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// instance_norm
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
instance_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ beta, T* __restrict__ out, int64_t hw,
                     float eps, int act, bool vec) {
  const int64_t base = (int64_t)blockIdx.x * hw;
  const T* xp = x + base;

  // pass 1: per-thread Welford over the plane
  float mean = 0.f, m2 = 0.f, n = 0.f;
  if (vec) {
    for (int64_t i = (int64_t)threadIdx.x * 4; i < hw; i += kNormThreads * 4) {
      float v[4];
      load4(xp + i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) welford_add(v[k], mean, m2, n);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kNormThreads)
      welford_add(to_f32(xp[i]), mean, m2, n);
  }

  // merge the threads' states, then the rsqrt of the biased variance
  const float2 stats = block_mean_rstd<kNormThreads>(mean, m2, n, eps);
  const float mu = stats.x;
  const float rstd = stats.y;

  // pass 2: normalise, modulate, activate
  T* op = out + base;
  const T* gp = gamma ? gamma + base : nullptr;
  const T* bp = beta ? beta + base : nullptr;
  if (vec) {
    for (int64_t i = (int64_t)threadIdx.x * 4; i < hw; i += kNormThreads * 4) {
      float v[4], y[4];
      load4(xp + i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) y[k] = (v[k] - mu) * rstd;
      if (gp) {
        float g[4], b[4];
        load4(gp + i, g);
        load4(bp + i, b);
#pragma unroll
        for (int k = 0; k < 4; ++k) y[k] = y[k] * (1.f + g[k]) + b[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) y[k] = apply_act(y[k], act);
      store4(op + i, y);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kNormThreads) {
      float y = (to_f32(xp[i]) - mu) * rstd;
      if (gp) y = y * (1.f + to_f32(gp[i])) + to_f32(bp[i]);
      op[i] = from_f32<T>(apply_act(y, act));
    }
  }
}

template <typename T>
int launch_instance_norm(const void* x, const void* gamma, const void* beta, void* out,
                         int64_t planes, int64_t hw, float eps, int act, void* stream) {
  const bool vec = gamma ? can_vec4<T>(hw, x, gamma, beta, out)
                         : can_vec4<T>(hw, x, x, x, out);
  instance_norm_kernel<T><<<(unsigned)planes, kNormThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out), hw, eps, act, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int spade_modulate_f32(const void* x, const void* mean, const void* invstd,
                       const void* gamma, const void* beta, void* out, int64_t n,
                       int64_t c, int64_t hw, int64_t gb_sample_stride, void* stream) {
  return launch_spade_modulate<float>(x, mean, invstd, gamma, beta, out, n, c, hw,
                                      gb_sample_stride, stream);
}

int spade_modulate_bf16(const void* x, const void* mean, const void* invstd,
                        const void* gamma, const void* beta, void* out, int64_t n,
                        int64_t c, int64_t hw, int64_t gb_sample_stride, void* stream) {
  return launch_spade_modulate<__nv_bfloat16>(x, mean, invstd, gamma, beta, out, n, c,
                                              hw, gb_sample_stride, stream);
}

int instance_norm_f32(const void* x, const void* gamma, const void* beta, void* out,
                      int64_t planes, int64_t hw, float eps, int act, void* stream) {
  return launch_instance_norm<float>(x, gamma, beta, out, planes, hw, eps, act, stream);
}

int instance_norm_bf16(const void* x, const void* gamma, const void* beta, void* out,
                       int64_t planes, int64_t hw, float eps, int act, void* stream) {
  return launch_instance_norm<__nv_bfloat16>(x, gamma, beta, out, planes, hw, eps, act,
                                             stream);
}

}  // extern "C"
