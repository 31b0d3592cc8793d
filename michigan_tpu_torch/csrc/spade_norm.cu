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
// in, y out); instance_norm in float32 reads x twice and writes y once (12 B
// per element, 20 B with gamma/beta; the bf16 form reads x once, below),
// against 3.35 TB/s of HBM.
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
// - the float32 form (instance_norm_kernel<float>) keeps that design and its
//   limit: with fewer planes than the 132 SMs (the inpainter's 64 planes of
//   256x256 at batch 1) its grid underfills the card.
//
// instance_norm in bf16 (instance_norm_bf16_kernel) reads x once: a plane
// stays on chip between its statistics and its normalisation, so the kernel
// moves the bound's bytes (2 B in and 2 B out per element, 4 more with
// gamma and beta).  The form is picked by shape alone (bf16_split):
// - a block of 128 threads holds up to 8,192 elements in registers, eight
//   16-byte vectors (or 64 scalars where H*W % 8 != 0 or a pointer is off 16
//   bytes) a thread, all loads in flight at once (256 threads of four took
//   up to 14% longer, a slice brought by one bulk copy into shared memory up
//   to 11%: tools/norm_variants.py);
// - a plane larger than a block, or a plane of a call with fewer planes
//   than the card has SMs, is split across a thread-block cluster of 2, 4 or
//   8 blocks (the portable size; 16-block clusters fit on only 7 of this
//   card's GPCs), each holding a slice: (1, 64, 256^2) at batch 1 runs 8
//   blocks a plane on 512 blocks, (1, 128, 128^2) 2.  The blocks merge
//   their (mean, M2, count) by Chan's rule through distributed shared
//   memory: one cluster barrier, 2-8 remote 16-byte loads a block (a
//   counted exchange through device memory, as conv_in_act.cu's, took
//   10.5 -> 11.4 us at (1, 64, 256^2) and 6.0 -> 8.8 at (1, 128, 128^2) on an
//   H100);
// - a thread's own statistics are two passes over its registers (mean,
//   then squared deviations), merged across the block and the cluster by
//   welford.cuh's Chan merge, so the variance never comes from E[x^2] -
//   mean^2;
// - planes above 8 x 8,192 elements take the two-pass form above
//   (instance_norm_kernel<__nv_bfloat16>), correct at any H*W.
//
// Every launcher returns cudaGetLastError() so the caller can raise on a
// refused launch.  Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "conv3x3_bf16.cuh"
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

// ---------------------------------------------------------------------------
// instance_norm in bf16: one read
// ---------------------------------------------------------------------------

constexpr int kResThreads = 128;
constexpr int kResVecs = 8;                                 // 16-byte vectors a thread
constexpr int kResElems = kResThreads * kResVecs * 8;       // 8,192 elements a block
constexpr int kResWarps = kResThreads / 32;
constexpr int kMaxCluster = 8;                              // the portable cluster size

// Blocks per plane of the one-read form: as few as hold the plane, then
// more, while the call has fewer blocks than the card has SMs and each
// block keeps at least one vector a thread; 0 for the two-pass form.
inline int bf16_split(int64_t planes, int64_t hw, int sms) {
  int cs = 1;
  while (cs <= kMaxCluster && (hw + cs - 1) / cs > kResElems) cs *= 2;
  if (cs > kMaxCluster) return 0;
  while (cs < kMaxCluster && planes * cs < sms && hw / (2 * cs) >= kResThreads * 8) cs *= 2;
  return cs;
}

// element j of the eight bf16 in v, as float32
__device__ __forceinline__ float bf16_at(const uint4& v, int j) {
  const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float4 at p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float4 ld_cluster(const float4* p, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(conv_bf16::smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// One block per slice of `chunk` elements (a multiple of 8) of a plane; the
// cs blocks of a plane form a cluster.  kVec: 16-byte vectors, thread t's
// vector v at element 8 (v kResThreads + t) of the slice; else scalars, its
// element j of vector v at (8 v + j) kResThreads + t.  Registers for 4
// blocks an SM, so that the 512 blocks of the inpainter's (1, 64, 256^2)
// are resident at once.
template <bool kVec>
__global__ void __launch_bounds__(kResThreads, 4)
instance_norm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ gamma,
                          const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ out,
                          int64_t hw, int cs, int chunk, float eps, int act) {
  __shared__ float4 s_part[kResWarps];
  __shared__ __align__(16) float4 s_block;
  __shared__ float2 s_stats;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t plane = blockIdx.x / cs;
  const int rank = (int)(blockIdx.x - plane * cs);
  // offsets within the plane (at most kMaxCluster * kResElems elements)
  const int lo = rank * chunk;
  const int hi = lo + chunk < hw ? lo + chunk : (int)hw;
  const int64_t base = plane * hw;
  auto at = [&](int v, int j) -> int {
    return kVec ? lo + 8 * (v * kResThreads + tid) + j : lo + (8 * v + j) * kResThreads + tid;
  };
  auto load = [&](const __nv_bfloat16* p, int v) -> uint4 {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p + base);
    if (kVec) return at(v, 0) < hi ? *reinterpret_cast<const uint4*>(q + at(v, 0)) : uint4{};
    unsigned e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = at(v, j) < hi ? q[at(v, j)] : 0u;
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
  };

  uint4 xv[kResVecs];
#pragma unroll
  for (int v = 0; v < kResVecs; ++v) xv[v] = load(x, v);

  // this thread's (mean, M2, count): two passes over its registers
  float sum = 0.f, cnt = 0.f;
#pragma unroll
  for (int v = 0; v < kResVecs; ++v)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (at(v, j) < hi) {
        sum += bf16_at(xv[v], j);
        cnt += 1.f;
      }
  float mean = cnt > 0.f ? sum / cnt : 0.f, m2 = 0.f;
#pragma unroll
  for (int v = 0; v < kResVecs; ++v)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (at(v, j) < hi) {
        const float d = bf16_at(xv[v], j) - mean;
        m2 += d * d;
      }

  // the block's, by Chan's rule (warps, then the warps' states)
  warp_merge(mean, m2, cnt);
  if (lane == 0) s_part[warp] = make_float4(mean, m2, cnt, 0.f);
  __syncthreads();
  if (warp == 0) {
    const float4 p = lane < kResWarps ? s_part[lane] : make_float4(0.f, 0.f, 0.f, 0.f);
    mean = p.x, m2 = p.y, cnt = p.z;
    warp_merge(mean, m2, cnt);
    if (lane == 0) s_block = make_float4(mean, m2, cnt, 0.f);
  }
  if (cs > 1) {  // the plane's, from every block of the cluster, in rank order
    cluster_arrive();
    cluster_wait();
    if (warp == 0) {
      const float4 p = lane < cs ? ld_cluster(&s_block, lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      mean = p.x, m2 = p.y, cnt = p.z;
      warp_merge(mean, m2, cnt);
      if (lane == 0) s_stats = make_float2(mean, rsqrtf(m2 / cnt + eps));
    }
    cluster_arrive();  // done reading the others' s_block; waited for before exit
  } else if (tid == 0) {
    s_stats = make_float2(mean, rsqrtf(m2 / cnt + eps));
  }
  __syncthreads();
  const float mu = s_stats.x, rstd = s_stats.y;

  unsigned short* o = reinterpret_cast<unsigned short*>(out + base);
#pragma unroll
  for (int v = 0; v < kResVecs; ++v) {
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = (bf16_at(xv[v], j) - mu) * rstd;
    if (gamma) {
      const uint4 g = load(gamma, v), b = load(beta, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = y[j] * (1.f + bf16_at(g, j)) + bf16_at(b, j);
    }
    unsigned e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __bfloat16_as_ushort(__float2bfloat16_rn(apply_act(y[j], act)));
    if (kVec) {
      if (at(v, 0) < hi)
        *reinterpret_cast<uint4*>(o + at(v, 0)) = make_uint4(
            e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16, e[6] | e[7] << 16);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (at(v, j) < hi) o[at(v, j)] = (unsigned short)e[j];
    }
  }
  if (cs > 1) cluster_wait();  // no block leaves while another may read its s_block
}

// The current card's SM count, queried once per device.
int device_sms(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> cached[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kDevices && (*sms = cached[dev].load(std::memory_order_relaxed)) > 0) return 0;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kDevices) cached[dev].store(*sms, std::memory_order_relaxed);
  return (int)e;
}

int launch_instance_norm_bf16(const void* x, const void* gamma, const void* beta, void* out,
                              int64_t planes, int64_t hw, float eps, int act, void* stream) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != 0) return err;
  const int cs = bf16_split(planes, hw, sms);
  if (cs == 0) return launch_instance_norm<__nv_bfloat16>(x, gamma, beta, out, planes, hw, eps,
                                                          act, stream);
  const int chunk = (int)(((hw + cs - 1) / cs + 7) / 8 * 8);
  // 16-byte vectors need H*W % 8 == 0 and every pointer on 16 bytes
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         (gamma ? reinterpret_cast<uintptr_t>(gamma) |
                                      reinterpret_cast<uintptr_t>(beta)
                                : 0);
  const bool vec = hw % 8 == 0 && bits % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(planes * cs));
  cfg.blockDim = dim3(kResThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  const __nv_bfloat16 *xp = static_cast<const __nv_bfloat16*>(x),
                      *gp = static_cast<const __nv_bfloat16*>(gamma),
                      *bp = static_cast<const __nv_bfloat16*>(beta);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  const cudaError_t e =
      vec ? cudaLaunchKernelEx(&cfg, instance_norm_bf16_kernel<true>, xp, gp, bp, op, hw, cs, chunk,
                               eps, act)
          : cudaLaunchKernelEx(&cfg, instance_norm_bf16_kernel<false>, xp, gp, bp, op, hw, cs,
                               chunk, eps, act);
  if (e != cudaSuccess) return (int)e;
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
  return launch_instance_norm_bf16(x, gamma, beta, out, planes, hw, eps, act, stream);
}

// Blocks per plane that instance_norm_bf16 gives (planes, hw) on the current
// card: 1-8 for the one-read form, 0 for the two-pass form; -1 on an error.
int instance_norm_bf16_split(int64_t planes, int64_t hw) {
  int sms = 0;
  return device_sms(&sms) == 0 ? bf16_split(planes, hw, sms) : -1;
}

}  // extern "C"
