// The bf16 3x3 convolution tile for Hopper (sm_90a) of conv_lowch.cu
// (SAME padding of an unpadded NCHW input): bf16 x as given, the weight
// bf16 or float32 rounded to bf16 here, float32 sums.  Its PTX helpers
// (mbarriers, bulk copies, wgmma and its shared-memory descriptors, the
// accumulator layout) also serve conv_in_act.cu's bf16 form.
//
// GEMM view.  M = output pixels: a tile of kTileRows x kTileCols = 4 x 64
// pixels of one sample's plane, one m64 per output row; N = kN output
// channels of the block; K = (tap, input channel), walked in stages of
// kStageCh = 16 input channels, one k16 product per tap and stage.  The
// consumer warpgroup takes all four rows, wgmma.mma_async m64nNk16 bf16 ->
// f32 with both operands in shared memory; producer warpgroups stage the
// operands.
//
// Staging, per stage (no pass before the kernel, no scratch):
// - the input halo of the stage's 16 channels, (4 + 2d) rows x `cols`
//   columns from an origin rounded down to 8 elements: one TMA box of a
//   tensor map where x's rows allow one, else each (channel, row) by one
//   bulk copy of the copy engine (cp.async.bulk, completion counted in
//   bytes on the slot's mbarrier), widened to 16-byte boundaries so that
//   rows of any width and alignment go whole; a row whose widened copy
//   would leave x's own bytes goes by plain loads instead;
// - a transposer turns each slot into [8-channel chunk][halo row][column]
//   [8 channels], the canonical K-major layout of a wgmma operand without
//   swizzle (core matrices of 8 rows x 16 bytes), writing zeros outside the
//   plane (the SAME padding) and past channel C.  A tap's shift (dy, dx) *
//   d moves the A descriptor's start by whole 16-byte rows, so every tap
//   reads the same transposed halo through its own descriptor;
// - the weights go in the B-operand layout [tap][chunk][co][8 channels],
//   rounded to bf16 as they are stored, loaded in 16-byte vectors: the
//   block's whole weight (64 x 64 x 9 bf16 = 73.7 KB at C = 64) stays
//   resident, loaded once by a persistent block that then walks many
//   tiles; where that does not fit each stage's slice is stored beside its
//   halo.
//
// Pipeline: the producers run up to two stages ahead of the products, on
// mbarriers (the halo ring's, and full / empty ones for the two operand
// slots); the ring runs across tile boundaries, so a persistent block's
// next tile is staged during a tile's epilogue.  (With every warp doing
// both, staging and products ran one after the other, by clock64 probes.)
//
// Accumulation.  The tensor cores add with truncation; each output sums
// C * 9 products in one wgmma chain (576 at C = 64), held against float64
// beside cuDNN's bf16 convolution in chip_smoke.py and
// tools/tile_variants.py: at most F64_RATIO x cuDNN's error, which the one
// bf16 rounding of the output dominates.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_bf16 {

constexpr int kConsumers = 128;  // warpgroup 0: the products and the epilogue
constexpr int kTileRows = 4;    // output rows per tile
constexpr int kTileCols = 64;   // output columns per tile: one m64 per row
constexpr int kRowsPerWg = kTileRows;  // the consumer warpgroup takes them all
constexpr int kStageCh = 16;    // input channels per K stage: one k16 per tap
constexpr int kSmemMax = 232448;  // an H100 block's shared memory

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers: one per halo ring slot; every thread arrives once per use,
// declaring the bytes of the bulk copy it issued (0 if none)
__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(void* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the copy engine; completion is counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one 4-d box (x, y, c, n) of a tensor map from global to shared, zero
// outside the tensor, counted on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int x, int y,
                                            int c, int n, void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(c), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

// Host: a bf16 tensor map of `rank` dims (dims[0] innermost; strides in
// bytes for dims 1..) with boxes of `box`, zero outside the tensor, through
// the CUDA driver's cuTensorMapEncodeTiled (reached by the runtime, no
// -lcuda); an error if the driver lacks it or refuses the map.
inline cudaError_t encode_bf16_map(CUtensorMap* map, int rank, const void* base,
                                   const cuuint64_t* dims, const cuuint64_t* strides,
                                   const cuuint32_t* box) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// generic-proxy writes to shared memory (st.shared, stmatrix) made visible
// to the async proxy that wgmma reads its operands through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor without swizzle: the start address,
// the byte offset between core matrices along K (lbo) and along M or N
// (sbo), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving accumulator registers across a wait
template <int kN>
__device__ __forceinline__ void reg_fence(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B, m64nNk16, bf16 operands from shared memory, f32 sums;
// accumulate = 0 overwrites d
template <int kN>
__device__ __forceinline__ void wgmma(float (&d)[kN / 2], uint64_t da, uint64_t db,
                                      int accumulate);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the bits of v rounded to bf16 (to nearest even, as torch's cast)
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// ----------------------------------------------------------- geometry ---

// One launch's shapes and shared-memory plan (host and device).  The input
// plane is (c, ph, pw) per sample; a tile's halo starts at plane row y0 -
// pad and column x0 - pad (x0 a multiple of 64, so x0 - pad - shift is a
// multiple of 8 for every tile).
struct Geo {
  int c, ph, pw, pad, d;     // input channels, plane rows and columns, padding, dilation
  int h, w, tiles_x, tiles;  // output plane; tiles per plane
  int rows, cols, shift;     // halo rows, columns (a multiple of 8), x0 - pad - origin
  int nk;                    // K stages of kStageCh channels
  int pitch, raw_cs;         // bytes: a raw halo row (2 cols + 16), a channel of them
  int64_t x_bytes;           // x's own bytes (the launcher sets them)
  int tab_off, raw_stage;    // bytes: the slot's table of row offsets, the slot
  int pairs;                 // rows' column offsets are even: two-pixel reads
  int tr_chunk, tr_stage;    // bytes: an 8-channel chunk of the transposed halo, a slot
  int b_step;                // bytes: one K stage's weights, all 9 taps
  int raw_off, tr_off, b_off, epi_off, smem;  // byte offsets; total dynamic shared memory
  int resident;              // the block's whole weight stays in shared memory
  int wvec;                  // the weight's (co, 16-channel) slices start on 16 bytes
};

// kN output channels per block; kLook raw slots (stages requested ahead);
// epi_bytes for the caller's epilogue; resident weights where they fit and
// allow_resident.
template <int kN, int kLook>
inline Geo make_geo(int c, int ph, int pw, int pad, int d, int h, int w, const void* x,
                    const void* wt, bool w_f32, int epi_bytes, bool allow_resident) {
  Geo g;
  g.c = c;
  g.ph = ph;
  g.pw = pw;
  g.pad = pad;
  g.d = d;
  g.h = h;
  g.w = w;
  g.tiles_x = (w + kTileCols - 1) / kTileCols;
  g.tiles = g.tiles_x * ((h + kTileRows - 1) / kTileRows);
  g.rows = kTileRows + 2 * d;
  g.shift = ((-pad) % 8 + 8) % 8;
  g.cols = (g.shift + kTileCols + 2 * d + 7) / 8 * 8;
  g.nk = (c + kStageCh - 1) / kStageCh;
  // a slice of 16 channels x 9 taps starts at element (co * c + 16 k) * 9
  g.wvec = c % (w_f32 ? 4 : 8) == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  g.pitch = 2 * g.cols + 16;  // a row's copy with its lead to the 16-byte boundary
  g.raw_cs = g.rows * g.pitch;
  g.x_bytes = 0;
  g.pairs = pw % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  g.tab_off = kStageCh * g.raw_cs;
  g.raw_stage = (g.tab_off + kStageCh * g.rows * 4 + 127) / 128 * 128;
  g.tr_chunk = g.rows * g.cols * 16;
  g.tr_stage = 2 * g.tr_chunk;
  g.b_step = 9 * 2 * kN * 16;
  auto up = [](int b) { return (b + 127) / 128 * 128; };
  g.raw_off = 0;
  g.tr_off = up(kLook * g.raw_stage);
  g.b_off = g.tr_off + up(2 * g.tr_stage);
  const int fixed = g.b_off + up(epi_bytes);
  g.resident = allow_resident && fixed + g.nk * g.b_step <= kSmemMax - 2048;
  g.epi_off = g.b_off + up((g.resident ? g.nk : 2) * g.b_step);
  g.smem = g.epi_off + up(epi_bytes);
  return g;
}

// Accumulator coordinates of a thread (the wgmma m64nN D layout):
// acc[i][4 * j + 2 * h + e] holds tile row
// frag_row(i), tile column frag_px(h), block channel frag_co(j, e).
__device__ __forceinline__ int frag_row(int i) { return i; }

// barriers of one warpgroup: the consumers' (the epilogues), the producers'
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
template <int kProducers>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kProducers) : "memory");
}
__device__ __forceinline__ int frag_px(int h) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int frag_co(int j, int e) { return 8 * j + 2 * (threadIdx.x & 3) + e; }

// Where item i of a block's walk lies: sample, tile origin (G: a geometry
// with tiles and tiles_x).
struct Item {
  int n, y0, x0;
};
template <typename G>
__device__ __forceinline__ Item item_at(const G& g, int base_n, int i) {
  const int t = i % g.tiles;
  Item it;
  it.n = base_n + i / g.tiles;
  it.y0 = (t / g.tiles_x) * kTileRows;
  it.x0 = (t % g.tiles_x) * kTileCols;
  return it;
}

// ----------------------------------------------------------- the tile ---

// Vectors of 16 bytes per output channel in one K stage's weight slice
// (16 channels x 9 taps contiguous in (co, c, 3, 3)): 36 float32, 18 bf16.
constexpr int kWvF32 = kStageCh * 9 * 4 / 16;
constexpr int kWvBf16 = kStageCh * 9 * 2 / 16;

// The weights of K stage k for the block's kN output channels, rounded to
// bf16, as [tap][chunk][co][8] (the B operand), by kThr threads (me: this
// one's index).  Where every (co, 16-channel) slice starts on 16 bytes
// (g.wvec), fetch loads the thread's 16-byte vectors into registers (ahead
// of need) and store scatters them; else scalar does both, a thread per
// (co, chunk, tap).
template <int kN, int kThr>
struct WeightLoader {
  static constexpr int kWv = (kN * kWvF32 + kThr - 1) / kThr;
  uint4 reg[kWv];
  const void* w;
  int w_f32, co, co0, c, me, w_vec;

  __device__ __forceinline__ void fetch(int k) {
    const int valid = (c - k * kStageCh < kStageCh ? c - k * kStageCh : kStageCh) * 9;
#pragma unroll
    for (int j = 0; j < kWv; ++j) {
      const int t = me + j * kThr;
      const int m = w_f32 ? t / kWvF32 : t / kWvBf16;
      const int q = t - m * (w_f32 ? kWvF32 : kWvBf16);
      const int per = w_f32 ? 4 : 8;  // elements per vector
      const bool ok = m < kN && co0 + m < co && q * per < valid;
      const int64_t at = ((int64_t)(co0 + m) * c + k * kStageCh) * 9 + q * per;
      const uint4* src = reinterpret_cast<const uint4*>(
          w_f32 ? (const char*)w + at * 4 : (const char*)w + at * 2);
      reg[j] = ok ? __ldg(src) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(char* dst) const {
#pragma unroll
    for (int j = 0; j < kWv; ++j) {
      const int t = me + j * kThr;
      const int m = w_f32 ? t / kWvF32 : t / kWvBf16;
      if (m >= kN) continue;
      const int q = t - m * (w_f32 ? kWvF32 : kWvBf16);
      const unsigned u[4] = {reg[j].x, reg[j].y, reg[j].z, reg[j].w};
      const int per = w_f32 ? 4 : 8;
      // (channel, tap) of the vector's first element, then stepped
      int cl = q * per / 9, tap = q * per - cl * 9;
      char* at = dst + m * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= per) break;
        const unsigned bits = w_f32 ? bf16_bits(__uint_as_float(u[e]))
                                    : (u[e >> 1] >> (16 * (e & 1))) & 0xffffu;
        *reinterpret_cast<uint16_t*>(at + (tap * 2 + (cl >> 3)) * kN * 16 + (cl & 7) * 2) =
            (uint16_t)bits;
        if (++tap == 9) {
          tap = 0;
          ++cl;
        }
      }
    }
  }

  __device__ __forceinline__ void scalar(int k, char* dst) const {
    for (int t = me; t < 9 * 2 * kN; t += kThr) {
      const int tap = t % 9;
      const int rr = t / 9;
      const int chunk = rr & 1;
      const int m = rr >> 1;
      const int oc = co0 + m;
      const int cb = k * kStageCh + chunk * 8;
      unsigned word[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned lo = 0, hi = 0;
        const int ci = cb + 2 * e;
        if (oc < co) {
          const int64_t at = ((int64_t)oc * c + ci) * 9 + tap;
          if (w_f32) {
            const float* wf = static_cast<const float*>(w);
            if (ci < c) lo = bf16_bits(wf[at]);
            if (ci + 1 < c) hi = bf16_bits(wf[at + 9]);
          } else {
            const uint16_t* wb = static_cast<const uint16_t*>(w);
            if (ci < c) lo = wb[at];
            if (ci + 1 < c) hi = wb[at + 9];
          }
        }
        word[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + ((tap * 2 + chunk) * kN + m) * 16) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  }

  // both steps, for a stage's slot
  __device__ __forceinline__ void load(int k, char* dst) {
    if (w_vec) {
      fetch(k);
      store(dst);
    } else {
      scalar(k, dst);
    }
  }
};

// For items first, first + stride, ... < total (item i: sample base_n + i /
// tiles, tile i % tiles), acc = the 3x3 correlation (dilation g.d) of x with
// the weight w (co, c, 3, 3) (float32 if w_f32, else bf16) for the block's
// channels co0 .. co0 + kN - 1 (zero past co), and, in the consumer
// warpgroup, epi(acc, li, item, last) after each item's last stage (li: the
// item's place in the block's walk).  x: (N, c, ph, pw) bf16.
// Called by all kConsumers + kProducers threads; smem: g.smem bytes of dynamic shared
// memory, 128-byte aligned.
//
// The producers run up to two stages ahead of the products: stage s goes
// from its raw slot s % kLook (bulk copies, raw_bar) through the transposer
// and the weight store into operand slot s & 1, announced on full_bar[s & 1];
// the consumers release the slot on empty_bar[s & 1] once wgmma.wait_group
// has retired stage s's products.  So the copies, the transposes and the
// weight stores overlap the tensor cores' work instead of queueing behind
// it in the same warps.
//
// kProducers: the producer threads (a multiple of 128).  map: x as a
// tensor map with boxes of (cols, rows, 16, 1), or null.
template <int kN, int kLook, int kProducers, typename Epi>
__device__ __forceinline__ void conv_tiles(const __nv_bfloat16* __restrict__ x,
                                           const CUtensorMap* map, const void* __restrict__ w,
                                           int w_f32, int co, int co0, const Geo& g, int first,
                                           int stride, int total, int base_n, char* smem,
                                           Epi& epi) {
  static_assert(kN == 32 || kN == 64, "m64n32 or m64n64");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_items = first < total ? (total - first + stride - 1) / stride : 0;
  const int n_stages = n_items * g.nk;

  __shared__ __align__(8) uint64_t raw_bar[kLook];
  __shared__ __align__(8) uint64_t full_bar[2];
  __shared__ __align__(8) uint64_t empty_bar[2];
  if (tid == 0) {
    for (int i = 0; i < kLook; ++i) mbar_init(&raw_bar[i], kProducers / 32);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_bar[i], kProducers);
      mbar_init(&empty_bar[i], kConsumers);
    }
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------------- producers ---
    const int pt = tid - kConsumers;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);

    // The halo of a stage: one tensor-map box where there is a map, else
    // each of the 16 x rows (channel, halo row) by one bulk copy of the copy
    // engine, the row's in-plane columns widened to 16-byte boundaries (x
    // rows need no alignment), into its slot row of `pitch` bytes; a row
    // whose widened copy would read outside x's own bytes (x's first or
    // last bytes, off a 16-byte boundary) goes by plain loads instead.  The
    // slot's table gets each row's offset of column ox; the slot's mbarrier
    // counts one arrival per warp, with its bytes, after the warp's plain
    // stores and before its copies.  The transposer masks what lies outside
    // the plane or past channel c.
    const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
    const uintptr_t x_hi = x_lo + (uintptr_t)g.x_bytes;
    auto load_raw = [&](int slot, const Item& it, int k) {
      char* base = smem + g.raw_off + slot * g.raw_stage;
      int* tab = reinterpret_cast<int*>(base + g.tab_off);
      const int oy = it.y0 - g.pad;
      const int ox = it.x0 - g.pad - g.shift;
      if (map != nullptr) {  // one box, dense [16][rows][cols], zero outside x
        if (pt < kStageCh * g.rows)
          tab[pt] = pt * g.cols * 2;  // = ch * rows * cols * 2 + hr * cols * 2
        if (lane == 0)
          mbar_arrive_tx(&raw_bar[slot], pt == 0 ? kStageCh * g.rows * g.cols * 2 : 0);
        if (pt == 0) tma_load_4d(base, map, ox, oy, k * kStageCh, it.n, &raw_bar[slot]);
        return;
      }
      const int c_left = g.c - k * kStageCh;
      const uint16_t* plane0 = xs + ((int64_t)it.n * g.c + k * kStageCh) * g.ph * g.pw;
      const int xa = ox > 0 ? ox : 0;
      const int xb = ox + g.cols < g.pw ? ox + g.cols : g.pw;
      // this thread's copies (at most 2: 16 x 12 rows at dilation 4)
      const void* src[2] = {nullptr, nullptr};
      char* dst[2] = {nullptr, nullptr};
      unsigned bytes[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // copies dealt out across the warps first (each issues its lanes'
        // copies one after another)
        const int r = (pt & 31) * (kProducers / 32) + (pt >> 5) + j * kProducers;
        if (r >= kStageCh * g.rows) continue;
        const int ch = r / g.rows;
        const int hr = r - ch * g.rows;
        const int y = oy + hr;
        if (ch >= c_left || y < 0 || y >= g.ph || xa >= xb) continue;
        const char* row =
            reinterpret_cast<const char*>(plane0 + ((int64_t)ch * g.ph + y) * g.pw);
        const uintptr_t p0 = reinterpret_cast<uintptr_t>(row + 2 * xa);
        const uintptr_t p1 = reinterpret_cast<uintptr_t>(row + 2 * xb);
        const uintptr_t a16 = p0 & ~uintptr_t(15);
        const uintptr_t e16 = (p1 + 15) & ~uintptr_t(15);
        dst[j] = base + ch * g.raw_cs + hr * g.pitch;
        tab[ch * g.rows + hr] =
            ch * g.raw_cs + hr * g.pitch + (int)(reinterpret_cast<intptr_t>(row + 2 * ox) -
                                                 (intptr_t)a16);
        if (a16 < x_lo || e16 > x_hi) {
          for (uintptr_t q = p0; q < p1; q += 2)
            *reinterpret_cast<uint16_t*>(dst[j] + (q - a16)) =
                *reinterpret_cast<const uint16_t*>(q);
        } else {
          bytes[j] = (unsigned)(e16 - a16);
          src[j] = reinterpret_cast<const void*>(a16);
        }
      }
      __syncwarp();  // the warp's plain stores, before its arrival
      const unsigned warp_bytes = __reduce_add_sync(0xffffffffu, bytes[0] + bytes[1]);
      if (lane == 0) mbar_arrive_tx(&raw_bar[slot], warp_bytes);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (bytes[j]) bulk_copy(dst[j], src[j], bytes[j], &raw_bar[slot]);
    };

    // raw slot -> operand slot [chunk][halo row][column][8 channels], zero
    // outside the plane: tasks of (chunk, halo row, column group) dealt out
    // flat (lanes along a row's columns), each task the 8 channels of 2
    // columns (4-byte reads, where rows are even-width and x 4-byte
    // aligned) or of 1 column; every walk advanced by additions
    const int per_task = g.pairs ? 2 : 1;
    const int groups = g.cols / per_task;  // column groups per (chunk, halo row)
    const int n_tasks = 2 * g.rows * groups;
    const int gr_first = pt % groups, r_first = pt / groups;
    const int gr_step = kProducers % groups, r_step = kProducers / groups;
    auto transpose = [&](int raw_slot, int tr_slot, const Item& it, int k) {
      const char* raw = smem + g.raw_off + raw_slot * g.raw_stage;
      const int* tab = reinterpret_cast<const int*>(raw + g.tab_off);
      char* tr = smem + g.tr_off + tr_slot * g.tr_stage;
      const int ox = it.x0 - g.pad - g.shift;
      const int oy = it.y0 - g.pad;
      const int c_left = g.c - k * kStageCh;  // channels of the stage inside c
      int gr = gr_first, r = r_first;
      for (int t = pt; t < n_tasks; t += kProducers) {
        const int chunk = r >= g.rows, hr = r - chunk * g.rows;
        const int col = gr * per_task;
        const int x = ox + col;
        const bool ok_xy = oy + hr >= 0 && oy + hr < g.ph && x >= 0 && x < g.pw;
        unsigned v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ch = chunk * 8 + e;
          const char* at = raw + tab[ch * g.rows + hr] + 2 * col;
          if (!ok_xy || ch >= c_left) {
            v[e] = 0u;
          } else if (per_task == 2) {  // both columns inside (x and pw even)
            v[e] = *reinterpret_cast<const unsigned*>(at);
          } else {
            v[e] = *reinterpret_cast<const uint16_t*>(at);
          }
        }
        char* out = tr + chunk * g.tr_chunk + (hr * g.cols + col) * 16;
        *reinterpret_cast<uint4*>(out) =
            make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                       __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
        if (per_task == 2)
          *reinterpret_cast<uint4*>(out + 16) =
              make_uint4(__byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632),
                         __byte_perm(v[4], v[5], 0x7632), __byte_perm(v[6], v[7], 0x7632));
        gr += gr_step;
        r += r_step;
        if (gr >= groups) {
          gr -= groups;
          ++r;
        }
      }
    };

    WeightLoader<kN, kProducers> wl{{}, w, w_f32, co, co0, g.c, pt, g.wvec};
    if (g.resident && n_stages > 0)
      for (int k = 0; k < g.nk; ++k) wl.load(k, smem + g.b_off + k * g.b_step);
    if (map != nullptr && pt == 0)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
    // the load cursor runs kLook stages ahead of the transpose cursor
    int load_li = 0, load_k = 0;
    Item load_it = item_at(g, base_n, first);
    auto load_next = [&](int s_load) {
      if (s_load >= n_stages) return;
      load_raw(s_load % kLook, load_it, load_k);
      if (++load_k == g.nk) {
        load_k = 0;
        if (++load_li < n_items) load_it = item_at(g, base_n, first + load_li * stride);
      }
    };
#pragma unroll 1
    for (int s = 0; s < kLook; ++s) load_next(s);
    Item it = item_at(g, base_n, first);
    int k = 0, li = 0;
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s) {
      mbar_wait(&raw_bar[s % kLook], s / kLook & 1);
      if (s >= 2) mbar_wait(&empty_bar[s & 1], (s - 2) >> 1 & 1);
      transpose(s % kLook, s & 1, it, k);
      if (!g.resident) wl.load(k, smem + g.b_off + (s & 1) * g.b_step);
      fence_proxy_async();
      mbar_arrive(&full_bar[s & 1]);
      producer_sync<kProducers>();  // every producer is done with raw slot s % kLook
      load_next(s + kLook);
      if (++k == g.nk) {
        k = 0;
        if (++li < n_items) it = item_at(g, base_n, first + li * stride);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers ---
  float acc[kRowsPerWg][kN / 2];
#pragma unroll
  for (int i = 0; i < kRowsPerWg; ++i)
#pragma unroll
    for (int r = 0; r < kN / 2; ++r) acc[i][r] = 0.f;
  int s = 0;
#pragma unroll 1
  for (int li = 0; li < n_items; ++li) {
#pragma unroll 1
    for (int k = 0; k < g.nk; ++k, ++s) {
      mbar_wait(&full_bar[s & 1], s >> 1 & 1);
      const char* a_base = smem + g.tr_off + (s & 1) * g.tr_stage;
      const char* b_base = smem + g.b_off + (g.resident ? k : (s & 1)) * g.b_step;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const uint64_t db = make_desc(smem_u32(b_base + tap * 2 * kN * 16), kN * 16, 128);
#pragma unroll
        for (int i = 0; i < kRowsPerWg; ++i) {
          const int hr = i + dy * g.d;
          const uint64_t da = make_desc(
              smem_u32(a_base + (hr * g.cols + g.shift + dx * g.d) * 16), g.tr_chunk, 128);
          wgmma<kN>(acc[i], da, db, k == 0 && tap == 0 ? 0 : 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage s - 1's products are done
      if (k > 0) mbar_arrive(&empty_bar[(s - 1) & 1]);
    }
    wgmma_wait<0>();
    mbar_arrive(&empty_bar[(s - 1) & 1]);  // the item's last stage
#pragma unroll
    for (int i = 0; i < kRowsPerWg; ++i) reg_fence<kN / 2>(acc[i]);
    epi(acc, li, item_at(g, base_n, first + li * stride), li == n_items - 1);
  }
}

}  // namespace conv_bf16
