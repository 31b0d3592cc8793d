"""Build variants of the 3x3 convolution kernels and measure them on a card.

    python -m michigan_tpu_torch.tools.tile_variants [--only A,B] [--check]

The design choices of ``csrc/conv3x3_tile.cuh`` (the float32 tile of both
convolutions), ``csrc/conv3x3_bf16.cuh`` (conv_lowch's bf16 tile) and of the
kernels around them (``conv_lowch.cu``, ``conv_in_act.cu``: its bf16 form has
a tile of its own) are each one textual change away from the built sources:
VARIANTS lists them as (file, text, replacement) edits; BF16_VARIANTS names
those measured on the bf16 kernels.  Every variant is
compiled with the port's nvcc flags and ``-Xptxas -v`` into
``michigan_tpu_torch/_build/variants/v<i>/`` (all nvcc processes started
together), loaded with ctypes and run at the paths' shapes:

- conv3x3_same_lowch at VGG19 features_2's (16, 64, 512^2), float32 and bf16;
- conv3x3_in_act at the inpainters' (1, 256, 64^2), dilation 2 with relu and
  dilation 1 with a residual, in float32 and in bfloat16 (the bf16 policy's
  form: bf16 x_pad and residual, the float32 weight rounded in the kernel).

For each bf16 variant first: the kernels against their plain versions at
their edges (LOWCH_EDGES, IN_ACT_EDGES; atol 1e-2, rtol 1.6e-2), then, for
every variant, the largest error against a float64 convolution at batch 2 of
those shapes over the largest magnitude, beside F.conv2d's (float32, TF32
off; bf16) and cuDNN's bf16 conv + the torch norm, and for bf16 the share of
outputs that are not float64's value rounded to bf16; and in_act's blocks
per plane at the edit's shape.  ``--check`` stops there.  Then the
card's mma.sync rates (m16n8k8 TF32, m16n8k16 bf16), and device times (20
calls replayed in a CUDA graph, median of 5), the variants timed in turns
(forward, then backward through the list), float32 variants on the float32
kernels and bf16 ones on the bf16 kernels, the library routes before and
after them; last the device time of each kernel of the package's own build
per call (torch.profiler).  The bf16 variants: lowch's wgmma against an
mma.sync form of the same staging, ring depths, a tile per block against the
persistent grid, streamed against resident weights; in_act's ring depth and
blocks per plane; a time-stamp probe of in_act's phases; the "diag:"
variants each remove one part of the work (their results are wrong) to
show where the time goes.
Prints the card's name and power limit first.  Needs a CUDA card and nvcc;
exits 1 without them.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

# the mma.sync m16n8k16 form of conv3x3_bf16.cuh's products: ldmatrix
# fragments from the same shared memory (the tool's "lowch mma.sync")
MMA_SYNC_HELPERS = r"""
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

"""
WGMMA_STAGE = """      wgmma_fence();
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
"""
MMA_SYNC_STAGE = """      if (k == 0) {
#pragma unroll
        for (int i = 0; i < kRowsPerWg; ++i)
#pragma unroll
          for (int r = 0; r < kN / 2; ++r) acc[i][r] = 0.f;
      }
      const int wq = (tid >> 5) & 3;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        unsigned bf[kN / 16][4];  // n8 tiles 2jj, 2jj + 1: {b0, b1} each
#pragma unroll
        for (int jj = 0; jj < kN / 16; ++jj)
          ldmatrix_x4(bf[jj], smem_u32(b_base + ((tap * 2 + ((lane >> 3) & 1)) * kN +
                                                 16 * jj + 8 * (lane >> 4) + (lane & 7)) * 16));
#pragma unroll
        for (int i = 0; i < kRowsPerWg; ++i) {
          const int hr = i + dy * g.d;
          const int px = g.shift + dx * g.d + 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1);
          unsigned af[4];
          ldmatrix_x4(af, smem_u32(a_base + (lane >> 4) * g.tr_chunk + (hr * g.cols + px) * 16));
#pragma unroll
          for (int jj = 0; jj < kN / 16; ++jj) {
            mma_bf16(&acc[i][8 * jj], af, bf[jj][0], bf[jj][1]);
            mma_bf16(&acc[i][8 * jj + 4], af, bf[jj][2], bf[jj][3]);
          }
        }
      }
"""
# conv_lowch's halo copies and TMA boxes of no bytes (their barriers kept)
LOWCH_NO_HALO = [
    ("conv3x3_bf16.cuh", "          bytes[j] = (unsigned)(e16 - a16);", "          bytes[j] = 0;"),
    ("conv3x3_bf16.cuh", "pt == 0 ? kStageCh * g.rows * g.cols * 2 : 0", "0"),
    ("conv3x3_bf16.cuh",
     "        if (pt == 0) tma_load_4d(base, map, ox, oy, k * kStageCh, it.n, &raw_bar[slot]);\n",
     "")]
IN_ACT_NO_PRODUCTS = ("conv_in_act.cu",
                      "cb::wgmma<kN16>(acc[i], da, db, k == 0 && tap == 0 ? 0 : 1);",
                      "if (da == db) acc[i][0] += 1.f;")
# conv_in_act's bf16 copies not issued, their stage barriers expecting no bytes
IN_ACT_NO_COPIES = [
    ("conv_in_act.cu",
     "      cb::mbar_arrive_tx(&full_bar[slot], g.a_stage + kBStage);\n      cb::tma_load_4d(",
     "      cb::mbar_arrive_tx(&full_bar[slot], 0);\n      if (k < 0) cb::tma_load_4d("),
    ("conv_in_act.cu", "      cb::bulk_copy(base + g.a_stage,",
     "      if (k < 0) cb::bulk_copy(base + g.a_stage,")]

# conv_in_act's bf16 form with time stamps: thread 0 of every block writes
# %globaltimer at its start (0), after its products (1), before the
# statistics' exchange (2), once its plane's blocks have all arrived (3), once
# the plane's statistics are merged (4) and after its stores (5), and its
# %smid (7), into a device array that in_act_probe copies out
IN_ACT_PROBE = [
    ("conv_in_act.cu", "namespace cb = conv_bf16;\n",
     "namespace cb = conv_bf16;\n"
     "__device__ unsigned long long g_probe[4096][8];\n"
     "__device__ __forceinline__ void probe(int p) {\n"
     "  if (threadIdx.x != 0) return;\n"
     "  unsigned long long t;\n"
     "  unsigned sm;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "  const unsigned b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     "  if (b < 4096) { g_probe[b][p] = t; g_probe[b][7] = sm; }\n"
     "}\n"),
    ("conv_in_act.cu", "  if (tid < kN16) epi.load_bias(s_bias);\n  __syncthreads();\n",
     "  if (tid < kN16) epi.load_bias(s_bias);\n  __syncthreads();\n  probe(0);\n"),
    ("conv_in_act.cu", "  // the item's last stage\n",
     "  // the item's last stage\n    probe(1);\n"),
    ("conv_in_act.cu", "    const int plane = blockIdx.z * gridDim.y + blockIdx.y;\n",
     "    probe(2);\n    const int plane = blockIdx.z * gridDim.y + blockIdx.y;\n"),
    ("conv_in_act.cu", "    cb::consumer_sync();\n    // thread (group g, channel m) merges",
     "    cb::consumer_sync();\n    probe(3);\n    // thread (group g, channel m) merges"),
    ("conv_in_act.cu", "    cb::consumer_sync();  // s_stat complete\n",
     "    cb::consumer_sync();  // s_stat complete\n    probe(4);\n"),
    ("conv_in_act.cu", "    // the block's earlier tiles, from the pre-norm plane\n",
     "    probe(5);\n    // the block's earlier tiles, from the pre-norm plane\n"),
    ("conv_in_act.cu", "}  // extern \"C\"\n",
     "int in_act_probe(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));\n}\n\n"
     "}  // extern \"C\"\n")]

# name: its edits, each a (file, text, replacement)
VARIANTS = {
    "as built": [],
    # the conversion instruction instead of its integer form
    "cvt.rna split": [(
        "tf32x3.cuh",
        "  const unsigned big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
        '  unsigned big;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));\n')],
    # small rounded to TF32 too, in the same integer form
    "small rounded": [(
        "tf32x3.cuh",
        "  return make_uint2(big, __float_as_uint(x - __uint_as_float(big)));\n",
        "  return make_uint2(big, (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) &"
        " 0xffffe000u);\n")],
    # one tensor-core chain per output over all of K: no per-step flush
    "one chain": [
        ("conv3x3_tile.cuh",
         "    float part[kMT][kNT][4];  // this step's chain: written first at tap 0\n",
         "    float (&part)[kMT][kNT][4] = acc;\n"),
        ("conv3x3_tile.cuh",
         "            mma_tf32_first(part[i][j], a_small[i], b_big[j]);\n",
         "            mma_tf32(part[i][j], a_small[i], b_big[j]);\n"),
        ("conv3x3_tile.cuh",
         "        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];\n",
         "        for (int r = 0; r < 4; ++r) {}\n")],
    "4-byte halo copies": [(
        "conv3x3_tile.cuh", "  for (int v = 4; v > 1; v /= 2)\n",
        "  for (int v = 1; v > 1; v /= 2)\n")],
    "8-byte halo copies": [(
        "conv3x3_tile.cuh", "  for (int v = 4; v > 1; v /= 2)\n",
        "  for (int v = 2; v > 1; v /= 2)\n")],
    "in_act one group": [(
        "conv_in_act.cu", "constexpr int kGroups = 2;\n", "constexpr int kGroups = 1;\n")],
    "in_act one group, 6 stages": [
        ("conv_in_act.cu", "constexpr int kGroups = 2;\n", "constexpr int kGroups = 1;\n"),
        ("conv_in_act.cu", "constexpr int kStages = 3;\n", "constexpr int kStages = 6;\n")],
    "lowch two groups": [(
        "conv_lowch.cu", "constexpr int kGroups = 1;\n", "constexpr int kGroups = 2;\n")],
    # the halo's channel stride left at rows x cols words, 0 mod 32 at
    # dilation 2: the A-fragment loads of the 4 channels collide
    "unpadded channel stride": [(
        "conv3x3_tile.cuh", "  g.cs = ((g.rows * g.cols - 8 + 31) / 32) * 32 + 8;",
        "  g.cs = g.rows * g.cols;")],
    # the bf16 tile of conv_lowch (conv3x3_bf16.cuh): the product, ring
    # depths, the persistent grid, resident weights; conv_in_act's bf16
    # form: its ring, its blocks per plane
    "lowch mma.sync": [
        ("conv3x3_bf16.cuh",
         "// ----------------------------------------------------------- geometry ---\n",
         MMA_SYNC_HELPERS
         + "// ----------------------------------------------------------- geometry ---\n"),
        ("conv3x3_bf16.cuh", WGMMA_STAGE, MMA_SYNC_STAGE)],
    "lowch ring 2": [(
        "conv_lowch.cu", "constexpr int kLook = 3;", "constexpr int kLook = 2;")],
    "lowch ring 4": [(
        "conv_lowch.cu", "constexpr int kLook = 3;", "constexpr int kLook = 4;")],
    "lowch a tile per block": [(
        "conv_lowch.cu", "  int64_t per = sms / co_blocks;\n", "  int64_t per = items;\n")],
    "lowch streamed weights": [(
        "conv_lowch.cu", "kStgBytes, true);", "kStgBytes, false);")],
    # the mbarrier waits sleep 64 ns between tries instead of spinning
    "waits sleep between tries": [(
        "conv3x3_bf16.cuh", '"@!done bra LAB_WAIT;\\n}\\n"',
        '"@done bra LAB_DONE;\\nnanosleep.u32 64;\\nbra LAB_WAIT;\\nLAB_DONE:\\n}\\n"')],
    "lowch one producer warpgroup": [(
        "conv_lowch.cu", "constexpr int kProd = 256;", "constexpr int kProd = 128;")],
    # lowch's halo row by row (bulk copies) instead of one tensor-map box
    "lowch rows copied": [(
        "conv_lowch.cu", "  const int use_map = uses_map(x, w);", "  const int use_map = 0;")],
    "lowch 32 channels a block": [(
        "conv_lowch.cu", "constexpr int kN16 = 64;", "constexpr int kN16 = 32;")],
    # in_act's ring of operand stages (as built: as many as 108 KB hold, at
    # most 6: 4 at dilation 2, 5 at dilation 1); one block an SM (a ring of
    # 6 stages); 8 blocks a plane (two tiles each, the first through the
    # pre-norm plane)
    "in_act ring 2": [(
        "conv_in_act.cu", "constexpr int kRingMax = 6;", "constexpr int kRingMax = 2;")],
    "in_act ring 3": [(
        "conv_in_act.cu", "constexpr int kRingMax = 6;", "constexpr int kRingMax = 3;")],
    "in_act one block an SM": [(
        "conv_in_act.cu", "constexpr int kRingBytes = 110592;",
        "constexpr int kRingBytes = 180000;")],
    "in_act 8 blocks a plane": [(
        "conv_in_act.cu", "constexpr int kMaxBlocks = 16;", "constexpr int kMaxBlocks = 8;")],
    "probe: in_act time stamps": IN_ACT_PROBE,
    # diagnostics, not designs (their results are wrong): each removes one
    # part of the work to show what it costs
    "diag: no main loop": [(
        "conv3x3_tile.cuh", "  for (int s = 0; s < nstages; ++s) {\n",
        "  for (int s = 0; s < 0; ++s) {\n")],
    "diag: no loads in the loop": [(
        "conv3x3_tile.cuh", "    if (next < nstages) load_stage(next, next % kStages);\n", "")],
    "diag: no global reads": [
        ("conv3x3_tile.cuh", "          cp_async16(dst, src, ok);\n",
         "          cp_async16(dst, in.x, false);\n"),
        ("conv3x3_tile.cuh",
         "cp_async16(s_w + m * g.ws + q, ok ? w + ((int64_t)(co0 + m) * c + ci0) * 9 + q : w, ok);",
         "cp_async16(s_w + m * g.ws + q, w, false);")],
    "diag: empty conv pass": [(
        "conv_in_act.cu", "  extern __shared__ __align__(16) float smem[];\n",
        "  extern __shared__ __align__(16) float smem[];\n  if (a.c > 0) return;\n")],
    "diag: no conv epilogue": [(
        "conv_in_act.cu",
        "  // epilogue: bias, pre-norm store, and the patch's statistics per channel\n",
        "  if (a.c > 0) {\n    if (acc[0][0][0] == 1234.5f) a.y[0] = 1.f;\n    return;\n  }\n")],
    # conv_lowch's bf16 tile without its products (the descriptors kept
    # live), its halo reads (zero-filled copies), its weight reads, its
    # transposes; with no staging at all (the mbarrier hand-offs kept), and
    # that without products too
    "diag: lowch no products": [
        ("conv3x3_bf16.cuh", "wgmma<kN>(acc[i], da, db, k == 0 && tap == 0 ? 0 : 1);",
         "if (da == db) acc[i][0] += 1.f;")],
    "diag: lowch no halo reads": LOWCH_NO_HALO,
    "diag: lowch no weight reads": [
        ("conv3x3_bf16.cuh", "reg[j] = ok ? __ldg(src) : make_uint4(0, 0, 0, 0);",
         "reg[j] = make_uint4(0, 0, 0, 0);")],
    "diag: lowch no transposes": [
        ("conv3x3_bf16.cuh", "      for (int t = pt; t < n_tasks; t += kProducers) {",
         "      for (int t = pt; t < 0; t += kProducers) {")],
    "diag: lowch no producer work": LOWCH_NO_HALO + [
        ("conv3x3_bf16.cuh",
         "      transpose(s % kLook, s & 1, it, k);\n      if (!g.resident) wl.load(",
         "      if (false) wl.load(")],
    "diag: lowch barriers and epilogue only": LOWCH_NO_HALO + [
        ("conv3x3_bf16.cuh",
         "      transpose(s % kLook, s & 1, it, k);\n      if (!g.resident) wl.load(",
         "      if (false) wl.load("),
        ("conv3x3_bf16.cuh", "wgmma<kN>(acc[i], da, db, k == 0 && tap == 0 ? 0 : 1);",
         "if (da == db) acc[i][0] += 1.f;")],
    # conv_in_act's bf16 form without its layout pass (the buffers left as
    # they are, the counters still zeroed), its products, its copies (the
    # stage barriers still arrived on), or both
    "diag: in_act no layout pass": [
        ("conv_in_act.cu",
         "    const int u = 2 * (blockIdx.x * kLayoutThreads + tid);\n    if (u >= hw) return;",
         "    return;"),
        ("conv_in_act.cu", "  if (blockIdx.x != 0) return;\n  const int cob",
         "  return;\n  const int cob")],
    "diag: in_act no products": [IN_ACT_NO_PRODUCTS],
    "diag: in_act no copies": IN_ACT_NO_COPIES,
    # ... its convolution kernel returning at once (the launch), without its
    # epilogue, and without waiting for the plane's other blocks
    "diag: in_act empty kernel": [
        ("conv_in_act.cu", "  const Geo16& g = a.g;\n  const int tid = threadIdx.x;\n",
         "  if (a.co > 0) return;\n  const Geo16& g = a.g;\n  const int tid = threadIdx.x;\n")],
    "diag: in_act no epilogue": [
        ("conv_in_act.cu",
         "    epi(acc, li, cb::item_at(g, blockIdx.z, first + li * stride), li == n_items - 1);",
         "    if (acc[0][0] == 1234.5f) a.out[0] = 1;")],
    "diag: in_act barriers and epilogue only": IN_ACT_NO_COPIES + [IN_ACT_NO_PRODUCTS],
    "diag: in_act no wait for the plane": [
        ("conv_in_act.cu", "        if (arrived >= gridDim.x) break;", "        break;")],
    # conv_lowch's epilogue reads no sum (a test of what makes ptxas
    # serialise its wgmmas)
    "diag: lowch epilogue reads no sums": [
        ("conv_lowch.cu", "cb::bf16_bits(acc[i][4 * j + 2 * hh + e]);", "0u;")],
    # conv_lowch's epilogue without its add of 0 before the first read of
    # each sum: ptxas then serialises the kernel's wgmmas
    "lowch epilogue without the add": [
        ("conv_lowch.cu", "      for (int r = 0; r < kN16 / 2; ++r) acc[i][r] += 0.f;\n",
         "      for (int r = 0; r < kN16 / 2; ++r) {}\n")],
    "diag: bf16 no stores": [
        ("conv_lowch.cu",
         "        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);\n",
         "        if (src[0] == 1 && src[15] == 2) *dst = 0;\n"),
        ("conv_in_act.cu",
         "        *reinterpret_cast<uint4*>(a.out + at) = "
         "make_uint4(ow[0], ow[1], ow[2], ow[3]);\n",
         "        if (ow[0] == 0x12345u && ow[3] == 7u) a.out[at] = 0;\n")],
}

# the variants measured on the bf16 kernels (the others on the float32 ones;
# "as built" on both)
BF16_VARIANTS = {
    "as built", "diag: bf16 no stores", "diag: in_act barriers and epilogue only",
    "diag: in_act empty kernel", "diag: in_act no copies", "diag: in_act no epilogue",
    "diag: in_act no layout pass", "diag: in_act no products", "diag: in_act no wait for the plane",
    "diag: lowch barriers and epilogue only", "diag: lowch epilogue reads no sums",
    "diag: lowch no halo reads", "diag: lowch no producer work", "diag: lowch no products",
    "diag: lowch no transposes", "diag: lowch no weight reads", "in_act 8 blocks a plane",
    "in_act one block an SM", "in_act ring 2", "in_act ring 3", "lowch 32 channels a block",
    "lowch a tile per block", "lowch epilogue without the add", "lowch mma.sync",
    "lowch one producer warpgroup", "lowch ring 2", "lowch ring 4", "lowch rows copied",
    "lowch streamed weights", "probe: in_act time stamps", "waits sleep between tries",
}

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
// kBf16: m16n8k16 bf16 (K = 16), else m16n8k8 TF32 (K = 8)
template <bool kBf16>
__global__ void mma_loop(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (kBf16) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[t][0]), "+f"(d[t][1]), "+f"(d[t][2]), "+f"(d[t][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[t][0]), "+f"(d[t][1]), "+f"(d[t][2]), "+f"(d[t][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int t = 0; t < 8; ++t) s += d[t][0] + d[t][1] + d[t][2] + d[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// TFLOP/s of `blocks` x `threads` threads, each warp 8 independent chains
template <bool kBf16>
float tflops(int blocks, int threads, int iters) {
  float* out;
  if (cudaMalloc(&out, sizeof(float) * blocks * threads) != cudaSuccess) return -1.f;
  mma_loop<kBf16><<<blocks, threads>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  mma_loop<kBf16><<<blocks, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return -1.f;
  const double k = kBf16 ? 16 : 8;
  return (float)(2.0 * 16 * 8 * k * 8 * (double)iters * (blocks * threads / 32) / (ms * 1e9));
}
extern "C" float mma_tflops(int blocks, int threads, int iters) {
  return tflops<false>(blocks, threads, iters);
}
extern "C" float mma_tflops_bf16(int blocks, int threads, int iters) {
  return tflops<true>(blocks, threads, iters);
}
"""

LIBS = ("conv_lowch", "conv_in_act")
EPI_CASES = ((2, "relu", False), (1, None, True))  # (dilation, act, residual)


def patched_sources(edits, dst: Path, csrc: Path) -> None:
    """Copy csrc's sources into dst with the variant's edits applied; each
    edited text must occur exactly once."""
    dst.mkdir(parents=True, exist_ok=True)
    files = {p.name: p.read_text() for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")}
    for name, old, new in edits:
        if files[name].count(old) != 1:
            raise ValueError(f"{name}: the text to replace occurs {files[name].count(old)} times: "
                             f"{old!r}")
        files[name] = files[name].replace(old, new)
    for name, text in files.items():
        (dst / name).write_text(text)


def ptxas_report(stderr: str) -> list:
    """One line per kernel from `-Xptxas -v`: its (mangled) name, registers,
    barriers, shared memory, stack and spills; and every line that speaks of
    wgmma (ptxas says when it serialises them)."""
    lines = [s.strip().removeprefix("ptxas info    : ") for s in stderr.splitlines()]
    return [f"{name.removeprefix('Function properties for ')}: {used}; {spill}"
            for name, spill, used in zip(lines, lines[1:], lines[2:])
            if name.startswith("Function properties for ") and used.startswith("Used ")] + \
        [s for s in lines if "wgmma" in s]


def build_variants(build, names) -> tuple:
    """{(variant, lib): ctypes.CDLL}, and {"mma": CDLL} for the peak kernel;
    {(variant, lib): ptxas report lines}; {variant: nvcc's error} for the
    variants that do not build."""
    root = build.BUILD_DIR / "variants"
    procs = []
    nvcc = build.nvcc_path()
    for i, name in enumerate(names):
        src = root / f"v{i}"
        patched_sources(VARIANTS[name], src, build.CSRC_DIR)
        for lib in LIBS:
            out = src / f"{lib}.so"
            cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                   str(src / f"{lib}.cu")]
            procs.append(((name, lib), out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    (root / "mma_peak.cu").write_text(MMA_PEAK_CU)
    out = root / "mma_peak.so"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-o", str(out), str(root / "mma_peak.cu")]
    procs.append(("mma", out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
    libs, ptxas, failed = {}, {}, {}
    for key, path, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            if key == "mma" or key[0] == "as built":
                raise RuntimeError(f"nvcc failed for {key}:\n{err}")
            failed[key[0]] = err[-3000:]
            continue
        lib = ctypes.CDLL(str(path))
        if key == "mma":
            for fn in (lib.mma_tflops, lib.mma_tflops_bf16):
                fn.restype = ctypes.c_float
                fn.argtypes = [ctypes.c_int] * 3
        else:
            for fn, argtypes in build.SIGNATURES[key[1]].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            ptxas[key] = ptxas_report(err)
        libs[key] = lib
    return libs, ptxas, failed


def median_ms(fn, torch, inner=20, reps=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# the bf16 kernels' edges, each against its plain version (--check and
# every run): lowch (n, c, co, h, w): ragged tiles, odd C and W, Co over one
# block, C too large for resident weights, fewer tiles than SMs; in_act (n,
# c, co, h, w, d, act, residual): ragged planes, odd C, dilation 1, 2 and 4,
# a plane of more tiles than blocks (the pre-norm form), batch > 1
LOWCH_EDGES = [(2, 64, 64, 37, 53), (1, 3, 70, 10, 11), (3, 12, 72, 9, 66),
               (1, 160, 64, 20, 70), (1, 64, 64, 8, 64)]
IN_ACT_EDGES = [(1, 20, 70, 9, 7, 2, "relu", True), (2, 20, 40, 13, 30, 2, "lrelu", False),
                (1, 64, 72, 37, 53, 1, "relu", True), (3, 7, 64, 4, 32, 2, None, True),
                (2, 16, 24, 80, 80, 1, "relu", True), (1, 32, 32, 16, 16, 4, None, False)]
ACT_CODES = {None: 0, "relu": 1, "lrelu": 2}


def print_probe(v, lib, inputs, in_act, torch, card) -> None:
    """The time stamps of a "probe:" variant's in_act call at batch 1 of the
    edit's shapes: per phase the median and largest duration over the
    blocks, the blocks' start spread, and how many SMs hold two blocks."""
    import ctypes

    lib.in_act_probe.argtypes = [ctypes.c_void_p]
    lib.in_act_probe.restype = ctypes.c_int
    for d, act, _ in EPI_CASES:
        x, w, b, r = inputs[d]
        x, r = x[:1].bfloat16(), None if r is None else r[:1].bfloat16()
        out = torch.empty((1, 256, 64, 64), device="cuda", dtype=torch.bfloat16)
        for _ in range(3):
            in_act(v, x, w, b, d, act, r, out)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4096 * 8))()
        build_err = lib.in_act_probe(ctypes.addressof(buf))
        if build_err != 0:
            print(f"{v}: in_act_probe failed: cudaError {build_err}", flush=True)
            return
        blocks = [[buf[8 * i + p] for p in range(8)] for i in range(128)]
        t0 = min(b_[0] for b_ in blocks)
        phase = lambda p, q: sorted((b_[q] - b_[p]) / 1e3 for b_ in blocks)
        sms = [b_[7] for b_ in blocks]
        shared = sum(1 for s_ in set(sms) if sms.count(s_) > 1)
        parts = [("start after the first", 0, None), ("products", 0, 1), ("stats", 1, 2),
                 ("wait for the plane", 2, 3), ("merge", 3, 4), ("stores", 4, 5),
                 ("end after the first start", None, 5)]
        text = []
        for name, p, q in parts:
            ts = sorted((b_[0] - t0) / 1e3 for b_ in blocks) if q is None else \
                sorted((b_[5] - t0) / 1e3 for b_ in blocks) if p is None else phase(p, q)
            text.append(f"{name} {statistics.median(ts):.2f} / {ts[-1]:.2f}")
        print(f"{v} dilation {d}: us, median / largest over the 128 blocks: "
              f"{'; '.join(text)}; SMs holding two blocks: {shared} [{card}]", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated variants to build beside "
                    "'as built' (default: all)")
    ap.add_argument("--check", action="store_true", help="build, print ptxas's report and "
                    "hold the bf16 kernels against their plain versions and float64; no timing")
    args = ap.parse_args(argv)
    names = ["as built"] + [v for v in (args.only.split(",") if args.only else VARIANTS)
                            if v and v != "as built"]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        print(f"FAIL: no variant {unknown}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.ops.cuda import epilogue as E
    from michigan_tpu_torch.ops.cuda import lowch as L
    from michigan_tpu_torch.ops.cuda.spade import _act
    from michigan_tpu_torch.ops.norms import instance_norm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, ptxas, failed = build_variants(build, names)
    for v, err in failed.items():
        print(f"nvcc failed for {v}:\n{err}", flush=True)
    names = [v for v in names if v not in failed]
    for (v, lib), kernels in ptxas.items():
        print(f"ptxas {v} {lib}: {' | '.join(kernels)}", flush=True)
    fp32 = [v for v in names if v == "as built" or v not in BF16_VARIANTS]
    bf16 = [v for v in names if v in BF16_VARIANTS]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def lowch(v, x, w, out):
        n, c, h, wd = x.shape
        lib = libs[(v, "conv_lowch")]
        if x.dtype == torch.bfloat16:
            err = lib.conv3x3_same_bf16(x.data_ptr(), w.data_ptr(), int(w.dtype == torch.float32),
                                        out.data_ptr(), n, c, w.shape[0], h, wd, stream())
        else:
            err = lib.conv3x3_same_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, c,
                                       w.shape[0], h, wd, stream())
        build.check_launch(v, err)

    def in_act(v, x, w, b, d, act, r, out, scratch=None):
        n, c, hp, wp = x.shape
        h, wd, co = hp - 2 * d, wp - 2 * d, w.shape[0]
        lib = libs[(v, "conv_in_act")]
        r_ptr = None if r is None else r.data_ptr()
        if x.dtype == torch.bfloat16:
            pre = torch.empty((n, co, h, wd), device="cuda") \
                if lib.conv3x3_in_act_bf16_prenorm(n, c, co, h, wd, d) else None
            xt, wl, xchg = E.bf16_scratch(n, c, co, hp, wp, x.device)
            err = lib.conv3x3_in_act_bf16(
                x.data_ptr(), w.data_ptr(), int(w.dtype == torch.float32), b.data_ptr(),
                int(b.dtype == torch.bfloat16), r_ptr, out.data_ptr(),
                None if pre is None else pre.data_ptr(), xt.data_ptr(), wl.data_ptr(),
                xchg.data_ptr(), n, c, co, h, wd, d, 1e-5, ACT_CODES[act], stream())
        else:
            err = lib.conv3x3_in_act_f32(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), r_ptr, out.data_ptr(),
                scratch.data_ptr(), scratch.numel(), n, c, co, h, wd, d, 1e-5, ACT_CODES[act],
                stream())
        build.check_launch(v, err)

    def rel(got, want64):
        return ((got.double() - want64).abs().max() / want64.abs().max()).item()

    def off_rounding(got, want64):
        """The share of bf16 outputs that are not float64's value rounded to bf16."""
        return (got.float() != want64.to(torch.bfloat16).float()).float().mean().item()

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {v: {} for v in names}

    # the bf16 kernels at their edges, against their plain versions
    tol = dict(atol=1e-2, rtol=1.6e-2)
    for v in bf16:
        bad = []
        for n, c, co, h, wd in LOWCH_EDGES:
            x = torch.randn((n, c, h, wd), generator=gen, device="cuda").relu_().bfloat16()
            for w_dtype in (torch.float32, torch.bfloat16):
                w = (torch.randn((co, c, 3, 3), generator=gen, device="cuda")
                     * math.sqrt(2 / (9 * c))).to(w_dtype)
                out = torch.full((n, co, h, wd), float("nan"), device="cuda",
                                 dtype=torch.bfloat16)
                lowch(v, x, w, out)
                if not torch.allclose(out.float(), L.conv3x3_same_lowch_plain(x, w).float(),
                                      **tol):
                    bad.append(("lowch", (n, c, co, h, wd), str(w_dtype)))
        for n, c, co, h, wd, d, act, res in IN_ACT_EDGES:
            x = torch.randn((n, c, h + 2 * d, wd + 2 * d), generator=gen,
                            device="cuda").bfloat16()
            r = torch.randn((n, co, h, wd), generator=gen, device="cuda").bfloat16() \
                if res else None
            for p_dtype in (torch.float32, torch.bfloat16):
                w = (torch.randn((co, c, 3, 3), generator=gen, device="cuda") * 0.05).to(p_dtype)
                b = torch.randn(co, generator=gen, device="cuda").to(p_dtype)
                out = torch.full((n, co, h, wd), float("nan"), device="cuda",
                                 dtype=torch.bfloat16)
                in_act(v, x, w, b, d, act, r, out)
                want = E.conv3x3_in_act_plain(x, w, b, d, act, residual=r)
                if not torch.allclose(out.float(), want.float(), **tol):
                    err = (out.float() - want.float()).abs().max().item()
                    bad.append(("in_act", (n, c, co, h, wd, d, act, res), str(p_dtype), err))
        torch.cuda.synchronize()
        rows[v]["edges"] = "all match their plain versions" if not bad else f"FAIL {bad}"
        print(f"{v:>24}: bf16 edges {rows[v]['edges']} [{card}]", flush=True)

    # float64 errors at batch 2 of the paths' shapes
    w = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * math.sqrt(2 / 576)
    x = torch.randn((2, 64, 512, 512), generator=gen, device="cuda").relu_()
    want = F.conv2d(x.double(), w.double(), padding=1)
    ref = {"lowch": rel(F.conv2d(x, w, padding=1), want)}
    out = torch.empty_like(x)
    for v in fp32:
        lowch(v, x, w, out)
        rows[v]["lowch err"] = rel(out, want)
    x, w = x.bfloat16(), w.bfloat16()
    want = F.conv2d(x.double(), w.double(), padding=1)
    y = F.conv2d(x, w, padding=1)
    ref["lowch16"], ref["lowch16 off"] = rel(y, want), off_rounding(y, want)
    out = torch.empty_like(x)
    for v in bf16:
        lowch(v, x, w, out)
        rows[v]["lowch16 err"], rows[v]["lowch16 off"] = rel(out, want), off_rounding(out, want)
    del x, y, want, out
    inputs = {}
    for d, act, res in EPI_CASES:
        x = torch.randn((2, 256, 64 + 2 * d, 64 + 2 * d), generator=gen, device="cuda")
        w = torch.randn((256, 256, 3, 3), generator=gen, device="cuda") * 0.02
        b = torch.randn(256, generator=gen, device="cuda")
        r = torch.randn((2, 256, 64, 64), generator=gen, device="cuda") if res else None
        inputs[d] = (x, w, b, r)
        want = E.conv3x3_in_act_plain(x.double(), w.double(), b.double(), d, act,
                                      residual=None if r is None else r.double())
        ref[f"in_act d{d}"] = rel(E.conv3x3_in_act_plain(x, w, b, d, act, residual=r), want)
        out = torch.empty((2, 256, 64, 64), device="cuda")
        scratch = torch.empty(2 * 256 * 32 * 3, device="cuda")  # 32 patches of 64^2
        for v in fp32:
            in_act(v, x, w, b, d, act, r, out, scratch)
            rows[v][f"in_act d{d} err"] = rel(out, want)
        # the bf16 form on the same values rounded to bf16; float64 of them,
        # beside cuDNN's bf16 conv + the torch norm (the route it replaces)
        x, r = x.bfloat16(), None if r is None else r.bfloat16()
        want = E.conv3x3_in_act_plain(x.double(), w.bfloat16().double(), b.double(), d, act,
                                      residual=None if r is None else r.double())
        y = _act(instance_norm(F.conv2d(x, w.bfloat16(), b.bfloat16(), dilation=d)), act)
        y = y if r is None else r + y
        ref[f"in_act16 d{d}"], ref[f"in_act16 d{d} off"] = rel(y, want), off_rounding(y, want)
        out = torch.empty((2, 256, 64, 64), device="cuda", dtype=torch.bfloat16)
        for v in bf16:
            in_act(v, x, w, b, d, act, r, out)
            rows[v][f"in_act16 d{d} err"] = rel(out, want)
            rows[v][f"in_act16 d{d} off"] = off_rounding(out, want)
    print(f"float64 error over the largest magnitude (share of bf16 outputs off float64's "
          f"rounding): F.conv2d fp32 {ref['lowch']:.3e}, bf16 {ref['lowch16']:.3e} "
          f"({ref['lowch16 off']:.2e}) (lowch); cuDNN conv + torch norm fp32 "
          f"{ref['in_act d2']:.3e} / {ref['in_act d1']:.3e}, bf16 {ref['in_act16 d2']:.3e} "
          f"({ref['in_act16 d2 off']:.2e}) / {ref['in_act16 d1']:.3e} "
          f"({ref['in_act16 d1 off']:.2e}) (in_act d2 / d1) [{card}]", flush=True)
    for v in bf16:
        row = rows[v]
        blocks = [libs[(v, "conv_in_act")].conv3x3_in_act_bf16_blocks(1, 256, 256, 64, 64, d)
                  for d, _, _ in EPI_CASES]
        print(f"{v:>24}: bf16 errors lowch {row['lowch16 err']:.3e} ({row['lowch16 off']:.2e}), "
              f"in_act d2 {row['in_act16 d2 err']:.3e} ({row['in_act16 d2 off']:.2e}), d1 "
              f"{row['in_act16 d1 err']:.3e} ({row['in_act16 d1 off']:.2e}); in_act blocks a "
              f"plane (1,256,64^2) d2, d1: {blocks} [{card}]", flush=True)
    for v in [v for v in bf16 if v.startswith("probe:")]:
        print_probe(v, libs[(v, "conv_in_act")], inputs, in_act, torch, card)
    if args.check:
        return 0 if all(rows[v]["edges"].startswith("all") for v in bf16) else 1

    for blocks, threads in ((132, 128), (132, 256), (264, 256), (264, 512)):
        print(f"mma.sync m16n8k8 TF32, {blocks} blocks x {threads} threads (8 chains a warp): "
              f"{libs['mma'].mma_tflops(blocks, threads, 20000):.1f} TFLOP/s; m16n8k16 bf16: "
              f"{libs['mma'].mma_tflops_bf16(blocks, threads, 20000):.1f} TFLOP/s [{card}]",
              flush=True)
    # device times at the paths' shapes, the variants in turns (forward, then
    # backward through the list); the library routes beside them
    w = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * math.sqrt(2 / 576)
    x = torch.randn((16, 64, 512, 512), generator=gen, device="cuda").relu_()
    out = torch.empty_like(x)
    ref["lowch ms"] = median_ms(lambda: F.conv2d(x, w, padding=1), torch, inner=5)
    for v in fp32 + fp32[::-1]:
        rows[v].setdefault("lowch ms", []).append(
            median_ms(lambda: lowch(v, x, w, out), torch, inner=5))
    x, w = x.bfloat16(), w.bfloat16()
    out = torch.empty_like(x)
    ref["lowch16 ms"] = [median_ms(lambda: F.conv2d(x, w, padding=1), torch, inner=5)]
    for v in bf16 + bf16[::-1]:
        rows[v].setdefault("lowch16 ms", []).append(
            median_ms(lambda: lowch(v, x, w, out), torch, inner=5))
    ref["lowch16 ms"].append(median_ms(lambda: F.conv2d(x, w, padding=1), torch, inner=5))
    del x, out
    for d, act, res in EPI_CASES:
        x, w, b, r = inputs[d]
        x, r = x[:1].contiguous(), None if r is None else r[:1].contiguous()
        out = torch.empty((1, 256, 64, 64), device="cuda")
        scratch = torch.empty(256 * 32 * 3, device="cuda")
        for v in fp32 + fp32[::-1]:
            rows[v].setdefault(f"in_act d{d} us", []).append(1e3 * median_ms(
                lambda: in_act(v, x, w, b, d, act, r, out, scratch), torch))
        x, r = x.bfloat16(), None if r is None else r.bfloat16()
        out = out.bfloat16()
        w16, b16 = w.bfloat16(), b.bfloat16()
        route = lambda: _act(instance_norm(F.conv2d(x, w16, b16, dilation=d)), act)
        ref[f"in_act16 d{d} us"] = [1e3 * median_ms(route, torch)]
        for v in bf16 + bf16[::-1]:
            rows[v].setdefault(f"in_act16 d{d} us", []).append(1e3 * median_ms(
                lambda: in_act(v, x, w, b, d, act, r, out), torch))
        ref[f"in_act16 d{d} us"].append(1e3 * median_ms(route, torch))
    # device time of each kernel of the package's own build per call
    # (torch.profiler): one kernel per bf16 call, two passes per float32
    # in_act call
    from torch.profiler import ProfilerActivity, profile

    name = lambda key: key.split("::", 1)[-1].split("<")[0].split("(")[0]

    def passes(fn, calls):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return "; ".join(f"{name(e.key)} {e.device_time_total / calls:.2f}"
                         for e in prof.key_averages() if e.device_time_total > 0
                         and "kernel" in e.key)

    x = torch.randn((16, 64, 512, 512), generator=gen, device="cuda").relu_().bfloat16()
    w = (torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * math.sqrt(2 / 576)).bfloat16()
    print(f"passes, bfloat16 lowch (16,64,512^2): "
          f"{passes(lambda: L.conv3x3_same_lowch(x, w), 5)} us a call [{card}]", flush=True)
    del x, w
    for d, act, res in EPI_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b, r = inputs[d]
            x, r = x[:1].to(dtype), None if r is None else r[:1].to(dtype)
            per_call = passes(lambda: E.conv3x3_in_act(x, w, b, dilation=d, act=act, residual=r),
                              20)
            print(f"passes, {str(dtype).removeprefix('torch.')} (1,256,64^2) dilation {d}: "
                  f"{per_call} us a call [{card}]", flush=True)
    times = lambda ts, f: ", ".join(f.format(t) for t in ts)
    print(f"library routes, in turns before and after the variants: F.conv2d fp32 "
          f"{ref['lowch ms']:.3f} ms, bf16 {times(ref['lowch16 ms'], '{:.3f}')} ms (16, 64, "
          f"512^2); cuDNN bf16 conv + torch norm (1, 256, 64^2) d2 "
          f"{times(ref['in_act16 d2 us'], '{:.1f}')} us, d1 "
          f"{times(ref['in_act16 d1 us'], '{:.1f}')}"
          f" us [{card}]", flush=True)
    for v in fp32:
        row = rows[v]
        print(f"{v:>24}: fp32 lowch {times(row['lowch ms'], '{:.3f}')} ms, error "
              f"{row['lowch err']:.3e}; in_act d2 {times(row['in_act d2 us'], '{:.1f}')} us, error "
              f"{row['in_act d2 err']:.3e}; in_act d1 {times(row['in_act d1 us'], '{:.1f}')} us, "
              f"error {row['in_act d1 err']:.3e} [{card}]", flush=True)
    for v in bf16:
        row = rows[v]
        print(f"{v:>24}: bf16 lowch {times(row['lowch16 ms'], '{:.3f}')} ms; in_act d2 "
              f"{times(row['in_act16 d2 us'], '{:.1f}')} us; in_act d1 "
              f"{times(row['in_act16 d1 us'], '{:.1f}')} us [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
