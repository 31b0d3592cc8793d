"""Build variants of the shared 3x3 tensor-core tile and measure them on a card.

    python -m michigan_tpu_torch.tools.tile_variants

The design choices of ``csrc/conv3x3_tile.cuh`` are each one textual change
away from the built sources: VARIANTS lists them as (file, text, replacement)
edits.  Every variant is compiled with the port's nvcc flags into
``michigan_tpu_torch/_build/variants/v<i>/`` (all nvcc processes started
together), loaded with ctypes and run at the paths' shapes:

- conv3x3_same_lowch at VGG19 features_2's (16, 64, 512^2);
- conv3x3_in_act at the inpainters' (1, 256, 64^2), dilation 2 with relu and
  dilation 1 with a residual, in float32 and in bfloat16 (the bf16 policy's
  form: bf16 x_pad and residual, the float32 weight rounded in the kernel).

For each variant: the largest error against a float64 convolution at batch 2
of those shapes, over the largest magnitude (beside F.conv2d's in float32,
TF32 off, and, for the bf16 form, cuDNN's bf16 conv + the torch norm on the
same bf16 inputs), and the device time (20 calls replayed in a CUDA graph,
median of 5), the variants timed in turns (forward, then backward through
the list).  The bf16 tile's variants change its halo layout (the 8 mod 32
pair stride), its copy width (16-byte copies from rows padded to 16 bytes;
8- and 4-byte copies) and its chain length (16-channel steps per fresh
accumulator chain); the "diag:" variants remove one part of the work each
(their results are wrong) to show where the time goes, and the tool prints
each pass's device time (torch.profiler) of the package's own build.  It
also measures the card's mma.sync rates, m16n8k8
TF32 (three products per float32-accurate one) and m16n8k16 bf16, which cap
the tile.  Prints the card's name and power limit first.  Needs a CUDA card
and nvcc; exits 1 without them.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

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
    "in_act one group": [(
        "conv_in_act.cu", "constexpr int kGroups = 2;\n", "constexpr int kGroups = 1;\n")],
    "lowch two groups": [(
        "conv_lowch.cu", "constexpr int kGroups = 1;\n", "constexpr int kGroups = 2;\n")],
    # the halo's channel (bf16: pair) stride left at rows x cols words, 0 mod
    # 32 at dilation 2: the A-fragment loads of the 4 pairs collide
    "unpadded pair stride": [(
        "conv3x3_tile.cuh", "  g.cs = ((g.rows * g.cols - 8 + 31) / 32) * 32 + 8;",
        "  g.cs = g.rows * g.cols;")],
    "8-byte halo copies": [(
        "conv3x3_tile.cuh", "  for (int v = 4; v > 1; v /= 2)\n",
        "  for (int v = 2; v > 1; v /= 2)\n")],
    # bf16 pair rows not padded to 16 bytes: 8-byte copies at dilation 1
    "bf16 unpadded rows": [(
        "conv_in_act.cu", "constexpr int kRowWords = 4;\n", "constexpr int kRowWords = 1;\n")],
    "bf16 2-step chains": [(
        "conv3x3_tile.cuh", "constexpr int kBf16ChainSteps = 1;\n",
        "constexpr int kBf16ChainSteps = 2;\n")],
    "bf16 one chain": [(
        "conv3x3_tile.cuh", "constexpr int kBf16ChainSteps = 1;\n",
        "constexpr int kBf16ChainSteps = 1 << 20;\n")],
    # diagnostics, not designs (their results are wrong): each removes one
    # part of the work to show what it costs; "bf16 no mma" keeps the
    # fragment loads live through a float add, "no global reads" zero-fills
    # every copy
    "diag: bf16 no mma": [
        ("conv3x3_tile.cuh", "              mma_bf16_first(chain[i][j], af[i], bf[j]);\n",
         "              chain[i][j][0] = __uint_as_float(af[i][0] ^ bf[j][1]);\n"),
        ("conv3x3_tile.cuh", "              mma_bf16(chain[i][j], af[i], bf[j]);\n",
         "              chain[i][j][0] += __uint_as_float(af[i][0] ^ af[i][3] ^ bf[j][0]);\n")],
    "diag: no global reads": [
        ("conv3x3_tile.cuh", "          cp_async16(dst, src, ok);\n",
         "          cp_async16(dst, in.x, false);\n"),
        ("conv3x3_tile.cuh",
         "cp_async16(s_w + m * g.ws + q, ok ? w + ((int64_t)(co0 + m) * c + ci0) * 9 + q : w, ok);",
         "cp_async16(s_w + m * g.ws + q, w, false);")],
    "in_act one group, 6 stages": [
        ("conv_in_act.cu", "constexpr int kGroups = 2;\n", "constexpr int kGroups = 1;\n"),
        ("conv_in_act.cu", "constexpr int kStages = 3;\n", "constexpr int kStages = 6;\n")],
    "diag: empty conv pass": [(
        "conv_in_act.cu", "  extern __shared__ __align__(16) float smem[];\n",
        "  extern __shared__ __align__(16) float smem[];\n  if (a.c > 0) return;\n")],
    "diag: no conv epilogue": [(
        "conv_in_act.cu",
        "  // epilogue: bias, pre-norm store, and the patch's statistics per channel\n",
        "  if (a.c > 0) {\n    if (acc[0][0][0] == 1234.5f) a.y[0] = 1.f;\n    return;\n  }\n")],
    "diag: no main loop": [(
        "conv3x3_tile.cuh", "  for (int s = 0; s < nstages; ++s) {\n",
        "  for (int s = 0; s < 0; ++s) {\n")],
    "diag: no loads in the loop": [(
        "conv3x3_tile.cuh", "    if (next < nstages) load_stage(next, next % kStages);\n", "")],
    "diag: bf16 no fragment loads": [
        ("conv3x3_tile.cuh", "          af[i][0] = a[i * 16];\n", "          af[i][0] = tap + i;\n"),
        ("conv3x3_tile.cuh", "          af[i][1] = a[i * 16 + 8];\n", "          af[i][1] = s;\n"),
        ("conv3x3_tile.cuh", "          af[i][2] = a[a_hi + i * 16];\n", "          af[i][2] = i;\n"),
        ("conv3x3_tile.cuh", "          af[i][3] = a[a_hi + i * 16 + 8];\n", "          af[i][3] = tap;\n"),
        ("conv3x3_tile.cuh", "          bf[j][0] = sb[j * 8 * g.ws + tap];\n", "          bf[j][0] = j + s;\n"),
        ("conv3x3_tile.cuh", "          bf[j][1] = sb[j * 8 * g.ws + tap + 36];  // pair + 4\n",
         "          bf[j][1] = j * tap;\n")],
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
    barriers, shared memory, stack and spills."""
    lines = [s.strip().removeprefix("ptxas info    : ") for s in stderr.splitlines()]
    return [f"{name.removeprefix('Function properties for ')}: {used}; {spill}"
            for name, spill, used in zip(lines, lines[1:], lines[2:])
            if name.startswith("Function properties for ") and used.startswith("Used ")]


def build_variants(build) -> tuple:
    """{(variant, lib): ctypes.CDLL}, and {"mma": CDLL} for the peak kernel;
    {(variant, lib): ptxas report lines}."""
    root = build.BUILD_DIR / "variants"
    procs = []
    nvcc = build.nvcc_path()
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = root / f"v{i}"
        patched_sources(edits, src, build.CSRC_DIR)
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
    libs, ptxas = {}, {}
    for key, path, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
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
    return libs, ptxas


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


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.ops.cuda import epilogue as E
    from michigan_tpu_torch.ops.cuda.spade import _act
    from michigan_tpu_torch.ops.norms import instance_norm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, ptxas = build_variants(build)
    for (v, lib), kernels in ptxas.items():
        print(f"ptxas {v} {lib}: {' | '.join(kernels)}", flush=True)
    for blocks, threads in ((132, 128), (132, 256), (264, 256), (264, 512)):
        print(f"mma.sync m16n8k8 TF32, {blocks} blocks x {threads} threads (8 chains a warp): "
              f"{libs['mma'].mma_tflops(blocks, threads, 20000):.1f} TFLOP/s; m16n8k16 bf16: "
              f"{libs['mma'].mma_tflops_bf16(blocks, threads, 20000):.1f} TFLOP/s [{card}]",
              flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def lowch(v, x, w, out):
        n, c, h, wd = x.shape
        err = libs[(v, "conv_lowch")].conv3x3_same_f32(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, c, w.shape[0], h, wd, stream())
        build.check_launch(v, err)

    def in_act(v, x, w, b, d, act, r, out, scratch):
        n, c, hp, wp = x.shape
        err = libs[(v, "conv_in_act")].conv3x3_in_act_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None if r is None else r.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, c, w.shape[0], hp - 2 * d,
            wp - 2 * d, d, 1e-5, {None: 0, "relu": 1}[act], stream())
        build.check_launch(v, err)

    def in_act16(v, x, w, b, d, act, r, out):
        n, c, hp, wp = x.shape
        lib = libs[(v, "conv_in_act")]
        h, wd = hp - 2 * d, wp - 2 * d
        scratch = torch.empty(lib.conv3x3_in_act_bf16_scratch(n, c, w.shape[0], h, wd, d),
                              dtype=torch.uint8, device="cuda")
        err = lib.conv3x3_in_act_bf16(
            x.data_ptr(), w.data_ptr(), 1, b.data_ptr(), 0, None if r is None else r.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, c, w.shape[0], h, wd, d,
            1e-5, {None: 0, "relu": 1}[act], stream())
        build.check_launch(v, err)

    def rel(got, want64):
        return ((got.double() - want64).abs().max() / want64.abs().max()).item()

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {v: {} for v in VARIANTS}
    turns = list(VARIANTS) + list(VARIANTS)[::-1]
    # conv3x3_same_lowch
    w = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") * math.sqrt(2 / 576)
    x = torch.randn((2, 64, 512, 512), generator=gen, device="cuda").relu_()
    want = F.conv2d(x.double(), w.double(), padding=1)
    out = torch.empty_like(x)
    ref = {"lowch": rel(F.conv2d(x, w, padding=1), want)}
    for v in VARIANTS:
        lowch(v, x, w, out)
        rows[v]["lowch err"] = rel(out, want)
    del want
    x = torch.randn((16, 64, 512, 512), generator=gen, device="cuda").relu_()
    out = torch.empty_like(x)
    ref["lowch ms"] = median_ms(lambda: F.conv2d(x, w, padding=1), torch, inner=5)
    for v in turns:
        rows[v].setdefault("lowch ms", []).append(
            median_ms(lambda: lowch(v, x, w, out), torch, inner=5))
    del x, out
    # conv3x3_in_act
    for d, act, res in EPI_CASES:
        key = f"in_act d{d}"
        x = torch.randn((2, 256, 64 + 2 * d, 64 + 2 * d), generator=gen, device="cuda")
        w = torch.randn((256, 256, 3, 3), generator=gen, device="cuda") * 0.02
        b = torch.randn(256, generator=gen, device="cuda")
        r = torch.randn((2, 256, 64, 64), generator=gen, device="cuda") if res else None
        want = E.conv3x3_in_act_plain(x.double(), w.double(), b.double(), d, act,
                                      residual=None if r is None else r.double())
        ref[f"{key} err"] = rel(E.conv3x3_in_act_plain(x, w, b, d, act, residual=r), want)
        out = torch.empty((2, 256, 64, 64), device="cuda")
        scratch = torch.empty(2 * 256 * 32 * 3, device="cuda")  # 32 patches of 64^2
        for v in VARIANTS:
            in_act(v, x, w, b, d, act, r, out, scratch)
            rows[v][f"{key} err"] = rel(out, want)
        x1, o1 = x[:1].contiguous(), out[:1].contiguous()
        r1 = None if r is None else r[:1].contiguous()
        for v in turns:
            rows[v].setdefault(f"{key} us", []).append(1e3 * median_ms(
                lambda: in_act(v, x1, w, b, d, act, r1, o1, scratch), torch))
        # the bf16 form on the same values rounded to bf16; float64 of them,
        # beside cuDNN's bf16 conv + the torch norm (the route it replaces)
        key = f"in_act16 d{d}"
        x, r = x.bfloat16(), None if r is None else r.bfloat16()
        want = E.conv3x3_in_act_plain(x.double(), w.bfloat16().double(), b.double(), d, act,
                                      residual=None if r is None else r.double())
        y = _act(instance_norm(F.conv2d(x, w.bfloat16(), b.bfloat16(), dilation=d)), act)
        ref[f"{key} err"] = rel(y if r is None else r + y, want)
        out = torch.empty((2, 256, 64, 64), device="cuda", dtype=torch.bfloat16)
        for v in VARIANTS:
            in_act16(v, x, w, b, d, act, r, out)
            rows[v][f"{key} err"] = rel(out, want)
        x1, o1 = x[:1].contiguous(), out[:1].contiguous()
        r1 = None if r is None else r[:1].contiguous()
        for v in turns:
            rows[v].setdefault(f"{key} us", []).append(1e3 * median_ms(
                lambda: in_act16(v, x1, w, b, d, act, r1, o1), torch))
    # device time of each pass of the package's own build (torch.profiler):
    # pair, conv and norm passes in bf16, conv and norm passes in float32
    from torch.profiler import ProfilerActivity, profile

    for d, act, res in EPI_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((1, 256, 64 + 2 * d, 64 + 2 * d), generator=gen, device="cuda")
            w = torch.randn((256, 256, 3, 3), generator=gen, device="cuda") * 0.02
            b = torch.randn(256, generator=gen, device="cuda")
            r = torch.randn((1, 256, 64, 64), generator=gen, device="cuda") if res else None
            x, r = x.to(dtype), None if r is None else r.to(dtype)
            for _ in range(3):
                E.conv3x3_in_act(x, w, b, dilation=d, act=act, residual=r)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    E.conv3x3_in_act(x, w, b, dilation=d, act=act, residual=r)
                torch.cuda.synchronize()
            name = lambda key: key.split("::", 1)[-1].split("<")[0].split("(")[0]
            passes = [f"{name(e.key)} {e.device_time_total / e.count:.2f}"
                      for e in prof.key_averages() if e.device_time_total > 0 and "kernel" in e.key]
            print(f"passes, {str(dtype).removeprefix('torch.')} (1,256,64^2) dilation {d}: "
                  f"{'; '.join(passes)} us a call [{card}]", flush=True)
    print(f"float64 error over the largest magnitude, plain versions in fp32: F.conv2d "
          f"{ref['lowch']:.3e} (lowch), cuDNN conv + torch norm {ref['in_act d2 err']:.3e} / "
          f"{ref['in_act d1 err']:.3e} (in_act d2 / d1); in bf16, cuDNN bf16 conv + torch norm "
          f"{ref['in_act16 d2 err']:.3e} / {ref['in_act16 d1 err']:.3e}; F.conv2d at (16, 64, "
          f"512^2) {ref['lowch ms']:.3f} ms [{card}]", flush=True)
    for v, row in rows.items():
        times = lambda k, f: ", ".join(f.format(t) for t in row[k])
        print(f"{v:>20}: lowch {times('lowch ms', '{:.3f}')} ms, error {row['lowch err']:.3e}; "
              f"in_act d2 {times('in_act d2 us', '{:.1f}')} us, error {row['in_act d2 err']:.3e}; "
              f"in_act d1 {times('in_act d1 us', '{:.1f}')} us, error {row['in_act d1 err']:.3e}; "
              f"bf16 d2 {times('in_act16 d2 us', '{:.1f}')} us, error "
              f"{row['in_act16 d2 err']:.3e}; bf16 d1 {times('in_act16 d1 us', '{:.1f}')} us, "
              f"error {row['in_act16 d1 err']:.3e} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
