"""Build variants of the shared 3x3 tensor-core tile and measure them on a card.

    python -m michigan_tpu_torch.tools.tile_variants

The design choices of ``csrc/conv3x3_tile.cuh`` are each one textual change
away from the built sources: VARIANTS lists them as (file, text, replacement)
edits.  Every variant is compiled with the port's nvcc flags into
``michigan_tpu_torch/_build/variants/v<i>/`` (all nvcc processes started
together), loaded with ctypes and run at the paths' shapes:

- conv3x3_same_lowch at VGG19 features_2's (16, 64, 512^2);
- conv3x3_in_act at the inpainters' (1, 256, 64^2), dilation 2 with relu and
  dilation 1 with a residual.

For each variant: the largest error against a float64 convolution at batch 2
of those shapes, over the largest magnitude (beside F.conv2d's in float32,
TF32 off), and the device time (20 calls replayed in a CUDA graph, median of
5), the variants timed in turns (forward, then backward through the list).
It also measures the card's mma.sync m16n8k8 TF32 rate, which caps the tile:
three products per float32-accurate one.  Prints the card's name and power
limit first.  Needs a CUDA card and nvcc; exits 1 without them.
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
}

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
__global__ void mma_loop(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[t][0]), "+f"(d[t][1]), "+f"(d[t][2]), "+f"(d[t][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int t = 0; t < 8; ++t) s += d[t][0] + d[t][1] + d[t][2] + d[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// TFLOP/s of `blocks` x `threads` threads, each warp 8 independent chains
extern "C" float mma_tflops(int blocks, int threads, int iters) {
  float* out;
  if (cudaMalloc(&out, sizeof(float) * blocks * threads) != cudaSuccess) return -1.f;
  mma_loop<<<blocks, threads>>>(out, 16);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  mma_loop<<<blocks, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return -1.f;
  return (float)(2.0 * 16 * 8 * 8 * 8 * (double)iters * (blocks * threads / 32) / (ms * 1e9));
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
            lib.mma_tflops.restype = ctypes.c_float
            lib.mma_tflops.argtypes = [ctypes.c_int] * 3
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
              f"{libs['mma'].mma_tflops(blocks, threads, 20000):.1f} TFLOP/s", flush=True)
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
    print(f"float64 error over the largest magnitude, plain versions in fp32: F.conv2d "
          f"{ref['lowch']:.3e} (lowch), cuDNN conv + torch norm {ref['in_act d2 err']:.3e} / "
          f"{ref['in_act d1 err']:.3e} (in_act d2 / d1); F.conv2d at (16, 64, 512^2) "
          f"{ref['lowch ms']:.3f} ms [{card}]", flush=True)
    for v, row in rows.items():
        times = lambda k, f: ", ".join(f.format(t) for t in row[k])
        print(f"{v:>18}: lowch {times('lowch ms', '{:.3f}')} ms, error {row['lowch err']:.3e}; "
              f"in_act d2 {times('in_act d2 us', '{:.1f}')} us, error {row['in_act d2 err']:.3e}; "
              f"in_act d1 {times('in_act d1 us', '{:.1f}')} us, error {row['in_act d1 err']:.3e} "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
