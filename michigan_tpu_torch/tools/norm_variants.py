"""Build variants of fused_instance_norm's bf16 kernel and measure them on a card.

    python -m michigan_tpu_torch.tools.norm_variants

The design choices of ``csrc/spade_norm.cu``'s one-read bf16 instance norm
are each one textual change away from the built source: VARIANTS lists them
as (file, text, replacement) edits, as ``tile_variants.py`` does for the 3x3
tile.  Every variant is compiled with the port's nvcc flags (and ``-Xptxas
-v``) into ``michigan_tpu_torch/_build/norm_variants/v<i>/``, all nvcc
processes started together, and loaded with ctypes:

- "as built": the plane in registers, one block or a cluster of 2-8 blocks
  a plane, merged through distributed shared memory;
- "two-pass": the float32 design (one block a plane, x read twice), the
  form bf16 had before;
- "bulk copy into shared memory": each block's slice arrives by one bulk
  copy of the copy engine into shared memory and is read from there;
- "counted global exchange": the blocks of a plane merge through a buffer
  in device memory and a counter they wait on, with no cluster (as
  conv3x3_in_act's bf16 form does); its launcher clears the counters first.
  It waits on blocks that must all be resident, so it runs only at batch 1
  (at most 512 blocks);
- "256 threads": blocks of 256 threads holding 4 vectors each;
- "plant: ...": faults planted in the merges, which the comparison must
  catch: a slice of a split plane dropped from the cluster's merge, a slice
  counted twice, the cluster's merge without the spread of the slices'
  means (Chan's d^2 term), and a warp dropped from a block's merge.

Each variant is held against the plain version (atol 1e-2, rtol 1.6e-2) at
every shape of fused_instance_norm on the bf16 paths (the flagship's and the
stroke edit's at batch 1, the training step's at batch 8), with gamma and
beta and with each act, and at a ragged H*W, on planes with a trend along
H*W (``planes``, the input of chip_smoke.py's phase 3 and of the card
tests), and each plant also on i.i.d. planes, whose slices agree.  The
designs are then timed per shape (calls replayed in a CUDA graph, median of
5, the variants in turns) beside F.instance_norm, and summed over a
flagship forward (batch 1) and a training step's frozen inpainter (batch
8).  Prints the card's name and power limit first.  Exits 1 if "as built"
disagrees or a plant passes on the trended planes; needs a CUDA card and
nvcc, and exits 1 without them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

from michigan_tpu_torch.tools.tile_variants import median_ms, patched_sources, ptxas_report

SRC = "spade_norm.cu"
# (C, H=W, act): calls per forward of the flagship (the frozen inpainter's
# norms; the training step runs the same at batch 8)
IN_SHAPES = {(64, 256, "lrelu"): 1, (128, 128, "lrelu"): 1, (256, 64, "lrelu"): 1,
             (256, 64, "relu"): 12, (256, 64, None): 12, (128, 128, "relu"): 1,
             (64, 256, "relu"): 1}
ACTS = {None: 0, "relu": 1, "lrelu": 2}
TOL = dict(atol=1e-2, rtol=1.6e-2)

GLOBAL_EXCHANGE = (
    "  if (cs > 1) {  // the plane's, through device memory and a counter\n"
    "    if (tid == 0) {\n"
    "      g_part[blockIdx.x] = s_block;\n"
    "      __threadfence();\n"
    "      atomicAdd(&g_arrived[plane], 1u);\n"
    "      const long long t0 = clock64();\n"
    "      while (*reinterpret_cast<volatile unsigned*>(&g_arrived[plane]) < (unsigned)cs)\n"
    "        if (clock64() - t0 > (1ll << 32)) __trap();  // seconds: a block is not resident\n"
    "      __threadfence();\n"
    "    }\n"
    "    __syncthreads();\n"
    "    if (warp == 0) {\n"
    "      const float4 p = lane < cs ? __ldcg(&g_part[plane * cs + lane])\n"
    "                                 : make_float4(0.f, 0.f, 0.f, 0.f);\n"
    "      mean = p.x, m2 = p.y, cnt = p.z;\n"
    "      warp_merge(mean, m2, cnt);\n"
    "      if (lane == 0) s_stats = make_float2(mean, rsqrtf(m2 / cnt + eps));\n"
    "    }\n"
    "  } else if (tid == 0) {\n")
CLUSTER_EXCHANGE_START = "  if (cs > 1) {  // the plane's, from every block of the cluster, in rank order\n"
CLUSTER_EXCHANGE_END = "  } else if (tid == 0) {\n"
CLUSTER_MERGE = ("      warp_merge(mean, m2, cnt);\n"
                 "      if (lane == 0) s_stats = make_float2(mean, rsqrtf(m2 / cnt + eps));\n"
                 "    }\n    cluster_arrive();")
KERNEL_DECL = ("template <bool kVec>\n__global__ void __launch_bounds__(kResThreads, 4)\n"
               "instance_norm_bf16_kernel(")


def _exchange_edit(text: str):
    """The edit that swaps the cluster exchange for GLOBAL_EXCHANGE."""
    i = text.index(CLUSTER_EXCHANGE_START)
    j = text.index(CLUSTER_EXCHANGE_END, i) + len(CLUSTER_EXCHANGE_END)
    return (SRC, text[i:j], GLOBAL_EXCHANGE)


def variants(csrc) -> dict:
    """{variant: [(file, text, replacement), ...]}."""
    text = (csrc / SRC).read_text()
    return {
        "as built": [],
        "two-pass": [(SRC, "  if (cs == 0) return", "  if (true) return")],
        "bulk copy into shared memory": [
            (SRC, "  for (int v = 0; v < kResVecs; ++v) xv[v] = load(x, v);\n",
             "  __shared__ __align__(128) uint4 s_slice[kResElems / 8];\n"
             "  __shared__ __align__(8) unsigned long long s_bar;\n"
             "  if (kVec) {\n"
             "    const unsigned bytes = hi > lo ? (unsigned)(hi - lo) * 2 : 0u;\n"
             "    if (tid == 0) conv_bf16::mbar_init(&s_bar, 1);\n"
             "    __syncthreads();\n"
             "    if (tid == 0) {\n"
             "      conv_bf16::mbar_arrive_tx(&s_bar, bytes);\n"
             "      if (bytes) conv_bf16::bulk_copy(s_slice, x + base + lo, bytes, &s_bar);\n"
             "    }\n"
             "    conv_bf16::mbar_wait(&s_bar, 0);\n"
             "    for (int v = 0; v < kResVecs; ++v)\n"
             "      xv[v] = at(v, 0) < hi ? s_slice[(at(v, 0) - lo) / 8] : make_uint4(0, 0, 0, 0);\n"
             "  } else {\n"
             "    for (int v = 0; v < kResVecs; ++v) xv[v] = load(x, v);\n"
             "  }\n")],
        "counted global exchange": [
            (SRC, KERNEL_DECL, "__device__ float4 g_part[1 << 20];\n"
                               "__device__ unsigned g_arrived[1 << 17];\n\n" + KERNEL_DECL),
            _exchange_edit(text),
            (SRC, "  if (cs > 1) cluster_wait();  // no block leaves", "  if (false) cluster_wait();  //"),
            (SRC, "  cfg.numAttrs = cs > 1 ? 1 : 0;",
             "  cfg.numAttrs = 0;\n"
             "  if (cs > 1) {\n"
             "    void* counters = nullptr;\n"
             "    cudaError_t me = cudaGetSymbolAddress(&counters, g_arrived);\n"
             "    if (me == cudaSuccess)\n"
             "      me = cudaMemsetAsync(counters, 0, sizeof(unsigned) * planes, cfg.stream);\n"
             "    if (me != cudaSuccess) return (int)me;\n"
             "  }")],
        "256 threads": [
            (SRC, "constexpr int kResThreads = 128;", "constexpr int kResThreads = 256;"),
            (SRC, "constexpr int kResVecs = 8; ", "constexpr int kResVecs = 4; ")],
        "plant: a slice dropped": [
            (SRC, "lane < cs ? ld_cluster(&s_block, lane)",
             "lane < cs - 1 ? ld_cluster(&s_block, lane)")],
        "plant: a slice counted twice": [
            (SRC, "ld_cluster(&s_block, lane)", "ld_cluster(&s_block, lane == cs - 1 ? 0 : lane)")],
        "plant: no d^2 term": [
            (SRC, CLUSTER_MERGE, CLUSTER_MERGE.replace(
                "      if (lane == 0)",
                "      m2 = p.y;  // the slices' own M2 only\n"
                "      for (int off = 16; off > 0; off >>= 1)\n"
                "        m2 += __shfl_down_sync(0xffffffffu, m2, off);\n"
                "      if (lane == 0)", 1))],
        "plant: a warp dropped": [
            (SRC, "lane < kResWarps ? s_part[lane]", "lane < kResWarps - 1 ? s_part[lane]")],
    }


def planes(torch, shape, gen, trend=True):
    """bf16 planes on the card: randn, plus with `trend` 4 linspace(-1, 1)
    along H*W, so that the slices of a split plane differ in mean."""
    h, w = shape[-2:]
    x = torch.randn(shape, generator=gen, device="cuda")
    if trend:
        x += 4 * torch.linspace(-1, 1, h * w, device="cuda").view(h, w)
    return x.bfloat16()


def build_variants(build) -> tuple:
    """{variant: ctypes.CDLL}, {variant: ptxas report lines}, {variant:
    nvcc's error} for the variants (other than "as built") that do not
    build."""
    root = build.BUILD_DIR / "norm_variants"
    nvcc = build.nvcc_path()
    procs = []
    for i, (name, edits) in enumerate(variants(build.CSRC_DIR).items()):
        src = root / f"v{i}"
        patched_sources(edits, src, build.CSRC_DIR)
        out = src / "spade_norm.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src / SRC)]
        procs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True)))
    libs, ptxas, failed = {}, {}, {}
    for name, out, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            if name == "as built":
                raise RuntimeError(f"nvcc failed for {name}:\n{err}")
            failed[name] = err[-3000:]
            continue
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in build.SIGNATURES["spade_norm"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name], ptxas[name] = lib, ptxas_report(err)
    return libs, ptxas, failed


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.ops.cuda import spade as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs, ptxas, failed = build_variants(build)
    for v, kernels in ptxas.items():
        print(f"ptxas {v}: {' | '.join(kernels)}", flush=True)
    for v, err in failed.items():
        print(f"nvcc refused {v}:\n{err}", flush=True)
    names = list(libs)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def run(v, x, g, b, act, out):
        n, c, h, w = x.shape
        build.check_launch(v, libs[v].instance_norm_bf16(
            x.data_ptr(), g.data_ptr() if g is not None else None,
            b.data_ptr() if b is not None else None, out.data_ptr(), n * c, h * w, 1e-5,
            ACTS[act], stream()))

    def fits(v, n):  # the counted exchange waits on blocks that must all be resident
        return v != "counted global exchange" or n == 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
    plants = [v for v in names if v.startswith("plant: ")]
    designs = [v for v in names if v not in plants]
    failures = []
    caught = {v: {"trended": 0, "i.i.d.": 0} for v in plants}
    cases = [(n, c, h, h, act, gb) for n in (1, 8) for (c, h, act) in IN_SHAPES
             for gb in (False, True)]
    cases += [(1, 64, 37, 53, "lrelu", True), (2, 8, 300, 300, None, False),
              (1, 3, 255, 257, "relu", False)]  # ragged, and planes for the two-pass form
    for n, c, h, w, act, gb in cases:
        for kind in ("trended", "i.i.d."):
            x = planes(torch, (n, c, h, w), gen, trend=kind == "trended")
            g, b = (rand((n, c, h, w)), rand((n, c, h, w))) if gb else (None, None)
            want = K.fused_instance_norm_plain(x, g, b, act=act).float()
            out = torch.empty_like(x)
            errs = []
            for v in names if kind == "trended" else plants:
                if not fits(v, n):
                    continue
                out.zero_()
                run(v, x, g, b, act, out)
                torch.cuda.synchronize()
                ok = torch.allclose(out.float(), want, **TOL)
                errs.append(f"{v} {(out.float() - want).abs().max().item():.2e}"
                            f"{'' if ok else ' FAIL'}")
                if ok:
                    continue
                if v in caught:
                    caught[v][kind] += 1
                else:
                    failures.append((v, n, c, h, w, act, gb))
            print(f"({n},{c},{h},{w}) act={act} gamma/beta={gb}, {kind} planes: max abs err "
                  + ", ".join(errs), flush=True)
    for v, k in caught.items():
        print(f"{v}: fails {k['trended']} of {len(cases)} cases on trended planes, "
              f"{k['i.i.d.']} on i.i.d. planes", flush=True)
    missed = [v for v, k in caught.items() if k["trended"] == 0]
    if any(f[0] == "as built" for f in failures) or missed:
        print(f"FAIL: {failures}; plants the trended planes miss: {missed}", file=sys.stderr)
        return 1

    totals = {}
    for n in (1, 8):
        for (c, h, act), calls in IN_SHAPES.items():
            x = rand((n, c, h, h))
            out = torch.empty_like(x)
            order = [v for v in designs if fits(v, n)]
            ts = {}
            for v in order + order[::-1]:
                ts.setdefault(v, []).append(median_ms(lambda: run(v, x, None, None, act, out),
                                                      torch, inner=20))
            lib_ms = median_ms(lambda: F.instance_norm(x, eps=1e-5), torch, inner=20)
            split = libs["as built"].instance_norm_bf16_split(n * c, h * h)
            print(f"({n},{c},{h},{h}) act={act} x{calls}, {split} blocks a plane as built: "
                  + ", ".join(f"{v} {', '.join(f'{t * 1e3:.2f}' for t in t_)} us"
                              for v, t_ in ts.items())
                  + f"; F.instance_norm {lib_ms * 1e3:.2f} us [{card}]", flush=True)
            for v, t_ in ts.items():
                totals.setdefault((n, v), 0.0)
                totals[(n, v)] += calls * sum(t_) / len(t_)
            totals.setdefault((n, "F.instance_norm"), 0.0)
            totals[(n, "F.instance_norm")] += calls * lib_ms
            bound_ms = calls * 4 * n * c * h * h / 3.35e12 * 1e3
            totals.setdefault((n, "bound"), 0.0)
            totals[(n, "bound")] += bound_ms
    for (n, v), ms in totals.items():
        per = "a flagship forward" if n == 1 else "a training step (batch 8)"
        print(f"summed over {per}: {v} {ms:.4f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
