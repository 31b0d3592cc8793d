"""Build variants of the orientation filter bank's kernels and measure them on a card.

    python -m michigan_tpu_torch.tools.filterbank_variants

The design choices of ``csrc/filterbank.cu`` are each one textual change
away from the built source (the 3xTF32 forward, its backward and the
forward on bf16 operands, whose variants are named "bf16 ..."): VARIANTS lists them as (file, text, replacement)
edits, as ``tile_variants.py`` does for the 3x3 tile.  Every variant is
compiled with the port's nvcc flags (and ``-Xptxas -v``) into
``michigan_tpu_torch/_build/fb_variants/v<i>/``, all nvcc processes started
together, loaded with ctypes and run at the training step's shapes:

- filterbank_orientation on eight (1, 512^2) strand planes, Gabor bank, and
  on one (the stroke edit's and the orientation tool's batch);
- filterbank_orientation_backward at (8, 512^2) on a dense random dconf and
  on the same dconf times the hair masks of ``synthetic_train_data`` (what
  the training loss passes back: it multiplies by the hair);
- the forward on bf16 operands at the bf16 training step's (8, 1, 512^2)
  and at (1, 1, 512^2): wgmma m64n32k16 with A from registers as built
  against mma.sync m16n8k16 and against wgmma waiting one step behind, tile
  shapes, and 4-step chains.

For each variant: the forward's largest conf error and its argmax mismatch
against a float64 bank convolution at (2, 1, 512^2), Gabor and DoG, beside
the plain version's in float32 (cuDNN, TF32 off); the backward's largest
error against its plain version over the gradient's largest magnitude; and
device times (calls replayed in a CUDA graph, median of 5), the variants
timed in turns (forward, then backward through the list).  For the bf16
forms: conf against the plain version (within one bf16 ulp, the argmax off
on at most 1% of the pixels, and only at bf16 near-ties) and against
float64 sums of the bf16 operands, beside the plain version's error; the
tensor-core instructions of the kernel's SASS (``cuobjdump -sass``:
HMMA.16816 bf16 for mma.sync, HGMMA for wgmma, HMMA.1684 for TF32); and
device times beside cuDNN's bf16 route (the bf16 conv of the gray plane
with the bank, then the clamp, max and argmax).  Prints the card's
name and power limit first.  Needs a CUDA card and nvcc; exits 1 without
them.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import types

from michigan_tpu_torch.tools.kernel_launches import sass_mma
from michigan_tpu_torch.tools.tile_variants import median_ms, patched_sources, ptxas_report

SRC = "filterbank.cu"
# the forward's A-fragment loads as built: from the two split planes
A_LOADS = (
    "        const int off[4] = {16 * i, 16 * i + 8, 16 * i + k4, 16 * i + k4 + 8};\n"
    "#pragma unroll\n"
    "        for (int r = 0; r < 4; ++r) {\n"
    "          a_big[i][r] = __float_as_uint(a[off[r]]);\n"
    "          a_small[i][r] = __float_as_uint(a[kPlane + off[r]]);\n"
    "        }\n")
VARIANTS = {
    "as built": [],
    # the halo split in registers as each A fragment leaves shared memory,
    # instead of once into (big, small) planes when it is staged
    "split in registers": [
        (SRC, "constexpr int kHalo = 2 * kPlane;", "constexpr int kHalo = kPlane;"),
        (SRC, "    // split the staged halo once: big in place, small into the second plane\n"
              "    for (int i = tid; i < kPlane; i += kThreads) {\n"
              "      const uint2 p = split_tf32(cur[i]);\n"
              "      cur[i] = __uint_as_float(p.x);\n"
              "      cur[kPlane + i] = __uint_as_float(p.y);\n"
              "    }\n    __syncthreads();\n", ""),
        (SRC, A_LOADS,
         "        const float v[4] = {a[16 * i], a[16 * i + 8], a[16 * i + k4], "
         "a[16 * i + k4 + 8]};\n"
         "#pragma unroll\n"
         "        for (int r = 0; r < 4; ++r) {\n"
         "          const uint2 p = split_tf32(v[r]);\n"
         "          a_big[i][r] = p.x;\n"
         "          a_small[i][r] = p.y;\n"
         "        }\n")],
    # a row step's K column t as tap column 2 (t % 4) + t / 4 and m16 row m as
    # pixel 2 (m % 8) + m / 8: a thread's four A values are then three
    # neighbouring floats, one 8-byte and one 4-byte load (column steps keep
    # four loads)
    "paired A loads": [
        (SRC, "  if (s < kRowSteps) return (s >> 1) * kK + 8 * (s & 1) + t;\n",
         "  if (s < kRowSteps) return (s >> 1) * kK + 8 * (s & 1) + 2 * (t & 3) + (t >> 2);\n"),
        (SRC, "  const int a_row = warp * kRS + gid + tig;                 // steps 0-33\n"
              "  const int a_col = warp * kRS + gid + tig * kRS + kK - 1;  // steps 34-36\n",
         "  const int a_row = warp * kRS + 2 * (gid + tig);\n"
         "  const int a_col = warp * kRS + 2 * gid + tig * kRS + kK - 1;\n"),
        (SRC, A_LOADS,
         "        if (s < kRowSteps) {\n"
         "#pragma unroll\n"
         "          for (int pl = 0; pl < 2; ++pl) {\n"
         "            unsigned(&frag)[4] = pl == 0 ? a_big[i] : a_small[i];\n"
         "            const float2 v = *reinterpret_cast<const float2*>(a + pl * kPlane + 16 * i);\n"
         "            frag[0] = __float_as_uint(v.x);\n"
         "            frag[1] = frag[2] = __float_as_uint(v.y);\n"
         "            frag[3] = __float_as_uint(a[pl * kPlane + 16 * i + 2]);\n"
         "          }\n"
         "          continue;\n"
         "        }\n"
         "        const int off[4] = {16 * i, 16 * i + 1, 16 * i + k4, 16 * i + k4 + 1};\n"
         "#pragma unroll\n"
         "        for (int r = 0; r < 4; ++r) {\n"
         "          a_big[i][r] = __float_as_uint(a[off[r]]);\n"
         "          a_small[i][r] = __float_as_uint(a[kPlane + off[r]]);\n"
         "        }\n"),
        (SRC, "    const int y = tl.y0 + warp, x = tl.x0 + 8 * tig + gid;\n",
         "    const int y = tl.y0 + warp, x = tl.x0 + 16 * (tig >> 1) + 2 * gid + (tig & 1);\n")],
    # the 37 steps unrolled fully, or not at all, instead of by 4
    "steps fully unrolled": [(SRC, "#pragma unroll 4  //", "#pragma unroll  //")],
    "steps not unrolled": [(SRC, "#pragma unroll 4  //", "#pragma unroll 1  //")],
    # at most 255 registers a thread, one block (8 warps) per SM
    "one block per SM": [(SRC, "__launch_bounds__(kThreads, 2)\nfilterbank_kernel(",
                          "__launch_bounds__(kThreads, 1)\nfilterbank_kernel(")],
    # backward: 8 pixels per thread (64 x 32 tiles), and no skipping
    "backward 8 rows": [(SRC, "constexpr int kBRows = 16;", "constexpr int kBRows = 8;")],
    "backward no skip": [(SRC, "  if (live) {\n", "  if (true) {\n")],
}
# the length of a fresh tensor-core chain, in steps of 8 taps (as built: 4)
for steps in ("1", "2", "8", "kSteps"):
    VARIANTS[f"chain {steps}"] = [(SRC, "constexpr int kChain = 4;",
                                   f"constexpr int kChain = {steps};")]
# the bf16-operand forward's products as built: wgmma m64n32k16 with A from
# registers, waiting for each K step's products before the next step's A
WGMMA_BODY = (
    "  cb::wgmma_commit();\n"
    "  cb::wgmma_wait<0>();  // a's registers are free, acc is readable\n"
    "#pragma unroll\n"
    "  for (int i = 0; i < kMT; ++i) cb::reg_fence<16>(acc[i]);\n")
STEP_DECL = "// The products of one K step: the warp's kMT m16 tiles x the 32\n"
STEP_PRODUCTS = (
    "  namespace cb = conv_bf16;\n"
    "  const uint64_t db = cb::make_desc(cb::smem_u32(b), kStepBytes / 2, 128);\n"
    "  cb::wgmma_fence();\n"
    "#pragma unroll\n"
    "  for (int i = 0; i < kMT; ++i) wgmma_rs(acc[i], a[i], db);\n" + WGMMA_BODY)
BF16_CALL = "      step_products(acc, a, s_b + s * kStepBytes);\n"
# the same products by mma.sync m16n8k16 on the same A registers, the bank
# read one word per lane from the same layout
MMA_SYNC = [
    (SRC, STEP_DECL,
     "__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3,\n"
     "                                         const unsigned (&a)[4], unsigned b0, unsigned b1) {\n"
     "  asm volatile(\n"
     "      \"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 \"\n"
     "      \"{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n\"\n"
     "      : \"+f\"(d0), \"+f\"(d1), \"+f\"(d2), \"+f\"(d3)\n"
     "      : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), \"r\"(b0), \"r\"(b1));\n"
     "}\n\n" + STEP_DECL),
    (SRC, STEP_PRODUCTS,
     "  // lane (gid, tig) reads k = 2 tig, 2 tig + 1 (+ 8 for b1) of orientation\n"
     "  // 8 j + gid: one word per lane of a 128-byte block\n"
     "  const unsigned* bw = reinterpret_cast<const unsigned*>(b) + (threadIdx.x & 31);\n"
     "  unsigned b0[4], b1[4];\n"
     "#pragma unroll\n"
     "  for (int j = 0; j < 4; ++j) {\n"
     "    b0[j] = bw[32 * j];\n"
     "    b1[j] = bw[kStepBytes / 8 + 32 * j];\n"
     "  }\n"
     "#pragma unroll\n"
     "  for (int i = 0; i < kMT; ++i)\n"
     "#pragma unroll\n"
     "    for (int j = 0; j < 4; ++j)\n"
     "      mma_bf16(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3], a[i],\n"
     "               b0[j], b1[j]);\n")]
# the next step's A loads while this step's products run: wait until one
# step's products are still in flight, then for all before the epilogue
WGMMA_ASYNC = [
    (SRC, WGMMA_BODY, "  cb::wgmma_commit();\n  cb::wgmma_wait<1>();\n"),
    (SRC, BF16_CALL, BF16_CALL + "      if (s == kSteps - 1) {\n"
     "        conv_bf16::wgmma_wait<0>();\n"
     "#pragma unroll\n"
     "        for (int i = 0; i < kMT; ++i) conv_bf16::reg_fence<16>(acc[i]);\n"
     "      }\n")]


BF16_LB = "__launch_bounds__(kThreads, 1)\nfilterbank_bf16_kernel("
VARIANTS.update({
    "bf16 mma.sync": MMA_SYNC,
    "bf16 wgmma async": WGMMA_ASYNC,
    # 4-step chains flushed into rounded float32 sums, as the 3xTF32 form
    "bf16 chain 4": [
        (SRC, "    float acc[kMT][16];\n", "    float acc[kMT][16], part[kMT][16];\n"),
        (SRC, BF16_CALL,
         "      if (s % 4 == 0) {\n"
         "#pragma unroll\n"
         "        for (int i = 0; i < kMT; ++i)\n"
         "#pragma unroll\n"
         "          for (int r = 0; r < 16; ++r) part[i][r] = 0.f;\n"
         "      }\n"
         "      step_products(part, a, s_b + s * kStepBytes);\n"
         "      if (s % 4 == 3 || s == kSteps - 1) {\n"
         "#pragma unroll\n"
         "        for (int i = 0; i < kMT; ++i)\n"
         "#pragma unroll\n"
         "          for (int r = 0; r < 16; ++r) acc[i][r] += part[i][r];\n"
         "      }\n")],
    # two blocks of 8 warps an SM (64 x 8 tiles); a warp row of 32 pixels (2
    # m16 tiles); 8 warps of 128-pixel rows (8 m16 tiles)
    "bf16 tile 64x8": [
        (SRC, "constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),
        (SRC, BF16_LB, BF16_LB.replace("1)", "2)"))],
    "bf16 tile 32x16": [
        (SRC, "constexpr int kTileW = 64;                    // pixels per warp row",
         "constexpr int kTileW = 32;"),
        (SRC, "constexpr int kPS = 88;", "constexpr int kPS = 56;"),
        (SRC, "constexpr int kFS = 84;", "constexpr int kFS = 52;")],
    "bf16 tile 128x8": [
        (SRC, "constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),
        (SRC, "constexpr int kTileW = 64;                    // pixels per warp row",
         "constexpr int kTileW = 128;"),
        (SRC, "constexpr int kPS = 88;", "constexpr int kPS = 152;"),
        (SRC, "constexpr int kFS = 84;", "constexpr int kFS = 148;")],
    # diagnostics, each without one part of the work (their results are
    # wrong; only their times are read): the products, the A loads from the
    # pair words, the staging of the next tile's halo and the pair-word pass
    "bf16 diag: no products": [
        (SRC, BF16_CALL,
         "#pragma unroll\n"
         "      for (int i = 0; i < kMT; ++i)\n"
         "        acc[i][s % 16] += __uint_as_float(a[i][0] ^ a[i][1] ^ a[i][2] ^ a[i][3]);\n")],
    "bf16 diag: no A loads": [
        (SRC, "wd[u] = a_row[s * kPS + 8 * u];", "wd[u] = 0x3f803f80u + s + u;"),
        (SRC, "          a[i][0] = p[16 * i];\n          a[i][1] = p[16 * i + 8];\n"
              "          a[i][2] = p[4 * kPS + 16 * i];\n          a[i][3] = p[4 * kPS + 16 * i + 8];\n",
         "          a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0x3f803f80u + s + i;\n")],
    "bf16 diag: no staging": [
        (SRC, "    if (t + gridDim.x < ntiles) stage(t + gridDim.x);\n", ""),
        (SRC, "    for (int i = tid; i < kStageH * kWords; i += kThreads) {\n",
         "    for (int i = tid; i < 0; i += kThreads) {\n")],
})
FWD16_VARIANTS = ("as built", "bf16 mma.sync", "bf16 wgmma async", "bf16 chain 4",
                  "bf16 tile 64x8", "bf16 tile 32x16", "bf16 tile 128x8", "bf16 diag: no products",
                  "bf16 diag: no A loads", "bf16 diag: no staging")
FWD_VARIANTS = ("as built", "split in registers", "paired A loads", "chain 1", "chain 2",
                "chain 8", "chain kSteps", "one block per SM", "steps fully unrolled",
                "steps not unrolled")
BWD_VARIANTS = ("as built", "backward 8 rows", "backward no skip")
def build_variants(build, names) -> tuple:
    """{variant: ctypes.CDLL}, {variant: ptxas report lines}, {variant:
    library path}, {variant: nvcc's error} for the variants (other than "as
    built") that do not build."""
    root = build.BUILD_DIR / "fb_variants"
    nvcc = build.nvcc_path()
    procs = []
    for i, name in enumerate(names):
        src = root / f"v{i}"
        patched_sources(VARIANTS[name], src, build.CSRC_DIR)
        out = src / "filterbank.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src / SRC)]
        procs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True)))
    libs, ptxas, paths, failed = {}, {}, {}, {}
    for name, out, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            if name == "as built":
                raise RuntimeError(f"nvcc failed for {name}:\n{err}")
            failed[name] = err[-3000:]
            continue
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in build.SIGNATURES["filterbank"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name], ptxas[name], paths[name] = lib, ptxas_report(err), out
    return libs, ptxas, paths, failed


def strand_planes(torch, n, size, seed):
    """(n, 1, size, size) gray planes in [0, 255] on the card: strands whose
    angle turns across the plane, plus noise (no exact ties among the
    clamped responses)."""
    gen = torch.Generator().manual_seed(seed)
    ax = torch.arange(size, dtype=torch.float32) / size
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    out = []
    for i in range(n):
        angle = math.pi * (xx + 0.5 * yy + 0.1 * i)
        wave = torch.sin(2 * math.pi * 40 * (xx * torch.cos(angle) + yy * torch.sin(angle)))
        out.append(127 + 90 * wave + 25 * torch.rand((size, size), generator=gen))
    return torch.stack(out)[:, None].cuda()


def float64_orientation(torch, gray, bank):
    """(idx, conf) of the clamped bank responses in float64."""
    import torch.nn.functional as F

    res = F.conv2d(gray.double(), bank.double().permute(3, 2, 0, 1), padding=8)
    conf, idx = res.clamp_min(0.0).max(dim=1)
    return idx.to(torch.int32), conf


def run_f32(torch, libs, card) -> int:
    """The 3xTF32 forward's and the backward's variants: checks, then times."""
    from michigan_tpu_torch.data.synthetic import synthetic_train_data
    from michigan_tpu_torch.ops import filters
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.ops.cuda import orient as O

    stream = lambda: torch.cuda.current_stream().cuda_stream

    def fwd(v, gray, bank, idx, conf):
        n, _, h, w = gray.shape
        build.check_launch(v, libs[v].filterbank_orientation_f32(
            gray.data_ptr(), bank.data_ptr(), idx.data_ptr(), conf.data_ptr(), n, h, w, stream()))

    def bwd(v, dconf, idx, conf, bank, out):
        n, h, w = dconf.shape
        build.check_launch(v, libs[v].filterbank_orientation_backward_f32(
            dconf.data_ptr(), idx.data_ptr(), conf.data_ptr(), bank.data_ptr(), out.data_ptr(),
            n, h, w, stream()))

    failed = []
    # forward against float64, both banks
    gray = strand_planes(torch, 2, 512, 1)
    for mode in ("gabor", "dog"):
        bank = filters.bank(mode, gray.device)
        i64, c64 = float64_orientation(torch, gray, bank)
        p_idx, p_conf = O.filterbank_orientation_plain(gray, bank)
        p_err = (p_conf.double() - c64).abs().max().item()
        p_mis = (p_idx != i64).float().mean().item()
        print(f"{mode} (2,1,512,512) against float64: plain fp32 conf err {p_err:.3e}, argmax "
              f"mismatch {p_mis:.2e}", flush=True)
        idx = torch.empty((2, 512, 512), dtype=torch.int32, device="cuda")
        conf = torch.empty((2, 512, 512), device="cuda")
        for v in FWD_VARIANTS:
            fwd(v, gray, bank, idx, conf)
            torch.cuda.synchronize()
            err = (conf.double() - c64).abs().max().item()
            mis = (idx != i64).float().mean().item()
            ok = err <= 2 * p_err and mis <= p_mis + 1e-4
            print(f"  {v:>16}: conf err {err:.3e} ({err / p_err:.2f}x plain), argmax mismatch "
                  f"{mis:.2e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok and v == "as built":
                failed.append(("forward float64", mode))
    # backward against the plain version, dense and hair-masked dconf
    grays = strand_planes(torch, 8, 512, 2)
    bank = filters.bank("gabor", grays.device)
    idx, conf = O.filterbank_orientation_plain(grays, bank)
    gen = torch.Generator(device="cuda").manual_seed(3)
    hair = torch.from_numpy(synthetic_train_data(types.SimpleNamespace(crop_size=512), 0, 8)
                            ["label_tag"][..., 0]).cuda()
    dense = torch.randn(conf.shape, generator=gen, device="cuda")
    inputs = {"dense": dense, "hair-masked": dense * hair}
    out = torch.empty_like(grays)
    for name, dconf in inputs.items():
        want = O.filterbank_orientation_backward_plain(dconf, idx, conf, bank)
        carry = int(((dconf != 0) & (conf > 0)).sum())
        print(f"backward {name}: {carry / dconf.numel():.3f} of pixels carry a gradient",
              flush=True)
        for v in BWD_VARIANTS:
            bwd(v, dconf, idx, conf, bank, out)
            torch.cuda.synchronize()
            rel = ((out - want).abs().max() / want.abs().max()).item()
            print(f"  {v:>16}: error {rel:.2e} of the largest magnitude "
                  f"{'ok' if rel <= 1e-4 else 'FAIL'}", flush=True)
            if rel > 1e-4:
                failed.append(("backward", name, v))
    if failed:
        print(f"FAIL: {failed}", file=sys.stderr)
        return 1
    # device times, in turns
    times = {}
    for label, planes in (("fwd (8,1,512^2)", grays), ("fwd (1,1,512^2)", grays[:1])):
        n = planes.shape[0]
        i_out = torch.empty((n, 512, 512), dtype=torch.int32, device="cuda")
        c_out = torch.empty((n, 512, 512), device="cuda")
        for v in FWD_VARIANTS + FWD_VARIANTS[::-1]:
            times.setdefault((label, v), []).append(median_ms(
                lambda: fwd(v, planes, bank, i_out, c_out), torch, inner=10))
        plain = median_ms(lambda: O.filterbank_orientation_plain(planes, bank), torch, inner=10)
        print(f"{label}: plain (cuDNN conv + max) {plain:.3f} ms [{card}]", flush=True)
    for name, dconf in inputs.items():
        label = f"bwd {name} (8,512^2)"
        for v in BWD_VARIANTS + BWD_VARIANTS[::-1]:
            times.setdefault((label, v), []).append(median_ms(
                lambda: bwd(v, dconf, idx, conf, bank, out), torch, inner=10))
    for (label, v), ts in times.items():
        print(f"{label} {v:>16}: {', '.join(f'{t:.4f}' for t in ts)} ms [{card}]", flush=True)
    return 0


def run_bf16(torch, libs, paths, card) -> int:
    """The bf16-operand forward's variants: checks, SASS, then times beside
    cuDNN's bf16 route."""
    import torch.nn.functional as F

    from michigan_tpu_torch.ops import filters
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.ops.cuda import orient as O

    stream = lambda: torch.cuda.current_stream().cuda_stream
    names = [v for v in FWD16_VARIANTS if v in libs]

    def fwd16(v, gray, bank, idx, conf):
        n, _, h, w = gray.shape
        build.check_launch(v, libs[v].filterbank_orientation_bf16ops(
            gray.data_ptr(), bank.data_ptr(), idx.data_ptr(), conf.data_ptr(), n, h, w, stream()))

    for v in names:
        print(f"sass {v}: {sass_mma(paths[v], 'filterbank_bf16_kernel')}", flush=True)
    failed = []
    for size in ((2, 512, 512), (2, 37, 53)):
        gray = strand_planes(torch, size[0], 512, 5)[..., :size[1], :size[2]].contiguous()
        g16 = gray.bfloat16().double()
        for mode in ("gabor", "dog"):
            bank = filters.bank(mode, gray.device)
            res = F.conv2d(g16, bank.bfloat16().double().permute(3, 2, 0, 1), padding=8)
            res = res.bfloat16().double().clamp_min(0.0)
            c64, i64 = res.max(dim=1)
            p_idx, p_conf = O.filterbank_orientation_plain(gray, bank, True)
            p_err = (p_conf.double() - c64).abs().max().item()
            print(f"bf16 operands {mode} {size} against float64 sums of the bf16 operands "
                  f"(rounded to bf16): plain conf err {p_err:.3e}, argmax mismatch "
                  f"{(p_idx != i64).float().mean().item():.2e}", flush=True)
            idx = torch.empty(size, dtype=torch.int32, device="cuda")
            conf = torch.empty(size, device="cuda")
            for v in names:
                if "diag:" in v:  # no result to check
                    continue
                fwd16(v, gray, bank, idx, conf)
                torch.cuda.synchronize()
                err = (conf.double() - c64).abs().max().item()
                differ = idx != p_idx
                a, b = (res.gather(1, i.long()[:, None])[:, 0][differ] for i in (idx, p_idx))
                ties = bool(((a - b).abs() <= 1e-3 + 1e-2 * b.abs()).all())
                frac = differ.float().mean().item()
                ok = torch.allclose(conf, p_conf, rtol=1e-2, atol=1e-3) and frac <= 1e-2 and \
                    ties and torch.equal(conf.bfloat16().float(), conf)
                print(f"  {v:>22}: conf err {err:.3e} against float64, {frac:.2e} of the argmax "
                      f"off the plain version's (near-ties {ties}), against float64's "
                      f"{(idx != i64).float().mean().item():.2e} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok and v == "as built":
                    failed.append(("bf16 forward", mode, size))
    if failed:
        print(f"FAIL: {failed}", file=sys.stderr)
        return 1
    bank = filters.bank("gabor", "cuda")
    times = {}
    for n in (8, 1):
        planes = strand_planes(torch, n, 512, 2)
        i_out = torch.empty((n, 512, 512), dtype=torch.int32, device="cuda")
        c_out = torch.empty((n, 512, 512), device="cuda")
        b16 = bank.bfloat16().permute(3, 2, 0, 1).contiguous()
        route = lambda: F.conv2d(planes.bfloat16(), b16, padding=8).clamp_min(0).max(dim=1)
        label = f"bf16 operands ({n},1,512^2)"
        for v in ("cuDNN bf16 route",) + tuple(names) + tuple(names[::-1]) + ("cuDNN bf16 route",):
            fn = route if v == "cuDNN bf16 route" else \
                lambda v=v: fwd16(v, planes, bank, i_out, c_out)
            times.setdefault((label, v), []).append(median_ms(fn, torch, inner=10))
    for (label, v), ts in times.items():
        print(f"{label} {v:>22}: {', '.join(f'{t:.4f}' for t in ts)} ms [{card}]", flush=True)
    return 0


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from michigan_tpu_torch.ops.cuda import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16_only = "--bf16" in argv
    names = FWD16_VARIANTS if bf16_only else tuple(VARIANTS)
    libs, ptxas, paths, failed = build_variants(build, names)
    for v, kernels in ptxas.items():
        print(f"ptxas {v}: {' | '.join(kernels)}", flush=True)
    for v, err in failed.items():
        print(f"nvcc refused {v}:\n{err}", flush=True)
    if not bf16_only and run_f32(torch, libs, card):
        return 1
    return run_bf16(torch, libs, paths, card)


if __name__ == "__main__":
    sys.exit(main())
