#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (michigan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives two paths of the port at full width on seeded random weights and
seeded numpy samples, each through its own entry points:

- the flagship inference path (IG orientation inpainting -> partial-conv
  appearance encoder -> noise background encoder -> SPADEB generator with
  eval-mode running stats; ngf 64, 512^2 crop, add_feat_zeros: generator
  planes up to 576^2) through `MichiGANModel.infer`;
- the interactive stroke edit (the demo's flags plus --use_pallas_epilogue:
  the stroke's orientation from the DoG filter bank on the card, IG prefill
  of the uncovered hair, SIG stroke inpainting, the SPADEB generator, the
  crop and uint8 encode on the card) through the demo engine's
  `orient_stroke_plane` and `render_edit`, and the dense-orientation tool's
  `compute_orientation_map`.

Phases, each on its own line:

  1. card name and power limit (nvidia-smi), torch and CUDA versions; TF32
     off for cuDNN convolutions and matmuls
  2. build the three CUDA libraries from michigan_tpu_torch/csrc, one nvcc
     each, all started together
  3. each kernel against its plain PyTorch version at every distinct shape
     of both paths: spade_modulate and fused_instance_norm in float32 (atol
     1e-4, rtol 1e-5) and bfloat16 (atol 1e-2, rtol 1.6e-2, about two bf16
     ulps); conv3x3_in_act in float32 (atol 1e-4, rtol 1e-4: sums of C*9
     products in another order); filterbank_orientation in float32 (the
     response within rtol 1e-4, atol 1e-3; the argmax off on at most 0.1% of
     pixels, and then by one orientation)
  4. the flagship on the card, counting launches: 18 spade_modulate and 29
     fused_instance_norm per forward, no other kernel
  5. the flagship on the CPU (plain versions), same weights and inputs: tanh
     output within 2e-3 max abs, PSNR of the uint8 image > 50 dB
  6. flagship timings (median): each kernel and its plain version at the
     path's shapes, end-to-end ms/image at batch 1 and 8, peak device memory,
     a torch.profiler breakdown of one batch-1 forward
  7. the stroke edit on the card, counting launches: 1 filterbank_orientation,
     48 conv3x3_in_act (IG prefill and SIG), 10 fused_instance_norm and 18
     spade_modulate; the output finite and in [-1, 1]
  8. the stroke edit on the CPU, same weights and inputs: within 2e-3 max abs
     and PSNR > 50 dB; compute_orientation_map on a seeded 512^2 image and
     mask: at most 1% of pixels differ from the CPU's
  9. stroke-path timings (median): the two new kernels and their plain
     versions at the path's shapes, one inpainter forward with and without
     --use_pallas_epilogue, the edit end to end at batch 1, and
     compute_orientation_map per 512^2 and 1024^2 image, and a profiler
     breakdown of one edit

Then a JSON line of per-kernel results for the stroke edit (launches in
phase 7's run; times summed over one edit's calls) and, last, the device
line.  Any failure exits non-zero without the device line; so does a machine
without CUDA, and a directory without the rest of the repository.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

FLAGS = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
         "--expand_th 5 --add_feat_zeros --init_type none --gpu_ids 0").split()
# the demo's flags (demo_options' defaults) plus the fused resblock epilogue
STROKE_FLAGS = "--use_pallas_epilogue --init_type none --gpu_ids 0".split()

# distinct shapes of the flagship at batch 1: (C, H=W) of the generator's
# SPADE norms, and (C, H=W, act) of the inpainter's norms, with calls per
# forward
SPADE_SHAPES = {(1024, 9): 2, (1024, 18): 2, (1024, 36): 2, (1024, 72): 2, (512, 72): 1,
                (512, 144): 2, (256, 144): 1, (256, 288): 2, (128, 288): 1,
                (128, 576): 2, (64, 576): 1}
IN_SHAPES = {(64, 256, "lrelu"): 1, (128, 128, "lrelu"): 1, (256, 64, "lrelu"): 1,
             (256, 64, "relu"): 12, (256, 64, None): 12, (128, 128, "relu"): 1,
             (64, 256, "relu"): 1}
# the stroke edit runs two inpainters with the epilogue: their encoder and
# decoder norms go through fused_instance_norm, their resblocks through
# conv3x3_in_act at (n, C, output H=W, dilation, act, residual)
STROKE_IN_SHAPES = {(64, 256, "lrelu"): 2, (128, 128, "lrelu"): 2, (256, 64, "lrelu"): 2,
                    (128, 128, "relu"): 2, (64, 256, "relu"): 2}
EPI_SHAPES = {(1, 256, 64, 2, "relu", False): 24, (1, 256, 64, 1, None, True): 24,
              (2, 256, 64, 1, None, True): 0}  # batch 2 is off the path
# (mode, size, plane, calls per edit): the stroke mask is the path's call;
# the gray planes are compute_orientation_map's at 512^2 and FFHQ's 1024^2
FB_CASES = [("dog", 512, "stroke mask", 1), ("dog", 512, "gray", 0),
            ("dog", 1024, "gray", 0), ("gabor", 512, "gray", 0)]
TOLS = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}
EPI_TOL = dict(atol=1e-4, rtol=1e-4)
FB_TOL = dict(rtol=1e-4, atol=1e-3)
FB_IDX_FRAC = 1e-3
FLAGSHIP_LAUNCHES = {"spade_modulate": 18, "fused_instance_norm": 29, "conv3x3_in_act": 0,
                     "filterbank_orientation": 0}
STROKE_LAUNCHES = {"spade_modulate": 18, "fused_instance_norm": 10, "conv3x3_in_act": 48,
                   "filterbank_orientation": 1}
REPLACES = {"spade_modulate": "michigan_tpu/ops/pallas/spade.py:285",
            "fused_instance_norm": "michigan_tpu/ops/pallas/spade.py:207",
            "conv3x3_in_act": "michigan_tpu/ops/pallas/epilogue.py:89",
            "filterbank_orientation": "michigan_tpu/ops/pallas/filterbank.py:44"}
SOURCES = {"spade_modulate": "michigan_tpu_torch/csrc/spade_norm.cu",
           "fused_instance_norm": "michigan_tpu_torch/csrc/spade_norm.cu",
           "conv3x3_in_act": "michigan_tpu_torch/csrc/conv_in_act.cu",
           "filterbank_orientation": "michigan_tpu_torch/csrc/filterbank.cu"}
SEED = 0


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, torch, graph, reps=5, inner=20):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    by CUDA events.  With `graph`, the calls are captured once in a CUDA
    graph and replayed, which leaves the host's launch cost out: device
    time.  Without, the calls are launched from Python as the path
    launches them: at small shapes that measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run_all = g.replay
    else:
        def run_all():
            for _ in range(inner):
                fn()
    run_all()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run_all()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def host_ms(fn, torch, reps):
    """Median host-clock time of fn() followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def profile_once(fn, torch):
    """(device busy ms, wall ms, table) of one call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    # the table's own footer: device time summed over the kernels
    busy = re.search(r"Self (?:CUDA|device) time total: ([\d.]+)(us|ms|s)\b", table)
    busy_ms = float(busy.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[busy.group(2)]
    return busy_ms, wall_ms, table


def psnr_u8(a, b, np):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def kernel_inputs(torch, kind, c, h, dtype, gen, n=1):
    """As the path gives them: spade_modulate's gamma and beta are the two
    channel halves of one (n, 2C, H, W) conv output."""
    x = torch.randn((n, c, h, h), generator=gen).to("cuda", dtype)
    if kind == "spade_modulate":
        mean = torch.randn(c, generator=gen).cuda()
        inv = torch.rand(c, generator=gen).add(0.5).cuda()
        gamma_beta = torch.randn((n, 2 * c, h, h), generator=gen).to("cuda", dtype)
        return (x, mean, inv, *gamma_beta.chunk(2, dim=1))
    return (x,)


def epilogue_inputs(torch, case, gen):
    """(x_pad, w, b, residual) at one conv3x3_in_act shape of the path, the
    weight at the scale of a spectrally normalised 256-channel conv."""
    n, c, h, d, _act, res = case
    x = torch.randn((n, c, h + 2 * d, h + 2 * d), generator=gen).cuda()
    w = (torch.randn((c, c, 3, 3), generator=gen) * 0.02).cuda()
    b = torch.randn(c, generator=gen).cuda()
    r = torch.randn((n, c, h, h), generator=gen).cuda() if res else None
    return x, w, b, r


def strand_image(torch, size, seed):
    """(size, size, 3) float in [0, 1], on the card: strands whose angle
    turns across the image, plus noise: a hair-like texture with a defined
    orientation almost everywhere."""
    gen = torch.Generator().manual_seed(seed)
    ax = torch.arange(size, dtype=torch.float32) / size
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    angle = math.pi * (xx + 0.5 * yy)
    wave = torch.sin(2 * math.pi * 40 * (xx * torch.cos(angle) + yy * torch.sin(angle)))
    img = 0.5 + 0.35 * wave[..., None] + 0.1 * torch.rand((size, size, 3), generator=gen)
    return img.clamp(0, 1).cuda()


def ellipse_mask(torch, size):
    ax = torch.arange(size, dtype=torch.float32) / size
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    return ((((yy - 0.4) / 0.3) ** 2 + ((xx - 0.5) / 0.35) ** 2) < 1).float().cuda()


def fb_plane(torch, mode, size, plane, stroke_mask):
    """The (1, 1, size, size) float32 plane of one FB_CASES entry."""
    from michigan_tpu_torch.ops.filters import rgb_to_gray255

    if plane == "stroke mask":
        return stroke_mask
    img = strand_image(torch, size, SEED) * 2 - 1
    return rgb_to_gray255(img[None]).permute(0, 3, 1, 2).contiguous()


def fb_compare(torch, got, want):
    """(ok, conf max abs error, share of pixels whose argmax differs)."""
    idx, conf = got
    p_idx, p_conf = want
    off = (idx - p_idx) % 32
    frac = (off != 0).float().mean().item()
    ok = torch.allclose(conf, p_conf, **FB_TOL) and frac <= FB_IDX_FRAC and \
        bool(((off == 0) | (off == 1) | (off == 31)).all())
    return ok, (conf - p_conf).abs().max().item(), frac


def run():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from michigan_tpu_torch import cal_orientation
        from michigan_tpu_torch.data.synthetic import (
            synthetic_inference_data,
            synthetic_stroke_data,
        )
        from michigan_tpu_torch.demo import engine
        from michigan_tpu_torch.inference import parse_options
        from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
        from michigan_tpu_torch.models.inpaint import InpaintGenerator
        from michigan_tpu_torch.ops import cuda as kernels
        from michigan_tpu_torch.ops import filters
        from michigan_tpu_torch.ops.cuda import build
        from michigan_tpu_torch.ops.cuda import epilogue as E
        from michigan_tpu_torch.ops.cuda import orient as O
        from michigan_tpu_torch.ops.cuda import spade as K
        from michigan_tpu_torch.utils.imaging import tensor2im
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    # 1 ---------------------------------------------------------------
    card = card_info()
    tag = f"[{card}]"
    phase(1, f"card: {card}")
    phase(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase(1, "TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False "
             "(cuDNN's fp32 convolutions default to TF32)")

    # 2 ---------------------------------------------------------------
    prebuilt = {name: build.library_path(name).exists() for name in build.SIGNATURES}
    t0 = time.perf_counter()
    libs = build.build_all()
    for name in libs:
        build.load(name)
    phase(2, f"{', '.join(p.name for p in libs.values())}: "
             f"{'already built, loaded' if all(prebuilt.values()) else 'nvcc builds (in parallel) and load'} "
             f"in {time.perf_counter() - t0:.2f} s")

    # 3 ---------------------------------------------------------------
    plain = {"spade_modulate": K.spade_modulate_plain,
             "fused_instance_norm": K.fused_instance_norm_plain}
    kern = {"spade_modulate": K.spade_modulate, "fused_instance_norm": K.fused_instance_norm}
    cases = [("spade_modulate", c, h, None) for c, h in SPADE_SHAPES]
    cases += [("fused_instance_norm", c, h, act) for c, h, act in IN_SHAPES]
    max_err = {k: 0.0 for k in REPLACES}
    gen = torch.Generator().manual_seed(SEED)
    failed = []
    for dname, tol in TOLS.items():
        dtype = getattr(torch, dname)
        for kind, c, h, act in cases:
            inp = kernel_inputs(torch, kind, c, h, dtype, gen)
            kw = {} if kind == "spade_modulate" else {"act": act}
            got = kern[kind](*inp, **kw)
            want = plain[kind](*inp, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **tol)
            if dname == "float32":
                max_err[kind] = max(max_err[kind], err)
            print(f"[phase 3] {kind} {dname} (1,{c},{h},{h}) act={act}: "
                  f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((kind, dname, c, h, act))
    # batch 8 (the halves of gamma/beta lie apart per sample), and the
    # modulated instance norm (SPADE's instance variant, off the path)
    x, g, b = (torch.randn((1, 256, 64, 64), generator=gen).cuda() for _ in range(3))
    extra = {"spade_modulate float32 (8,512,72,72)":
             (kern["spade_modulate"], plain["spade_modulate"],
              kernel_inputs(torch, "spade_modulate", 512, 72, torch.float32, gen, n=8)),
             "fused_instance_norm float32 (1,256,64,64) with gamma/beta":
             (kern["fused_instance_norm"], plain["fused_instance_norm"], (x, g, b))}
    for label, (fk, fp, inp) in extra.items():
        got, want = fk(*inp), fp(*inp)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **TOLS["float32"])
        print(f"[phase 3] {label}: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(label)
    for case in EPI_SHAPES:
        n, c, h, d, act, res = case
        xp, w, bias, r = epilogue_inputs(torch, case, gen)
        got = E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r)
        want = E.conv3x3_in_act_plain(xp, w, bias, dilation=d, act=act, residual=r)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **EPI_TOL)
        max_err["conv3x3_in_act"] = max(max_err["conv3x3_in_act"], err)
        print(f"[phase 3] conv3x3_in_act float32 x_pad ({n},{c},{h + 2 * d},{h + 2 * d}) "
              f"dilation {d} act={act} residual={res}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("conv3x3_in_act", case))
    stroke_opt = engine.parse_options(STROKE_FLAGS + ["--seed", str(SEED)])
    stroke_data = synthetic_stroke_data(stroke_opt, SEED)
    stroke_mask = torch.from_numpy(stroke_data["mask_stroke"]).permute(0, 3, 1, 2) \
        .contiguous().cuda()
    for mode, size, plane, _calls in FB_CASES:
        gray = fb_plane(torch, mode, size, plane, stroke_mask)
        bank = filters.bank(mode, gray.device)
        ok, err, frac = fb_compare(torch, O.filterbank_orientation(gray, bank),
                                   O.filterbank_orientation_plain(gray, bank))
        torch.cuda.synchronize()
        max_err["filterbank_orientation"] = max(max_err["filterbank_orientation"], err)
        print(f"[phase 3] filterbank_orientation {mode} {plane} {size}^2: conf max_abs_err "
              f"{err:.3e}, argmax differs on {frac:.2e} of pixels {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failed.append(("filterbank_orientation", mode, size, plane))
    z = torch.zeros((1, 1, 64, 64), device="cuda")
    z_idx, z_conf = O.filterbank_orientation(z, filters.bank("dog", z.device))
    torch.cuda.synchronize()
    ok = not z_idx.any() and not z_conf.any()
    print(f"[phase 3] filterbank_orientation on an all-zero plane: idx 0, conf 0 "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failed.append("filterbank_orientation ties")
    if failed:
        return fail(f"kernel disagrees with its plain version: {failed}")
    # not live when phase 6 reads peak memory
    del inp, got, want, x, g, b, extra, xp, w, bias, r, gray, z, z_idx, z_conf

    # 4 ---------------------------------------------------------------
    opt = parse_options(FLAGS + ["--seed", str(SEED)])
    model = MichiGANModel(opt, "cuda:0")
    model.init_weights(SEED)
    data = synthetic_inference_data(opt, SEED)
    batch = batch_from_numpy(data, "cuda:0")
    kernels.reset_launch_counts()
    fake, orient_rgb = model.infer(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    phase(4, f"flagship on the card: fake {tuple(fake.shape)}, orient_rgb "
             f"{tuple(orient_rgb.shape)}, launches {counts}")
    if counts != FLAGSHIP_LAUNCHES:
        return fail(f"expected launches {FLAGSHIP_LAUNCHES}, got {counts}")
    size = opt.generator_input_size()
    if fake.shape != (1, 3, size, size) or not torch.isfinite(fake).all() \
            or fake.abs().max() > 1 or fake.std() < 1e-3:
        return fail(f"generator output is wrong: shape {tuple(fake.shape)}, "
                    f"std {fake.std().item()}")
    phase(4, f"output finite, in [-1,1], std {fake.std().item():.4f}")

    # 5 ---------------------------------------------------------------
    def to_cpu_model(m, o):
        cpu_model = MichiGANModel(o, "cpu")
        cpu_model.load_state_dicts({k: {n: t.cpu() for n, t in net.state_dict().items()}
                                    for k, net in m.nets().items()})
        return cpu_model

    def crop_u8(t, o):
        r = o.add_th // 2
        return tensor2im(t.permute(0, 2, 3, 1).cpu().numpy()[
            0, r : r + o.crop_size, r : r + o.crop_size])

    cpu = to_cpu_model(model, opt)
    t0 = time.perf_counter()
    fake_cpu, _ = cpu.infer(batch_from_numpy(data, "cpu"))
    cpu_s = time.perf_counter() - t0
    diff = (fake.cpu() - fake_cpu).abs().max().item()
    psnr = psnr_u8(crop_u8(fake, opt), crop_u8(fake_cpu, opt), np)
    phase(5, f"card vs CPU: max_abs {diff:.3e} (limit 2e-3), PSNR {psnr:.2f} dB "
             f"(limit 50); CPU forward {cpu_s:.1f} s")
    if not diff <= 2e-3 or not psnr > 50:
        return fail("card and CPU outputs disagree")
    del cpu, fake_cpu

    # 6 ---------------------------------------------------------------
    # per forward, summed over the path's calls: device time (CUDA graph
    # replay) and time as launched from Python; per shape for phase 9
    shape_ms = {}
    kernel_ms, plain_ms = {k: 0.0 for k in kern}, {k: 0.0 for k in kern}
    kernel_host_ms, plain_host_ms = {k: 0.0 for k in kern}, {k: 0.0 for k in kern}
    for kind, c, h, act in cases:
        calls = SPADE_SHAPES[(c, h)] if kind == "spade_modulate" else IN_SHAPES[(c, h, act)]
        inp = kernel_inputs(torch, kind, c, h, torch.float32, gen)
        kw = {} if kind == "spade_modulate" else {"act": act}
        fk = lambda: kern[kind](*inp, **kw)
        fp = lambda: plain[kind](*inp, **kw)
        tk, tp = median_ms(fk, torch, True), median_ms(fp, torch, True)
        hk, hp = median_ms(fk, torch, False), median_ms(fp, torch, False)
        shape_ms[(kind, c, h, act)] = (tk, tp)
        kernel_ms[kind] += calls * tk
        plain_ms[kind] += calls * tp
        kernel_host_ms[kind] += calls * hk
        plain_host_ms[kind] += calls * hp
        print(f"[phase 6] {kind} (1,{c},{h},{h}) act={act} x{calls}/forward: "
              f"device kernel {tk * 1e3:.1f} us, plain {tp * 1e3:.1f} us; "
              f"launched from Python kernel {hk * 1e3:.1f} us, plain {hp * 1e3:.1f} us "
              f"{tag}", flush=True)
    del inp, fk, fp
    for kind in kern:
        phase(6, f"{kind} per forward: device kernel {kernel_ms[kind]:.3f} ms, plain "
                 f"{plain_ms[kind]:.3f} ms; launched from Python kernel "
                 f"{kernel_host_ms[kind]:.3f} ms, plain {plain_host_ms[kind]:.3f} ms {tag}")

    def e2e(n, reps):
        b = batch_from_numpy(synthetic_inference_data(opt, SEED, batch=n), "cuda:0")
        model.infer(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        ms = host_ms(lambda: model.infer(b), torch, reps)
        return ms / n, torch.cuda.max_memory_allocated(), live

    for n, reps in ((1, 10), (8, 5)):
        ms, mem, live = e2e(n, reps)
        phase(6, f"end to end batch {n}: {ms:.2f} ms/image, peak device memory "
                 f"{mem / 2**30:.2f} GiB, of which {live / 2**30:.2f} GiB live before the "
                 f"forward (weights, inputs, this script's tensors) {tag}")

    busy_ms, wall_ms, table = profile_once(lambda: model.infer(batch), torch)
    phase(6, f"profiled batch-1 forward: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
             f"wall under the profiler {tag}; top device time:")
    print(table, flush=True)
    del model, batch, fake, orient_rgb

    # 7 ---------------------------------------------------------------
    smodel = MichiGANModel(stroke_opt, "cuda:0")
    smodel.init_weights(SEED)
    sbatch = batch_from_numpy(stroke_data, "cuda:0")

    def stroke_edit():
        """One edit as the demo engine runs it on the card: the stroke's
        orientation through the DoG bank, the forward, the display encode,
        and the one copy back."""
        b = dict(sbatch)
        b["orient_stroke"] = engine.orient_stroke_plane(b["mask_stroke"], b["label_tag"])
        return engine.render_edit(smodel, b, "stroke").cpu()

    kernels.reset_launch_counts()
    u8 = stroke_edit()
    torch.cuda.synchronize()
    stroke_counts = kernels.launch_counts()
    phase(7, f"stroke edit on the card: result and orientation {tuple(u8.shape)} "
             f"{u8.dtype}, launches {stroke_counts}")
    if stroke_counts != STROKE_LAUNCHES:
        return fail(f"expected launches {STROKE_LAUNCHES}, got {stroke_counts}")
    crop = stroke_opt.crop_size
    sbatch["orient_stroke"] = engine.orient_stroke_plane(sbatch["mask_stroke"],
                                                         sbatch["label_tag"])
    sfake, s_orient = smodel.infer(sbatch, "stroke")
    torch.cuda.synchronize()
    if u8.shape != (2, crop, crop, 3) or not torch.isfinite(sfake).all() \
            or sfake.abs().max() > 1 or sfake.std() < 1e-3:
        return fail(f"stroke edit output is wrong: {tuple(u8.shape)}, "
                    f"std {sfake.std().item()}")
    phase(7, f"output finite, in [-1,1], std {sfake.std().item():.4f}")

    # 8 ---------------------------------------------------------------
    scpu = to_cpu_model(smodel, stroke_opt)
    cbatch = batch_from_numpy(stroke_data, "cpu")
    cbatch["orient_stroke"] = engine.orient_stroke_plane(cbatch["mask_stroke"],
                                                         cbatch["label_tag"])
    plane_diff = (cbatch["orient_stroke"] != sbatch["orient_stroke"].cpu()).float().mean()
    t0 = time.perf_counter()
    sfake_cpu, s_orient_cpu = scpu.infer(cbatch, "stroke")
    cpu_s = time.perf_counter() - t0
    diff = (sfake.cpu() - sfake_cpu).abs().max().item()
    odiff = (s_orient.cpu() - s_orient_cpu).abs().max().item()
    psnr = psnr_u8(crop_u8(sfake, stroke_opt), crop_u8(sfake_cpu, stroke_opt), np)
    phase(8, f"stroke edit card vs CPU: orient_stroke plane differs on {plane_diff:.2e} of "
             f"its values; output max_abs {diff:.3e} (limit 2e-3), PSNR {psnr:.2f} dB "
             f"(limit 50); inpainted orientation max_abs {odiff:.3e}; CPU forward "
             f"{cpu_s:.1f} s")
    if not diff <= 2e-3 or not psnr > 50:
        return fail("card and CPU stroke edits disagree")
    del scpu, cbatch, sfake_cpu, s_orient_cpu
    img, hair = strand_image(torch, 512, SEED), ellipse_mask(torch, 512)
    map_card = cal_orientation.compute_orientation_map(img, hair).cpu()
    map_cpu = cal_orientation.compute_orientation_map(img.cpu(), hair.cpu())
    frac = (map_card != map_cpu).float().mean().item()
    phase(8, f"compute_orientation_map 512^2 card vs CPU: {frac:.2e} of pixels differ "
             f"(limit 1e-2); {map_card.dtype}, {int(map_card.float().mean())} mean level")
    if map_card.dtype != torch.uint8 or not frac <= 1e-2:
        return fail("card and CPU orientation maps disagree")

    # 9 ---------------------------------------------------------------
    edit_ms = {k: 0.0 for k in REPLACES}
    edit_plain_ms = {k: 0.0 for k in REPLACES}
    for kind in ("spade_modulate", "fused_instance_norm"):
        for (k, c, h, act), (tk, tp) in shape_ms.items():
            if k != kind:
                continue
            calls = SPADE_SHAPES[(c, h)] if kind == "spade_modulate" \
                else STROKE_IN_SHAPES.get((c, h, act), 0)
            edit_ms[kind] += calls * tk
            edit_plain_ms[kind] += calls * tp
    for case, calls in EPI_SHAPES.items():
        n, c, h, d, act, res = case
        xp, w, bias, r = epilogue_inputs(torch, case, gen)
        fk = lambda: E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r)
        fp = lambda: E.conv3x3_in_act_plain(xp, w, bias, dilation=d, act=act, residual=r)

        def route():  # the resblock without the epilogue: cuDNN conv, fused_instance_norm
            y = K.fused_instance_norm(F.conv2d(xp, w, bias, dilation=d), act=act)
            return y if r is None else r + y

        tk, tp, tr = (median_ms(f, torch, True) for f in (fk, fp, route))
        hk, hp = median_ms(fk, torch, False), median_ms(fp, torch, False)
        edit_ms["conv3x3_in_act"] += calls * tk
        edit_plain_ms["conv3x3_in_act"] += calls * tp
        gflops = 2 * n * c * c * 9 * h * h / 1e9
        print(f"[phase 9] conv3x3_in_act x_pad ({n},{c},{h + 2 * d},{h + 2 * d}) dilation {d} "
              f"act={act} residual={res} x{calls}/edit: device kernel {tk * 1e3:.1f} us "
              f"({gflops / tk:.1f} TFLOP/s), plain (cuDNN conv + torch norm) {tp * 1e3:.1f} us, "
              f"cuDNN conv + fused_instance_norm {tr * 1e3:.1f} us; launched from Python "
              f"kernel {hk * 1e3:.1f} us, plain {hp * 1e3:.1f} us {tag}", flush=True)
    del xp, w, bias, r, fk, fp, route
    for mode, size, plane, calls in FB_CASES:
        gray = fb_plane(torch, mode, size, plane, stroke_mask)
        bank = filters.bank(mode, gray.device)
        fk = lambda: O.filterbank_orientation(gray, bank)
        fp = lambda: O.filterbank_orientation_plain(gray, bank)
        tk, tp = median_ms(fk, torch, True), median_ms(fp, torch, True)
        hk, hp = median_ms(fk, torch, False), median_ms(fp, torch, False)
        edit_ms["filterbank_orientation"] += calls * tk
        edit_plain_ms["filterbank_orientation"] += calls * tp
        gflops = 2 * size * size * 32 * 289 / 1e9
        print(f"[phase 9] filterbank_orientation {mode} {plane} {size}^2 x{calls}/edit: "
              f"device kernel {tk * 1e3:.1f} us ({gflops / tk:.1f} TFLOP/s), plain "
              f"{tp * 1e3:.1f} us; launched from Python kernel {hk * 1e3:.1f} us, plain "
              f"{hp * 1e3:.1f} us {tag}", flush=True)
    del gray, fk, fp
    for kind in REPLACES:
        phase(9, f"{kind} per stroke edit: device kernel {edit_ms[kind]:.3f} ms, plain "
                 f"{edit_plain_ms[kind]:.3f} ms {tag}")

    # one inpainter forward at 256^2 without the epilogue (cuDNN conv +
    # fused_instance_norm) against the epilogue kernel, same weights; order
    # route, epilogue, epilogue, route
    igs = {}
    for epi in (False, True):
        igs[epi] = InpaintGenerator(epilogue=epi).eval().cuda()
        igs[epi].load_state_dict(smodel.netIG.state_dict())
    ig_in = torch.rand((1, 4, 256, 256), generator=gen).cuda()
    with torch.no_grad():
        ig_diff = (igs[True](ig_in) - igs[False](ig_in)).abs().max().item()
        ig_ms = {False: [], True: []}
        for epi in (False, True, True, False):
            fwd = lambda: igs[epi](ig_in)
            ig_ms[epi].append((median_ms(fwd, torch, True, inner=5),
                               median_ms(fwd, torch, False, inner=5)))
    for epi, label in ((False, "cuDNN conv + fused_instance_norm"),
                       (True, "--use_pallas_epilogue, conv3x3_in_act")):
        dev = ", ".join(f"{d:.3f}" for d, _ in ig_ms[epi])
        py = ", ".join(f"{p:.3f}" for _, p in ig_ms[epi])
        phase(9, f"inpainter forward 256^2, {label}: device {dev} ms; launched from Python "
                 f"{py} ms {tag}")
    phase(9, f"inpainter outputs of the two routes differ by {ig_diff:.3e} max abs")
    del igs, ig_in

    torch.cuda.reset_peak_memory_stats()
    edit = host_ms(stroke_edit, torch, 10)
    phase(9, f"stroke edit end to end, batch 1 (stroke orientation, IG prefill, SIG, "
             f"generator, crop and uint8 encode, copy back): {edit:.2f} ms/edit, peak device "
             f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
    for size, reps in ((512, 10), (1024, 5)):
        img, hair = strand_image(torch, size, SEED), ellipse_mask(torch, size)
        ms = host_ms(lambda: cal_orientation.compute_orientation_map(img, hair), torch, reps)
        phase(9, f"compute_orientation_map {size}^2: {ms:.3f} ms/image {tag}")
    busy_ms, wall_ms, table = profile_once(stroke_edit, torch)
    phase(9, f"profiled stroke edit: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
             f"under the profiler {tag}; top device time:")
    print(table, flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": stroke_counts[k], "max_abs_err": max_err[k], "ms": edit_ms[k],
         "plain_ms": edit_plain_ms[k]} for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
