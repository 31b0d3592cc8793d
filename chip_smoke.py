#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (michigan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives three paths of the port at full width on seeded random weights and
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
  `compute_orientation_map`;
- one G+D training step of the config of record (bench.py's training flags:
  multiscale D, every default loss, TTUR Adam, ngf 64, ndf 64, 512^2, batch
  8, fp32; torch's default conv init) through the trainer's
  `TrainStep.g_step` and `d_step`.

Phases, each on its own line:

  1. card name and power limit (nvidia-smi), torch and CUDA versions; TF32
     off for cuDNN convolutions and matmuls; neither jax nor any module of
     the JAX package (michigan_tpu) was loaded by the port's imports
  2. build the four CUDA libraries from michigan_tpu_torch/csrc, one nvcc
     each, all started together
  3. each kernel against its plain PyTorch version at every distinct shape
     of both paths: spade_modulate and fused_instance_norm in float32 (atol
     1e-4, rtol 1e-5) and bfloat16 (atol 1e-2, rtol 1.6e-2, about two bf16
     ulps); conv3x3_in_act in float32 (atol 1e-4, rtol 1e-4: sums of C*9
     products in another order); filterbank_orientation in float32 (the
     response within rtol 1e-4, atol 1e-3; the argmax off on at most 0.1% of
     pixels, and then by one orientation, or by more where float64's
     responses of the two orientations tie within that tolerance: the DoG
     bank's rounding-level ties, printed with their evidence), and against a float64 bank conv
     at (2, 1, 512^2) on strand planes, Gabor and DoG (its largest response
     error at most 2x the plain version's in fp32; its argmax mismatch at
     most the plain version's plus 1e-4 of pixels)
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
  9. stroke-path timings (median): conv3x3_in_act in turns with the route
     it replaces (cuDNN conv + fused_instance_norm) and its plain version,
     filterbank_orientation and its plain version, at the path's shapes;
     conv3x3_in_act and its plain version in fp32 against the float64
     composition at batch 2 (the kernel's largest error at most 2x the
     plain version's); one inpainter forward with and without
     --use_pallas_epilogue, the edit end to end at batch 1, and
     compute_orientation_map per 512^2 and 1024^2 image, and a profiler
     breakdown of one edit

  10. the training step's two new kernels against their plain versions:
      conv3x3_same_lowch at VGG features_2's (16, 64, 512^2) and a ragged
      (2, 64, 37, 53) (max abs error within 1e-4 of the output's largest
      magnitude), filterbank_orientation_backward at (8, 1, 512^2) for Gabor
      and DoG on a dense random dconf and on the same dconf times the hair
      masks of synthetic_train_data (the step's sparsity: the loss multiplies
      by the hair), within 1e-4 of the gradient's largest magnitude;
      conv3x3_same_lowch and F.conv2d in fp32 against a float64 conv at
      (2, 64, 512^2) (the kernel's largest error at most 2x F.conv2d's);
      device times of every kernel of the step at its shapes, kernel and
      plain (conv3x3_same_lowch in turns with F.conv2d, its TFLOP/s at 2
      FLOP per FMA; the backward on both dconf inputs, with the share of the
      kernel's 16 x 32 warp blocks that gradient reaches), and
      F.instance_norm on fused_instance_norm's act=None calls
  11. the training step on the card at batch 8 (out of memory fails the
      phase): launches per step exactly 29 fused_instance_norm (the frozen
      IG), 1 conv3x3_same_lowch (features_2 of the no-grad tag+ref VGG
      tower), 1 filterbank_orientation and 1 filterbank_orientation_backward
      (the ORIENT/CONFIDENCE loss), no spade_modulate or conv3x3_in_act;
      losses finite, netG and netD changed, netIG and VGG19 bit-identical;
      one warm-up then 5 timed steps (ms/step, img/s, peak device memory)
      and one profiled step
  12. one G+D step on the card and on the CPU (plain versions) from the same
      weights, batch 1, crop PARITY_CROP at full width: per-term losses
      within rtol 1e-4, atol 1e-5; netG after the G step and netD after the
      D step (both started from the card's post-G state) by the scale-aware
      rule of tests/test_training.py; netG's running statistics and
      spectral u / v within rtol 1e-4, atol 1e-5

Then a JSON line of per-kernel results: for the training step's kernels
(fused_instance_norm, filterbank_orientation and its backward,
conv3x3_same_lowch) launches in phase 11's counted step and times summed over
one step's calls (the backward on the hair-masked dconf); for spade_modulate
and conv3x3_in_act, which the step does
not run, launches in phase 7's stroke edit and times over one edit.  Each
row's bound_ms is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its FLOPs over the card's peak for
them (dense products 495/3 TFLOP/s through 3xTF32, the rest 67 TFLOP/s of
float32 FMA), from this run's shapes and data (the backward: 289 FMAs per
pixel that carries a gradient, dconf != 0 and conf > 0); library_ms is one PyTorch
call that computes the same function where there is one (F.conv2d for
conv3x3_same_lowch; F.instance_norm for fused_instance_norm's act=None
calls), else null.  Last,
the device line.  Any failure exits non-zero without the device line; so
does a machine without CUDA, and a directory without the rest of the
repository.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import types

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
FB_F64_IDX = 1e-4  # the argmax's extra mismatch against float64 over the plain version's
FLAGSHIP_LAUNCHES = {"spade_modulate": 18, "fused_instance_norm": 29, "conv3x3_in_act": 0,
                     "filterbank_orientation": 0, "filterbank_orientation_backward": 0,
                     "conv3x3_same_lowch": 0}
STROKE_LAUNCHES = {"spade_modulate": 18, "fused_instance_norm": 10, "conv3x3_in_act": 48,
                   "filterbank_orientation": 1, "filterbank_orientation_backward": 0,
                   "conv3x3_same_lowch": 0}
STEP_LAUNCHES = {"spade_modulate": 0, "fused_instance_norm": 29, "conv3x3_in_act": 0,
                 "filterbank_orientation": 1, "filterbank_orientation_backward": 1,
                 "conv3x3_same_lowch": 1}
REPLACES = {"spade_modulate": "michigan_tpu/ops/pallas/spade.py:285",
            "fused_instance_norm": "michigan_tpu/ops/pallas/spade.py:207",
            "conv3x3_in_act": "michigan_tpu/ops/pallas/epilogue.py:89",
            "filterbank_orientation": "michigan_tpu/ops/pallas/filterbank.py:44",
            # the TPU kernel is forward-only; its gradient is the custom VJP here
            "filterbank_orientation_backward": "michigan_tpu/ops/filters.py:232",
            "conv3x3_same_lowch": "michigan_tpu/ops/pallas/conv_lowch.py:99"}
SOURCES = {"spade_modulate": "michigan_tpu_torch/csrc/spade_norm.cu",
           "fused_instance_norm": "michigan_tpu_torch/csrc/spade_norm.cu",
           "conv3x3_in_act": "michigan_tpu_torch/csrc/conv_in_act.cu",
           "filterbank_orientation": "michigan_tpu_torch/csrc/filterbank.cu",
           "filterbank_orientation_backward": "michigan_tpu_torch/csrc/filterbank.cu",
           "conv3x3_same_lowch": "michigan_tpu_torch/csrc/conv_lowch.cu"}
# the training step: bench.py's training flags (the config of record), with
# torch's default conv init as the other phases.  Under the default gain-0.02
# xavier init phase 12 reads 0.10-0.11% of netG's elements past its rule's
# 0.1%: held against a float64 step on the CPU, the card's step is 0.09% off
# and the CPU's fp32 step 0.03%.  The card's extra error comes from cuDNN's
# fp32 convolutions (the implicit-GEMM forward and the Winograd weight
# gradient err ~10x more than the CPU's conv at these shapes) and gathers in
# head_0's gradients; with cuDNN off the card's step is 0.02% off.  Under
# this init card vs CPU reads 0.06-0.07%
TRAIN_FLAGS = ("--netG spadeb --use_encoder --use_ig --noise_background --expand_mask_be "
               "--expand_th 5 --random_expand_mask --num_upsampling_layers more "
               "--init_type none --gpu_ids 0").split()
TRAIN_BATCH = 8  # the slice's batch: an out-of-memory error fails phase 11
TRAIN_STEPS = 5
EXTRA_DILATE = 2  # the expected random mask dilation (encoder.py:294)
PARITY_CROP = 512
LOWCH_SHAPES = [(16, 64, 512, 512), (2, 64, 37, 53)]  # features_2 at batch 8; a ragged tile
NEW_KERNEL_REL = 1e-4  # of the reference's largest magnitude
F64_RATIO = 2.0  # a conv kernel's error against float64 at most 2x F.conv2d's in fp32
SEED = 0
# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s; float32
# FMAs outside the tensor cores; float32-accurate products on the tensor
# cores through the 3xTF32 split, a third of the 495 TFLOP/s TF32 rate
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32X3_FLOP_S = 495e12 / 3


def bound(nbytes, flops, flop_s):
    """(ms, what sets it): the least time for moving `nbytes` once at the
    HBM rate and doing `flops` at `flop_s`, the larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv3x3_work(n, c, co, h, w, pad, extra_bytes=0):
    """(bytes, FLOPs) of one 3x3 convolution of an (n, c, h+2pad, w+2pad)
    float32 input to (n, co, h, w), 2 FLOPs per FMA."""
    nbytes = 4 * (n * c * (h + 2 * pad) * (w + 2 * pad) + co * c * 9 + n * co * h * w)
    return nbytes + extra_bytes, 2 * n * co * h * w * c * 9


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
    """(device busy ms, wall ms, table) of one call under torch.profiler;
    raises when the profiler lists no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    # the union of the device activities' intervals; CUPTI's "Command Buffer
    # Full" rows mark a stalled host, not device work
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != "Command Buffer Full")
    if not spans:
        raise RuntimeError("the profiler listed no device activity")
    busy_us, end = 0.0, -math.inf
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us * 1e-3, wall_ms, table


def rel_err(got, want64):
    """Largest error against a float64 result, over its largest magnitude."""
    return ((got.double() - want64).abs().max() / want64.abs().max()).item()


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


def fb_compare(torch, got, want, gray, bank):
    """(ok, conf max abs error, share of pixels whose argmax differs, note).
    The argmax may differ on at most FB_IDX_FRAC of the pixels, and there by
    one orientation, or by more where the two orientations' responses tie
    in float64 within FB_TOL (the symmetric DoG bank's rounding-level ties);
    the note gives those pixels' float64 evidence."""
    idx, conf = got
    p_idx, p_conf = want
    off = (idx - p_idx) % 32
    frac = (off != 0).float().mean().item()
    far = (off > 1) & (off < 31)
    ties_ok, note = True, ""
    if far.any():
        res = float64_responses(gray, bank)
        n_, y_, x_ = far.nonzero(as_tuple=True)
        rk, rp = (res[n_, i[far].long(), y_, x_] for i in (idx, p_idx))
        best = res[n_, :, y_, x_].max(dim=1).values
        gap = (rk - rp).abs()
        ties_ok = bool((gap <= FB_TOL["atol"] + FB_TOL["rtol"] * best).all())
        note = (f"; {int(far.sum())} differ by more than one orientation, where float64's "
                f"responses of the two differ by at most {gap.max().item():.2e} and its max is "
                f"the kernel's at {int((rk == best).sum())}, the plain version's at "
                f"{int((rp == best).sum())}")
        del res
    ok = torch.allclose(conf, p_conf, **FB_TOL) and frac <= FB_IDX_FRAC and ties_ok
    return ok, (conf - p_conf).abs().max().item(), frac, note


def train_grays(torch, n=8):
    """(n, 1, 512, 512) gray planes of strand images: the orientation loss's
    input at the training step's shape (n = 8), textured so that the bank's
    clamped responses have no exact ties."""
    from michigan_tpu_torch.ops.filters import rgb_to_gray255

    imgs = torch.stack([strand_image(torch, 512, SEED + i) for i in range(n)]) * 2 - 1
    return rgb_to_gray255(imgs).permute(0, 3, 1, 2).contiguous()


def float64_responses(gray, bank):
    """The (N, 32, H, W) clamped bank responses, computed in float64."""
    import torch.nn.functional as F

    res = F.conv2d(gray.double(), bank.double().permute(3, 2, 0, 1), padding=bank.shape[0] // 2)
    return res.clamp_min(0.0)


def train_hair(torch):
    """(8, 512, 512) hair masks of the training step's batch
    (synthetic_train_data at batch 8), on the card."""
    from michigan_tpu_torch.data.synthetic import synthetic_train_data

    data = synthetic_train_data(types.SimpleNamespace(crop_size=512), SEED, TRAIN_BATCH)
    return torch.from_numpy(data["label_tag"][..., 0]).cuda()


def live_share(torch, g, block):
    """The share of `block` (rows, columns) output blocks that a nonzero g
    (N, H, W) reaches through the 17 x 17 bank: those the backward kernel
    does not skip."""
    import torch.nn.functional as F

    reach = F.max_pool2d((g != 0).float()[:, None], 17, stride=1, padding=8)
    return F.max_pool2d(reach, block, stride=block, ceil_mode=True).mean().item()


def scale_aware(got, want, max_lr):
    """tests/test_training.py:212-247's rule over {name: tensor} on the CPU:
    every element within 2.5 max_lr (Adam's first step moves a parameter by
    about +-lr, so a near-zero gradient of the other sign gives 2 lr), at
    most 0.1% of the elements (or 8) beyond float noise.  Returns (ok, max
    diff, elements beyond noise, elements)."""
    worst, n_bad, n_tot = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        worst = max(worst, d.max().item())
        n_bad += int((d > 1e-4 * w.double().abs() + 1e-5).sum())
        n_tot += d.numel()
    return worst <= 2.5 * max_lr and n_bad <= max(1e-3 * n_tot, 8), worst, n_bad, n_tot


def step_breakdown(torch, trainer, batch):
    """Host-clock ms (median of 3, each ending in a synchronize) of the
    training step's parts, each run alone on the step's batch; nothing is
    written (parameters, buffers) and nothing is kept."""
    from michigan_tpu_torch.models.layers import frozen_buffers

    m = trainer.model
    n = batch["image_tag"].shape[0]
    with frozen_buffers(m.netG):
        pre = m.preprocess(batch)
        orient = m.orient_for_training(pre)
        with torch.no_grad():
            fake = m.generate_fake(pre, orient, EXTRA_DILATE).requires_grad_()

        def g_fwd_bwd():
            m.generate_fake(pre, orient, EXTRA_DILATE).sum().backward()

        def vgg():
            sum(f.sum() for f in m.vgg(fake)).backward()
            with torch.no_grad():
                m.vgg(torch.cat([pre["image_tag"], pre["image_ref"]]))

        def d_fwd_bwd():
            pf, pr = m.discriminate(pre["input_tag"], fake, pre["image_tag"], orient)
            sum(t.sum() for s_ in pf + pr for t in s_).backward()

        def recompute():
            with torch.no_grad():
                m.generate_fake(pre, orient, EXTRA_DILATE)

        parts = {
            "frozen IG inpainting (no grad)": lambda: m.orient_for_training(pre),
            "netG forward + backward": g_fwd_bwd,
            "VGG19: fake tower + backward, tag+ref tower (no grad)": vgg,
            f"netD on fake+real ({2 * n}) forward + backward": d_fwd_bwd,
            "netG forward without grad (the D step's recompute)": recompute,
        }
        out = {k: host_ms(f, torch, 3) for k, f in parts.items()}
    for net in (m.netG, m.netD):
        for p in net.parameters():
            p.grad = None
    return out


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
            synthetic_train_data,
        )
        from michigan_tpu_torch.demo import engine
        from michigan_tpu_torch.inference import parse_options
        from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
        from michigan_tpu_torch.models.inpaint import InpaintGenerator
        from michigan_tpu_torch.ops import cuda as kernels
        from michigan_tpu_torch.ops import filters
        from michigan_tpu_torch.ops.cuda import build
        from michigan_tpu_torch.ops.cuda import epilogue as E
        from michigan_tpu_torch.ops.cuda import lowch as LC
        from michigan_tpu_torch.ops.cuda import orient as O
        from michigan_tpu_torch.ops.cuda import spade as K
        from michigan_tpu_torch.train import parse_options as train_options
        from michigan_tpu_torch.training.train_step import TrainStep
        from michigan_tpu_torch.utils.imaging import tensor2im
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "michigan_tpu"))
    if leaked:
        return fail(f"the port loaded jax or the JAX package: {leaked[:8]}")
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
        ok, err, frac, note = fb_compare(torch, O.filterbank_orientation(gray, bank),
                                         O.filterbank_orientation_plain(gray, bank), gray, bank)
        torch.cuda.synchronize()
        max_err["filterbank_orientation"] = max(max_err["filterbank_orientation"], err)
        print(f"[phase 3] filterbank_orientation {mode} {plane} {size}^2: conf max_abs_err "
              f"{err:.3e}, argmax differs on {frac:.2e} of pixels{note} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
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
    # against float64 at (2, 1, 512^2) on strand planes: the kernel and the
    # plain version (cuDNN's fp32 conv, TF32 off)
    gray = train_grays(torch, 2)
    for mode in ("gabor", "dog"):
        bank = filters.bank(mode, gray.device)
        c64, i64 = float64_responses(gray, bank).max(dim=1)
        (k_idx, k_conf), (p_idx, p_conf) = (O.filterbank_orientation(gray, bank),
                                            O.filterbank_orientation_plain(gray, bank))
        k_err, p_err = ((c - c64).abs().max().item() for c in (k_conf.double(), p_conf.double()))
        k_mis, p_mis = ((i != i64).float().mean().item() for i in (k_idx, p_idx))
        ok = k_err <= F64_RATIO * p_err and k_mis <= p_mis + FB_F64_IDX
        print(f"[phase 3] filterbank_orientation {mode} (2,1,512,512) against float64: conf "
              f"max_abs_err kernel {k_err:.3e}, plain version in fp32 {p_err:.3e} (limit "
              f"{F64_RATIO:g}x); argmax differs on {k_mis:.2e} / {p_mis:.2e} of pixels (limit "
              f"plain + {FB_F64_IDX:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("filterbank_orientation float64", mode))
    if failed:
        return fail(f"kernel disagrees with its plain version: {failed}")
    # not live when phase 6 reads peak memory
    del inp, got, want, x, g, b, extra, xp, w, bias, r, gray, z, z_idx, z_conf, i64, c64, k_idx, \
        k_conf, p_idx, p_conf

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
    work = {k: [0, 0] for k in REPLACES}  # bytes and FLOPs per edit or step
    for kind in ("spade_modulate", "fused_instance_norm"):
        for (k, c, h, act), (tk, tp) in shape_ms.items():
            if k != kind:
                continue
            calls = SPADE_SHAPES[(c, h)] if kind == "spade_modulate" \
                else STROKE_IN_SHAPES.get((c, h, act), 0)
            edit_ms[kind] += calls * tk
            edit_plain_ms[kind] += calls * tp
            if kind == "spade_modulate":  # x, gamma, beta in, y out; ~4 FLOPs each
                work[kind][0] += calls * 4 * 4 * c * h * h
                work[kind][1] += calls * 4 * c * h * h
    epi_route_ms = 0.0
    for case, calls in EPI_SHAPES.items():
        n, c, h, d, act, res = case
        xp, w, bias, r = epilogue_inputs(torch, case, gen)
        fk = lambda: E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r)
        fp = lambda: E.conv3x3_in_act_plain(xp, w, bias, dilation=d, act=act, residual=r)

        def route():  # the resblock without the epilogue: cuDNN conv, fused_instance_norm
            y = K.fused_instance_norm(F.conv2d(xp, w, bias, dilation=d), act=act)
            return y if r is None else r + y

        # in turns: route, kernel, kernel, route
        turns = {route: [], fk: []}
        for f in (route, fk, fk, route):
            turns[f].append(median_ms(f, torch, True))
        tk, tr = statistics.mean(turns[fk]), statistics.mean(turns[route])
        tp = median_ms(fp, torch, True)
        hk, hp = median_ms(fk, torch, False), median_ms(fp, torch, False)
        edit_ms["conv3x3_in_act"] += calls * tk
        edit_plain_ms["conv3x3_in_act"] += calls * tp
        epi_route_ms += calls * tr
        nbytes, flops = conv3x3_work(n, c, c, h, h, d, 4 * (c + (n * c * h * h if res else 0)))
        work["conv3x3_in_act"][0] += calls * nbytes
        work["conv3x3_in_act"][1] += calls * flops
        bound_us = bound(nbytes, flops, TF32X3_FLOP_S)[0] * 1e3
        print(f"[phase 9] conv3x3_in_act x_pad ({n},{c},{h + 2 * d},{h + 2 * d}) dilation {d} "
              f"act={act} residual={res} x{calls}/edit: device kernel "
              f"{', '.join(f'{t * 1e3:.1f}' for t in turns[fk])} us "
              f"({flops / 1e9 / tk:.1f} TFLOP/s; bound {bound_us:.1f} us), cuDNN conv + "
              f"fused_instance_norm "
              f"{', '.join(f'{t * 1e3:.1f}' for t in turns[route])} us (in turns: route, kernel, "
              f"kernel, route), plain (cuDNN conv + torch norm) {tp * 1e3:.1f} us; launched "
              f"from Python kernel {hk * 1e3:.1f} us, plain {hp * 1e3:.1f} us {tag}", flush=True)
    # against float64 at batch 2 of the path's shape: the kernel and the plain
    # version (cuDNN's fp32 conv, TF32 off, and the torch norm)
    failed = []
    for d, act, res in ((2, "relu", False), (1, None, True)):
        xp, w, bias, r = epilogue_inputs(torch, (2, 256, 64, d, act, res), gen)
        want = E.conv3x3_in_act_plain(xp.double(), w.double(), bias.double(), d, act,
                                      residual=None if r is None else r.double())
        k_rel = rel_err(E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r), want)
        p_rel = rel_err(E.conv3x3_in_act_plain(xp, w, bias, dilation=d, act=act, residual=r), want)
        ok = k_rel <= F64_RATIO * p_rel
        print(f"[phase 9] conv3x3_in_act (2,256,{64 + 2 * d},{64 + 2 * d}) dilation {d} act={act} "
              f"residual={res} against float64, largest error over the largest magnitude: kernel "
              f"{k_rel:.3e}, plain version in fp32 {p_rel:.3e} (limit {F64_RATIO:g}x) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("conv3x3_in_act float64", d))
    if failed:
        return fail(f"kernel less accurate than cuDNN's fp32 conv: {failed}")
    del xp, w, bias, r, fk, fp, route, want
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
    for kind in (k for k in REPLACES if STROKE_LAUNCHES[k]):
        phase(9, f"{kind} per stroke edit: device kernel {edit_ms[kind]:.3f} ms, plain "
                 f"{edit_plain_ms[kind]:.3f} ms {tag}")
    phase(9, f"the route conv3x3_in_act replaces (cuDNN conv + fused_instance_norm) per stroke "
             f"edit: {epi_route_ms:.3f} ms {tag}")

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

    del smodel, sbatch, u8, sfake, s_orient, img, hair
    torch.cuda.empty_cache()

    # 10 --------------------------------------------------------------
    new_err = {"conv3x3_same_lowch": 0.0, "filterbank_orientation_backward": 0.0}
    cgen = torch.Generator(device="cuda").manual_seed(SEED)
    failed = []
    for shape in LOWCH_SHAPES:
        # features_2's input is features_0's ReLU output; kaiming-scaled weights
        x = torch.randn(shape, generator=cgen, device="cuda").relu_()
        w = torch.randn((64, shape[1], 3, 3), generator=cgen, device="cuda") \
            * math.sqrt(2 / (9 * shape[1]))
        got, want = LC.conv3x3_same_lowch(x, w), LC.conv3x3_same_lowch_plain(x, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        new_err["conv3x3_same_lowch"] = max(new_err["conv3x3_same_lowch"], err)
        ok = rel <= NEW_KERNEL_REL
        print(f"[phase 10] conv3x3_same_lowch {shape} vs F.conv2d: max_abs_err {err:.3e}, "
              f"{rel:.2e} of the output's largest magnitude {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failed.append(("conv3x3_same_lowch", shape))
    del x, w, got, want
    grays, hair = train_grays(torch), train_hair(torch)
    for mode in ("gabor", "dog"):
        bank = filters.bank(mode, grays.device)
        idx, conf = O.filterbank_orientation(grays, bank)
        dense = torch.randn(hair.shape, generator=cgen, device="cuda")
        dconfs = {"dense": dense, "hair-masked": dense * hair}
        fwd_ok, _, frac, _ = fb_compare(torch, (idx, conf),
                                        O.filterbank_orientation_plain(grays, bank), grays, bank)
        for name, dconf in dconfs.items():
            got = O.filterbank_orientation_backward(dconf, idx, conf, bank)
            want = O.filterbank_orientation_backward_plain(dconf, idx, conf, bank)
            g = grays.clone().requires_grad_()
            (auto,) = torch.autograd.grad(O.filterbank_orientation_plain(g, bank)[1], g, dconf)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            auto_rel = (auto - want).abs().max().item() / scale
            new_err["filterbank_orientation_backward"] = max(
                new_err["filterbank_orientation_backward"], err)
            ok = err / scale <= NEW_KERNEL_REL and fwd_ok
            print(f"[phase 10] filterbank_orientation_backward {mode} (8,1,512,512) {name} dconf: "
                  f"max_abs_err {err:.3e}, {err / scale:.2e} of the gradient's largest magnitude; "
                  f"the plain version vs autograd through the plain forward {auto_rel:.2e}; "
                  f"forward argmax differs on {frac:.2e} of pixels {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append(("filterbank_orientation_backward", mode, name))
    if failed:
        return fail(f"kernel disagrees with its plain version: {failed}")
    del g, auto, got, want
    # against float64 at batch 2 of features_2's shape: the kernel and
    # F.conv2d in fp32 (TF32 off)
    x = torch.randn((2, 64, 512, 512), generator=cgen, device="cuda").relu_()
    w = torch.randn((64, 64, 3, 3), generator=cgen, device="cuda") * math.sqrt(2 / 576)
    want = LC.conv3x3_same_lowch_plain(x.double(), w.double())
    k_rel = rel_err(LC.conv3x3_same_lowch(x, w), want)
    p_rel = rel_err(LC.conv3x3_same_lowch_plain(x, w), want)
    ok = k_rel <= F64_RATIO * p_rel
    print(f"[phase 10] conv3x3_same_lowch (2,64,512,512) against float64, largest error over the "
          f"largest magnitude: kernel {k_rel:.3e}, F.conv2d in fp32 {p_rel:.3e} (limit "
          f"{F64_RATIO:g}x) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        return fail("conv3x3_same_lowch is less accurate than cuDNN's fp32 conv")
    del x, w, want
    # device time of every kernel of the step at its shapes, summed over one
    # step's calls (the frozen IG runs at batch 8); bytes and FLOPs for the
    # bounds; one library call where one computes the same function
    step_ms, step_plain_ms, library_ms = {}, {}, {}
    n_, c_, h_, w_ = LOWCH_SHAPES[0]
    x = torch.randn(LOWCH_SHAPES[0], generator=cgen, device="cuda").relu_()
    w = torch.randn((64, c_, 3, 3), generator=cgen, device="cuda") * math.sqrt(2 / (9 * c_))
    fk = lambda: LC.conv3x3_same_lowch(x, w)
    fp = lambda: LC.conv3x3_same_lowch_plain(x, w)
    turns = {fk: [], fp: []}
    for f in (fp, fk, fk, fp):  # in turns
        turns[f].append(median_ms(f, torch, True, inner=5))
    step_ms["conv3x3_same_lowch"] = statistics.mean(turns[fk])
    # the plain version is one library call, F.conv2d(x, w, padding=1)
    step_plain_ms["conv3x3_same_lowch"] = statistics.mean(turns[fp])
    library_ms["conv3x3_same_lowch"] = step_plain_ms["conv3x3_same_lowch"]
    work["conv3x3_same_lowch"] = list(conv3x3_work(n_, c_, 64, h_, w_, 0))
    lc_bound = bound(*work["conv3x3_same_lowch"], TF32X3_FLOP_S)
    tflops = work["conv3x3_same_lowch"][1] / 1e9 / step_ms["conv3x3_same_lowch"]
    print(f"[phase 10] conv3x3_same_lowch {LOWCH_SHAPES[0]} x1/step: device kernel "
          f"{', '.join(f'{t:.3f}' for t in turns[fk])} ms ({tflops:.1f} TFLOP/s at 2 FLOP per "
          f"FMA; bound {lc_bound[0]:.3f} ms by {lc_bound[1]}), F.conv2d (the plain version) "
          f"{', '.join(f'{t:.3f}' for t in turns[fp])} ms (in turns: F.conv2d, kernel, kernel, "
          f"F.conv2d) {tag}", flush=True)
    del x, w, fk, fp, turns
    bank = filters.bank("gabor", grays.device)
    idx, conf = O.filterbank_orientation(grays, bank)
    fk = lambda: O.filterbank_orientation(grays, bank)
    fp = lambda: O.filterbank_orientation_plain(grays, bank)
    k = "filterbank_orientation"
    step_ms[k], step_plain_ms[k] = (median_ms(f, torch, True, inner=5) for f in (fk, fp))
    # the bank forward: 289 taps x 32 orientations per pixel, a dense product;
    # its backward: 289 taps per pixel that carries a gradient (dconf != 0,
    # conf > 0: this run's data), a gather; 4-byte gray, idx, conf and
    # gradient planes
    pixels, bank_bytes = grays.numel(), bank.numel() * 4
    work[k] = [12 * pixels + bank_bytes, 2 * pixels * 32 * 289]
    k = "filterbank_orientation_backward"
    for name, dconf in dconfs.items():
        fk = lambda: O.filterbank_orientation_backward(dconf, idx, conf, bank)
        fp = lambda: O.filterbank_orientation_backward_plain(dconf, idx, conf, bank)
        tk, tp = (median_ms(f, torch, True, inner=5) for f in (fk, fp))
        carry = int(((dconf != 0) & (conf > 0)).sum())
        b_ms, b_by = bound(16 * pixels + bank_bytes, 2 * 289 * carry, FP32_FLOP_S)
        share = live_share(torch, torch.where(conf > 0, dconf, 0), O.BACKWARD_SKIP_BLOCK)
        print(f"[phase 10] {k} (8,1,512,512) {name} dconf: device kernel {tk * 1e3:.1f} us, "
              f"plain {tp * 1e3:.1f} us; {carry / pixels:.3f} of pixels carry a gradient, "
              f"{share:.3f} of the kernel's {O.BACKWARD_SKIP_BLOCK[0]} x "
              f"{O.BACKWARD_SKIP_BLOCK[1]} warp blocks are reached by one; bound "
              f"{b_ms * 1e3:.1f} us by {b_by} {tag}", flush=True)
        # the step's own input: its loss multiplies by the hair
        step_ms[k], step_plain_ms[k] = tk, tp
        work[k] = [16 * pixels + bank_bytes, 2 * 289 * carry]
    step_ms["fused_instance_norm"] = step_plain_ms["fused_instance_norm"] = 0.0
    in_lib = {"kernel": 0.0, "F.instance_norm": 0.0, "calls": 0}
    for (c, h, act), calls in IN_SHAPES.items():
        inp = kernel_inputs(torch, "fused_instance_norm", c, h, torch.float32, gen, n=8)
        tk = median_ms(lambda: K.fused_instance_norm(*inp, act=act), torch, True)
        step_ms["fused_instance_norm"] += calls * tk
        step_plain_ms["fused_instance_norm"] += calls * median_ms(
            lambda: K.fused_instance_norm_plain(*inp, act=act), torch, True)
        work["fused_instance_norm"][0] += calls * 2 * inp[0].numel() * 4
        work["fused_instance_norm"][1] += calls * 8 * inp[0].numel()
        if act is None:  # F.instance_norm computes the same function only without act
            in_lib["kernel"] += calls * tk
            in_lib["F.instance_norm"] += calls * median_ms(
                lambda: F.instance_norm(inp[0], eps=1e-5), torch, True)
            in_lib["calls"] += calls
    library_ms["fused_instance_norm"] = in_lib["F.instance_norm"]
    del grays, hair, dense, dconfs, idx, conf, dconf, inp, fk, fp
    for k in step_ms:
        phase(10, f"{k} per training step: device kernel {step_ms[k]:.3f} ms, plain "
                  f"{step_plain_ms[k]:.3f} ms {tag}")
    phase(10, f"fused_instance_norm on the step's {in_lib['calls']} act=None calls: device "
              f"kernel {in_lib['kernel']:.3f} ms, F.instance_norm "
              f"{in_lib['F.instance_norm']:.3f} ms {tag}")
    torch.cuda.empty_cache()

    # 11 --------------------------------------------------------------
    def make_trainer(n, crop):
        o = train_options(TRAIN_FLAGS + ["--batchSize", str(n), "--crop_size", str(crop),
                                         "--load_size", str(crop), "--seed", str(SEED)])
        m = MichiGANModel(o, "cuda:0")
        m.init_weights(SEED)
        return o, TrainStep(m)

    def snapshot(net):
        return {k: v.detach().clone() for k, v in net.state_dict().items()}

    n = TRAIN_BATCH
    topt, trainer = make_trainer(n, 512)
    tbatch = batch_from_numpy(synthetic_train_data(topt, SEED, n), "cuda:0")
    before = {k: snapshot(net) for k, net in trainer.model.nets().items()}
    kernels.reset_launch_counts()
    g_losses, _fake, orient_t = trainer.g_step(tbatch, EXTRA_DILATE)
    d_losses = trainer.d_step(tbatch, EXTRA_DILATE, orient_t)
    torch.cuda.synchronize()
    step_counts = kernels.launch_counts()
    phase(11, f"training step on the card, batch {n}, {topt.crop_size}^2, ngf {topt.ngf}, "
              f"ndf {topt.ndf}: launches {step_counts}")
    if step_counts != STEP_LAUNCHES:
        return fail(f"expected launches per step {STEP_LAUNCHES}, got {step_counts}")
    losses = {k: v.item() for k, v in {**g_losses, **d_losses}.items()}
    phase(11, "losses " + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    nets = trainer.model.nets()
    moved = {k: any(not torch.equal(p, before[k][name]) for name, p in nets[k].named_parameters())
             for k in ("netG", "netD")}
    frozen = {k: all(torch.equal(t, before[k][name]) for name, t in nets[k].state_dict().items())
              for k in ("netIG", "vgg")}
    phase(11, f"parameters changed {moved}; frozen nets bit-identical {frozen}")
    if not all(math.isfinite(v) for v in losses.values()) or not all(moved.values()) \
            or not all(frozen.values()):
        return fail("the training step's losses or parameter updates are wrong")
    del before

    def train_step():
        _g, _f, o = trainer.g_step(tbatch, EXTRA_DILATE)
        trainer.d_step(tbatch, EXTRA_DILATE, o)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ms_step = statistics.median(times)
    phase(11, f"{TRAIN_STEPS} timed steps after the warm-up: {', '.join(f'{t:.1f}' for t in times)} "
              f"ms; median {ms_step:.1f} ms/step, {n / ms_step * 1e3:.2f} img/s; peak device "
              f"memory {peak / 2**30:.2f} GiB, of which {live / 2**30:.2f} GiB live before the "
              f"steps (weights, optimizer state, batch) {tag}")
    if counts != {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}:
        return fail(f"launches over {TRAIN_STEPS} steps: {counts}")
    g_times, d_times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        _g, _f, o = trainer.g_step(tbatch, EXTRA_DILATE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.d_step(tbatch, EXTRA_DILATE, o)
        torch.cuda.synchronize()
        g_times.append((t1 - t0) * 1e3)
        d_times.append((time.perf_counter() - t1) * 1e3)
    phase(11, f"G step {statistics.median(g_times):.1f} ms, D step "
              f"{statistics.median(d_times):.1f} ms (medians of 3) {tag}")
    for k, v in step_breakdown(torch, trainer, tbatch).items():
        phase(11, f"  part, alone: {k}: {v:.1f} ms {tag}")
    busy_ms, wall_ms, table = profile_once(train_step, torch)
    phase(11, f"profiled training step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
              f"under the profiler {tag}; top device time:")
    print(table, flush=True)
    del trainer, tbatch, nets, g_losses, d_losses, orient_t, _fake
    torch.cuda.empty_cache()

    # 12 --------------------------------------------------------------
    popt, card = make_trainer(1, PARITY_CROP)
    cpu_model = MichiGANModel(popt, "cpu")
    cpu_model.load_state_dicts({k: {n_: t.cpu() for n_, t in net.state_dict().items()}
                                for k, net in card.model.nets().items()})
    cpu = TrainStep(cpu_model)
    data = synthetic_train_data(popt, SEED, 1)
    b_card, b_cpu = batch_from_numpy(data, "cuda:0"), batch_from_numpy(data, "cpu")
    g_card, _, o_card = card.g_step(b_card, EXTRA_DILATE)
    t0 = time.perf_counter()
    g_cpu, _, o_cpu = cpu.g_step(b_cpu, EXTRA_DILATE)
    t_g = time.perf_counter() - t0
    state = lambda net, params: {k: v.detach().cpu() for k, v in (
        net.named_parameters() if params else net.named_buffers())}
    g_params = scale_aware(state(cpu_model.netG, True), state(card.model.netG, True),
                           popt.lr / 2)
    bufs_card, bufs_cpu = state(card.model.netG, False), state(cpu_model.netG, False)
    buf_err = max((bufs_cpu[k] - v).abs().max().item() for k, v in bufs_card.items()
                  if v.is_floating_point())
    bufs_ok = all(torch.allclose(bufs_cpu[k], v, rtol=1e-4, atol=1e-5)
                  for k, v in bufs_card.items() if v.is_floating_point())
    # the D step on both from the card's post-G state: the G step's few
    # Adam sign flips would otherwise move the recomputed fake
    cpu_model.netG.load_state_dict({k: v.cpu() for k, v in card.model.netG.state_dict().items()})
    d_card = card.d_step(b_card, EXTRA_DILATE, o_card)
    t0 = time.perf_counter()
    d_cpu = cpu.d_step(b_cpu, EXTRA_DILATE, o_cpu)
    t_d = time.perf_counter() - t0
    d_params = scale_aware(state(cpu_model.netD, True), state(card.model.netD, True),
                           2 * popt.lr)
    loss_rows, losses_ok = [], True
    for k in list(g_card) + list(d_card):
        a = (g_card.get(k) if k in g_card else d_card[k]).item()
        b = (g_cpu.get(k) if k in g_cpu else d_cpu[k]).item()
        ok = abs(a - b) <= 1e-5 + 1e-4 * abs(b)
        losses_ok &= ok
        loss_rows.append(f"{k} {a:.6f}/{b:.6f}{'' if ok else ' FAIL'}")
    phase(12, f"one G+D step card/CPU, batch 1, {PARITY_CROP}^2, ngf {popt.ngf}, ndf "
              f"{popt.ndf}: " + ", ".join(loss_rows))
    phase(12, f"netG after the G step: max diff {g_params[1]:.2e} (limit {2.5 * popt.lr / 2:.1e}), "
              f"{g_params[2]} of {g_params[3]} elements beyond float noise; netG buffers max "
              f"diff {buf_err:.2e}; netD after the D step: max diff {d_params[1]:.2e} (limit "
              f"{2.5 * 2 * popt.lr:.1e}), {d_params[2]} of {d_params[3]} beyond float noise; "
              f"CPU G step {t_g:.1f} s, D step {t_d:.1f} s")
    if not (losses_ok and g_params[0] and d_params[0] and bufs_ok):
        return fail("the card's and the CPU's training steps disagree")
    del card, cpu, cpu_model

    train_kernels = ("fused_instance_norm", "filterbank_orientation",
                     "filterbank_orientation_backward", "conv3x3_same_lowch")
    rows = {k: (stroke_counts[k], edit_ms[k], edit_plain_ms[k])
            for k in ("spade_modulate", "conv3x3_in_act")}
    rows.update({k: (step_counts[k], step_ms[k], step_plain_ms[k]) for k in train_kernels})
    max_err.update(new_err)
    # dense products at the 3xTF32 rate; norms and the gather at fp32 FMA's
    rates = {k: TF32X3_FLOP_S if k in ("conv3x3_in_act", "filterbank_orientation",
                                       "conv3x3_same_lowch") else FP32_FLOP_S for k in REPLACES}
    bounds = {k: bound(*work[k], rates[k]) for k in REPLACES}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": rows[k][0], "max_abs_err": max_err[k], "ms": rows[k][1],
         "plain_ms": rows[k][2], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library_ms.get(k), **({"library_covers": (
             f"the step's {in_lib['calls']} act=None calls, where the kernel takes "
             f"{in_lib['kernel']} ms")} if k == "fused_instance_norm" else {})}
        for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
