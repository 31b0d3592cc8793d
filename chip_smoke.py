#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (michigan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives three paths of the port at full width on seeded random weights and
seeded numpy samples, each through its own entry points, and all three again
under the bf16 compute policy (--dtype bfloat16):

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
     most the plain version's plus 1e-4 of pixels); conv3x3_in_act in
     bfloat16 (bf16 x_pad and residual, the float32 spectral weight, the
     bf16 stored bias) at the edit's shapes against its plain version (atol
     1e-2, rtol 1.6e-2); and the bf16 tile's edges against their plain
     versions, with float32 and bf16 weights: conv3x3_in_act at odd C, W %
     8 != 0, dilation 4 and its forms (a tile per block; the pre-norm
     plane past 16 tiles; one block per plane where the card holds fewer
     blocks than planes), conv3x3_same_lowch at odd C and W,
     C too large for resident weights and fewer tiles than SMs; and the bf16
     training step's two forms at its shapes: the bank's bf16-operand
     forward at (8, 1, 512^2), Gabor and DoG (conf within one bf16 ulp, the
     argmax off on at most 1% of the pixels and only at bf16 near-ties), its
     kernel's SASS on bf16 tensor-core products and no TF32 mma (cuobjdump),
     and fused_instance_norm in bf16 at the frozen inpainter's shapes at
     batch 8 (with gamma and beta at the lrelu ones), each printed with the
     blocks a plane its shape gives it
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
      weights, batch 1, crop PARITY_CROP at full width, at torch's default
      conv init and at the config's own (xavier, gain 0.02): per-term losses
      within rtol 1e-4, atol 1e-5; netG after the G step and netD after the
      D step (both started from the card's post-G state) by the scale-aware
      rule of tests/test_training.py; netG's running statistics and
      spectral u / v within rtol 1e-4, atol 1e-5
  13. the flagship at --dtype bfloat16 on the card: launches per forward
      exactly 18 spade_modulate and 29 fused_instance_norm, all bfloat16,
      no other kernel; the output finite; against the same weights and
      inputs at bfloat16 on the CPU (plain versions), max abs within
      BF16_CAL x the CPU's own bf16-vs-fp32 difference (both printed, with
      the uint8 PSNR); ms/image at batch 1 and 8 and peak memory beside
      phase 6's fp32 numbers; each bf16 kernel and its plain version at the
      path's shapes; a profiler breakdown with cuDNN's share of device time
  14. the stroke edit at --dtype bfloat16 --use_pallas_epilogue: launches
      per edit exactly 48 conv3x3_in_act, 10 fused_instance_norm and 18
      spade_modulate in bfloat16 and 1 filterbank_orientation in float32;
      the same CPU comparison; ms/edit beside phase 9's; conv3x3_in_act in
      bfloat16 in turns with cuDNN's bf16 conv + fused_instance_norm and
      beside its plain version; it and that route against a float64
      composition at batch 2 (the kernel's largest error at most F64_RATIO
      x the route's) and its device kernels per call under the profiler, in
      a process of its own (tools/kernel_launches.py; exactly its layout
      pass and its convolution, one each); fused_instance_norm in bf16 at
      the edit's shapes (device time beside its bound and plain version);
      a profiler breakdown
  15. the training step at --dtype bfloat16: conv3x3_same_lowch in bf16
      against its plain version at (16, 64, 512^2) and (2, 64, 37, 53)
      (atol 1e-2, rtol 1.6e-2) and, with F.conv2d in bf16, against a
      float64 conv of the same bf16 values at batch 2 (at most 2x
      F.conv2d's error) and, under the profiler in a process of its own,
      exactly one device kernel per call; the bank's bf16-operand form
      against its plain version at (8, 1, 512^2), Gabor and DoG (conf within one bf16 ulp, the
      argmax off on at most 1% of the pixels and only at bf16 near-ties) and
      against float64 sums of the bf16 operands; both timed at the step's
      shapes (lowch in turns with F.conv2d in bf16, the bank in turns with
      cuDNN's bf16 route: the gray plane cast to bf16, the bf16 conv with
      the bank, the clamp, max and argmax), the bank's device kernels per
      call under the profiler in a process of its own (exactly one);
      fused_instance_norm in bf16 at the step's batch 8 (beside its bound,
      its plain version and F.instance_norm on the act=None calls); then
      the step at batch 8, 512^2, full width: launches per step exactly 29
      fused_instance_norm, 1 conv3x3_same_lowch and 1 bank forward in
      bfloat16 and 1 bank backward in float32; losses finite, netG and netD changed (float32),
      netIG and VGG19 bit-identical in bf16; ms/step, img/s, G and D step,
      peak memory and a profiled step with the convolutions' share, beside
      phase 11's float32 numbers; then one bf16 G+D step card vs CPU at
      PARITY16's batch, crop and width, the CPU's D steps from the card's
      post-G netG: per loss within BF16_CAL x the CPU's own bf16-vs-fp32
      difference of that loss (plus the fp32 agreement, rtol 1e-4, atol
      1e-5), netG's and netD's elements beyond float noise within BF16_CAL x
      the CPU's own count (plus 0.1%), every element within 2.5 lr; and a
      control that must fail that gate: the card's bf16 step on the first
      half of the batch

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
calls), else null.  The bf16 rows (phases 13-14: spade_modulate and
conv3x3_in_act over one bf16 edit, fused_instance_norm over one bf16
flagship forward) count 2-byte elements and bf16 products at 989 TFLOP/s,
and the two conv3x3_in_act rows carry the replaced route's time
(replaced_route_ms: cuDNN conv + fused_instance_norm, in the row's dtype).
The fused_instance_norm_bf16 row also carries the bf16 training step's
batch-8 calls (step_launches from phase 15's counted step; step_ms,
step_plain_ms, step_bound_ms, and step_library_ms: F.instance_norm on its
act=None calls) and the bf16 edit's (edit_ms, edit_bound_ms).  The bf16
training step's rows (phase 15: conv3x3_same_lowch_bf16 with F.conv2d in
bf16 as library_ms; filterbank_orientation_bf16, the bank's bf16-operand
form, with cuDNN's bf16 route as replaced_route_ms; both bound at 989
TFLOP/s of bf16 products) take their launches from phase 15's counted
step.  Last, the device line.  Any
failure exits non-zero without the device line; so does a machine without
CUDA, and a directory without the rest of the repository.

    python3 chip_smoke.py --host_ab DIR [PAIRS]

compares the port of another checkout DIR (the parent's ``git archive``)
with this one on the host clock, in fresh processes in turns: each bf16
fused_instance_norm call launched from Python, the bf16 flagship forward at
batch 1 and the bf16 stroke edit (host_ab; 10 pairs by default).
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
BF16_CAL = 2.0  # card-bf16 vs CPU-bf16 at most 2x the CPU's own bf16 vs fp32
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
# under --dtype bfloat16, by dtype
NO_LAUNCHES = {k: {} for k in FLAGSHIP_LAUNCHES}
FLAGSHIP_BF16_LAUNCHES = {**NO_LAUNCHES, "spade_modulate": {"bfloat16": 18},
                          "fused_instance_norm": {"bfloat16": 29}}
STROKE_BF16_LAUNCHES = {**NO_LAUNCHES, "spade_modulate": {"bfloat16": 18},
                        "fused_instance_norm": {"bfloat16": 10},
                        "conv3x3_in_act": {"bfloat16": 48},
                        "filterbank_orientation": {"float32": 1}}
# the bf16 training step: the frozen IG's norms and VGG's features_2 in bf16,
# the bank's forward on bf16 operands (counted as bfloat16), its gradient fp32
STEP_BF16_LAUNCHES = {**NO_LAUNCHES, "fused_instance_norm": {"bfloat16": 29},
                      "filterbank_orientation": {"bfloat16": 1},
                      "filterbank_orientation_backward": {"float32": 1},
                      "conv3x3_same_lowch": {"bfloat16": 1}}
# the kernels line's bf16 rows: (kernel, the bf16 run it is read from)
BF16_ROWS = {"spade_modulate": "edit", "fused_instance_norm": "flagship",
             "conv3x3_in_act": "edit"}
# the bf16 step's two new forms: the kernels line's rows, and what each replaces
STEP_BF16_ROWS = {"conv3x3_same_lowch": "michigan_tpu/ops/pallas/conv_lowch.py:99",
                  # the JAX package's bf16 forward (_fb_s2d_core with fwd_bf16)
                  "filterbank_orientation": "michigan_tpu/ops/filters.py:207"}
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
# torch's default conv init as the other phases; phase 12 also runs the
# config's own xavier init (gain 0.02), under which every conv on cuDNN put
# 0.101% of netG's elements past its rule's 0.1% (cuDNN's float32
# implicit-GEMM forward errs 3-5x PyTorch's own conv at the generator's
# high-channel blocks, which now take cuDNN off in train mode:
# models/generator.py CUDNN_OFF; tools/conv_algorithms.py)
TRAIN_FLAGS = ("--netG spadeb --use_encoder --use_ig --noise_background --expand_mask_be "
               "--expand_th 5 --random_expand_mask --num_upsampling_layers more "
               "--init_type none --gpu_ids 0").split()
TRAIN_BATCH = 8  # the slice's batch: an out-of-memory error fails phase 11
TRAIN_STEPS = 5
EXTRA_DILATE = 2  # the expected random mask dilation (encoder.py:294)
PARITY_CROP = 512
# phase 15's card-bf16 vs CPU-bf16 step at this batch, crop and width, so
# that the CPU's two steps (bf16 and fp32) fit the script's time
PARITY16 = dict(crop=256, ngf=32, ndf=32, batch=2)
FB16_TOL = dict(rtol=1e-2, atol=1e-3)  # one bf16 ulp of the response
FB16_IDX_FRAC = 1e-2
LOWCH_SHAPES = [(16, 64, 512, 512), (2, 64, 37, 53)]  # features_2 at batch 8; a ragged tile
# the bf16 tile's own edges in phase 3, each against its plain version:
# conv3x3_same_lowch (n, c, co, h, w): odd C and W, C too large for the
# resident weights (streamed), fewer tiles than SMs; conv3x3_in_act (n, c,
# co, h, w, dilation, act, residual): odd C, W % 8 != 0, dilation 4, and
# planes of more than 16 tiles (the pre-norm form), batch 2, and more
# planes than the card holds blocks for (one block walks each plane)
LOWCH_BF16_EDGES = [(1, 3, 70, 10, 11), (1, 160, 64, 20, 70), (1, 64, 64, 8, 64)]
EPI_BF16_EDGES = [(1, 7, 64, 9, 13, 2, "relu", True), (2, 20, 40, 13, 30, 1, "lrelu", False),
                  (1, 32, 32, 16, 16, 4, None, False), (2, 16, 24, 80, 80, 1, "relu", True),
                  (1, 256, 256, 96, 96, 2, "relu", False), (140, 8, 64, 8, 72, 1, "relu", True)]
# device kernels per call of the bf16 forms (torch.profiler): lowch one,
# in_act its layout pass and its convolution
BF16_KERNELS = {
    "conv3x3_in_act": {"in_act_layout_kernel": 1.0, "conv3x3_in_act_bf16_kernel": 1.0},
    "conv3x3_same_lowch": {"conv3x3_same_bf16_kernel": 1.0},
    "filterbank_orientation": {"filterbank_bf16_kernel": 1.0}}
NEW_KERNEL_REL = 1e-4  # of the reference's largest magnitude
F64_RATIO = 2.0  # a conv kernel's error against float64 at most 2x F.conv2d's in fp32
SEED = 0
# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s; float32
# FMAs outside the tensor cores; float32-accurate products on the tensor
# cores through the 3xTF32 split, a third of the 495 TFLOP/s TF32 rate
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
TF32X3_FLOP_S = TF32_FLOP_S / 3
# dense bf16 products on the tensor cores: the rate for bf16 operands
BF16_FLOP_S = 989e12


def bound(nbytes, flops, flop_s):
    """(ms, what sets it): the least time for moving `nbytes` once at the
    HBM rate and doing `flops` at `flop_s`, the larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv3x3_work(n, c, co, h, w, pad, extra_bytes=0, elem=4):
    """(bytes, FLOPs) of one 3x3 convolution of an (n, c, h+2pad, w+2pad)
    input to (n, co, h, w) of `elem`-byte elements, with a float32 weight,
    2 FLOPs per FMA."""
    nbytes = elem * (n * c * (h + 2 * pad) * (w + 2 * pad) + n * co * h * w) + 4 * co * c * 9
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


def edit_of(engine, m, batch_):
    def stroke_edit():
        """One edit as the demo engine runs it on the card: the stroke's
        orientation through the DoG bank, the forward, the display encode,
        and the one copy back."""
        b = dict(batch_)
        b["orient_stroke"] = engine.orient_stroke_plane(b["mask_stroke"], b["label_tag"])
        return engine.render_edit(m, b, "stroke").cpu()
    return stroke_edit


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


# every convolution: cuDNN's forwards, PyTorch's own forwards (the fp32
# generator's blocks off cuDNN in train mode) and every backward (the
# training steps'; the inference paths have neither of the last two)
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::_slow_conv2d_forward", "aten::convolution_backward")


def profile_once(fn, torch):
    """(device busy ms, wall ms, table, convolutions' device ms, device ms
    of every op) of one call under torch.profiler; raises when the profiler
    lists no device activity.  The last two sum the kernel durations the
    profiler attaches to the ops (CONV_OPS, each counted where it is the
    outermost; all ops), one accounting for both, so their ratio is the
    convolutions' share; device busy is the union of the device activities'
    intervals, which may overlap and are not all attached."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def attached_us(e):
        return sum(k.duration for k in e.kernels) + sum(attached_us(c) for c in e.cpu_children)

    def outermost(e):
        p = e.cpu_parent
        while p is not None and p.name not in CONV_OPS:
            p = p.cpu_parent
        return p is None

    ops = [e for e in prof.events() if e.device_type == CPU]
    conv_ms = sum(attached_us(e) for e in ops if e.name in CONV_OPS and outermost(e)) * 1e-3
    total_ms = sum(attached_us(e) for e in ops if e.cpu_parent is None) * 1e-3
    # CUPTI's "Command Buffer Full" rows mark a stalled host, not device work
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == CUDA and e.name != "Command Buffer Full")
    if not spans:
        raise RuntimeError("the profiler listed no device activity")
    busy_us, end = 0.0, -math.inf
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us * 1e-3, wall_ms, table, conv_ms, total_ms


def kernels_per_call(cases):
    """{device kernel: launches per call} over `cases` of
    tools/kernel_launches.py (one call each, under torch.profiler, in a
    process of its own)."""
    from michigan_tpu_torch.tools import kernel_launches

    counts = {}
    for key, n in kernel_launches.run(cases).items():
        name = kernel_launches.short_name(key)
        counts[name] = counts.get(name, 0) + n
    return {k: v / len(cases) for k, v in counts.items()}


def rel_err(got, want64):
    """Largest error against a float64 result, over its largest magnitude."""
    return ((got.double() - want64).abs().max() / want64.abs().max()).item()


def psnr_u8(a, b, np):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def kernel_inputs(torch, kind, c, h, dtype, gen, n=1):
    """As the path gives them: spade_modulate's gamma and beta are the two
    channel halves of one (n, 2C, H, W) conv output.  fused_instance_norm's
    planes carry a trend along H*W (4 linspace(-1, 1)), so that the slices a
    plane is split into differ in mean and spread: a merge that drops,
    doubles or mis-weights a slice, or leaves out the slices' spread of
    means, moves the output by far more than the tolerance (on i.i.d. planes
    the slices agree and such a merge passes: tools/norm_variants.py)."""
    x = torch.randn((n, c, h, h), generator=gen)
    if kind == "fused_instance_norm":
        x += 4 * torch.linspace(-1, 1, h * h).view(h, h)
    x = x.to("cuda", dtype)
    if kind == "spade_modulate":
        mean = torch.randn(c, generator=gen).cuda()
        inv = torch.rand(c, generator=gen).add(0.5).cuda()
        gamma_beta = torch.randn((n, 2 * c, h, h), generator=gen).to("cuda", dtype)
        return (x, mean, inv, *gamma_beta.chunk(2, dim=1))
    return (x,)


def in16_path(torch, F, K, shapes, n, gen, ph, per, tag):
    """fused_instance_norm in bf16 over one path's calls, {(C, H=W, act):
    calls} at batch n: device times of the kernel and its plain version
    summed over the calls, its bound's bytes (2 B in and out per element),
    and F.instance_norm beside the kernel on the act=None calls; prints each
    shape with the blocks a plane its form takes."""
    out = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "lib_ms": 0.0, "lib_kernel_ms": 0.0,
           "lib_calls": 0}
    for (c, h, act), calls in shapes.items():
        x = kernel_inputs(torch, "fused_instance_norm", c, h, torch.bfloat16, gen, n=n)[0]
        tk = median_ms(lambda: K.fused_instance_norm(x, act=act), torch, True)
        tp = median_ms(lambda: K.fused_instance_norm_plain(x, act=act), torch, True)
        out["ms"] += calls * tk
        out["plain_ms"] += calls * tp
        out["bytes"] += calls * 4 * x.numel()
        lib = ""
        if act is None:  # F.instance_norm computes the same function only without act
            tl = median_ms(lambda: F.instance_norm(x, eps=1e-5), torch, True)
            out["lib_ms"] += calls * tl
            out["lib_kernel_ms"] += calls * tk
            out["lib_calls"] += calls
            lib = f", F.instance_norm {tl * 1e3:.1f} us"
        print(f"[phase {ph}] fused_instance_norm bfloat16 ({n},{c},{h},{h}) act={act} x{calls}/"
              f"{per}, {K.instance_norm_bf16_split(x)} blocks a plane: device kernel "
              f"{tk * 1e3:.1f} us (bound {4 * x.numel() / HBM_BYTES_S * 1e6:.1f} us), plain "
              f"{tp * 1e3:.1f} us{lib} {tag}", flush=True)
    return out


def in16_rows(step, edit, step_counts):
    """The fused_instance_norm_bf16 row's keys for the bf16 training step
    (batch 8) and the bf16 edit beside the flagship's."""
    return {"step_launches": step_counts["fused_instance_norm"]["bfloat16"],
            "step_ms": step["ms"], "step_plain_ms": step["plain_ms"],
            "step_bound_ms": step["bytes"] / HBM_BYTES_S * 1e3,
            "step_library_ms": step["lib_ms"],
            "step_library_covers": (f"the step's {step['lib_calls']} act=None calls, where the "
                                    f"kernel takes {step['lib_kernel_ms']} ms"),
            "edit_ms": edit["ms"], "edit_bound_ms": edit["bytes"] / HBM_BYTES_S * 1e3}


def epilogue_inputs(torch, case, gen, dtype=None):
    """(x_pad, w, b, residual) at one conv3x3_in_act shape of the path, the
    weight at the scale of a spectrally normalised 256-channel conv.  In
    bfloat16 as the bf16 policy hands them over: x_pad and the residual
    bf16, the spectral weight float32, the frozen inpainter's bias bf16."""
    dtype = dtype or torch.float32
    n, c, h, d, _act, res = case
    x = torch.randn((n, c, h + 2 * d, h + 2 * d), generator=gen).to("cuda", dtype)
    w = (torch.randn((c, c, 3, 3), generator=gen) * 0.02).cuda()
    b = torch.randn(c, generator=gen).to("cuda", dtype)
    r = torch.randn((n, c, h, h), generator=gen).to("cuda", dtype) if res else None
    return x, w, b, r


def epilogue_route(torch, F, K, xp, w, b, d, act, r):
    """The resblock without the epilogue: cuDNN's conv, in x_pad's dtype
    (weight and bias cast to it, as layers.py's cast rule does), then
    fused_instance_norm, then the residual add."""
    y = K.fused_instance_norm(F.conv2d(xp, w.to(xp.dtype), b.to(xp.dtype), dilation=d), act=act)
    return y if r is None else r + y


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


def fb16_compare(torch, got, want, gray, bank):
    """(ok, conf max abs error, share of pixels whose argmax differs) of the
    bank's bf16-operand form against its plain version: conf within one bf16
    ulp (FB16_TOL: the float32 sums, taken in another order, may round to
    the neighbouring bf16 value), the argmax off on at most FB16_IDX_FRAC of
    the pixels, and there only where the two orientations' bf16 responses
    (float64 sums of the bf16 operands, rounded to bf16) tie within FB16_TOL."""
    idx, conf = got
    p_idx, p_conf = want
    differ = idx != p_idx
    frac = differ.float().mean().item()
    ties_ok = True
    if differ.any():
        res = float64_responses(gray.bfloat16().double(), bank.bfloat16().double())
        res = res.bfloat16().double()
        n_, y_, x_ = differ.nonzero(as_tuple=True)
        a, b = (res[n_, i[differ].long(), y_, x_] for i in (idx, p_idx))
        ties_ok = bool(((a - b).abs() <= FB16_TOL["atol"] + FB16_TOL["rtol"] * b.abs()).all())
        del res
    ok = torch.allclose(conf, p_conf, **FB16_TOL) and frac <= FB16_IDX_FRAC and ties_ok \
        and torch.equal(conf.bfloat16().float(), conf)
    return ok, (conf - p_conf).abs().max().item(), frac


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


def step_gate(card, cpu16, cpu32, lrs):
    """Phase 15's calibrated comparison of three one-step runs ({'losses':
    {name: float}, 'params': {net: {name: tensor}}}): card-bf16 vs CPU-bf16
    per loss within BF16_CAL x the CPU's own bf16 vs fp32 difference of that
    loss, plus the float32 agreement (rtol 1e-4, atol 1e-5); per net, the
    elements beyond float noise of the scale-aware rule within BF16_CAL x
    the CPU's own count (plus its 0.1% allowance), every element within 2.5
    lr.  Returns (ok, printable rows)."""
    ok, rows = True, []
    for k, want in cpu16["losses"].items():
        gap, own = abs(card["losses"][k] - want), abs(want - cpu32["losses"][k])
        good = gap <= BF16_CAL * own + 1e-5 + 1e-4 * abs(want)
        ok &= good
        rows.append(f"{k} {gap:.2e}/{own:.2e}{'' if good else ' FAIL'}")
    for net, lr in lrs.items():
        got, want, ref = (r["params"][net] for r in (card, cpu16, cpu32))
        _, worst, bad, tot = scale_aware(got, want, lr)
        _, _, own_bad, _ = scale_aware(ref, want, lr)
        good = worst <= 2.5 * lr and bad <= BF16_CAL * own_bad + max(1e-3 * tot, 8)
        ok &= good
        rows.append(f"{net}: {bad} of {tot} beyond float noise (CPU bf16 vs fp32 {own_bad}), "
                    f"max diff {worst:.2e} (limit {2.5 * lr:.1e}){'' if good else ' FAIL'}")
    return ok, rows


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

        def vgg():  # in the compute dtype, as generator_loss runs the towers
            sum(f.float().sum() for f in m.vgg(fake.to(m.compute_dtype))).backward()
            with torch.no_grad():
                m.vgg(torch.cat([pre["image_tag"], pre["image_ref"]]).to(m.compute_dtype))

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
    max_err_bf16 = {}
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
            errs = max_err if dname == "float32" else max_err_bf16
            errs[kind] = max(errs.get(kind, 0.0), err)
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
    max_err_bf16["conv3x3_in_act"] = 0.0
    for case in EPI_SHAPES:
        n, c, h, d, act, res = case
        xp, w, bias, r = epilogue_inputs(torch, case, gen, torch.bfloat16)
        got = E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r)
        want = E.conv3x3_in_act_plain(xp, w, bias, dilation=d, act=act, residual=r)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = got.dtype == torch.bfloat16 and torch.allclose(got.float(), want.float(),
                                                            **TOLS["bfloat16"])
        max_err_bf16["conv3x3_in_act"] = max(max_err_bf16["conv3x3_in_act"], err)
        print(f"[phase 3] conv3x3_in_act bfloat16 x_pad ({n},{c},{h + 2 * d},{h + 2 * d}) "
              f"dilation {d} act={act} residual={res}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("conv3x3_in_act bfloat16", case))
    # the bf16 tile's edges: conv3x3_in_act with the float32 and the bf16
    # weight and bias (the two forms the policy hands it), its forms (a tile
    # per block, the pre-norm plane, one block per plane), and
    # conv3x3_same_lowch (its features_2 shapes run in phase 15)
    for n, c, co, h, w_, d, act, res in EPI_BF16_EDGES:
        for p_dtype in (torch.float32, torch.bfloat16):
            xp = torch.randn((n, c, h + 2 * d, w_ + 2 * d), generator=gen).to("cuda",
                                                                             torch.bfloat16)
            w = (torch.randn((co, c, 3, 3), generator=gen) * 0.05).to("cuda", p_dtype)
            bias = torch.randn(co, generator=gen).to("cuda", p_dtype)
            r = torch.randn((n, co, h, w_), generator=gen).to("cuda", torch.bfloat16) \
                if res else None
            got = E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r)
            want = E.conv3x3_in_act_plain(xp, w, bias, dilation=d, act=act, residual=r)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **TOLS["bfloat16"])
            blocks = build.load("conv_in_act").conv3x3_in_act_bf16_blocks(n, c, co, h, w_, d)
            form = f"{blocks} blocks a plane" + (
                ", pre-norm plane" if E.bf16_prenorm(n, c, co, h, w_, d, 0) else "")
            print(f"[phase 3] conv3x3_in_act bfloat16 x_pad ({n},{c},{h + 2 * d},{w_ + 2 * d}) "
                  f"Co {co} dilation {d} act={act} residual={res}, {str(p_dtype)[6:]} weight "
                  f"and bias ({form}): max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append(("conv3x3_in_act bfloat16", (n, c, co, h, w_, d), str(p_dtype)))
    for n, c, co, h, w_ in LOWCH_BF16_EDGES:
        for w_dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((n, c, h, w_), generator=gen).relu().to("cuda", torch.bfloat16)
            w = (torch.randn((co, c, 3, 3), generator=gen) * math.sqrt(2 / (9 * c))).to(
                "cuda", w_dtype)
            got, want = LC.conv3x3_same_lowch(x, w), LC.conv3x3_same_lowch_plain(x, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = got.dtype == torch.bfloat16 and torch.allclose(got.float(), want.float(),
                                                                **TOLS["bfloat16"])
            print(f"[phase 3] conv3x3_same_lowch bfloat16 ({n},{c},{h},{w_}) Co {co}, "
                  f"{str(w_dtype)[6:]} weight: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append(("conv3x3_same_lowch bfloat16", (n, c, co, h, w_), str(w_dtype)))
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
    # the two bf16 forms of the training step at its shapes: the bank's
    # bf16-operand forward at (8, 1, 512^2) and fused_instance_norm in bf16 at
    # the frozen inpainter's shapes at batch 8 (with gamma and beta at one),
    # each form (blocks a plane) chosen by the shape
    grays8 = train_grays(torch)
    for mode in ("gabor", "dog"):
        bank = filters.bank(mode, grays8.device)
        ok, err, frac = fb16_compare(torch, O.filterbank_orientation(grays8, bank, True),
                                     O.filterbank_orientation_plain(grays8, bank, True), grays8,
                                     bank)
        max_err_bf16["filterbank_orientation"] = max(
            max_err_bf16.get("filterbank_orientation", 0.0), err)
        print(f"[phase 3] filterbank_orientation bf16 operands {mode} (8,1,512,512): conf "
              f"max_abs_err {err:.3e}, argmax differs on {frac:.2e} of pixels (limit "
              f"{FB16_IDX_FRAC:g}, near-ties only) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("filterbank_orientation bf16 operands", mode))
    from michigan_tpu_torch.tools.kernel_launches import sass_mma

    ops = sass_mma(libs["filterbank"], "filterbank_bf16_kernel")
    ok = any(k.startswith(("HMMA.16816.F32.BF16", "HGMMA")) for k in ops) and \
        not any("TF32" in k for k in ops)
    print(f"[phase 3] filterbank_orientation bf16 operands: tensor-core instructions of its "
          f"kernel (cuobjdump -sass) {ops}: bf16 products, no TF32 {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failed.append("filterbank_orientation bf16 operands: not on bf16 tensor-core products")
    del grays8
    for c, h, act in IN_SHAPES:
        x, g, b = (kernel_inputs(torch, "fused_instance_norm", c, h, torch.bfloat16, gen,
                                 n=TRAIN_BATCH)[0] for _ in range(3))
        for gb in ((None, None), (g, b)) if act == "lrelu" else ((None, None),):
            got = K.fused_instance_norm(x, *gb, act=act)
            want = K.fused_instance_norm_plain(x, *gb, act=act)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **TOLS["bfloat16"])
            max_err_bf16["fused_instance_norm"] = max(max_err_bf16["fused_instance_norm"], err)
            print(f"[phase 3] fused_instance_norm bfloat16 ({TRAIN_BATCH},{c},{h},{h}) act={act}"
                  f"{' with gamma/beta' if gb[0] is not None else ''}, "
                  f"{K.instance_norm_bf16_split(x)} blocks a plane: max_abs_err {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(("fused_instance_norm bfloat16", TRAIN_BATCH, c, h, act))
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
    fake_cpu32 = fake_cpu  # phase 13 calibrates the bf16 comparison on it
    del cpu

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

    def e2e(m, o, n, reps):
        b = batch_from_numpy(synthetic_inference_data(o, SEED, batch=n), "cuda:0")
        m.infer(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        ms = host_ms(lambda: m.infer(b), torch, reps)
        return ms / n, torch.cuda.max_memory_allocated(), live

    flag_e2e = {}  # batch: (ms/image, peak bytes), for phase 13
    for n, reps in ((1, 10), (8, 5)):
        ms, mem, live = flag_e2e[n] = e2e(model, opt, n, reps)
        phase(6, f"end to end batch {n}: {ms:.2f} ms/image, peak device memory "
                 f"{mem / 2**30:.2f} GiB, of which {live / 2**30:.2f} GiB live before the "
                 f"forward (weights, inputs, this script's tensors) {tag}")

    busy_ms, wall_ms, table, conv_ms, dev_ms = profile_once(lambda: model.infer(batch), torch)
    phase(6, f"profiled batch-1 forward: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
             f"wall under the profiler, cuDNN convolutions {conv_ms:.2f} of {dev_ms:.2f} ms "
             f"device time ({conv_ms / dev_ms:.0%}) {tag}; top device time:")
    print(table, flush=True)
    flag_conv32 = (conv_ms, dev_ms)
    del model, batch, fake, orient_rgb

    # 7 ---------------------------------------------------------------
    smodel = MichiGANModel(stroke_opt, "cuda:0")
    smodel.init_weights(SEED)
    sbatch = batch_from_numpy(stroke_data, "cuda:0")

    stroke_edit = edit_of(engine, smodel, sbatch)

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
    sfake_cpu32 = sfake_cpu  # phase 14 calibrates the bf16 comparison on it
    del scpu, s_orient_cpu
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
            return epilogue_route(torch, F, K, xp, w, bias, d, act, r)

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
    busy_ms, wall_ms, table, conv_ms, dev_ms = profile_once(stroke_edit, torch)
    phase(9, f"profiled stroke edit: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
             f"under the profiler, cuDNN convolutions {conv_ms:.2f} of {dev_ms:.2f} ms device "
             f"time ({conv_ms / dev_ms:.0%}) {tag}; top device time:")
    print(table, flush=True)
    edit_ms32, edit_conv32 = edit, (conv_ms, dev_ms)

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
    def make_trainer(n, crop, extra=()):
        o = train_options(TRAIN_FLAGS + ["--batchSize", str(n), "--crop_size", str(crop),
                                         "--load_size", str(crop), "--seed", str(SEED),
                                         *extra])
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
    busy_ms, wall_ms, table, conv_ms, dev_ms = profile_once(train_step, torch)
    phase(11, f"profiled training step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
              f"under the profiler, convolutions (forward and backward, on cuDNN and off it) "
              f"{conv_ms:.2f} of {dev_ms:.2f} ms device time ({conv_ms / dev_ms:.0%}) {tag}; "
              f"top device time:")
    print(table, flush=True)
    # phase 15 sets the bf16 step beside these
    step32 = dict(ms=ms_step, peak=peak, g=statistics.median(g_times),
                  d=statistics.median(d_times), conv=conv_ms, dev=dev_ms)
    del trainer, tbatch, nets, g_losses, d_losses, orient_t, _fake
    torch.cuda.empty_cache()

    # 12 --------------------------------------------------------------
    def step_parity(init):
        """One G+D step card vs CPU at `init` (--init_type); returns the
        failure message or None."""
        popt, card = make_trainer(1, PARITY_CROP, ["--init_type", init])
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
        cpu_model.netG.load_state_dict({k: v.cpu() for k, v in
                                        card.model.netG.state_dict().items()})
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
        phase(12, f"one G+D step card/CPU at --init_type {init}, batch 1, {PARITY_CROP}^2, ngf "
                  f"{popt.ngf}, ndf {popt.ndf}: " + ", ".join(loss_rows))
        phase(12, f"--init_type {init}: netG after the G step: max diff {g_params[1]:.2e} (limit "
                  f"{2.5 * popt.lr / 2:.1e}), {g_params[2]} of {g_params[3]} elements beyond "
                  f"float noise (limit {max(1e-3 * g_params[3], 8):.0f}); netG buffers max diff "
                  f"{buf_err:.2e}; netD after the D step: max diff {d_params[1]:.2e} (limit "
                  f"{2.5 * 2 * popt.lr:.1e}), {d_params[2]} of {d_params[3]} beyond float noise; "
                  f"CPU G step {t_g:.1f} s, D step {t_d:.1f} s")
        if not (losses_ok and g_params[0] and d_params[0] and bufs_ok):
            return f"the card's and the CPU's training steps disagree at --init_type {init}"
        return None

    # torch's default conv init as the other phases, and the config's own
    # (xavier, gain 0.02), for which the generator's CUDNN_OFF blocks take
    # cuDNN off (models/generator.py)
    for init in ("none", "xavier"):
        msg = step_parity(init)
        torch.cuda.empty_cache()
        if msg:
            return fail(msg)

    # 13 --------------------------------------------------------------
    # the serving paths under the bf16 compute policy: bf16 device time of
    # each kernel at the path's shapes, summed over one forward or edit
    bf16_ms, bf16_plain_ms = {k: 0.0 for k in BF16_ROWS}, {k: 0.0 for k in BF16_ROWS}
    bf16_work = {k: [0, 0] for k in BF16_ROWS}
    bf16_in_lib = {"kernel": 0.0, "F.instance_norm": 0.0, "calls": 0}
    for kind, c, h, act in cases:
        calls = SPADE_SHAPES[(c, h)] if kind == "spade_modulate" else IN_SHAPES[(c, h, act)]
        inp = kernel_inputs(torch, kind, c, h, torch.bfloat16, gen)
        kw = {} if kind == "spade_modulate" else {"act": act}
        tk = median_ms(lambda: kern[kind](*inp, **kw), torch, True)
        tp = median_ms(lambda: plain[kind](*inp, **kw), torch, True)
        bf16_ms[kind] += calls * tk
        bf16_plain_ms[kind] += calls * tp
        if kind == "spade_modulate":  # x, gamma, beta in, y out, 2 bytes each; mean, invstd
            bf16_work[kind][0] += calls * (4 * 2 * c * h * h + 8 * c)
            bf16_work[kind][1] += calls * 4 * c * h * h
        else:  # x in, y out
            bf16_work[kind][0] += calls * 2 * 2 * c * h * h
            bf16_work[kind][1] += calls * 8 * c * h * h
            if act is None:
                bf16_in_lib["kernel"] += calls * tk
                bf16_in_lib["F.instance_norm"] += calls * median_ms(
                    lambda: F.instance_norm(inp[0], eps=1e-5), torch, True)
                bf16_in_lib["calls"] += calls
        print(f"[phase 13] {kind} bfloat16 (1,{c},{h},{h}) act={act} x{calls}/forward: device "
              f"kernel {tk * 1e3:.1f} us, plain {tp * 1e3:.1f} us {tag}", flush=True)
    del inp
    opt16 = parse_options(FLAGS + ["--seed", str(SEED), "--dtype", "bfloat16"])
    model16 = MichiGANModel(opt16, "cuda:0")
    model16.init_weights(SEED)
    fdata = synthetic_inference_data(opt16, SEED)
    batch = batch_from_numpy(fdata, "cuda:0")
    kernels.reset_launch_counts()
    fake16, _ = model16.infer(batch)
    torch.cuda.synchronize()
    counts16 = kernels.launch_counts(by_dtype=True)
    phase(13, f"flagship at --dtype bfloat16 on the card: fake {tuple(fake16.shape)} "
              f"{fake16.dtype}, launches {counts16}")
    if counts16 != FLAGSHIP_BF16_LAUNCHES:
        return fail(f"expected launches {FLAGSHIP_BF16_LAUNCHES}, got {counts16}")
    size = opt16.generator_input_size()
    if fake16.shape != (1, 3, size, size) or fake16.dtype != torch.float32 \
            or not torch.isfinite(fake16).all() or fake16.abs().max() > 1 or fake16.std() < 1e-3:
        return fail(f"bf16 generator output is wrong: {tuple(fake16.shape)} {fake16.dtype}, "
                    f"finite {bool(torch.isfinite(fake16).all())}, std {fake16.std().item()}")
    cpu16 = to_cpu_model(model16, opt16)
    t0 = time.perf_counter()
    fake16_cpu, _ = cpu16.infer(batch_from_numpy(fdata, "cpu"))
    cpu_s = time.perf_counter() - t0
    diff = (fake16.cpu() - fake16_cpu).abs().max().item()
    cal = (fake16_cpu - fake_cpu32).abs().max().item()
    psnr = psnr_u8(crop_u8(fake16, opt16), crop_u8(fake16_cpu, opt16), np)
    phase(13, f"bf16 card vs bf16 CPU: max_abs {diff:.3e} (limit {BF16_CAL:g} x the CPU's own "
              f"bf16 vs fp32 {cal:.3e}), uint8 PSNR {psnr:.2f} dB; CPU bf16 forward "
              f"{cpu_s:.1f} s")
    if not diff <= BF16_CAL * cal:
        return fail("card and CPU bf16 outputs disagree")
    del cpu16, fake16_cpu, fake_cpu32
    for n, reps in ((1, 10), (8, 5)):
        ms, mem, live = e2e(model16, opt16, n, reps)
        phase(13, f"bf16 end to end batch {n}: {ms:.2f} ms/image (fp32 {flag_e2e[n][0]:.2f}), "
                  f"peak device memory {mem / 2**30:.2f} GiB (fp32 "
                  f"{flag_e2e[n][1] / 2**30:.2f}), of which {live / 2**30:.2f} GiB live before "
                  f"the forward (fp32 {flag_e2e[n][2] / 2**30:.2f}) {tag}")
    busy_ms, wall_ms, table, conv_ms, dev_ms = profile_once(lambda: model16.infer(batch), torch)
    phase(13, f"profiled bf16 batch-1 forward: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
              f"wall, cuDNN convolutions {conv_ms:.2f} of {dev_ms:.2f} ms device time "
              f"({conv_ms / dev_ms:.0%}; fp32 {flag_conv32[0]:.2f} of {flag_conv32[1]:.2f} ms) "
              f"{tag}; top device time:")
    print(table, flush=True)
    del model16, batch, fake16
    torch.cuda.empty_cache()

    # 14 --------------------------------------------------------------
    sopt16 = engine.parse_options(STROKE_FLAGS + ["--seed", str(SEED), "--dtype", "bfloat16"])
    smodel16 = MichiGANModel(sopt16, "cuda:0")
    smodel16.init_weights(SEED)
    sbatch = batch_from_numpy(stroke_data, "cuda:0")
    stroke_edit16 = edit_of(engine, smodel16, sbatch)
    kernels.reset_launch_counts()
    u8 = stroke_edit16()
    torch.cuda.synchronize()
    scounts16 = kernels.launch_counts(by_dtype=True)
    phase(14, f"stroke edit at --dtype bfloat16 on the card: result and orientation "
              f"{tuple(u8.shape)} {u8.dtype}, launches {scounts16}")
    if scounts16 != STROKE_BF16_LAUNCHES:
        return fail(f"expected launches {STROKE_BF16_LAUNCHES}, got {scounts16}")
    sbatch["orient_stroke"] = engine.orient_stroke_plane(sbatch["mask_stroke"],
                                                         sbatch["label_tag"])
    sfake16, _ = smodel16.infer(sbatch, "stroke")
    torch.cuda.synchronize()
    if u8.shape != (2, crop, crop, 3) or not torch.isfinite(sfake16).all() \
            or sfake16.abs().max() > 1 or sfake16.std() < 1e-3:
        return fail(f"bf16 stroke edit output is wrong: std {sfake16.std().item()}")
    scpu16 = to_cpu_model(smodel16, sopt16)
    t0 = time.perf_counter()
    sfake16_cpu, _ = scpu16.infer(cbatch, "stroke")
    cpu_s = time.perf_counter() - t0
    diff = (sfake16.cpu() - sfake16_cpu).abs().max().item()
    cal = (sfake16_cpu - sfake_cpu32).abs().max().item()
    psnr = psnr_u8(crop_u8(sfake16, sopt16), crop_u8(sfake16_cpu, sopt16), np)
    phase(14, f"bf16 stroke edit card vs bf16 CPU: max_abs {diff:.3e} (limit {BF16_CAL:g} x the "
              f"CPU's own bf16 vs fp32 {cal:.3e}), uint8 PSNR {psnr:.2f} dB; CPU bf16 forward "
              f"{cpu_s:.1f} s")
    if not diff <= BF16_CAL * cal:
        return fail("card and CPU bf16 stroke edits disagree")
    del scpu16, sfake16_cpu, sfake_cpu32, cbatch
    # conv3x3_in_act in bf16 at the edit's shapes: in turns with the route it
    # replaces (cuDNN bf16 conv + fused_instance_norm), and its plain version
    epi_route16_ms = 0.0
    for case, calls in EPI_SHAPES.items():
        n, c, h, d, act, res = case
        xp, w, bias, r = epilogue_inputs(torch, case, gen, torch.bfloat16)
        w16 = w.bfloat16()  # the route's weight, cast once outside the timing
        fk = lambda: E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r)
        fp = lambda: E.conv3x3_in_act_plain(xp, w, bias, dilation=d, act=act, residual=r)
        route = lambda: epilogue_route(torch, F, K, xp, w16, bias, d, act, r)
        turns = {route: [], fk: []}
        for f in (route, fk, fk, route):
            turns[f].append(median_ms(f, torch, True))
        tk, tr = statistics.mean(turns[fk]), statistics.mean(turns[route])
        tp = median_ms(fp, torch, True)
        bf16_ms["conv3x3_in_act"] += calls * tk
        bf16_plain_ms["conv3x3_in_act"] += calls * tp
        epi_route16_ms += calls * tr
        nbytes, flops = conv3x3_work(n, c, c, h, h, d, 4 * c + (2 * n * c * h * h if res else 0),
                                     elem=2)
        bf16_work["conv3x3_in_act"][0] += calls * nbytes
        bf16_work["conv3x3_in_act"][1] += calls * flops
        bound_us = bound(nbytes, flops, BF16_FLOP_S)[0] * 1e3
        print(f"[phase 14] conv3x3_in_act bfloat16 x_pad ({n},{c},{h + 2 * d},{h + 2 * d}) "
              f"dilation {d} act={act} residual={res} x{calls}/edit: device kernel "
              f"{', '.join(f'{t * 1e3:.1f}' for t in turns[fk])} us ({flops / 1e9 / tk:.1f} "
              f"TFLOP/s; bound {bound_us:.1f} us), cuDNN bf16 conv + fused_instance_norm "
              f"{', '.join(f'{t * 1e3:.1f}' for t in turns[route])} us (in turns: route, kernel, "
              f"kernel, route), plain {tp * 1e3:.1f} us {tag}", flush=True)
    del xp, w, w16, bias, r, fk, fp, route
    # against float64 at batch 2 of the edit's shapes: the bf16 kernel and
    # the route it replaces under the policy, both from the same bf16 inputs
    # (the float64 composition takes the weight rounded to bf16); and the
    # device kernels of one call at batch 1 (torch.profiler)
    edit_cases = ((2, "relu", False), (1, None, True))
    per_call = kernels_per_call([["in_act", [1, 256, 256, 64, 64, d, act, res]]
                                 for d, act, res in edit_cases])
    for d, act, res in edit_cases:
        xp, w, bias, r = epilogue_inputs(torch, (2, 256, 64, d, act, res), gen, torch.bfloat16)
        want = E.conv3x3_in_act_plain(xp.double(), w.bfloat16().double(), bias.double(), d, act,
                                      residual=None if r is None else r.double())
        k_rel = rel_err(E.conv3x3_in_act(xp, w, bias, dilation=d, act=act, residual=r), want)
        r_rel = rel_err(epilogue_route(torch, F, K, xp, w, bias, d, act, r), want)
        ok = k_rel <= F64_RATIO * r_rel and per_call == BF16_KERNELS["conv3x3_in_act"]
        print(f"[phase 14] conv3x3_in_act bfloat16 (2,256,{64 + 2 * d},{64 + 2 * d}) dilation "
              f"{d} act={act} residual={res} against float64, largest error over the largest "
              f"magnitude: kernel {k_rel:.3e}, cuDNN bf16 conv + fused_instance_norm {r_rel:.3e} "
              f"(limit {F64_RATIO:g}x); device kernels per call at batch 1, both edit shapes, "
              f"{per_call} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return fail("conv3x3_in_act in bf16 is less accurate than cuDNN's bf16 route, or "
                        "runs other device kernels than its layout pass and its convolution")
    del xp, w, bias, r, want
    in16_edit = in16_path(torch, F, K, STROKE_IN_SHAPES, 1, gen, 14, "edit", tag)
    phase(14, f"fused_instance_norm bfloat16 per stroke edit ({sum(STROKE_IN_SHAPES.values())} "
              f"calls): device kernel {in16_edit['ms']:.3f} ms (bound "
              f"{in16_edit['bytes'] / HBM_BYTES_S * 1e3:.3f} ms), plain "
              f"{in16_edit['plain_ms']:.3f} ms {tag}")
    for kind, path in BF16_ROWS.items():
        per = "stroke edit" if path == "edit" else "flagship forward"
        phase(14, f"{kind} bfloat16 per {per}: device kernel {bf16_ms[kind]:.3f} ms, plain "
                  f"{bf16_plain_ms[kind]:.3f} ms {tag}")
    phase(14, f"the route conv3x3_in_act replaces in bf16 (cuDNN bf16 conv + fused_instance_norm) "
              f"per stroke edit: {epi_route16_ms:.3f} ms (fp32: kernel "
              f"{edit_ms['conv3x3_in_act']:.3f}, route {epi_route_ms:.3f} ms) {tag}")
    torch.cuda.reset_peak_memory_stats()
    edit16 = host_ms(stroke_edit16, torch, 10)
    phase(14, f"bf16 stroke edit end to end, batch 1: {edit16:.2f} ms/edit (fp32 {edit_ms32:.2f}), "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
    busy_ms, wall_ms, table, conv_ms, dev_ms = profile_once(stroke_edit16, torch)
    phase(14, f"profiled bf16 stroke edit: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall, "
              f"cuDNN convolutions {conv_ms:.2f} of {dev_ms:.2f} ms device time "
              f"({conv_ms / dev_ms:.0%}; fp32 {edit_conv32[0]:.2f} of {edit_conv32[1]:.2f} ms) "
              f"{tag}; top device time:")
    print(table, flush=True)
    del smodel16, sbatch, u8, sfake16

    # 15 --------------------------------------------------------------
    # the bf16 training step (--dtype bfloat16): its two new kernel forms,
    # conv3x3_same_lowch in bf16 (A) and the bank's bf16-operand forward
    # (B), against their plain versions and float64, then the step
    torch.cuda.empty_cache()
    cgen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    failed, step16_ms, step16_plain_ms, step16_work = [], {}, {}, {}
    k = "conv3x3_same_lowch"
    max_err_bf16[k] = 0.0
    for shape in LOWCH_SHAPES:
        # features_2 as the bf16 tower runs it: bf16 ReLU output, bf16 weight
        x = torch.randn(shape, generator=cgen, device="cuda").relu_().bfloat16()
        w = (torch.randn((64, shape[1], 3, 3), generator=cgen, device="cuda")
             * math.sqrt(2 / (9 * shape[1]))).bfloat16()
        got, want = LC.conv3x3_same_lowch(x, w), LC.conv3x3_same_lowch_plain(x, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = got.dtype == torch.bfloat16 and torch.allclose(got.float(), want.float(),
                                                            **TOLS["bfloat16"])
        max_err_bf16[k] = max(max_err_bf16[k], err)
        print(f"[phase 15] {k} bfloat16 {shape} vs its plain version: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append((k, shape))
    del x, w, got, want
    k = "filterbank_orientation"
    grays = train_grays(torch)
    for mode in ("gabor", "dog"):
        bank = filters.bank(mode, grays.device)
        ok, err, frac = fb16_compare(torch, O.filterbank_orientation(grays, bank, True),
                                     O.filterbank_orientation_plain(grays, bank, True), grays,
                                     bank)
        torch.cuda.synchronize()
        max_err_bf16[k] = max(max_err_bf16.get(k, 0.0), err)
        print(f"[phase 15] {k} bf16 operands {mode} (8,1,512,512) vs its plain version: conf "
              f"max_abs_err {err:.3e}, argmax differs on {frac:.2e} of pixels (limit "
              f"{FB16_IDX_FRAC:g}, near-ties only) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append((k, mode))
    if failed:
        return fail(f"a bf16 form disagrees with its plain version: {failed}")
    # against float64 at batch 2: A and F.conv2d in bf16 from the same bf16
    # values; B and its plain version against float64 sums of the bf16
    # operands (both round each response to bf16)
    x = torch.randn((2, 64, 512, 512), generator=cgen, device="cuda").relu_().bfloat16()
    w = (torch.randn((64, 64, 3, 3), generator=cgen, device="cuda") * math.sqrt(2 / 576)).bfloat16()
    want = LC.conv3x3_same_lowch_plain(x.double(), w.double())
    k_rel = rel_err(LC.conv3x3_same_lowch(x, w), want)
    l_rel = rel_err(F.conv2d(x, w, padding=1), want)
    ok = k_rel <= F64_RATIO * l_rel
    print(f"[phase 15] conv3x3_same_lowch bfloat16 (2,64,512,512) against float64, largest error "
          f"over the largest magnitude: kernel {k_rel:.3e}, F.conv2d in bf16 {l_rel:.3e} (limit "
          f"{F64_RATIO:g}x) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        return fail("conv3x3_same_lowch in bf16 is less accurate than cuDNN's bf16 conv")
    del x, w, want
    g2 = grays[:2]
    for mode in ("gabor", "dog"):
        bank = filters.bank(mode, g2.device)
        c64 = float64_responses(g2.bfloat16().double(), bank.bfloat16().double()).amax(dim=1)
        k_conf = O.filterbank_orientation(g2, bank, True)[1]
        p_conf = O.filterbank_orientation_plain(g2, bank, True)[1]
        k_err, p_err = ((c.double() - c64).abs().max().item() for c in (k_conf, p_conf))
        ok = k_err <= F64_RATIO * p_err
        print(f"[phase 15] filterbank_orientation bf16 operands {mode} (2,1,512,512) against "
              f"float64 sums of the bf16 operands: conf max_abs_err kernel {k_err:.3e}, plain "
              f"version {p_err:.3e} (limit {F64_RATIO:g}x; both round to bf16) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            return fail("the bank's bf16-operand form is less accurate than its plain version")
    del c64, g2, k_conf, p_conf
    # device times at the step's shapes: A in turns with F.conv2d in bf16
    n_, c_, h_, w_ = LOWCH_SHAPES[0]
    x = torch.randn(LOWCH_SHAPES[0], generator=cgen, device="cuda").relu_().bfloat16()
    w = (torch.randn((64, c_, 3, 3), generator=cgen, device="cuda") * math.sqrt(2 / (9 * c_))).bfloat16()
    fk = lambda: LC.conv3x3_same_lowch(x, w)
    fl = lambda: F.conv2d(x, w, padding=1)
    turns = {fk: [], fl: []}
    for f in (fl, fk, fk, fl):
        turns[f].append(median_ms(f, torch, True, inner=5))
    k = "conv3x3_same_lowch"
    step16_ms[k], lib16_lowch = statistics.mean(turns[fk]), statistics.mean(turns[fl])
    step16_plain_ms[k] = median_ms(lambda: LC.conv3x3_same_lowch_plain(x, w), torch, True, inner=5)
    # bf16 x, w and output; 2 FLOP per FMA at the dense bf16 rate
    step16_work[k] = [2 * (n_ * c_ * h_ * w_ + n_ * 64 * h_ * w_ + 64 * c_ * 9),
                      2 * n_ * 64 * h_ * w_ * c_ * 9]
    a_bound = bound(*step16_work[k], BF16_FLOP_S)
    print(f"[phase 15] {k} bfloat16 {LOWCH_SHAPES[0]} x1/step: device kernel "
          f"{', '.join(f'{t:.3f}' for t in turns[fk])} ms "
          f"({step16_work[k][1] / 1e9 / step16_ms[k]:.1f} TFLOP/s; bound {a_bound[0]:.3f} ms by "
          f"{a_bound[1]}), F.conv2d in bf16 {', '.join(f'{t:.3f}' for t in turns[fl])} ms (in "
          f"turns: F.conv2d, kernel, kernel, F.conv2d), plain version {step16_plain_ms[k]:.3f} ms "
          f"{tag}", flush=True)
    per_call = kernels_per_call([["lowch", [n_, c_, 64, h_, w_]]])
    print(f"[phase 15] {k} bfloat16 {LOWCH_SHAPES[0]}: device kernels per call {per_call}",
          flush=True)
    if per_call != BF16_KERNELS[k]:
        return fail("conv3x3_same_lowch in bf16 runs other than one device kernel per call")
    del x, w, fk, fl, turns
    k = "filterbank_orientation"
    bank = filters.bank("gabor", grays.device)  # the loss's bank
    # in turns with the bank's route under XLA's bf16 policy, done by cuDNN:
    # gray cast to bf16, the bf16 conv with the bank, the clamp, max and
    # argmax.  The route's gray has NCHW strides: the permuted planes (C = 1,
    # also "contiguous") sent cuDNN to a kernel 3x slower
    b16 = bank.bfloat16().permute(3, 2, 0, 1).contiguous()
    g_nchw = grays.new_empty(grays.shape).copy_(grays)
    fk = lambda: O.filterbank_orientation(grays, bank, True)
    fr = lambda: F.conv2d(g_nchw.bfloat16(), b16, padding=8).clamp_min(0).max(dim=1)
    turns = {fk: [], fr: []}
    for f in (fr, fk, fk, fr):
        turns[f].append(median_ms(f, torch, True, inner=5))
    step16_ms[k], bank_route16_ms = statistics.mean(turns[fk]), statistics.mean(turns[fr])
    step16_plain_ms[k] = median_ms(lambda: O.filterbank_orientation_plain(grays, bank, True),
                                   torch, True, inner=5)
    # 4-byte gray in, idx and conf out; 289 x 32 products per pixel of bf16
    # operands, at the bf16 rate
    step16_work[k] = [12 * grays.numel() + bank.numel() * 4, 2 * grays.numel() * 32 * 289]
    b_bound = bound(*step16_work[k], BF16_FLOP_S)
    print(f"[phase 15] {k} bf16 operands (8,1,512,512) x1/step: device kernel "
          f"{', '.join(f'{t * 1e3:.1f}' for t in turns[fk])} us (the 3xTF32 form "
          f"{step_ms[k] * 1e3:.1f} us in phase 10; bound {b_bound[0] * 1e3:.1f} us by "
          f"{b_bound[1]}), cuDNN's bf16 route (cast, bf16 conv, clamp, max) "
          f"{', '.join(f'{t * 1e3:.1f}' for t in turns[fr])} us (in turns: route, kernel, "
          f"kernel, route), plain version {step16_plain_ms[k] * 1e3:.1f} us {tag}", flush=True)
    per_call = kernels_per_call([["bank16", [8, 512, 512]]])
    print(f"[phase 15] {k} bf16 operands (8,1,512,512): device kernels per call {per_call}",
          flush=True)
    if per_call != BF16_KERNELS["filterbank_orientation"]:
        return fail("the bank's bf16-operand form runs other than one device kernel per call")
    del grays, g_nchw, bank, b16, fk, fr, turns
    # fused_instance_norm in bf16 at the step's batch 8 (the frozen inpainter)
    in16_step = in16_path(torch, F, K, IN_SHAPES, TRAIN_BATCH, gen, 15, "step", tag)
    phase(15, f"fused_instance_norm bfloat16 per training step ({sum(IN_SHAPES.values())} calls "
              f"at batch {TRAIN_BATCH}): device kernel {in16_step['ms']:.3f} ms (bound "
              f"{in16_step['bytes'] / HBM_BYTES_S * 1e3:.3f} ms; fp32 "
              f"{step_ms['fused_instance_norm']:.3f} ms in phase 10), plain "
              f"{in16_step['plain_ms']:.3f} ms; on the {in16_step['lib_calls']} act=None calls "
              f"{in16_step['lib_kernel_ms']:.3f} ms, F.instance_norm {in16_step['lib_ms']:.3f} ms "
              f"{tag}")
    torch.cuda.empty_cache()

    # the step at batch 8, 512^2, full width
    n = TRAIN_BATCH
    topt16, trainer16 = make_trainer(n, 512, ["--dtype", "bfloat16"])
    tbatch = batch_from_numpy(synthetic_train_data(topt16, SEED, n), "cuda:0")
    before = {k: snapshot(net) for k, net in trainer16.model.nets().items()}
    kernels.reset_launch_counts()
    g_losses, _fake, orient_t = trainer16.g_step(tbatch, EXTRA_DILATE)
    d_losses = trainer16.d_step(tbatch, EXTRA_DILATE, orient_t)
    torch.cuda.synchronize()
    step16_counts = kernels.launch_counts(by_dtype=True)
    phase(15, f"bf16 training step on the card, batch {n}, {topt16.crop_size}^2, ngf "
              f"{topt16.ngf}, ndf {topt16.ndf}: launches {step16_counts}")
    if step16_counts != STEP_BF16_LAUNCHES:
        return fail(f"expected launches per bf16 step {STEP_BF16_LAUNCHES}, got {step16_counts}")
    losses = {k: v.item() for k, v in {**g_losses, **d_losses}.items()}
    phase(15, "losses " + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
    nets = trainer16.model.nets()
    moved = {k: any(not torch.equal(p, before[k][name]) for name, p in nets[k].named_parameters())
             for k in ("netG", "netD")}
    frozen = {k: all(t.dtype == before[k][name].dtype and torch.equal(t, before[k][name])
                     for name, t in nets[k].state_dict().items()) for k in ("netIG", "vgg")}
    stored = {k: sorted({str(t.dtype) for t in nets[k].state_dict().values()
                         if t.is_floating_point()}) for k in nets}
    phase(15, f"parameters changed {moved}; frozen nets bit-identical {frozen}; floating "
              f"dtypes stored {stored}")
    if not all(math.isfinite(v) for v in losses.values()) or not all(moved.values()) \
            or not all(frozen.values()) or stored["vgg"] != ["torch.bfloat16"] \
            or stored["netG"] != ["torch.float32"]:
        return fail("the bf16 training step's losses, updates or stored dtypes are wrong")
    del before

    def train_step16():
        _g, _f, o = trainer16.g_step(tbatch, EXTRA_DILATE)
        trainer16.d_step(tbatch, EXTRA_DILATE, o)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        train_step16()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak16 = torch.cuda.max_memory_allocated()
    ms16 = statistics.median(times)
    phase(15, f"{TRAIN_STEPS} timed bf16 steps after the warm-up: "
              f"{', '.join(f'{t:.1f}' for t in times)} ms; median {ms16:.1f} ms/step, "
              f"{n / ms16 * 1e3:.2f} img/s (fp32 {step32['ms']:.1f} ms, "
              f"{n / step32['ms'] * 1e3:.2f} img/s); peak device memory {peak16 / 2**30:.2f} GiB "
              f"(fp32 {step32['peak'] / 2**30:.2f}), of which {live / 2**30:.2f} GiB live before "
              f"the steps {tag}")
    g_times, d_times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        _g, _f, o = trainer16.g_step(tbatch, EXTRA_DILATE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer16.d_step(tbatch, EXTRA_DILATE, o)
        torch.cuda.synchronize()
        g_times.append((t1 - t0) * 1e3)
        d_times.append((time.perf_counter() - t1) * 1e3)
    phase(15, f"bf16 G step {statistics.median(g_times):.1f} ms, D step "
              f"{statistics.median(d_times):.1f} ms (medians of 3; fp32 {step32['g']:.1f} / "
              f"{step32['d']:.1f}) {tag}")
    for k, v in step_breakdown(torch, trainer16, tbatch).items():
        phase(15, f"  part, alone: {k}: {v:.1f} ms {tag}")
    busy_ms, wall_ms, table, conv_ms, dev_ms = profile_once(train_step16, torch)
    phase(15, f"profiled bf16 training step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
              f"wall, convolutions (forward and backward) {conv_ms:.2f} of {dev_ms:.2f} ms "
              f"device time ({conv_ms / dev_ms:.0%}; fp32 {step32['conv']:.2f} of "
              f"{step32['dev']:.2f} ms) {tag}; top device time:")
    print(table, flush=True)
    del trainer16, tbatch, nets, g_losses, d_losses, orient_t, _fake
    torch.cuda.empty_cache()

    # one bf16 G+D step, card vs CPU, calibrated on the CPU's bf16 vs fp32;
    # and a control that must fail the gate: the card's step on the first
    # half of the batch
    extra16 = ["--ngf", str(PARITY16["ngf"]), "--ndf", str(PARITY16["ndf"])]
    n = PARITY16["batch"]
    popt16, card16 = make_trainer(n, PARITY16["crop"], extra16 + ["--dtype", "bfloat16"])
    popt32 = train_options(TRAIN_FLAGS + ["--batchSize", str(n), "--crop_size",
                                          str(PARITY16["crop"]), "--load_size",
                                          str(PARITY16["crop"]), "--seed", str(SEED), *extra16])
    init16 = {k: {n_: t.detach().cpu().clone() for n_, t in net.state_dict().items()}
              for k, net in card16.model.nets().items()}

    def trainer_from_init(o, dev):
        m = MichiGANModel(o, dev)
        m.load_state_dicts(init16)  # float32 modules take the bf16 frozen leaves as they are
        return TrainStep(m)

    data = synthetic_train_data(popt16, SEED, n)
    half = {k: v[:n // 2] for k, v in data.items()}
    trainers = {"card": (card16, "cuda:0", data),
                "cpu16": (trainer_from_init(popt16, "cpu"), "cpu", data),
                "cpu32": (trainer_from_init(popt32, "cpu"), "cpu", data),
                "control": (trainer_from_init(popt16, "cuda:0"), "cuda:0", half)}
    params_of = lambda net: {k: v.detach().cpu().clone() for k, v in net.named_parameters()}
    runs16, t_run, batches, orients = {}, {}, {}, {}
    for name, (tr, dev, d_) in trainers.items():
        batches[name] = batch_from_numpy(d_, dev)
        t0 = time.perf_counter()
        g, _f, orients[name] = tr.g_step(batches[name], EXTRA_DILATE)
        t_run[name] = time.perf_counter() - t0
        runs16[name] = {"losses": {k: v.item() for k, v in g.items()},
                        "params": {"netG": params_of(tr.model.netG)}}
    # the two CPU D steps from the card's post-G netG, as phase 12's: under
    # bf16 the G step's Adam flips the sign of a large share of netG's
    # elements, which would move the recomputed fake, and so D's losses, by
    # more than bf16 moves them
    post_g = {k: v.cpu() for k, v in card16.model.netG.state_dict().items()}
    for name, (tr, dev, d_) in trainers.items():
        if name in ("cpu16", "cpu32"):
            tr.model.netG.load_state_dict(post_g)
        t0 = time.perf_counter()
        d = tr.d_step(batches[name], EXTRA_DILATE, orients[name])
        t_run[name] += time.perf_counter() - t0
        runs16[name]["losses"].update({k: v.item() for k, v in d.items()})
        runs16[name]["params"]["netD"] = params_of(tr.model.netD)
    del trainers, batches, orients, post_g
    lrs = {"netG": popt16.lr / 2, "netD": 2 * popt16.lr}
    ok, rows = step_gate(runs16["card"], runs16["cpu16"], runs16["cpu32"], lrs)
    control_ok, control_rows = step_gate(runs16["control"], runs16["cpu16"], runs16["cpu32"], lrs)
    phase(15, f"one bf16 G+D step card/CPU, batch {n}, {PARITY16['crop']}^2, ngf "
              f"{PARITY16['ngf']}, ndf {PARITY16['ndf']}, per loss card-vs-CPU bf16 / CPU bf16 "
              f"vs fp32: " + ", ".join(rows) + f"; CPU steps {t_run['cpu16']:.1f} s (bf16), "
              f"{t_run['cpu32']:.1f} s (fp32)")
    phase(15, f"control, the card's step on the first {n // 2} of the {n} samples against the "
              f"same CPU steps: " + ", ".join(control_rows)
              + (": passes, FAIL" if control_ok else ": fails the gate, as it must"))
    if not ok:
        return fail("the card's and the CPU's bf16 training steps disagree")
    if control_ok:
        return fail("phase 15's gate passes a step that dropped half its batch")
    del card16, runs16, init16
    torch.cuda.empty_cache()

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
    kernel_rows = [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": rows[k][0], "max_abs_err": max_err[k], "ms": rows[k][1],
         "plain_ms": rows[k][2], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library_ms.get(k), **({"library_covers": (
             f"the step's {in_lib['calls']} act=None calls, where the kernel takes "
             f"{in_lib['kernel']} ms")} if k == "fused_instance_norm" else {}),
         **({"replaced_route_ms": epi_route_ms} if k == "conv3x3_in_act" else {})}
        for k in REPLACES]
    # the bf16 forms on the bf16 serving paths: launches from phases 13-14
    bf16_launches = {"flagship": counts16, "edit": scounts16}
    for k, path in BF16_ROWS.items():
        b_ms, b_by = bound(*bf16_work[k], BF16_FLOP_S if k == "conv3x3_in_act" else FP32_FLOP_S)
        kernel_rows.append({
            "name": f"{k}_bf16", "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": bf16_launches[path][k]["bfloat16"], "max_abs_err": max_err_bf16[k],
            "ms": bf16_ms[k], "plain_ms": bf16_plain_ms[k], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": bf16_in_lib["F.instance_norm"] if k == "fused_instance_norm" else None,
            **({"library_covers": (
                f"the flagship's {bf16_in_lib['calls']} act=None calls, where the kernel takes "
                f"{bf16_in_lib['kernel']} ms")} if k == "fused_instance_norm" else {}),
            **(in16_rows(in16_step, in16_edit, step16_counts) if k == "fused_instance_norm"
               else {}),
            **({"replaced_route_ms": epi_route16_ms} if k == "conv3x3_in_act" else {})})
    # the bf16 training step's two forms: launches from phase 15's counted step
    for k, replaces in STEP_BF16_ROWS.items():
        lowch = k == "conv3x3_same_lowch"
        b_ms, b_by = bound(*step16_work[k], BF16_FLOP_S)
        kernel_rows.append({
            "name": f"{k}_bf16", "route": "cuda", "source": SOURCES[k], "replaces": replaces,
            "launches": step16_counts[k]["bfloat16"], "max_abs_err": max_err_bf16[k],
            "ms": step16_ms[k], "plain_ms": step16_plain_ms[k], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib16_lowch if lowch else None,
            **({} if lowch else {"operands": "bf16, sums float32",
                                 "replaced_route_ms": bank_route16_ms})})
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def host_times(root, reps=30):
    """The bf16 serving paths on the host clock with the port of the
    checkout `root`, in this process: each bf16 fused_instance_norm call of
    the flagship launched from Python (mean of 50 back-to-back calls,
    median of 5), the bf16 flagship forward at batch 1 (phase 13's) and the
    bf16 stroke edit (phase 14's), each the median of `reps` after a
    warm-up.  Prints one JSON line."""
    from pathlib import Path

    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    import michigan_tpu_torch
    from michigan_tpu_torch.data.synthetic import synthetic_inference_data, synthetic_stroke_data
    from michigan_tpu_torch.demo import engine
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.ops.cuda import spade as K

    port = Path(michigan_tpu_torch.__file__).resolve()
    if not port.is_relative_to(Path(root).resolve()):
        return fail(f"the port was imported from {port}, not from {root}")
    build.build_all()
    gen = torch.Generator().manual_seed(SEED)
    norm_us = {}
    for (c, h, act) in IN_SHAPES:
        x = kernel_inputs(torch, "fused_instance_norm", c, h, torch.bfloat16, gen)[0]
        norm_us[f"(1,{c},{h},{h}) {act}"] = 1e3 * median_ms(
            lambda: K.fused_instance_norm(x, act=act), torch, False, inner=50)
    opt = parse_options(FLAGS + ["--seed", str(SEED), "--dtype", "bfloat16"])
    model = MichiGANModel(opt, "cuda:0")
    model.init_weights(SEED)
    batch = batch_from_numpy(synthetic_inference_data(opt, SEED), "cuda:0")
    flagship_ms = host_ms(lambda: model.infer(batch), torch, reps)
    del model, batch
    sopt = engine.parse_options(STROKE_FLAGS + ["--seed", str(SEED), "--dtype", "bfloat16"])
    smodel = MichiGANModel(sopt, "cuda:0")
    smodel.init_weights(SEED)
    stroke_data = synthetic_stroke_data(engine.parse_options(STROKE_FLAGS + ["--seed", str(SEED)]),
                                        SEED)
    edit_ms = host_ms(edit_of(engine, smodel, batch_from_numpy(stroke_data, "cuda:0")), torch,
                      reps)
    print(json.dumps({"root": str(root), "norm_launched_us": norm_us,
                      "flagship_bf16_ms": flagship_ms, "edit_bf16_ms": edit_ms}))
    return 0


def host_ab(other, pairs):
    """The parent (or any checkout `other`) against this checkout on the
    host clock: host_times in fresh processes, `pairs` pairs in turns
    (other, this, this, other, ...), on one card.  Prints every run, then
    per metric the medians and how many pairs this checkout was slower in.
    The bf16 serving paths are host-bound and a process's host clock spreads
    more than two commits differ, hence many runs in turns."""
    from pathlib import Path

    here = Path(__file__).resolve().parent
    card = card_info()
    print(f"card: {card}", flush=True)
    runs = {"other": [], "this": []}
    for i in range(pairs):
        for who in ("other", "this") if i % 2 == 0 else ("this", "other"):
            root = other if who == "other" else here
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--host_times",
                                   str(root)], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                return fail(f"host_times {root} failed:\n{proc.stderr[-3000:]}")
            run_ = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[who].append(run_)
            print(json.dumps({"pair": i, "checkout": who, **run_}), flush=True)
    flat = lambda r: {"flagship_bf16_ms": r["flagship_bf16_ms"], "edit_bf16_ms": r["edit_bf16_ms"],
                      **{f"norm {k} us": v for k, v in r["norm_launched_us"].items()}}
    for key in flat(runs["this"][0]):
        a = [flat(r)[key] for r in runs["other"]]
        b = [flat(r)[key] for r in runs["this"]]
        print(f"{key}: other median {statistics.median(a):.3f} [{min(a):.3f}, {max(a):.3f}], "
              f"this median {statistics.median(b):.3f} [{min(b):.3f}, {max(b):.3f}], this slower "
              f"in {sum(y > x for x, y in zip(a, b))} of {pairs} pairs [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host_ab"]:  # a comparison of two checkouts: see host_ab
        sys.exit(host_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 10))
    if sys.argv[1:2] == ["--host_times"]:
        sys.exit(host_times(sys.argv[2]))
    if sys.argv[1:2] == ["--conv_algorithms"]:  # a diagnostic: see its module
        from michigan_tpu_torch.tools import conv_algorithms

        sys.exit(conv_algorithms.main(sys.argv[2:], TRAIN_FLAGS, SEED, EXTRA_DILATE,
                                      scale_aware, card_info))
    sys.exit(run())
