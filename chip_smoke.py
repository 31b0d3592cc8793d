#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (michigan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives three paths of the port at full width on seeded random weights and
seeded numpy samples, each through its own entry points, and all three again
under the bf16 compute policy (--dtype bfloat16); then the training step of
the VAE, blender and unpaired two-stage configs (phase 16), the
flagship through the serving session, the exported program and FID's
extractors (phase 17), the training step on two data-parallel ranks
(phase 18), the VAE, blender and unpaired configs again at --dtype
bfloat16 (phase 19), and the 1024^2 configuration (--num_upsampling_layers
most) with --remat activation checkpointing (phase 20), the last
model options of the JAX package (phase 21), the trainer's native host
library on this machine's host (phase 22), the 1024^2 forward in row
bands on two ranks of one spatial group (phase 23), and the 1024^2 training
step in row bands on two ranks (phase 24):

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
     off for cuDNN convolutions and matmuls; subnormals flushed to zero on
     the CPU (its references); neither jax nor any module of the JAX
     package (michigan_tpu) was loaded by the port's imports
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
      one warm-up then TRAIN_STEPS timed steps (ms/step, img/s, peak device memory)
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
  16. the training configs of the JAX package's flag matrix in float32 at
      batch 8, 512^2, full width, TRAIN_FLAGS plus --use_vae (vae),
      --use_blender (blender) or --unpairTrain --same_netD_model (unpair:
      a stage-2 step on the unpaired synthetic batch, then a stage-1 step
      on the paired one): per config and stage, the counts set to 0 just
      before one G+D step and read just after, exactly 29
      fused_instance_norm, 1 filterbank_orientation, 1
      filterbank_orientation_backward and 1 conv3x3_same_lowch (0 in stage
      2, which runs no VGG tower); losses finite (KLD among them for vae);
      the nets the step trains changed and no other (netG, netE or netB,
      netD; stage 2 netG and netD2, stage 1 netG and netD), netIG and VGG19
      bit-identical; CONFIG_STEPS timed steps after that warm-up (ms/step,
      img/s, G step, D step, peak memory) and one profiled step (device
      busy, the top device time); then
      each config's G+D step (unpair: stage 2) on the card and on the CPU
      at PARITY16's batch, crop and width in float32, at torch's default
      init and at the config's own (xavier), the VAE's eps the same draw
      on both, by phase 12's rule: per-term losses within rtol 1e-4, atol
      1e-5, netG, netE / netB after the G step and netD (netD2) after the
      D step (both from the card's post-G state) by the scale-aware rule,
      netG's running statistics and spectral u / v within rtol 1e-4, atol
      1e-5.  The blender's netG and netB (F64_WITNESSED) may instead pass
      a float64 witness: one G step on the CPU in float64 from the same
      state (tools/float64_step.py; computed from phase 15 on beside the
      card's work, in a niced process of its own: CpuRefs), from whose
      gradient the card's G-step
      gradient (read back from Adam's first moment) may lie at most
      F64_CAL x as far, relative to its norm, as the CPU's float32 one.
      netB's backward multiplies the relative rounding error of the
      gradient that crosses it by thousands, and Adam's first step turns
      each gradient element into +-lr by its sign, so even the CPU's
      float32 step lies past phase 12's rule from the float64 one.  A
      control, the card's G step on half the batch, must fail that gate.
      The blender's card G and D steps run under
      torch.use_deterministic_algorithms(True) (CUBLAS_WORKSPACE_CONFIG
      :4096:8, set before the first CUDA call; its batch-8 step is also
      timed under them, beside the time without), and its G step runs
      DET_REPEATS times from the same state: printed, whether netG and
      netB come out bit for bit equal, and each repeat's netG count
      beyond float noise against the float64 step.
  17. serving (michigan_tpu_torch.serving) and FID at the flagship's full
      width: the shape-bucketed InferenceSession with buckets (1, 4, 8) in
      fp32 and at --dtype bfloat16, each bucket's graph captured (capture
      seconds; the counts set to 0 just before it and read just after:
      spade_modulate and fused_instance_norm launched; each graph exactly
      FLAGSHIP_LAUNCHES; peak memory and what stays allocated with every
      pool held); requests of 1, 3, 8 and 11 samples (padding, a split
      into 8 + 4): replays per bucket and the graphs' launches per request,
      no launch from Python, against eager infer of the same chunks within
      2e-3 max abs and PSNR > 50 dB (phase 5's limit), bit for bit
      printed; ms/image at batch 1 and 8, session and eager, numpy in and
      out, host clock; device busy over wall of a profiled batch-1 request;
      one bf16 --use_pallas_epilogue bucket whose graph launches exactly 24
      conv3x3_in_act, 5 fused_instance_norm and 18 spade_modulate; the
      exported program (serving.export, fp32, batch 1) loaded with
      load_exported: the kernels launched (exactly FLAGSHIP_LAUNCHES), the
      output against eager infer by the same limit, and a second seed's
      state_dicts against that seed's eager output; FID's VGG19 relu4_1 and
      InceptionV3 pool3 features of 16 seeded 299^2 images on the card
      against the CPU (relative error at most 1e-3 of their norm), the FID
      of two seeded sets, ms per batch of 8 and the pretrained tag.
  18. data-parallel training (michigan_tpu_torch.parallel): two ranks
      spawned on the one card (cuda:0) in a gloo group (NCCL refuses two
      ranks on one device; gloo all-reduces CUDA tensors through the
      host), each joined within DP_JOIN_S, the group's timeout
      DP_GROUP_TIMEOUT_S; each rank starts from SEED's weights (checked
      equal across ranks by one broadcast) and steps on its half of the
      global batch.  Held against one process at the global batch on the
      same objective (tools/replica_objective.py: the orientation loss's
      two terms as the mean of their values on the two halves, as the JAX
      package's replicas average them), the D steps of both from the one
      process's post-G netG: the fp32 step at TRAIN_BATCH, 512^2, full
      width by phase 12's rule, launches per rank exactly STEP_LAUNCHES,
      the two ranks' losses, parameters and netG buffers bit for bit equal;
      the bf16 step at DP16 by phase 15's gate (2x the one process's own
      bf16-vs-fp32 effect), launches per rank exactly STEP_BF16_LAUNCHES;
      a control, the fp32 ranks with the norms' group removed (local batch
      statistics), that must fail phase 12's rule; ms/step (median of
      DP_STEPS after the compared step) of the ranks and of the one process
      and peak memory a rank.  Then an NCCL group of one on the card:
      batch_norm_train with and without it, the gradient mean (fp32 and
      bf16 rounding) and the loss mean; with two or more cards the fp32
      ranks also run over NCCL, one card each.
  19. phase 16's configs at --dtype bfloat16 (vae, blender, unpair stage
      2, then stage 1) at batch 8, 512^2, full width: per config and
      stage, the counts set to 0 just before one G+D step and read just
      after, by dtype: exactly 29 fused_instance_norm, 1 bank forward and 1
      conv3x3_same_lowch in bfloat16 and 1 bank backward in float32 (stage
      2: no conv3x3_same_lowch); losses finite (KLD for vae); the nets the
      step trains changed and no other, stored in float32, netIG and VGG19
      bit-identical in bfloat16; TRAIN_STEPS timed steps after that
      warm-up (ms/step, img/s, G step, D step, peak memory beside phase
      16's float32 numbers).  Then each config and stage one bf16 G+D step
      card vs CPU at PARITY16's batch, crop and width by phase 15's gate
      (step_gate; netG, netE, netB and netD or netD2 in its rates), with
      the VAE's eps one draw and the CPU's D steps from the card's post-G
      netG, netE and netB; a control, the card's step on the first half of
      the batch, must fail it.  The blender's card steps and its control
      run under torch.use_deterministic_algorithms(True), as in phase 16.
      After the unpaired stage-2 comparison, the
      trainer's --stats_freq diagnostics (training/diagnostics.py) of the
      card's model against the same weights on the CPU (relative
      difference at most DIAG_REL).
  20. the 1024^2 configuration (--num_upsampling_layers most: up_4 and the
      background encoder's half-width stem) at full width: the kernels at
      its shapes against their plain versions (spade_modulate at up_4's
      (1, 64 and 32, 1152^2) in fp32 and bf16, conv3x3_same_lowch at (2,
      64, 1024^2) in fp32 and bf16, the bank forward in fp32 and on bf16
      operands and its backward on a hair-masked dconf at (1, 1, 1024^2)),
      then device times beside their plain versions, F.conv2d and their
      bounds, summed over a forward's 21 spade_modulate calls; inference
      on FLAGS at 1024 + --add_th 128 (planes 9^2 ... 1152^2), batch 1, fp32
      and bf16: the counts set to 0 just before and read just after,
      exactly 21 spade_modulate and 29 fused_instance_norm, the output
      finite, ms/image (median of 5, host clock) and peak memory; the same
      path at MOST_CHECK_CROP + 128 card vs CPU by phase 5's limit (fp32)
      and phase 13's (bf16); the training step on TRAIN_FLAGS at 1024
      (the flag matrix's most_1024 row), batch 1, fp32 and bf16, with and
      without --remat (up_1..up_4 and the VGG tower of the fake): exactly
      STEP_LAUNCHES (STEP_BF16_LAUNCHES by dtype), losses finite, ms/step
      (median of MOST_STEPS, with their spread) and peak, then the largest
      batch of MOST_BATCHES that fits (an out-of-memory error above batch 1
      is that probe's printed result; anything else fails); the flag
      matrix's all_losses_remat row (every loss, batch 8, 512^2,
      --remat_blocks up_1,up_2,up_3) beside phase 11's step without
      --remat; then at PARITY16's batch, crop and width, `most`: the fp32
      G+D step card vs CPU by phase 12's rule at torch's default init and
      at xavier, the bf16 step with --no_confidence_loss by phase 15's
      whole gate at SEED and by its gate on netG and netD at each of
      MOST_GATE_SEEDS (the Gabor confidence term's clamp decides the bf16
      netG at this size; SEED's step with it is printed), each with a
      half-batch control that must fail; and the card's step with
      --remat against its step without, from one state, under
      deterministic algorithms, fp32 and bf16: bit for bit equal (or
      within phase 12's rule, printed).
  21. the port's last model options at full width: inference on FLAGS,
      batch 1, 512², under each of VARIANT_INFER (--Image_encoder_mode
      norm, instance, no --use_encoder, no --noise_background,
      --orient_random_disturb, --weight_norm_G, --no_instance False with
      a synthetic two-id instance map): the counts set to 0 just before
      and read just after, exactly FLAGSHIP_LAUNCHES (under
      --weight_norm_G spade_modulate with mean 0 and invstd 1), the output
      finite, card vs CPU by phase 5's limits (the CPU forward from SEED's
      weights, computed beside the card's work by CpuRefs), ms/image
      (median of VARIANT_INFER_REPS, host clock) and peak memory;
      spade_modulate with
      mean 0 and invstd 1 against x * (1 + gamma) + beta at WN_SHAPES;
      then the two configs of VARIANT_TRAIN on TRAIN_FLAGS (A: the norm
      encoder and D with spectral batch norms, --weight_norm_G,
      --reuse_fake_for_d; B: the instance encoder, netFE, an instance map,
      --netD n_layer, no --noise_background, --no_ganFeat_loss): one G+D
      step card vs CPU at PARITY16's size by phase 12's rule with a
      half-batch control that must fail, then at TRAIN_BATCH, 512², full
      width: exactly STEP_LAUNCHES, losses finite, ms/step (median of
      VARIANT_STEPS) and peak.
  22. the native host library (michigan_tpu_torch/native: the loader's
      noise pyramid, bilinear resize and hole rasterization) on this
      machine's host: g++ builds it from the checkout (a failed build
      fails the run); noise_pyramid at 512^2 and 1024^2 twice with one
      seed (bit for bit equal) and once with another (different), mean
      within 0.02 of 0.5 and std in (0.05, 0.3); rasterize_hole equal to
      its numpy formula and bilinear_resize within 1e-4 of a numpy
      half-pixel bilinear (this machine has no cv2) at the pyramid's
      shapes; ms per noise sample (median of NATIVE_REPS) at both sizes
      beside the bf16 512^2 step's card ms per image (phase 15).  The Qt
      editor and the PIL loader do not run here (no PyQt5, PIL or cv2):
      their edit and step are phases 9 and 14, and 11 and 15.
  23. spatial sharding of inference (michigan_tpu_torch.parallel.spatial):
      the generator's planes over SPACE_WORLD ranks (printed: which are
      bands and which whole); spade_modulate at up_4's band (1, 64, 576,
      1152) against its plain version in fp32 and bf16 (TOLS), with its
      device time, its plain version's and its bound; then one process's
      1024^2 `most` forward (FLAGS + MOST_INFER, batch 1, SEED's weights),
      fp32 and bf16, on the card; then SPACE_WORLD ranks spawned on the one
      card in a gloo group (each joined within SPACE_JOIN_S, the group's
      timeout SPACE_GROUP_TIMEOUT_S), each running make_spatial_infer on
      the same host batch: the counts set to 0 just before the compared
      forward and read just after, exactly 21 spade_modulate and 29
      fused_instance_norm a rank in each dtype; the gathered output against
      one process's by phase 5's limits (fp32: 2e-3 max abs and PSNR > 50
      dB) and phase 13's (bf16: 2x the card's own bf16-vs-fp32 difference);
      a control, the fp32 ranks with zeros in place of the neighbours' halo
      rows, must fail phase 5's limits; ms/image (median of SPACE_REPS,
      host clock) and peak memory a rank beside one process's (each above
      what its process held before its model); one more forward a rank
      with the transport (halo rows, gathers, all-reduces) clocked between
      synchronizes: its calls and ms.  With two or more cards, the same
      ranks over NCCL, one card each (four bands on four cards, else two),
      by the same gates.
  24. spatial sharding of training: the plane plan (the generator's and
      VGG19's bands, netD whole); filterbank_orientation, its backward
      and conv3x3_same_lowch at the band shapes (rank 1's band of the
      1024^2 plane with the bank's 8 halo rows, zeros below the frame; the
      tag + ref tower's band with a halo row each side), each against its
      plain version by phase 3's tolerances; one process's fp32 `most` G+D
      step at 1024^2, batch 1 (TRAIN_FLAGS + MOST_TRAIN, SEED's weights,
      synthetic_train_data) on the card, then SPACE_WORLD ranks spawned on
      the one card in a gloo group, each running TrainStep with its Space
      on its band of the same batch (spatial.shard_batch) from the same
      weights: the counts set to 0 just before the compared G step and
      read just after its D step, exactly STEP_LAUNCHES a rank; the D step
      from one process's post-G netG; the compared steps (one process's,
      the ranks' and the controls') under
      torch.use_deterministic_algorithms(True), as in phase 16; the
      ranks' loss terms the same as one process's, each within
      SPACE_LOSS_RTOL of it (ORIENT SPACE_ORIENT_RTOL), its relative
      difference printed; netG after the G step and netD after the D step
      by phase 12's rule, netG's buffers within rtol 1e-4; every rank's
      nets and losses equal rank 0's bit for bit; two controls from the
      same weights, zeros in place of the neighbours' halo rows and each
      band's own batch-norm statistics, whose G steps must fail the same
      gate; ms/step (median
      of SPACE_TRAIN_STEPS, host clock) and peak memory a rank beside one
      process's; one more step a rank with its collectives clocked between
      synchronizes.  With two or more cards, the same ranks over NCCL, one
      card each, by the same gates.

Then a JSON line of per-kernel results: for the training step's kernels
(fused_instance_norm, filterbank_orientation and its backward,
conv3x3_same_lowch) launches in phase 11's counted step and times summed over
one step's calls (the backward on the hair-masked dconf), with phase 16's
counted steps under config_launches (the bank backward's phase 19
launches under bf16_config_launches); for spade_modulate
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
The bf16 rows of fused_instance_norm, conv3x3_same_lowch and the bank
forward carry phase 19's counted steps under config_launches.
The fused_instance_norm_bf16 row also carries the bf16 training step's
batch-8 calls (step_launches from phase 15's counted step; step_ms,
step_plain_ms, step_bound_ms, and step_library_ms: F.instance_norm on its
act=None calls) and the bf16 edit's (edit_ms, edit_bound_ms).  The bf16
training step's rows (phase 15: conv3x3_same_lowch_bf16 with F.conv2d in
bf16 as library_ms; filterbank_orientation_bf16, the bank's bf16-operand
form, with cuDNN's bf16 route as replaced_route_ms; both bound at 989
TFLOP/s of bf16 products) take their launches from phase 15's counted
step.  The three serving kernels' rows carry session_launches, phase 17's
launches per request through the captured graphs; conv3x3_same_lowch's
row the launches of FID's VGG per batch.  Phase 20 adds rows named
<kernel>_1024 (and <kernel>_bf16_1024) at the 1024^2 configuration's
shapes: spade_modulate over a forward's 21 calls, the training kernels over
the batch-1 step's calls, launches from phase 20's counted runs; the
fused_instance_norm rows carry launches_1024 (forward and step), whose
shapes are the 512^2 paths'.  The float32 rows carry variants_launches,
phase 21's counted runs.  The spade_modulate and fused_instance_norm
rows (and their _bf16 rows) carry spatial_launches_per_rank, phase 23's
counted forwards, and the spade_modulate rows a band entry: its shape,
max_abs_err, ms, plain_ms, bound_ms and bound_by at up_4's band.  The
float32 rows of fused_instance_norm, the bank, its backward and
conv3x3_same_lowch carry spatial_train_launches_per_rank, phase 24's
counted steps.  Last,
the device line.  Any
failure exits non-zero without the device line; so does a machine without
CUDA, and a directory without the rest of the repository.

    python3 chip_smoke.py --host_ab DIR [PAIRS]

compares the port of another checkout DIR (the parent's ``git archive``)
with this one on the host clock, in fresh processes in turns: each bf16
fused_instance_norm call launched from Python, the flagship forward at
batch 1 in fp32 and bf16 and the bf16 stroke edit (host_ab; 10 pairs by
default).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
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
TRAIN_STEPS = 2  # timed batch-8 steps after the warm-up (phases 11, 15, 19)
SPLIT_STEPS = 1  # steps timed as a G step and a D step apart (phases 11, 15)
EXTRA_DILATE = 2  # the expected random mask dilation (encoder.py:294)
PARITY_CROP = 512
# phase 16: the three training configs of the JAX package's flag matrix
# (artifacts/flag_matrix_r5.json), each on TRAIN_FLAGS; the unpaired stage
# runs no VGG tower, so no conv3x3_same_lowch
CONFIG_FLAGS = {"vae": ("--use_vae",), "blender": ("--use_blender",),
                "unpair": ("--unpairTrain", "--same_netD_model")}
STAGE2_LAUNCHES = {**STEP_LAUNCHES, "conv3x3_same_lowch": 0}
# phase 16's float64 witness: the nets of a config whose card-vs-CPU step
# may be judged against a float64 CPU step instead, and how much farther
# from its gradient than the CPU's float32 gradient the card's may land
F64_WITNESSED = {"blender": ("netG", "netB")}
F64_CAL = 2.0
# the CPU references that need no card result: the blender's float64
# witness (phase 16) at both inits and phase 21's seven CPU forwards, each
# from SEED's weights, computed beside the card's work from phase 15 on in
# one process of its own, niced (REFS_NICE) so that the phases' own CPU work
# keeps the cores it asks for, with REFS_THREADS torch threads; a phase that
# needs one waits for it at most REFS_WAIT_S seconds
REFS_NICE = 10
REFS_THREADS = 4
REFS_WAIT_S = 900
# phase 16's timed steps a config (fewer than phase 11's, to leave phase 19
# room in the script's time), and the witnessed config's repeats of its
# card G step under deterministic algorithms
CONFIG_STEPS = 1
DET_REPEATS = 3
# phase 19: phase 16's configs at --dtype bfloat16; the unpaired stage runs
# no VGG tower, so no conv3x3_same_lowch
STAGE2_BF16_LAUNCHES = {**STEP_BF16_LAUNCHES, "conv3x3_same_lowch": {}}
DIAG_REL = 1e-4  # the diagnostics card vs CPU, relative
# phase 22: the noise pyramid's timed calls a size
NATIVE_REPS = 10
# the modules those configs added (and phase 22's library), imported before
# the check that no module of jax or of the JAX package was loaded
CONFIG_MODULES = ("michigan_tpu_torch.native", "michigan_tpu_torch.data.noise",
                  "michigan_tpu_torch.models.blend", "michigan_tpu_torch.models.encoders",
                  "michigan_tpu_torch.models.maskgan", "michigan_tpu_torch.models.discriminator",
                  "michigan_tpu_torch.tools.float64_step",
                  "michigan_tpu_torch.losses.color", "michigan_tpu_torch.ops.stats",
                  "michigan_tpu_torch.training.checkpoint", "michigan_tpu_torch.convert",
                  "michigan_tpu_torch.utils.iter_counter", "michigan_tpu_torch.serving",
                  "michigan_tpu_torch.serving.session", "michigan_tpu_torch.serving.export",
                  "michigan_tpu_torch.evaluate", "michigan_tpu_torch.models.inception",
                  "michigan_tpu_torch.parallel.dist", "michigan_tpu_torch.parallel.spatial",
                  "michigan_tpu_torch.tools.replica_objective",
                  "michigan_tpu_torch.training.diagnostics", "michigan_tpu_torch.utils.visualizer")
# phase 17: the serving session's buckets and request sizes (padding, and a
# split into 8 + 4), the bf16 --use_pallas_epilogue bucket's graph, and FID
SERVE_BUCKETS = (1, 4, 8)
SERVE_REQUESTS = (1, 3, 8, 11)
SERVE_KERNELS = ("spade_modulate", "fused_instance_norm", "conv3x3_in_act")
EPILOGUE_GRAPH_LAUNCHES = {**FLAGSHIP_LAUNCHES, "fused_instance_norm": 5, "conv3x3_in_act": 24}
FID_IMAGES, FID_SIZE, FID_BATCH = 16, 299, 8
FID_REL = 1e-3  # card vs CPU features, relative to their norm
# phase 18: data parallelism on the one card: DP_WORLD ranks on cuda:0 in a
# gloo group (NCCL refuses two ranks on one device; gloo all-reduces CUDA
# tensors through the host), the fp32 step at TRAIN_BATCH and full width,
# the bf16 step at DP16; group and join timeouts in seconds
DP_WORLD = 2
DP16 = dict(crop=256, ngf=32, ndf=32, batch=4)
DP_STEPS = 1
DP_GROUP_TIMEOUT_S = 300
DP_JOIN_S = 900
# phase 23: spatial sharding of inference (parallel/spatial.py): SPACE_WORLD
# gloo ranks on cuda:0, each holding one band of rows of the 1024^2 `most`
# flagship's planes (FLAGS + MOST_INFER, batch 1), against one process's
# forward on the same card; SPACE_REPS timed forwards after the compared
# one; spade_modulate at up_4's band (1, 64, 1152 / SPACE_WORLD, 1152)
# against its plain version; with two or more cards, NCCL ranks one card
# each as well; group and join timeouts in seconds
SPACE_WORLD = 2
SPACE_REPS = 2
SPACE_GROUP_TIMEOUT_S = 300
SPACE_JOIN_S = 600
# phase 24: spatial sharding of training: SPACE_WORLD gloo ranks on cuda:0,
# each holding one band of rows of the 1024^2 `most` step (TRAIN_FLAGS +
# MOST_TRAIN, batch 1, fp32, every default loss), against one process's step
# on the same card from the same weights, batch and EXTRA_DILATE: the
# losses within SPACE_LOSS_RTOL (ORIENT SPACE_ORIENT_RTOL, the JAX package's
# own limit for reordered argmax near-ties), the nets by phase 12's rule,
# the compared steps under deterministic algorithms; SPACE_TRAIN_STEPS
# timed steps (default algorithms) after the compared one
SPACE_LOSS_RTOL = 1e-3
SPACE_ORIENT_RTOL = 2e-2
SPACE_TRAIN_STEPS = 2
# phase 20: the 1024^2 configuration (--num_upsampling_layers most) at full
# width: inference on FLAGS at 1024 + --add_th 128 (generator planes 9^2 ...
# 1152^2, the pad-crop back to 1024), the training step on TRAIN_FLAGS at
# 1024 (the flag matrix's most_1024 row: planes 8^2 ... 1024^2), with and
# without --remat over up_1..up_4 (and the VGG tower of the fake); the flag
# matrix's all_losses_remat row on train-step-512's config at batch 8
MOST_INFER = ["--num_upsampling_layers", "most", "--crop_size", "1024", "--load_size", "1024",
              "--add_th", "128"]
MOST_TRAIN = ["--num_upsampling_layers", "most", "--load_size", "1136"]
MOST_REMAT = ["--remat", "--remat_blocks", "up_1,up_2,up_3,up_4"]
ALL_LOSSES_REMAT = ["--remat", "--remat_blocks", "up_1,up_2,up_3"]
# up_4's SPADE norms at 1152^2 (norm_0 and norm_s on its 64 input channels,
# norm_1 on 32) after the flagship's 18, whose planes `most` keeps
MOST_SPADE_SHAPES = {**SPADE_SHAPES, (64, 1152): 2, (32, 1152): 1}
MOST_LAUNCHES = {**FLAGSHIP_LAUNCHES, "spade_modulate": sum(MOST_SPADE_SHAPES.values())}
MOST_BF16_LAUNCHES = {**NO_LAUNCHES, "spade_modulate": {"bfloat16": MOST_LAUNCHES["spade_modulate"]},
                      "fused_instance_norm": {"bfloat16": 29}}
MOST_BATCHES = (1, 2, 4, 8)  # the largest-batch probes of the 1024^2 step
MOST_CHECK_CROP = 512        # the 1024^2 inference path card vs CPU at 512 + 128
MOST_STEPS = 2               # timed batch-1 1024^2 steps after the counted one
REMAT512_STEPS = 1           # timed all_losses_remat steps (batch 8) after the counted one
MOST_LOWCH = (2, 64, 1024, 1024)  # features_2 of the batch-1 step's tag+ref tower
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
# phase 21: the port's last model options at full width.  Inference: FLAGS
# with each option ({name: (flags added, flags dropped)}); the SPADE norms
# keep their spade_modulate launch under each (under --weight_norm_G with
# mean 0 and invstd 1: no param-free norm), and the IG its 29
# fused_instance_norm
VARIANT_INFER = {
    "Image_encoder_mode_norm": (["--Image_encoder_mode", "norm"], ()),
    "Image_encoder_mode_instance": (["--Image_encoder_mode", "instance"], ()),
    "no_encoder": ([], ("--use_encoder",)),
    "no_noise_background": ([], ("--noise_background",)),
    "orient_random_disturb": (["--orient_random_disturb"], ()),
    "weight_norm_G": (["--weight_norm_G"], ()),
    "instance_map": (["--no_instance", "False"], ()),
}
VARIANT_INFER_REPS = 2  # timed forwards a variant, after a warm-up
# training: two combined configs on TRAIN_FLAGS.  B's one n_layer D gives
# its features to the GAN-feature loss as the JAX package's split does
# (michigan_tpu_torch/model.py discriminate), whose fake and real pieces
# broadcast against each other only at batch 1: B runs without that loss
VARIANT_TRAIN = {
    "A": (["--Image_encoder_mode", "norm", "--norm_E", "spectralbatch", "--norm_D",
           "spectralbatch", "--weight_norm_G", "--reuse_fake_for_d"], ()),
    "B": (["--Image_encoder_mode", "instance", "--use_instance_feat", "--no_instance", "False",
           "--netD", "n_layer", "--no_ganFeat_loss"], ("--noise_background",)),
}
VARIANT_STEPS = 1  # timed batch-8 steps a config, after the counted one (the warm-up)
# spade_modulate under --weight_norm_G against x * (1 + gamma) + beta at the
# flagship's first and last SPADE shapes (C, H=W)
WN_SHAPES = ((1024, 18), (64, 576))
SEED = 0
MOST_GATE_SEEDS = (SEED, SEED + 1, SEED + 2)  # phase 20's bf16 gate on netG and netD
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


@contextlib.contextmanager
def deterministic_algorithms(torch, on=True):
    """Inside (with `on`), torch.use_deterministic_algorithms(True): every
    op without a deterministic CUDA form raises, cuDNN takes its
    deterministic algorithms (CUBLAS_WORKSPACE_CONFIG is set before the
    first CUDA call, in run)."""
    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


class PhaseClock:
    """Standard output that notes when each phase's first line is written,
    so that the run can say how its time splits across the phases."""

    def __init__(self, out):
        self.out, self.first, self.t0 = out, {}, time.perf_counter()

    def write(self, text):
        if text.startswith("[phase ") and "]" in text:
            self.first.setdefault(text[7:text.index("]")], time.perf_counter())
        return self.out.write(text)

    def __getattr__(self, name):
        return getattr(self.out, name)

    def seconds(self):
        """{phase: seconds from its first line to the next phase's first
        line (the last: to now)}, in the order the phases began."""
        order = sorted(self.first.items(), key=lambda kv: kv[1])
        ends = [t for _, t in order[1:]] + [time.perf_counter()]
        return {n: round(end - t, 1) for (n, t), end in zip(order, ends)}


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
            fake = m.generate_fake(pre, orient, EXTRA_DILATE)[0].requires_grad_()

        def g_fwd_bwd():
            m.generate_fake(pre, orient, EXTRA_DILATE)[0].sum().backward()

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
    """The smoke test."""
    # deterministic algorithms (phase 16) need cuBLAS's fixed workspace,
    # set before the first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    clock = sys.stdout = PhaseClock(sys.stdout)
    # before the first parallel CPU op, so that torch's worker threads
    # inherit it: the seeded inpainters' attention softmax underflows into
    # subnormals, on which the CPU references' matmuls run ~80x slower
    flushed = torch.set_flush_denormal(True)
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
        from michigan_tpu_torch.tools import float64_step
        from michigan_tpu_torch.train import parse_options as train_options
        from michigan_tpu_torch.training.diagnostics import diagnostics
        from michigan_tpu_torch.training.state import init_netd2_from_netd
        from michigan_tpu_torch.training.train_step import TrainStep
        from michigan_tpu_torch.utils.imaging import tensor2im
        for name in CONFIG_MODULES:
            importlib.import_module(name)
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
    phase(1, f"CPU subnormals flushed to zero: {flushed} (each flushed value is below "
             f"1.2e-38, far inside every limit of the CPU references; the card is untouched)")

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
        o = train_opts(train_options, n, crop, extra)
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
    for _ in range(SPLIT_STEPS):
        t0 = time.perf_counter()
        _g, _f, o = trainer.g_step(tbatch, EXTRA_DILATE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.d_step(tbatch, EXTRA_DILATE, o)
        torch.cuda.synchronize()
        g_times.append((t1 - t0) * 1e3)
        d_times.append((time.perf_counter() - t1) * 1e3)
    phase(11, f"G step {statistics.median(g_times):.1f} ms, D step "
              f"{statistics.median(d_times):.1f} ms (medians of {SPLIT_STEPS}) {tag}")
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
    # (B), against their plain versions and float64, then the step; the CPU
    # references of phases 16 and 21 start beside it (CpuRefs)
    refs = CpuRefs()
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
    for _ in range(SPLIT_STEPS):
        t0 = time.perf_counter()
        _g, _f, o = trainer16.g_step(tbatch, EXTRA_DILATE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer16.d_step(tbatch, EXTRA_DILATE, o)
        torch.cuda.synchronize()
        g_times.append((t1 - t0) * 1e3)
        d_times.append((time.perf_counter() - t1) * 1e3)
    phase(15, f"bf16 G step {statistics.median(g_times):.1f} ms, D step "
              f"{statistics.median(d_times):.1f} ms (medians of {SPLIT_STEPS}; fp32 {step32['g']:.1f} / "
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
    popt32 = train_opts(train_options, n, PARITY16["crop"], extra16)
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

    # 16 --------------------------------------------------------------
    # the VAE, blender and unpaired two-stage training configs: each driven
    # with the counts set to 0 just before its step and read just after
    def config_trainer(cfg, n, crop, extra=()):
        o, tr = make_trainer(n, crop, list(CONFIG_FLAGS[cfg]) + list(extra))
        if o.unpairTrain and o.same_netD_model:
            init_netd2_from_netd(tr.model)
        return o, tr

    def counted_step(tr, batch, by_dtype=False):
        """(losses, launches) of one G+D step, the counts set to 0 just
        before it and read just after (by dtype with `by_dtype`)."""
        kernels.reset_launch_counts()
        g, _f, o = tr.g_step(batch, EXTRA_DILATE)
        d = tr.d_step(batch, EXTRA_DILATE, o)
        torch.cuda.synchronize()
        return ({k: v.item() for k, v in {**g, **d}.items()},
                kernels.launch_counts(by_dtype=by_dtype))

    def timed_steps(tr, batch, steps=TRAIN_STEPS):
        """(step ms, G ms, D ms, peak bytes, live bytes) over `steps` steps
        after the warm-up, medians; each step synchronizes between its G
        step and its D step."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        rows = []
        for _ in range(steps):
            t0 = time.perf_counter()
            _g, _f, o = tr.g_step(batch, EXTRA_DILATE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr.d_step(batch, EXTRA_DILATE, o)
            torch.cuda.synchronize()
            rows.append(((time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3,
                         (time.perf_counter() - t1) * 1e3))
        med = [statistics.median(r[i] for r in rows) for i in range(3)]
        return (*med, torch.cuda.max_memory_allocated(), live, [r[0] for r in rows])

    config_counts, config_e2e = {}, {}
    for cfg in CONFIG_FLAGS:
        n = TRAIN_BATCH
        copt, tr = config_trainer(cfg, n, 512)
        nets = tr.model.nets()
        before = {k: snapshot(net) for k, net in nets.items()}
        stages = (2, 1) if cfg == "unpair" else (1,)
        for stage in stages:
            copt.curr_step = stage
            label = cfg if cfg != "unpair" else f"unpair stage {stage}"
            cbatch = batch_from_numpy(synthetic_train_data(copt, SEED, n, paired=stage == 1),
                                      "cuda:0")
            start = {k: snapshot(net) for k, net in nets.items()}
            losses, counts = counted_step(tr, cbatch)
            want = STAGE2_LAUNCHES if stage == 2 else STEP_LAUNCHES
            key = cfg if cfg != "unpair" else f"unpair_stage{stage}"
            config_counts[key] = counts
            moved = {k: any(not torch.equal(p, start[k][name])
                            for name, p in nets[k].named_parameters()) for k in nets
                     if k not in ("netIG", "vgg")}
            frozen = {k: all(torch.equal(t, before[k][name])
                             for name, t in nets[k].state_dict().items())
                      for k in ("netIG", "vgg")}
            # the nets a step of this config and stage must move, and no other
            want_moved = {"vae": ("netG", "netE", "netD"), "blender": ("netG", "netB", "netD"),
                          "unpair": ("netG", "netD2" if stage == 2 else "netD")}[cfg]
            phase(16, f"{label}, batch {n}, 512^2, ngf {copt.ngf}, ndf {copt.ndf}: launches "
                      f"{counts}; losses " + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
            phase(16, f"{label}: parameters changed {moved}; frozen nets bit-identical {frozen}")
            if counts != want:
                return fail(f"phase 16 {label}: expected launches per step {want}, got {counts}")
            if not all(math.isfinite(v) for v in losses.values()) or \
                    not all(frozen.values()) or \
                    any(moved[k] != (k in want_moved) for k in moved) or \
                    (cfg == "vae" and "KLD" not in losses):
                return fail(f"phase 16 {label}: the step's losses or parameter updates are wrong")
            ms, g_ms, d_ms, peak, live, times = timed_steps(tr, cbatch, CONFIG_STEPS)
            config_e2e[key] = (ms, peak)
            busy_ms, wall_ms, table, conv_ms, dev_ms = profile_once(
                lambda: tr.d_step(cbatch, EXTRA_DILATE, tr.g_step(cbatch, EXTRA_DILATE)[2]),
                torch)
            phase(16, f"{label}: {CONFIG_STEPS} timed steps after the warm-up: "
                      f"{', '.join(f'{t:.1f}' for t in times)} ms; median {ms:.1f} ms/step, "
                      f"{n / ms * 1e3:.2f} img/s; G step {g_ms:.1f} ms, D step {d_ms:.1f} ms; "
                      f"peak device memory {peak / 2**30:.2f} GiB ({live / 2**30:.2f} GiB live "
                      f"before); profiled step: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
                      f"wall, convolutions {conv_ms:.2f} of {dev_ms:.2f} ms device time {tag}; "
                      f"top device time:")
            print(table, flush=True)
            if cfg in F64_WITNESSED:
                # what deterministic algorithms, under which its card-vs-CPU
                # steps below run, cost this config's step
                with deterministic_algorithms(torch):
                    tr.d_step(cbatch, EXTRA_DILATE, tr.g_step(cbatch, EXTRA_DILATE)[2])
                    det_ms, _, _, _, _, det_times = timed_steps(tr, cbatch, CONFIG_STEPS)
                phase(16, f"{label}: under torch.use_deterministic_algorithms(True), "
                          f"{CONFIG_STEPS} timed steps after a warm-up: "
                          f"{', '.join(f'{t:.1f}' for t in det_times)} ms; median {det_ms:.1f} "
                          f"ms/step against {ms:.1f} without ({det_ms / ms - 1:+.1%}) {tag}")
            del cbatch
        del tr, nets, before, start
        torch.cuda.empty_cache()

    # each config's G+D step card vs CPU (unpair: stage 2) at PARITY16's
    # size in float32, at torch's default init and the config's own
    # (xavier), the VAE's eps the same draw on both: phase 12's rule.  The
    # blender's netG and netB, whose gradients come through netB's backward,
    # may instead pass the float64 witness (F64_CAL; a half-batch control
    # must fail both)
    def config_parity(cfg, init):
        extra = ["--ngf", str(PARITY16["ngf"]), "--ndf", str(PARITY16["ndf"]),
                 "--init_type", init]
        n = PARITY16["batch"]
        popt, card = config_trainer(cfg, n, PARITY16["crop"], extra)
        popt.curr_step = 2 if cfg == "unpair" else 1
        init_sd = {k: {n_: t.detach().cpu().clone() for n_, t in net.state_dict().items()}
                   for k, net in card.model.nets().items()}
        cpu_model = MichiGANModel(popt, "cpu")
        cpu_model.load_state_dicts(init_sd)
        cpu = TrainStep(cpu_model)
        data = synthetic_train_data(popt, SEED, n, paired=cfg != "unpair")
        b_card, b_cpu = batch_from_numpy(data, "cuda:0"), batch_from_numpy(data, "cpu")
        eps = card.new_eps(n)
        eps_cpu = None if eps is None else eps.cpu()
        # the blender's card steps under deterministic algorithms: under
        # cuDNN's default algorithms its step does not repeat bit for bit
        det = cfg in F64_WITNESSED
        with deterministic_algorithms(torch, det):
            g_card, _, o_card = card.g_step(b_card, EXTRA_DILATE, eps)
        t0 = time.perf_counter()
        g_cpu, _, o_cpu = cpu.g_step(b_cpu, EXTRA_DILATE, eps_cpu)
        t_cpu = time.perf_counter() - t0
        state = lambda net: {k: v.detach().cpu() for k, v in net.named_parameters()}
        g_nets = [k for k in ("netG", "netE", "netB") if k in cpu_model.nets()]
        card_g = {k: state(card.model.nets()[k]) for k in g_nets}
        cpu_g = {k: state(cpu_model.nets()[k]) for k in g_nets}
        lr_g = popt.lr / 2
        rules = {k: scale_aware(cpu_g[k], card_g[k], lr_g) for k in g_nets}
        witness = {}
        if cfg in F64_WITNESSED:
            nets_w = F64_WITNESSED[cfg]
            if cfg != "blender" or eps_cpu is not None or nets_w != F64_WITNESSED["blender"]:
                return f"phase 16: no float64 witness was computed for {cfg}"
            w64 = refs.get(f"witness_{init}")  # computed beside the card's work
            g64, exact, t64 = w64["g64"], w64["exact"], w64["s"]
            control = TrainStep(MichiGANModel(popt, "cuda:0"))
            control.model.load_state_dicts(init_sd)
            control.g_step({k: v[:n // 2] for k, v in b_card.items()}, EXTRA_DILATE,
                           None if eps is None else eps[:n // 2])
            grads = {"card": float64_step.adam_grads(card, nets_w),
                     "cpu": float64_step.adam_grads(cpu, nets_w),
                     "control": float64_step.adam_grads(control, nets_w)}
            for k in nets_w:
                ctl = state(control.model.nets()[k])
                worst, bad = scale_aware(cpu_g[k], ctl, lr_g)[1:3]
                witness[k] = {
                    "err": {r: float64_step.rel_err(g[k], g64[k]) for r, g in grads.items()},
                    "bad64": {"card": scale_aware(card_g[k], exact[k], lr_g)[2],
                              "cpu": scale_aware(cpu_g[k], exact[k], lr_g)[2]},
                    "control": (worst, bad)}
            # the card's G step again from the same state, under
            # deterministic algorithms: equal bit for bit, and netG's count
            # against float64 each time
            repeats = [card_g]
            for _ in range(DET_REPEATS - 1):
                again = TrainStep(MichiGANModel(popt, "cuda:0"))
                again.model.load_state_dicts(init_sd)
                with deterministic_algorithms(torch, True):
                    again.g_step(b_card, EXTRA_DILATE, eps)
                repeats.append({k: state(again.model.nets()[k]) for k in nets_w})
                del again
            same = all(torch.equal(r[k][p], repeats[0][k][p]) for r in repeats[1:]
                       for k in nets_w for p in repeats[0][k])
            phase(16, f"{cfg} --init_type {init}: the card's G step under "
                      f"torch.use_deterministic_algorithms(True), {DET_REPEATS} times from the "
                      f"same state: {', '.join(nets_w)} bit for bit equal {same}; netG's "
                      f"elements beyond float noise against the float64 G step "
                      f"{[scale_aware(r['netG'], exact['netG'], lr_g)[2] for r in repeats]} "
                      f"(under torch's default algorithms it spread 20,032-20,076 over repeats: PERF.md) "
                      f"{tag}")
            del control, grads, g64, exact, repeats

        def g_net_ok(k, worst, bad, tot, who="card"):
            """phase 12's rule; or for a witnessed net, a gradient as close to
            the float64 step's as F64_CAL x the CPU's float32 gradient."""
            if worst > 2.5 * lr_g:
                return False
            if bad <= max(1e-3 * tot, 8):
                return True
            return k in witness and \
                witness[k]["err"][who] <= F64_CAL * witness[k]["err"]["cpu"]

        # netG's running statistics and spectral u / v, as phase 12 holds them
        bufs = {k: v.cpu() for k, v in card.model.netG.named_buffers() if v.is_floating_point()}
        cpu_bufs = dict(cpu_model.netG.named_buffers())
        buf_err = max((cpu_bufs[k] - v).abs().max().item() for k, v in bufs.items())
        bufs_ok = all(torch.allclose(cpu_bufs[k], v, rtol=1e-4, atol=1e-5)
                      for k, v in bufs.items())
        # the D step on both from the card's post-G state, as phase 12's
        for k in g_nets:
            cpu_model.nets()[k].load_state_dict({n_: v.cpu() for n_, v in
                                                 card.model.nets()[k].state_dict().items()})
        with deterministic_algorithms(torch, det):
            d_card = card.d_step(b_card, EXTRA_DILATE, o_card)
        t0 = time.perf_counter()
        d_cpu = cpu.d_step(b_cpu, EXTRA_DILATE, o_cpu)
        t_cpu += time.perf_counter() - t0
        d_name = "netD2" if cfg == "unpair" else "netD"
        d_rule = scale_aware(state(cpu_model.nets()[d_name]), state(card.model.nets()[d_name]),
                             2 * popt.lr)
        loss_rows, ok = [], True
        for k in list(g_card) + list(d_card):
            a = (g_card[k] if k in g_card else d_card[k]).item()
            b = (g_cpu[k] if k in g_cpu else d_cpu[k]).item()
            good = abs(a - b) <= 1e-5 + 1e-4 * abs(b)
            ok &= good
            loss_rows.append(f"{k} {a:.6f}/{b:.6f}{'' if good else ' FAIL'}")
        net_rows = []
        for k, (_, worst, bad, tot) in rules.items():
            good = g_net_ok(k, worst, bad, tot)
            ok &= good
            row = (f"{k} max diff {worst:.2e}, {bad} of {tot} beyond float noise (phase 12's "
                   f"limit {max(1e-3 * tot, 8):.0f})")
            if k in witness:
                w = witness[k]
                row += (f"; gradient error against the CPU's float64 step: the card "
                        f"{w['err']['card']:.2e}, the CPU's float32 step {w['err']['cpu']:.2e} "
                        f"(limit {F64_CAL * w['err']['cpu']:.2e}); elements beyond float noise "
                        f"against the float64 step: the card {w['bad64']['card']}, the CPU "
                        f"{w['bad64']['cpu']}")
            net_rows.append(row + ("" if good else " FAIL"))
        ok &= bufs_ok and d_rule[0]
        net_rows.append(f"{d_name} max diff {d_rule[1]:.2e}, {d_rule[2]} of {d_rule[3]} beyond "
                        f"float noise; netG buffers max diff {buf_err:.2e}; CPU step "
                        f"{t_cpu:.1f} s" + (f", float64 G step {t64:.1f} s (beside the card's "
                                           f"work, niced)" if witness else ""))
        phase(16, f"{cfg} G+D step card/CPU at --init_type {init}, batch {n}, "
                  f"{PARITY16['crop']}^2, ngf {PARITY16['ngf']}, ndf {PARITY16['ndf']}: "
                  + ", ".join(loss_rows))
        phase(16, f"{cfg} --init_type {init}: " + "; ".join(net_rows))
        if not ok:
            return f"phase 16: the card's and the CPU's {cfg} steps disagree at --init_type {init}"
        if witness:
            # the card's G step on the first half of the batch, through the same gate
            passes = [g_net_ok(k, *w["control"], rules[k][3], "control")
                      for k, w in witness.items()]
            phase(16, f"{cfg} --init_type {init}: control, the card's G step on the first "
                      f"{n // 2} of the {n} samples: " + ", ".join(
                          f"{k} {w['control'][1]} beyond float noise against the CPU, gradient "
                          f"error {w['err']['control']:.2e} against the float64 step"
                          for k, w in witness.items())
                      + (": passes, FAIL" if any(passes) else ": fails the gate, as it must"))
            if any(passes):
                return f"phase 16's gate passes a {cfg} step that dropped half its batch"
        return None

    for cfg in CONFIG_FLAGS:
        for init in ("none", "xavier"):
            msg = config_parity(cfg, init)
            torch.cuda.empty_cache()
            if msg:
                return fail(msg)

    # 17 ---------------------------------------------------------------
    t17 = time.perf_counter()
    msg, served = serving_phase(torch, np, tag)
    if msg:
        return fail(msg)
    session_launches, fid_lowch = served
    phase(17, f"serving, export and FID in {time.perf_counter() - t17:.1f} s")

    # 18 ---------------------------------------------------------------
    msg = dp_phase(torch, tag)
    if msg:
        return fail(msg)

    # 19 ---------------------------------------------------------------
    # phase 16's configs at --dtype bfloat16: each step at batch 8, 512^2,
    # full width, with the counts set to 0 just before it and read just
    # after, by dtype; then each step card-bf16 vs CPU-bf16 by phase 15's
    # gate, with a half-batch control that must fail it
    t19 = time.perf_counter()
    bf16 = ["--dtype", "bfloat16"]
    counts19 = {}
    for cfg in CONFIG_FLAGS:
        n = TRAIN_BATCH
        copt, tr = config_trainer(cfg, n, 512, bf16)
        nets = tr.model.nets()
        for stage in ((2, 1) if cfg == "unpair" else (1,)):
            copt.curr_step = stage
            label = cfg if cfg != "unpair" else f"unpair stage {stage}"
            key = cfg if cfg != "unpair" else f"unpair_stage{stage}"
            cbatch = batch_from_numpy(synthetic_train_data(copt, SEED, n, paired=stage == 1),
                                      "cuda:0")
            start = {k: snapshot(net) for k, net in nets.items()}
            losses, counts = counted_step(tr, cbatch, by_dtype=True)
            counts19[key] = counts
            want = STAGE2_BF16_LAUNCHES if stage == 2 else STEP_BF16_LAUNCHES
            moved = {k: any(not torch.equal(p, start[k][name])
                            for name, p in nets[k].named_parameters()) for k in nets
                     if k not in ("netIG", "vgg")}
            frozen = {k: all(torch.equal(t, start[k][name])
                             for name, t in nets[k].state_dict().items())
                      for k in ("netIG", "vgg")}
            stored = {k: sorted({str(t.dtype) for t in nets[k].state_dict().values()
                                 if t.is_floating_point()}) for k in nets}
            want_moved = {"vae": ("netG", "netE", "netD"), "blender": ("netG", "netB", "netD"),
                          "unpair": ("netG", "netD2" if stage == 2 else "netD")}[cfg]
            phase(19, f"{label} at --dtype bfloat16, batch {n}, 512^2, ngf {copt.ngf}, ndf "
                      f"{copt.ndf}: launches by dtype {counts}; losses "
                      + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
            phase(19, f"{label} bf16: parameters changed {moved}; frozen nets bit-identical "
                      f"{frozen}; floating dtypes stored {stored}")
            if counts != want:
                return fail(f"phase 19 {label}: expected launches per bf16 step {want}, "
                            f"got {counts}")
            if not all(math.isfinite(v) for v in losses.values()) or \
                    not all(frozen.values()) or \
                    any(moved[k] != (k in want_moved) for k in moved) or \
                    any(stored[k] != ["torch.float32"] for k in nets
                        if k not in ("netIG", "vgg")) or \
                    stored["vgg"] != ["torch.bfloat16"] or \
                    (cfg == "vae" and "KLD" not in losses):
                return fail(f"phase 19 {label}: the bf16 step's losses, updates or stored "
                            f"dtypes are wrong")
            ms, g_ms, d_ms, peak, live, times = timed_steps(tr, cbatch)
            ms32, peak32 = config_e2e[key]
            phase(19, f"{label} bf16: {TRAIN_STEPS} timed steps after the warm-up: "
                      f"{', '.join(f'{t:.1f}' for t in times)} ms; median {ms:.1f} ms/step, "
                      f"{n / ms * 1e3:.2f} img/s; G step {g_ms:.1f} ms, D step {d_ms:.1f} ms; "
                      f"peak device memory {peak / 2**30:.2f} GiB ({live / 2**30:.2f} GiB live "
                      f"before); float32 (phase 16) {ms32:.1f} ms/step, {peak32 / 2**30:.2f} GiB "
                      f"{tag}")
            del cbatch
        del tr, nets, start
        torch.cuda.empty_cache()

    def bf16_config_parity(cfg, stage):
        """Phase 15's card-vs-CPU bf16 comparison of one config and stage,
        with the VAE's eps one draw on all three and the G-side nets of
        the CPU's D steps the card's post-G ones; returns (failure or None,
        the card's trainer)."""
        extra16 = ["--ngf", str(PARITY16["ngf"]), "--ndf", str(PARITY16["ndf"])]
        n = PARITY16["batch"]
        popt16, card16 = config_trainer(cfg, n, PARITY16["crop"], extra16 + bf16)
        popt32 = train_opts(train_options, n, PARITY16["crop"], list(CONFIG_FLAGS[cfg]) + extra16)
        popt16.curr_step = popt32.curr_step = stage
        init16 = {k: {n_: t.detach().cpu().clone() for n_, t in net.state_dict().items()}
                  for k, net in card16.model.nets().items()}

        def trainer_from_init(o, dev):
            m = MichiGANModel(o, dev)
            m.load_state_dicts(init16)  # float32 modules take the bf16 frozen leaves as they are
            return TrainStep(m)

        data = synthetic_train_data(popt16, SEED, n, paired=stage == 1)
        eps = card16.new_eps(n)
        cut = lambda e, dev, k=n: None if e is None else e[:k].to(dev)
        trainers = {"card": (card16, "cuda:0", data, eps),
                    "cpu16": (trainer_from_init(popt16, "cpu"), "cpu", data, cut(eps, "cpu")),
                    "cpu32": (trainer_from_init(popt32, "cpu"), "cpu", data, cut(eps, "cpu")),
                    "control": (trainer_from_init(popt16, "cuda:0"), "cuda:0",
                                {k: v[:n // 2] for k, v in data.items()},
                                cut(eps, "cuda:0", n // 2))}
        g_names = [k for k in ("netG", "netE", "netB") if k in card16.model.nets()]
        d_name = "netD2" if stage == 2 else "netD"
        params_of = lambda net: {k: v.detach().cpu().clone() for k, v in net.named_parameters()}
        runs19, batches, orients, t_cpu = {}, {}, {}, 0.0
        # the blender's card steps (and its control) under deterministic
        # algorithms, as phase 16 runs them: the gate is calibrated on a step
        # that repeats
        det = lambda dev: deterministic_algorithms(torch, cfg in F64_WITNESSED and dev != "cpu")
        for name, (tr_, dev, d_, e_) in trainers.items():
            batches[name] = batch_from_numpy(d_, dev)
            t0 = time.perf_counter()
            with det(dev):
                g, _f, orients[name] = tr_.g_step(batches[name], EXTRA_DILATE, e_)
            t_cpu += (time.perf_counter() - t0) if dev == "cpu" else 0.0
            runs19[name] = {"losses": {k: v.item() for k, v in g.items()},
                            "params": {k: params_of(tr_.model.nets()[k]) for k in g_names}}
        post_g = {k: {n_: v.cpu() for n_, v in card16.model.nets()[k].state_dict().items()}
                  for k in g_names}
        for name, (tr_, dev, d_, e_) in trainers.items():
            if dev == "cpu":
                for k in g_names:
                    tr_.model.nets()[k].load_state_dict(post_g[k])
            t0 = time.perf_counter()
            with det(dev):
                d = tr_.d_step(batches[name], EXTRA_DILATE, orients[name])
            t_cpu += (time.perf_counter() - t0) if dev == "cpu" else 0.0
            runs19[name]["losses"].update({k: v.item() for k, v in d.items()})
            runs19[name]["params"][d_name] = params_of(tr_.model.nets()[d_name])
        lrs = {**{k: popt16.lr / 2 for k in g_names}, d_name: 2 * popt16.lr}
        ok, rows = step_gate(runs19["card"], runs19["cpu16"], runs19["cpu32"], lrs)
        control_ok, control_rows = step_gate(runs19["control"], runs19["cpu16"], runs19["cpu32"],
                                             lrs)
        label = cfg if cfg != "unpair" else f"unpair stage {stage}"
        phase(19, f"{label}: one bf16 G+D step card/CPU, batch {n}, {PARITY16['crop']}^2, ngf "
                  f"{PARITY16['ngf']}, ndf {PARITY16['ndf']}, per loss card-vs-CPU bf16 / CPU "
                  f"bf16 vs fp32: " + ", ".join(rows) + f"; CPU steps {t_cpu:.1f} s")
        phase(19, f"{label}: control, the card's step on the first {n // 2} of the {n} samples "
                  f"against the same CPU steps: " + ", ".join(control_rows)
                  + (": passes, FAIL" if control_ok else ": fails the gate, as it must"))
        if not ok:
            return f"phase 19: the card's and the CPU's bf16 {label} steps disagree", None
        if control_ok:
            return f"phase 19's gate passes a bf16 {label} step that dropped half its batch", None
        return None, card16

    for cfg in CONFIG_FLAGS:
        for stage in ((2, 1) if cfg == "unpair" else (1,)):
            msg, card16 = bf16_config_parity(cfg, stage)
            if msg:
                return fail(msg)
            if cfg == "unpair" and stage == 2:
                # the trainer's --stats_freq diagnostics on the card, against
                # the same weights on the CPU
                cpu_model = MichiGANModel(card16.opt, "cpu")
                cpu_model.load_state_dicts({k: {n_: t.cpu() for n_, t in net.state_dict().items()}
                                            for k, net in card16.model.nets().items()})
                diag, diag_cpu = diagnostics(card16.model), diagnostics(cpu_model)
                worst = max(abs(diag[k] - v) / max(abs(v), 1e-12) for k, v in diag_cpu.items())
                phase(19, f"--stats_freq diagnostics of the bf16 unpair model after its stage-2 "
                          f"step, on the card: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                                              diag.items())
                          + f"; against the CPU's, largest relative difference {worst:.2e} "
                          f"(limit {DIAG_REL:g})")
                if set(diag) != set(diag_cpu) or not worst <= DIAG_REL or \
                        not all(math.isfinite(v) for v in diag.values()):
                    return fail("phase 19: the card's diagnostics disagree with the CPU's")
                del cpu_model
            del card16
            torch.cuda.empty_cache()
    phase(19, f"the bf16 configs in {time.perf_counter() - t19:.1f} s")

    # 20 --------------------------------------------------------------
    # the 1024^2 configuration (--num_upsampling_layers most) and --remat
    msg, k20 = most_kernels(torch, F, tag)
    if msg:
        return fail(msg)
    msg, most = most_phase(torch, np, tag, step32)
    if msg:
        return fail(msg)

    # 21 --------------------------------------------------------------
    # the port's last model options (encoders, seeds, background encoder,
    # norms, discriminators, netFE, instance maps) at full width
    msg, variants = variants_phase(torch, np, tag, refs)
    if msg:
        return fail(msg)

    # 22 --------------------------------------------------------------
    # the trainer's native host library, built and held here on the host
    msg = native_phase(np, tag, ms16 / TRAIN_BATCH)
    if msg:
        return fail(msg)

    # 23 --------------------------------------------------------------
    # spatial sharding of the 1024^2 forward: row bands on two ranks
    msg, space = spatial_phase(torch, np, tag)
    if msg:
        return fail(msg)

    # 24 --------------------------------------------------------------
    # spatial sharding of the 1024^2 training step: row bands on two ranks
    msg, space_train = spatial_train_phase(torch, np, tag)
    if msg:
        return fail(msg)

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
         **({"replaced_route_ms": epi_route_ms} if k == "conv3x3_in_act" else {}),
         # phase 16's counted steps of the VAE, blender and unpaired configs
         "config_launches": {c: config_counts[c][k] for c in config_counts},
         # phase 19's, at --dtype bfloat16: this row's float32 launches
         **({"bf16_config_launches": {c: counts19[c][k].get("float32", 0) for c in counts19}}
            if k == "filterbank_orientation_backward" else {}),
         # phase 17's session: the captured graphs' launches per request
         **({"session_launches": {r: n for r, n in session_launches[k].items()
                                  if r.startswith("fp32")}} if k in session_launches else {}),
         **({"fid_vgg_launches_per_batch": fid_lowch} if k == "conv3x3_same_lowch" else {})}
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
            "session_launches": {r: n for r, n in session_launches[k].items()
                                 if r.startswith("bf16")},
            **({"config_launches": {c: counts19[c][k].get("bfloat16", 0) for c in counts19}}
               if k == "fused_instance_norm" else {}),
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
            # phase 19's counted steps of the bf16 VAE, blender and unpaired configs
            "config_launches": {c: counts19[c][k].get("bfloat16", 0) for c in counts19},
            **({} if lowch else {"operands": "bf16, sums float32",
                                 "replaced_route_ms": bank_route16_ms})})
    # the 1024^2 configuration's forward and step launch the fused
    # instance norm at the IG's shapes, as at 512^2 (phase 20)
    for row in kernel_rows:
        if row["name"] in ("fused_instance_norm", "fused_instance_norm_bf16"):
            key = "bfloat16" if row["name"].endswith("_bf16") else None
            pick = lambda c: c["fused_instance_norm"][key] if key else c["fused_instance_norm"]
            row["launches_1024"] = {
                "forward": pick(most[f"infer_{key or 'float32'}"]),
                "step": pick(most[f"step_{key or 'float32'}"])}
    kernel_rows += most_rows(k20, most)
    # phase 21's counted runs of the last model options
    for row in kernel_rows:
        if row["name"] in REPLACES:
            row["variants_launches"] = {r: c[row["name"]] for r, c in variants.items()}
    # phase 23's counted spatial forwards, a rank's launches (fp32 on the
    # float32 rows, bf16 on the _bf16 rows), and spade_modulate at a band
    for row in kernel_rows:
        name, dtype = (row["name"][:-5], "bfloat16") if row["name"].endswith("_bf16") \
            else (row["name"], "float32")
        if name in SERVE_KERNELS[:2]:
            row["spatial_launches_per_rank"] = [c[dtype][name].get(dtype, 0)
                                                for c in space["counts"]]
            if name == "spade_modulate":
                row["band"] = space["band"][dtype]
    # phase 24's counted training step in row bands, a rank's launches
    for row in kernel_rows:
        if row["name"] in ("fused_instance_norm", "filterbank_orientation",
                           "filterbank_orientation_backward", "conv3x3_same_lowch"):
            row["spatial_train_launches_per_rank"] = [c[row["name"]]
                                                      for c in space_train["counts"]]
    print(f"[timing] seconds from each phase's first line to the next's: {clock.seconds()}; "
          f"{time.perf_counter() - clock.t0:.1f} s in all")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def native_phase(np, tag, step_ms_per_image):
    """Phase 22 (see the module docstring); returns a failure message or
    None."""
    from michigan_tpu_torch import native

    t_phase = time.perf_counter()
    try:
        path = native.build()
        native.get_lib()
    except (RuntimeError, OSError) as e:
        return f"phase 22: the native library does not build or load here: {e}"
    phase(22, f"g++ built and loaded {os.path.relpath(path, os.path.dirname(__file__))} in "
              f"{time.perf_counter() - t_phase:.2f} s")
    failed = []
    for size in (512, 1024):
        a, b = (native.noise_pyramid(size, size, SEED) for _ in range(2))
        c = native.noise_pyramid(size, size, SEED + 1)
        ok = (a.shape == (size, size, 3) and bool(np.isfinite(a).all()) and np.array_equal(a, b)
              and not np.array_equal(a, c) and abs(float(a.mean()) - 0.5) < 0.02
              and 0.05 < float(a.std()) < 0.3)
        phase(22, f"noise_pyramid {size}^2: seed {SEED} twice bit-equal {np.array_equal(a, b)}, "
                  f"seed {SEED + 1} differs {not np.array_equal(a, c)}; mean {a.mean():.4f}, "
                  f"std {a.std():.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"noise_pyramid {size}^2")
    rng = np.random.default_rng(SEED)
    mask = (rng.uniform(size=(512, 512)) > 0.3).astype(np.float32)
    orient = mask * (rng.uniform(size=(512, 512)) > 0.5).astype(np.float32)
    for ch, cw, rr in ((256, 300, 2500.0), (0, 511, 90000.0), (511, 0, 1.0)):
        got = native.rasterize_hole(mask, orient, ch, cw, rr)
        ok = np.array_equal(got, native.rasterize_hole_plain(mask, orient, ch, cw, rr))
        phase(22, f"rasterize_hole (512,512) centre ({ch},{cw}) rr {rr:g} equals its numpy "
                  f"formula: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append("rasterize_hole")
    # the pyramid's upsamplings at 512^2 and 1024^2, and a ragged downsample
    for (h, w), (dh, dw) in (((256, 256), (512, 512)), ((8, 8), (512, 512)),
                             ((16, 16), (1024, 1024)), ((37, 53), (100, 64))):
        src = rng.standard_normal((h, w, 3)).astype(np.float32)
        err = float(np.abs(native.bilinear_resize(src, dh, dw)
                           - native.bilinear_resize_plain(src, dh, dw)).max())
        phase(22, f"bilinear_resize ({h},{w},3) -> ({dh},{dw}) vs numpy half-pixel bilinear: "
                  f"max_abs_err {err:.3e} {'ok' if err <= 1e-4 else 'FAIL'}")
        if err > 1e-4:
            failed.append("bilinear_resize")
    per_sample = {}
    for size in (512, 1024):
        native.noise_pyramid(size, size, 1)
        times = []
        for i in range(NATIVE_REPS):
            t0 = time.perf_counter()
            native.noise_pyramid(size, size, i)
            times.append((time.perf_counter() - t0) * 1e3)
        per_sample[size] = statistics.median(times)
        phase(22, f"noise_pyramid {size}^2: {per_sample[size]:.3f} ms per sample (median of "
                  f"{NATIVE_REPS}, host clock, one thread; {min(times):.3f}-{max(times):.3f}) {tag}")
    phase(22, f"the loader's noise at 512^2 is {per_sample[512]:.3f} ms of one loader thread per "
              f"sample, beside {step_ms_per_image:.2f} ms of card per image in the bf16 512^2 "
              f"step (phase 15): {per_sample[512] / step_ms_per_image:.1%} {tag}")
    phase(22, "the Qt editor and the PIL loader are not run on this machine (no PyQt5, PIL or "
              "cv2); the edit they drive is phases 9 and 14 (DemoEngine, fp32 and bf16), the "
              "step they feed phases 11 and 15")
    phase(22, f"{time.perf_counter() - t_phase:.1f} s")
    if failed:
        return f"phase 22: the native library's checks failed: {failed}"
    return None


def serving_phase(torch, np, tag):
    """Phase 17: the serving session, the exported program and FID's
    features at full width.  Returns (failure message or None, {kernel:
    {run: launches per request}} of the session, FID's VGG launches of
    conv3x3_same_lowch per batch)."""
    from michigan_tpu_torch import evaluate
    from michigan_tpu_torch.data.synthetic import synthetic_inference_data
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.ops import cuda as kernels
    from michigan_tpu_torch.ops.cuda import build
    from michigan_tpu_torch.serving import InferenceSession, export_inference, load_exported
    from michigan_tpu_torch.utils.imaging import tensor2im

    keys = tuple(InferenceSession.BATCH_CHANNELS)
    seed = ["--seed", str(SEED)]

    def request(opt, n, s):
        data = synthetic_inference_data(opt, s, batch=n)
        return {k: data[k] for k in keys}

    def nhwc(t):
        return t.permute(0, 2, 3, 1).float().cpu().numpy()

    def compare(got, want, opt):
        """(max abs, the lowest uint8 PSNR over the samples' crops, bit for bit)."""
        r, c = opt.add_th // 2, opt.crop_size
        crop = lambda a: tensor2im(a[r:r + c, r:r + c])
        psnr = min(psnr_u8(crop(g), crop(w), np) for g, w in zip(got, want))
        return float(np.abs(got - want).max()), psnr, bool(np.array_equal(got, want))

    def eager_request(model, data):
        image, orient = model.infer(batch_from_numpy(data, "cuda:0"))
        return nhwc(image), nhwc(orient)

    def eager_chunks(model, data, buckets):
        """Eager infer of the chunks the session runs: the same batch sizes,
        so the same convolution algorithms."""
        n, out = len(data[keys[0]]), []
        for start in range(0, n, buckets[-1]):
            take = min(n - start, buckets[-1])
            b = next(b for b in buckets if b >= take)
            chunk = {k: v[start:start + take] for k, v in data.items()}
            chunk = {k: np.concatenate([v] + [v[-1:]] * (b - take)) for k, v in chunk.items()}
            out.append([a[:take] for a in eager_request(model, chunk)])
        return tuple(np.concatenate(parts) for parts in zip(*out))

    launches = {k: {} for k in SERVE_KERNELS}
    runs = {"fp32": ([], SERVE_BUCKETS, SERVE_REQUESTS, FLAGSHIP_LAUNCHES),
            "bf16": (["--dtype", "bfloat16"], SERVE_BUCKETS, SERVE_REQUESTS, FLAGSHIP_LAUNCHES),
            "bf16 --use_pallas_epilogue": (["--dtype", "bfloat16", "--use_pallas_epilogue"], (1,),
                                           (1,), EPILOGUE_GRAPH_LAUNCHES)}
    for label, (extra, buckets, sizes, per_graph) in runs.items():
        opt = parse_options(FLAGS + seed + extra)
        model = MichiGANModel(opt, "cuda:0")
        model.init_weights(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        session = InferenceSession(model, (opt.crop_size, opt.crop_size), buckets)
        session.precompile()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        phase(17, f"{label} session: graphs of buckets {buckets} captured in "
                  + ", ".join(f"{b}: {c['seconds']:.2f} s" for b, c in session.captured.items())
                  + f" (warm-up included); launches while capturing {counts}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated with every graph's "
                  f"pool held {tag}")
        graphs = {b: c["launches"] for b, c in session.captured.items()}
        if any(g != per_graph for g in graphs.values()) or \
                not all(counts[k] > 0 for k, n in per_graph.items() if n):
            return f"{label} session: each graph should launch {per_graph}, got {graphs}", None
        for n in sizes:
            data = request(opt, n, SEED + n)
            kernels.reset_launch_counts()
            before = dict(session.replays)
            image, orient = session.infer(data)
            eager_counts = kernels.launch_counts()
            replays = {b: session.replays[b] - before[b] for b in buckets}
            per_request = {k: sum(r * graphs[b][k] for b, r in replays.items())
                           for k in SERVE_KERNELS}
            want_image, want_orient = eager_chunks(model, data, buckets)
            diff, psnr, equal = compare(image, want_image, opt)
            o_diff = float(np.abs(orient - want_orient).max())
            phase(17, f"{label} request of {n}: replays {replays}, launches per request "
                      f"{per_request}, launched from Python during it {sum(eager_counts.values())}; "
                      f"session vs eager infer: image max abs {diff:.3e}, PSNR {psnr:.2f} dB (limit "
                      f"2e-3, 50 dB), orientation max abs {o_diff:.3e}, bit for bit "
                      f"{equal and o_diff == 0}")
            if image.shape != want_image.shape or not diff <= 2e-3 or not psnr > 50 \
                    or not o_diff <= 2e-3 or any(eager_counts.values()):
                return f"{label} session disagrees with eager infer at request size {n}", None
            for k in SERVE_KERNELS:
                launches[k][f"{label}, request of {n}"] = per_request[k]
        if len(buckets) > 1:
            for n in (1, 8):
                data = request(opt, n, SEED)
                ms_s = host_ms(lambda: session.infer(data), torch, 10) / n
                ms_e = host_ms(lambda: eager_request(model, data), torch, 10) / n
                phase(17, f"{label} batch {n}: session {ms_s:.2f} ms/image, eager {ms_e:.2f} "
                          f"ms/image (numpy in and out, host clock, median of 10) {tag}")
            data = request(opt, 1, SEED)
            for who, fn in (("session", lambda: session.infer(data)),
                            ("eager", lambda: eager_request(model, data))):
                busy_ms, wall_ms = profile_once(fn, torch)[:2]
                phase(17, f"{label} batch-1 request, {who}, profiled: device busy {busy_ms:.2f} "
                          f"ms of {wall_ms:.2f} ms wall ({busy_ms / wall_ms:.0%}) {tag}")
        if session.recaptures:
            return f"{label} session captured again with its weights unchanged", None
        if label == "fp32":
            # a second checkpoint loaded in place: the session captures
            # again and serves it
            data = request(opt, 1, SEED)
            before, _ = session.infer(data)
            other = MichiGANModel(opt, "cuda:0")
            other.init_weights(SEED + 1)
            model.load_state_dicts({k: net.state_dict() for k, net in other.nets().items()})
            del other
            t0 = time.perf_counter()
            image, _ = session.infer(data)
            reload_s = time.perf_counter() - t0
            want_image, _ = eager_chunks(model, data, buckets)
            diff, psnr, _ = compare(image, want_image, opt)
            moved = float(np.abs(image - before).max())
            phase(17, f"{label} session after load_state_dicts of seed {SEED + 1}: recaptures "
                      f"{session.recaptures}, first request {reload_s:.2f} s (capture of every "
                      f"bucket included); vs that seed's eager infer max abs {diff:.3e}, PSNR "
                      f"{psnr:.2f} dB; moved {moved:.3e} from the first checkpoint's image")
            if session.recaptures != 1 or not diff <= 2e-3 or not psnr > 50 or not moved > 2e-2:
                return f"{label} session does not serve a reloaded checkpoint", None
        del session, model
        torch.cuda.empty_cache()

    # the exported program, fp32 at batch 1, and a second seed's state_dicts
    opt = parse_options(FLAGS + seed)
    models = [MichiGANModel(opt, "cuda:0") for _ in range(2)]
    for i, m in enumerate(models):
        m.init_weights(SEED + i)
    batch = batch_from_numpy(request(opt, 1, SEED), "cuda:0")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = str(build.BUILD_DIR / "exported_flagship.pt2")
    t0 = time.perf_counter()
    export_inference(models[0], batch, path)
    export_s = time.perf_counter() - t0
    fn = load_exported(path)
    for i, m in enumerate(models):
        kernels.reset_launch_counts()
        image, orient = fn({k: net.state_dict() for k, net in m.nets().items()}, batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want_image, want_orient = m.infer(batch)
        diff, psnr, equal = compare(nhwc(image), nhwc(want_image), opt)
        o_diff = (orient - want_orient).abs().max().item()
        phase(17, f"exported program (export {export_s:.1f} s), seed {SEED + i}'s state_dicts: "
                  f"launches {counts}; vs eager infer max abs {diff:.3e}, PSNR {psnr:.2f} dB, "
                  f"orientation {o_diff:.3e}, bit for bit {equal and o_diff == 0}")
        if counts != FLAGSHIP_LAUNCHES or not diff <= 2e-3 or not psnr > 50 or not o_diff <= 2e-3:
            return "the exported program disagrees with eager infer or skips a kernel", None
    os.remove(path)
    del models, fn
    torch.cuda.empty_cache()

    # FID: the extractors' features of seeded 299^2 images on the card and CPU
    rng = np.random.default_rng(SEED)
    sets = [rng.uniform(-1, 1, (FID_IMAGES, FID_SIZE, FID_SIZE, 3)).astype(np.float32)
            for _ in range(2)]
    ckpt = str(build.BUILD_DIR / "no_weights")  # the seeded fallback on both devices
    fid_lowch = None
    for name in ("vgg", "inception"):
        kernels.reset_launch_counts()
        card = evaluate.extract_features(sets[0], name, FID_BATCH, "cuda:0", ckpt)
        if name == "vgg":
            fid_lowch = kernels.launch_counts()["conv3x3_same_lowch"] / (FID_IMAGES // FID_BATCH)
        pretrained = evaluate.extract_features.last_pretrained
        cpu = evaluate.extract_features(sets[0], name, FID_BATCH, "cpu", ckpt)
        rel = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu))
        fid = evaluate.frechet_distance(card, evaluate.extract_features(
            sets[1], name, FID_BATCH, "cuda:0", ckpt))
        net, _, _ = evaluate._extractor(name, torch.device("cuda:0"), ckpt)
        x8 = torch.from_numpy(sets[0][:FID_BATCH]).cuda()

        def features():
            with torch.no_grad():
                net(x8)

        ms = median_ms(features, torch, False, reps=5, inner=3)
        phase(17, f"FID {name}: features {card.shape} card vs CPU relative error {rel:.2e} "
                  f"(limit {FID_REL:g}); FID of two seeded sets of {FID_IMAGES} on the card "
                  f"{fid:.4f}; {ms:.2f} ms per batch of {FID_BATCH} (CUDA events); "
                  f"pretrained={pretrained}"
                  + (f"; conv3x3_same_lowch launches per batch {fid_lowch:g}" if name == "vgg"
                     else "") + f" {tag}")
        if not rel <= FID_REL or not np.isfinite(fid):
            return f"FID {name}: card features disagree with the CPU's", None
        del net, x8
    return None, (launches, fid_lowch)


def most_kernels(torch, F, tag):
    """Phase 20's kernels at the 1024^2 configuration's shapes, each against
    its plain version, then device times beside the plain version, the
    library call where one computes the same function and the bound.
    Returns (failure or None, {row: {max_abs_err, ms, plain_ms, work, rate,
    library_ms, shape}})."""
    from michigan_tpu_torch.ops import filters
    from michigan_tpu_torch.ops.cuda import lowch as LC
    from michigan_tpu_torch.ops.cuda import orient as O
    from michigan_tpu_torch.ops.cuda import spade as K

    cgen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows, failed = {}, []
    # spade_modulate: the forward's 21 calls, device time summed over them;
    # up_4's shapes also against the plain version
    for dname, tol in TOLS.items():
        dtype = getattr(torch, dname)
        row = rows.setdefault(f"spade_modulate{'_bf16' if dname == 'bfloat16' else ''}", dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, work=[0, 0], library_ms=None,
            rate=FP32_FLOP_S, shape=f"{sum(MOST_SPADE_SHAPES.values())} calls of a 1024^2 "
                                    "forward, up to (1, 64, 1152, 1152)"))
        for (c, h), calls in MOST_SPADE_SHAPES.items():
            x = torch.randn((1, c, h, h), generator=cgen, device="cuda").to(dtype)
            mean = torch.randn(c, generator=cgen, device="cuda")
            inv = torch.rand(c, generator=cgen, device="cuda").add_(0.5)
            gb = torch.randn((1, 2 * c, h, h), generator=cgen, device="cuda").to(dtype)
            args = (x, mean, inv, *gb.chunk(2, dim=1))
            if h == 1152:
                got, want = K.spade_modulate(*args), K.spade_modulate_plain(*args)
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), **tol)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                print(f"[phase 20] spade_modulate {dname} (1,{c},{h},{h}) vs its plain version: "
                      f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failed.append(("spade_modulate", dname, c, h))
                del got, want
            tk = median_ms(lambda: K.spade_modulate(*args), torch, True, inner=5)
            tp = median_ms(lambda: K.spade_modulate_plain(*args), torch, True, inner=5)
            row["ms"] += calls * tk
            row["plain_ms"] += calls * tp
            elem = x.element_size()
            # x, gamma, beta and the output, the two (C,) statistics
            row["work"][0] += calls * (4 * elem * x.numel() + 8 * c)
            row["work"][1] += calls * 4 * x.numel()
            if h == 1152:
                print(f"[phase 20] spade_modulate {dname} (1,{c},{h},{h}) x{calls}/forward: device "
                      f"kernel {tk * 1e3:.1f} us, plain {tp * 1e3:.1f} us, bound "
                      f"{4 * elem * x.numel() / HBM_BYTES_S * 1e6:.1f} us (bytes) {tag}",
                      flush=True)
            del x, gb, args
    # conv3x3_same_lowch at the batch-1 step's features_2, fp32 and bf16
    n, c, h, w_ = MOST_LOWCH
    for dname in TOLS:
        bf = dname == "bfloat16"
        x = torch.randn(MOST_LOWCH, generator=cgen, device="cuda").relu_()
        w = torch.randn((64, c, 3, 3), generator=cgen, device="cuda") * math.sqrt(2 / (9 * c))
        if bf:
            x, w = x.bfloat16(), w.bfloat16()
        got, want = LC.conv3x3_same_lowch(x, w), LC.conv3x3_same_lowch_plain(x, w)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **TOLS["bfloat16"]) if bf else \
            err <= NEW_KERNEL_REL * want.abs().max().item()
        print(f"[phase 20] conv3x3_same_lowch {dname} {MOST_LOWCH} vs its plain version: "
              f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(("conv3x3_same_lowch", dname))
        del got, want
        fk = lambda: LC.conv3x3_same_lowch(x, w)
        fl = lambda: F.conv2d(x, w, padding=1)
        turns = {fk: [], fl: []}
        for f in (fl, fk, fk, fl):
            turns[f].append(median_ms(f, torch, True, reps=3, inner=3))
        elem = x.element_size()
        rows[f"conv3x3_same_lowch{'_bf16' if bf else ''}"] = dict(
            max_abs_err=err, ms=statistics.mean(turns[fk]),
            plain_ms=median_ms(lambda: LC.conv3x3_same_lowch_plain(x, w), torch, True, reps=3,
                               inner=3),
            library_ms=statistics.mean(turns[fl]), rate=BF16_FLOP_S if bf else TF32X3_FLOP_S,
            work=[elem * (n * c * h * w_ + n * 64 * h * w_) + w.element_size() * 64 * c * 9,
                  2 * n * 64 * h * w_ * c * 9], shape=str(MOST_LOWCH))
        del x, w, fk, fl, turns
    # the bank forward (fp32; bf16 operands) and its backward at 1024^2 on a
    # strand plane, the backward on a hair-masked dconf, as the loss gives it
    img = strand_image(torch, 1024, SEED) * 2 - 1
    gray = filters.rgb_to_gray255(img[None]).permute(0, 3, 1, 2).contiguous()
    hair = ellipse_mask(torch, 1024)[None]
    bank = filters.bank("gabor", gray.device)
    pixels, bank_bytes = gray.numel(), bank.numel() * 4
    for bf in (False, True):
        got = O.filterbank_orientation(gray, bank, bf)
        want = O.filterbank_orientation_plain(gray, bank, bf)
        ok, err, frac = (fb16_compare(torch, got, want, gray, bank) if bf else
                         fb_compare(torch, got, want, gray, bank)[:3])
        name = f"filterbank_orientation{'_bf16' if bf else ''}"
        print(f"[phase 20] {name} (1,1,1024,1024) vs its plain version: conf max_abs_err "
              f"{err:.3e}, argmax differs on {frac:.2e} of pixels {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failed.append((name,))
        rows[name] = dict(
            max_abs_err=err, library_ms=None, rate=BF16_FLOP_S if bf else TF32X3_FLOP_S,
            ms=median_ms(lambda: O.filterbank_orientation(gray, bank, bf), torch, True, inner=5),
            plain_ms=median_ms(lambda: O.filterbank_orientation_plain(gray, bank, bf), torch,
                               True, inner=5),
            work=[12 * pixels + bank_bytes, 2 * pixels * 32 * 289], shape="(1,1,1024,1024)")
    idx, conf = O.filterbank_orientation(gray, bank)
    dconf = torch.randn(hair.shape, generator=cgen, device="cuda") * hair
    got = O.filterbank_orientation_backward(dconf, idx, conf, bank)
    want = O.filterbank_orientation_backward_plain(dconf, idx, conf, bank)
    err = (got - want).abs().max().item()
    ok = err <= NEW_KERNEL_REL * want.abs().max().item()
    print(f"[phase 20] filterbank_orientation_backward (1,1,1024,1024) hair-masked dconf vs its "
          f"plain version: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failed.append(("filterbank_orientation_backward",))
    carry = int(((dconf != 0) & (conf > 0)).sum())
    rows["filterbank_orientation_backward"] = dict(
        max_abs_err=err, library_ms=None, rate=FP32_FLOP_S,
        ms=median_ms(lambda: O.filterbank_orientation_backward(dconf, idx, conf, bank), torch,
                     True, inner=5),
        plain_ms=median_ms(lambda: O.filterbank_orientation_backward_plain(dconf, idx, conf,
                                                                           bank), torch, True,
                           inner=5),
        work=[16 * pixels + bank_bytes, 2 * 289 * carry], shape="(1,1,1024,1024)")
    del img, gray, hair, idx, conf, dconf, got, want
    torch.cuda.empty_cache()
    for k, r in rows.items():
        b_ms, b_by = bound(*r["work"], r["rate"])
        r["bound_ms"], r["bound_by"] = b_ms, b_by
        phase(20, f"{k} at 1024^2 ({r['shape']}): device kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound {b_ms:.3f} ms by {b_by}"
                  + (f", one library call {r['library_ms']:.3f} ms" if r["library_ms"] else "")
                  + f" {tag}")
    if failed:
        return f"phase 20: a kernel disagrees with its plain version at 1024^2: {failed}", rows
    return None, rows


def most_phase(torch, np, tag, step32):
    """Phase 20: the 1024^2 configuration at full width.  `step32`: phase
    11's {'ms', 'peak'}.  Returns (failure or None, {run: launches} of the
    counted runs)."""
    from michigan_tpu_torch.data.synthetic import synthetic_inference_data, synthetic_train_data
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.ops import cuda as kernels
    from michigan_tpu_torch.train import parse_options as train_options
    from michigan_tpu_torch.training.train_step import TrainStep
    from michigan_tpu_torch.utils.imaging import tensor2im

    t20 = time.perf_counter()
    launches = {}

    # inference at 1024 + 128, batch 1, fp32 and bf16: counted, timed
    for dtype, want in (("float32", MOST_LAUNCHES), ("bfloat16", MOST_BF16_LAUNCHES)):
        opt = parse_options(FLAGS + MOST_INFER + ["--seed", str(SEED), "--dtype", dtype])
        model = MichiGANModel(opt, "cuda:0")
        model.init_weights(SEED)
        batch = batch_from_numpy(synthetic_inference_data(opt, SEED), "cuda:0")
        kernels.reset_launch_counts()
        fake, _ = model.infer(batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts(by_dtype=dtype == "bfloat16")
        size = opt.generator_input_size()
        phase(20, f"1024^2 inference ({dtype}, --num_upsampling_layers most, --add_th "
                  f"{opt.add_th}, latent {opt.latent_size()}): fake {tuple(fake.shape)}, "
                  f"launches {counts}")
        if counts != want:
            return f"phase 20: expected launches per 1024^2 forward {want}, got {counts}", None
        if fake.shape != (1, 3, size, size) or not torch.isfinite(fake).all() \
                or fake.abs().max() > 1 or fake.std() < 1e-3:
            return f"phase 20: the 1024^2 {dtype} output is wrong", None
        launches[f"infer_{dtype}"] = counts
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda: model.infer(batch), torch, 5)
        phase(20, f"1024^2 inference {dtype}, batch 1: {ms:.2f} ms/image (median of 5, host "
                  f"clock), peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}")
        del model, batch, fake
        torch.cuda.empty_cache()

    # the same path card vs CPU at MOST_CHECK_CROP + 128, full width: phase
    # 5's limit in fp32, phase 13's in bf16
    outs = {}
    for dtype in ("float32", "bfloat16"):
        opt = parse_options(FLAGS + MOST_INFER + ["--crop_size", str(MOST_CHECK_CROP),
                                                  "--load_size", str(MOST_CHECK_CROP),
                                                  "--seed", str(SEED), "--dtype", dtype])
        model = MichiGANModel(opt, "cuda:0")
        model.init_weights(SEED)
        cpu = MichiGANModel(opt, "cpu")
        cpu.load_state_dicts({k: {n: t.cpu() for n, t in net.state_dict().items()}
                              for k, net in model.nets().items()})
        data = synthetic_inference_data(opt, SEED)
        card_out = model.infer(batch_from_numpy(data, "cuda:0"))[0].cpu()
        t0 = time.perf_counter()
        outs[dtype] = (card_out, cpu.infer(batch_from_numpy(data, "cpu"))[0],
                       time.perf_counter() - t0)
        del model, cpu
    r = opt.add_th // 2
    u8 = lambda t: tensor2im(t.permute(0, 2, 3, 1).numpy()[0, r:r + MOST_CHECK_CROP,
                                                           r:r + MOST_CHECK_CROP])
    (c32, p32, s32), (c16, p16, s16) = outs["float32"], outs["bfloat16"]
    diff32, diff16 = (c32 - p32).abs().max().item(), (c16 - p16).abs().max().item()
    cal = (p16 - p32).abs().max().item()
    psnr = psnr_u8(u8(c32), u8(p32), np)
    phase(20, f"{MOST_CHECK_CROP}^2 + {opt.add_th} `most` card vs CPU, ngf {opt.ngf}: fp32 "
              f"max_abs {diff32:.3e} (limit 2e-3), PSNR {psnr:.2f} dB (limit 50); bf16 max_abs "
              f"{diff16:.3e} (limit {BF16_CAL:g} x the CPU's own bf16 vs fp32 {cal:.3e}); CPU "
              f"forwards {s32:.1f} s, {s16:.1f} s")
    if not (diff32 <= 2e-3 and psnr > 50 and diff16 <= BF16_CAL * cal):
        return "phase 20: the `most` inference path's card and CPU outputs disagree", None
    del outs, c32, p32, c16, p16
    torch.cuda.empty_cache()

    def trainer(n, crop, extra):
        o = train_opts(train_options, n, crop, extra)
        m = MichiGANModel(o, "cuda:0")
        m.init_weights(SEED)
        return o, TrainStep(m)

    def counted(tr, batch, by_dtype):
        kernels.reset_launch_counts()
        g, _f, o = tr.g_step(batch, EXTRA_DILATE)
        d = tr.d_step(batch, EXTRA_DILATE, o)
        torch.cuda.synchronize()
        return {k: v.item() for k, v in {**g, **d}.items()}, kernels.launch_counts(by_dtype)

    def timed(tr, batch, steps):
        """(median ms, min ms, max ms, peak bytes) of `steps` G+D steps."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            _g, _f, o = tr.g_step(batch, EXTRA_DILATE)
            tr.d_step(batch, EXTRA_DILATE, o)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), min(times), max(times), torch.cuda.max_memory_allocated()

    # the 1024^2 step at batch 1, fp32 and bf16, without and with --remat:
    # counted, timed; then the largest batch of MOST_BATCHES that fits
    for dtype in ("float32", "bfloat16"):
        bf = dtype == "bfloat16"
        want = STEP_BF16_LAUNCHES if bf else STEP_LAUNCHES
        for remat in (False, True):
            label = f"{dtype}{', --remat up_1..up_4' if remat else ''}"
            o, tr = trainer(1, 1024, MOST_TRAIN + ["--dtype", dtype]
                            + (MOST_REMAT if remat else []))
            batch = batch_from_numpy(synthetic_train_data(o, SEED, 1), "cuda:0")
            losses, counts = counted(tr, batch, bf)
            phase(20, f"1024^2 step ({label}), batch 1, ngf {o.ngf}, ndf {o.ndf}: launches "
                      f"{counts}; losses " + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
            if counts != want or not all(math.isfinite(v) for v in losses.values()):
                return f"phase 20: the 1024^2 step ({label}) launched {counts} or lost finiteness", \
                    None
            launches[f"step_{dtype}{'_remat' if remat else ''}"] = counts
            ms, lo, hi, peak = timed(tr, batch, MOST_STEPS)
            fits = [1]
            for n in MOST_BATCHES[1:]:
                del batch
                for net in tr.model.nets().values():
                    net.zero_grad(set_to_none=True)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                try:
                    batch = batch_from_numpy(synthetic_train_data(o, SEED, n), "cuda:0")
                    t0 = time.perf_counter()
                    _g, _f, ori = tr.g_step(batch, EXTRA_DILATE)
                    tr.d_step(batch, EXTRA_DILATE, ori)
                    torch.cuda.synchronize()
                    fits.append(n)
                    print(f"[phase 20]   batch {n} fits: {(time.perf_counter() - t0) * 1e3:.1f} "
                          f"ms (one step), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                          f"GiB {tag}", flush=True)
                    del _g, _f, ori
                except torch.OutOfMemoryError as e:
                    print(f"[phase 20]   batch {n}: out of memory ({str(e).splitlines()[0][:120]})",
                          flush=True)
                    batch = None
                    break
            phase(20, f"1024^2 step ({label}), batch 1: {ms:.1f} ms/step (median of {MOST_STEPS} "
                      f"after the counted step; {lo:.1f} to {hi:.1f}), peak {peak / 2**30:.2f} "
                      f"GiB; largest batch of "
                      f"{MOST_BATCHES} that fits: {fits[-1]} {tag}")
            del tr, batch
            torch.cuda.empty_cache()

    # the flag matrix's all_losses_remat row: every loss, batch 8, 512^2,
    # --remat_blocks up_1,up_2,up_3, beside phase 11's step without --remat
    o, tr = trainer(TRAIN_BATCH, 512, ALL_LOSSES_REMAT)
    batch = batch_from_numpy(synthetic_train_data(o, SEED, TRAIN_BATCH), "cuda:0")
    losses, counts = counted(tr, batch, False)
    if counts != STEP_LAUNCHES or not all(math.isfinite(v) for v in losses.values()):
        return f"phase 20: the all_losses_remat step launched {counts}", None
    launches["step_all_losses_remat"] = counts
    ms, _lo, _hi, peak = timed(tr, batch, REMAT512_STEPS)
    del tr, batch
    torch.cuda.empty_cache()
    phase(20, f"all_losses_remat (--remat_blocks up_1,up_2,up_3), batch {TRAIN_BATCH}, 512^2, "
              f"losses {sorted(losses)}: {ms:.1f} ms/step, peak {peak / 2**30:.2f} GiB; without "
              f"--remat (phase 11) {step32['ms']:.1f} ms/step, {step32['peak'] / 2**30:.2f} GiB "
              f"{tag}")

    # card vs CPU at PARITY16's batch, crop and width, `most`: fp32 by phase
    # 12's rule (both inits), bf16 by phase 15's whole gate, each with a
    # half-batch control that must fail; the card's remat step against its
    # step without, under deterministic algorithms
    extra = ["--ngf", str(PARITY16["ngf"]), "--ndf", str(PARITY16["ndf"]), *MOST_TRAIN]
    for init in ("none", "xavier"):
        o, _init, r32 = most_step_runs(torch, extra + ["--init_type", init])
        ok, row = rule12(r32["card"], r32["cpu"], o)
        c_ok, c_row = rule12(r32["control"], r32["cpu"], o)
        phase(20, f"`most` fp32 G+D step card vs CPU at --init_type {init}, batch "
                  f"{PARITY16['batch']}, {PARITY16['crop']}^2, ngf {o.ngf}: {row}: "
                  f"{'passes' if ok else 'FAIL'}; half-batch control: {c_row}: "
                  f"{'passes, FAIL' if c_ok else 'fails, as it must'}")
        if not ok or c_ok:
            return f"phase 20: the `most` fp32 gate at --init_type {init} failed", None
    msg = most_bf16_gates(torch, extra)
    if msg:
        return msg, None
    # the card's remat step against its step without, from one initial
    # state, under deterministic algorithms, fp32 and bf16
    for dtype in ("float32", "bfloat16"):
        flags = extra + ["--dtype", dtype]
        o, init, plain = most_step_runs(torch, flags, det=True, card_only=True)
        _o, _i, remat = most_step_runs(torch, flags + MOST_REMAT, init_state=init, det=True,
                                       card_only=True)
        same = bit_identical(plain["card"], remat["card"])
        ok, row = (True, "bit for bit equal") if same else rule12(remat["card"], plain["card"], o)
        phase(20, f"`most` {dtype} card step with --remat (up_1..up_4, the VGG tower) against the "
                  f"card's step without, under deterministic algorithms: {row}"
                  + ("" if same else f": {'within' if ok else 'past'} phase 12's rule"))
        if not ok:
            return f"phase 20: the {dtype} remat step differs from the step without", None
    phase(20, f"the 1024^2 configuration in {time.perf_counter() - t20:.1f} s")
    return None, launches


def most_step_runs(torch, flags, seed=SEED, init_state=None, det=False, cpu32_flags=None,
                   card_only=False, drop=()):
    """{name: one G+D step from one initial state} at PARITY16's batch, on
    TRAIN_FLAGS less `drop` + `flags` with `seed`: the card's; unless `card_only` the
    CPU's and the card's on the first half of the batch (the control), and
    with `cpu32_flags` the CPU's at those flags (float32); the CPU's and the
    control's D steps from the card's post-G netG, as phase 12's.  Each
    {'losses', 'params': {netG after G, netD after D}, 'buffers': netG's
    after G}.  Returns (options, initial state, runs)."""
    from michigan_tpu_torch.data.synthetic import synthetic_train_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.train import parse_options as train_options
    from michigan_tpu_torch.training.train_step import TrainStep

    n, crop = PARITY16["batch"], PARITY16["crop"]
    params_of = lambda net: {k: v.detach().cpu().clone() for k, v in net.named_parameters()}
    buffers_of = lambda net: {k: v.detach().cpu().clone() for k, v in net.named_buffers()
                              if v.is_floating_point()}
    o = train_opts(train_options, n, crop, flags, seed, drop)
    card_model = MichiGANModel(o, "cuda:0")
    card_model.init_weights(seed)
    init = init_state or {k: {n_: t.detach().cpu().clone() for n_, t in net.state_dict().items()}
                          for k, net in card_model.nets().items()}
    card_model.load_state_dicts(init)
    data = synthetic_train_data(o, seed, n)
    todo = {"card": (o, "cuda:0", data)}
    if not card_only:
        todo.update(cpu=(o, "cpu", data),
                    control=(o, "cuda:0", {k: v[:n // 2] for k, v in data.items()}))
    if cpu32_flags is not None:
        todo["cpu32"] = (train_opts(train_options, n, crop, cpu32_flags, seed, drop), "cpu",
                         data)
    out, post_g = {}, None
    for name, (o_, dev, d_) in todo.items():
        if name == "card":
            m = card_model
        else:
            m = MichiGANModel(o_, dev)
            m.load_state_dicts(init)
        tr = TrainStep(m)
        b = batch_from_numpy(d_, dev)
        with deterministic_algorithms(torch, det and dev != "cpu"):
            g, _f, ori = tr.g_step(b, EXTRA_DILATE)
            res = {"losses": {k: v.item() for k, v in g.items()},
                   "params": {"netG": params_of(tr.model.netG)},
                   "buffers": buffers_of(tr.model.netG)}
            if name == "card":
                post_g = {k: v.cpu() for k, v in tr.model.netG.state_dict().items()}
            else:
                tr.model.netG.load_state_dict(post_g)
            d = tr.d_step(b, EXTRA_DILATE, ori, None, _f)  # _f: --reuse_fake_for_d
        res["losses"].update({k: v.item() for k, v in d.items()})
        res["params"]["netD"] = params_of(tr.model.netD)
        out[name] = res
        del m, tr, b, g, d, ori, _f
    del card_model
    torch.cuda.empty_cache()
    return o, init, out


def rule12(got, want, o):
    """Phase 12's rule over two of most_step_runs' runs: (ok, printable)."""
    import torch

    bad = [k for k, v in want["losses"].items()
           if not abs(got["losses"][k] - v) <= 1e-5 + 1e-4 * abs(v)]
    g_ok, g_worst, g_bad, g_tot = scale_aware(got["params"]["netG"], want["params"]["netG"],
                                              o.lr / 2)
    d_ok, d_worst, d_bad, _ = scale_aware(got["params"]["netD"], want["params"]["netD"],
                                          2 * o.lr)
    b_ok = all(torch.allclose(got["buffers"][k], v, rtol=1e-4, atol=1e-5)
               for k, v in want["buffers"].items())
    ok = not bad and g_ok and d_ok and b_ok
    return ok, (f"losses beyond rtol 1e-4 {bad}; netG {g_bad} of {g_tot} beyond float noise, "
                f"max diff {g_worst:.2e}; netD {d_bad} beyond, max diff {d_worst:.2e}; "
                f"buffers {'within' if b_ok else 'past'} rtol 1e-4")


def most_bf16_gate(torch, flags, seed):
    """Phase 15's gate on one `most` bf16 G+D step card vs CPU at
    PARITY16's batch and crop and `seed`, and on its half-batch control.
    Returns ({'whole': ok, 'nets': ok}, the same of the control,
    printable): the whole gate (every loss, netG and netD) and its verdict
    on netG and netD alone."""
    t0 = time.perf_counter()
    o, _init, r = most_step_runs(torch, flags + ["--dtype", "bfloat16"], seed, cpu32_flags=flags)
    lrs = {"netG": o.lr / 2, "netD": 2 * o.lr}
    nets = lambda k: {"losses": {}, "params": r[k]["params"]}

    def verdicts(who):
        whole, rows = step_gate(r[who], r["cpu"], r["cpu32"], lrs)
        return {"whole": whole, "nets": step_gate(nets(who), nets("cpu"), nets("cpu32"), lrs)[0]}, \
            rows

    ok, rows = verdicts("card")
    c_ok, c_rows = verdicts("control")
    word = lambda v: "passes" if v else "fails"
    return ok, c_ok, (f"seed {seed}, batch {PARITY16['batch']}, {PARITY16['crop']}^2, per loss "
                      f"card-vs-CPU bf16 / CPU bf16 vs fp32: " + ", ".join(rows)
                      + f": the whole gate {word(ok['whole'])}, on netG and netD "
                      f"{word(ok['nets'])}; half-batch control: " + ", ".join(c_rows)
                      + f": the whole gate {word(c_ok['whole'])}, on netG and netD "
                      f"{word(c_ok['nets'])} ({time.perf_counter() - t0:.1f} s)")


def most_bf16_gates(torch, flags):
    """Phase 20's bf16 gates at PARITY16's batch, crop and width, `most`
    (TRAIN_FLAGS + `flags`), with --no_confidence_loss: the Gabor
    confidence term's clamp at 0 decides which pixels its gradient reaches,
    and at this size it alone moves the card's bf16 netG past the CPU's own
    bf16 vs fp32 count (PERF.md section 7).  Phase 15's whole gate on
    SEED's step; on each of MOST_GATE_SEEDS the gate on netG and netD, the
    per-loss rows printed; each control fails what it is held to.  Then
    SEED's step with the confidence term, printed, not gated.  Returns the
    failure or None."""
    for seed in MOST_GATE_SEEDS:
        ok, c_ok, row = most_bf16_gate(torch, flags + ["--no_confidence_loss"], seed)
        held = "whole" if seed == SEED else "nets"
        phase(20, f"`most` bf16 G+D step (--no_confidence_loss) card vs CPU, held to phase 15's "
                  f"{'whole gate' if held == 'whole' else 'gate on netG and netD'}: {row}")
        if not ok[held]:
            return f"phase 20: the `most` bf16 step at seed {seed} fails phase 15's gate"
        if c_ok[held]:
            return f"phase 20: the `most` bf16 gate at seed {seed} passes its half-batch control"
    _ok, _c_ok, row = most_bf16_gate(torch, flags, SEED)
    phase(20, f"`most` bf16 G+D step with the confidence term card vs CPU, printed: {row}")
    return None


def most_rows(k20, launches):
    """The kernels line's rows of the 1024^2 configuration (phase 20): each
    kernel at its 1024^2 shapes, its launches from phase 20's counted runs
    (the forward's for spade_modulate, the batch-1 step's for the rest)."""
    counts = {"spade_modulate": launches["infer_float32"]["spade_modulate"],
              "spade_modulate_bf16": launches["infer_bfloat16"]["spade_modulate"]["bfloat16"]}
    for k in ("conv3x3_same_lowch", "filterbank_orientation", "filterbank_orientation_backward"):
        counts[k] = launches["step_float32"][k]
    for k in ("conv3x3_same_lowch", "filterbank_orientation"):
        counts[f"{k}_bf16"] = launches["step_bfloat16"][k]["bfloat16"]
    rows = []
    for name, r in k20.items():
        base = name[:-5] if name.endswith("_bf16") else name
        bf16_step_form = name.endswith("_bf16") and base in STEP_BF16_ROWS
        rows.append({
            "name": f"{name}_1024", "route": "cuda", "source": SOURCES[base],
            "replaces": STEP_BF16_ROWS[base] if bf16_step_form else REPLACES[base],
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "path": "1024^2 inference forward" if base == "spade_modulate" else
                    "1024^2 training step, batch 1"})
    return rows


def variants_phase(torch, np, tag, refs):
    """Phase 21: the port's last model options at full width, the CPU
    forwards from `refs` (CpuRefs).  Returns (failure or None, {run:
    launches} of the counted runs)."""
    from michigan_tpu_torch.data.synthetic import synthetic_inference_data, synthetic_train_data
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.ops import cuda as kernels
    from michigan_tpu_torch.ops.cuda import spade as K
    from michigan_tpu_torch.train import parse_options as train_options
    from michigan_tpu_torch.training.train_step import TrainStep
    from michigan_tpu_torch.utils.imaging import tensor2im

    t21 = time.perf_counter()
    launches = {}

    # (i) inference on FLAGS with each option, batch 1: counted, timed, and
    # card vs CPU by phase 5's limits
    for name, (add, drop) in VARIANT_INFER.items():
        opt = parse_options([f for f in FLAGS if f not in drop] + add + ["--seed", str(SEED)])
        model = MichiGANModel(opt, "cuda:0")
        model.init_weights(SEED)
        data = synthetic_inference_data(opt, SEED)
        batch = batch_from_numpy(data, "cuda:0")
        kernels.reset_launch_counts()
        fake, _ = model.infer(batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        launches[f"infer_{name}"] = counts
        size = opt.generator_input_size()
        if counts != FLAGSHIP_LAUNCHES:
            return f"phase 21 {name}: expected launches {FLAGSHIP_LAUNCHES}, got {counts}", None
        if fake.shape != (1, 3, size, size) or not torch.isfinite(fake).all() \
                or fake.abs().max() > 1 or fake.std() < 1e-3:
            return f"phase 21 {name}: the output is wrong", None
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda: model.infer(batch), torch, VARIANT_INFER_REPS)
        peak = torch.cuda.max_memory_allocated()
        ref = refs.get(f"variant_{name}")  # SEED's weights on the CPU, beside the card's work
        fake_cpu, cpu_s = ref["fake"], ref["s"]
        r = opt.add_th // 2
        u8 = lambda t: tensor2im(t.permute(0, 2, 3, 1).cpu().numpy()[
            0, r:r + opt.crop_size, r:r + opt.crop_size])
        diff = (fake.cpu() - fake_cpu).abs().max().item()
        psnr = psnr_u8(u8(fake), u8(fake_cpu), np)
        phase(21, f"{name}: launches {counts}; card vs CPU max_abs {diff:.3e} (limit 2e-3), "
                  f"PSNR {psnr:.2f} dB (limit 50); batch 1, 512^2, ngf {opt.ngf}: {ms:.2f} "
                  f"ms/image (median of {VARIANT_INFER_REPS}, host clock), peak device memory "
                  f"{peak / 2**30:.2f} GiB ({live / 2**30:.2f} GiB live before) {tag}; CPU "
                  f"forward {cpu_s:.1f} s (beside the card's work, niced)")
        if not diff <= 2e-3 or not psnr > 50:
            return f"phase 21 {name}: card and CPU outputs disagree", None
        del model, batch, fake, fake_cpu
        torch.cuda.empty_cache()

    # the --weight_norm_G form of spade_modulate (mean 0, invstd 1) against
    # the plain x * (1 + gamma) + beta
    gen = torch.Generator(device="cuda:0").manual_seed(SEED)
    for c, h in WN_SHAPES:
        x, gamma, beta = (torch.randn((1, c, h, h), device="cuda:0", generator=gen)
                          for _ in range(3))
        got = K.spade_modulate(x, torch.zeros(c, device="cuda:0"),
                               torch.ones(c, device="cuda:0"), gamma, beta)
        want = x * (1 + gamma) + beta
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **TOLS["float32"])
        phase(21, f"spade_modulate (1, {c}, {h}, {h}) with mean 0, invstd 1 against x * (1 + "
                  f"gamma) + beta: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            return "phase 21: spade_modulate under --weight_norm_G disagrees", None

    # (ii) training: each combined config card vs CPU at PARITY16's size by
    # phase 12's rule with a half-batch control that must fail, then at
    # TRAIN_BATCH, 512^2, full width: counted, timed
    for cfg, (flags, drop) in VARIANT_TRAIN.items():
        extra = ["--ngf", str(PARITY16["ngf"]), "--ndf", str(PARITY16["ndf"]), *flags]
        o, _init, runs = most_step_runs(torch, extra, drop=drop)
        ok, row = rule12(runs["card"], runs["cpu"], o)
        c_ok, c_row = rule12(runs["control"], runs["cpu"], o)
        phase(21, f"config {cfg} ({' '.join(flags)}{' less ' + ' '.join(drop) if drop else ''}) "
                  f"G+D step card vs CPU, batch {PARITY16['batch']}, {PARITY16['crop']}^2, ngf "
                  f"{o.ngf}: {row}: {'passes' if ok else 'FAIL'}; half-batch control: {c_row}: "
                  f"{'passes, FAIL' if c_ok else 'fails, as it must'}")
        if not ok or c_ok:
            return f"phase 21: config {cfg}'s card-vs-CPU gate failed", None
        del runs
        o = train_opts(train_options, TRAIN_BATCH, 512, flags, drop=drop)
        model = MichiGANModel(o, "cuda:0")
        model.init_weights(SEED)
        tr = TrainStep(model)
        batch = batch_from_numpy(synthetic_train_data(o, SEED, TRAIN_BATCH), "cuda:0")
        kernels.reset_launch_counts()
        g, fake, ori = tr.g_step(batch, EXTRA_DILATE)
        d = tr.d_step(batch, EXTRA_DILATE, ori, None, fake)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        launches[f"step_{cfg}"] = counts
        losses = {k: v.item() for k, v in {**g, **d}.items()}
        if counts != STEP_LAUNCHES:
            return f"phase 21 config {cfg}: expected launches {STEP_LAUNCHES}, got {counts}", None
        if not all(math.isfinite(v) for v in losses.values()):
            return f"phase 21 config {cfg}: a loss is not finite: {losses}", None
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(VARIANT_STEPS):  # after the counted step, the warm-up
            t0 = time.perf_counter()
            _g, fake_, ori_ = tr.g_step(batch, EXTRA_DILATE)
            tr.d_step(batch, EXTRA_DILATE, ori_, None, fake_)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        phase(21, f"config {cfg}, batch {TRAIN_BATCH}, 512^2, ngf {o.ngf}, ndf {o.ndf}: "
                  f"launches {counts}; losses " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                            losses.items())
                  + f"; {', '.join(f'{t:.1f}' for t in times)} ms, median {ms:.1f} ms/step "
                  f"(host clock, after the counted step), {TRAIN_BATCH / ms * 1e3:.2f} img/s, "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"({live / 2**30:.2f} GiB live before) {tag}")
        del model, tr, batch, g, d, fake, ori
        torch.cuda.empty_cache()
    phase(21, f"the last model options in {time.perf_counter() - t21:.1f} s")
    return None, launches


def train_opts(train_options, n, crop, extra=(), seed=SEED, drop=()):
    """TRAIN_FLAGS less `drop` at batch `n` (the global batch), `crop`,
    --seed `seed`."""
    return train_options([f for f in TRAIN_FLAGS if f not in drop] + [
        "--batchSize", str(n), "--crop_size", str(crop), "--load_size", str(crop),
        "--seed", str(seed), *extra])


def dp_step(opt, device, group, world, rank=0, post_g=None, save_post_g=None, init=None,
            local_norms=False, timed=0):
    """Phase 18's one G+D step from SEED's weights (or the state_dicts
    `init`) on synthetic_train_data's global batch of --batchSize: with a
    group, this rank's slice through TrainStep; without, the whole batch
    on the `world`-replica objective (tools/replica_objective.py).  The D
    step starts from the netG in the file `post_g` when given (phase 12's
    D step from one post-G state); `save_post_g` writes netG after the G
    step there.  `local_norms` drops the norms' group; `timed` plain
    TrainStep steps follow, host clock.  Returns {'losses', 'params':
    {netG after G, netD after D}, 'buffers': netG's after G, 'counts': by
    dtype over the compared step, 'ms': [...], 'peak': bytes, and with a
    group and `timed`, 'allreduce_ms': {net: the gradient mean alone}}."""
    import torch

    from michigan_tpu_torch.data.synthetic import synthetic_train_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.models.normalization import ParamFreeNorm
    from michigan_tpu_torch.ops import cuda as kernels
    from michigan_tpu_torch.parallel.dist import average_gradients
    from michigan_tpu_torch.tools import replica_objective
    from michigan_tpu_torch.training.state import check_replicas
    from michigan_tpu_torch.training.train_step import TrainStep

    model = MichiGANModel(opt, device, group)
    if init is None:
        model.init_weights(SEED)
    else:
        model.load_state_dicts(init)
    check_replicas(model)  # the replicas start equal (rank 0's broadcast)
    if local_norms:
        for m in model.netG.modules():
            if isinstance(m, ParamFreeNorm):
                m.group = None
    tr = TrainStep(model)
    data = synthetic_train_data(opt, SEED, opt.batchSize)
    k = opt.batchSize // world if group is not None else opt.batchSize
    batch = batch_from_numpy({key: v[rank * k:(rank + 1) * k] for key, v in data.items()}, device)
    cpu = lambda items: {name: t.detach().cpu().clone() for name, t in items}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    if group is None:
        g, orient = replica_objective.g_step(tr, batch, EXTRA_DILATE, world)
    else:
        g, _fake, orient = tr.g_step(batch, EXTRA_DILATE)
    res = {"params": {"netG": cpu(model.netG.named_parameters())},
           "buffers": cpu(model.netG.named_buffers())}
    if save_post_g:
        torch.save(model.netG.state_dict(), save_post_g)
    if post_g:
        model.netG.load_state_dict(torch.load(post_g, map_location=device))
    d = tr.d_step(batch, EXTRA_DILATE, orient)
    torch.cuda.synchronize(device)
    res["counts"] = kernels.launch_counts(by_dtype=True)
    res["losses"] = {name: v.item() for name, v in {**g, **d}.items()}
    res["params"]["netD"] = cpu(model.netD.named_parameters())
    res["ms"] = []
    for _ in range(timed):
        t0 = time.perf_counter()
        _g, _f, o = tr.g_step(batch, EXTRA_DILATE)
        tr.d_step(batch, EXTRA_DILATE, o)
        torch.cuda.synchronize(device)
        res["ms"].append((time.perf_counter() - t0) * 1e3)
    res["peak"] = torch.cuda.max_memory_allocated(device)
    if group is not None and timed:
        # the gradient means alone, on the last step's gradients (their mean
        # again leaves them as they are): host clock, median of 3
        res["allreduce_ms"] = {}
        for name in ("netG", "netD"):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                average_gradients(getattr(model, name).parameters(), group)
                torch.cuda.synchronize(device)
                times.append((time.perf_counter() - t0) * 1e3)
            res["allreduce_ms"][name] = statistics.median(times)
    del model, tr, batch, orient, g, d
    torch.cuda.empty_cache()
    return res


def dp_rank(tmp, backend):
    """Phase 18's rank (spawned by parallel.dist.launch): a `backend` group
    of the launched ranks, on cuda:0 for gloo (both ranks on the one card)
    or cuda:<rank> for NCCL; the fp32 step at full width (then DP_STEPS
    timed steps), its local-statistics control, and the bf16 step at DP16;
    writes <tmp>/rank<r>.pt."""
    import datetime

    import torch

    from michigan_tpu_torch.parallel import dist as DP
    from michigan_tpu_torch.train import parse_options as train_options

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda:0" if backend == "gloo" else f"cuda:{rank}")
    torch.cuda.set_device(device)
    group = DP.init_group(backend, rank, world, os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), device,
                          datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
    try:
        o32 = train_opts(train_options, TRAIN_BATCH, 512)
        o16 = train_opts(train_options, DP16["batch"], DP16["crop"], dp16_flags(True))
        out = {"fp32": dp_step(o32, device, group, world, rank, f"{tmp}/post_g32.pt",
                               timed=DP_STEPS),
               "control": dp_step(o32, device, group, world, rank, f"{tmp}/post_g32.pt",
                                  local_norms=True),
               "bf16": dp_step(o16, device, group, world, rank, f"{tmp}/post_g16.pt")}
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def dp16_flags(bf16):
    return ["--ngf", str(DP16["ngf"]), "--ndf", str(DP16["ndf"])] + \
        (["--dtype", "bfloat16"] if bf16 else [])


def nccl_world1(tmp):
    """Phase 18's NCCL check (spawned, one rank): an NCCL group of one on
    cuda:0; batch_norm_train with the group (float32 and bfloat16) against
    it without, forward and dx; the trainer's gradient mean (float32 and
    --bf16_grad_allreduce) and loss mean; the replicas' start-up check.
    Writes <tmp>/nccl.pt."""
    import datetime

    import torch

    from michigan_tpu_torch.ops.norms import batch_norm_train
    from michigan_tpu_torch.parallel import dist as DP

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    group = DP.init_group(DP.backend_for(device), 0, 1, os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), device,
                          datetime.timedelta(seconds=DP_GROUP_TIMEOUT_S))
    try:
        gen = torch.Generator().manual_seed(SEED)
        x = (torch.randn(8, 64, 32, 32, generator=gen) * 2 + 0.5).to(device)
        w = torch.randn(8, 64, 32, 32, generator=gen).to(device)
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            runs = []
            for grp in (group, None):
                xx = x.to(dtype).detach().clone().requires_grad_()
                y, m, v = batch_norm_train(xx, torch.zeros(64, device=device),
                                           torch.ones(64, device=device), group=grp)
                y.backward(w.to(dtype))
                runs.append([t.detach().float() for t in (y, xx.grad, m, v)])
            res[str(dtype).removeprefix("torch.")] = max(
                (a - b).abs().max().item() for a, b in zip(*runs))
        p = torch.nn.Parameter(torch.randn(1000, generator=gen).to(device))
        p.grad = torch.randn(1000, generator=gen).to(device)
        want = p.grad.clone()
        DP.average_gradients([p], group)
        res["grad_mean_fp32_exact"] = torch.equal(p.grad, want)
        DP.average_gradients([p], group, bf16=True)
        res["grad_mean_bf16_exact"] = torch.equal(p.grad, want.bfloat16().float())
        losses = DP.mean_over({"a": want[0], "b": want[1]}, group)
        res["loss_mean_exact"] = losses["a"].item() == want[0].item()
        DP.check_replicas_identical([x, w], group)
        torch.save(res, f"{tmp}/nccl.pt")
    finally:
        torch.distributed.destroy_process_group()


def dp_rule(got, want, lr):
    """Phase 12's rule for phase 18 (the replicas against one process):
    (ok, printable rows)."""
    import torch

    rows, ok = [], True
    bad = [k for k, v in want["losses"].items()
           if abs(got["losses"][k] - v) > 1e-5 + 1e-4 * abs(v)]
    ok &= not bad
    rows.append(f"losses beyond rtol 1e-4 {bad or 'none'}")
    for net, max_lr in (("netG", lr / 2), ("netD", 2 * lr)):
        good, worst, n_bad, n_tot = scale_aware(got["params"][net], want["params"][net], max_lr)
        ok &= good
        rows.append(f"{net} max diff {worst:.2e} (limit {2.5 * max_lr:.1e}), {n_bad} of {n_tot} "
                    f"beyond float noise{'' if good else ' FAIL'}")
    bufs = [k for k, v in want["buffers"].items() if v.is_floating_point()]
    buf_err = max((got["buffers"][k] - want["buffers"][k]).abs().max().item() for k in bufs)
    bufs_ok = all(torch.allclose(got["buffers"][k], want["buffers"][k], rtol=1e-4, atol=1e-5)
                  for k in bufs)
    ok &= bufs_ok
    rows.append(f"netG running statistics and u / v max diff {buf_err:.2e}"
                f"{'' if bufs_ok else ' FAIL'}")
    return ok, rows


def bit_identical(a, b):
    """Whether two ranks' results of dp_step hold the same losses,
    parameters and buffers, bit for bit."""
    import torch

    same = lambda x, y: x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    return (a["losses"] == b["losses"] and same(a["buffers"], b["buffers"])
            and all(same(a["params"][n], b["params"][n]) for n in a["params"]))


def dp_phase(torch, tag):
    """Phase 18: data-parallel training on the card; returns the failure
    message or None."""
    import shutil
    import tempfile

    from michigan_tpu_torch.parallel import dist as DP
    from michigan_tpu_torch.train import parse_options as train_options

    t18 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase18_")
    try:
        torch.cuda.empty_cache()
        dev = torch.device("cuda:0")
        # one process at the global batch on the replicas' objective
        o32 = train_opts(train_options, TRAIN_BATCH, 512)
        ref32 = dp_step(o32, dev, None, DP_WORLD, save_post_g=f"{tmp}/post_g32.pt",
                        timed=DP_STEPS)
        o16 = train_opts(train_options, DP16["batch"], DP16["crop"], dp16_flags(True))
        ref16 = dp_step(o16, dev, None, DP_WORLD, save_post_g=f"{tmp}/post_g16.pt")
        # the policy's own effect: the fp32 step from the bf16 model's state
        # (its frozen nets rounded to bf16), its D step from the bf16 post-G netG
        from michigan_tpu_torch.model import MichiGANModel

        m16 = MichiGANModel(o16, "cpu")
        m16.init_weights(SEED)
        init16 = {k: net.state_dict() for k, net in m16.nets().items()}
        del m16
        ref16_32 = dp_step(train_opts(train_options, DP16["batch"], DP16["crop"],
                                      dp16_flags(False)), dev, None, DP_WORLD,
                           post_g=f"{tmp}/post_g16.pt", init=init16)
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t18
        t0 = time.perf_counter()
        two_cards = torch.cuda.device_count() >= 2
        DP.launch(dp_rank, (tmp, "gloo"), DP_WORLD, timeout=DP_JOIN_S)
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(DP_WORLD)]
        t_ranks = time.perf_counter() - t0
        t0 = time.perf_counter()
        DP.launch(nccl_world1, (tmp,), 1, timeout=DP_JOIN_S)
        nccl = torch.load(f"{tmp}/nccl.pt")
        if two_cards:
            DP.launch(dp_rank, (tmp, "nccl"), DP_WORLD, timeout=DP_JOIN_S)
            nccl_ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(DP_WORLD)]
        t_nccl = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lr = o32.lr
    fails = []
    for r, res in enumerate(ranks):
        counts = {k: sum(v.values()) for k, v in res["fp32"]["counts"].items()}
        phase(18, f"rank {r} of {DP_WORLD} (gloo, both on cuda:0), fp32 step at global batch "
                  f"{TRAIN_BATCH} ({TRAIN_BATCH // DP_WORLD} a rank), 512^2, ngf {o32.ngf}: "
                  f"launches {counts}; bf16 step at {DP16['crop']}^2, ngf {DP16['ngf']}: "
                  f"launches {res['bf16']['counts']}")
        if counts != STEP_LAUNCHES or res["bf16"]["counts"] != STEP_BF16_LAUNCHES:
            fails.append(f"rank {r}'s launches")
    ok, rows = dp_rule(ranks[0]["fp32"], ref32, lr)
    phase(18, "fp32, the 2 ranks against one process at batch "
              f"{TRAIN_BATCH} (the D steps from its post-G netG): " + "; ".join(rows))
    phase(18, "fp32 losses, ranks / one process: " + ", ".join(
        f"{k} {ranks[0]['fp32']['losses'][k]:.6f}/{v:.6f}" for k, v in ref32["losses"].items()))
    if not ok:
        fails.append("the fp32 2-rank step against one process")
    same = [bit_identical(ranks[0][k], ranks[1][k]) for k in ("fp32", "bf16")]
    phase(18, f"the two ranks bit for bit equal after the step (losses, netG parameters and "
              f"running statistics and u / v, netD): fp32 {same[0]}, bf16 {same[1]}")
    if not all(same):
        fails.append("the ranks' states differ")
    ok16, rows16 = step_gate(ranks[0]["bf16"], ref16, ref16_32,
                             {"netG": o16.lr / 2, "netD": 2 * o16.lr})
    phase(18, f"bf16, the 2 ranks against one process at batch {DP16['batch']}, per loss "
              f"ranks-vs-one / one-process bf16 vs fp32: " + ", ".join(rows16))
    if not ok16:
        fails.append("the bf16 2-rank step against one process")
    control_ok, control_rows = dp_rule(ranks[0]["control"], ref32, lr)
    phase(18, "control, the 2 ranks with the norms' group removed (each its own batch "
              "statistics): " + "; ".join(control_rows)
              + (": passes, FAIL" if control_ok else ": fails the rule, as it must"))
    if control_ok:
        fails.append("phase 18's rule passes a step with local batch statistics")
    rank_ms = ", ".join(f"{statistics.median(r['fp32']['ms']):.1f}" for r in ranks)
    rank_peak = ", ".join(f"{r['fp32']['peak'] / 2**30:.2f}" for r in ranks)
    rank_ar = ", ".join(f"{r['fp32']['allreduce_ms']['netG']:.1f} / "
                        f"{r['fp32']['allreduce_ms']['netD']:.1f}" for r in ranks)
    phase(18, f"fp32 step, batch {TRAIN_BATCH}, 512^2: one process "
              f"{statistics.median(ref32['ms']):.1f} ms/step (median of {DP_STEPS} after the "
              f"compared step), peak {ref32['peak'] / 2**30:.2f} GiB; 2 ranks on one card "
              f"{rank_ms} ms/step, peak {rank_peak} GiB a rank; the gradient mean alone, netG "
              f"/ netD, {rank_ar} ms a rank (median of 3) {tag}")
    nccl_ok = (nccl["float32"] <= 1e-4 and nccl["bfloat16"] <= 2e-2 and
               nccl["grad_mean_fp32_exact"] and nccl["grad_mean_bf16_exact"]
               and nccl["loss_mean_exact"])
    phase(18, f"NCCL group of one on cuda:0: batch_norm_train with / without it max diff fp32 "
              f"{nccl['float32']:.2e}, bf16 {nccl['bfloat16']:.2e}; gradient mean fp32 exact "
              f"{nccl['grad_mean_fp32_exact']}, bf16 rounding exact "
              f"{nccl['grad_mean_bf16_exact']}; loss mean exact {nccl['loss_mean_exact']}")
    if not nccl_ok:
        fails.append("the NCCL group of one")
    if two_cards:
        ok2, rows2 = dp_rule(nccl_ranks[0]["fp32"], ref32, lr)
        phase(18, "fp32 over NCCL on two cards: " + "; ".join(rows2))
        if not (ok2 and bit_identical(nccl_ranks[0]["fp32"], nccl_ranks[1]["fp32"])):
            fails.append("the 2-rank step over NCCL on two cards")
    else:
        phase(18, f"{torch.cuda.device_count()} card: the two ranks ran on one card over gloo; "
                  "no step ran over NCCL on two cards")
    phase(18, f"data parallelism in {time.perf_counter() - t18:.1f} s (references "
              f"{t_ref:.1f} s, ranks {t_ranks:.1f} s, NCCL {t_nccl:.1f} s)")
    return f"phase 18: {', '.join(fails)}" if fails else None


def zero_neighbour_rows(bands, x, lo, hi):
    """Phase 23's control (Bands.neighbour_rows replaced): zeros in place of
    the neighbours' halo rows."""
    z = lambda n: x.new_zeros((x.shape[0], x.shape[1], n, x.shape[3]))
    return (z(lo) if lo and bands.r > 0 else None), \
        (z(hi) if hi and bands.r < bands.P - 1 else None)


def space_forwards(torch, model, infer, batch, reps):
    """The compared forward (the counts set to 0 just before it and read
    just after, by dtype; peak memory from a reset) then `reps` timed ones:
    (fake, counts, peak bytes, median ms, host clock)."""
    from michigan_tpu_torch.ops import cuda as kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    fake = infer(batch)[0]
    torch.cuda.synchronize()
    counts = kernels.launch_counts(by_dtype=True)
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        infer(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return fake, counts, peak, statistics.median(times)


def transport_clock(torch, bands_cls, infer, batch):
    """One more forward with Bands' three transport methods clocked (host
    clock, a synchronize before and after each, so that the card's queued
    work is not counted in them): {'calls', 'ms' in them, 'forward_ms'}."""
    acc = {"calls": 0, "ms": 0.0}
    saved = {n: getattr(bands_cls, n) for n in ("neighbour_rows", "all_reduce", "gather_rows")}

    def clocked(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc["ms"] += (time.perf_counter() - t0) * 1e3
            acc["calls"] += 1
            return out
        return run

    for n, fn in saved.items():
        setattr(bands_cls, n, clocked(fn))
    try:
        t0 = time.perf_counter()
        infer(batch)
        torch.cuda.synchronize()
        acc["forward_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in saved.items():
            setattr(bands_cls, n, fn)
    return acc


def space_rank(tmp, backend):
    """Phase 23's rank (spawned by parallel.dist.launch): a `backend` group
    of the launched ranks, on cuda:0 for gloo (all on the one card) or
    cuda:<rank> for NCCL; make_spatial_infer of the 1024^2 `most` flagship
    at SEED's weights on synthetic_inference_data's host batch: fp32
    (space_forwards), the fp32 control with zeros in place of the
    neighbours' rows, then bf16 from the same weights; writes
    <tmp>/<backend><r>.pt (the gathered outputs on rank 0)."""
    import datetime

    import torch

    from michigan_tpu_torch.data.synthetic import synthetic_inference_data
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.parallel import dist as DP
    from michigan_tpu_torch.parallel import spatial

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda:0" if backend == "gloo" else f"cuda:{rank}")
    torch.cuda.set_device(device)
    group = DP.init_group(backend, rank, world, os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), device,
                          datetime.timedelta(seconds=SPACE_GROUP_TIMEOUT_S))
    space = spatial.Space(group, rank, world, device)
    cpu = lambda t: None if t is None else t.cpu()
    try:
        res = {"held": torch.cuda.memory_allocated(device)}
        opt = parse_options(FLAGS + MOST_INFER + ["--seed", str(SEED)])
        batch = batch_from_numpy(synthetic_inference_data(opt, SEED), "cpu")
        model = MichiGANModel(opt, device)
        model.init_weights(SEED)
        infer = spatial.make_spatial_infer(model, space)
        fake, counts, peak, ms = space_forwards(torch, model, infer, batch, SPACE_REPS)
        res["float32"] = {"fake": cpu(fake), "counts": counts, "peak": peak, "ms": ms,
                          "transport": transport_clock(torch, spatial.Bands, infer, batch)}
        normal = spatial.Bands.neighbour_rows
        spatial.Bands.neighbour_rows = zero_neighbour_rows
        res["control"] = cpu(spatial.make_spatial_infer(model, space)(batch)[0])
        spatial.Bands.neighbour_rows = normal
        states = {k: {n: t.cpu() for n, t in net.state_dict().items()}
                  for k, net in model.nets().items()}
        del model
        torch.cuda.empty_cache()
        model = MichiGANModel(parse_options(FLAGS + MOST_INFER + ["--seed", str(SEED), "--dtype",
                                                                  "bfloat16"]), device)
        model.load_state_dicts(states)
        infer = spatial.make_spatial_infer(model, space)
        fake, counts, peak, ms = space_forwards(torch, model, infer, batch, SPACE_REPS)
        res["bfloat16"] = {"fake": cpu(fake), "counts": counts, "peak": peak, "ms": ms,
                           "transport": transport_clock(torch, spatial.Bands, infer, batch)}
        torch.save(res, f"{tmp}/{backend}{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spatial_phase(torch, np, tag):
    """Phase 23: spatial sharding of inference on the card.  Returns
    (failure or None, {'counts': [a rank's launches by dtype, ...], 'band':
    {dtype: spade_modulate at up_4's band}})."""
    import shutil
    import tempfile

    from michigan_tpu_torch.data.synthetic import synthetic_inference_data
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.ops.cuda import spade as K
    from michigan_tpu_torch.parallel import dist as DP
    from michigan_tpu_torch.parallel import spatial
    from michigan_tpu_torch.utils.imaging import tensor2im

    t23 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # as phase 1 and the ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = parse_options(FLAGS + MOST_INFER + ["--seed", str(SEED)])
    frame, crop, r0 = opt.generator_input_size(), opt.crop_size, opt.add_th // 2
    phase(23, f"{SPACE_WORLD} ranks (gloo, all on cuda:0), `most` at {crop} + --add_th "
              f"{opt.add_th} (frame {frame}), ngf {opt.ngf}, batch 1; the generator's planes: "
              f"{spatial.plane_plan(opt, SPACE_WORLD)}; the encoders' planes are bands, the "
              f"IG whole on every rank")

    # spade_modulate at up_4's band against its plain version, and its times
    gen = torch.Generator().manual_seed(SEED)
    c, rows = opt.ngf, frame // SPACE_WORLD  # up_4 takes ngf channels at the frame
    band = {}
    for dname, tol in TOLS.items():
        dtype = getattr(torch, dname)
        x = torch.randn((1, c, rows, frame), generator=gen).to("cuda", dtype)
        mean = torch.randn(c, generator=gen).cuda()
        inv = torch.rand(c, generator=gen).add(0.5).cuda()
        gb = torch.randn((1, 2 * c, rows, frame), generator=gen).to("cuda", dtype)
        args = (x, mean, inv, *gb.chunk(2, dim=1))
        got, want = K.spade_modulate(*args), K.spade_modulate_plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **tol)
        elem = x.element_size()
        b_ms, b_by = bound(elem * 4 * x.numel() + 8 * c, 4 * x.numel(), FP32_FLOP_S)
        band[dname] = {"shape": [1, c, rows, frame], "max_abs_err": err,
                       "ms": median_ms(lambda: K.spade_modulate(*args), torch, True),
                       "plain_ms": median_ms(lambda: K.spade_modulate_plain(*args), torch, True),
                       "bound_ms": b_ms, "bound_by": b_by}
        r = band[dname]
        phase(23, f"spade_modulate {dname} at up_4's band (1, {c}, {rows}, {frame}) vs its plain "
                  f"version: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}; device kernel "
                  f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}) "
                  f"{tag}")
        if not ok:
            return "phase 23: spade_modulate disagrees with its plain version at a band", None
        del x, gb, args, got, want
    torch.cuda.empty_cache()

    # one process's forward on the card, then the ranks'; each peak is read
    # above what the process held before its model (this one holds what
    # earlier phases left)
    dev = torch.device("cuda:0")
    held = torch.cuda.memory_allocated(dev)
    batch = batch_from_numpy(synthetic_inference_data(opt, SEED), dev)
    model = MichiGANModel(opt, dev)
    model.init_weights(SEED)
    one = {}
    one["float32"] = space_forwards(torch, model, model.infer, batch, SPACE_REPS)
    states = {k: {n: t.cpu() for n, t in net.state_dict().items()}
              for k, net in model.nets().items()}
    del model
    torch.cuda.empty_cache()
    model = MichiGANModel(parse_options(FLAGS + MOST_INFER + ["--seed", str(SEED), "--dtype",
                                                              "bfloat16"]), dev)
    model.load_state_dicts(states)
    one["bfloat16"] = space_forwards(torch, model, model.infer, batch, SPACE_REPS)
    del model, batch, states
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t23
    u8 = lambda t: tensor2im(t.permute(0, 2, 3, 1).numpy()[0, r0:r0 + crop, r0:r0 + crop])
    one32, one16 = one["float32"][0].cpu(), one["bfloat16"][0].cpu()
    want = {"float32": {k: ({"float32": v} if v else {}) for k, v in MOST_LAUNCHES.items()},
            "bfloat16": MOST_BF16_LAUNCHES}

    def check(ranks, how):
        """The gates and lines of one launch's ranks; the failures."""
        fails = []
        for r, res in enumerate(ranks):
            phase(23, f"{how}, rank {r}: launches fp32 {res['float32']['counts']}, bf16 "
                      f"{res['bfloat16']['counts']}")
            if any(res[d]["counts"] != want[d] for d in want):
                fails.append(f"{how}: rank {r}'s launches")
        got32, got16 = ranks[0]["float32"]["fake"], ranks[0]["bfloat16"]["fake"]
        diff32, psnr = (got32 - one32).abs().max().item(), psnr_u8(u8(got32), u8(one32), np)
        diff16, cal = (got16 - one16).abs().max().item(), (one16 - one32).abs().max().item()
        ok = (got32.shape == one32.shape == (1, 3, frame, frame) and torch.isfinite(got32).all()
              and diff32 <= 2e-3 and psnr > 50 and diff16 <= BF16_CAL * cal)
        phase(23, f"{how}: the {len(ranks)} ranks' gathered output against one process on the "
                  f"card: fp32 max_abs {diff32:.3e} (limit 2e-3), PSNR {psnr:.2f} dB (limit 50); "
                  f"bf16 max_abs {diff16:.3e} (limit {BF16_CAL:g} x the card's own bf16 vs fp32 "
                  f"{cal:.3e})")
        if not ok:
            fails.append(f"{how}: the bands' output against one process's")
        control = ranks[0]["control"]
        c_diff = (control - one32).abs().max().item()
        c_psnr = psnr_u8(u8(control), u8(one32), np)
        c_ok = c_diff <= 2e-3 and c_psnr > 50
        phase(23, f"{how}: control, zeros in place of the neighbours' halo rows: max_abs "
                  f"{c_diff:.3e}, PSNR {c_psnr:.2f} dB" + (
                      ": passes, FAIL" if c_ok else ": fails the gate, as it must"))
        if c_ok:
            fails.append(f"{how}: the gate passes the zero-halo control")
        for d in ("float32", "bfloat16"):
            peaks = ", ".join(f"{(res[d]['peak'] - res['held']) / 2**30:.2f}" for res in ranks)
            ms = ", ".join(f"{res[d]['ms']:.2f}" for res in ranks)
            tr = ", ".join(f"{res[d]['transport']['calls']} calls {res[d]['transport']['ms']:.2f} "
                           f"of {res[d]['transport']['forward_ms']:.2f} ms" for res in ranks)
            phase(23, f"{how}, {d}, batch 1: one process {one[d][3]:.2f} ms/image, peak "
                      f"{(one[d][2] - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} it held "
                      f"before; the {len(ranks)} ranks {ms} ms/image a rank "
                      f"(median of {SPACE_REPS}, host clock), peak {peaks} GiB a rank; in the "
                      f"exchanges, gathers and all-reduces (one more forward, each clocked "
                      f"between two synchronizes) {tr} a rank {tag}")
        return fails

    tmp = tempfile.mkdtemp(prefix="phase23_")
    n_cards = torch.cuda.device_count()
    try:
        t0 = time.perf_counter()
        DP.launch(space_rank, (tmp, "gloo"), SPACE_WORLD, timeout=SPACE_JOIN_S)
        ranks = [torch.load(f"{tmp}/gloo{r}.pt") for r in range(SPACE_WORLD)]
        t_ranks = time.perf_counter() - t0
        fails = check(ranks, "gloo, all on cuda:0")
        if n_cards >= 2:  # one rank a card over NCCL: 4 bands on 4 cards, else 2
            world = 4 if n_cards >= 4 else 2
            phase(23, f"NCCL, {world} ranks one card each: the generator's planes "
                      f"{spatial.plane_plan(opt, world)}")
            DP.launch(space_rank, (tmp, "nccl"), world, timeout=SPACE_JOIN_S)
            fails += check([torch.load(f"{tmp}/nccl{r}.pt") for r in range(world)],
                           f"NCCL, {world} cards")
        else:
            phase(23, f"{n_cards} card: the ranks ran on one card over gloo; none ran over NCCL")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase(23, f"spatial sharding in {time.perf_counter() - t23:.1f} s (one process {t_one:.1f} s, "
              f"the gloo ranks {t_ranks:.1f} s)")
    if fails:
        return f"phase 23: {', '.join(fails)}", None
    return None, {"counts": [{d: res[d]["counts"] for d in want} for res in ranks],
                  "band": band}


def space_train_opts(train_options):
    """Phase 24's options: TRAIN_FLAGS + MOST_TRAIN at 1024, batch 1,
    float32, every default loss."""
    return train_opts(train_options, 1, 1024, MOST_TRAIN)


def space_gate(got, want, o):
    """Phase 24's gate of one run ({'losses', 'params': {net: {name:
    tensor}}, 'buffers'}) against one process's: the same loss terms as one
    process's G step (and D step, where `got` has netD), each within
    SPACE_LOSS_RTOL (ORIENT SPACE_ORIENT_RTOL) plus 1e-5; netG and netD,
    where `got` has them, by phase 12's scale-aware rule; netG's buffers,
    where given, within rtol 1e-4, atol 1e-5.  Returns (ok, printable: the
    relative difference of every term)."""
    import torch

    keys = [k for k in want["losses"] if "netD" in got["params"] or not k.startswith("D_")]
    ok = sorted(got["losses"]) == sorted(keys)
    rows = [] if ok else [f"loss terms {sorted(got['losses'])} where one process has {keys}"]
    rel, bad = {}, []
    for k in keys:
        if k not in got["losses"]:
            continue
        v, g = want["losses"][k], got["losses"][k]
        rel[k] = abs(g - v) / max(abs(v), 1e-30)
        if not abs(g - v) <= (SPACE_ORIENT_RTOL if k == "ORIENT" else SPACE_LOSS_RTOL) \
                * abs(v) + 1e-5:
            bad.append(k)
    ok &= not bad
    rows.append("relative differences " + ", ".join(f"{k} {r:.2e}" for k, r in rel.items())
                + f"; beyond the limit {bad}")
    for net, lr in (("netG", o.lr / 2), ("netD", 2 * o.lr)):
        if net in got["params"]:
            n_ok, worst, n_bad, n_tot = scale_aware(got["params"][net], want["params"][net], lr)
            ok &= n_ok
            rows.append(f"{net} {n_bad} of {n_tot} beyond float noise, max diff {worst:.2e} "
                        f"(limit {2.5 * lr:.1e})")
    if "buffers" in got:
        b_ok = all(torch.allclose(got["buffers"][k], v, rtol=1e-4, atol=1e-5)
                   for k, v in want["buffers"].items())
        ok &= b_ok
        rows.append(f"netG's buffers {'within' if b_ok else 'past'} rtol 1e-4")
    return ok, "; ".join(rows)


def space_train_step(torch, tr, batch, post_g=None, g_only=False, save_post_g=None):
    """One G step then (unless `g_only`) one D step of the TrainStep `tr` on
    `batch`, the D step from the netG state_dict `post_g` when given
    (`save_post_g`: a file netG's state_dict after the G step is written
    to): {'losses', 'params': {'netG' after G, 'netD' after D}, 'buffers':
    netG's float buffers after G} on the CPU."""
    cpu = lambda items: {k: v.detach().cpu().clone() for k, v in items}
    m = tr.model
    g, _fake, orient = tr.g_step(batch, EXTRA_DILATE)
    res = {"losses": {k: v.item() for k, v in g.items()},
           "params": {"netG": cpu(m.netG.named_parameters())},
           "buffers": cpu((k, v) for k, v in m.netG.named_buffers() if v.is_floating_point())}
    if save_post_g:
        torch.save(m.netG.state_dict(), save_post_g)
    if not g_only:
        if post_g is not None:
            m.netG.load_state_dict(post_g)
        d = tr.d_step(batch, EXTRA_DILATE, orient)
        res["losses"].update({k: v.item() for k, v in d.items()})
        res["params"]["netD"] = cpu(m.netD.named_parameters())
    torch.cuda.synchronize()
    return res


def collectives_clock(torch, spatial, step):
    """`step()` with every collective of the step clocked (host clock, a
    synchronize before and after each, so that queued card work is not
    counted): torch.distributed's all_reduce and all_gather (the norms'
    sums, the gathers, the gradient sums) and the halo exchanges
    (Bands._exchange).  Returns {'calls', 'ms' in them, 'step_ms'}."""
    import torch.distributed as tdist

    acc = {"calls": 0, "ms": 0.0}
    saved = [(tdist, "all_reduce"), (tdist, "all_gather"), (spatial.Bands, "_exchange")]
    fns = {(o, n): getattr(o, n) for o, n in saved}

    def clocked(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc["ms"] += (time.perf_counter() - t0) * 1e3
            acc["calls"] += 1
            return out
        return run

    for (o, n), fn in fns.items():
        setattr(o, n, clocked(fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        acc["step_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        for (o, n), fn in fns.items():
            setattr(o, n, fn)
    return acc


def space_train_rank(tmp, backend):
    """Phase 24's rank (spawned by parallel.dist.launch): a `backend` group
    of the launched ranks, on cuda:0 for gloo or cuda:<rank> for NCCL;
    TrainStep in row bands of the 1024^2 `most` step at SEED's weights on
    synthetic_train_data's batch (shard_batch): the counted G step, then
    the D step from one process's post-G netG (<tmp>/post_g.pt), under
    deterministic algorithms, held by phase 24's gate against one
    process's (<tmp>/one.pt); whether every
    rank's nets equal rank 0's; the zero-halo and local-statistics
    controls' G steps from the same weights, by the same gate; then
    SPACE_TRAIN_STEPS timed steps and one with its collectives clocked.
    Writes <tmp>/<backend><r>.pt."""
    import datetime

    import torch

    from michigan_tpu_torch.data.synthetic import synthetic_train_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.ops import cuda as kernels
    from michigan_tpu_torch.parallel import dist as DP
    from michigan_tpu_torch.parallel import spatial
    from michigan_tpu_torch.train import parse_options as train_options
    from michigan_tpu_torch.training.train_step import TrainStep

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda:0" if backend == "gloo" else f"cuda:{rank}")
    torch.cuda.set_device(device)
    group = DP.init_group(backend, rank, world, os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), device,
                          datetime.timedelta(seconds=SPACE_GROUP_TIMEOUT_S))
    space = spatial.Space(group, rank, world, device)
    try:
        res = {"held": torch.cuda.memory_allocated(device)}
        o = space_train_opts(train_options)
        band = spatial.shard_batch(batch_from_numpy(synthetic_train_data(o, SEED, 1), "cpu"),
                                   space)
        model = MichiGANModel(o, device)
        model.init_weights(SEED)
        init = {k: {n: t.detach().cpu().clone() for n, t in net.state_dict().items()}
                for k, net in model.nets().items()}
        one = torch.load(f"{tmp}/one.pt")
        post_g = torch.load(f"{tmp}/post_g.pt", map_location=device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        with deterministic_algorithms(torch):
            step = space_train_step(torch, TrainStep(model, space), band, post_g)
        res["counts"] = kernels.launch_counts()
        res["peak"] = torch.cuda.max_memory_allocated(device)
        res["losses"] = step["losses"]
        res["gate"] = space_gate(step, one, o)
        try:
            DP.check_replicas_identical([t for net in model.nets().values()
                                         for t in (*net.parameters(), *net.buffers())], group)
            res["identical"] = True
        except RuntimeError:
            res["identical"] = False
        del step
        # the controls' G steps from the same weights
        saved_rows, saved_bn = spatial.Bands.neighbour_rows, spatial.batch_norm_train
        for name in ("zero_halo", "local_stats"):
            model.load_state_dicts(init)
            if name == "zero_halo":
                spatial.Bands.neighbour_rows = zero_neighbour_rows
            else:
                spatial.batch_norm_train = lambda x, m, v, eps, group: saved_bn(x, m, v, eps=eps)
            try:
                with deterministic_algorithms(torch):
                    ctl = space_train_step(torch, TrainStep(model, space), band, g_only=True)
            finally:
                spatial.Bands.neighbour_rows, spatial.batch_norm_train = saved_rows, saved_bn
            del ctl["buffers"]
            res[name] = space_gate(ctl, one, o)
        # timed steps (warm: the compared and control steps ran first), then
        # one with its collectives clocked
        model.load_state_dicts(init)
        tr = TrainStep(model, space)

        def g_and_d():
            _g, _f, ori = tr.g_step(band, EXTRA_DILATE)
            tr.d_step(band, EXTRA_DILATE, ori)

        res["ms"] = []
        for _ in range(SPACE_TRAIN_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            g_and_d()
            torch.cuda.synchronize(device)
            res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["transport"] = collectives_clock(torch, spatial, g_and_d)
        torch.save(res, f"{tmp}/{backend}{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def space_train_kernels(torch, tag):
    """Phase 24's kernels at their band shapes (SPACE_WORLD bands of the
    1024^2 step), each against its plain version by phase 3's tolerances:
    the bank forward and its backward on rank 1's band of a strand plane
    with its BANK_HALO rows (zeros below the frame), the backward on a
    hair-masked dconf zero on the halo rows; conv3x3_same_lowch on the tag
    + ref tower's band with a halo row each side.  Returns the failures."""
    from michigan_tpu_torch.ops import filters
    from michigan_tpu_torch.ops.cuda import lowch as LC
    from michigan_tpu_torch.ops.cuda import orient as O
    from michigan_tpu_torch.parallel.spatial import BANK_HALO

    cgen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    rows, halo = 1024 // SPACE_WORLD, BANK_HALO
    img = strand_image(torch, 1024, SEED) * 2 - 1
    whole = filters.rgb_to_gray255(img[None]).permute(0, 3, 1, 2).contiguous()
    gray = torch.cat([whole[:, :, 1024 - rows - halo:], whole.new_zeros((1, 1, halo, 1024))],
                     dim=2).contiguous()
    bank = filters.bank("gabor", gray.device)
    failed = []
    got, want = O.filterbank_orientation(gray, bank), O.filterbank_orientation_plain(gray, bank)
    ok, err, frac, note = fb_compare(torch, got, want, gray, bank)
    phase(24, f"filterbank_orientation at a band {tuple(gray.shape)} vs its plain version: conf "
              f"max_abs_err {err:.3e}, argmax differs on {frac:.2e} of pixels{note} "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("filterbank_orientation")
    idx, conf = got
    hair = torch.cat([ellipse_mask(torch, 1024)[None, 1024 - rows - halo:],
                      gray.new_zeros((1, halo, 1024))], dim=1)
    hair[:, :halo] = 0
    dconf = (torch.randn(hair.shape, generator=cgen, device="cuda") * hair).contiguous()
    got_b = O.filterbank_orientation_backward(dconf, idx, conf, bank)
    want_b = O.filterbank_orientation_backward_plain(dconf, idx, conf, bank)
    err = (got_b - want_b).abs().max().item()
    ok = err <= NEW_KERNEL_REL * want_b.abs().max().item()
    phase(24, f"filterbank_orientation_backward at a band {tuple(dconf.shape)}, hair-masked "
              f"dconf, zero on the halo rows, vs its plain version: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("filterbank_orientation_backward")
    shape = (2, 64, rows + 2, 1024)
    x = torch.randn(shape, generator=cgen, device="cuda").relu_()
    w = torch.randn((64, 64, 3, 3), generator=cgen, device="cuda") * math.sqrt(2 / (9 * 64))
    got_l, want_l = LC.conv3x3_same_lowch(x, w), LC.conv3x3_same_lowch_plain(x, w)
    err = (got_l - want_l).abs().max().item()
    ok = err <= NEW_KERNEL_REL * want_l.abs().max().item()
    phase(24, f"conv3x3_same_lowch at a band {shape} vs its plain version: max_abs_err "
              f"{err:.3e} {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        failed.append("conv3x3_same_lowch")
    del img, whole, gray, got, want, idx, conf, hair, dconf, got_b, want_b, x, w, got_l, want_l
    torch.cuda.empty_cache()
    return failed


def spatial_train_phase(torch, np, tag):
    """Phase 24: spatial sharding of training on the card.  Returns
    (failure or None, {'counts': [a rank's launches, ...]})."""
    import shutil
    import tempfile

    from michigan_tpu_torch.data.synthetic import synthetic_train_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.parallel import dist as DP
    from michigan_tpu_torch.parallel import spatial
    from michigan_tpu_torch.train import parse_options as train_options
    from michigan_tpu_torch.training.train_step import TrainStep

    t24 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # as phase 1 and the ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    o = space_train_opts(train_options)
    plan = spatial.train_plane_plan(o, SPACE_WORLD)
    phase(24, f"{SPACE_WORLD} ranks (gloo, all on cuda:0), the `most` step at {o.crop_size}^2, "
              f"ngf {o.ngf}, ndf {o.ndf}, batch 1, float32, every default loss; planes: "
              f"generator {plan['generator']}, VGG19 {plan['vgg19']}; netD {plan['netD']}; the "
              f"IG whole on every rank")
    failed = space_train_kernels(torch, tag)
    if failed:
        return f"phase 24: a kernel disagrees with its plain version at a band: {failed}", None

    # one process's step on the card: the compared step (peak from a
    # reset, above what this process held before its model), then the
    # timed ones
    dev = torch.device("cuda:0")
    held = torch.cuda.memory_allocated(dev)
    model = MichiGANModel(o, dev)
    model.init_weights(SEED)
    tr = TrainStep(model)
    batch = batch_from_numpy(synthetic_train_data(o, SEED, 1), dev)
    tmp = tempfile.mkdtemp(prefix="phase24_")
    n_cards = torch.cuda.device_count()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with deterministic_algorithms(torch):
            one = space_train_step(torch, tr, batch, save_post_g=f"{tmp}/post_g.pt")
        one_peak = torch.cuda.max_memory_allocated() - held
        torch.save(one, f"{tmp}/one.pt")
        one_ms = []
        for _ in range(SPACE_TRAIN_STEPS):
            t0 = time.perf_counter()
            _g, _f, ori = tr.g_step(batch, EXTRA_DILATE)
            tr.d_step(batch, EXTRA_DILATE, ori)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
        del model, tr, batch, ori, _f, _g
        torch.cuda.empty_cache()
        phase(24, "one process: losses " + ", ".join(f"{k} {v:.5g}"
                                                    for k, v in one["losses"].items()))
        t_one = time.perf_counter() - t24

        def check(ranks, how):
            """The gates and lines of one launch's ranks; the failures."""
            fails = []
            for r, res in enumerate(ranks):
                ok, row = res["gate"]
                phase(24, f"{how}, rank {r}: launches {res['counts']}; against one process: "
                          f"{row} {'ok' if ok else 'FAIL'}")
                if res["counts"] != STEP_LAUNCHES:
                    fails.append(f"{how}: rank {r}'s launches")
                if not ok:
                    fails.append(f"{how}: rank {r}'s step against one process's")
            same = all(res["identical"] for res in ranks) and \
                all(res["losses"] == ranks[0]["losses"] for res in ranks)
            phase(24, f"{how}: the ranks' nets and losses after the step "
                      f"{'equal rank 0s bit for bit' if same else 'DIFFER'}")
            if not same:
                fails.append(f"{how}: the ranks differ")
            for name, what in (("zero_halo", "zeros in place of the neighbours' halo rows"),
                               ("local_stats", "each band's own batch-norm statistics")):
                ok, row = ranks[0][name]
                phase(24, f"{how}: control, {what}, its G step: {row}" + (
                    ": passes, FAIL" if ok else ": fails the gate, as it must"))
                if ok:
                    fails.append(f"{how}: the gate passes the {name} control")
            peaks = ", ".join(f"{(res['peak'] - res['held']) / 2**30:.2f}" for res in ranks)
            ms = ", ".join(f"{statistics.median(res['ms']):.1f}" for res in ranks)
            tr_ = ", ".join(f"{res['transport']['calls']} calls {res['transport']['ms']:.1f} of "
                            f"{res['transport']['step_ms']:.1f} ms" for res in ranks)
            phase(24, f"{how}, batch 1: one process {statistics.median(one_ms):.1f} ms/step "
                      f"(median of {SPACE_TRAIN_STEPS}, host clock), peak "
                      f"{one_peak / 2**30:.2f} GiB above the {held / 2**30:.2f} it held before; "
                      f"the {len(ranks)} ranks {ms} ms/step a rank, peak {peaks} GiB a rank "
                      f"(the compared step); in the collectives (one more step, each clocked "
                      f"between two synchronizes) {tr_} a rank {tag}")
            return fails

        t0 = time.perf_counter()
        DP.launch(space_train_rank, (tmp, "gloo"), SPACE_WORLD, timeout=SPACE_JOIN_S)
        ranks = [torch.load(f"{tmp}/gloo{r}.pt") for r in range(SPACE_WORLD)]
        t_ranks = time.perf_counter() - t0
        fails = check(ranks, "gloo, all on cuda:0")
        if n_cards >= 2:  # one rank a card over NCCL
            DP.launch(space_train_rank, (tmp, "nccl"), SPACE_WORLD, timeout=SPACE_JOIN_S)
            fails += check([torch.load(f"{tmp}/nccl{r}.pt") for r in range(SPACE_WORLD)],
                           f"NCCL, {SPACE_WORLD} cards")
        else:
            phase(24, f"{n_cards} card: the ranks ran on one card over gloo; none ran over NCCL")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase(24, f"spatial training in {time.perf_counter() - t24:.1f} s (one process {t_one:.1f} s, "
              f"the gloo ranks {t_ranks:.1f} s)")
    if fails:
        return f"phase 24: {', '.join(fails)}", None
    return None, {"counts": [res["counts"] for res in ranks]}


def witness_opts(train_options, init):
    """Phase 16's options of the blender config's card-vs-CPU step at
    PARITY16's size and `init`."""
    return train_opts(train_options, PARITY16["batch"], PARITY16["crop"],
                      list(CONFIG_FLAGS["blender"]) + [
                          "--ngf", str(PARITY16["ngf"]), "--ndf", str(PARITY16["ndf"]),
                          "--init_type", init])


def cpu_refs_worker(out):
    """The CPU references computed beside the card's work (spawned, niced):
    the blender's float64 G step (phase 16's witness) at --init_type none
    and xavier from SEED's weights on synthetic_train_data's paired batch,
    then phase 21's CPU forward of each of VARIANT_INFER from SEED's
    weights; each result written to <out>/<name>.pt as it is done
    (witness_<init>: {'g64', 'exact', 's'}; variant_<name>: {'fake', 's'})."""
    os.nice(REFS_NICE)
    import torch

    from michigan_tpu_torch.data.synthetic import synthetic_inference_data, synthetic_train_data
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.tools import float64_step
    from michigan_tpu_torch.train import parse_options as train_options

    torch.set_num_threads(REFS_THREADS)
    torch.set_flush_denormal(True)

    def save(name, obj):
        torch.save(obj, f"{out}/{name}.pt.part")
        os.replace(f"{out}/{name}.pt.part", f"{out}/{name}.pt")

    for init in ("none", "xavier"):
        popt = witness_opts(train_options, init)
        model = MichiGANModel(popt, "cpu")
        model.init_weights(SEED)
        init_sd = {k: {n: t.detach().clone() for n, t in net.state_dict().items()}
                   for k, net in model.nets().items()}
        del model
        batch = batch_from_numpy(synthetic_train_data(popt, SEED, PARITY16["batch"]), "cpu")
        t0 = time.perf_counter()
        _, g64, exact = float64_step.g_step64(popt, init_sd, batch, None,
                                              F64_WITNESSED["blender"], EXTRA_DILATE)
        save(f"witness_{init}", {"g64": g64, "exact": exact, "s": time.perf_counter() - t0})
    for name, (add, drop) in VARIANT_INFER.items():
        opt = parse_options([f for f in FLAGS if f not in drop] + add + ["--seed", str(SEED)])
        model = MichiGANModel(opt, "cpu")
        model.init_weights(SEED)
        batch = batch_from_numpy(synthetic_inference_data(opt, SEED), "cpu")
        t0 = time.perf_counter()
        fake = model.infer(batch)[0]
        save(f"variant_{name}", {"fake": fake, "s": time.perf_counter() - t0})
        del model


class CpuRefs:
    """cpu_refs_worker in a daemonic spawned process (ended with this one),
    and its results as they come."""

    def __init__(self):
        import atexit
        import multiprocessing
        import shutil
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="cpu_refs_")
        atexit.register(shutil.rmtree, self.dir, True)
        self.proc = multiprocessing.get_context("spawn").Process(
            target=cpu_refs_worker, args=(self.dir,), daemon=True)
        self.proc.start()

    def get(self, name):
        """The result `name`, waiting for it (at most REFS_WAIT_S seconds);
        RuntimeError if the worker ended without it."""
        import torch

        path = f"{self.dir}/{name}.pt"
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if not self.proc.is_alive() and not os.path.exists(path):
                raise RuntimeError(f"the CPU reference worker exited with code "
                                   f"{self.proc.exitcode} before {name}")
            if time.perf_counter() - t0 > REFS_WAIT_S:
                raise RuntimeError(f"no CPU reference {name} after {REFS_WAIT_S} s")
            time.sleep(0.2)
        return torch.load(path)


def host_times(root, reps=30):
    """The serving paths on the host clock with the port of the checkout
    `root`, in this process: each bf16 fused_instance_norm call of the
    flagship launched from Python (mean of 50 back-to-back calls, median of
    5), the flagship forward at batch 1 in fp32 and bf16 (phases 6 and
    13) and the bf16 stroke edit (phase 14's), each the median of `reps`
    after a warm-up.  Prints one JSON line."""
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
    flagship_ms = {}
    for dtype in ("float32", "bfloat16"):
        opt = parse_options(FLAGS + ["--seed", str(SEED), "--dtype", dtype])
        model = MichiGANModel(opt, "cuda:0")
        model.init_weights(SEED)
        batch = batch_from_numpy(synthetic_inference_data(opt, SEED), "cuda:0")
        flagship_ms[dtype] = host_ms(lambda: model.infer(batch), torch, reps)
        del model, batch
    sopt = engine.parse_options(STROKE_FLAGS + ["--seed", str(SEED), "--dtype", "bfloat16"])
    smodel = MichiGANModel(sopt, "cuda:0")
    smodel.init_weights(SEED)
    stroke_data = synthetic_stroke_data(engine.parse_options(STROKE_FLAGS + ["--seed", str(SEED)]),
                                        SEED)
    edit_ms = host_ms(edit_of(engine, smodel, batch_from_numpy(stroke_data, "cuda:0")), torch,
                      reps)
    print(json.dumps({"root": str(root), "norm_launched_us": norm_us,
                      "flagship_fp32_ms": flagship_ms["float32"],
                      "flagship_bf16_ms": flagship_ms["bfloat16"], "edit_bf16_ms": edit_ms}))
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
    flat = lambda r: {"flagship_fp32_ms": r["flagship_fp32_ms"],
                      "flagship_bf16_ms": r["flagship_bf16_ms"], "edit_bf16_ms": r["edit_bf16_ms"],
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
