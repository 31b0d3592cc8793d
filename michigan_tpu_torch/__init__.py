"""MichiGAN in PyTorch for NVIDIA Hopper: the port of ``michigan_tpu``.

The module names mirror ``michigan_tpu`` so each module's counterpart is easy
to find.  Inside, the port uses PyTorch idiom: ``nn.Module``s in NCHW, plain
functions on tensors, an explicit ``device``, ``torch.Generator``s for any
randomness.  Its own ``config.py`` keeps the JAX package's ``Options`` and
flags, so the CLI reads the same command lines; it imports nothing of the
JAX package.

Layer map:
  ops          resize / pools, norms, masks, masked stats, the oriented
               filter banks and dense orientation (plain torch)
  ops/cuda     hand-written CUDA kernels (csrc/*.cu), built with nvcc at
               first use and bound with ctypes, each beside its plain version
  models       the inference nets: SPADEB generator, encoders, IG and SIG
  data         host prep (numpy / PIL / cv2) for single-image inference and
               demo edits; the trainer's loader; seeded numpy-only samples
  native       the loader's C++ noise pyramid (g++ at first use, ctypes)
  model        inference orchestration (IG or SIG inpainting -> generator)
  convert      weight bridge from the JAX package's variable trees
  inference    the CLI (python -m michigan_tpu_torch.inference ...)
  demo         the edit engine, the Qt editor and the headless edit
               (python -m michigan_tpu_torch.demo [--stroke ...])
  cal_orientation  the dense-orientation CLI
               (python -m michigan_tpu_torch.cal_orientation ...)
"""
