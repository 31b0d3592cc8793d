"""Multi-octave background noise pyramid (reference base_dataset.py:387-396):
``generate_noise``, the copy of michigan_tpu/ops/noise.py:generate_noise
(numpy and cv2; single-image inference and the demo engine), and
``generate_noise_fast``, its :58 counterpart (the native library; the
trainer's loader)."""

from __future__ import annotations

import numpy as np


def generate_noise(width: int, height: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """Octaves of N(0.5, 0.25) noise from full resolution down to 8 px, each
    cv2-bilinear upsampled to full size, averaged.  (H,W,3) float32."""
    import cv2

    rand = rng.normal if rng is not None else np.random.normal
    weight = 1.0
    weight_sum = 0.0
    noise = np.zeros((height, width, 3), dtype=np.float32)
    w, h = width, height
    while w >= 8 and h >= 8:
        octave = rand(loc=0.5, scale=0.25, size=(int(h), int(w), 3))
        noise += cv2.resize(octave, dsize=(noise.shape[0], noise.shape[1])) * weight
        weight_sum += weight
        w //= 2
        h //= 2
    return noise / weight_sum


def generate_noise_fast(width: int, height: int, seed: int) -> np.ndarray:
    """The native C++ pyramid (michigan_tpu_torch/native), deterministic in
    `seed`: the JAX package's loader noise bit for bit.  (H,W,3) float32.
    Raises RuntimeError when the library cannot be built: there is no cv2
    fallback, which would draw another stream."""
    from michigan_tpu_torch import native

    return native.noise_pyramid(height, width, seed)
