"""A seeded synthetic sample with the keys, shapes and dtypes of
``single_inference_data``, made with numpy alone (no image files, PIL or
cv2): a hair ellipse over the upper face, a disk-shaped hole inside it, a
smooth orientation field and noise around 0.5.  For runs where the image
libraries are absent, such as the card smoke test."""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_inference_data(opt, seed: int, batch: int = 1) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    s = opt.crop_size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s

    def sample():
        cy, cx = rng.uniform(0.3, 0.4), rng.uniform(0.45, 0.55)
        ry, rx = rng.uniform(0.2, 0.3), rng.uniform(0.25, 0.35)
        hair = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(np.float32)
        hy, hx = cy + rng.uniform(-0.05, 0.05), cx + rng.uniform(-0.05, 0.05)
        hole = hair * (((yy - hy) ** 2 + (xx - hx) ** 2) < 0.1 ** 2)
        orient = (np.arctan2(yy - cy, xx - cx) / np.pi % 1.0) * 255.0
        t = orient / 255.0 * np.pi
        orient_rgb = np.stack(
            [(np.cos(2 * t) + 1) / 2, (np.sin(2 * t) + 1) / 2, np.full_like(t, 0.5)], -1
        ) * hair[..., None]
        image = rng.uniform(-1, 1, (s, s, 3)).astype(np.float32)
        return {
            "label_ref": hair[..., None],
            "label_tag": hair[..., None],
            "image_ref": image,
            "image_tag": image,
            "orient": (orient * hair)[..., None],
            "hole": hole[..., None],
            "orient_rgb": orient_rgb,
            "noise": rng.normal(0.5, 0.25 / 3, (s, s, 3)),
        }

    samples = [sample() for _ in range(batch)]
    out = {k: np.stack([x[k] for x in samples]).astype(np.float32) for k in samples[0]}
    out["instance"] = np.zeros((1,), np.float32)
    return out
