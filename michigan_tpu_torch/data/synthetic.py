"""Seeded synthetic samples made with numpy alone (no image files, PIL or
cv2), for runs where the image libraries are absent, such as the card smoke
test.

synthetic_inference_data  the keys, shapes and dtypes of
    ``single_inference_data``: a hair ellipse over the upper face, a
    disk-shaped hole inside it, a smooth orientation field, noise around 0.5;
    under --no_instance False the (N,H,W,1) instance map a caller builds
    for the model (no loader reads one): two ids, split at a seeded column.
synthetic_train_data  a training batch with the training loader's keys
    (``label_ref``, ``label_tag``, ``image_ref``, ``image_tag``, ``orient``,
    ``hole``, ``orient_rgb``, ``noise``; ``instance`` under --no_instance
    False), the same samples: paired, so the
    ref planes are the tag planes; or unpaired (the --unpairTrain stage's
    batch), the ref label and image from other samples.
synthetic_stroke_data  a stroke edit as ``demo_inference_data`` gives it,
    less ``orient_stroke``, which the caller makes from ``mask_stroke`` on
    its device (``michigan_tpu_torch.demo.engine.orient_stroke_plane``).
"""

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
    if getattr(opt, "no_instance", True):
        out["instance"] = np.zeros((1,), np.float32)
    else:  # its own generator: the other planes stay as they are
        cut = np.random.default_rng(seed + 1000).integers(s // 4, 3 * s // 4, batch)
        out["instance"] = np.broadcast_to(
            np.arange(s)[None, None, :, None] >= cut[:, None, None, None],
            (batch, s, s, 1)).astype(np.float32)
    return out


def synthetic_train_data(opt, seed: int, batch: int, paired: bool = True
                         ) -> Dict[str, np.ndarray]:
    out = synthetic_inference_data(opt, seed, batch)
    if getattr(opt, "no_instance", True):
        del out["instance"]
    if not paired:
        other = synthetic_inference_data(opt, seed + 1, batch)
        out["label_ref"], out["image_ref"] = other["label_tag"], other["image_tag"]
    return out


def synthetic_stroke_data(opt, seed: int) -> Dict[str, np.ndarray]:
    """One stroke edit on the sample of ``synthetic_inference_data``: a
    stroke 6 px wide (at 512^2) through the hair, as the headless demo draws
    it; the hole is the stroke dilated by a 50 px disk, within the hair
    (the demo's dilate_hole, computed here as a distance); the orientation
    map covers the hair less the hole, so the edit takes the two-stage
    (IG prefill, then SIG) branch.  Batch 1."""
    out = synthetic_inference_data(opt, seed)
    rng = np.random.default_rng(seed + 1)
    s = opt.crop_size
    hair = out["label_tag"][0, ..., 0]
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    ys, xs = np.nonzero(hair)
    centre = np.array([ys.mean(), xs.mean()], np.float32)
    direction = np.array([1.0, rng.uniform(0.3, 0.7)], np.float32)
    direction /= np.linalg.norm(direction)
    half = 60.0 * s / 512
    a, b = centre - half * direction, centre + half * direction
    # distance of every pixel to the segment a-b
    py, px = yy - a[0], xx - a[1]
    ab = b - a
    t = np.clip((py * ab[0] + px * ab[1]) / float(ab @ ab), 0.0, 1.0)
    dist = np.hypot(py - t * ab[0], px - t * ab[1])
    stroke = hair * (dist < 3.0 * s / 512)
    hole = hair * (dist < 25.0 * s / 512)
    orient_mask = hair * (1 - hole)
    plane = lambda a_: a_[None, ..., None].astype(np.float32)
    out["hole"] = plane(hole)
    out["mask_stroke"] = plane(stroke)
    out["orient_rgb_mask"] = plane(orient_mask)
    out["orient_rgb"] = (out["orient_rgb"] * orient_mask[None, ..., None]).astype(np.float32)
    return out
