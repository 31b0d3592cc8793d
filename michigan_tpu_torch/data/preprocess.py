"""Host-side sample preprocessing (copy of michigan_tpu/data/preprocess.py;
reference base_dataset.py:28-47, 335-396)."""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np
from PIL import Image


def pad_zeros(img: Image.Image, pad_th: int) -> Image.Image:
    """Zero-pad a PIL image by pad_th in total (pad_th/2 per side)."""
    arr = np.array(img)
    r = int(pad_th / 2)
    out = np.zeros((arr.shape[0] + pad_th, arr.shape[1] + pad_th) + arr.shape[2:], arr.dtype)
    out[r : r + arr.shape[0], r : r + arr.shape[1]] = arr
    return Image.fromarray(np.uint8(out))


def trans_orient_to_rgb(
    orient: np.ndarray, label: np.ndarray, orient_label: Optional[np.ndarray] = None
) -> Image.Image:
    """Dense orient [0,255] -> RGB: R=(cos2t+1)/2, G=(sin2t+1)/2, B=0.5,
    masked by the matching label."""
    t = orient / 255.0 * math.pi
    h, w = t.shape
    rgb = np.zeros((h, w, 3))
    rgb[..., 1] = (np.sin(2 * t) + 1) / 2
    rgb[..., 0] = (np.cos(2 * t) + 1) / 2
    rgb[..., 2] = 0.5
    mask = label if orient_label is None else orient_label
    rgb *= mask[..., None]
    return Image.fromarray(np.uint8(rgb * 255.0)).convert("RGB")


def generate_hole(
    mask: np.ndarray, orient_mask: np.ndarray, rng: Optional[random.Random] = None
) -> Image.Image:
    """Random circular erasure of the orient mask + the out-of-orient region."""
    r = rng or random
    H, W = orient_mask.shape
    if np.abs(orient_mask).max() == 0:
        return Image.fromarray(np.uint8(orient_mask)).convert("L")
    coord = np.where(orient_mask != 0)
    nums = len(coord[0])
    th = r.uniform(0.5, 1.2)
    rr = int(int(th * nums) / math.pi)
    center_idx = r.randint(0, nums - 1)
    ch, cw = coord[0][center_idx], coord[1][center_idx]
    yy = np.arange(H)[:, None]
    xx = np.arange(W)[None, :]
    circ = ((yy - ch) ** 2 + (xx - cw) ** 2) < rr
    hole = orient_mask * circ.astype(np.float64) + (mask - orient_mask)
    return Image.fromarray(np.uint8(hole)).convert("L")
