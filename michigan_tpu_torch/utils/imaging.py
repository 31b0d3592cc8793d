"""Array <-> image helpers (port of michigan_tpu/utils/imaging.py)."""

from __future__ import annotations

import os

import numpy as np
import torch


def tensor2im(x: np.ndarray) -> np.ndarray:
    """(H,W,3) float in [-1,1] -> uint8 (util/util.py:40-66)."""
    x = (np.asarray(x) + 1.0) / 2.0
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def tensor2im_u8(x: torch.Tensor) -> torch.Tensor:
    """tensor2im's math on the tensor's own device: (N,3,H,W) float in
    [-1,1] -> (N,H,W,3) uint8 ((x+1)/2*255, clip, truncate)."""
    y = ((x.float() + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8)
    return y.permute(0, 2, 3, 1)


def save_image(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
