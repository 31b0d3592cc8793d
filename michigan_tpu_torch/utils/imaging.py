"""Array <-> image helpers (port of michigan_tpu/utils/imaging.py)."""

from __future__ import annotations

import os

import numpy as np


def tensor2im(x: np.ndarray) -> np.ndarray:
    """(H,W,3) float in [-1,1] -> uint8 (util/util.py:40-66)."""
    x = (np.asarray(x) + 1.0) / 2.0
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def save_image(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
