"""Array <-> image helpers (port of michigan_tpu/utils/imaging.py)."""

from __future__ import annotations

import os

import numpy as np
import torch


def tensor2im(x: np.ndarray) -> np.ndarray:
    """(H,W,3) float in [-1,1] -> uint8 (util/util.py:40-66)."""
    x = (np.asarray(x) + 1.0) / 2.0
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def tensor2label(label: np.ndarray, n_label: int) -> np.ndarray:
    """Label map ((H,W), (H,W,1) or the first of a batch) -> uint8 gray,
    each label times 255 // (n_label - 1) (util/util.py:69-88 without the
    colormap, which only datasets of more than two classes use)."""
    lab = np.asarray(label)
    if lab.ndim == 4:
        lab = lab[0]
    lab = lab[..., 0] if lab.ndim == 3 else lab
    return (lab * (255 // max(n_label - 1, 1))).astype(np.uint8)


def tensor2im_u8(x: torch.Tensor) -> torch.Tensor:
    """tensor2im's math on the tensor's own device: (N,3,H,W) float in
    [-1,1] -> (N,H,W,3) uint8 ((x+1)/2*255, clip, truncate)."""
    y = ((x.float() + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8)
    return y.permute(0, 2, 3, 1)


def save_image(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
