"""Mask utilities (port of michigan_tpu/ops/masks.py), NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def one_hot_label(label_map: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer (N,1,H,W) label map -> one-hot float32 (N,num_classes,H,W),
    the scatter_ one-hot of the reference; labels clipped to the range."""
    lab = label_map[:, 0].long().clamp(0, num_classes - 1)
    return F.one_hot(lab, num_classes).permute(0, 3, 1, 2).float()
