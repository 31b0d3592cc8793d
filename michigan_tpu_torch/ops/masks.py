"""Mask utilities (port of michigan_tpu/ops/masks.py), NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.resize import max_pool_same, resize_nearest


def one_hot_label(label_map: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer (N,1,H,W) label map -> one-hot float32 (N,num_classes,H,W),
    the scatter_ one-hot of the reference; labels clipped to the range."""
    lab = label_map[:, 0].long().clamp(0, num_classes - 1)
    return F.one_hot(lab, num_classes).permute(0, 3, 1, 2).float()


def wide_edges(mask: torch.Tensor, th: float = 0.06) -> torch.Tensor:
    """The band around a binary mask, dilate(m) - erode(m) with a
    max(1, int(H * th)) window (loss.py:60-68); an even window grows the map
    by one, which is resized back, as in the reference."""
    k = max(1, int(mask.shape[2] * th))
    p = int(k / 2)
    grow = max_pool_same(mask, k, 1, p)
    shrink = 1.0 - max_pool_same(1.0 - mask, k, 1, p)
    return resize_nearest(grow - shrink, mask.shape[2:])
