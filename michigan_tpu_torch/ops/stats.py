"""Masked statistics (port of michigan_tpu/ops/stats.py), NCHW."""

from __future__ import annotations

import torch


def masked_region_mean(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-channel average of feat over a single-channel mask:
    sum(feat * mask) / max(sum(mask), 1).  (N,C,H,W), (N,1,H,W) -> (N,C,1,1)."""
    num = (feat * mask).sum(dim=(2, 3), keepdim=True)
    den = mask.sum(dim=(2, 3), keepdim=True).clamp_min(1.0)
    return num / den
