"""Masked statistics (port of michigan_tpu/ops/stats.py), NCHW."""

from __future__ import annotations

import torch


def masked_region_mean(feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-channel average of feat over a single-channel mask:
    sum(feat * mask) / max(sum(mask), 1).  (N,C,H,W), (N,1,H,W) -> (N,C,1,1)."""
    num = (feat * mask).sum(dim=(2, 3), keepdim=True)
    den = mask.sum(dim=(2, 3), keepdim=True).clamp_min(1.0)
    return num / den


def hair_avg(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-channel average of x over a single-channel mask (loss.py:571-577):
    sum(x * mask) / sum(mask), a divisor of 1 where the mask is empty.
    (N,C,H,W), (N,1,H,W) -> (N,C,1,1)."""
    s = (x * mask).sum(dim=(2, 3), keepdim=True)
    msum = mask.sum(dim=(2, 3), keepdim=True)
    return s / torch.where(msum == 0, torch.ones_like(msum), msum)


def masked_mean_std(feat: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5):
    """calc_mean_std_mask (loss.py:634-654): per-(N, C) mean and std over the
    masked pixels, (N,C,H,W) and (N,1,H,W) -> two (N,C,1,1).  As in the
    reference the variance is sum(((x*m - mean) * m)^2) / sum(m) + eps."""
    m = mask.float()
    f = feat.float() * m
    msum = m.sum(dim=(2, 3), keepdim=True) + eps
    mean = f.sum(dim=(2, 3), keepdim=True) / msum
    var = (((f - mean) * m) ** 2).sum(dim=(2, 3), keepdim=True) / msum + eps
    return mean, torch.sqrt(var)
