"""Resize and pooling with PyTorch's own index rules (port of
michigan_tpu/ops/resize.py, which re-implements these rules in JAX), NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(x, size, mode='nearest')."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2): exact 2x pixel replication."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(x, size, mode='bilinear', align_corners=False)."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def max_pool_same(x: torch.Tensor, k: int, stride: int = 1, padding: int = None) -> torch.Tensor:
    """F.max_pool2d(x, k, stride, padding=int(k/2)); an even k grows the
    output by one, as in torch."""
    if padding is None:
        padding = int(k / 2)
    return F.max_pool2d(x, k, stride, padding)


def dilate_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Binary-mask dilation by a k x k max-pool at stride 1, resized back to
    the input size when an even k grew it."""
    y = max_pool_same(mask, k, 1, int(k / 2))
    if y.shape[2:] != mask.shape[2:]:
        y = resize_nearest(y, mask.shape[2:])
    return y


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False): the
    multiscale discriminator's downsample (discriminator.py:46-49)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)
