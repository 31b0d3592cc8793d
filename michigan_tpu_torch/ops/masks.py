"""Mask utilities (port of michigan_tpu/ops/masks.py), NCHW."""

from __future__ import annotations

import torch

from michigan_tpu_torch.ops.resize import max_pool_same, resize_nearest


def one_hot_label(label_map: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer (N,1,H,W) label map -> one-hot float32 (N,num_classes,H,W),
    the scatter_ one-hot of the reference; labels clipped to the range.
    A comparison with arange, not F.one_hot, whose range check reads the
    labels on the host on the CPU, which torch.export cannot trace."""
    lab = label_map.long().clamp(0, num_classes - 1)
    classes = torch.arange(num_classes, device=label_map.device).view(1, -1, 1, 1)
    return (lab == classes).float()


def wide_edges(mask: torch.Tensor, th: float = 0.06) -> torch.Tensor:
    """The band around a binary mask, dilate(m) - erode(m) with a
    max(1, int(H * th)) window (loss.py:60-68); an even window grows the map
    by one, which is resized back, as in the reference."""
    k = max(1, int(mask.shape[2] * th))
    p = int(k / 2)
    grow = max_pool_same(mask, k, 1, p)
    shrink = 1.0 - max_pool_same(1.0 - mask, k, 1, p)
    return resize_nearest(grow - shrink, mask.shape[2:])


def wide_edges_outer(mask: torch.Tensor, k: int = 5) -> torch.Tensor:
    """The band just inside a binary mask's border, m - erode(m) with a k x k
    window (generator.py:98-105); an even window's extra row and column are
    resized back, as in wide_edges."""
    p = int(k / 2)
    shrink = 1.0 - max_pool_same(1.0 - mask, k, 1, p)
    return resize_nearest(mask - shrink, mask.shape[2:])


def instance_edges(inst: torch.Tensor) -> torch.Tensor:
    """The boundary map of an instance-id map (pix2pix_model.py:596-602):
    1 at each pixel whose right, left, lower or upper neighbour holds
    another id.  (N,1,H,W) -> float32 (N,1,H,W)."""
    dx = inst[:, :, :, 1:] != inst[:, :, :, :-1]
    dy = inst[:, :, 1:, :] != inst[:, :, :-1, :]
    edge = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    edge[:, :, :, 1:] |= dx
    edge[:, :, :, :-1] |= dx
    edge[:, :, 1:, :] |= dy
    edge[:, :, :-1, :] |= dy
    return edge.float()
