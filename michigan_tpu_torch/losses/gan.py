"""GAN losses (port of michigan_tpu/losses/gan.py, reference loss.py:19-140):
hinge (with the optional wide-edge weighting and the hair-masked form of
--remove_background), ls, original, w."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.masks import wide_edges
from michigan_tpu_torch.ops.resize import resize_nearest


def _weight_mask(pred: torch.Tensor, label: torch.Tensor, wide_edge: float) -> torch.Tensor:
    edges = wide_edges(resize_nearest(label, pred.shape[2:]))
    return edges * wide_edge + (1.0 - edges)


def gan_loss(pred: torch.Tensor, target_is_real: bool, for_discriminator: bool, opt,
             label: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One scale (loss.py:80-124); `label` is the target hair mask
    (N,1,H,W) at full resolution."""
    pred = pred.float()
    mode = opt.gan_mode
    if mode == "original":
        return F.binary_cross_entropy_with_logits(
            pred, torch.full_like(pred, 1.0 if target_is_real else 0.0))
    if mode == "ls":
        return ((pred - (1.0 if target_is_real else 0.0)) ** 2).mean()
    if mode == "hinge":
        if not opt.remove_background:
            if for_discriminator:
                minval = torch.clamp_max((pred - 1) if target_is_real else (-pred - 1), 0.0)
                if opt.wide_edge > 1.0 and label is not None:
                    minval = minval * _weight_mask(pred, label, opt.wide_edge)
                return -minval.mean()
            if not target_is_real:
                raise ValueError("the generator's hinge loss aims for real")
            return -pred.mean()
        label1 = resize_nearest(label, pred.shape[2:])
        denom = label1.sum() * pred.shape[1] + 1e-5
        if for_discriminator:
            raw = (pred - 1) if target_is_real else (-pred - 1)
            return -torch.clamp_max(raw * label1, 0.0).sum() / denom
        return -(pred * label1).sum() / denom
    if mode == "w":
        return -pred.mean() if target_is_real else pred.mean()
    raise ValueError(f"unknown --gan_mode {mode}")


def multiscale_gan_loss(preds, target_is_real: bool, for_discriminator: bool, opt,
                        label: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the discriminators of each one's loss on its last output
    (loss.py:126-140)."""
    label = label.detach() if label is not None else None
    total = sum(gan_loss(p[-1], target_is_real, for_discriminator, opt, label) for p in preds)
    return total / len(preds)
