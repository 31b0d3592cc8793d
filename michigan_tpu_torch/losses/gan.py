"""GAN losses (port of michigan_tpu/losses/gan.py, reference loss.py:19-140):
hinge (with the optional wide-edge weighting and the hair-masked form of
--remove_background), ls, original, w."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.masks import wide_edges
from michigan_tpu_torch.ops.resize import resize_nearest


def label_at(label: torch.Tensor, pred: torch.Tensor, fn=None):
    """(the hair label resized to pred's planes, then `fn` of it, in pred's
    layout; pred's channels).  pred is NCHW, or a 3-D piece of a single
    discriminator's feature in the JAX package's (H, W, C) layout
    (model.discriminate under --netD n_layer): that one's label is resized
    to (pred.shape[1], pred.shape[2]) and laid out (N, h, w, 1), as the
    JAX losses resize an NHWC label to an NHWC pred's shape[1:3]."""
    fn = fn or (lambda m: m)
    if pred.dim() == 4:
        return fn(resize_nearest(label, pred.shape[2:])), pred.shape[1]
    return fn(resize_nearest(label, pred.shape[1:3])).permute(0, 2, 3, 1), pred.shape[-1]


def _weight_mask(pred: torch.Tensor, label: torch.Tensor, wide_edge: float) -> torch.Tensor:
    edges, _ = label_at(label, pred, wide_edges)
    return edges * wide_edge + (1.0 - edges)


def gan_loss(pred: torch.Tensor, target_is_real: bool, for_discriminator: bool, opt,
             label: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One scale (loss.py:80-124); `label` is the target hair mask
    (N,1,H,W) at full resolution; pred as ``label_at`` takes it."""
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
        label1, c = label_at(label, pred)
        denom = label1.sum() * c + 1e-5
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
