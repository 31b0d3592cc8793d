"""Discriminator feature matching (port of michigan_tpu/losses/feat.py,
reference loss.py:144-175)."""

from __future__ import annotations

import torch

from michigan_tpu_torch.losses.gan import label_at


def gan_feat_loss(pred_fake, pred_real, opt, label: torch.Tensor = None) -> torch.Tensor:
    """L1 between fake and (detached) real D features, every layer but the
    prediction, times lambda_feat / num_D; with --remove_background the L1
    is masked by the hair and normalised by its area times channels.  The
    features are NCHW, or 3-D pieces as ``gan.label_at`` takes them, whose
    differences broadcast as the JAX package's do."""
    num_d = len(pred_fake)
    total = 0.0
    for fakes, reals in zip(pred_fake, pred_real):
        for a, b in zip(fakes[:-1], reals[:-1]):
            b = b.detach().float()
            a = a.float()
            if opt.remove_background:
                lab, c = label_at(label.detach(), a)
                term = (a * lab - b * lab).abs().sum() / (lab.sum() * c + 1e-5)
            else:
                term = (a - b).abs().mean()
            total = total + term * (opt.lambda_feat / num_d)
    return total
