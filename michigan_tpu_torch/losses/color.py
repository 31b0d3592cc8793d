"""Colour losses (port of michigan_tpu/losses/color.py, reference
loss.py:388-531): the Lab ab-channel L1, optionally balanced by the data's
ab histogram (--balance_Lab, data_assets/ab_count.npy), and the background
L1; the hair-average Lab L1 of the unpaired stage (--unpairTrain) and the
VAE's KLD (--use_vae).  The per-pixel means go through `red`
(losses/reduce.py: the whole plane, or a band's share of it)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from michigan_tpu_torch.losses.reduce import WHOLE
from michigan_tpu_torch.ops.color import rgb_to_lab
from michigan_tpu_torch.ops.stats import hair_avg


def load_ab_count(path: str, device) -> torch.Tensor:
    """The (256, 256) ab histogram as float32 on `device`."""
    return torch.from_numpy(np.load(path).astype(np.float32)).to(device)


def _balance_weight_map(real_lab: torch.Tensor, ab_count: torch.Tensor, opt) -> torch.Tensor:
    """Per pixel min(max(count) / count, Lab_weight_th) at the pixel's (b, a)
    cell, looked up by nearest grid sampling (loss.py:484-507)."""
    weight = torch.where(ab_count == 0, torch.ones_like(ab_count), ab_count)
    weight = (weight.max() / weight).clamp_max(opt.Lab_weight_th)
    n = real_lab.shape[0]
    m = (torch.stack([real_lab[:, 2], real_lab[:, 1]], dim=-1) + 128.0).clamp(0.0, 255.0)
    grid = (m.int().float() - 127.5) / 127.5  # (N, H, W, 2): x = b, y = a
    return F.grid_sample(weight.expand(n, 1, *weight.shape), grid, mode="nearest",
                         align_corners=False)


def lab_color_loss(fake: torch.Tensor, real: torch.Tensor, opt, mask: torch.Tensor = None,
                   ab_count: torch.Tensor = None, red=WHOLE) -> torch.Tensor:
    """Mean |ab(fake) - ab(real)| of (N,3,H,W) images in [-1,1]; with
    --balance_Lab and `ab_count`, weighted by the balance map inside `mask`
    (weight 1 outside)."""
    fake_lab = rgb_to_lab((fake + 1.0) / 2.0)
    real_lab = rgb_to_lab((real + 1.0) / 2.0).detach()
    diff = (fake_lab[:, 1:] - real_lab[:, 1:]).abs()
    if opt.balance_Lab and ab_count is not None:
        wm = _balance_weight_map(real_lab, ab_count, opt) * mask
        wm = torch.where(wm == 0, torch.ones_like(wm), wm)
        return red.mean(wm * diff)
    return red.mean(diff)


def rgb_background_l1_loss(fake: torch.Tensor, input_tag: torch.Tensor,
                           image_tag: torch.Tensor, red=WHOLE) -> torch.Tensor:
    """L1 outside the hair; channel 0 of the one-hot is the background."""
    bg = input_tag[:, 0:1]
    return red.mean((fake * bg - (image_tag * bg).detach()).abs())


def hair_avg_lab_loss(fake: torch.Tensor, real: torch.Tensor, mask_fake: torch.Tensor,
                      mask_real: torch.Tensor, opt, ab_count: torch.Tensor = None
                      ) -> torch.Tensor:
    """Mean |ab| difference of the average Lab colours of fake's hair
    (`mask_fake`) and real's (`mask_real`, no gradient) (loss.py:601-621);
    with --balance_Lab and `ab_count`, weighted by the balance map at the
    real average's (b, a) cell."""
    fake_avg = hair_avg(rgb_to_lab((fake + 1.0) / 2.0), mask_fake)
    real_avg = hair_avg(rgb_to_lab((real + 1.0) / 2.0), mask_real).detach()
    diff = (fake_avg[:, 1:] - real_avg[:, 1:]).abs()
    if opt.balance_Lab and ab_count is not None:
        return (_balance_weight_map(real_avg, ab_count, opt) * diff).mean()
    return diff.mean()


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """The VAE's KL divergence from the unit Gaussian, summed (loss.py:211-213)."""
    return -0.5 * torch.sum(1 + logvar - mu.pow(2) - logvar.exp())
