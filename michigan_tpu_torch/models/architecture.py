"""SPADE residual block (port of michigan_tpu/models/architecture.py), NCHW."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import (
    Conv2d,
    SpectralConv2d,
    UnitNormConv2d,
    WeightNormConv2d,
)
from michigan_tpu_torch.models.normalization import SPADE


def block_conv(opt):
    """The class of a SPADE block's convs (JAX architecture.py:31-48):
    under --weight_norm_G weight-normed (--weight_norm_g 0: torch's
    weight_norm; 1: a weight normalised once), else spectral when --norm_G
    says so, else plain."""
    if opt.weight_norm_G:
        return WeightNormConv2d if opt.weight_norm_g == 0 else UnitNormConv2d
    return SpectralConv2d if "spectral" in opt.norm_G else Conv2d


class SPADEResnetBlock(nn.Module):
    """2x (SPADE -> LeakyReLU(0.2) -> 3x3 conv) + a learned 1x1 shortcut when
    fin != fout.  The convs are ``block_conv(opt)``; the SPADE norms take the
    data-parallel `group`, and under --weight_norm_G have no param-free
    norm."""

    def __init__(self, fin: int, fout: int, opt, group=None):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        conv = block_conv(opt)
        spade_cfg = opt.norm_G.replace("spectral", "")
        label_nc = opt.spade_label_nc()
        spade = lambda nc: SPADE(spade_cfg, nc, label_nc, group=group,
                                 weight_norm=opt.weight_norm_G)
        self.conv_0 = conv(fin, fmiddle, 3, padding=1)
        self.conv_1 = conv(fmiddle, fout, 3, padding=1)
        self.norm_0 = spade(fin)
        self.norm_1 = spade(fmiddle)
        if self.learned_shortcut:
            self.conv_s = conv(fin, fout, 1, bias=False)
            self.norm_s = spade(fin)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx
