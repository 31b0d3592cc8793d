"""SPADE residual block (port of michigan_tpu/models/architecture.py), NCHW."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import SpectralConv2d
from michigan_tpu_torch.models.normalization import SPADE


class SPADEResnetBlock(nn.Module):
    """2x (SPADE -> LeakyReLU(0.2) -> 3x3 conv) + a learned 1x1 shortcut when
    fin != fout.  Convs are spectral when opt.norm_G says so; the SPADE norms
    take the data-parallel `group`."""

    def __init__(self, fin: int, fout: int, opt, group=None):
        super().__init__()
        if opt.weight_norm_G:
            raise NotImplementedError("--weight_norm_G is not ported")
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        conv = SpectralConv2d if "spectral" in opt.norm_G else nn.Conv2d
        spade_cfg = opt.norm_G.replace("spectral", "")
        label_nc = opt.spade_label_nc()
        self.conv_0 = conv(fin, fmiddle, 3, padding=1)
        self.conv_1 = conv(fmiddle, fout, 3, padding=1)
        self.norm_0 = SPADE(spade_cfg, fin, label_nc, group=group)
        self.norm_1 = SPADE(spade_cfg, fmiddle, label_nc, group=group)
        if self.learned_shortcut:
            self.conv_s = conv(fin, fout, 1, bias=False)
            self.norm_s = SPADE(spade_cfg, fin, label_nc, group=group)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx
