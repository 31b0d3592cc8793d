"""Orientation inpainting generator IG (port of
michigan_tpu/models/inpaint.py), NCHW.

Reflect-pad 7x7 spectral conv encoder to 256 channels at 1/4 resolution, 12
dilated spectral resblocks + self-attention (concatenated -> 512 channels),
spectral transposed-conv decoder, (tanh + 1) / 2.  Every instance norm (+
activation) is one `fused_instance_norm` launch: 29 per forward.  Module
keys follow the reference's nn.Sequential indices (encoder.1, middle.3.
conv_block.5, decoder.0, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from michigan_tpu_torch.models.layers import (
    SpectralConv2d,
    SpectralConvTranspose2d,
    reflect_pad,
)
from michigan_tpu_torch.ops.cuda.spade import fused_instance_norm


class DilatedResnetBlock(nn.Module):
    """reflect2 -> spectral 3x3 dil2 -> IN+ReLU -> reflect1 -> spectral 3x3
    -> IN; residual add (generator.py:450-464)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.ModuleDict({
            "1": SpectralConv2d(dim, dim, 3, dilation=2),
            "5": SpectralConv2d(dim, dim, 3),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_block["1"](reflect_pad(x, 2))
        y = fused_instance_norm(y, act="relu")
        y = self.conv_block["5"](reflect_pad(y, 1))
        return x + fused_instance_norm(y)


class SelfAttention(nn.Module):
    """1x1 q/k/v, softmax over keys, output concatenated to the input
    (generator.py:467-485).  No 1/sqrt(d) scale, as in the reference."""

    def __init__(self, dim: int, downsample: int = 4):
        super().__init__()
        self.query_conv = nn.Conv2d(dim, dim // downsample, 1)
        self.key_conv = nn.Conv2d(dim, dim // downsample, 1)
        self.value_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        q = self.query_conv(x).flatten(2)  # (n, c', hw)
        k = self.key_conv(x).flatten(2)
        v = self.value_conv(x).flatten(2)  # (n, c, hw)
        att = torch.softmax(torch.bmm(q.transpose(1, 2), k), dim=-1)  # (n, hw, hw)
        out = torch.bmm(v, att.transpose(1, 2)).view(n, c, h, w)
        return torch.cat([x, out], dim=1)


class InpaintGenerator(nn.Module):
    """netIG: input [orient RGB with noise (3), hole (1)] at 256^2."""

    def __init__(self, in_channels: int = 4, blocks: int = 12):
        super().__init__()
        self.encoder = nn.ModuleDict({
            "1": SpectralConv2d(in_channels, 64, 7),
            "4": SpectralConv2d(64, 128, 4, 2, 1),
            "7": SpectralConv2d(128, 256, 4, 2, 1),
        })
        self.middle = nn.ModuleList(
            [DilatedResnetBlock(256) for _ in range(blocks)] + [SelfAttention(256)]
        )
        self.decoder = nn.ModuleDict({
            "0": SpectralConvTranspose2d(512, 128, 4, 2, 1),
            "3": SpectralConvTranspose2d(128, 64, 4, 2, 1),
            "7": nn.Conv2d(64, 3, 7),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_instance_norm(self.encoder["1"](reflect_pad(x, 3)), act="lrelu")
        y = fused_instance_norm(self.encoder["4"](y), act="lrelu")
        y = fused_instance_norm(self.encoder["7"](y), act="lrelu")
        for block in self.middle:
            y = block(y)
        y = fused_instance_norm(self.decoder["0"](y), act="relu")
        y = fused_instance_norm(self.decoder["3"](y), act="relu")
        y = self.decoder["7"](reflect_pad(y, 3))
        return (torch.tanh(y) + 1.0) / 2.0
