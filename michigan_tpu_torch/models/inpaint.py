"""Orientation inpainting generators IG and SIG (port of
michigan_tpu/models/inpaint.py), NCHW.

Reflect-pad 7x7 spectral conv encoder to 256 channels at 1/4 resolution, 12
dilated spectral resblocks + self-attention (concatenated -> 512 channels),
spectral transposed-conv decoder, (tanh + 1) / 2.  IG takes 4 input channels,
SIG 5 (+ the stroke mask).  Every instance norm (+ activation) is one
`fused_instance_norm` launch: 29 per forward.  With `epilogue`
(--use_pallas_epilogue) each resblock instead runs as two `conv3x3_in_act`
launches, conv included: 24 of those and 5 `fused_instance_norm` per
forward.  Module keys follow the reference's nn.Sequential indices
(encoder.1, middle.3.conv_block.5, decoder.0, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from michigan_tpu_torch.models.layers import (
    Conv2d,
    SpectralConv2d,
    SpectralConvTranspose2d,
    reflect_pad,
)
from michigan_tpu_torch.ops.cuda.epilogue import conv3x3_in_act
from michigan_tpu_torch.ops.cuda.spade import fused_instance_norm


class DilatedResnetBlock(nn.Module):
    """reflect2 -> spectral 3x3 dil2 -> IN+ReLU -> reflect1 -> spectral 3x3
    -> IN; residual add (generator.py:450-464).  With `epilogue`, each conv
    and the norm after it are one `conv3x3_in_act` call on the spectrally
    normalised float32 weight (the kernel casts it to x's dtype), as the JAX
    package's block does under --use_pallas_epilogue."""

    def __init__(self, dim: int, epilogue: bool = False):
        super().__init__()
        self.epilogue = epilogue
        self.conv_block = nn.ModuleDict({
            "1": SpectralConv2d(dim, dim, 3, dilation=2),
            "5": SpectralConv2d(dim, dim, 3),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2 = self.conv_block["1"], self.conv_block["5"]
        if self.epilogue:
            y = conv3x3_in_act(reflect_pad(x, 2), c1.weight(), c1.bias, dilation=2,
                               act="relu")
            return conv3x3_in_act(reflect_pad(y, 1), c2.weight(), c2.bias, residual=x)
        y = fused_instance_norm(c1(reflect_pad(x, 2)), act="relu")
        return x + fused_instance_norm(c2(reflect_pad(y, 1)))


class SelfAttention(nn.Module):
    """1x1 q/k/v, softmax over keys, output concatenated to the input
    (generator.py:467-485).  No 1/sqrt(d) scale, as in the reference."""

    def __init__(self, dim: int, downsample: int = 4):
        super().__init__()
        self.query_conv = Conv2d(dim, dim // downsample, 1)
        self.key_conv = Conv2d(dim, dim // downsample, 1)
        self.value_conv = Conv2d(dim, dim, 1)

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

    in_channels = 4

    def __init__(self, blocks: int = 12, epilogue: bool = False):
        super().__init__()
        in_channels = self.in_channels
        self.encoder = nn.ModuleDict({
            "1": SpectralConv2d(in_channels, 64, 7),
            "4": SpectralConv2d(64, 128, 4, 2, 1),
            "7": SpectralConv2d(128, 256, 4, 2, 1),
        })
        self.middle = nn.ModuleList(
            [DilatedResnetBlock(256, epilogue) for _ in range(blocks)] + [SelfAttention(256)]
        )
        self.decoder = nn.ModuleDict({
            "0": SpectralConvTranspose2d(512, 128, 4, 2, 1),
            "3": SpectralConvTranspose2d(128, 64, 4, 2, 1),
            "7": Conv2d(64, 3, 7),
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


class SInpaintGenerator(InpaintGenerator):
    """netSIG: input [orient RGB with noise (3), hole (1), stroke mask (1)]."""

    in_channels = 5
