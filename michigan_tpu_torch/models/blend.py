"""The blend generator (port of michigan_tpu/models/blend.py), NCHW.

The reference's ``Blend2Generator`` lost its class header in a bad merge
(generator.py:352-447), so --use_blender crashes upstream and there are no
released weights; this is the JAX package's working rebuild: a 7x7 stem on
[hair * mask + background * (1 - mask), mask], 3 stride-2 downs, 3
instance-norm resblocks, 3 skip-concatenated transposed-conv ups, a 7x7
head and tanh.  Every norm is the plain differentiable instance norm
(ops/norms.instance_norm, as the JAX package's), never the forward-only
fused_instance_norm kernel: the blender trains.  It has no buffers, so
train and eval mode compute the same.

State_dict keys: ``model1_conv`` ... ``model8_conv`` (model5-7 transposed,
weight (I, O, kh, kw)), ``model_middle.<i>.block0.conv`` and
``.block1.conv``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import ConvBlock, Conv2d, ConvTranspose2d, reflect_pad
from michigan_tpu_torch.ops.masks import wide_edges
from michigan_tpu_torch.ops.norms import instance_norm


class ResnetBlock2(nn.Module):
    """MaskGAN_networks.py:225-239: x + two 3x3 reflect ConvBlocks (instance
    norm; relu, then none)."""

    def __init__(self, dim: int):
        super().__init__()
        self.block0 = ConvBlock(dim, dim, 3, 1, 1, norm="in", activation="relu")
        self.block1 = ConvBlock(dim, dim, 3, 1, 1, norm="in", activation="none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block1(self.block0(x))


def _in_lrelu(y: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(instance_norm(y), 0.2)


class Blend2Generator(nn.Module):
    """blend(hair, background, mask, noise): `hair` the generator's fake (or
    the ref image under --only_blend), `background` the tag image, `mask`
    the one-hot tag labels (channel 1 is the hair) or the hair mask;
    --hair_random_disturb replaces a band around the hair's edge by `noise`."""

    def __init__(self, opt, ngf: int = 32):
        super().__init__()
        self.hair_random_disturb = opt.hair_random_disturb
        self.model1_conv = Conv2d(4, ngf, 7)
        self.model2_conv = Conv2d(ngf, ngf * 2, 3, 2, 1)
        self.model3_conv = Conv2d(ngf * 2, ngf * 4, 3, 2, 1)
        self.model4_conv = Conv2d(ngf * 4, ngf * 8, 3, 2, 1)
        self.model_middle = nn.ModuleList(ResnetBlock2(ngf * 8) for _ in range(3))
        up = lambda i, o: ConvTranspose2d(i, o, 3, 2, 1, output_padding=1)
        self.model5_conv = up(ngf * 16, ngf * 4)
        self.model6_conv = up(ngf * 8, ngf * 2)
        self.model7_conv = up(ngf * 4, ngf)
        self.model8_conv = Conv2d(ngf * 2, 3, 7)

    def forward(self, hair, background, mask, noise=None):
        hair_mask = mask[:, 1:2] if mask.shape[1] > 1 else mask
        x = hair * hair_mask + background * (1 - hair_mask)
        if self.hair_random_disturb and noise is not None:
            edges = wide_edges(hair_mask, th=5.0 / hair_mask.shape[2])
            x = x * (1 - edges) + noise * edges
        e1 = _in_lrelu(self.model1_conv(reflect_pad(torch.cat([x, hair_mask], dim=1), 3)))
        e2 = _in_lrelu(self.model2_conv(e1))
        e3 = _in_lrelu(self.model3_conv(e2))
        e4 = _in_lrelu(self.model4_conv(e3))
        em = e4
        for block in self.model_middle:
            em = block(em)
        e5 = _in_lrelu(self.model5_conv(torch.cat([em, e4], dim=1)))
        e6 = _in_lrelu(self.model6_conv(torch.cat([e5, e3], dim=1)))
        e7 = _in_lrelu(self.model7_conv(torch.cat([e6, e2], dim=1)))
        out = self.model8_conv(reflect_pad(torch.cat([e7, e1], dim=1), 3))
        return torch.tanh(out)
