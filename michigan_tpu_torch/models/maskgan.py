"""MaskGAN / pix2pixHD auxiliary networks (port of michigan_tpu/models/maskgan.py;
reference MaskGAN_networks.py), NCHW.

``FeatureEncoder`` is netFE (--use_instance_feat), whose instance-wise
average (a quadruple Python loop upstream, MaskGAN_networks.py:36-49) is a
one-hot segment mean over the instance ids.  As in the JAX package netFE is
built, seeded, optimised with netG and checkpointed, and no path runs it.
StyleEncoder, LabelEncoder, SFTLayer, adaptive_instance_norm, LayerNorm2d
and LinearBlock are the reference's blocks that no path calls either.

The JAX modules take their input channels from their inputs; these take
them as arguments.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import Conv2d, ConvBlock, ConvTranspose2d, Linear
from michigan_tpu_torch.ops.norms import instance_norm


def instance_wise_avg(feat: torch.Tensor, inst: torch.Tensor, num_ids: int) -> torch.Tensor:
    """Each instance's region replaced by its per-channel mean: feat
    (N,C,H,W), inst (N,1,H,W) integer ids, clipped to [0, num_ids)."""
    n, c, h, w = feat.shape
    ids = inst[:, 0].long().clamp(0, num_ids - 1).reshape(n, -1)
    onehot = F.one_hot(ids, num_ids).to(feat.dtype)               # (N, HW, K)
    f = feat.reshape(n, c, -1)
    sums = torch.einsum("npk,ncp->nkc", onehot, f)
    means = sums / onehot.sum(dim=1).unsqueeze(-1).clamp_min(1.0)
    return torch.einsum("npk,nkc->ncp", onehot, means).reshape(n, c, h, w)


class FeatureEncoder(nn.Module):
    """netFE (MaskGAN_networks.py:14-49): a reflect-padded 7x7 stem, 4
    stride-2 downs, 4 transposed ups, each with instance norm and ReLU, a
    reflect-padded 7x7 tanh head, then the instance-wise average."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsampling: int = 4, max_instance_ids: int = 32):
        super().__init__()
        self.n_downsampling, self.max_instance_ids = n_downsampling, max_instance_ids
        self.stem = Conv2d(input_nc, ngf, 7)
        for i in range(n_downsampling):
            mult = 2 ** i
            setattr(self, f"down{i}", Conv2d(ngf * mult, ngf * mult * 2, 3, 2, 1))
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            setattr(self, f"up{i}", ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, 2, 1,
                                                    output_padding=1))
        self.head = Conv2d(ngf, output_nc, 7)

    def forward(self, x: torch.Tensor, inst: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.stem(F.pad(x, (3, 3, 3, 3), mode="reflect"))))
        for name in [f"down{i}" for i in range(self.n_downsampling)] + \
                [f"up{i}" for i in range(self.n_downsampling)]:
            y = F.relu(instance_norm(getattr(self, name)(y)))
        y = torch.tanh(self.head(F.pad(y, (3, 3, 3, 3), mode="reflect")))
        return instance_wise_avg(y, inst, self.max_instance_ids)


class SFTLayer(nn.Module):
    """Spatial feature transform (MaskGAN_networks.py:242-253): x * scale +
    shift, each two 1x1 convs of the condition with a leaky ReLU (0.1)."""

    def __init__(self, dim: int, cond_nc: int):
        super().__init__()
        self.scale_conv1 = Conv2d(cond_nc, dim, 1)
        self.scale_conv2 = Conv2d(dim, dim, 1)
        self.shift_conv1 = Conv2d(cond_nc, dim, 1)
        self.shift_conv2 = Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        s = self.scale_conv2(F.leaky_relu(self.scale_conv1(cond), 0.1))
        t = self.shift_conv2(F.leaky_relu(self.shift_conv1(cond), 0.1))
        return x * s + t


class StyleEncoder(nn.Module):
    """MaskGAN_networks.py:54-87: a 7x7 stem, two stride-2 4x4 downs that
    double the width, an SFT on `cond1`, n_downsample - 2 more downs, an SFT
    on `cond2`, the global mean and a 1x1 conv to style_dim."""

    def __init__(self, n_downsample: int, input_nc: int, dim: int, style_dim: int,
                 cond_nc: int, norm: str = "none", activ: str = "relu",
                 pad_type: str = "reflect"):
        super().__init__()
        block = lambda i, o, k, s, p: ConvBlock(i, o, k, s, p, norm, activ, pad_type)
        self.n_mid = n_downsample - 2
        self.stem = block(input_nc, dim, 7, 1, 3)
        for i in range(2):
            setattr(self, f"down{i}", block(dim, 2 * dim, 4, 2, 1))
            dim *= 2
        self.sft1 = SFTLayer(dim, cond_nc)
        for i in range(self.n_mid):
            setattr(self, f"mid{i}", block(dim, dim, 4, 2, 1))
        self.sft2 = SFTLayer(dim, cond_nc)
        self.fc = Conv2d(dim, style_dim, 1)

    def forward(self, x, cond1, cond2):
        y = self.down1(self.down0(self.stem(x)))
        y = self.sft1(y, cond1)
        for i in range(self.n_mid):
            y = getattr(self, f"mid{i}")(y)
        y = self.sft2(y, cond2)
        return self.fc(y.mean(dim=(2, 3), keepdim=True))


class LabelEncoder(nn.Module):
    """MaskGAN_networks.py:91-110: returns (the features after the second
    down, before its activation; the final features)."""

    def __init__(self, n_downsample: int, input_nc: int, dim: int, norm: str = "none",
                 activ: str = "relu", pad_type: str = "reflect"):
        super().__init__()
        block = lambda i, o, act: ConvBlock(i, o, 4, 2, 1, norm, act, pad_type)
        self.n_last = n_downsample - 3
        self.stem = ConvBlock(input_nc, dim, 7, 1, 3, norm, activ, pad_type)
        self.down0 = block(dim, 2 * dim, activ)
        self.down1 = block(2 * dim, 4 * dim, "none")
        d = 4 * dim
        for i in range(self.n_last):
            setattr(self, f"last{i}", block(d, d, activ))
        self.last_final = block(d, d, "none")

    def forward(self, x):
        fea = self.down1(self.down0(self.stem(x)))
        y = F.relu(fea)
        for i in range(self.n_last):
            y = getattr(self, f"last{i}")(y)
        return fea, self.last_final(y)


def adaptive_instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """AdaIN (MaskGAN_networks.py:281-310): the instance norm of x, then the
    given per-channel scale and bias."""
    return instance_norm(x, eps) * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


class LayerNorm2d(nn.Module):
    """MaskGAN_networks.py:312-339 as the JAX package computes it: each
    sample normalised over (C, H, W) by its mean and its biased standard
    deviation plus eps, then an optional per-channel gamma (drawn U[0, 1) at
    construction) and beta (0)."""

    def __init__(self, num_features: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.affine, self.eps = affine, eps
        if affine:
            self.gamma = nn.Parameter(torch.rand(num_features))
            self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.flatten(1)
        shape = (-1, 1, 1, 1)
        y = (x - flat.mean(dim=1).view(shape)) / (flat.std(dim=1, unbiased=False).view(shape)
                                                  + self.eps)
        if self.affine:
            y = y * self.gamma.view(1, -1, 1, 1) + self.beta.view(1, -1, 1, 1)
        return y


class LinearBlock(nn.Module):
    """MaskGAN_networks.py:176-221: a Linear, then norm 'none' or 'ln' (over
    the features, biased standard deviation plus 1e-5), then act 'relu',
    'lrelu' (0.2), 'tanh' or 'none'."""

    def __init__(self, in_features: int, features: int, norm: str = "none",
                 activation: str = "relu"):
        super().__init__()
        if norm not in ("none", "ln") or activation not in ConvBlock.ACTS:
            raise ValueError(f"LinearBlock norm {norm!r}, activation {activation!r}")
        self.norm, self.activation = norm, activation
        self.fc = Linear(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x)
        if self.norm == "ln":
            y = (y - y.mean(dim=-1, keepdim=True)) / (y.std(dim=-1, keepdim=True,
                                                           unbiased=False) + 1e-5)
        return ConvBlock.ACTS[self.activation](y)
