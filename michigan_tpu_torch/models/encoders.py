"""Encoders (port of michigan_tpu/models/encoders.py), NCHW: the VAE encoder
ConvEncoder (--use_vae); the generator's appearance encoders, ImageEncoder3
(--Image_encoder_mode partialconv, the flagship's), ImageEncoder (norm) and
ImageEncoder2 (instance); and its background encoders, BackgroundEncode2
(--noise_background, the flagship's) and BackgroundEncode (without it)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import Conv2d, ConvBlock, Linear, PartialConv
from michigan_tpu_torch.models.normalization import NonSpadeNorm
from michigan_tpu_torch.ops.norms import instance_norm
from michigan_tpu_torch.ops.resize import (
    dilate_mask,
    max_pool_same,
    resize_bilinear,
    resize_nearest,
)
from michigan_tpu_torch.ops.stats import masked_region_mean


def norm_layers(module: nn.Module, opt, chans, group=None) -> None:
    """layer1 .. layer<len(chans) - 1> of `module`: 3x3 stride-2 --norm_E
    layers (NonSpadeNorm) from chans[i - 1] to chans[i] channels."""
    for i in range(1, len(chans)):
        setattr(module, f"layer{i}",
                NonSpadeNorm(chans[i - 1], chans[i], 3, 2, 1, opt.norm_E, group))


def run_layers(module: nn.Module, y: torch.Tensor, n: int) -> torch.Tensor:
    """layer1 .. layer<n> of `module` with a leaky ReLU (0.2) after each."""
    for i in range(1, n + 1):
        y = F.leaky_relu(getattr(module, f"layer{i}")(y), 0.2)
    return y


class ConvEncoder(nn.Module):
    """The VAE encoder (encoder.py:17-59): the image resized bilinearly to
    256^2, 5 stride-2 3x3 --norm_E layers (6 from a 256^2 crop up), leaky
    ReLU, flattened in NCHW order, then fc_mu and fc_var to 256 each.
    The model runs it in eval mode, as the JAX package applies it: sigma
    from the stored spectral u / v, which it never writes."""

    def __init__(self, opt, group=None):
        super().__init__()
        ndf = opt.ngf
        self.n_layers = 6 if opt.crop_size >= 256 else 5
        norm_layers(self, opt, [3, ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 8, ndf * 8]
                    [:self.n_layers + 1], group)
        s0 = 256 // 2 ** self.n_layers
        self.fc_mu = Linear(ndf * 8 * s0 * s0, 256)
        self.fc_var = Linear(ndf * 8 * s0 * s0, 256)

    def forward(self, x: torch.Tensor):
        """(mu, logvar), each (N, 256)."""
        y = run_layers(self, resize_bilinear(x, (256, 256)), self.n_layers).flatten(1)
        return self.fc_mu(y), self.fc_var(y)


class ImageEncoder(nn.Module):
    """Appearance encoder, mode 'norm' (encoder.py:61-105; JAX
    encoders.py:61-95): the ref image resized bilinearly to 256^2, 5
    stride-2 --norm_E layers with leaky ReLU, the global mean, then a 1x1
    conv ``fc`` to 16 ngf * sh * sw channels, read channel-major as the
    (16 ngf, sh, sw) latent.  The labels are not read."""

    def __init__(self, opt, sw: int, sh: int, group=None):
        super().__init__()
        ndf = opt.ngf
        self.sw, self.sh, self.nc = sw, sh, ndf * 16
        norm_layers(self, opt, [3, ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 16], group)
        self.fc = Conv2d(ndf * 16, ndf * 16 * sw * sh, 1)

    def forward(self, x, label_ref=None, label_tag=None):
        y = run_layers(self, resize_bilinear(x, (256, 256)), 5)
        y = self.fc(y.mean(dim=(2, 3), keepdim=True))
        return y.view(y.shape[0], self.nc, self.sh, self.sw)


class ImageEncoder2(nn.Module):
    """Appearance encoder, mode 'instance' (encoder.py:107-158; JAX
    encoders.py:97-132): 5 stride-2 --norm_E layers with leaky ReLU on the
    ref image as it comes, the mean over the ref's hair (over the whole
    plane under --ref_global_pool) broadcast into the tag's hair, nearest
    resized to the latent where the sizes differ."""

    def __init__(self, opt, sw: int, sh: int, group=None):
        super().__init__()
        ndf = opt.ngf
        self.sw, self.sh, self.global_pool = sw, sh, opt.ref_global_pool
        norm_layers(self, opt, [3, ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 16], group)

    def forward(self, x, label_ref, label_tag):
        y = run_layers(self, x, 5)
        size = y.shape[2:]
        lr = resize_nearest(label_ref, size)
        lt = resize_nearest(label_tag, size)
        pooled = y.mean(dim=(2, 3), keepdim=True) if self.global_pool else \
            masked_region_mean(y, lr)
        out = pooled.expand_as(y) * lt
        if self.sh != size[0]:
            out = resize_nearest(out, (self.sh, self.sw))
        return out


class ImageEncoder3(nn.Module):
    """Appearance encoder, mode 'partialconv' (encoder.py:160-225): 5 partial
    convs masked by the reference hair mask, hair-region average pooled and
    broadcast into the target hair mask."""

    def __init__(self, opt, sw: int, sh: int, group=None):
        super().__init__()
        ndf = opt.ngf
        self.sw, self.sh = sw, sh
        self.use_in = "instance" in opt.norm_ref_encode
        chans = [3, ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 16]
        for i in range(1, 6):
            setattr(self, f"layer{i}", PartialConv(chans[i - 1], chans[i], 3, 2, 1))

    def forward(self, x, label_ref, label_tag):
        mask, y = label_ref, x
        for i in range(1, 6):
            if i > 1:
                y = F.leaky_relu(y, 0.2)
            y, mask = getattr(self, f"layer{i}")(y, mask)
            if self.use_in:
                y = instance_norm(y)
        y = F.leaky_relu(y, 0.2)
        size = y.shape[2:]
        lr = resize_nearest(label_ref, size)
        lt = resize_nearest(label_tag, size)
        out = masked_region_mean(y, lr).expand_as(y) * lt
        if self.sh != size[0]:
            out = resize_bilinear(out, (self.sh, self.sw))
        return out


def _expanded_back_mask(opt, mask: torch.Tensor, extra_dilate_steps: int = 2):
    """Background mask with the hair mask dilated (encoder.py:288-316).
    `extra_dilate_steps` 3x3 dilations follow the base width in the
    train-time random expansion; 2 is its expectation."""
    hair = mask[:, 1:2]
    if opt.isTrain:
        if not opt.random_expand_mask:
            return mask[:, 0:1]
        th = int(hair.shape[2] * opt.random_expand_th)
        th = th if th % 2 == 1 else th + 1
        expanded = dilate_mask(hair, max(th - 4, 1))
        for _ in range(extra_dilate_steps):
            expanded = dilate_mask(expanded, 3)
        return 1.0 - expanded
    if opt.expand_mask_be:
        k = opt.expand_th
        if opt.add_feat_zeros:
            H = W = opt.crop_size
            r0 = opt.add_th // 2
            center = hair[:, :, r0 : r0 + H, r0 : r0 + W]
            center = max_pool_same(center, k, 1, int(k / 2))[:, :, :H, :W]
            expanded = torch.zeros_like(hair)
            expanded[:, :, r0 : r0 + H, r0 : r0 + W] = center
        else:
            expanded = dilate_mask(hair, k)
        return 1.0 - expanded
    return mask[:, 0:1]


class BackgroundEncode(nn.Module):
    """Background pyramid without noise (encoder.py:227-253), as the JAX
    package rebuilt it (encoders.py:171-210): the tag image through the
    pyramid of BackgroundEncode2, coarsest first, with the tag's background
    label (channel 0) at each scale.  Four levels, or under
    --num_upsampling_layers most five, from a stem of ngf // 2 channels at
    full resolution (conv0) and a stride-2 layer0 in place of conv1.  The
    reference's layer4 is never applied and is not built."""

    def __init__(self, opt):
        super().__init__()
        ngf = opt.ngf
        self.opt = opt
        self.most = opt.num_upsampling_layers == "most"
        if self.most:
            self.conv0 = ConvBlock(3, ngf // 2, 7, 1, 3)
            self.layer0 = ConvBlock(ngf // 2, ngf, 4, 2, 1)
        else:
            self.conv1 = ConvBlock(3, ngf, 7, 1, 3)
        self.layer1 = ConvBlock(ngf, 2 * ngf, 4, 2, 1)
        self.layer2 = ConvBlock(2 * ngf, 4 * ngf, 4, 2, 1)
        self.layer3 = ConvBlock(4 * ngf, 8 * ngf, 4, 2, 1)

    def pyramid(self, inp: torch.Tensor, back_mask: torch.Tensor):
        if self.most:
            x00 = self.conv0(inp)
            x0 = self.layer0(x00)
        else:
            x0 = self.conv1(inp)
        x1 = self.layer1(x0)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        h, w = back_mask.shape[2:]
        factors = (16, 8, 4, 2) if self.most else (8, 4, 2)
        bms = [resize_nearest(back_mask, (h // f, w // f)) for f in factors] + [back_mask]
        if self.most:
            return [x3, x2, x1, x0, x00], bms
        return [x3, x2, x1, x0], bms

    def forward(self, image, mask, noise=None, extra_dilate_steps: int = 2):
        return self.pyramid(image, mask[:, 0:1])


class BackgroundEncode2(BackgroundEncode):
    """Noise-background condition module (encoder.py:271-341): the pyramid
    of BackgroundEncode on the tag image with noise in place of the hair
    (widened by _expanded_back_mask), or on the noise alone under
    --random_noise_background, with that background mask at each scale."""

    def forward(self, image, mask, noise, extra_dilate_steps: int = 2):
        back_mask = _expanded_back_mask(self.opt, mask, extra_dilate_steps)
        if self.opt.random_noise_background:
            inp = noise
        else:
            inp = image * back_mask + noise * (1.0 - back_mask)
        return self.pyramid(inp.to(image.dtype), back_mask)
