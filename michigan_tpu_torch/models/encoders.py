"""Encoders (port of michigan_tpu/models/encoders.py), NCHW: the VAE encoder
ConvEncoder (--use_vae), and the flagship path's condition modules, the
partial-conv appearance encoder ImageEncoder3 and the noise background
encoder BackgroundEncode2."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import ConvBlock, Linear, PartialConv
from michigan_tpu_torch.models.normalization import NonSpadeNorm
from michigan_tpu_torch.ops.norms import instance_norm
from michigan_tpu_torch.ops.resize import (
    dilate_mask,
    max_pool_same,
    resize_bilinear,
    resize_nearest,
)
from michigan_tpu_torch.ops.stats import masked_region_mean


class ConvEncoder(nn.Module):
    """The VAE encoder (encoder.py:17-59): the image resized bilinearly to
    256^2, 5 stride-2 3x3 --norm_E layers (6 from a 256^2 crop up), leaky
    ReLU, flattened in NCHW order, then fc_mu and fc_var to 256 each.
    The model runs it in eval mode, as the JAX package applies it: sigma
    from the stored spectral u / v, which it never writes."""

    def __init__(self, opt):
        super().__init__()
        ndf = opt.ngf
        self.n_layers = 6 if opt.crop_size >= 256 else 5
        chans = [3, ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 8, ndf * 8]
        for i in range(1, self.n_layers + 1):
            setattr(self, f"layer{i}", NonSpadeNorm(chans[i - 1], chans[i], 3, 2, 1, opt.norm_E))
        s0 = 256 // 2 ** self.n_layers
        self.fc_mu = Linear(ndf * 8 * s0 * s0, 256)
        self.fc_var = Linear(ndf * 8 * s0 * s0, 256)

    def forward(self, x: torch.Tensor):
        """(mu, logvar), each (N, 256)."""
        y = resize_bilinear(x, (256, 256))
        for i in range(1, self.n_layers + 1):
            if i > 1:
                y = F.leaky_relu(y, 0.2)
            y = getattr(self, f"layer{i}")(y)
        y = F.leaky_relu(y, 0.2).flatten(1)
        return self.fc_mu(y), self.fc_var(y)


class ImageEncoder3(nn.Module):
    """Appearance encoder, mode 'partialconv' (encoder.py:160-225): 5 partial
    convs masked by the reference hair mask, hair-region average pooled and
    broadcast into the target hair mask."""

    def __init__(self, opt, sw: int, sh: int):
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


class BackgroundEncode2(nn.Module):
    """Noise-background condition module (encoder.py:271-341).  Returns the
    feature pyramid coarsest-first, with the background mask at each scale:
    four levels, or under --num_upsampling_layers most five, from a stem of
    ngf // 2 channels at full resolution (conv0) and a stride-2 layer0 in
    place of conv1.  The reference's layer4 is never applied and is not
    built."""

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

    def forward(self, image, mask, noise, extra_dilate_steps: int = 2):
        back_mask = _expanded_back_mask(self.opt, mask, extra_dilate_steps)
        if self.opt.random_noise_background:
            inp = noise
        else:
            inp = image * back_mask + noise * (1.0 - back_mask)
        inp = inp.to(image.dtype)
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
