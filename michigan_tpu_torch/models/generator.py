"""SPADEB generator (port of michigan_tpu/models/generator.py), NCHW.

  input_ref, input_tag  (N,label_nc,H,W) one-hot segmentations
  orient                (N,2,H,W) decoded (sin2t, cos2t)*mask (use_ig), or
                        (N,1,H,W) raw [0,255] dense orientation
  image_ref, image_tag  (N,3,H,W) in [-1,1]
  noise                 (N,3,H,W) noise pyramid in [0,1]
  z                     (N,z_dim) the VAE latent (--use_vae)
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.architecture import SPADEResnetBlock
from michigan_tpu_torch.models.encoders import (
    BackgroundEncode,
    BackgroundEncode2,
    ImageEncoder,
    ImageEncoder2,
    ImageEncoder3,
)
from michigan_tpu_torch.models.layers import Conv2d, Linear, checkpointed, cudnn_off
from michigan_tpu_torch.ops.masks import wide_edges_outer
from michigan_tpu_torch.ops.resize import resize_nearest, upsample2x_nearest

ENCODERS = {"norm": ImageEncoder, "instance": ImageEncoder2, "partialconv": ImageEncoder3}


def orient_to_two_channel(orient255: torch.Tensor, hair_mask: torch.Tensor) -> torch.Tensor:
    """Raw [0,255] orientation -> (sin 2t, cos 2t) * hair mask."""
    t = orient255 / 255.0 * math.pi
    return torch.cat([torch.sin(2 * t), torch.cos(2 * t)], dim=1) * hair_mask


# Blocks whose float32 convolutions run with cuDNN off in train mode on a
# card (models/layers.py: cudnn_off): at their channel counts (256 to 1024
# in, on planes of 64^2 and less) cuDNN's float32 implicit-GEMM forward errs
# 3-5x PyTorch's own im2col + GEMM against float64, and under the config's
# own init (xavier, gain 0.02) those errors carried through the step put the
# card's G step past the scale-aware rule against the CPU's
# (tools/conv_algorithms.py; chip_smoke.py phase 12).  head_0, G_middle and
# up_0 alone bring it under the rule with a thin margin; the two encoders
# widen it.  up_4 (--num_upsampling_layers most: 64 -> 32 channels at the
# output's side) stays on cuDNN: at 512^2, xavier, its convolutions' weight
# gradients flip one sign against float64 on cuDNN and one off it, and
# taking it off moves the G step card vs CPU from 60,476 to 62,898 elements
# beyond float noise (the limit 101,525).
CUDNN_OFF = ("fc", "backgroud_enc", "head_0", "G_middle_0", "G_middle_1", "up_0")
SPADE_BLOCKS = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3")


def check_most_sizes(opt) -> None:
    """Under --num_upsampling_layers most the latent is the generator's
    input side over 2^7 and seven 2x upsamplings must give that side back
    to meet the background encoder's pyramid; the JAX package fails on a
    shape mismatch where they do not (1024 + the default --add_th 64 gives
    a latent of 8 against an 1088^2 pyramid)."""
    if opt.num_upsampling_layers != "most":
        return
    side = opt.generator_input_size()
    if side % 128:
        what = "--crop_size + --add_th" if opt.add_feat_zeros else "--crop_size"
        raise ValueError(
            f"--num_upsampling_layers most needs {what} to be a multiple of 128, got {side} "
            f"(--crop_size {opt.crop_size}, --add_th {opt.add_th}, --add_feat_zeros "
            f"{opt.add_feat_zeros}); at --crop_size 1024 with --add_feat_zeros use --add_th 128")


def remat_block_names(opt) -> frozenset:
    """The SPADE blocks whose activations --remat recomputes in the backward
    (--remat_blocks: 'all' or a comma list); an unknown name raises, listing
    the valid ones, as the JAX package does (generator.py:122-136), even
    without --remat."""
    valid = set(SPADE_BLOCKS) | ({"up_4"} if opt.num_upsampling_layers == "most" else set())
    sel = opt.remat_blocks
    names = valid if sel == "all" else {s for s in sel.split(",") if s}
    unknown = names - valid
    if unknown:
        raise ValueError(f"--remat_blocks: unknown block(s) {sorted(unknown)}; "
                         f"valid: {sorted(valid)} or 'all'")
    return frozenset(names) if opt.remat else frozenset()


class SPADEBGenerator(nn.Module):
    """Seed ``fc``: under --use_vae a Linear from z; with --use_encoder the
    appearance encoder of --Image_encoder_mode (partialconv, norm or
    instance); else the ref image nearest resized to the latent and a 3x3
    conv (JAX generator.py:88-90) -> 7 SPADE blocks (8 under
    --num_upsampling_layers most: up_4, at the output's side) with 2x
    nearest upsampling -> per-scale background composite -> conv_img ->
    tanh.  The blocks' sync batch norms take the
    data-parallel `group` (None: this process's batch), as do the
    appearance encoder's sync batch norms (--norm_E).  The background
    features come from BackgroundEncode2 (--noise_background) or
    BackgroundEncode.  Under --orient_random_disturb the orientation's band
    just inside the hair's border is replaced by the noise's channel 0.

    With --remat, the blocks of --remat_blocks free their activations after
    a train-mode forward that records gradients and recompute them in the
    backward (``layers.checkpointed``), the JAX package's nn.remat."""

    def __init__(self, opt, group=None):
        super().__init__()
        check_most_sizes(opt)
        self.remat_blocks = remat_block_names(opt)
        self.opt = opt
        nf = opt.ngf
        sw, sh = opt.latent_size()
        # under --use_vae the seed is z's Linear whatever --use_encoder says,
        # as in the JAX package (generator.py:71-73)
        if opt.use_vae:
            self.fc = Linear(opt.z_dim, 16 * nf * sw * sh)
        elif opt.use_encoder:
            self.fc = ENCODERS[opt.Image_encoder_mode](opt, sw, sh, group)
        else:
            self.fc = Conv2d(3, 16 * nf, 3, padding=1)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, opt, group)
        self.G_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, opt, group)
        self.G_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, opt, group)
        self.up_0 = SPADEResnetBlock(16 * nf, 8 * nf, opt, group)
        self.up_1 = SPADEResnetBlock(8 * nf, 4 * nf, opt, group)
        self.up_2 = SPADEResnetBlock(4 * nf, 2 * nf, opt, group)
        self.up_3 = SPADEResnetBlock(2 * nf, 1 * nf, opt, group)
        if opt.num_upsampling_layers == "most":
            self.up_4 = SPADEResnetBlock(1 * nf, nf // 2, opt, group)
        self.conv_img = Conv2d(nf // 2 if opt.num_upsampling_layers == "most" else nf, 3, 3,
                               padding=1)
        self.backgroud_enc = (BackgroundEncode2 if opt.noise_background else BackgroundEncode)(opt)
        self.cudnn_off_blocks = CUDNN_OFF

    def block(self, name: str, *args):
        """self.<name>(*args), with cuDNN off in train mode for the blocks in
        ``cudnn_off_blocks`` (the recompute of a rematerialised block too),
        and rematerialised in train mode for those in ``remat_blocks`` when
        autograd records."""
        module = getattr(self, name)
        off = self.training and name in self.cudnn_off_blocks

        def run(*a):
            with cudnn_off(off):
                return module(*a)

        if self.training and name in self.remat_blocks and torch.is_grad_enabled():
            return checkpointed(module, run, *args)
        return run(*args)

    def forward(self, input_ref, input_tag, orient, image_ref, image_tag, noise,
                extra_dilate_steps: int = 2, z=None):
        """`extra_dilate_steps` (training with --random_expand_mask) is the
        number of 3x3 dilations added to the hair mask's base width; `z` the
        VAE latent, which --use_vae needs."""
        opt = self.opt
        seg = input_tag
        hair_mask = input_tag[:, 1:2]
        sw, sh = opt.latent_size()
        if opt.use_vae:
            x = self.fc(z).view(-1, 16 * opt.ngf, sh, sw)
        elif opt.use_encoder:
            x = self.block("fc", image_ref, input_ref[:, 1:2], hair_mask)
        else:
            x = self.block("fc", resize_nearest(image_ref, (sh, sw)))

        if not opt.no_orientation:
            o = orient if opt.use_ig else orient_to_two_channel(orient, hair_mask)
            if opt.orient_random_disturb:
                edges = wide_edges_outer(hair_mask, 5)
                o = o * (1 - edges) + edges * noise[:, 0:1]
            seg = torch.cat([seg, o.to(seg.dtype)], dim=1)

        back_feats, back_masks = self.block("backgroud_enc", image_tag, input_tag, noise,
                                            extra_dilate_steps)
        most = opt.num_upsampling_layers == "most"
        H, W = hair_mask.shape[2:]
        hair_masks = [resize_nearest(hair_mask, (H // f, W // f))
                      for f in ((16, 8, 4, 2) if most else (8, 4, 2))]
        hair_masks.append(hair_mask)

        def composite(xx, i):
            if opt.bf_direct_add:
                return back_feats[i] + xx
            return back_feats[i] * (1 - hair_masks[i]) + xx * (1 - back_masks[i])

        def clip(xx):
            return torch.where(xx > opt.clip_th, 0.0, xx) if opt.use_clip else xx

        x = self.block("head_0", x, seg)
        x = upsample2x_nearest(x)
        x = self.block("G_middle_0", x, seg)
        if opt.num_upsampling_layers in ("more", "most"):
            x = upsample2x_nearest(x)
        x = clip(self.block("G_middle_1", x, seg))
        for i, name in enumerate(("up_0", "up_1", "up_2", "up_3")):
            x = upsample2x_nearest(x)
            x = composite(clip(self.block(name, x, seg)), i)
        if most:  # up_4 is not clipped (JAX generator.py:185-188)
            x = composite(self.block("up_4", upsample2x_nearest(x), seg), 4)
        x = self.conv_img(F.leaky_relu(x, 0.2))
        return torch.tanh(x)
