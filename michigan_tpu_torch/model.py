"""MichiGAN orchestration (port of michigan_tpu/model.py), NCHW.

  preprocess(batch)          one-hot labels (+ instance edges, --no_instance False)
  inpaint_orient(...)        IG orientation inpainting (pix2pix_model.py:407-429)
  inpaint_stroke_orient(...) SIG stroke inpainting (pix2pix_model.py:431-464)
  encode_z(image, eps)       the VAE's z, mu, logvar (--use_vae)
  generate_fake(...)         VAE + zeros-pad + netG + netB (pix2pix_model.py:495-541)
  infer(batch, mode)         the 'inference' mode (pix2pix_model.py:80-120)
  discriminate(...)          fake and real as one D batch, split (:546-594);
                             netD2 in the unpaired stage
  generator_loss(...)        the G losses of either stage (:257-365)
  discriminator_loss(...)    D's (or D2's) hinge on the recomputed fake (:367-398)

A batch is a dict of NCHW float32 tensors on the model's device with the keys
of ``michigan_tpu.data.single_inference_data`` (or ``demo_inference_data``
for a stroke edit, or the training loader's); ``batch_from_numpy`` turns
NHWC numpy arrays into one.  The inference paths of the flagship and demo
configurations, the paired training stage, and the VAE (--use_vae), blender
(--use_blender, --only_blend) and unpaired two-stage (--unpairTrain)
configurations are ported, under either dtype, with every model option
of the JAX package (appearance encoders, seeds, background encoders,
norms, discriminators, netFE); ``check_supported`` names what is not.

The training stage (``stage``) is --curr_step under --unpairTrain, read on
each call, else 1: stage 2 (unpaired ref) discriminates with netD2, drops
every paired term and the VGG towers, and adds hairAvgLab and background.
The VAE's noise eps is an argument: ``draw_eps`` draws it from one CPU
``torch.Generator`` seeded by --seed (the same numbers on the card and the
CPU), and the training step hands the G step's draw to its D step, as the
JAX package passes one rng to both.

The compute policy (--dtype, the JAX package's ``compute_dtype``): under
bfloat16 the generator's six inputs are cast to bfloat16 after the zeros
pad and the fake comes back float32; the IG / SIG input is cast to bfloat16
and their output back to float32, while orientation decoding and
compositing stay float32; the frozen inpainters store every floating
parameter and buffer in bfloat16 (``compact_frozen_nets``), netG keeps
float32 parameters, which each conv casts to its input's dtype
(models/layers.py).  In training, netD keeps float32 parameters too and
takes the fake-and-real batch in bfloat16; VGG19 is stored in bfloat16 and
takes the fake's and the tag / ref batch in bfloat16; the losses upcast
inside their reductions; Adam updates the float32 parameters from float32
gradients; the bank of the orientation loss takes bf16 operands unless
--orient_bank_fp32 (losses/orient.py).  netE takes the float32 image and
runs in float32, so under --use_vae z, netG's Linear seed and the SPADE
blocks after it stay float32, as the JAX package's generator takes z
(only the background encoder runs bfloat16 there); netB takes its four
inputs in the compute dtype and returns a float32 blend; netD2 takes the
stage-2 batch in the compute dtype, as netD does.

With --isTrain netG, netB and netD (netD2) are in train mode.  Which forward
writes buffers follows the JAX package: netG's batch-norm running statistics
and spectral u / v are written by the G step's forward only; the D step's
recompute of the fake uses train-mode statistics and writes nothing; netD's
and netD2's spectral u / v are never written (each step iterates again from
the stored ones).  netE trains but runs in eval mode, as the JAX package
applies it: sigma from its stored u / v, never iterated or written.  netIG
and VGG19 are frozen (eval mode, no gradient).  netD's and netD2's batch
norms (--norm_D) normalise with the batch's statistics and never write
their running statistics, a batch-norm netE (--norm_E) normalises with its
running statistics, and the appearance encoder's batch norms inside netG
write theirs in the G step only, as netG's SPADE norms do.  netFE
(--use_instance_feat) is built, seeded, in G's optimizer and checkpointed,
and no path runs it, as in the JAX package.

Under --reuse_fake_for_d (not with --use_blender) the D step takes the G
step's fake, detached, and does not recompute it (JAX model.py:511-537):
D trains against the image of netG before its update.

Under --netD n_layer netD is one NLayerDiscriminator, whose output is one
list of features rather than a list of lists; ``discriminate`` splits it
as the JAX package's does (see there), and the losses read the pieces as
the JAX package's losses do.

The G and D losses take `bands` (parallel/spatial.py ``Bands``; the paired
stage in row bands over the ranks of one spatial group): then the batch is
this rank's band of rows, netG and the orientation run in bands, netD runs
whole on every rank on the gathered planes, and each term is this rank's
share of the one process's, through the reductions of losses/reduce.py.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from michigan_tpu_torch.losses import color as color_losses
from michigan_tpu_torch.losses.feat import gan_feat_loss
from michigan_tpu_torch.losses.gan import multiscale_gan_loss
from michigan_tpu_torch.losses.orient import orient_loss
from michigan_tpu_torch.losses.perceptual import (
    style_content_loss_from_features,
    vgg_loss_from_features,
)
from michigan_tpu_torch.losses.reduce import WHOLE
from michigan_tpu_torch.models.blend import Blend2Generator
from michigan_tpu_torch.models.discriminator import define_D
from michigan_tpu_torch.models.encoders import ConvEncoder
from michigan_tpu_torch.models.generator import SPADEBGenerator, orient_to_two_channel
from michigan_tpu_torch.models.inpaint import InpaintGenerator, SInpaintGenerator
from michigan_tpu_torch.models.layers import checkpointed, frozen_buffers, init_weights
from michigan_tpu_torch.models.maskgan import FeatureEncoder
from michigan_tpu_torch.models.vgg import VGG19, load_vgg19
from michigan_tpu_torch.ops.masks import instance_edges, one_hot_label
from michigan_tpu_torch.ops.resize import resize_nearest

GEN_KEYS = ("input_ref", "input_tag", "orient", "image_ref", "image_tag", "noise")
FROZEN_NETS = ("netIG", "netSIG", "vgg")
# netG, then every net by name, in the order init_weights draws them: the
# nets of the VAE, blender and unpair configs last, so that they leave every
# other net's seeded weights as they were, and netFE after them
NET_NAMES = ("netG", "netIG", "netSIG", "netD", "vgg", "netE", "netB", "netD2", "netFE")
Z_NC = 256  # ConvEncoder's mu / logvar width (encoder.py:57-58)


def check_supported(opt) -> None:
    """Raise for flags whose code paths are not ported, and for the
    combinations the JAX package cannot run."""
    unported = []
    if opt.only_blend and not opt.use_blender:
        unported.append("--only_blend without --use_blender (the JAX package returns no image)")
    if opt.use_blender and opt.add_feat_zeros:
        unported.append("--use_blender with --add_feat_zeros (the JAX package's blender "
                        "takes the unpadded planes and fails on the padded fake)")
    if opt.dtype not in ("float32", "bfloat16"):
        unported.append(f"--dtype {opt.dtype}")
    if opt.netG != "spadeb" or (opt.use_ig and opt.netIG != "inpaint") or \
            (opt.use_stroke and opt.netSIG != "sinpaint"):
        unported.append("a netG other than spadeb, a netIG other than inpaint or a "
                        "netSIG other than sinpaint")
    if opt.isTrain:
        if opt.fused_step:
            unported.append("--fused_step (one XLA program of the G and D steps; the port "
                            "runs eagerly)")
        if opt.curr_step not in (1, 2):
            unported.append(f"--curr_step {opt.curr_step}")
        if opt.only_blend and opt.unpairTrain:
            unported.append("--only_blend with --unpairTrain (the JAX package's unpaired "
                            "stage needs the generator's fake, which --only_blend skips)")
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")


def batch_from_numpy(data: Dict, device) -> Dict[str, torch.Tensor]:
    """NHWC numpy arrays (as single_inference_data returns them) -> NCHW
    float32 tensors on `device`; non-image entries are dropped."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        .permute(0, 3, 1, 2).contiguous().to(device)
        for k, v in data.items()
        if isinstance(v, np.ndarray) and v.ndim == 4
    }


class MichiGANModel:
    """Holds the nets of one configuration on one device: netG, netIG /
    netSIG, netE (--use_vae), netB (--use_blender), and with --isTrain netD,
    netD2 (--unpairTrain) and the frozen VGG19; netFE under
    --use_instance_feat.  The device is the card unless the caller asks
    for the CPU.  `group` is the data-parallel process group of a replica
    (parallel/dist.py; None with one process): the sync batch norms of
    netG, netD, netD2 and netE take their statistics over it, and the
    training step averages gradients and losses over it."""

    def __init__(self, opt, device="cuda", group=None):
        check_supported(opt)
        self.opt = opt
        self.device = torch.device(device)
        self.group = group
        self.compute_dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
        self.netG = SPADEBGenerator(opt, group).train(opt.isTrain)
        epilogue = opt.use_pallas_epilogue
        self.netIG = InpaintGenerator(epilogue=epilogue).eval() if opt.use_ig else None
        self.netSIG = SInpaintGenerator(epilogue=epilogue).eval() if opt.use_stroke else None
        self.netD = define_D(opt, group) if opt.isTrain else None
        self.vgg = VGG19().eval() if opt.isTrain else None
        self.netE = ConvEncoder(opt, group).eval() if opt.use_vae else None
        self.netB = Blend2Generator(opt).train(opt.isTrain) if opt.use_blender else None
        self.netD2 = define_D(opt, group) if opt.isTrain and opt.unpairTrain else None
        self.netFE = FeatureEncoder(opt.feat_input_nc, opt.feat_num, opt.nef) \
            if opt.use_instance_feat else None
        for frozen in (self.netIG, self.netSIG, self.vgg):
            if frozen is not None:
                frozen.requires_grad_(False)
        if opt.isTrain and opt.fix_netG:  # outside G's optimizer (training/state.py)
            self.netG.requires_grad_(False)
        self.eps_gen = torch.Generator().manual_seed(opt.seed)
        self.ab_count = None
        if opt.isTrain and opt.balance_Lab and os.path.exists(opt.weight_dir):
            self.ab_count = color_losses.load_ab_count(opt.weight_dir, self.device)

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {k: getattr(self, k) for k in NET_NAMES if getattr(self, k) is not None}

    def stage(self, curr_step: Optional[int] = None) -> int:
        """The training stage: `curr_step` (default --curr_step) under
        --unpairTrain, else 1 (the JAX package's step reads it the same way)."""
        s = self.opt.curr_step if curr_step is None else curr_step
        return s if self.opt.unpairTrain else 1

    def draw_eps(self, n: int) -> torch.Tensor:
        """(n, 256) standard normal noise for the VAE, from ``eps_gen``."""
        return torch.randn((n, Z_NC), generator=self.eps_gen).to(self.device)

    def init_weights(self, seed: int) -> None:
        """Seeded weights by --init_type (one CPU torch.Generator), VGG19's
        from a file or its fallback, then move the nets to the device."""
        gen = torch.Generator().manual_seed(seed)
        for name, net in self.nets().items():
            if name == "vgg":
                self.vgg_pretrained = load_vgg19(net, gen, self.opt.checkpoints_dir)
            else:
                init_weights(net, gen, self.opt.init_type, self.opt.init_variance)
        self.to_device()

    def load_state_dicts(self, states: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Load per-net state_dicts (reference key names), strictly."""
        for name, net in self.nets().items():
            net.load_state_dict(states[name], strict=True)
        self.to_device()

    def to_device(self) -> None:
        for net in self.nets().values():
            net.to(self.device)
        self.compact_frozen_nets()

    def compact_frozen_nets(self) -> None:
        """Under the bf16 policy, round every floating parameter and buffer
        of the frozen nets (IG, SIG, VGG19; spectral u and v included) to
        bfloat16 once, as the JAX package's compact_frozen_variables does;
        the inpainters' sigma is still computed in float32 from the rounded
        values.  Under float32 nothing changes."""
        if self.compute_dtype != torch.bfloat16:
            return
        for name in FROZEN_NETS:
            net = getattr(self, name)
            if net is not None:
                net.to(torch.bfloat16)

    # ------------------------------------------------------------------

    def preprocess(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        nc = self.opt.label_nc + (1 if self.opt.contain_dontcare_label else 0)
        out = dict(batch)
        out["input_ref"] = one_hot_label(batch["label_ref"], nc)
        out["input_tag"] = one_hot_label(batch["label_tag"], nc)
        if not self.opt.no_instance:  # the batch's (N,1,H,W) instance-id map
            out["input_tag"] = torch.cat([out["input_tag"], instance_edges(batch["instance"])],
                                         dim=1)
        return out

    def _run_ig(self, net: torch.nn.Module, inp: torch.Tensor) -> torch.Tensor:
        # the IG and SIG always run at 256^2 (nearest resize in and out), in
        # the compute dtype; what they return is float32
        size = self.opt.crop_size
        if size != 256 or inp.shape[2] != 256:
            inp = resize_nearest(inp, (256, 256))
        out = net(inp.to(self.compute_dtype)).float()
        if out.shape[2] != size:
            out = resize_nearest(out, (size, size))
        return out

    @staticmethod
    def _decode_orient_rgb(output: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """RGB [0,1] -> 2ch (sin2t, cos2t)*mask.  The RGB encoding stores cos
        in R and sin in G, so the channels swap."""
        two = (output[:, :2] - 0.5) * 2.0
        return torch.stack([two[:, 1], two[:, 0]], dim=1) * mask

    def inpaint_orient(self, hole, orient_rgb, noise, mask):
        """(inpainted orient RGB, 2ch orient)."""
        comp = orient_rgb * (1 - hole) + noise * hole
        output = self._run_ig(self.netIG, torch.cat([comp, hole], dim=1))
        output = output * hole + orient_rgb * (1 - hole)
        return output, self._decode_orient_rgb(output, mask)

    def inpaint_stroke_orient(self, hole, orient_rgb, noise, mask, stroke, stroke_mask,
                              mask_orient_rgb):
        """(inpainted orient RGB, 2ch orient) through SIG.  Where the hair
        mask has grown past the orientation map, the map is first prefilled
        through IG (the reference's two-stage branch)."""
        # a Python `if` on one scalar: one host sync per edit (the JAX
        # package compiles both branches under lax.cond instead)
        if bool((mask - mask_orient_rgb).max() != 0):
            orient_rgb, _ = self.inpaint_orient(mask - mask_orient_rgb, orient_rgb, noise,
                                                mask)
        comp = orient_rgb * (1 - hole) + noise * (hole - stroke_mask) + stroke * stroke_mask
        output = self._run_ig(self.netSIG, torch.cat([comp, hole, stroke_mask], dim=1))
        output = output * hole + orient_rgb * (1 - hole)
        return output, self._decode_orient_rgb(output, mask)

    def _zeros_pad(self, x: torch.Tensor) -> torch.Tensor:
        th = self.opt.add_th
        r = th // 2
        return F.pad(x, (r, th - r, r, th - r))

    def _padded_gen_inputs(self, pre, orient) -> Dict[str, torch.Tensor]:
        gin = {k: pre[k] for k in GEN_KEYS if k != "orient"}
        gin["orient"] = orient
        if self.opt.add_feat_zeros:
            gin = {k: self._zeros_pad(v) for k, v in gin.items()}
        return {k: v.to(self.compute_dtype) for k, v in gin.items()}

    def encode_z(self, image: torch.Tensor, eps: Optional[torch.Tensor] = None):
        """(z, mu, logvar): z = eps * exp(logvar / 2) + mu from netE on
        `image`, with eps from ``draw_eps`` unless given.  netE takes the
        image as it comes (float32 under either dtype), as the JAX package
        applies it."""
        mu, logvar = self.netE(image)
        if eps is None:
            eps = self.draw_eps(mu.shape[0])
        return eps * torch.exp(0.5 * logvar) + mu, mu, logvar

    def generate_fake(self, pre, orient, extra_dilate_steps: int = 2,
                      eps: Optional[torch.Tensor] = None):
        """(fake, kld, blend): netG's image (None under --only_blend); the
        weighted KLD (--use_vae, else None), whose z takes `eps`; netB's
        blend of the fake (of the ref image under --only_blend) into the tag
        image (--use_blender, else None)."""
        opt = self.opt
        z = kld = fake = blend = None
        if opt.use_vae:
            z, mu, logvar = self.encode_z(pre["image_ref"], eps)
            kld = color_losses.kld_loss(mu, logvar) * opt.lambda_kld
        if not opt.only_blend:
            gin = self._padded_gen_inputs(pre, orient)
            fake = self.netG(*(gin[k] for k in GEN_KEYS), extra_dilate_steps, z=z).float()
        if opt.use_blender:
            src = pre["image_ref"] if opt.only_blend else fake
            cdt = self.compute_dtype
            blend = self.netB(src.to(cdt), pre["image_tag"].to(cdt), pre["input_tag"].to(cdt),
                              pre["noise"].to(cdt)).float()
        return fake, kld, blend

    # ------------------------------------------------------------------
    # training, the paired stage (pix2pix_model.py:257-398, 546-594)
    # ------------------------------------------------------------------

    def discriminate(self, input_tag, fake_image, real_image, orient, stage: int = 1):
        """Fake and real through netD (netD2 in stage 2) as one batch (so its
        norms and spectral iteration see both), in the compute dtype, then
        split; the features stay in it (the losses upcast).  The
        discriminators' buffers are never written (models/discriminator.py).

        The split is the JAX package's ``[[t[:n] for t in scale] for scale
        in out]`` (model.py:372-373).  For --netD multiscale each `scale` is
        a list of features, each split along the batch.  For --netD n_layer
        `out` is one list of features, so each `scale` is one feature and
        `t` runs over its 2n samples, each in JAX's (H, W, C) layout, and
        t[:n] / t[n:] take its first n rows / the rest: what the losses then
        read (losses/gan.py, losses/feat.py)."""
        if not self.opt.use_ig:
            orient = orient_to_two_channel(orient, input_tag[:, 1:2])
        both = torch.cat([torch.cat([input_tag, orient, fake_image], dim=1),
                          torch.cat([input_tag, orient, real_image], dim=1)], dim=0)
        net = self.netD2 if stage == 2 else self.netD
        out = [[t.permute(1, 2, 0) for t in scale] if torch.is_tensor(scale) else scale
               for scale in net(both.to(self.compute_dtype))]
        n = fake_image.shape[0]
        return [[t[:n] for t in scale] for scale in out], [[t[n:] for t in scale] for scale in out]

    @torch.no_grad()
    def orient_for_training(self, pre) -> torch.Tensor:
        """The frozen IG's inpainted orientation (pix2pix_model.py:260-265),
        or the raw orientation without --use_ig."""
        if not self.opt.use_ig:
            return pre["orient"]
        return self.inpaint_orient(pre["hole"], pre["orient_rgb"], pre["noise"],
                                   pre["input_tag"][:, 1:2])[1]

    def _d_planes(self, pre, out, orient, bands=None):
        """netD's (input_tag, fake, real, orient): whole planes, gathered on
        every rank in bands (one gather; the fake's gradient returns to its
        band)."""
        planes = (pre["input_tag"], out, pre["image_tag"], orient)
        return planes if bands is None else bands.gather_planes(planes)

    def generator_loss(self, batch, extra_dilate_steps: int = 2,
                       eps: Optional[torch.Tensor] = None, curr_step: Optional[int] = None,
                       bands=None):
        """(total, per-term losses by name, fake, orient) in the training
        stage (``stage``).  netG's forward writes its buffers; gradients
        reach netG, netE and netB (and the stage's D's parameters, unless
        the caller switched them off).  The losses judge the blend under
        --use_blender; `fake` is netG's image before it.  With `bands`:
        this rank's share of each term, the whole fake (on every rank) and
        this band of the orientation."""
        opt = self.opt
        stage = self.stage(curr_step)
        red = WHOLE if bands is None else bands
        pre = self.preprocess(batch)
        losses: Dict[str, torch.Tensor] = {}
        if bands is None:
            orient = self.orient_for_training(pre)
            fake, kld, blend = self.generate_fake(pre, orient, extra_dilate_steps, eps)
        else:
            orient = bands.orient_for_training(self, pre)
            fake, kld, blend = bands.generate(self, pre, orient, extra_dilate_steps), None, None
        if opt.use_vae:
            losses["KLD"] = kld
        out = blend if opt.use_blender else fake
        planes = self._d_planes(pre, out, orient, bands)
        pred_fake, pred_real = self.discriminate(*planes, stage)
        label_tag = pre["input_tag"][:, 1:2]
        label_ref = pre["input_ref"][:, 1:2]
        label_d = planes[0][:, 1:2]  # the hair at netD's (whole) planes
        if not opt.no_gan_loss:
            losses["GAN"] = red.whole(multiscale_gan_loss(pred_fake, True, False, opt, label_d))
        if stage == 1:
            losses.update(self._paired_losses(pre, out, pred_fake, pred_real, red, label_d))
        if not opt.no_orient_loss:
            o_l1, conf = orient_loss(out, orient, pre["input_tag"], opt, red)
            losses["ORIENT"] = o_l1 * opt.lambda_orient
            if not opt.no_confidence_loss:
                losses["CONFIDENCE"] = conf * opt.lambda_confidence
        if stage == 2:
            # the unpaired stage (pix2pix_model.py:353-363): the hair's
            # average colour against the ref's, or the blend's against the
            # fake it blends
            if opt.use_blender:
                lab = color_losses.hair_avg_lab_loss(blend, fake.detach(), label_tag, label_tag,
                                                     opt, self.ab_count)
            else:
                lab = color_losses.hair_avg_lab_loss(fake, pre["image_ref"], label_tag,
                                                     label_ref, opt, self.ab_count)
            losses["hairAvgLab"] = lab * opt.lambda_hairavglab
            losses["background"] = color_losses.rgb_background_l1_loss(
                out, pre["input_tag"], pre["image_tag"]) * opt.lambda_background
        return sum(losses.values()), losses, fake if bands is None else planes[1], orient

    def _paired_losses(self, pre, out, pred_fake, pred_real, red=WHOLE, label_d=None
                       ) -> Dict[str, torch.Tensor]:
        """The paired stage's terms on the output image `out`, in the JAX
        package's order: GAN_Feat, VGG, content, style, background, rgb, lab;
        each reduced by `red` (losses/reduce.py).  `label_d`: the hair at
        netD's planes (default the tag's)."""
        opt = self.opt
        losses: Dict[str, torch.Tensor] = {}
        label_tag = pre["input_tag"][:, 1:2]
        label_ref = pre["input_ref"][:, 1:2]
        label_d = label_tag if label_d is None else label_d
        # the paired-data gate (pix2pix_model.py:286-291) as a factor, not a
        # branch: no host sync
        ref_is_tag = (red.total((label_tag - label_ref).abs()) == 0).float()
        # one VGG forward per distinct image, in the compute dtype: the
        # output's with a gradient (under --remat recomputed in the backward,
        # as the JAX package's jax.checkpoint of the tower), the tag's and
        # ref's as one no-grad forward at twice the batch
        cdt = self.compute_dtype
        if opt.remat and torch.is_grad_enabled():
            f_fake = checkpointed(self.vgg, self.vgg, out.to(cdt))
        else:
            f_fake = red.vgg(self.vgg, out.to(cdt))
        with torch.no_grad():
            f_tr = red.vgg(self.vgg,
                           torch.cat([pre["image_tag"], pre["image_ref"]], dim=0).to(cdt))
        n = out.shape[0]
        f_tag, f_ref = [t[:n] for t in f_tr], [t[n:] for t in f_tr]
        if not opt.no_ganFeat_loss:
            losses["GAN_Feat"] = ref_is_tag * red.whole(
                gan_feat_loss(pred_fake, pred_real, opt, label_d))
        if not opt.no_vgg_loss:
            losses["VGG"] = ref_is_tag * (vgg_loss_from_features(f_fake, f_tag, opt, label_tag,
                                                                 red) * opt.lambda_vgg)
        loss_c, loss_s = style_content_loss_from_features(f_fake, f_ref, f_tag, opt, label_ref,
                                                          label_tag, red)
        if not opt.no_content_loss:
            losses["content"] = loss_c * opt.lambda_content
        if not opt.no_style_loss:
            losses["style"] = loss_s * opt.lambda_style
        if not opt.no_background_loss:
            losses["background"] = ref_is_tag * (color_losses.rgb_background_l1_loss(
                out, pre["input_tag"], pre["image_tag"], red) * opt.lambda_background)
        if not opt.no_rgb_loss:
            losses["rgb"] = ref_is_tag * (red.mean((out - pre["image_tag"]).abs())
                                          * opt.lambda_rgb)
        if not opt.no_lab_loss:
            losses["lab"] = ref_is_tag * (color_losses.lab_color_loss(
                out, pre["image_tag"], opt, label_tag, self.ab_count, red) * opt.lambda_lab)
        return losses

    def discriminator_loss(self, batch, extra_dilate_steps: int = 2,
                           orient: Optional[torch.Tensor] = None,
                           eps: Optional[torch.Tensor] = None, curr_step: Optional[int] = None,
                           fake_image: Optional[torch.Tensor] = None, bands=None):
        """(total, {'D_Fake', 'D_real'}) of the stage's D on `fake_image`
        (--reuse_fake_for_d: the G step's fake), or else on the fake (the
        blend under --use_blender) recomputed with the current netG, netE
        and netB (train-mode statistics, nothing written, no gradient) and
        the VAE's `eps`; with the G step's orientation when given (the IG is
        frozen, so it is the same).  With `bands`: the fake recomputed in
        bands, netD on the gathered planes, each term this rank's share."""
        opt = self.opt
        red = WHOLE if bands is None else bands
        pre = self.preprocess(batch)
        if orient is None:
            orient = self.orient_for_training(pre) if bands is None else \
                bands.orient_for_training(self, pre)
        if fake_image is None:
            with torch.no_grad(), frozen_buffers(self.netG):
                if bands is None:
                    fake, _, blend = self.generate_fake(pre, orient, extra_dilate_steps, eps)
                else:
                    fake, blend = bands.generate(self, pre, orient, extra_dilate_steps), None
            fake_image = blend if opt.use_blender else fake
        planes = self._d_planes(pre, fake_image.detach(), orient.detach(), bands)
        pred_fake, pred_real = self.discriminate(*planes, self.stage(curr_step))
        label_d = planes[0][:, 1:2]
        d_fake = red.whole(multiscale_gan_loss(pred_fake, False, True, opt, label_d))
        d_real = red.whole(multiscale_gan_loss(pred_real, True, True, opt, label_d))
        return d_fake + d_real, {"D_Fake": d_fake, "D_real": d_real}

    @torch.no_grad()
    def infer(self, batch: Dict[str, torch.Tensor], inpaint_mode: Optional[str] = None,
              eps: Optional[torch.Tensor] = None):
        """Returns (fake image, inpainted orient RGB or None), NCHW; the fake
        (the blend under --use_blender) keeps the add_feat_zeros frame,
        which the caller crops.  `inpaint_mode` ('ref' or 'stroke', default
        --inpaint_mode) picks the orientation-inpainting branch; the options
        are never changed.  Under --use_vae, z takes `eps` (default: a draw
        from ``eps_gen``)."""
        mode = self.opt.inpaint_mode if inpaint_mode is None else inpaint_mode
        pre = self.preprocess(batch)
        orient_rgb_out: Optional[torch.Tensor] = None
        hair = pre["input_tag"][:, 1:2]
        if self.opt.use_ig and "stroke" in mode:
            if self.netSIG is None:
                raise ValueError("--inpaint_mode stroke needs --use_stroke (netSIG)")
            orient_rgb_out, orient = self.inpaint_stroke_orient(
                pre["hole"], pre["orient_rgb"], pre["noise"], hair, pre["orient_stroke"],
                pre["mask_stroke"], pre["orient_rgb_mask"])
        elif self.opt.use_ig:
            orient_rgb_out, orient = self.inpaint_orient(
                pre["hole"], pre["orient_rgb"], pre["noise"], hair)
        else:
            orient = pre["orient"]
        fake, _, blend = self.generate_fake(pre, orient, eps=eps)
        return blend if self.opt.use_blender else fake, orient_rgb_out
