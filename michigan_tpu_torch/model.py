"""MichiGAN inference orchestration (port of michigan_tpu/model.py), NCHW.

  preprocess(batch)          one-hot labels
  inpaint_orient(...)        IG orientation inpainting (pix2pix_model.py:407-429)
  inpaint_stroke_orient(...) SIG stroke inpainting (pix2pix_model.py:431-464)
  generate_fake(...)         zeros-pad + netG (pix2pix_model.py:495-541)
  infer(batch, mode)         the 'inference' mode (pix2pix_model.py:80-120)

A batch is a dict of NCHW float32 tensors on the model's device with the keys
of ``michigan_tpu.data.single_inference_data`` (or ``demo_inference_data``
for a stroke edit); ``batch_from_numpy`` turns those functions' NHWC numpy
arrays into one.  Only the inference paths of the flagship and demo
configurations are ported; ``check_supported`` names what is not.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from michigan_tpu_torch.models.generator import SPADEBGenerator
from michigan_tpu_torch.models.inpaint import InpaintGenerator, SInpaintGenerator
from michigan_tpu_torch.models.layers import init_weights
from michigan_tpu_torch.ops.masks import one_hot_label
from michigan_tpu_torch.ops.resize import resize_nearest

GEN_KEYS = ("input_ref", "input_tag", "orient", "image_ref", "image_tag", "noise")


def check_supported(opt) -> None:
    """Raise for flags whose code paths are not ported yet."""
    unported = [f"--{f}" for f in ("use_vae", "use_blender", "only_blend",
                                   "use_instance_feat", "add_zeros")
                if getattr(opt, f)]
    if not opt.no_instance:
        unported.append("instance maps (--no_instance False)")
    if opt.dtype != "float32":
        unported.append(f"--dtype {opt.dtype}")
    if opt.netG != "spadeb" or (opt.use_ig and opt.netIG != "inpaint") or \
            (opt.use_stroke and opt.netSIG != "sinpaint"):
        unported.append("a netG other than spadeb, a netIG other than inpaint or a "
                        "netSIG other than sinpaint")
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
    """Holds the inference nets of one configuration on one device."""

    def __init__(self, opt, device="cpu"):
        check_supported(opt)
        self.opt = opt
        self.device = torch.device(device)
        self.netG = SPADEBGenerator(opt).eval()
        epilogue = opt.use_pallas_epilogue
        self.netIG = InpaintGenerator(epilogue=epilogue).eval() if opt.use_ig else None
        self.netSIG = SInpaintGenerator(epilogue=epilogue).eval() if opt.use_stroke else None

    def nets(self) -> Dict[str, torch.nn.Module]:
        return {k: v for k, v in (("netG", self.netG), ("netIG", self.netIG),
                                  ("netSIG", self.netSIG)) if v is not None}

    def init_weights(self, seed: int) -> None:
        """Seeded weights by --init_type (one CPU torch.Generator), then move
        the nets to the device."""
        gen = torch.Generator().manual_seed(seed)
        for net in self.nets().values():
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

    # ------------------------------------------------------------------

    def preprocess(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        nc = self.opt.label_nc + (1 if self.opt.contain_dontcare_label else 0)
        out = dict(batch)
        out["input_ref"] = one_hot_label(batch["label_ref"], nc)
        out["input_tag"] = one_hot_label(batch["label_tag"], nc)
        return out

    def _run_ig(self, net: torch.nn.Module, inp: torch.Tensor) -> torch.Tensor:
        # the IG and SIG always run at 256^2 (nearest resize in and out)
        size = self.opt.crop_size
        if size != 256 or inp.shape[2] != 256:
            inp = resize_nearest(inp, (256, 256))
        out = net(inp)
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
        return gin

    def generate_fake(self, pre, orient) -> torch.Tensor:
        gin = self._padded_gen_inputs(pre, orient)
        return self.netG(*(gin[k] for k in GEN_KEYS)).float()

    @torch.no_grad()
    def infer(self, batch: Dict[str, torch.Tensor], inpaint_mode: Optional[str] = None):
        """Returns (fake image, inpainted orient RGB or None), NCHW; the fake
        keeps the add_feat_zeros frame, which the caller crops.
        `inpaint_mode` ('ref' or 'stroke', default --inpaint_mode) picks the
        orientation-inpainting branch; the options are never changed."""
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
        return self.generate_fake(pre, orient), orient_rgb_out
