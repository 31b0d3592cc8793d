"""Orientation supervision (port of michigan_tpu/losses/orient.py, reference
loss.py:274-385): the fake's dense orientation from the filter bank,
L1-matched to the label inside the hair, plus a confidence term.  The
gradient reaches the image through the bank's max response only.  Under
--dtype bfloat16 the bank's forward takes bf16 operands, as the JAX
package's does without --orient_bank_fp32; its gradient stays float32.
The bank's response and the reductions go through `red` (losses/reduce.py:
the whole plane, or a band with the bank's halo and its share of each
term)."""

from __future__ import annotations

import math

import torch

from michigan_tpu_torch.losses.reduce import WHOLE
from michigan_tpu_torch.ops.filters import cal_orientation_two_channel


def orient_loss(fake_image: torch.Tensor, orient_label: torch.Tensor,
                input_tag: torch.Tensor, opt, red=WHOLE):
    """(orient L1, confidence loss).  fake_image (N,3,H,W) in [-1,1];
    orient_label (N,2,H,W) decoded (--use_ig) or (N,1,H,W) raw [0,255];
    input_tag the one-hot (N,2,H,W)."""
    hair = input_tag[:, 1:2].permute(0, 2, 3, 1)  # NHWC, as the filters take it
    mode = "gabor" if "gabor" in opt.orient_filter else "dog"
    # under the bf16 policy the bank's bf16-operand forward, unless
    # --orient_bank_fp32 asks for the float32 one (the JAX package's fwd_bf16)
    bf16_operands = opt.dtype == "bfloat16" and not opt.orient_bank_fp32
    two, conf = cal_orientation_two_channel(fake_image.permute(0, 2, 3, 1), mode,
                                            hair if mode == "dog" else None, bf16_operands,
                                            red.orientation_response)
    if opt.use_ig:
        target = orient_label.permute(0, 2, 3, 1)
    else:
        t = orient_label.permute(0, 2, 3, 1) / 255.0 * math.pi
        target = torch.cat([torch.sin(2 * t), torch.cos(2 * t)], dim=-1)
    l1 = red.mean((two * hair - (target * hair).detach()).abs())
    if mode == "gabor":
        conf_loss = -(torch.log(conf.clamp(0.001, 1.0)) * hair).sum() / red.total(hair)
    else:
        conf_loss = (conf * hair - hair.detach()).abs().sum() / (red.total(hair) + 1e-5)
    return l1, conf_loss
