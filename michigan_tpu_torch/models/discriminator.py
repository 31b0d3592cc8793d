"""PatchGAN discriminators (port of michigan_tpu/models/discriminator.py),
NCHW: --netD multiscale (num_D NLayerDiscriminators over an average-pool
pyramid) or --netD n_layer (one NLayerDiscriminator; JAX
models/__init__.py:27-47).

State_dict keys follow the reference (discriminator.py:14-120):
``[discriminator_{i}.]model0.0`` (plain conv + leaky ReLU),
``model{n}.0.0`` (the conv inside the --norm_D layer's Sequential, spectral
under 'spectral'), ``model{n}.0.1`` (its affine batch norm under 'batch' /
'sync_batch') and ``model{n_layers_D}.0`` (the plain 1-channel conv).
Every conv casts its float32 parameters to the input's dtype
(models/layers.py), so under the bf16 policy netD runs in bfloat16.

A discriminator never writes its buffers, as in the JAX package, which
applies netD without mutable collections (model.py:352): each train-mode
forward iterates the spectral u / v again from the stored ones and
normalises a batch norm with the batch's statistics, and the running
statistics stay as they are.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import Conv2d
from michigan_tpu_torch.models.normalization import NonSpadeNorm
from michigan_tpu_torch.ops.resize import avg_pool_3x3s2


class NLayerDiscriminator(nn.Module):
    """kw 4, padw 2, nf doubling up to 512, the last two layers at stride 1.
    Returns every layer group's output (the features of the GAN-feature
    loss, then the prediction), or [prediction] with --no_ganFeat_loss."""

    def __init__(self, opt, group=None):
        super().__init__()
        kw, padw = 4, 2
        nf = opt.ndf
        self.no_ganFeat_loss = opt.no_ganFeat_loss
        self.n_layers = opt.n_layers_D
        self.model0 = nn.Sequential(Conv2d(opt.d_input_nc(), nf, kw, 2, padw))
        for n in range(1, opt.n_layers_D):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == opt.n_layers_D - 1 else 2
            setattr(self, f"model{n}",
                    nn.Sequential(NonSpadeNorm(nf_prev, nf, kw, stride, padw, opt.norm_D,
                                               group)))
        setattr(self, f"model{opt.n_layers_D}", nn.Sequential(Conv2d(nf, 1, kw, 1, padw)))
        for m in self.modules():  # never written (the module docstring)
            if hasattr(m, "write_buffers"):
                m.write_buffers = False

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        results = []
        for n in range(self.n_layers + 1):
            x = getattr(self, f"model{n}")(x)
            if n < self.n_layers:
                x = F.leaky_relu(x, 0.2)
            results.append(x)
        return [results[-1]] if self.no_ganFeat_loss else results


class MultiscaleDiscriminator(nn.Module):
    """num_D NLayerDiscriminators over a 3x3/2 average-pool pyramid; returns a
    list (one per scale) of lists of features."""

    def __init__(self, opt, group=None):
        super().__init__()
        self.num_D = opt.num_D
        for i in range(opt.num_D):
            setattr(self, f"discriminator_{i}", NLayerDiscriminator(opt, group))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        out = []
        for i in range(self.num_D):
            out.append(getattr(self, f"discriminator_{i}")(x))
            if i != self.num_D - 1:
                x = avg_pool_3x3s2(x)
        return out


def define_D(opt, group=None) -> nn.Module:
    """--netD multiscale (its sub-nets --netD_subarch n_layer, the only one
    the reference ships) or n_layer; the norm layers' sync batch norms take
    the data-parallel `group`."""
    if opt.netD == "multiscale" and opt.netD_subarch == "n_layer":
        return MultiscaleDiscriminator(opt, group)
    if opt.netD == "n_layer":
        return NLayerDiscriminator(opt, group)
    raise ValueError(f"--netD {opt.netD} --netD_subarch {opt.netD_subarch}: only multiscale "
                     "(of n_layer) and n_layer exist")
