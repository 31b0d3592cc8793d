"""SPADE conditional normalisation (port of
michigan_tpu/models/normalization.py), NCHW.

The param-free norm of netG=spadeb is sync batch norm; in eval it uses the
running statistics, so every SPADE norm is one `spade_modulate` launch with
invstd = rsqrt(running_var + 1e-5).  The instance-norm variant is one
`fused_instance_norm` launch with gamma and beta.  Both kernels are
forward-only: in train mode SPADE is the plain composition with autograd
(batch statistics, running statistics written unless under
``layers.frozen_buffers``), as the JAX package's training path is.

NonSpadeNorm is the norm layer of the discriminator and the VAE encoder: a
spectral conv with the bias stripped, then the plain instance norm (with
autograd).
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import Conv2d, SpectralConv2d, conv
from michigan_tpu_torch.ops.cuda.spade import fused_instance_norm, spade_modulate
from michigan_tpu_torch.ops.norms import batch_norm_eval, batch_norm_train, instance_norm
from michigan_tpu_torch.ops.resize import resize_nearest


def parse_spade_config(config_text: str):
    """'spadesyncbatch3x3' -> ('syncbatch', 3) (normalization.py:74-77)."""
    m = re.search(r"spade(\D+)(\d)x\d", config_text)
    return str(m.group(1)), int(m.group(2))


class ParamFreeNorm(nn.Module):
    """Affine-free instance / batch / syncbatch norm.  Batch norms hold the
    buffers of torch's BatchNorm2d (running_mean, running_var,
    num_batches_tracked); in train mode they normalise with the batch's
    statistics and write the running statistics with momentum 0.1 unless
    their buffers are frozen.  A syncbatch norm takes the statistics of the
    data-parallel `group`'s global batch (ops/norms.py); without a group,
    and for batch norms, the process's own batch's."""

    write_buffers = True

    def __init__(self, norm_type: str, num_features: int, eps: float = 1e-5, group=None):
        super().__init__()
        if norm_type not in ("instance", "batch", "syncbatch"):
            raise ValueError(norm_type)
        self.norm_type, self.eps = norm_type, eps
        self.group = group if norm_type == "syncbatch" else None
        if norm_type != "instance":
            self.register_buffer("running_mean", torch.zeros(num_features))
            self.register_buffer("running_var", torch.ones(num_features))
            self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "instance":
            return instance_norm(x, self.eps)
        if self.training:
            y, new_mean, new_var = batch_norm_train(x, self.running_mean, self.running_var,
                                                    eps=self.eps, group=self.group)
            if self.write_buffers:
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
                self.num_batches_tracked += 1
            return y
        return batch_norm_eval(x, self.running_mean, self.running_var, self.eps)


class SPADE(nn.Module):
    """out = param_free_norm(x) * (1 + gamma(seg)) + beta(seg), fused into
    one kernel.  gamma and beta run as ONE conv with concatenated output
    channels, whose two halves the kernel reads in place; the state_dict
    keeps mlp_gamma and mlp_beta."""

    def __init__(self, config_text: str, norm_nc: int, label_nc: int, nhidden: int = 128,
                 group=None):
        super().__init__()
        self.norm_type, ks = parse_spade_config(config_text)
        self.pw = ks // 2
        self.param_free_norm = ParamFreeNorm(self.norm_type, norm_nc, group=group)
        self.mlp_shared = nn.Sequential(
            Conv2d(label_nc, nhidden, ks, padding=self.pw), nn.ReLU()
        )
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, ks, padding=self.pw)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, ks, padding=self.pw)
        self._gamma_beta_key, self._gamma_beta = None, None

    def gamma_beta_conv(self, dtype: torch.dtype = torch.float32):
        """(weight, bias) of mlp_gamma and mlp_beta as one conv, in `dtype`
        (the cast rule of layers.py).  Without autograd the concatenation is
        kept until a parameter is written or replaced (load_state_dict, init,
        a move to another device) or another dtype is asked for; under
        tracing (torch.export) it is computed in the traced program."""
        params = (self.mlp_gamma.weight, self.mlp_beta.weight,
                  self.mlp_gamma.bias, self.mlp_beta.bias)
        if torch.is_grad_enabled() or torch.compiler.is_compiling():
            return torch.cat(params[:2]).to(dtype), torch.cat(params[2:]).to(dtype)
        key = (dtype,) + tuple((p.device, p.data_ptr(), p._version) for p in params)
        if key != self._gamma_beta_key:
            self._gamma_beta_key = key
            self._gamma_beta = (torch.cat(params[:2]).to(dtype), torch.cat(params[2:]).to(dtype))
        return self._gamma_beta

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        """x and the conditioning in x's dtype; gamma and beta come out in
        it, while the running statistics (mean, invstd) stay float32."""
        seg = resize_nearest(segmap, x.shape[2:]).to(x.dtype)
        actv = self.mlp_shared(seg)
        weight, bias = self.gamma_beta_conv(actv.dtype)
        gamma, beta = conv(F.conv2d, actv, weight, bias, 1, self.pw).chunk(2, dim=1)
        if self.training:
            return self.param_free_norm(x) * (1.0 + gamma) + beta
        if self.norm_type == "instance":
            return fused_instance_norm(x, gamma.contiguous(), beta.contiguous())
        pfn = self.param_free_norm
        invstd = torch.rsqrt(pfn.running_var + pfn.eps)
        return spade_modulate(x, pfn.running_mean, invstd, gamma, beta)


class NonSpadeNorm(nn.Module):
    """get_nonspade_norm_layer's Sequential(spectral conv, norm)
    (normalization.py:18-54) for spectralinstance (--norm_D, --norm_E): the conv's
    bias is stripped because a norm follows; the state_dict key of the conv
    is ``0``, as in the reference."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int, padding: int,
                 norm_str: str):
        super().__init__()
        if norm_str != "spectralinstance":
            raise NotImplementedError(f"the norm layer {norm_str} (--norm_D, --norm_E) "
                                      "is not ported")
        self.add_module("0", SpectralConv2d(in_ch, out_ch, kernel_size, stride, padding,
                                            bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(self._modules["0"](x))
