"""SPADE conditional normalisation (port of
michigan_tpu/models/normalization.py), NCHW.

The param-free norm of netG=spadeb is sync batch norm; in eval it uses the
running statistics, so every SPADE norm is one `spade_modulate` launch with
invstd = rsqrt(running_var + 1e-5).  The instance-norm variant is one
`fused_instance_norm` launch with gamma and beta.  Both kernels are
forward-only: in train mode SPADE is the plain composition with autograd
(batch statistics, running statistics written unless under
``layers.frozen_buffers``), as the JAX package's training path is.

Under --weight_norm_G a SPADE has no param-free norm and no buffer
(normalization.py:103-107): x * (1 + gamma) + beta, in eval still one
`spade_modulate` launch, with mean 0 and invstd 1.

NonSpadeNorm is the norm layer of the discriminators, the VAE encoder and
the norm / instance appearance encoders (--norm_D, --norm_E): a conv
(spectral or plain), then an instance norm, an affine batch or sync batch
norm, or none.
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
                 group=None, weight_norm: bool = False):
        super().__init__()
        self.norm_type, ks = parse_spade_config(config_text)
        self.pw = ks // 2
        self.weight_norm = weight_norm
        if weight_norm:  # no param-free norm (JAX normalization.py:129-131)
            self.register_buffer("zeros", torch.zeros(norm_nc), persistent=False)
            self.register_buffer("ones", torch.ones(norm_nc), persistent=False)
        else:
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
        if self.weight_norm:
            if self.training:
                return x * (1.0 + gamma) + beta
            return spade_modulate(x, self.zeros, self.ones, gamma, beta)
        if self.training:
            return self.param_free_norm(x) * (1.0 + gamma) + beta
        if self.norm_type == "instance":
            return fused_instance_norm(x, gamma.contiguous(), beta.contiguous())
        pfn = self.param_free_norm
        invstd = torch.rsqrt(pfn.running_var + pfn.eps)
        return spade_modulate(x, pfn.running_mean, invstd, gamma, beta)


class AffineBatchNorm(ParamFreeNorm):
    """BatchNorm2d(affine=True) of a NonSpadeNorm (normalization.py:43-46):
    the batch or sync batch norm of ParamFreeNorm, then weight * y + bias
    (the JAX package's norm_scale and norm_bias)."""

    def __init__(self, norm_type: str, num_features: int, group=None):
        super().__init__(norm_type, num_features, group=group)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y * self.weight.to(y.dtype).view(1, -1, 1, 1) + \
            self.bias.to(y.dtype).view(1, -1, 1, 1)


class NonSpadeNorm(nn.Sequential):
    """get_nonspade_norm_layer's Sequential(conv, norm) (normalization.py:18-54;
    JAX normalization.py:190-226) for every --norm_D / --norm_E:
    '[spectral]instance', '[spectral]batch', '[spectral]sync_batch' and
    '[spectral]none'.  The conv (``0``) is spectral under the 'spectral'
    prefix and has a bias only when no norm follows; the norm (``1``) is
    the plain instance norm (no state), or an AffineBatchNorm with running
    statistics (a sync batch norm takes the data-parallel `group`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int, padding: int,
                 norm_str: str, group=None):
        spectral = norm_str.startswith("spectral")
        sub = norm_str[len("spectral"):] if spectral else norm_str
        if sub not in ("", "none", "instance", "batch", "sync_batch"):
            raise ValueError(f"the norm layer {norm_str!r} (--norm_D, --norm_E)")
        has_norm = sub not in ("", "none")
        cls = SpectralConv2d if spectral else Conv2d
        layers = [cls(in_ch, out_ch, kernel_size, stride, padding, bias=not has_norm)]
        if sub in ("batch", "sync_batch"):
            layers.append(AffineBatchNorm("syncbatch" if sub == "sync_batch" else "batch",
                                          out_ch, group))
        super().__init__(*layers)
        self.instance = sub == "instance"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return instance_norm(y) if self.instance else y
