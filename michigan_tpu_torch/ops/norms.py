"""Normalisation primitives (port of michigan_tpu/ops/norms.py), NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn.InstanceNorm2d(affine=False): per-(N,C) over H,W with the biased
    variance and eps inside the sqrt; statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm_eval(x: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batch norm from the running statistics, affine-free."""
    inv = torch.rsqrt(running_var + eps).to(x.dtype).view(1, -1, 1, 1)
    return (x - running_mean.to(x.dtype).view(1, -1, 1, 1)) * inv


def spectral_sigma(w_mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Eval-mode spectral norm: sigma = u . (W v) from the stored u and v,
    with no power iteration (torch's spectral_norm in eval)."""
    return torch.dot(u, torch.mv(w_mat, v))


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, n_iter: int):
    """torch spectral_norm's power iteration: v = norm(W^T u); u = norm(W v).
    Used only to give freshly initialised weights unit-norm u and v."""
    v = None
    for _ in range(n_iter):
        v = F.normalize(torch.mv(w_mat.t(), u), dim=0, eps=1e-12)
        u = F.normalize(torch.mv(w_mat, v), dim=0, eps=1e-12)
    return u, v
