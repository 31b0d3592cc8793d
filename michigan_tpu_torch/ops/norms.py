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


def batch_norm_train(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float = 0.1, eps: float = 1e-5):
    """Training-mode batch norm, affine-free: normalise with the batch's
    per-channel mean and biased variance (statistics in float32, gradients
    through them), and return the running statistics updated with the
    unbiased variance, as sync batch norm does.  Returns (y, new_mean,
    new_var); the caller decides whether to write them."""
    xf = x.float()
    var_b, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
    inv = torch.rsqrt(var_b + eps)
    y = ((xf - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)).to(x.dtype)
    with torch.no_grad():
        count = x.numel() // x.shape[1]
        var_u = var_b * (count / max(count - 1, 1))
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * var_u
    return y, new_mean, new_var


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
    One iteration per training forward; a few to give freshly initialised
    weights unit-norm u and v."""
    v = None
    for _ in range(n_iter):
        v = F.normalize(torch.mv(w_mat.t(), u), dim=0, eps=1e-12)
        u = F.normalize(torch.mv(w_mat, v), dim=0, eps=1e-12)
    return u, v
