"""Normalisation primitives (port of michigan_tpu/ops/norms.py), NCHW.

bfloat16 inputs of ``instance_norm`` and ``batch_norm_train`` take the JAX
package's bf16 custom VJPs (``_instance_norm_b16``, ``_bn_train_b16``) as
``torch.autograd.Function``s: the forward is (x - mean) * inv in bfloat16
with float32 sums (sum x, sum x^2: var = E[x^2] - mean^2); autograd keeps
the bfloat16 x and per-channel float32 statistics, no full-size float32
tensor; the backward is inv * (g - mean(g) - x_hat * mean(g * x_hat)) in
bfloat16 with float32 reductions.  float32 inputs keep the float32 code.

Sync batch norm across data-parallel replicas (``group``, the JAX package's
``axis_name``): the per-channel (sum, sum of squares, count) are summed over
the group in one all-reduce, whose backward sums the gradients over the
group too (parallel/dist.py ``all_reduce_sum``); the bfloat16 Function sums
(s, ss, count) in its forward and (sum g, sum g * x_hat) in its backward,
where ``_bn_fwd_impl`` / ``_bn_b16_bwd`` psum.  Without a group nothing
changes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from michigan_tpu_torch.parallel.dist import all_reduce_sum


class InstanceNormB16(torch.autograd.Function):
    """instance_norm of a bfloat16 x (_in_fwd_impl / _in_bwd)."""

    @staticmethod
    def forward(ctx, x, eps):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
        del xf
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, inv)
        return (x - mean.to(x.dtype)) * inv.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv = ctx.saved_tensors
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        gf = g.float()
        mg = gf.mean(dim=(2, 3), keepdim=True)
        mgx = (gf * xhat.float()).mean(dim=(2, 3), keepdim=True)
        del gf
        return inv.to(x.dtype) * (g - mg.to(x.dtype) - xhat * mgx.to(x.dtype)), None


class BatchNormTrainB16(torch.autograd.Function):
    """batch_norm_train's normalisation of a bfloat16 x (_bn_fwd_impl /
    _bn_b16_bwd): returns (y, mean, biased var); the statistics carry no
    gradient (the running statistics are buffers).  With a `group` the sums
    and the count are the group's."""

    @staticmethod
    def forward(ctx, x, eps, group=None):
        count = x.numel() // x.shape[1]
        xf = x.float()
        s = xf.sum(dim=(0, 2, 3))
        ss = (xf * xf).sum(dim=(0, 2, 3))
        del xf
        if group is not None:
            stats = torch.cat([s, ss, s.new_full((1,), count)])
            dist.all_reduce(stats, group=group)
            s, ss, count = stats[:s.numel()], stats[s.numel():-1], stats[-1:]
        mean = s / count
        var_b = ss / count - mean * mean
        inv = torch.rsqrt(var_b + eps)
        ctx.save_for_backward(x, mean, inv)
        ctx.count, ctx.group = count, group
        ctx.mark_non_differentiable(mean, var_b)
        return (x - mean.view(1, -1, 1, 1).to(x.dtype)) * inv.view(1, -1, 1, 1).to(x.dtype), \
            mean, var_b

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        x, mean, inv = ctx.saved_tensors
        mean, inv = mean.view(1, -1, 1, 1).to(x.dtype), inv.view(1, -1, 1, 1).to(x.dtype)
        xhat = (x - mean) * inv
        gf = g.float()
        sum_g, sum_gx = gf.sum(dim=(0, 2, 3)), (gf * xhat.float()).sum(dim=(0, 2, 3))
        del gf
        if ctx.group is not None:
            sums = torch.cat([sum_g, sum_gx])
            dist.all_reduce(sums, group=ctx.group)
            sum_g, sum_gx = sums.chunk(2)
        mg = (sum_g / ctx.count).view(1, -1, 1, 1).to(x.dtype)
        mgx = (sum_gx / ctx.count).view(1, -1, 1, 1).to(x.dtype)
        return inv * (g - mg - xhat * mgx), None, None


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn.InstanceNorm2d(affine=False): per-(N,C) over H,W with the biased
    variance and eps inside the sqrt; statistics in float32 (bfloat16:
    InstanceNormB16)."""
    if x.dtype == torch.bfloat16:
        return InstanceNormB16.apply(x, float(eps))
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm_train(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, momentum: float = 0.1, eps: float = 1e-5,
                     group=None):
    """Training-mode batch norm, affine-free: normalise with the batch's
    per-channel mean and biased variance (statistics in float32, gradients
    through them), and return the running statistics updated with the
    unbiased variance, as sync batch norm does.  Returns (y, new_mean,
    new_var); the caller decides whether to write them.  bfloat16:
    BatchNormTrainB16.  With a data-parallel `group` the statistics are the
    group's global batch's (batch_stats: mean = s / count, var = ss / count
    - mean^2), the count too."""
    count = x.numel() // x.shape[1]
    if x.dtype == torch.bfloat16:
        y, mean, var_b = BatchNormTrainB16.apply(x, float(eps), group)
    elif group is not None:
        xf = x.float()
        c = x.shape[1]
        stats = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                          xf.new_full((1,), count)]), group)
        mean = stats[:c] / stats[c * 2:]
        var_b = stats[c:c * 2] / stats[c * 2:] - mean * mean
        inv = torch.rsqrt(var_b + eps)
        y = ((xf - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)).to(x.dtype)
    else:
        xf = x.float()
        var_b, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        inv = torch.rsqrt(var_b + eps)
        y = ((xf - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)).to(x.dtype)
    if group is not None:  # every replica holds an equal slice of the global batch
        count *= dist.get_world_size(group)
    with torch.no_grad():
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


def spectral_weight(weight_orig: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    transposed: bool = False) -> torch.Tensor:
    """Eval-mode spectrally normalised weight W / sigma, float32, from the
    stored u and v; W is flattened to (out, rest) for sigma, with a
    transposed conv's (I, O, kh, kw) weight taken out-channels first."""
    w = weight_orig.transpose(0, 1) if transposed else weight_orig
    w_mat = w.reshape(w.shape[0], -1).float()
    return weight_orig.float() / spectral_sigma(w_mat, u.float(), v.float())


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, n_iter: int):
    """torch spectral_norm's power iteration: v = norm(W^T u); u = norm(W v).
    One iteration per training forward; a few to give freshly initialised
    weights unit-norm u and v."""
    v = None
    for _ in range(n_iter):
        v = F.normalize(torch.mv(w_mat.t(), u), dim=0, eps=1e-12)
        u = F.normalize(torch.mv(w_mat, v), dim=0, eps=1e-12)
    return u, v
