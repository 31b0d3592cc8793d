"""TTUR Adam optimizers, the linear LR decay and netD2's start (port of
michigan_tpu/training/state.py; reference pix2pix_model.py:124-152 and
pix2pix_trainer.py:99-119).

G's Adam covers netG, netE (--use_vae), netFE (--use_instance_feat: no
loss reaches it, so it never changes, as in the JAX package) and netB
(--use_blender); D's covers netD; under --unpairTrain netD2 has an Adam of its own at D's rate.
torch.optim.Adam and optax's adam share the update, lr * m_hat /
(sqrt(v_hat) + eps) with eps outside the square root.
"""

from __future__ import annotations

from typing import Tuple

import torch

from michigan_tpu_torch.parallel.dist import check_replicas_identical


def learning_rates(opt, epoch: int) -> Tuple[float, float]:
    """(G lr, D lr) for `epoch`: constant for --niter epochs, then linear
    decay over --niter_decay; with TTUR G takes lr/2 and D 2*lr."""
    if epoch > opt.niter:
        new_lr = opt.lr - opt.lr / max(opt.niter_decay, 1) * (epoch - opt.niter)
    else:
        new_lr = opt.lr
    if opt.no_TTUR:
        return new_lr, new_lr
    return new_lr / 2.0, new_lr * 2.0


def g_net_names(opt) -> Tuple[str, ...]:
    """The nets G's optimizer trains (the JAX package's g_net_names)."""
    names = [] if opt.fix_netG else ["netG"]
    if opt.use_vae:
        names.append("netE")
    if opt.use_instance_feat:
        names.append("netFE")
    if opt.use_blender:
        names.append("netB")
    return tuple(names)


def make_optimizers(opt, model):
    """{'G': Adam over g_net_names, 'D': Adam over netD, and 'D2': Adam over
    netD2 under --unpairTrain}: betas (0, 0.9) with TTUR, else (--beta1,
    --beta2), at the learning rates of the first epoch."""
    betas = (opt.beta1, opt.beta2) if opt.no_TTUR else (0.0, 0.9)
    g_lr, d_lr = learning_rates(opt, 1)
    nets = model.nets()
    g_params = [p for n in g_net_names(opt) for p in nets[n].parameters()]
    # --fix_netG alone leaves G's optimizer nothing to train (None)
    out = {"G": torch.optim.Adam(g_params, lr=g_lr, betas=betas) if g_params else None,
           "D": torch.optim.Adam(model.netD.parameters(), lr=d_lr, betas=betas)}
    if model.netD2 is not None:
        out["D2"] = torch.optim.Adam(model.netD2.parameters(), lr=d_lr, betas=betas)
    return out


def set_learning_rates(optimizers, opt, epoch: int) -> None:
    """The epoch-level LR update (host side, between epochs): G's rate to
    'G', D's to 'D' and 'D2'."""
    g_lr, d_lr = learning_rates(opt, epoch)
    for key, optim in optimizers.items():
        for group in optim.param_groups if optim is not None else ():
            group["lr"] = g_lr if key == "G" else d_lr


@torch.no_grad()
def init_netd2_from_netd(model) -> None:
    """--same_netD_model: netD2 starts as a copy of netD (reference
    train_options.py:40), into netD2's own storage: the two never share a
    tensor."""
    for dst, src in zip(model.netD2.state_dict().values(), model.netD.state_dict().values()):
        dst.copy_(src)


def check_replicas(model, group=None) -> None:
    """Data parallelism (or the ranks of a spatial `group`): raise on every
    rank unless every net's parameters and buffers equal rank 0's bit for
    bit (one broadcast from rank 0).  The replicas start equal because every
    rank seeds its weights with --seed on the CPU; equal collectives and
    Adam steps keep them so, running statistics and spectral u / v
    included."""
    group = model.group if group is None else group
    if group is not None:
        check_replicas_identical(
            [t for net in model.nets().values() for t in (*net.parameters(), *net.buffers())],
            group, "the nets' parameters and buffers")
