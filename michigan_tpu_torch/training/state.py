"""TTUR Adam pair and the linear LR decay (port of
michigan_tpu/training/state.py; reference pix2pix_model.py:124-152 and
pix2pix_trainer.py:99-119).

torch.optim.Adam and optax's adam share the update, lr * m_hat /
(sqrt(v_hat) + eps) with eps outside the square root.
"""

from __future__ import annotations

from typing import Tuple

import torch


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


def make_optimizers(opt, net_g: torch.nn.Module, net_d: torch.nn.Module):
    """(Adam over netG, Adam over netD): betas (0, 0.9) with TTUR, else
    (--beta1, --beta2), at the learning rates of the first epoch."""
    betas = (opt.beta1, opt.beta2) if opt.no_TTUR else (0.0, 0.9)
    g_lr, d_lr = learning_rates(opt, 1)
    return (torch.optim.Adam(net_g.parameters(), lr=g_lr, betas=betas),
            torch.optim.Adam(net_d.parameters(), lr=d_lr, betas=betas))


def set_learning_rates(opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer, opt,
                       epoch: int) -> None:
    """The epoch-level LR update (host side, between epochs)."""
    for optim, lr in zip((opt_g, opt_d), learning_rates(opt, epoch)):
        for group in optim.param_groups:
            group["lr"] = lr
