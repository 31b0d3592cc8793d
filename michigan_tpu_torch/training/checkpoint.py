"""Checkpoints in the reference's naming (util/util.py:195-272): under
<checkpoints_dir>/<name>/, ``<label>_net_G.pth`` and ``<label>_net_D.pth``
(state_dicts with the reference's keys, on the CPU) and
``<label>_optim.pth`` (both optimizers' states and the step count).  The
port's inference CLI loads ``<which_epoch>_net_G.pth`` as it loads a
released generator."""

from __future__ import annotations

import os

import torch


def _path(opt, label, what: str) -> str:
    return os.path.join(opt.checkpoints_dir, opt.name, f"{label}_{what}.pth")


def _cpu(state):
    return {k: v.detach().cpu() for k, v in state.items()}


def save_checkpoint(opt, label, trainer) -> None:
    os.makedirs(os.path.join(opt.checkpoints_dir, opt.name), exist_ok=True)
    torch.save(_cpu(trainer.model.netG.state_dict()), _path(opt, label, "net_G"))
    torch.save(_cpu(trainer.model.netD.state_dict()), _path(opt, label, "net_D"))
    torch.save({"opt_G": trainer.opt_g.state_dict(), "opt_D": trainer.opt_d.state_dict(),
                "step": trainer.step}, _path(opt, label, "optim"))


def load_checkpoint(opt, label, trainer) -> bool:
    """Restore netG, netD and the optimizers saved under `label` into
    `trainer`; False (nothing changed) when the files are not there."""
    paths = [_path(opt, label, w) for w in ("net_G", "net_D", "optim")]
    if not all(os.path.exists(p) for p in paths):
        return False
    dev = trainer.model.device
    load = lambda p: torch.load(p, map_location=dev, weights_only=True)
    trainer.model.netG.load_state_dict(load(paths[0]), strict=True)
    trainer.model.netD.load_state_dict(load(paths[1]), strict=True)
    optim = load(paths[2])
    trainer.opt_g.load_state_dict(optim["opt_G"])
    trainer.opt_d.load_state_dict(optim["opt_D"])
    trainer.step = int(optim["step"])
    return True
