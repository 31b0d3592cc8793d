"""Checkpoints in the reference's naming (util/util.py:195-272): under
<checkpoints_dir>/<name>/, ``<label>_net_<X>.pth`` for each trained net X of
the configuration, G and D, and E (--use_vae), B (--use_blender), D2
(--unpairTrain) and FE (--use_instance_feat) (state_dicts with the reference's keys, on the CPU), and
``<label>_optim.pth`` (every optimizer's state and the step count).  The
port's inference CLI loads ``<which_epoch>_net_G.pth`` (and ``_net_E``,
``_net_B``) as it loads a released generator.  Under data parallelism
or spatial sharding (the trainer's ``ranks_group``) rank 0 alone writes,
in the format of one process, and every rank waits at a barrier until it
has; every rank reads."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

# checkpoint file letter -> the model's net
NETS = {"G": "netG", "D": "netD", "E": "netE", "B": "netB", "D2": "netD2", "FE": "netFE"}


def _path(opt, label, what: str) -> str:
    return os.path.join(opt.checkpoints_dir, opt.name, f"{label}_{what}.pth")


def _cpu(state):
    return {k: v.detach().cpu() for k, v in state.items()}


def _nets(trainer):
    nets = trainer.model.nets()
    return {x: nets[name] for x, name in NETS.items() if name in nets}


def save_checkpoint(opt, label, trainer) -> None:
    group = trainer.ranks_group
    if group is None or group.rank() == 0:
        os.makedirs(os.path.join(opt.checkpoints_dir, opt.name), exist_ok=True)
        for x, net in _nets(trainer).items():
            torch.save(_cpu(net.state_dict()), _path(opt, label, f"net_{x}"))
        optim = {f"opt_{k}": o.state_dict() for k, o in trainer.optimizers.items()
                 if o is not None}
        torch.save({**optim, "step": trainer.step}, _path(opt, label, "optim"))
    if group is not None:
        dist.barrier(group)


def load_checkpoint(opt, label, trainer) -> bool:
    """Restore the nets and optimizers saved under `label` into `trainer`;
    False (nothing changed) when a file is not there."""
    nets = _nets(trainer)
    paths = {x: _path(opt, label, f"net_{x}") for x in nets}
    paths["optim"] = _path(opt, label, "optim")
    if not all(os.path.exists(p) for p in paths.values()):
        return False
    dev = trainer.model.device
    load = lambda p: torch.load(p, map_location=dev, weights_only=True)
    for x, net in nets.items():
        net.load_state_dict(load(paths[x]), strict=True)
    optim = load(paths["optim"])
    for k, o in trainer.optimizers.items():
        if o is not None:
            o.load_state_dict(optim[f"opt_{k}"])
    trainer.step = int(optim["step"])
    return True
