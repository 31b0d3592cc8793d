"""The data-parallel training objective in one process: the reference that
holds a step on several replicas (parallel/dist.py) to a step without
collectives.

The JAX package's sharded step (and the reference's DataParallel) averages
each replica's losses and gradients.  A loss that is a mean over the batch
comes out as the global batch's.  The orientation loss is not such a mean:
CONFIDENCE divides a sum over the hair pixels by their count, and under the
DoG bank (--orient_filter dog) both its terms are taken on the confidence
divided by its maximum over the batch; a replica takes these over its own
slice, so where the slices hold different amounts of hair, or different
maxima, the replicas' mean is not the global batch's value.  ``g_step``
runs one G step of a ``TrainStep`` without a group on the replicas'
objective: every other term on the global batch, ORIENT and CONFIDENCE the
mean of their values on each of `world` equal slices.
tests/test_torch_parallel.py and chip_smoke.py's phase 18 compare the
replicas' step with it.
"""

from __future__ import annotations

from typing import Dict

import torch

from michigan_tpu_torch.losses.orient import orient_loss


def g_step(trainer, batch: Dict[str, torch.Tensor], extra_dilate_steps: int, world: int):
    """(losses by name, orient) of one G step of `trainer` (no group; the
    paired stage without the VAE or the blender: the configuration of
    record) on the `world`-replica objective."""
    m, opt = trainer.model, trainer.opt
    if m.group is not None or opt.use_vae or opt.use_blender or m.stage() != 1:
        raise ValueError("the one-process reference of the paired fp32/bf16 step only")
    m.netD.requires_grad_(False)
    try:
        _total, losses, fake, orient = m.generator_loss(batch, extra_dilate_steps)
    finally:
        m.netD.requires_grad_(True)
    if "ORIENT" in losses:
        tag = m.preprocess(batch)["input_tag"]
        n = fake.shape[0] // world
        per = [orient_loss(fake[i * n:(i + 1) * n], orient[i * n:(i + 1) * n],
                           tag[i * n:(i + 1) * n], opt) for i in range(world)]
        losses["ORIENT"] = sum(p[0] for p in per) / world * opt.lambda_orient
        if "CONFIDENCE" in losses:
            losses["CONFIDENCE"] = sum(p[1] for p in per) / world * opt.lambda_confidence
    trainer.optimizers["G"].zero_grad(set_to_none=True)
    sum(losses.values()).backward()
    trainer.optimizers["G"].step()
    trainer.step += 1
    return {k: v.detach() for k, v in losses.items()}, orient
