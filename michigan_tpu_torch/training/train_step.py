"""One G+D training step (port of michigan_tpu/training/train_step.py:107-192;
reference pix2pix_trainer.py:39-77): the G step, then the D step against a
fake recomputed with the updated netG.

The JAX package's one-program ``fused_step`` exists to hand XLA a single
dispatch; the port runs eagerly and does not have it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from michigan_tpu_torch.training.state import make_optimizers


class TrainStep:
    """Holds the model and its two optimizers; counts G steps."""

    def __init__(self, model):
        self.model = model
        self.opt = model.opt
        self.opt_g, self.opt_d = make_optimizers(model.opt, model.netG, model.netD)
        self.step = 0

    def g_step(self, batch: Dict[str, torch.Tensor], extra_dilate_steps: int = 2):
        """(losses by name, fake, orient).  netD's parameters take no
        gradient here: it is differentiated only with respect to its input."""
        m = self.model
        m.netD.requires_grad_(False)
        try:
            total, losses, fake, orient = m.generator_loss(batch, extra_dilate_steps)
        finally:
            m.netD.requires_grad_(True)
        self.opt_g.zero_grad(set_to_none=True)
        total.backward()
        self.opt_g.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}, fake.detach(), orient

    def d_step(self, batch: Dict[str, torch.Tensor], extra_dilate_steps: int = 2,
               orient: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """D's losses by name.  With --reuse_orient_for_d (the default) the G
        step's orientation is reused: the frozen IG gives the same."""
        if not (self.opt.reuse_orient_for_d and self.opt.use_ig):
            orient = None
        total, losses = self.model.discriminator_loss(batch, extra_dilate_steps, orient)
        self.opt_d.zero_grad(set_to_none=True)
        total.backward()
        self.opt_d.step()
        return {k: v.detach() for k, v in losses.items()}
