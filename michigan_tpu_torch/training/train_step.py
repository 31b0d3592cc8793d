"""One G+D training step (port of michigan_tpu/training/train_step.py:107-245;
reference pix2pix_trainer.py:39-77): the G step, then the D step against a
fake recomputed with the updated netG (netE, netB), or under
--reuse_fake_for_d (not with --use_blender) against the G step's fake
(JAX train_step.py:220-262).

Under --unpairTrain the stage is read from ``opt.curr_step`` on each call,
as the JAX package's wrappers pick their compiled stage: stage 2 trains
netD2 in its D step, stage 1 netD.  Under --use_vae the G step draws the
VAE's eps (``MichiGANModel.draw_eps``) unless given one, and the D step
reuses the last draw unless given one: the JAX package hands one step rng
to both.

The JAX package's one-program ``fused_step`` exists to hand XLA a single
dispatch; the port runs eagerly and does not have it.

Data parallelism (the model's ``group``; the JAX package's sharded steps):
each replica's batch is its slice of the global batch; after each backward
and before Adam every trained net's gradients are averaged over the group
in one flattened all-reduce a net (in bfloat16 under
--bf16_grad_allreduce), and the losses returned are the group's means.  The
VAE's eps of a replica is its slice of one draw for the global batch, so
the replicas together draw what one process does.  Overlapping the
reduction with the backward (DDP's buckets) is not done.

Spatial sharding (a ``Space``, parallel/spatial.py; --mesh_shape space:N):
every rank takes its band of the crop's rows of the same batch
(``spatial.shard_batch``) and runs the paired stage's G and D steps in row
bands, each rank's objective its share of the one process's; after each
backward every trained net's gradients are summed over the group (not
averaged: the shares add up to the whole), and the losses returned are the
group's sums of the shares.  The G step returns the whole fake (on every
rank) and this band of the orientation, which the D step reuses.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from michigan_tpu_torch.parallel import spatial
from michigan_tpu_torch.parallel.dist import average_gradients, mean_over
from michigan_tpu_torch.training.state import g_net_names, make_optimizers


class TrainStep:
    """Holds the model and its optimizers ('G', 'D', and 'D2' under
    --unpairTrain); counts G steps.  With a `space` (a spatial.Space of two
    or more ranks, the model on its device and without a data-parallel
    group) the steps run in row bands over it."""

    def __init__(self, model, space: Optional[spatial.Space] = None):
        self.model = model
        self.opt = model.opt
        self.group = model.group
        self.space = space
        self.bands = None
        if space is not None:
            if model.group is not None:
                raise NotImplementedError(
                    "the data x space grid (data parallelism over replicas that each train in "
                    "row bands) is not ported yet; it is the next slice of spatial training")
            spatial.check_spatial_train(model.opt, space.world)
            self.bands = spatial.Bands(space)
        self.optimizers = make_optimizers(model.opt, model)
        self.step = 0
        self.eps: Optional[torch.Tensor] = None

    @property
    def ranks_group(self):
        """The group whose rank 0 alone writes checkpoints and logs (the
        data-parallel group or the spatial one; None with one process)."""
        return self.space.group if self.space is not None else self.group

    def new_eps(self, n: int) -> Optional[torch.Tensor]:
        """A fresh draw of the VAE's eps for this replica's batch of `n`
        (None without --use_vae), kept for the D step."""
        if not self.opt.use_vae:
            self.eps = None
        elif self.group is None:
            self.eps = self.model.draw_eps(n)
        else:
            rank, world = self.group.rank(), self.group.size()
            self.eps = self.model.draw_eps(n * world)[rank * n:(rank + 1) * n]
        return self.eps

    def _all_reduce(self, nets: Iterable[torch.nn.Module], losses: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """With a group: each net's gradients and the losses averaged over
        it (the JAX package's _grad_pmean and pmean of the losses); with a
        Space, summed over its ranks."""
        losses = {k: v.detach() for k, v in losses.items()}
        if self.space is not None:
            for net in nets:
                average_gradients(net.parameters(), self.space.group, mean=False)
            return mean_over(losses, self.space.group, mean=False)
        if self.group is None:
            return losses
        for net in nets:
            average_gradients(net.parameters(), self.group, self.opt.bf16_grad_allreduce)
        return mean_over(losses, self.group)

    def g_step(self, batch: Dict[str, torch.Tensor], extra_dilate_steps: int = 2,
               eps: Optional[torch.Tensor] = None):
        """(losses by name, fake, orient); fake is netG's image before any
        blend (None under --only_blend).  The discriminators' parameters take
        no gradient here: they are differentiated only with respect to their
        input."""
        m = self.model
        if self.opt.use_vae:
            self.eps = eps if eps is not None else self.new_eps(batch["image_ref"].shape[0])
        ds = [d for d in (m.netD, m.netD2) if d is not None]
        for d in ds:
            d.requires_grad_(False)
        try:
            total, losses, fake, orient = m.generator_loss(batch, extra_dilate_steps, self.eps,
                                                           bands=self.bands)
        finally:
            for d in ds:
                d.requires_grad_(True)
        opt_g = self.optimizers["G"]
        nets = m.nets()
        trained = [nets[n] for n in g_net_names(self.opt)] if opt_g is not None else []
        if opt_g is not None:
            opt_g.zero_grad(set_to_none=True)
            total.backward()
        losses = self._all_reduce(trained, losses)
        if opt_g is not None:
            opt_g.step()
        self.step += 1
        return losses, None if fake is None else fake.detach(), orient

    def d_step(self, batch: Dict[str, torch.Tensor], extra_dilate_steps: int = 2,
               orient: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None,
               fake: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The stage's D's losses by name.  With --reuse_orient_for_d (the
        default) the G step's orientation is reused: the frozen IG gives the
        same.  With --reuse_fake_for_d the G step's `fake` is, when given."""
        if not (self.opt.reuse_orient_for_d and self.opt.use_ig):
            orient = None
        if not (self.opt.reuse_fake_for_d and not self.opt.use_blender):
            fake = None
        if eps is not None:
            self.eps = eps
        elif self.opt.use_vae and self.eps is None:
            self.new_eps(batch["image_ref"].shape[0])
        total, losses = self.model.discriminator_loss(batch, extra_dilate_steps, orient,
                                                      self.eps, fake_image=fake, bands=self.bands)
        stage2 = self.model.stage() == 2
        optim = self.optimizers["D2" if stage2 else "D"]
        optim.zero_grad(set_to_none=True)
        total.backward()
        losses = self._all_reduce([self.model.netD2 if stage2 else self.model.netD], losses)
        optim.step()
        return losses
