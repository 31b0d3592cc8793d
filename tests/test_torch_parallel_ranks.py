"""Rank bodies of tests/test_torch_parallel.py (no tests here).

Each body runs in a process that ``michigan_tpu_torch.parallel.dist.launch``
spawns, one torch thread, with a gloo group on the CPU whose timeout is
GROUP_TIMEOUT; it imports torch and the port only (not jax) and writes what
the test reads to ``<out>/<name><rank>.pt``.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
GLOBAL_BATCH = 4


def tiny_opt(**kw):
    """tests/test_data_parallel.py's tiny_opt in the port's Options (crop 64,
    ngf 8, ndf 8, no IG, `normal` upsampling), at GLOBAL_BATCH, with the DoG
    bank for the orientation loss: the Gabor bank's confidence is exactly 0
    at this crop, the DoG bank's is not, so every loss term is live."""
    from michigan_tpu_torch.config import Options

    d = dict(isTrain=True, crop_size=64, load_size=64, ngf=8, ndf=8, batchSize=GLOBAL_BATCH,
             use_encoder=True, use_ig=False, noise_background=True,
             num_upsampling_layers="normal", donate_buffers=False, gpu_ids="-1",
             orient_filter="dog")
    d.update(kw)
    return Options(**d).finalize()


def tiny_batch(opt, seed=0):
    """Paired synthetic samples (data/synthetic.py: hair ellipses of
    different sizes, so CONFIDENCE, a ratio over each slice's hair, tells
    the replicas' objective from the global batch's)."""
    from michigan_tpu_torch.data.synthetic import synthetic_train_data

    return synthetic_train_data(opt, seed, opt.batchSize)


def one_step(opt, data, group=None, world=1, extra=1, local_norms=False, states=None,
             post_g=None):
    """One G step then one D step from --seed's weights (or the per-net
    `states`) on `data` (this process's slice); {'losses', 'params': {net:
    {name: tensor}}, 'buffers'}: netG's parameters and buffers after the G
    step, netD's parameters after the D step.  Without a group and with
    `world` > 1: the G step of the `world`-replica objective
    (tools/replica_objective.py) on the whole batch.  `local_norms` drops
    the norms' group (each replica's own batch statistics) and keeps the
    gradients' and losses'.  `post_g`: netG's state_dict to load before the
    D step, as chip_smoke.py's phase 12 does, so that the D step is compared
    on its own (the G step's few Adam sign flips would move the fake the D
    step recomputes)."""
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.models.normalization import ParamFreeNorm
    from michigan_tpu_torch.tools import replica_objective
    from michigan_tpu_torch.training.train_step import TrainStep

    model = MichiGANModel(opt, "cpu", group)
    model.init_weights(opt.seed)
    if states is not None:
        model.load_state_dicts(states)
    if local_norms:
        for m in model.netG.modules():
            if isinstance(m, ParamFreeNorm):
                m.group = None
    trainer = TrainStep(model)
    batch = batch_from_numpy(data, "cpu")
    if group is None and world > 1:
        g, orient = replica_objective.g_step(trainer, batch, extra, world)
    else:
        g, _fake, orient = trainer.g_step(batch, extra)
    clone = lambda items: {k: v.detach().clone() for k, v in items}
    out = {"params": {"netG": clone(model.netG.named_parameters())},
           "buffers": clone(model.netG.named_buffers())}
    if post_g is not None:
        model.netG.load_state_dict(post_g)
    d = trainer.d_step(batch, extra, orient)
    out["params"]["netD"] = clone(model.netD.named_parameters())
    out["losses"] = {k: v.item() for k, v in {**g, **d}.items()}
    out["post_g"] = model.netG.state_dict() if post_g is None else None
    return out


def _replica():
    from michigan_tpu_torch.parallel.dist import replica_from_env

    torch.set_num_threads(1)
    return replica_from_env("-1", timeout=GROUP_TIMEOUT)


def _slice(arrays, rank, world):
    n = next(iter(arrays.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in arrays.items()}


def norms_and_step(out: str) -> None:
    """(a) batch_norm_train in float32 and bfloat16 on this rank's half of
    <out>/bn.npz (forward, dx for the cotangent there, running statistics);
    (b) one G+D step on this rank's half of tiny_batch, the D step from the
    one-process step's netG in <out>/post_g.pt; (b') the same with local
    norm statistics; (c) netG's gradients of this rank's G loss before
    and after average_gradients(bf16=True)."""
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.ops.norms import batch_norm_train
    from michigan_tpu_torch.parallel.dist import average_gradients

    rep = _replica()
    res = {}
    bn = _slice(dict(np.load(os.path.join(out, "bn.npz"))), rep.rank, rep.world)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(bn["x"]).permute(0, 3, 1, 2).to(dtype).requires_grad_()
        w = torch.from_numpy(bn["w"]).permute(0, 3, 1, 2).to(dtype)
        c = x.shape[1]
        y, rm, rv = batch_norm_train(x, torch.zeros(c), torch.ones(c), group=rep.group)
        y.backward(w)
        res[str(dtype)] = {"y": y.detach().float(), "dx": x.grad.float(), "rm": rm, "rv": rv}

    opt = tiny_opt()
    data = _slice(tiny_batch(opt), rep.rank, rep.world)
    post_g = torch.load(os.path.join(out, "post_g.pt"))
    res["step"] = one_step(opt, data, rep.group, post_g=post_g)
    res["control"] = one_step(opt, data, rep.group, local_norms=True, post_g=post_g)

    model = MichiGANModel(opt, "cpu", rep.group)
    model.init_weights(opt.seed)
    model.generator_loss(batch_from_numpy(data, "cpu"), 1)[0].backward()
    params = list(model.netG.parameters())
    local = torch.cat([p.grad.reshape(-1) for p in params]).clone()
    average_gradients(params, rep.group, bf16=True)
    res["grads"] = {"local": local, "mean": torch.cat([p.grad.reshape(-1) for p in params])}
    torch.save(res, os.path.join(out, f"ranks{rep.rank}.pt"))


def step_from_states(out: str) -> None:
    """(f) one G+D step on this rank's half of tiny_batch from the
    state_dicts in <out>/init.pt (the JAX package's initial variables)."""
    rep = _replica()
    opt = tiny_opt()
    data = _slice(tiny_batch(opt), rep.rank, rep.world)
    states = torch.load(os.path.join(out, "init.pt"))
    res = one_step(opt, data, rep.group, states=states)
    torch.save(res, os.path.join(out, f"from_states{rep.rank}.pt"))


def remat_and_plain_step(out: str) -> None:
    """(g) one G+D step on this rank's half of tiny_batch with --remat
    (every SPADE block and the VGG tower rematerialised) and without;
    <out>/remat<rank>.pt."""
    rep = _replica()
    data = _slice(tiny_batch(tiny_opt()), rep.rank, rep.world)
    res = {name: one_step(tiny_opt(remat=remat), data, rep.group)
           for name, remat in (("plain", False), ("remat", True))}
    torch.save(res, os.path.join(out, f"remat{rep.rank}.pt"))
