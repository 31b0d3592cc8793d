"""Rank bodies of tests/test_torch_spatial_train.py (no tests here).

Each body runs in a process that ``michigan_tpu_torch.parallel.dist.launch``
spawns, one torch thread, subnormals flushed, with a gloo group on the CPU
whose timeout is GROUP_TIMEOUT; it imports torch and the port only (not
jax) and writes what the test reads to ``<out>/<name><rank>.pt``.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from test_torch_spatial_ranks import CONVS, zero_halo

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
H, W = 32, 12  # the gradient cases' planes: 8 rows a band at P = 4, 16 at P = 2
# (name, rows above, rows below, pad) of the halo's gradchecks
HALOS = [("zeros_2_1", 2, 1, "zeros"), ("zeros_1_3", 1, 3, "zeros"),
         ("reflect_3_3", 3, 3, "reflect"), ("reflect_1_2", 1, 2, "reflect")]
EXTRA = 1  # the G and D steps' extra mask dilations


def _setup():
    from michigan_tpu_torch.parallel.spatial import space_from_env

    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    return space_from_env("-1", timeout=GROUP_TIMEOUT)


def _spaces(space):
    """{4: the world, 2: this rank's pair} (every rank makes both pairs)."""
    from michigan_tpu_torch.parallel.spatial import Space

    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return {4: space, 2: Space(pairs[space.rank // 2], space.rank % 2, 2, torch.device("cpu"))}


class _Replicated(torch.autograd.Function):
    """Identity forward on a tensor every rank holds; its backward sums the
    cotangents over the ranks (each rank's covers its own band's rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Total(torch.autograd.Function):
    """The sum over the ranks of each rank's value; its backward hands each
    rank the cotangent of its own value (the objective is the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_fn(bands, fn):
    """F(X) of the whole float64 plane X, the same on every rank: each rank
    applies `fn` to its band of Replicated(X), and _Total sums the ranks'
    values; so torch.autograd.gradcheck on every rank at once, in lockstep,
    checks the band code's backward (its collectives included) against
    the numerical derivative of F."""
    group = bands.space.group

    def f(x):
        a, b = bands.rows(x.shape[2])
        return _Total.apply(fn(_Replicated.apply(x, group)[:, :, a:b]), group)

    return f


def gradient_cases(spaces) -> dict:
    """At P = 4 (the world) and P = 2 (two pairs): gradcheck of the halo
    (float64, zeros and reflection), and for every conv case of
    tests/test_torch_spatial_ranks.py CONVS a stack of two band convs (the
    case's, then a 3x3) against the whole stack's input and weight
    gradients, VGG19 in float64 and the orientation loss; {(case, P):
    result}."""
    from michigan_tpu_torch.models.layers import Conv2d, ConvBlock
    from michigan_tpu_torch.parallel.spatial import Bands

    res = {}
    for p, sp in spaces.items():
        bands = Bands(sp)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(1, 2, H, 3, generator=gen, dtype=torch.float64, requires_grad=True)
        for name, lo, hi, pad in HALOS:
            w = torch.randn(1, 2, H // p + lo + hi, 3, generator=gen, dtype=torch.float64)
            f = global_fn(bands, lambda xb: (w * bands.halo(xb, lo, hi, pad) ** 2).sum())
            res[(name, p)] = torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-8,
                                                      raise_exception=False)
        torch.manual_seed(1)  # the modules' default init, the same on every rank
        xc = torch.randn(2, 3, H, W, generator=gen)
        a, b = bands.rows(H)
        for name, k, s, pad_, d, mode in CONVS:
            first = Conv2d(3, 4, k, s, pad_, d) if mode == "zeros" else \
                ConvBlock(3, 4, k, s, pad_, activation="none")
            if mode != "zeros":
                first.conv.dilation = (d, d)
            second = Conv2d(4, 5, 3, 1, 1)
            params = list(first.parameters()) + list(second.parameters())
            xw = xc.clone().requires_grad_(True)
            yw = second(first(xw))
            v = torch.randn(yw.shape, generator=gen)
            grads_w = torch.autograd.grad((v * yw).sum(), [xw] + params)
            xb = xc[:, :, a:b].clone().requires_grad_(True)
            if mode == "zeros":
                yb = bands.conv(first, xb)
            else:
                c = first.conv
                yb = bands._conv(xb, c.weight, c.bias, k, s, pad_, d, "reflect")
            yb = bands.conv(second, yb)
            ya, yb_ = bands.rows(yw.shape[2])
            grads_b = torch.autograd.grad((v[:, :, ya:yb_] * yb).sum(), [xb] + params)
            dparams = [bands._all_reduce(g) for g in grads_b[1:]]
            err_x = (grads_b[0] - grads_w[0][:, :, a:b]).abs().max().item()
            err_w = max((g - w_).abs().max().item() for g, w_ in zip(dparams, grads_w[1:]))
            res[(name, p)] = {"err_x": err_x, "err_w": err_w,
                              "scale": max(g.abs().max().item() for g in grads_w)}
        res[("orient_loss", p)] = orient_case(bands, gen)
        res[("vgg19", p)] = vgg_case(bands, gen)
    return res


def vgg_case(bands, gen):
    """VGG19 in bands (the towers of the VGG, content and style losses) in
    float64 against the whole tower: the input's and the weights'
    gradients of a weighted sum of its five slices (in float64 no 2x2 pool
    or ReLU takes another branch than the whole tower's): {'err', 'scale'}."""
    from michigan_tpu_torch.models.vgg import VGG19

    torch.manual_seed(2)
    vgg = VGG19().double()
    hw = (64, 16)
    a, b = bands.rows(hw[0])
    x = torch.randn(1, 3, *hw, generator=gen, dtype=torch.float64)
    params = list(vgg.parameters())
    xw = x.clone().requires_grad_(True)
    feats = vgg(xw)
    vs = [torch.randn(f.shape, generator=gen, dtype=torch.float64) for f in feats]
    gw = torch.autograd.grad(sum((v * f).sum() for v, f in zip(vs, feats)), [xw] + params)
    xb = x[:, :, a:b].clone().requires_grad_(True)
    fb = bands.vgg(vgg, xb)
    cut = [v[:, :, bands.rows(v.shape[2])[0]:bands.rows(v.shape[2])[1]] for v in vs]
    gb = torch.autograd.grad(sum((v * f).sum() for v, f in zip(cut, fb)), [xb] + params)
    dparams = [bands._all_reduce(g) for g in gb[1:]]
    err = max([(gb[0] - gw[0][:, :, a:b]).abs().max().item()] +
              [(g - w).abs().max().item() for g, w in zip(dparams, gw[1:])])
    return {"err": err, "scale": max(g.abs().max().item() for g in gw)}


def orient_case(bands, gen):
    """losses.orient.orient_loss on a band (``Bands`` as its reductions: the
    bank with its halo, its backward, the halo's adjoint) against the same
    function on the whole plane, on an image dark
    enough that the Gabor confidence is not saturated, so that its gradient
    is live: {'values': (band sums, whole), 'err': input gradient, 'scale'}."""
    from michigan_tpu_torch.config import Options
    from michigan_tpu_torch.losses.orient import orient_loss

    opt = Options(isTrain=True, use_ig=True).finalize()
    hw = 48
    a, b = bands.rows(hw)
    fake = (-1.0 + 0.02 * torch.rand(2, 3, hw, hw, generator=gen)).requires_grad_(True)
    orient = torch.rand(2, 2, hw, hw, generator=gen) * 2 - 1
    hair = (torch.rand(2, 1, hw, hw, generator=gen) > 0.4).float()
    tag = torch.cat([1 - hair, hair], dim=1)
    l1_w, conf_w = orient_loss(fake, orient, tag, opt)
    (g_w,) = torch.autograd.grad(l1_w + conf_w, fake)
    fb = fake.detach()[:, :, a:b].clone().requires_grad_(True)
    l1_b, conf_b = orient_loss(fb, orient[:, :, a:b], tag[:, :, a:b], opt, bands)
    (g_b,) = torch.autograd.grad(l1_b + conf_b, fb)
    sums = [bands.total(t).item() for t in (l1_b, conf_b)]
    return {"values": (sums, [l1_w.item(), conf_w.item()]),
            "err": (g_b - g_w[:, :, a:b]).abs().max().item(), "scale": g_w.abs().max().item(),
            "live": (g_w != 0).float().mean().item()}


def local_stats(control: bool):
    """The local-statistics control: netG's batch norms in bands take each
    band's own statistics (no group)."""
    from michigan_tpu_torch.parallel import spatial

    saved = spatial.batch_norm_train
    if control:
        spatial.batch_norm_train = lambda x, m, v, eps, group: saved(x, m, v, eps=eps)
    return saved


def band_step(model, sp, batch, post_g=None, g_only=False):
    """One G step (and unless `g_only` one D step, from the netG state_dict
    `post_g` when given) through TrainStep with the Space `sp` on this
    rank's band of `batch`: {'losses', 'params': {'netG', 'netD'},
    'buffers': netG's after the G step, 'fake': the whole fake, 'identical':
    whether every rank's nets equal rank 0's after the step}."""
    from michigan_tpu_torch.parallel import spatial
    from michigan_tpu_torch.parallel.dist import check_replicas_identical
    from michigan_tpu_torch.training.train_step import TrainStep

    tr = TrainStep(model, sp)
    band = spatial.shard_batch(batch, sp)
    g, fake, orient = tr.g_step(band, EXTRA)
    cpu = lambda items: {k: v.detach().clone() for k, v in items}
    res = {"losses": {k: v.item() for k, v in g.items()}, "fake": fake,
           "params": {"netG": cpu(model.netG.named_parameters())},
           "buffers": cpu(model.netG.named_buffers())}
    if not g_only:
        if post_g is not None:
            model.netG.load_state_dict(post_g)
        d = tr.d_step(band, EXTRA, orient)
        res["losses"].update({k: v.item() for k, v in d.items()})
        res["params"]["netD"] = cpu(model.netD.named_parameters())
    try:
        check_replicas_identical([t for net in model.nets().values()
                                  for t in (*net.parameters(), *net.buffers())], sp.group)
        res["identical"] = True
    except RuntimeError:
        res["identical"] = False
    return res


def train_steps(spaces, out: str, configs, controlled) -> dict:
    """For each config name in `configs` (its options and states saved by
    the test in <out>/<name>.pt with the batch and the unsharded step's
    post-G netG): the band step on each of `spaces` ({P: Space}; the D
    step from that post-G netG), and for the config `controlled` at P = 2
    the zero-halo and local-statistics controls' G steps; {(name, P, run):
    band_step's result}."""
    from michigan_tpu_torch.model import MichiGANModel
    from michigan_tpu_torch.parallel import spatial

    res = {}
    for name in configs:
        saved = torch.load(f"{out}/{name}.pt", weights_only=False)
        for p, sp in spaces.items():
            runs = ["step"] + (["zero_halo", "local_stats"]
                               if p == 2 and name == controlled else [])
            for run in runs:
                model = MichiGANModel(saved["opt"], "cpu")
                model.load_state_dicts(saved["states"])
                normal = spatial.Bands.neighbour_rows
                if run == "zero_halo":
                    spatial.Bands.neighbour_rows = zero_halo
                bn = local_stats(run == "local_stats")
                try:
                    res[(name, p, run)] = band_step(model, sp, saved["batch"], saved["post_g"],
                                                    run != "step")
                finally:
                    spatial.Bands.neighbour_rows = normal
                    spatial.batch_norm_train = bn
    return res


def gradients(out: str) -> None:
    """gradient_cases in one process group of 4 ranks; writes
    <out>/gradients<rank>.pt."""
    space = _setup()
    try:
        torch.save(gradient_cases(_spaces(space)), f"{out}/gradients{space.rank}.pt")
    finally:
        dist.destroy_process_group()


def steps(out: str, name: str, controlled: bool) -> None:
    """train_steps of the config `name` (with its controls if
    `controlled`) on the launched ranks, all one Space; writes
    <out>/steps_<name><rank>.pt."""
    space = _setup()
    try:
        torch.save(train_steps({space.world: space}, out, [name], name if controlled else None),
                   f"{out}/steps_{name}{space.rank}.pt")
    finally:
        dist.destroy_process_group()


def train_cli(argv) -> None:
    """The trainer's CLI on this rank, one torch thread."""
    from michigan_tpu_torch.train import main

    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    main(argv)
