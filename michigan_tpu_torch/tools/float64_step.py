"""The G step in float64 on the CPU, as a witness for float32 steps, and the
blender config's conditioning on the card.

``g_step64`` runs one G step of the port on the CPU in float64 from float32
state dicts: while it runs, every ``.float()`` of the port is ``.double()``
and new tensors default to float64 (constants made in float32, such as the
filter bank, keep their values).  ``adam_grads`` reads a G step's gradients
back from Adam's first moment.  chip_smoke.py's phase 16 judges the
blender config's card step by them.

``branch_masks`` records the branches a float32 step took (which elements
each ``F.relu`` and ``F.leaky_relu`` call passed, which element of each
window ``F.max_pool2d`` took, the signs ``Tensor.abs`` saw), and makes a
float64 step of the same code take the same ones (``g_step64(...,
branches=...)``): that step differs from the float32 one by rounding alone.
A value within float32 rounding of such a switch sends the two steps'
gradients down different branches, and one such element can move a net's
whole gradient by a percent (tests/test_torch_vae_blender.py).

    env PYTHONPATH=. python -m michigan_tpu_torch.tools.float64_step

runs the blender config's G step (chip_smoke.py's training flags plus
--use_blender, 256^2, ngf 32, ndf 32, batch 2, torch's default init) on the
CPU in float32 and in float64, then on the card per route of the
convolutions: as built (4 repeats, each profiled: the names of the
device kernels it ran), each net's convolutions off cuDNN (PyTorch's own
im2col + GEMM; 3 repeats each) and all of them.  Each line
prints netG's and netB's elements beyond float noise by phase 12's
scale-aware rule against the CPU's float32 step and against the float64
one, and each net's gradient error relative to the float64 gradient.  Last,
the G+D step at batch 8, 512^2, full width per route, in turns.  Needs a
card; ~3 minutes.

    env PYTHONPATH=. python -m michigan_tpu_torch.tools.float64_step --terms

runs on the CPU only: per loss term of the same G step, the norm of
netG's gradient of head_0.conv_0 in float64 and its float32 error
relative to it, and the same at the blend and at the fake that netB
blends (~3 minutes).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch
import torch.nn.functional as F

WITNESS_NETS = ("netG", "netB")


@contextlib.contextmanager
def branch_masks(replay=None, inputs=None):
    """Inside, each F.relu and F.leaky_relu call records which elements of
    its input are > 0, each F.max_pool2d call which element of each window
    it took, and each Tensor.abs call the signs of its input, and yields the
    list of those records in call order; or, given `replay` (such a list,
    from a float32 run of the same code), takes the next record's choices
    instead of reading its own input (raises if the calls do not line
    up).  Given a list `inputs`, a recording run appends each call's input
    to it (for ``branch_margins``)."""
    relu, leaky_relu = F.relu, F.leaky_relu
    masks = [] if replay is None else None
    todo = None if replay is None else iter(replay)

    def recorded(like, what):
        m = next(todo, None)
        if m is None or m.shape != like.shape:
            raise RuntimeError(f"no recorded branch for {what} of shape {tuple(like.shape)}")
        return m

    def record(x, choice):
        masks.append(choice)
        if inputs is not None:
            inputs.append(x.detach().clone())

    def mask_of(x):
        if todo is None:
            record(x, x > 0)
            return None
        return recorded(x, "an activation")

    def relu_(x, inplace=False):
        m = mask_of(x)
        if m is None:
            return relu(x, inplace)
        return x.mul_(m) if inplace else x * m

    def leaky_relu_(x, negative_slope=0.01, inplace=False):
        m = mask_of(x)
        return leaky_relu(x, negative_slope, inplace) if m is None else \
            torch.where(m, x, x * negative_slope)

    def max_pool2d_(x, *args, **kwargs):
        y, idx = max_pool2d(x, *args, **{**kwargs, "return_indices": True})
        if todo is None:
            record(x, idx)
            return y
        return x.flatten(2).gather(2, recorded(idx, "a max pool").flatten(2)).view_as(y)

    def abs_(x):
        if todo is None:
            record(x, torch.sign(x).to(torch.int8))
            return tensor_abs(x)
        return x * recorded(x, "an abs")

    max_pool2d, tensor_abs = F.max_pool2d, torch.Tensor.abs
    F.relu, F.leaky_relu, F.max_pool2d = relu_, leaky_relu_, max_pool2d_
    torch.Tensor.abs = abs_
    try:
        yield masks
    finally:
        F.relu, F.leaky_relu, F.max_pool2d = relu, leaky_relu, max_pool2d
        torch.Tensor.abs = tensor_abs
    if todo is not None and next(todo, None) is not None:
        raise RuntimeError("recorded branches left over: the runs took different paths")


def branch_margins(a, b, inputs):
    """[(call, kind, shape, elements, margin)] of each call where the branch
    record `a` (``branch_masks`` of a float32 step) differs from `b` (of a
    float64 step of the same code, which recorded its calls' `inputs`):
    kind 'relu' (F.relu, F.leaky_relu), 'max_pool' or 'abs'; elements, how
    many of its choices differ; margin, how far from the switch the float64
    input lay at the farthest of them, in float32 ulps of the call's input
    (float32's eps times its largest magnitude): |x| for a relu or an abs,
    for a max pool the window's maximum less the element `a` took.  A
    margin of a few ulps is a choice that float32's rounding can flip."""
    kinds = {torch.bool: "relu", torch.int64: "max_pool", torch.int8: "abs"}
    out = []
    for i, (x, y, v) in enumerate(zip(a, b, inputs)):
        differ = x != y
        if not differ.any():
            continue
        v = v.double()
        if x.dtype == torch.int64:
            flat = v.flatten(2)
            taken = flat.gather(2, x.flatten(2)) - flat.gather(2, y.flatten(2))
            gap = taken.abs().view_as(x)[differ]
        else:
            gap = v.abs()[differ]
        ulp = torch.finfo(torch.float32).eps * v.abs().max()
        out.append((i, kinds[x.dtype], tuple(x.shape), int(differ.sum()),
                    (gap.max() / ulp).item()))
    return out


def g_step64(opt, init, batch, eps, nets, extra_dilate_steps, branches=None):
    """(losses {name: float}, gradients and parameters after the step, each
    {net: {name: tensor}} of `nets`) of one G step on the CPU in float64
    from the float32 state dicts `init`, the float32 `batch` and `eps`;
    with `branches` (``branch_masks``' record of a float32 G step of the same
    config and batch) on that step's branches."""
    from michigan_tpu_torch.model import MichiGANModel
    from michigan_tpu_torch.training.train_step import TrainStep

    to_float, default = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda t, *a, **k: t.double(*a, **k)
    torch.set_default_dtype(torch.float64)
    try:
        m = MichiGANModel(opt, "cpu")
        m.load_state_dicts(init)
        m.compute_dtype = torch.float64
        for net in m.nets().values():
            net.double()
        tr = TrainStep(m)
        with branch_masks(branches) if branches is not None else contextlib.nullcontext():
            losses, _, _ = tr.g_step({k: v.double() for k, v in batch.items()},
                                     extra_dilate_steps, None if eps is None else eps.double())
        params = {k: {n: p.detach().clone() for n, p in m.nets()[k].named_parameters()}
                  for k in nets}
        return {k: v.item() for k, v in losses.items()}, adam_grads(tr, nets), params
    finally:
        torch.Tensor.float = to_float
        torch.set_default_dtype(default)


def adam_grads(trainer, nets):
    """{net: {name: gradient}} (float64, on the CPU) of the G step that
    `trainer` took first: Adam's first moment after one step is (1 - beta1)
    times the gradient."""
    adam = trainer.optimizers["G"]
    beta1 = adam.param_groups[0]["betas"][0]
    return {k: {n: (adam.state[p]["exp_avg"] / (1 - beta1)).detach().double().cpu()
                for n, p in trainer.model.nets()[k].named_parameters()} for k in nets}


def rel_err(got, want):
    """||got - want|| / ||want|| over all of a net's gradients."""
    num = sum(((got[n].double() - w) ** 2).sum() for n, w in want.items())
    return (num / sum((w ** 2).sum() for w in want.values())).sqrt().item()


def term_errors(opt, init, batch, extra):
    """{term: {where: (float64 norm, float32 relative error)}} of one G
    step's loss terms on the CPU: netG's head_0.conv_0 gradient, and the
    gradients at the blend (netB's output) and at the fake (its input)."""
    from michigan_tpu_torch.model import MichiGANModel

    runs = {}
    for dtype in (torch.float32, torch.float64):
        to_float, default = torch.Tensor.float, torch.get_default_dtype()
        if dtype == torch.float64:
            torch.Tensor.float = lambda t, *a, **k: t.double(*a, **k)
            torch.set_default_dtype(torch.float64)
        try:
            m = MichiGANModel(opt, "cpu")
            m.load_state_dicts(init)
            m.compute_dtype = dtype
            for net in m.nets().values():
                net.to(dtype)
            m.netD.requires_grad_(False)
            seen = {}
            blend_forward = m.netB.forward

            def forward(hair, *a, **k):
                seen["fake"] = hair
                seen["blend"] = blend_forward(hair, *a, **k)
                return seen["blend"]

            m.netB.forward = forward
            _, losses, _, _ = m.generator_loss({k: v.to(dtype) for k, v in batch.items()}, extra)
            w = m.netG.head_0.conv_0.weight_orig
            runs[dtype] = {
                term: dict(zip(("head_0.conv_0", "blend", "fake"), (
                    g.detach().double() for g in torch.autograd.grad(
                        v, [w, seen["blend"], seen["fake"]], retain_graph=True))))
                for term, v in losses.items()}
        finally:
            torch.Tensor.float = to_float
            torch.set_default_dtype(default)
    f32, f64 = runs[torch.float32], runs[torch.float64]
    return {term: {k: (g.norm().item(), ((f32[term][k] - g).norm() / g.norm()).item())
                   for k, g in f64[term].items()} for term in f64}


def main(argv=()):
    import chip_smoke
    from michigan_tpu_torch.data.synthetic import synthetic_train_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.models.layers import cudnn_off
    from michigan_tpu_torch.train import parse_options
    from michigan_tpu_torch.training.train_step import TrainStep

    terms = "--terms" in argv
    if not terms and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seed, extra = chip_smoke.SEED, chip_smoke.EXTRA_DILATE
    flags = chip_smoke.TRAIN_FLAGS + ["--use_blender", "--seed", str(seed)]
    opt = parse_options(flags + ["--batchSize", "2", "--crop_size", "256", "--load_size", "256",
                                 "--ngf", "32", "--ndf", "32"] + (["--gpu_ids", "-1"] if terms
                                                                  else []))
    if terms:
        model = MichiGANModel(opt, "cpu")
        model.init_weights(seed)
        init = {k: net.state_dict() for k, net in model.nets().items()}
        rows = term_errors(opt, init, batch_from_numpy(synthetic_train_data(opt, seed, 2), "cpu"),
                           extra)
        print(f"the blender config's G step on the CPU at 256^2, ngf 32, batch 2, --init_type "
              f"{opt.init_type}: per loss term, the float64 gradient's norm and the float32 "
              f"gradient's error relative to it", flush=True)
        for term, row in rows.items():
            print(f"  {term}: " + "; ".join(f"{k} {n:.3e}, error {e:.2e}"
                                            for k, (n, e) in row.items()), flush=True)
        return 0
    card = chip_smoke.card_info()
    model = MichiGANModel(opt, "cuda:0")
    model.init_weights(seed)
    init = {k: {n: t.detach().cpu().clone() for n, t in net.state_dict().items()}
            for k, net in model.nets().items()}
    data = synthetic_train_data(opt, seed, 2)
    lr = opt.lr / 2

    def route(m, off):
        """Each net of `off` runs its float32 convolutions off cuDNN."""
        for name in off:
            net = m.nets()[name]
            net.forward = routed(type(net).forward.__get__(net))

    def routed(fwd):
        def forward(*a, **k):
            with cudnn_off():
                return fwd(*a, **k)
        return forward

    def g_step(dev, off=(), kernels=None):
        """(parameters, gradients) of one G step; the names of the device
        kernels it ran are added to `kernels` when given."""
        m = MichiGANModel(opt, dev)
        m.load_state_dicts(init)
        route(m, off)
        tr = TrainStep(m)
        b = batch_from_numpy(data, dev)
        if kernels is None:
            tr.g_step(b, extra)
        else:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                tr.g_step(b, extra)
                torch.cuda.synchronize()
            kernels.update(e.name for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
        params = {k: {n: p.detach().cpu() for n, p in m.nets()[k].named_parameters()}
                  for k in WITNESS_NETS}
        return params, adam_grads(tr, WITNESS_NETS)

    def row(params, grads):
        return "; ".join(
            f"{k}: {chip_smoke.scale_aware(cpu[k], params[k], lr)[2]} against the CPU, "
            f"{chip_smoke.scale_aware(params[k], exact[k], lr)[2]} against float64, "
            f"gradient error {rel_err(grads[k], g64[k]):.2e}" for k in WITNESS_NETS)

    cpu, g32 = g_step("cpu")
    _, g64, exact = g_step64(opt, init, batch_from_numpy(data, "cpu"), None, WITNESS_NETS, extra)
    print(f"card: {card}; the blender config's G step at 256^2, ngf 32, batch 2, --init_type "
          f"{opt.init_type}; phase 12's limit 0.1% of a net's elements beyond float noise "
          f"(netG 31650, netB 4718)", flush=True)
    print("the CPU's float32 step: " + "; ".join(
        f"{k}: {chip_smoke.scale_aware(cpu[k], exact[k], lr)[2]} against float64, gradient "
        f"error {rel_err(g32[k], g64[k]):.2e}" for k in WITNESS_NETS), flush=True)
    routes = {"as built": (), "VGG19 off cuDNN": ("vgg",), "netD off cuDNN": ("netD",),
              "netG off cuDNN": ("netG",), "netB off cuDNN": ("netB",),
              "netIG off cuDNN": ("netIG",),
              "all off cuDNN": ("vgg", "netD", "netG", "netB", "netIG")}
    seen = []
    for label, off in routes.items():
        for _ in range(4 if not off else 3):
            if not off:
                seen.append(set())
            print(f"  the card, {label}: " + row(*g_step("cuda:0", off, seen[-1] if not off
                                                          else None)), flush=True)
    print(f"  the device kernels of the 4 steps as built: {len(seen[0])} names in the first; "
          f"the others' differ by {[sorted(k ^ seen[0]) for k in seen[1:]]}", flush=True)
    del model

    opt8 = parse_options(flags + ["--batchSize", "8", "--crop_size", "512", "--load_size", "512"])
    m8 = MichiGANModel(opt8, "cuda:0")
    m8.init_weights(seed)
    tr = TrainStep(m8)
    batch = batch_from_numpy(synthetic_train_data(opt8, seed, 8), "cuda:0")
    nets = {k: tr.model.nets()[k] for k in ("vgg", "netD", "netG", "netB", "netIG")}
    times = {label: [] for label in routes}
    for rep in range(3):
        for label, off in routes.items():
            for net in nets.values():
                net.forward = type(net).forward.__get__(net)
            route(tr.model, off)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.d_step(batch, extra, tr.g_step(batch, extra)[2])
            torch.cuda.synchronize()
            if rep:
                times[label].append((time.perf_counter() - t0) * 1e3)
    print("the G+D step at batch 8, 512^2, ngf 64, ms (median of 2 in turns after a warm-up): "
          + ", ".join(f"{k} {statistics.median(v):.1f}" for k, v in times.items())
          + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv[1:]))
