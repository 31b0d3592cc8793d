"""Which cuDNN algorithms the convolutions of netG's float32 training step
take on the card, and how far each lands from float64.

    python3 chip_smoke.py --conv_algorithms \
        [--init_type xavier] [--crop 512] [--ups more|most] [--no_table]
        [--native PREFIX[,PREFIX...] ...]

``main`` takes the training config, the seed, the mask dilation and the
scale-aware rule from its caller (chip_smoke.py, which holds them for its
phases 11 and 12).  One G step of that config (bench.py's flags, full
width, batch 1, ``--init_type`` as given, default the config's own xavier;
``--ups most`` the 1024^2 configuration's generator, with up_4)
records every convolution that reaches netG's parameters: its input, the
weight it was given, and the gradient of its output in the step's backward.
Each is then replayed alone on those tensors: in float32 through cuDNN
(TF32 off), as the step runs it, with the CUDA kernels of its forward and
its backward from torch.profiler; in float32 with cuDNN off (PyTorch's own
im2col + GEMM, float32 throughout); and in float64.  Per convolution it
prints the kernels and, for each float32 route, the elements of the weight
gradient whose sign differs from float64's (Adam's first step moves each
parameter by about +-lr along that sign, so these are the elements the
scale-aware rule of chip_smoke.py's phase 12 counts) and the largest error
of the weight and the input gradient over their largest magnitude.

Then the G step on the card against the same step on the CPU by phase 12's
rule (netG's parameters: at most 0.1% of the elements beyond float noise),
as the port runs it (the generator's ``CUDNN_OFF`` blocks off cuDNN), with
every convolution on cuDNN (under its default, its deterministic and its
benchmarked choice of algorithms), and, for each --native group
(comma-separated prefixes; "" names every block), with cuDNN off for the
generator's blocks whose names start with one of the group's prefixes and
on for the rest (the generator's ``cudnn_off_blocks``).
Needs a card; nothing here runs on the CPU alone.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

CONVS = (F.conv2d, F.conv_transpose2d)


class RecordConvs(TorchFunctionMode):
    """Records every conv whose weight takes a gradient: (module name, op,
    x, w, the other arguments) and, through a hook, its output's gradient."""

    def __init__(self, names):
        super().__init__()
        self.names, self.records = names, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in CONVS and self.names and args[1].requires_grad and torch.is_grad_enabled():
            rec = {"name": self.names[-1], "func": func,
                   "x": args[0].detach(), "w": args[1].detach(), "rest": args[2:],
                   "kwargs": kwargs}
            out.register_hook(lambda g, rec=rec: rec.__setitem__("g", g.detach()))
            self.records.append(rec)
        return out


def name_stack(net):
    """A list that holds the names of the modules being run, innermost last."""
    stack, handles = [], []

    def leave(_m, _a, _o):
        stack.pop()  # and return None: a forward hook's value replaces the output

    for name, m in net.named_modules():
        handles.append(m.register_forward_pre_hook(lambda _m, _a, n=name: stack.append(n)))
        handles.append(m.register_forward_hook(leave))
    return stack, handles


@contextlib.contextmanager
def cudnn_off_blocks(net, prefixes):
    """Inside, the generator `net` runs with cuDNN off the blocks whose
    names start with one of `prefixes` (none for no prefix)."""
    saved = net.cudnn_off_blocks
    net.cudnn_off_blocks = tuple(n for n, _ in net.named_children()
                                 if prefixes and n.startswith(tuple(prefixes)))
    try:
        yield
    finally:
        net.cudnn_off_blocks = saved


def replay(rec, dtype, cudnn, backward=True):
    """(y, dx, dw) of one recorded conv in `dtype` (without `backward`: y)."""
    x = rec["x"].to(dtype).requires_grad_()
    w = rec["w"].to(dtype).requires_grad_()
    rest = tuple(a.to(dtype) if isinstance(a, torch.Tensor) else a for a in rec["rest"])
    with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        y = rec["func"](x, w, *rest, **rec["kwargs"])
        if not backward:
            return y
        dx, dw = torch.autograd.grad(y, (x, w), rec["g"].to(dtype))
    return y, dx, dw


def kernel_names(fn):
    """The CUDA kernels one call of fn launches, by name, in order."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    names = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in names:
            names.append(e.name)
    return names


def short(name: str) -> str:
    return name if len(name) <= 90 else name[:87] + "..."


def rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-300)).item()


def step_params(model, batch, extra):
    from michigan_tpu_torch.training.train_step import TrainStep

    TrainStep(model).g_step(batch, extra)
    return {k: v.detach().cpu() for k, v in model.netG.named_parameters()}


def main(argv, train_flags, seed, extra, scale_aware, card_info):
    """`train_flags`: the training config's flags; `extra`: the mask's
    extra dilation steps; `scale_aware(got, want, max_lr)` -> (ok, max
    diff, elements beyond float noise, elements); `card_info()`: the card's
    name and power limit."""
    from michigan_tpu_torch.data.synthetic import synthetic_train_data
    from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
    from michigan_tpu_torch.models.layers import frozen_buffers
    from michigan_tpu_torch.train import parse_options

    ap = argparse.ArgumentParser()
    ap.add_argument("--init_type", default="xavier")
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--ups", default="more", choices=("normal", "more", "most"),
                    help="--num_upsampling_layers")
    ap.add_argument("--native", nargs="*", default=[])
    ap.add_argument("--no_table", action="store_true", help="only the G step comparison")
    ap.add_argument("--device", default="cuda:0", help="cpu: a rehearsal at a small --crop")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info() if dev.type == "cuda" else "the CPU"
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    flags = [f for f in train_flags if f not in ("none",)]
    flags = [f for f in flags if f != "--init_type"] + ["--init_type", args.init_type]
    opt = parse_options(flags + ["--num_upsampling_layers", args.ups,
                                 "--batchSize", "1", "--crop_size", str(args.crop),
                                 "--load_size", str(args.crop), "--seed", str(seed)])
    model = MichiGANModel(opt, dev)
    model.init_weights(seed)
    data = synthetic_train_data(opt, seed, 1)
    batch = batch_from_numpy(data, dev)
    print(f"card: {card}; torch {torch.__version__}; init {args.init_type}, batch 1, "
          f"{args.crop}^2, --num_upsampling_layers {args.ups}, ngf {opt.ngf}", flush=True)

    # the step's convolutions, with their output gradients (every conv on
    # cuDNN, so that each reaches F.conv2d with autograd recording)
    stack, handles = name_stack(model.netG)
    rec = RecordConvs(stack)
    with frozen_buffers(model.netG), cudnn_off_blocks(model.netG, []), rec:
        total, _losses, _fake, _orient = model.generator_loss(batch, extra)
    for h in handles:
        h.remove()
    total.backward()
    model.netG.zero_grad(set_to_none=True)
    model.netD.zero_grad(set_to_none=True)
    rows, flips = [], {"cudnn": 0, "native": 0}
    n_w = 0
    for r in rec.records:
        if "g" not in r or args.no_table:
            continue
        y64, dx64, dw64 = replay(r, torch.float64, True)
        row = {"name": r["name"], "op": r["func"].__name__, "x": tuple(r["x"].shape),
               "w": tuple(r["w"].shape)}
        for route, cudnn in (("cudnn", True), ("native", False)):
            y, dx, dw = replay(r, torch.float32, cudnn)
            s = int((torch.sign(dw.double()) != torch.sign(dw64)).sum())
            flips[route] += s
            row[route] = (s, rel(y, y64), rel(dx, dx64), rel(dw, dw64))
        n_w += dw64.numel()
        row["fwd"] = kernel_names(lambda: replay(r, torch.float32, True, backward=False))
        row["all"] = kernel_names(lambda: replay(r, torch.float32, True))
        rows.append(row)
        del y64, dx64, dw64, y, dx, dw
    rows.sort(key=lambda t: -t["cudnn"][0])
    print(f"{len(rows)} convolutions reach netG's parameters; weight-gradient elements whose "
          f"sign differs from float64's: cuDNN {flips['cudnn']}, cuDNN off {flips['native']} "
          f"of {n_w} [{card}]")
    for t in rows:
        c, n = t["cudnn"], t["native"]
        bwd = [k for k in t["all"] if k not in t["fwd"]]
        print(f"- {t['name']} {t['op']} x {t['x']} w {t['w']}: sign flips cuDNN {c[0]} / off "
              f"{n[0]}; error over float64 (y, dx, dw) cuDNN {c[1]:.1e} {c[2]:.1e} {c[3]:.1e}, "
              f"off {n[1]:.1e} {n[2]:.1e} {n[3]:.1e}\n    forward: "
              f"{'; '.join(short(k) for k in t['fwd'])}\n    backward: "
              f"{'; '.join(short(k) for k in bwd)}", flush=True)
    del rec, rows, total

    # the G step, card against CPU, by phase 12's rule
    cpu_model = MichiGANModel(opt, "cpu")
    cpu_model.load_state_dicts({k: {n_: t.cpu() for n_, t in net.state_dict().items()}
                                for k, net in model.nets().items()})
    state = {k: {n_: t.clone() for n_, t in net.state_dict().items()}
             for k, net in model.nets().items()}
    t0 = time.perf_counter()
    want = step_params(cpu_model, batch_from_numpy(data, "cpu"), extra)
    print(f"CPU G step {time.perf_counter() - t0:.1f} s", flush=True)
    every = lambda: cudnn_off_blocks(model.netG, [])

    @contextlib.contextmanager
    def flags(**kw):
        with every(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False, **kw):
            yield

    routes = {"as the port runs it": contextlib.nullcontext,
              "every conv on cuDNN": every,
              "every conv on cuDNN, deterministic": lambda: flags(benchmark=False,
                                                                  deterministic=True),
              "every conv on cuDNN, benchmark": lambda: flags(benchmark=True,
                                                              deterministic=False)}

    for group in args.native:
        prefixes = group.split(",")
        routes[f"cuDNN off for {prefixes} only"] = \
            lambda prefixes=prefixes: cudnn_off_blocks(model.netG, prefixes)
    for label, ctx in routes.items():
        model.load_state_dicts(state)
        t0 = time.perf_counter()
        with ctx():
            got = step_params(model, batch, extra)
        sync()
        dt = time.perf_counter() - t0
        ok, worst, bad, tot = scale_aware(got, want, opt.lr / 2)
        print(f"G step card vs CPU, {label}: {bad} of {tot} elements beyond float noise "
              f"({bad / tot:.4%}; phase 12's limit {max(1e-3 * tot, 8):.0f}), max diff "
              f"{worst:.2e}: {'within' if ok else 'past'} the rule; {dt:.2f} s, the first step of "
              f"this route [{card}]", flush=True)
    return 0
