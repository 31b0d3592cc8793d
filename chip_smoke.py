#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (michigan_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the flagship inference path (IG orientation inpainting -> partial-conv
appearance encoder -> noise background encoder -> SPADEB generator with
eval-mode running stats) at full width (ngf 64, 512^2 crop, add_feat_zeros:
generator planes up to 576^2) through the port's own `infer`, on seeded
random weights and a seeded numpy sample.  Phases, each on its own line:

  1. card name and power limit (nvidia-smi), torch and CUDA versions; TF32
     off for cuDNN convolutions and matmuls
  2. build the CUDA kernels from michigan_tpu_torch/csrc with nvcc
  3. each kernel against its plain PyTorch version at every distinct shape
     of the path, float32 (atol 1e-4, rtol 1e-5) and bfloat16 (atol 1e-2,
     rtol 1.6e-2, about two bf16 ulps)
  4. the slice on the card, counting kernel launches: 18 spade_modulate and
     29 fused_instance_norm per forward
  5. the same weights and inputs on the CPU (plain versions): tanh output
     within 2e-3 max abs, PSNR of the uint8 image > 50 dB
  6. timings (median): each kernel and its plain version at the path's
     shapes, end-to-end ms/image at batch 1 and 8, peak device memory, and
     a torch.profiler breakdown of one batch-1 forward

Then a JSON line of per-kernel results and, last, the device line.  Any
failure exits non-zero without the device line; so does a machine without
CUDA, and a directory without the rest of the repository.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

FLAGS = ("--netG spadeb --use_encoder --noise_background --use_ig --expand_mask_be "
         "--expand_th 5 --add_feat_zeros --init_type none --gpu_ids 0").split()

# distinct shapes of the path at batch 1: (C, H=W) of the generator's SPADE
# norms, and (C, H=W, act) of the inpainter's norms, with calls per forward
SPADE_SHAPES = {(1024, 9): 2, (1024, 18): 2, (1024, 36): 2, (1024, 72): 2, (512, 72): 1,
                (512, 144): 2, (256, 144): 1, (256, 288): 2, (128, 288): 1,
                (128, 576): 2, (64, 576): 1}
IN_SHAPES = {(64, 256, "lrelu"): 1, (128, 128, "lrelu"): 1, (256, 64, "lrelu"): 1,
             (256, 64, "relu"): 12, (256, 64, None): 12, (128, 128, "relu"): 1,
             (64, 256, "relu"): 1}
TOLS = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1.6e-2)}
REPLACES = {"spade_modulate": "michigan_tpu/ops/pallas/spade.py:285",
            "fused_instance_norm": "michigan_tpu/ops/pallas/spade.py:207"}
SOURCE = "michigan_tpu_torch/csrc/spade_norm.cu"
SEED = 0


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, torch, graph, reps=5, inner=20):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    by CUDA events.  With `graph`, the calls are captured once in a CUDA
    graph and replayed, which leaves the host's launch cost out: device
    time.  Without, the calls are launched from Python as the path
    launches them: at small shapes that measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run_all = g.replay
    else:
        def run_all():
            for _ in range(inner):
                fn()
    run_all()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run_all()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def kernel_inputs(torch, kind, c, h, dtype, gen, n=1):
    """As the path gives them: spade_modulate's gamma and beta are the two
    channel halves of one (n, 2C, H, W) conv output."""
    x = torch.randn((n, c, h, h), generator=gen).to("cuda", dtype)
    if kind == "spade_modulate":
        mean = torch.randn(c, generator=gen).cuda()
        inv = torch.rand(c, generator=gen).add(0.5).cuda()
        gamma_beta = torch.randn((n, 2 * c, h, h), generator=gen).to("cuda", dtype)
        return (x, mean, inv, *gamma_beta.chunk(2, dim=1))
    return (x,)


def run():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from michigan_tpu_torch.data.synthetic import synthetic_inference_data
        from michigan_tpu_torch.inference import parse_options
        from michigan_tpu_torch.model import MichiGANModel, batch_from_numpy
        from michigan_tpu_torch.ops.cuda import build
        from michigan_tpu_torch.ops.cuda import spade as K
        from michigan_tpu_torch.utils.imaging import tensor2im
    except ImportError as e:
        print(f"FAIL: the port is not importable here: {e}", file=sys.stderr)
        return 1
    import numpy as np

    # 1 ---------------------------------------------------------------
    card = card_info()
    tag = f"[{card}]"
    phase(1, f"card: {card}")
    phase(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase(1, "TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False "
             "(cuDNN's fp32 convolutions default to TF32)")

    # 2 ---------------------------------------------------------------
    lib = build.library_path("spade_norm")
    prebuilt = lib.exists()
    t0 = time.perf_counter()
    build.load("spade_norm")
    phase(2, f"{lib.name}: {'already built, loaded' if prebuilt else 'nvcc build and load'} "
             f"in {time.perf_counter() - t0:.2f} s")

    # 3 ---------------------------------------------------------------
    plain = {"spade_modulate": K.spade_modulate_plain,
             "fused_instance_norm": K.fused_instance_norm_plain}
    kern = {"spade_modulate": K.spade_modulate, "fused_instance_norm": K.fused_instance_norm}
    cases = [("spade_modulate", c, h, None) for c, h in SPADE_SHAPES]
    cases += [("fused_instance_norm", c, h, act) for c, h, act in IN_SHAPES]
    max_err = {k: 0.0 for k in kern}
    gen = torch.Generator().manual_seed(SEED)
    failed = []
    for dname, tol in TOLS.items():
        dtype = getattr(torch, dname)
        for kind, c, h, act in cases:
            inp = kernel_inputs(torch, kind, c, h, dtype, gen)
            kw = {} if kind == "spade_modulate" else {"act": act}
            got = kern[kind](*inp, **kw)
            want = plain[kind](*inp, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **tol)
            if dname == "float32":
                max_err[kind] = max(max_err[kind], err)
            print(f"[phase 3] {kind} {dname} (1,{c},{h},{h}) act={act}: "
                  f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((kind, dname, c, h, act))
    # batch 8 (the halves of gamma/beta lie apart per sample), and the
    # modulated instance norm (SPADE's instance variant, off the path)
    x, g, b = (torch.randn((1, 256, 64, 64), generator=gen).cuda() for _ in range(3))
    extra = {"spade_modulate float32 (8,512,72,72)":
             (kern["spade_modulate"], plain["spade_modulate"],
              kernel_inputs(torch, "spade_modulate", 512, 72, torch.float32, gen, n=8)),
             "fused_instance_norm float32 (1,256,64,64) with gamma/beta":
             (kern["fused_instance_norm"], plain["fused_instance_norm"], (x, g, b))}
    for label, (fk, fp, inp) in extra.items():
        got, want = fk(*inp), fp(*inp)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **TOLS["float32"])
        print(f"[phase 3] {label}: max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(label)
    if failed:
        print(f"FAIL: kernel disagrees with its plain version: {failed}", file=sys.stderr)
        return 1
    del inp, got, want, x, g, b, extra  # not live when phase 6 reads peak memory

    # 4 ---------------------------------------------------------------
    opt = parse_options(FLAGS + ["--seed", str(SEED)])
    model = MichiGANModel(opt, "cuda:0")
    model.init_weights(SEED)
    data = synthetic_inference_data(opt, SEED)
    batch = batch_from_numpy(data, "cuda:0")
    K.reset_launch_counts()
    fake, orient_rgb = model.infer(batch)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    phase(4, f"slice on the card: fake {tuple(fake.shape)}, orient_rgb "
             f"{tuple(orient_rgb.shape)}, launches {counts}")
    if counts != {"spade_modulate": 18, "fused_instance_norm": 29}:
        print(f"FAIL: expected 18 spade_modulate and 29 fused_instance_norm "
              f"launches, got {counts}", file=sys.stderr)
        return 1
    size = opt.generator_input_size()
    if fake.shape != (1, 3, size, size) or not torch.isfinite(fake).all() \
            or fake.abs().max() > 1 or fake.std() < 1e-3:
        print(f"FAIL: generator output is wrong: shape {tuple(fake.shape)}, "
              f"std {fake.std().item()}", file=sys.stderr)
        return 1
    phase(4, f"output finite, in [-1,1], std {fake.std().item():.4f}")

    # 5 ---------------------------------------------------------------
    cpu = MichiGANModel(opt, "cpu")
    cpu.load_state_dicts({k: {n: t.cpu() for n, t in net.state_dict().items()}
                          for k, net in model.nets().items()})
    t0 = time.perf_counter()
    fake_cpu, _ = cpu.infer(batch_from_numpy(data, "cpu"))
    cpu_s = time.perf_counter() - t0
    diff = (fake.cpu() - fake_cpu).abs().max().item()
    r = opt.add_th // 2
    crop = lambda t: tensor2im(t.permute(0, 2, 3, 1).cpu().numpy()[
        0, r : r + opt.crop_size, r : r + opt.crop_size])
    mse = np.mean((crop(fake).astype(np.float64) - crop(fake_cpu)) ** 2)
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    phase(5, f"card vs CPU: max_abs {diff:.3e} (limit 2e-3), PSNR {psnr:.2f} dB "
             f"(limit 50); CPU forward {cpu_s:.1f} s")
    if not diff <= 2e-3 or not psnr > 50:
        print("FAIL: card and CPU outputs disagree", file=sys.stderr)
        return 1

    # 6 ---------------------------------------------------------------
    # per forward, summed over the path's calls: device time (CUDA graph
    # replay) and time as launched from Python
    kernel_ms, plain_ms = {k: 0.0 for k in kern}, {k: 0.0 for k in kern}
    kernel_host_ms, plain_host_ms = {k: 0.0 for k in kern}, {k: 0.0 for k in kern}
    for kind, c, h, act in cases:
        calls = SPADE_SHAPES[(c, h)] if kind == "spade_modulate" else IN_SHAPES[(c, h, act)]
        inp = kernel_inputs(torch, kind, c, h, torch.float32, gen)
        kw = {} if kind == "spade_modulate" else {"act": act}
        fk = lambda: kern[kind](*inp, **kw)
        fp = lambda: plain[kind](*inp, **kw)
        tk, tp = median_ms(fk, torch, True), median_ms(fp, torch, True)
        hk, hp = median_ms(fk, torch, False), median_ms(fp, torch, False)
        kernel_ms[kind] += calls * tk
        plain_ms[kind] += calls * tp
        kernel_host_ms[kind] += calls * hk
        plain_host_ms[kind] += calls * hp
        print(f"[phase 6] {kind} (1,{c},{h},{h}) act={act} x{calls}/forward: "
              f"device kernel {tk * 1e3:.1f} us, plain {tp * 1e3:.1f} us; "
              f"launched from Python kernel {hk * 1e3:.1f} us, plain {hp * 1e3:.1f} us "
              f"{tag}", flush=True)
    del inp, fk, fp
    for kind in kern:
        phase(6, f"{kind} per forward: device kernel {kernel_ms[kind]:.3f} ms, plain "
                 f"{plain_ms[kind]:.3f} ms; launched from Python kernel "
                 f"{kernel_host_ms[kind]:.3f} ms, plain {plain_host_ms[kind]:.3f} ms {tag}")

    def e2e(n, reps):
        b = batch_from_numpy(synthetic_inference_data(opt, SEED, batch=n), "cuda:0")
        model.infer(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            model.infer(b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3 / n, torch.cuda.max_memory_allocated(), live

    for n, reps in ((1, 10), (8, 5)):
        ms, mem, live = e2e(n, reps)
        phase(6, f"end to end batch {n}: {ms:.2f} ms/image, peak device memory "
                 f"{mem / 2**30:.2f} GiB, of which {live / 2**30:.2f} GiB live before the "
                 f"forward (weights, inputs, this script's tensors) {tag}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.infer(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    # the table's own footer: device time summed over the kernels
    busy = re.search(r"Self (?:CUDA|device) time total: ([\d.]+)(us|ms|s)\b", table)
    busy_ms = float(busy.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[busy.group(2)]
    phase(6, f"profiled batch-1 forward: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
             f"wall under the profiler {tag}; top device time:")
    print(table, flush=True)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": counts[k], "max_abs_err": max_err[k], "ms": kernel_ms[k],
         "plain_ms": plain_ms[k]} for k in kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
