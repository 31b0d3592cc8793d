"""Rank bodies of tests/test_torch_spatial.py (no tests here).

Each body runs in a process that ``michigan_tpu_torch.parallel.dist.launch``
spawns, one torch thread, subnormals flushed, with a gloo group on the CPU
whose timeout is GROUP_TIMEOUT; it imports torch and the port only (not
jax) and writes what the test reads to ``<out>/<name><rank>.pt``.
"""

from __future__ import annotations

import datetime
import types

import torch
import torch.distributed as dist

GROUP_TIMEOUT = datetime.timedelta(seconds=60)
H, W = 32, 12  # the layer cases' planes: 8 rows a band at P = 4, 16 at P = 2
# (name, kernel, stride, padding, dilation, padding mode) of the conv cases
CONVS = [("zero_k3_s1", 3, 1, 1, 1, "zeros"), ("zero_k3_s1_d2", 3, 1, 2, 2, "zeros"),
         ("zero_k3_s2", 3, 2, 1, 1, "zeros"), ("zero_k4_s2", 4, 2, 1, 1, "zeros"),
         ("zero_k7_s1", 7, 1, 3, 1, "zeros"), ("zero_k1_s1", 1, 1, 0, 1, "zeros"),
         ("reflect_k7_s1", 7, 1, 3, 1, "reflect"), ("reflect_k4_s2", 4, 2, 1, 1, "reflect"),
         ("reflect_k3_s1", 3, 1, 1, 1, "reflect"), ("reflect_k3_s1_d2", 3, 1, 2, 2, "reflect")]
OTHERS = ["spectral_k3", "partial_conv", "partial_conv_mask", "instance_norm",
          "masked_mean", "resize_band", "resize_whole", "expanded_back_mask", "gather_rows",
          "conv_bf16", "instance_norm_bf16"]
LAYER_CASES = [c[0] for c in CONVS] + OTHERS


def _setup():
    from michigan_tpu_torch.parallel.spatial import space_from_env

    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    return space_from_env("-1", timeout=GROUP_TIMEOUT)


def layer_outputs(bands, gen):
    """{case: (whole output of the layer, this band's output)} on seeded
    inputs, the same on every rank."""
    from michigan_tpu_torch.models.encoders import _expanded_back_mask
    from michigan_tpu_torch.models.layers import Conv2d, ConvBlock, PartialConv, SpectralConv2d
    from michigan_tpu_torch.ops.norms import instance_norm
    from michigan_tpu_torch.ops.stats import masked_region_mean

    a, b = bands.rows(H)
    band = lambda t: t[:, :, a:b].contiguous()
    x = torch.randn(2, 3, H, W, generator=gen)
    out = {}
    for name, k, s, p, d, mode in CONVS:
        if mode == "zeros":
            m = Conv2d(3, 4, k, s, p, d)
            out[name] = (m(x), bands.conv(m, band(x)))
        elif d == 1:
            blk = ConvBlock(3, 4, k, s, p)
            out[name] = (blk(x), bands.conv_block(blk, band(x)))
        else:  # ConvBlock has no dilation: its conv, dilated, under the same padding
            blk = ConvBlock(3, 4, k, s, p, activation="none")
            c = blk.conv
            c.dilation = (d, d)
            out[name] = (blk(x), bands._conv(band(x), c.weight, c.bias, k, s, p, d, "reflect"))
    sc = SpectralConv2d(3, 4, 3, padding=1).eval()
    for t in (sc.weight_orig, sc.weight_u, sc.weight_v):
        t.data.copy_(torch.randn(t.shape, generator=gen))
    out["spectral_k3"] = (sc(x), bands.conv(sc, band(x)))
    pc = PartialConv(3, 4, 3, 2, 1)
    mask = (torch.rand(2, 1, H, W, generator=gen) > 0.6).float()
    (y, m), (yb, mb) = pc(x, mask), bands.partial_conv(pc, band(x), band(mask))
    out["partial_conv"], out["partial_conv_mask"] = (y, yb), (m, mb)
    shifted = x * 3 + 2
    out["instance_norm"] = (instance_norm(shifted), bands.instance_norm(band(shifted)))
    mm = masked_region_mean(x, mask)
    out["masked_mean"] = (mm.expand_as(x), bands.masked_mean(band(x), band(mask)).expand(
        -1, -1, b - a, W))
    from michigan_tpu_torch.ops.resize import resize_nearest

    out["resize_band"] = (resize_nearest(x, (H // 4, W // 4)),
                          bands.resize_nearest(band(x), H, (H // 4, W // 4)))
    out["resize_whole"] = (resize_nearest(x, (5, 7)),
                           bands.resize_nearest(band(x), H, (5, 7), whole=True))
    # the frame of --add_feat_zeros: a hair mask across the crop's edges
    opt = types.SimpleNamespace(isTrain=False, expand_mask_be=True, expand_th=5,
                                add_feat_zeros=True, crop_size=H - 8, add_th=8)
    hair = (torch.rand(2, 1, H, H, generator=gen) > 0.8).float()
    seg = torch.cat([1 - hair, hair], dim=1)
    out["expanded_back_mask"] = (_expanded_back_mask(opt, seg),
                                 bands.expanded_back_mask(opt, band(hair), H))
    out["gather_rows"] = (x, band(bands.gather_rows(band(x))))
    m16 = Conv2d(3, 4, 3, 1, 1)
    x16 = x.bfloat16()
    out["conv_bf16"] = (m16(x16), bands.conv(m16, band(x16)))
    out["instance_norm_bf16"] = (instance_norm(shifted.bfloat16()),
                                 bands.instance_norm(band(shifted.bfloat16())))
    return out


def band_layers(out: str) -> None:
    """Every layer case at P = 4 (the world) and P = 2 (two pairs): the
    largest |band - the whole layer's rows of the band| a case."""
    from michigan_tpu_torch.parallel.spatial import Bands, Space

    space = _setup()
    try:
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        spaces = {4: space, 2: Space(pairs[space.rank // 2], space.rank % 2, 2,
                                     torch.device("cpu"))}
        res = {}
        for p, sp in spaces.items():
            bands = Bands(sp)
            gen = torch.Generator().manual_seed(0)
            torch.manual_seed(1)  # the modules' default init, the same on every rank
            for name, (whole, got) in layer_outputs(bands, gen).items():
                h = whole.shape[2]
                a, b = bands.rows(h) if got.shape[2] != h else (0, h)
                want = whole[:, :, a:b]
                res[(name, p)] = {"shape_ok": got.shape == want.shape,
                                  "err": (got.float() - want.float()).abs().max().item()
                                  if got.shape == want.shape else float("inf")}
        torch.save(res, f"{out}/layers{space.rank}.pt")
    finally:
        dist.destroy_process_group()


def zero_halo(bands, x, lo, hi):
    """The control's neighbour rows: zeros in place of the neighbours'."""
    z = lambda n: x.new_zeros((x.shape[0], x.shape[1], n, x.shape[3]))
    r, p = bands.r, bands.P
    return (z(lo) if lo and r > 0 else None), (z(hi) if hi and r < p - 1 else None)


def spatial_infer(out: str, flags, dtypes, control: bool) -> None:
    """make_spatial_infer under each of `dtypes` on the weights and batch
    the test saved (the outputs on rank 0 alone), then (`control`) in
    float32 with zeros in place of the neighbours' halo rows, gathered on
    every rank; rank 0 writes the gathered outputs."""
    from michigan_tpu_torch.inference import parse_options
    from michigan_tpu_torch.model import MichiGANModel
    from michigan_tpu_torch.parallel import spatial

    space = _setup()
    try:
        states, batch = torch.load(f"{out}/states.pt"), torch.load(f"{out}/batch.pt")
        res = {}
        runs = [(d, d) for d in dtypes] + ([("control", "float32")] if control else [])
        for name, dtype in runs:
            model = MichiGANModel(parse_options(flags + ["--dtype", dtype]), "cpu")
            model.load_state_dicts(states)
            if name == "control":  # gathered on every rank
                spatial.Bands.neighbour_rows = zero_halo
                res[name] = spatial.make_spatial_infer(model, space, to_all=True)(batch)
                if res[name][0] is None:
                    raise RuntimeError(f"rank {space.rank} got no output with to_all")
            else:
                res[name] = spatial.make_spatial_infer(model, space)(batch)
                if (res[name][0] is None) != (space.rank != 0):
                    raise RuntimeError(f"rank {space.rank}: the output goes to rank 0 alone")
        if space.rank == 0:
            torch.save(res, f"{out}/spatial.pt")
    finally:
        dist.destroy_process_group()
