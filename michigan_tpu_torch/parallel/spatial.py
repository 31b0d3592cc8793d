"""Spatial sharding of inference and training (port of
michigan_tpu/parallel/spatial.py), NCHW.

The JAX package shards H of every activation over a ('space',) mesh axis
and lets GSPMD insert the convolutions' halo exchanges, in inference and in
the ordinary G and D steps alike.  PyTorch has no GSPMD: here the P ranks of
one process group (a ``Space``) each hold one contiguous band of rows of
every large plane and take the rows a convolution reads across a band's
edge from their neighbours (``Bands.halo``), by hand.  The purpose is the
JAX module's: memory at 1024^2, where the generator's planes reach 1152^2
in inference and a training step's activations outgrow one card's batch.

Bands.  A plane of global height h is sharded when h % P == 0 and each
band holds at least MIN_BAND_ROWS rows (the SPADE conditioning's halo):
rank r holds rows [r h/P, (r+1) h/P).  Otherwise it is whole on every rank
and computed redundantly by the module itself (under `most` at 1152 with
P = 4 the 9^2 and 18^2 planes of head_0 and G_middle_0).  Which planes are
sharded follows from the shapes alone (``plane_plan``).  Whole to sharded
is a local slice; sharded to whole is one all_gather, where the appearance
encoder's output is resized bilinearly to the seed
(models/encoders.py ImageEncoder3).  What else crosses bands:

- a convolution's halo rows (``halo_rows``), the global top and bottom
  padded as the layer pads: zeros (Conv2d, PartialConv, the SPADE convs,
  VGG19's convs, the filter bank), reflection (the background encoder's
  ConvBlocks), -inf (the max-pools of the expanded background mask, which
  pad at the crop's edge by global row index, inside the bands, as
  ``_expanded_back_mask`` does under --add_feat_zeros);
- the instance norms of the appearance encoder and its masked mean:
  per-(n, c) sums all-reduced in float32;
- the SPADE conditioning resized onto a whole plane: an all-reduce of the
  rows each band holds (the others' are zeros).  On a sharded plane each
  rank takes its band with MIN_BAND_ROWS halo rows once a plane, so that
  the SPADE's two stacked 3x3 convs run without a further exchange;
- the orientation inpainter's 256^2 input: each rank nearest-resizes its
  band of the crop's rows to 256/P rows, one all_gather gives the whole.
  The IG runs whole on every rank (its attention at 64^2 reads every row)
  and each rank upsamples the rows of its band out of its 256^2 output.

So no rank holds a full-size plane of the generator, its encoders or the
crop on the device.  In inference the kernels run as in
``MichiGANModel.infer``: each SPADE norm is one ``spade_modulate`` launch
on the band (eval mode: the running statistics, nothing to reduce), the
IG's 29 ``fused_instance_norm`` launches on every rank.

Training (``TrainStep`` with a Space; ``--mesh_shape space:N``).  Each rank
takes its band of the crop's rows (``shard_batch``), and the G and D steps
run the paired stage in bands with autograd through them:

- every collective is differentiable: the halo's backward sends the
  cotangent of each received row back to the rank that owns it, which adds
  it onto its edge rows (at the frame's top and bottom the adjoint follows
  the pad: zeros and -inf drop it, reflection adds it onto the mirrored
  rows); an all-reduce's backward is an all-reduce; an all_gather's is a
  reduce-scatter (an all-reduce of the cotangent, then this rank's rows);
- netG's sync batch norms (train mode) take their (sum, sum of squares,
  count) over the group (ops/norms.py ``batch_norm_train``), so the count
  is the global count of rows and the running statistics come out the same
  on every rank; spectral convs iterate u once a forward, as one process;
- the frozen IG runs whole on every rank under no_grad, as above (its 29
  ``fused_instance_norm`` launches a rank a step); the D step recomputes
  the fake in bands with netG's buffers frozen;
- VGG19 runs in bands (its 2x2 pools are band-local: a band's rows stay
  even), the no-grad tag + ref tower's ``features_2`` as one
  ``conv3x3_same_lowch`` launch on the band with one halo row each side,
  whose outer rows are cropped; the orientation loss runs the filter bank
  (``filterbank_orientation`` and its backward) on the band's gray plane
  with 8 halo rows each side, cropped after;
- netD runs whole on every rank, on the all-gathered fake, real image,
  labels and orientation: its planes (513, 257, 129, 130, 131 rows at
  1024) do not divide into bands.

One rule for the gradients: the sum over the ranks of each rank's objective
is the one process's objective.  A term over pixels enters with its band's
share of the global mean (the band's sum over the global count); a term
computed whole on every rank (the GAN and GAN-feature terms, D's hinge, the
style term's per-channel statistics) enters with weight 1/P.  The losses
are MichiGANModel's and losses/*.py's own, handed this module's ``Bands``
as their reductions (losses/reduce.py: ``mean``, ``total``, ``whole``,
``mean_std``) and band forms (``vgg``, ``orientation_response``, the IG,
netG, the gather of netD's planes).  So every parameter gradient is a sum
over the group (``TrainStep``), and the losses reported are the group's
sums of the shares.  The replicas stay bit for bit equal: the same summed
gradients, the same Adam step, the same all-reduced statistics.

Transport.  NCCL groups move device tensors (batch_isend_irecv,
all_gather, gather, all_reduce).  In gloo groups (the CPU, or several
ranks on one card) the halo rows and the gathers travel as host tensors:
a CUDA tensor is copied to the host, sent, and the received rows copied
back, and 2-byte floats travel as bytes; an all-reduce takes the device
tensor, as the sync batch norms' does (ops/norms.py).

Inference runs the flagship's flags (--netG spadeb --use_encoder
--noise_background --use_ig --expand_mask_be --add_feat_zeros) at
--num_upsampling_layers normal, more or most, either dtype, eval mode,
--inpaint_mode ref; ``check_spatial`` raises for any other option and for a
frame whose bands do not align with the layers.  Training runs the
training flags (--use_encoder --use_ig --noise_background, with or without
--random_expand_mask) in float32 with every default loss;
``check_spatial_train`` raises for the data x space grid, --dtype bfloat16
and the other options it names, which are the next slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import (
    SpectralConv2d,
    cast_params,
    conv,
    cudnn_off,
)
from michigan_tpu_torch.models.normalization import parse_spade_config
from michigan_tpu_torch.models.vgg import LOWCH_CONV, PLAN as VGG_PLAN
from michigan_tpu_torch.ops.cuda.lowch import conv3x3_same_lowch
from michigan_tpu_torch.ops.cuda.orient import OrientationResponse
from michigan_tpu_torch.ops.cuda.spade import spade_modulate
from michigan_tpu_torch.ops.filters import KERNEL_SIZE
from michigan_tpu_torch.ops.masks import one_hot_label
from michigan_tpu_torch.ops.norms import batch_norm_train, instance_norm
from michigan_tpu_torch.ops.resize import (
    max_pool_same,
    resize_bilinear,
    resize_nearest,
    upsample2x_nearest,
)
from michigan_tpu_torch.ops.stats import masked_region_mean
from michigan_tpu_torch.parallel.dist import TIMEOUT, all_reduce_sum, replica_from_env

SPACE_AXIS = "space"
IG_SIZE = 256        # the inpainter's plane (model.py _run_ig)
ENCODER_STRIDE = 32  # the appearance encoder's five stride-2 layers
MIN_BAND_ROWS = 2    # the SPADE conditioning's halo: two stacked 3x3 convs
VGG_STRIDE = 16      # VGG19's four 2x2 pools before relu5_1
BANK_HALO = KERNEL_SIZE // 2  # the filter bank's 17x17 reach
HALF = (torch.bfloat16, torch.float16)  # sent as bytes: gloo has no 2-byte types
GEN_KEYS = ("input_ref", "input_tag", "orient", "image_ref", "image_tag", "noise")


@dataclass(frozen=True)
class Space:
    """The ranks of one spatial group: its process group (None: one rank),
    this rank's band, the number of bands and the device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device

    def staged(self) -> bool:
        """Whether the halo rows and the gathers go through host tensors
        (gloo holding CUDA tensors)."""
        return self.group is not None and self.device.type == "cuda" and \
            dist.get_backend(self.group) == "gloo"


def space_from_env(gpu_ids: str, timeout=TIMEOUT) -> Space:
    """This process's Space from torchrun's environment (or ``launch``'s), as
    ``parallel.dist.replica_from_env`` makes a replica: NCCL on the card
    --gpu_ids[LOCAL_RANK], gloo under --gpu_ids -1."""
    r = replica_from_env(gpu_ids, timeout=timeout)
    return Space(r.group, r.rank, r.world, r.device)


# options outside both paths: (flag, whether it is set)
def _common_refusals(opt) -> List[str]:
    out = []
    for flag, on in (("--use_vae", opt.use_vae), ("--use_blender", opt.use_blender),
                     ("--orient_random_disturb", opt.orient_random_disturb),
                     ("--weight_norm_G", opt.weight_norm_G), ("--no_orientation",
                                                             opt.no_orientation),
                     ("--use_clip", opt.use_clip), ("--bf_direct_add", opt.bf_direct_add),
                     ("--random_noise_background", opt.random_noise_background)):
        if on:
            out.append(flag)
    for flag, on in (("--use_encoder", opt.use_encoder), ("--use_ig", opt.use_ig),
                     ("--noise_background", opt.noise_background)):
        if not on:
            out.append(f"no {flag}")
    if opt.Image_encoder_mode != "partialconv":
        out.append(f"--Image_encoder_mode {opt.Image_encoder_mode}")
    if not opt.no_instance:
        out.append("--no_instance False")
    if parse_spade_config(opt.norm_G.replace("spectral", ""))[0] == "instance":
        out.append(f"--norm_G {opt.norm_G}")
    if opt.aspect_ratio != 1.0:
        out.append(f"--aspect_ratio {opt.aspect_ratio}")
    return out


def check_spatial(opt, world: int) -> None:
    """Inference: raise NotImplementedError for an option outside the ported
    path and ValueError for a frame whose bands do not align with its
    layers."""
    out = []
    if opt.isTrain:
        out.append("--isTrain (training in row bands runs through TrainStep with a Space; "
                   "check_spatial_train)")
    out += _common_refusals(opt)
    for flag, on in (("--expand_mask_be", opt.expand_mask_be),
                     ("--add_feat_zeros", opt.add_feat_zeros)):
        if not on:
            out.append(f"no {flag}")
    if opt.inpaint_mode != "ref":
        out.append(f"--inpaint_mode {opt.inpaint_mode}")
    if out:
        raise NotImplementedError(f"spatial sharding of inference does not run {', '.join(out)}")
    frame = opt.generator_input_size()
    if world < 1 or frame % world or (frame // world) % ENCODER_STRIDE:
        raise ValueError(
            f"spatial sharding over {world} ranks needs the generator's frame (--crop_size "
            f"{opt.crop_size} + --add_th {opt.add_th} = {frame}) / {world} to be a multiple of "
            f"{ENCODER_STRIDE} (the appearance encoder's five stride-2 layers; the nearest "
            f"resizes by 16); it is {frame / world:g}")
    if IG_SIZE % world:
        raise ValueError(f"spatial sharding over {world} ranks needs {world} to divide the "
                         f"inpainter's {IG_SIZE} rows")
    k = opt.expand_th
    if max(int(k / 2), k - 1 - int(k / 2)) > frame // world:
        raise ValueError(f"--expand_th {k}: the max-pool's halo exceeds a band of "
                         f"{frame // world} rows")


def expand_kernels(opt, h: int, extra_dilate_steps: int) -> List[int]:
    """The max-pool sizes of --random_expand_mask's dilation of the hair at
    a crop of `h` rows (_expanded_back_mask): int(0.05 h) made odd, less 4,
    then `extra_dilate_steps` 3x3 ones."""
    th = int(h * opt.random_expand_th)
    th = th if th % 2 == 1 else th + 1
    return [max(th - 4, 1)] + [3] * extra_dilate_steps


MAX_EXTRA_DILATE = 4  # the trainer's draw of extra 3x3 dilations (train.py)


def check_spatial_train(opt, world: int) -> None:
    """Training: raise NotImplementedError for an option outside the ported
    path (the float32 paired stage on the training flags) and ValueError
    for a crop whose bands do not align with its layers or cannot hold a
    halo."""
    out = _common_refusals(opt)
    if not opt.isTrain:
        out.append("no --isTrain")
    if opt.dtype != "float32":
        out.append(f"--dtype {opt.dtype} (bfloat16 in row bands is the next slice)")
    for flag, on in (("--add_feat_zeros", opt.add_feat_zeros),
                     ("--unpairTrain", opt.unpairTrain), ("--remat", opt.remat),
                     ("--reuse_fake_for_d", opt.reuse_fake_for_d),
                     ("--remove_background", opt.remove_background),
                     ("--balance_Lab", opt.balance_Lab), ("--fused_step", opt.fused_step)):
        if on:
            out.append(flag)
    if "gabor" not in opt.orient_filter and not opt.no_orient_loss:
        out.append(f"--orient_filter {opt.orient_filter}")
    if out:
        raise NotImplementedError(f"spatial sharding of training does not run {', '.join(out)}")
    crop = opt.crop_size
    if world < 2 or crop % world or (crop // world) % VGG_STRIDE:
        raise ValueError(
            f"spatial training over {world} ranks needs at least 2 ranks and --crop_size "
            f"{crop} / {world} to be a multiple of {VGG_STRIDE} (VGG19's and the background "
            f"encoder's stride-2 layers); it is {crop / world:g}")
    if IG_SIZE % world:
        raise ValueError(f"spatial training over {world} ranks needs {world} to divide the "
                         f"inpainter's {IG_SIZE} rows")
    band = crop // world
    need = {"the filter bank's": BANK_HALO}
    if opt.random_expand_mask:
        need["--random_expand_mask's dilation"] = sum(
            k // 2 for k in expand_kernels(opt, crop, MAX_EXTRA_DILATE))
    for what, rows in need.items():
        if rows > band:
            raise ValueError(f"{what} halo of {rows} rows exceeds a band of {band} rows")


def halo_rows(k: int, stride: int, padding: int, dilation: int,
              band_start: int) -> Tuple[int, int]:
    """(lo, hi): the rows above and below a band of input rows that a
    convolution (kernel k, stride, padding on both sides, dilation) reads to
    give the band's outputs, rows [band_start / stride, ...), for a band that
    starts at global row `band_start` and spans a multiple of `stride` rows.
    3x3 s1 p1: (1, 1); 4x4 s2 p1: (1, 1); 3x3 s2 p1: (1, 0); 7x7 s1 p3:
    (3, 3)."""
    if band_start % stride:
        raise ValueError(f"a band starting at row {band_start} is not aligned with stride "
                         f"{stride}")
    return padding, max(0, (k - 1) * dilation - padding - stride + 1)


def nearest_index(n_in: int, n_out: int) -> torch.Tensor:
    """The source row of each of `n_out` rows under F.interpolate's nearest
    rule: floor(i * float32(n_in / n_out)), at most n_in - 1 (CPU int64)."""
    if n_in == n_out:
        return torch.arange(n_out)
    scale = np.float32(n_in) / np.float32(n_out)
    src = np.floor(np.arange(n_out, dtype=np.float32) * scale).astype(np.int64)
    return torch.from_numpy(np.minimum(src, n_in - 1))


def plane_plan(opt, world: int) -> Dict[int, str]:
    """{global rows: 'band of r rows' or 'whole'} of the generator's planes,
    the latent up to the frame."""
    frame = opt.generator_input_size()
    ups = {"normal": 5, "more": 6, "most": 7}[opt.num_upsampling_layers]
    bands = Bands(Space(None, 0, world, torch.device("cpu")))
    return {frame >> i: f"band of {(frame >> i) // world} rows" if bands.sharded(frame >> i)
            else "whole" for i in range(ups, -1, -1)}


def train_plane_plan(opt, world: int) -> Dict[str, object]:
    """The training step's planes over `world` ranks: the generator's
    (``plane_plan``), VGG19's slices (bands), and netD's, which run whole on
    every rank (each scale's layers' output rows)."""
    crop = opt.crop_size
    d_rows, h = [], crop
    for _ in range(opt.num_D):
        rows, x = [], h
        for n in range(opt.n_layers_D + 1):
            stride = 2 if n < opt.n_layers_D - 1 else 1
            x = (x + 2 * 2 - 4) // stride + 1
            rows.append(x)
        d_rows.append(rows)
        h = (h + 2 - 3) // 2 + 1
    return {"generator": plane_plan(opt, world),
            "vgg19": {crop >> i: f"band of {(crop >> i) // world} rows" for i in range(5)},
            "netD": f"whole on every rank (gathered), rows by scale {d_rows}"}


def batch_spec(space: Space) -> Tuple[Optional[str], ...]:
    """The axis each NCHW dimension of a training batch is split over (the
    JAX module's PartitionSpec): H over 'space'; N is whole (the data x
    space grid is not ported)."""
    return (None, None, SPACE_AXIS if space.world > 1 else None, None)


def shard_batch(batch: Dict[str, torch.Tensor], space: Space) -> Dict[str, torch.Tensor]:
    """This rank's rows of a whole NCHW batch (every rank holds the same
    batch, on any device), on the Space's device: the JAX module's
    shard_batch, which places the batch P(None, 'space')."""
    out = {}
    for k, v in batch.items():
        h = v.shape[2]
        if h % space.world:
            raise ValueError(f"{k}: {h} rows do not divide into {space.world} bands")
        a, b = space.rank * h // space.world, (space.rank + 1) * h // space.world
        out[k] = v[:, :, a:b].contiguous().to(space.device)
    return out


def _cols(t: torch.Tensor, w: int) -> torch.Tensor:
    """The nearest resize of t's columns alone."""
    return resize_nearest(t, (t.shape[2], w)) if t.shape[2] else \
        t.new_zeros((*t.shape[:3], w))


class _Halo(torch.autograd.Function):
    """``Bands.halo``, differentiable.  The backward sends the cotangent of
    the rows received from each neighbour back to it, which adds it onto
    its own edge rows; at the frame's top and bottom the adjoint follows the
    pad: zeros and -inf drop it, reflection adds it onto the mirrored
    interior rows."""

    @staticmethod
    def forward(ctx, x, bands, lo, hi, pad):
        ctx.bands, ctx.lo, ctx.hi, ctx.pad, ctx.h = bands, lo, hi, pad, x.shape[2]
        above, below = bands.neighbour_rows(x, lo, hi) if bands.P > 1 else (None, None)
        if lo and above is None:
            above = bands._edge(x, lo, pad, top=True)
        if hi and below is None:
            below = bands._edge(x, hi, pad, top=False)
        return torch.cat([t for t in (above, x, below) if t is not None], dim=2)

    @staticmethod
    def backward(ctx, g):
        b, lo, hi, h = ctx.bands, ctx.lo, ctx.hi, ctx.h
        g = g.contiguous()
        dx = g[:, :, lo:lo + h].clone()
        g_above, g_below = g[:, :, :lo], g[:, :, lo + h:]
        top, bottom = b.r == 0, b.r == b.P - 1
        if b.P > 1:
            from_below, from_above = b.return_rows(g_above if lo and not top else None,
                                                   g_below if hi and not bottom else None,
                                                   lo, hi, dx)
            if from_below is not None:
                dx[:, :, h - lo:] += from_below
            if from_above is not None:
                dx[:, :, :hi] += from_above
        if ctx.pad == "reflect":
            if lo and top:
                dx[:, :, 1:lo + 1] += g_above.flip(2)
            if hi and bottom:
                dx[:, :, h - 1 - hi:h - 1] += g_below.flip(2)
        return dx, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """``Bands.gather_rows`` on every rank, differentiable: the backward is
    a reduce-scatter, an all-reduce of the cotangent and this band's rows
    of it."""

    @staticmethod
    def forward(ctx, x, bands):
        ctx.bands, ctx.h = bands, x.shape[2]
        return bands._gather(x)

    @staticmethod
    def backward(ctx, g):
        b, h = ctx.bands, ctx.h
        s = b._all_reduce(g.contiguous())
        return s[:, :, b.r * h:(b.r + 1) * h].contiguous(), None


class Bands:
    """The band forms of the path's layers on one Space.  Every method
    takes and returns this rank's band of a sharded plane (or a whole
    plane, where it says so); every rank calls each in the same order."""

    def __init__(self, space: Space):
        self.space = space
        self.P, self.r = space.world, space.rank

    # -- geometry ---------------------------------------------------------

    def sharded(self, h: int) -> bool:
        return h % self.P == 0 and h // self.P >= MIN_BAND_ROWS

    def rows(self, h: int) -> Tuple[int, int]:
        """[start, stop) of this rank's band of a plane of `h` rows."""
        return self.r * h // self.P, (self.r + 1) * h // self.P

    def cut(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """x (a whole plane of `h` rows) as this band where the plane is
        sharded; a band stays as it is."""
        if self.P == 1 or not self.sharded(h) or x.shape[2] != h:
            return x
        a, b = self.rows(h)
        return x[:, :, a:b].contiguous()

    def frame_rows(self, t: torch.Tensor, pw: int) -> torch.Tensor:
        """(1, 1, rows, 1): 1 on t's rows inside the frame, 0 on the `pw`
        rows beyond it above the first band and below the last (t: a band
        with `pw` halo rows each side)."""
        keep = torch.ones(t.shape[2], dtype=t.dtype, device=t.device)
        if self.r == 0:
            keep[:pw] = 0
        if self.r == self.P - 1:
            keep[t.shape[2] - pw:] = 0
        return keep.view(1, 1, -1, 1)

    # -- transport --------------------------------------------------------

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.space.group, r)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """t as it travels: on the host when staged, 2-byte floats as bytes."""
        t = t.contiguous()
        if self.space.staged():
            t = t.cpu()
        return t.view(torch.uint8) if t.dtype in HALF else t

    def _in(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.view(like.dtype).to(like.device)

    def _buffer(self, like: torch.Tensor, rows: int) -> torch.Tensor:
        """An empty travelling tensor of `rows` rows of `like`'s planes."""
        t = torch.empty((like.shape[0], like.shape[1], rows, like.shape[3]), dtype=like.dtype,
                        device="cpu" if self.space.staged() else like.device)
        return t.view(torch.uint8) if t.dtype in HALF else t

    def _exchange(self, sends, recvs) -> None:
        """Each (travelling tensor, band) of `sends` sent to that band's rank,
        each of `recvs` received from it; returns when all are done."""
        group = self.space.group
        if dist.get_backend(group) == "nccl":
            ops = [dist.P2POp(dist.isend, t, self._peer(p), group) for t, p in sends] + \
                [dist.P2POp(dist.irecv, t, self._peer(p), group) for t, p in recvs]
            reqs = dist.batch_isend_irecv(ops) if ops else []
        else:
            reqs = [dist.isend(t, self._peer(p), group=group) for t, p in sends] + \
                [dist.irecv(t, self._peer(p), group=group) for t, p in recvs]
        for q in reqs:
            q.wait()

    def neighbour_rows(self, x: torch.Tensor, lo: int, hi: int):
        """(the `lo` last rows of the band above, the `hi` first rows of the
        band below); None at the global edges and where a count is 0."""
        r, P = self.r, self.P
        sends, recvs = [], []
        above = below = None
        if lo and r > 0:
            above = self._buffer(x, lo)
            recvs.append((above, r - 1))
        if hi and r < P - 1:
            below = self._buffer(x, hi)
            recvs.append((below, r + 1))
        if lo and r < P - 1:
            sends.append((self._out(x[:, :, x.shape[2] - lo:]), r + 1))
        if hi and r > 0:
            sends.append((self._out(x[:, :, :hi]), r - 1))
        self._exchange(sends, recvs)
        return (None if above is None else self._in(above, x),
                None if below is None else self._in(below, x))

    def return_rows(self, up: Optional[torch.Tensor], down: Optional[torch.Tensor], lo: int,
                    hi: int, like: torch.Tensor):
        """The adjoint of ``neighbour_rows``: `up` (the cotangent of the rows
        received from the band above, or None) goes back to it, `down` to
        the band below.  Returns (the cotangent of this band's `lo` last rows
        from the band below, of its `hi` first rows from the band above);
        None where no band is there."""
        r, P = self.r, self.P
        sends, recvs = [], []
        from_below = from_above = None
        if lo and r < P - 1:
            from_below = self._buffer(like, lo)
            recvs.append((from_below, r + 1))
        if hi and r > 0:
            from_above = self._buffer(like, hi)
            recvs.append((from_above, r - 1))
        if up is not None:
            sends.append((self._out(up), r - 1))
        if down is not None:
            sends.append((self._out(down), r + 1))
        self._exchange(sends, recvs)
        return (None if from_below is None else self._in(from_below, like),
                None if from_above is None else self._in(from_above, like))

    def halo(self, x: torch.Tensor, lo: int, hi: int, pad: str = "zeros") -> torch.Tensor:
        """x with `lo` rows above and `hi` below: the neighbours' rows, or at
        the global top and bottom `pad` ('zeros', 'reflect' or 'neg_inf');
        differentiable (``_Halo``)."""
        if lo == hi == 0:
            return x
        h = x.shape[2]
        if max(lo, hi) > h or (pad == "reflect" and max(lo, hi) >= h):
            raise ValueError(f"a halo of ({lo}, {hi}) rows around a band of {h} rows")
        return _Halo.apply(x, self, lo, hi, pad)

    @staticmethod
    def _edge(x: torch.Tensor, n: int, pad: str, top: bool) -> torch.Tensor:
        h = x.shape[2]
        if pad == "reflect":
            return x[:, :, 1:n + 1].flip(2) if top else x[:, :, h - 1 - n:h - 1].flip(2)
        return x.new_full((x.shape[0], x.shape[1], n, x.shape[3]),
                          float("-inf") if pad == "neg_inf" else 0.0)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, a new tensor (no autograd)."""
        if self.P == 1:
            return t
        u = t.detach().clone()
        dist.all_reduce(u, group=self.space.group)
        return u

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` (float32) over the ranks; differentiable (its
        backward sums the cotangents over the ranks)."""
        if self.P == 1:
            return t
        return all_reduce_sum(t, self.space.group)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        t = self._out(x)
        parts = [torch.empty_like(t) for _ in range(self.P)]
        dist.all_gather(parts, t, group=self.space.group)
        return self._in(torch.cat(parts, dim=2), x)

    def gather_rows(self, x: torch.Tensor, dst: Optional[int] = None) -> Optional[torch.Tensor]:
        """The bands stacked along H: on every rank (`dst` None;
        differentiable), or on rank `dst` only (None on the others)."""
        if self.P == 1:
            return x
        if dst is None:
            return _GatherRows.apply(x, self)
        t = self._out(x)
        parts = [torch.empty_like(t) for _ in range(self.P)] if self.r == dst else None
        dist.gather(t, parts, dst=self._peer(dst), group=self.space.group)
        return self._in(torch.cat(parts, dim=2), x) if self.r == dst else None

    # -- layers -----------------------------------------------------------

    def _conv(self, x, w, b, k, stride, padding, dilation=1, pad="zeros"):
        lo, hi = halo_rows(k, stride, padding, dilation, self.r * x.shape[2])
        xe = self.halo(x, lo, hi, pad)
        if pad == "reflect":
            xe, padding = F.pad(xe, (padding, padding, 0, 0), mode="reflect"), 0
        return conv(F.conv2d, xe, *cast_params(x, w, b), stride, (0, padding), dilation)

    def conv(self, m, x: torch.Tensor) -> torch.Tensor:
        """m(x) on a band: m a Conv2d or a SpectralConv2d (W / sigma the same
        on every rank: in eval from its stored u and v; in train mode after
        its one power iteration, which writes u and v as m's forward does)."""
        if isinstance(m, SpectralConv2d):
            return self._conv(x, m.weight(), m.bias, m.weight_orig.shape[-1], m.stride,
                              m.padding, m.dilation)
        return self._conv(x, m.weight, m.bias, m.kernel_size[0], m.stride[0], m.padding[0],
                          m.dilation[0])

    def conv_block(self, blk, x: torch.Tensor) -> torch.Tensor:
        """A ConvBlock of the background encoders (reflect pad, conv, no
        norm, act) on a band."""
        c = blk.conv
        y = self._conv(x, c.weight, c.bias, c.kernel_size[0], c.stride[0], blk.padding, 1,
                       "reflect")
        return blk.ACTS[blk.activation](y)

    def partial_conv(self, m, x: torch.Tensor, mask: torch.Tensor):
        """PartialConv on a band: the mask's sums take the input's halo."""
        k, s, p = m.kernel_size[0], m.stride[0], m.padding[0]
        lo, hi = halo_rows(k, s, p, 1, self.r * x.shape[2])
        return m(self.halo(x, lo, hi), self.halo(mask, lo, hi), padding=(0, p))

    def instance_norm(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        """ops.norms.instance_norm over the whole plane, its per-(n, c) sums
        all-reduced in float32: bfloat16 as InstanceNormB16 (sum x and sum
        x^2 in one), float32 as instance_norm's two passes (the sum, then
        the centred sum of squares)."""
        n, c = x.shape[:2]
        count = x.shape[2] * self.P * x.shape[3]
        xf = x.float()
        if x.dtype == torch.bfloat16:
            s = self.all_reduce(torch.cat([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], 1))
            mean, ex2 = (s / count).view(n, 2 * c, 1, 1).chunk(2, dim=1)
            inv = torch.rsqrt(ex2 - mean * mean + eps)
            return (x - mean.to(x.dtype)) * inv.to(x.dtype)
        mean = (self.all_reduce(xf.sum(dim=(2, 3))) / count).view(n, c, 1, 1)
        var = self.all_reduce(((xf - mean) ** 2).sum(dim=(2, 3))) / count
        return ((xf - mean) * torch.rsqrt(var.view(n, c, 1, 1) + eps)).to(x.dtype)

    def masked_mean(self, feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ops.stats.masked_region_mean over the whole plane: the sums of
        feat * mask and of the mask all-reduced in float32, then rounded to
        their dtypes as the whole plane's sums are."""
        num = (feat * mask).float().sum(dim=(2, 3), keepdim=True)
        den = mask.float().sum(dim=(2, 3), keepdim=True)
        s = self.all_reduce(torch.cat([num, den], dim=1))
        return s[:, :-1].to(feat.dtype) / s[:, -1:].to(mask.dtype).clamp_min(1.0)

    def resize_nearest(self, x: torch.Tensor, h: int, size, whole: Optional[bool] = None):
        """resize_nearest(x, size) of this band of a plane of `h` rows: this
        band of the output, or (`whole`, by default where the output plane
        is not sharded) the whole output, from the rows each band holds."""
        h_out, w_out = size
        if whole is None:
            whole = not self.sharded(h_out)
        idx = nearest_index(h, h_out)
        a_in, b_in = self.rows(h)
        if not whole:
            a, b = self.rows(h_out)
            src = idx[a:b] - a_in
            if src.numel() and (src.min() < 0 or src.max() >= b_in - a_in):
                raise ValueError(f"rows {a}..{b} of a {h_out}-row resize of {h} rows are not "
                                 f"all in band {a_in}..{b_in}")
            y = x.index_select(2, src.to(x.device))
        else:
            own = torch.nonzero((idx >= a_in) & (idx < b_in)).flatten()
            y = x.new_zeros((x.shape[0], x.shape[1], h_out, x.shape[3]), dtype=torch.float32)
            y.index_copy_(2, own.to(x.device),
                          x.index_select(2, (idx[own] - a_in).to(x.device)).float())
            y = self.all_reduce(y).to(x.dtype)
        return resize_nearest(y, (y.shape[2], w_out))

    # -- modules ----------------------------------------------------------

    def expanded_back_mask(self, opt, hair: torch.Tensor, h: int) -> torch.Tensor:
        """_expanded_back_mask's inference form under --expand_mask_be
        --add_feat_zeros on this band of the frame: the hair dilated by a
        k x k max-pool inside the crop only, padded at the crop's edges by
        global row and column, zero outside it; one minus that."""
        k = opt.expand_th
        p = int(k / 2)
        crop, r0 = opt.crop_size, opt.add_th // 2
        a, b = self.rows(h)
        he = self.halo(hair, p, k - 1 - p, "neg_inf")
        dev = hair.device
        rows = torch.arange(a - p, b + k - 1 - p, device=dev)
        cols = torch.arange(hair.shape[3], device=dev)
        inside = (((rows >= r0) & (rows < r0 + crop)).view(-1, 1)
                  & ((cols >= r0) & (cols < r0 + crop)).view(1, -1))
        he = F.pad(he.masked_fill(~inside, float("-inf")), (p, k - 1 - p, 0, 0),
                   value=float("-inf"))
        pooled = F.max_pool2d(he, k, 1)
        return 1.0 - pooled.masked_fill(~inside[p:p + b - a], 0.0)

    def train_back_mask(self, opt, mask: torch.Tensor, h: int,
                        extra_dilate_steps: int) -> torch.Tensor:
        """_expanded_back_mask's training form on this band of the crop: one
        minus the hair dilated by --random_expand_mask's max-pools
        (``expand_kernels``), each padding the frame's edges with -inf as
        its pool does; without --random_expand_mask the background label."""
        if not opt.random_expand_mask:
            return mask[:, 0:1]
        ks = expand_kernels(opt, h, extra_dilate_steps)
        half = sum(k // 2 for k in ks)
        y = self.halo(mask[:, 1:2], half, half, "neg_inf")
        for k in ks:
            y = F.max_pool2d(F.pad(y, (k // 2, k // 2, 0, 0), value=float("-inf")), k, 1)
        return 1.0 - y

    def appearance(self, enc, x, label_ref, label_tag, h: int) -> torch.Tensor:
        """ImageEncoder3 on this band of the frame: the seed, whole, or this
        band of it where the seed plane is sharded and is the encoder's own
        output plane (no resize).  Where a band grows too thin for the
        next stride-2 layer's alignment (an odd number of rows), the layers
        from there on run whole on every rank, on the gathered planes."""
        mask, y = label_ref, x
        banded = True
        for i in range(1, 6):
            layer = getattr(enc, f"layer{i}")
            if banded and y.shape[2] % layer.stride[0]:
                y, mask, banded = self.gather_rows(y), self.gather_rows(mask), False
            if i > 1:
                y = F.leaky_relu(y, 0.2)
            y, mask = self.partial_conv(layer, y, mask) if banded else layer(y, mask)
            if enc.use_in:
                y = self.instance_norm(y) if banded else instance_norm(y)
        y = F.leaky_relu(y, 0.2)
        hy = h // ENCODER_STRIDE
        if banded:
            size = (hy, y.shape[3])
            lr = self.resize_nearest(label_ref, h, size, whole=False)
            lt = self.resize_nearest(label_tag, h, size, whole=False)
            out = self.masked_mean(y, lr).expand_as(y) * lt
            if enc.sh == hy and self.sharded(hy):
                return out
            out = self.gather_rows(out)
        else:
            lr, lt = (resize_nearest(self.gather_rows(t), y.shape[2:])
                      for t in (label_ref, label_tag))
            out = masked_region_mean(y, lr).expand_as(y) * lt
        return out if enc.sh == hy else resize_bilinear(out, (enc.sh, enc.sw))

    def background(self, enc, image, mask, noise, h: int, extra_dilate_steps: int = 2):
        """BackgroundEncode2 on this band of the frame: (features, masks),
        coarsest first, each this band of its plane; the background mask of
        training (``train_back_mask``) when the options say --isTrain."""
        if enc.opt.isTrain:
            back_mask = self.train_back_mask(enc.opt, mask, h, extra_dilate_steps)
        else:
            back_mask = self.expanded_back_mask(enc.opt, mask[:, 1:2], h)
        inp = (image * back_mask + noise * (1.0 - back_mask)).to(image.dtype)
        if enc.most:
            x00 = self.conv_block(enc.conv0, inp)
            x0 = self.conv_block(enc.layer0, x00)
        else:
            x0 = self.conv_block(enc.conv1, inp)
        x1 = self.conv_block(enc.layer1, x0)
        x2 = self.conv_block(enc.layer2, x1)
        x3 = self.conv_block(enc.layer3, x2)
        w = back_mask.shape[3]
        factors = (16, 8, 4, 2) if enc.most else (8, 4, 2)
        bms = [self.resize_nearest(back_mask, h, (h // f, w // f)) for f in factors]
        feats = [x3, x2, x1, x0] + ([x00] if enc.most else [])
        return feats, bms + [back_mask]

    def spade(self, sp, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """A SPADE on a band: `seg` is the conditioning at x's plane with 2 pw
        halo rows, over which mlp_shared runs, so that the fused gamma / beta
        conv finds its halo in place; rows beyond the frame are zeroed as
        that conv pads.  Eval mode: one ``spade_modulate`` launch with the
        running statistics; train mode: the sync batch norm's statistics
        over the ranks (the global count of rows), the running statistics
        written unless frozen, as ParamFreeNorm does."""
        seg = seg.to(x.dtype)
        m = sp.mlp_shared[0]
        actv = F.relu(conv(F.conv2d, seg, *cast_params(seg, m.weight, m.bias), 1, (0, sp.pw)))
        actv = actv * self.frame_rows(actv, sp.pw)
        weight, bias = sp.gamma_beta_conv(actv.dtype)
        gamma, beta = conv(F.conv2d, actv, weight, bias, 1, (0, sp.pw)).chunk(2, dim=1)
        pfn = sp.param_free_norm
        if not sp.training:
            return spade_modulate(x, pfn.running_mean, torch.rsqrt(pfn.running_var + pfn.eps),
                                  gamma, beta)
        y, new_mean, new_var = batch_norm_train(x, pfn.running_mean, pfn.running_var,
                                                eps=pfn.eps, group=self.space.group)
        if pfn.write_buffers:
            pfn.running_mean.copy_(new_mean)
            pfn.running_var.copy_(new_var)
            pfn.num_batches_tracked += 1
        return y * (1.0 + gamma) + beta

    def block(self, blk, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """SPADEResnetBlock.forward on a band."""
        x_s = self.conv(blk.conv_s, self.spade(blk.norm_s, x, seg)) if blk.learned_shortcut \
            else x
        dx = self.conv(blk.conv_0, F.leaky_relu(self.spade(blk.norm_0, x, seg), 0.2))
        dx = self.conv(blk.conv_1, F.leaky_relu(self.spade(blk.norm_1, dx, seg), 0.2))
        return x_s + dx

    def generator(self, g, input_ref, input_tag, orient, image_ref, image_tag, noise,
                  extra_dilate_steps: int = 2):
        """SPADEBGenerator.forward on this band of the frame: this band of
        the fake; in train mode with cuDNN off in the blocks where the
        module takes it off (models/generator.py CUDNN_OFF)."""
        opt = g.opt
        h = input_tag.shape[2] * self.P
        hair = input_tag[:, 1:2]
        hx = g.fc.sh
        off = lambda name: cudnn_off(g.training and name in g.cudnn_off_blocks)
        with off("fc"):
            x = self.cut(self.appearance(g.fc, image_ref, input_ref[:, 1:2], hair, h), hx)
        seg = torch.cat([input_tag, orient.to(input_tag.dtype)], dim=1)
        with off("backgroud_enc"):
            back_feats, back_masks = self.background(g.backgroud_enc, image_tag, input_tag,
                                                     noise, h, extra_dilate_steps)
        most = opt.num_upsampling_layers == "most"
        w = hair.shape[3]
        hair_masks = [self.resize_nearest(hair, h, (h // f, w // f))
                      for f in ((16, 8, 4, 2) if most else (8, 4, 2))] + [hair]
        segs = {}

        def run(name, xx, hh):
            blk = getattr(g, name)
            if hh not in segs:  # the conditioning at this plane, once a plane
                s = self.resize_nearest(seg, h, (hh, xx.shape[3]))
                segs[hh] = self.halo(s, 2 * blk.norm_0.pw, 2 * blk.norm_0.pw) \
                    if self.sharded(hh) else s
            with off(name):
                return self.block(blk, xx, segs[hh]) if self.sharded(hh) else blk(xx, segs[hh])

        def up(xx, hh):
            return self.cut(upsample2x_nearest(xx), 2 * hh), 2 * hh

        def composite(xx, i):
            return back_feats[i] * (1 - hair_masks[i]) + xx * (1 - back_masks[i])

        x = run("head_0", x, hx)
        x, hx = up(x, hx)
        x = run("G_middle_0", x, hx)
        if opt.num_upsampling_layers in ("more", "most"):
            x, hx = up(x, hx)
        x = run("G_middle_1", x, hx)
        for i, name in enumerate(("up_0", "up_1", "up_2", "up_3")):
            x, hx = up(x, hx)
            x = composite(run(name, x, hx), i)
        if most:
            x, hx = up(x, hx)
            x = composite(run("up_4", x, hx), 4)
        return torch.tanh(self.conv(g.conv_img, F.leaky_relu(x, 0.2)))

    def infer(self, model, batch: Dict[str, torch.Tensor], dst: Optional[int] = 0):
        """MichiGANModel.infer in 'ref' mode on the global batch (NCHW crop
        tensors on any device), each rank uploading only the rows its bands
        read: (fake with its add_feat_zeros frame, inpainted orientation RGB)
        gathered on rank `dst` (every rank: None; the others get None)."""
        opt = model.opt
        dev, cdt = self.space.device, model.compute_dtype
        n, _, crop, width = batch["label_tag"].shape
        if crop != opt.crop_size or width != opt.crop_size:
            raise ValueError(f"a batch of {crop}x{width} planes; --crop_size {opt.crop_size}")
        nc = opt.label_nc + (1 if opt.contain_dontcare_label else 0)
        frame, r0 = opt.generator_input_size(), opt.add_th // 2

        def take(key, rows):
            t = batch[key]
            return t.index_select(2, rows.to(t.device)).to(dev)

        # the IG's input: this band of its 256 rows, then every band
        a, b = self.rows(IG_SIZE)
        src = nearest_index(crop, IG_SIZE)[a:b]
        hole, orient_rgb, noise = (take(k, src) for k in ("hole", "orient_rgb", "noise"))
        comp = orient_rgb * (1 - hole) + noise * hole
        inp = _cols(torch.cat([comp, hole], dim=1), IG_SIZE)
        ig_out = model.netIG(self.gather_rows(inp).to(cdt)).float()

        # the crop's rows inside this band of the frame
        fa, fb = self.rows(frame)
        ca, cb = min(max(fa - r0, 0), crop), min(max(fb - r0, 0), crop)
        rows = torch.arange(ca, cb)
        up = _cols(ig_out.index_select(2, nearest_index(IG_SIZE, crop)[rows].to(dev)), crop)
        hole, orient_rgb = take("hole", rows), take("orient_rgb", rows)
        orient_out = up * hole + orient_rgb * (1 - hole)
        input_tag = one_hot_label(take("label_tag", rows), nc)
        pre = {"input_ref": one_hot_label(take("label_ref", rows), nc), "input_tag": input_tag,
               "orient": model._decode_orient_rgb(orient_out, input_tag[:, 1:2]),
               **{k: take(k, rows) for k in ("image_ref", "image_tag", "noise")}}

        def framed(t, c0, w):  # t's rows in this band of the frame, from column c0
            out = t.new_zeros((n, t.shape[1], fb - fa, w))
            out[:, :, ca + r0 - fa:cb + r0 - fa, c0:c0 + crop] = t
            return out

        gin = [framed(pre[k], r0, frame).to(cdt) for k in GEN_KEYS]
        fake = self.gather_rows(self.generator(model.netG, *gin).float(), dst)
        orient_rgb = self.gather_rows(framed(orient_out, 0, crop), dst)
        if fake is None:
            return None, None
        return fake, orient_rgb[:, :, r0:r0 + crop]

    # -- training ---------------------------------------------------------
    # The reductions of losses/reduce.py on a band, which MichiGANModel's G
    # and D losses take as `red`, and the band forms of the IG, netG and
    # netD's input that they call.

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """This band's share of the whole plane's t.mean(): its sum over the
        global count."""
        return t.sum() / (t.numel() * self.P)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """t.sum() over the whole plane, on every rank (no gradient)."""
        return self._all_reduce(t.detach().sum())

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """A term computed whole, alike on every rank: its share, 1/P."""
        return t / self.P

    def mean_std(self, feats: List[torch.Tensor]):
        """losses.reduce.mean_std of each of `feats` over the whole plane
        (per (n, c): the mean and sqrt(unbiased var + eps)), from two
        all-reduces for all of them: the sums, then the centred sums of
        squares."""
        eps = 1e-5
        fs = [f.float().flatten(2) for f in feats]
        widths = [f.shape[1] for f in fs]
        counts = [f.shape[2] * self.P for f in fs]
        sums = self.all_reduce(torch.cat([f.sum(2) for f in fs], dim=1)).split(widths, dim=1)
        means = [s / n for s, n in zip(sums, counts)]
        sq = self.all_reduce(torch.cat([((f - m[..., None]) ** 2).sum(2)
                                        for f, m in zip(fs, means)], dim=1)).split(widths, dim=1)
        return [(m, torch.sqrt(v / (n - 1) + eps)) for m, v, n in zip(means, sq, counts)]

    def vgg(self, vgg, x: torch.Tensor) -> List[torch.Tensor]:
        """VGG19.forward on a band: [relu1_1, ..., relu5_1], each this band
        of its plane.  Without autograd, features_2 is one
        conv3x3_same_lowch launch on the band with a halo row each side,
        whose two outer output rows are dropped."""
        outs = []
        for step in VGG_PLAN:
            if step[0] == "conv":
                c = vgg.features[str(step[1])]
                if step[1] == LOWCH_CONV and not torch.is_grad_enabled():
                    y = conv3x3_same_lowch(self.halo(x, 1, 1), c.weight)
                    x = F.relu(y[:, :, 1:-1] + c.bias.view(1, -1, 1, 1))
                else:
                    x = F.relu(self.conv(c, x))
            elif step[0] == "pool":
                x = max_pool_same(x, 2, 2, 0)
            else:
                outs.append(x)
        return outs

    def orientation_response(self, gray: torch.Tensor, bank: torch.Tensor,
                             bf16_operands: bool = False):
        """``OrientationResponse`` of this band of the gray plane: the bank
        runs on the band with BANK_HALO rows of the neighbours' each side
        (zeros at the frame's edges, as the bank pads), and the outer rows
        of its output are dropped."""
        idx, raw = OrientationResponse.apply(self.halo(gray, BANK_HALO, BANK_HALO), bank,
                                             bf16_operands)
        return idx[:, BANK_HALO:-BANK_HALO], raw[:, BANK_HALO:-BANK_HALO]

    @torch.no_grad()
    def orient_for_training(self, model, pre) -> torch.Tensor:
        """MichiGANModel.orient_for_training on this band of the crop: the
        frozen IG whole on every rank, on the gathered 256^2 input; this
        band of the decoded orientation."""
        dev, cdt = pre["hole"].device, model.compute_dtype
        width = pre["hole"].shape[3]
        crop = pre["hole"].shape[2] * self.P
        a_in, b_in = self.rows(crop)
        a, b = self.rows(IG_SIZE)
        src = nearest_index(crop, IG_SIZE)[a:b] - a_in
        if src.min() < 0 or src.max() >= b_in - a_in:
            raise ValueError(f"the inpainter's rows {a}..{b} of a {crop}-row crop are not all "
                             f"in band {a_in}..{b_in}")
        hole, orient_rgb, noise = (pre[k].index_select(2, src.to(dev))
                                   for k in ("hole", "orient_rgb", "noise"))
        comp = orient_rgb * (1 - hole) + noise * hole
        inp = _cols(torch.cat([comp, hole], dim=1), IG_SIZE)
        ig_out = model.netIG(self.gather_rows(inp).to(cdt)).float()
        up = _cols(ig_out.index_select(2, nearest_index(IG_SIZE, crop)[a_in:b_in].to(dev)),
                   width)
        out = up * pre["hole"] + pre["orient_rgb"] * (1 - pre["hole"])
        return model._decode_orient_rgb(out, pre["input_tag"][:, 1:2])

    def generate(self, model, pre, orient, extra_dilate_steps: int = 2) -> torch.Tensor:
        """MichiGANModel.generate_fake's fake (no VAE, no blender, no zeros
        frame) on this band: this band of the fake, float32."""
        cdt = model.compute_dtype
        gin = {**{k: pre[k] for k in GEN_KEYS if k != "orient"}, "orient": orient}
        return self.generator(model.netG, *(gin[k].to(cdt) for k in GEN_KEYS),
                              extra_dilate_steps).float()

    def gather_planes(self, planes):
        """Each of `planes` (bands, float32) whole on every rank, by one
        gather; differentiable."""
        whole = self.gather_rows(torch.cat(planes, dim=1))
        return whole.split([t.shape[1] for t in planes], dim=1)


def make_spatial_infer(model, space: Space, to_all: bool = False):
    """``infer(batch) -> (fake, orient RGB)``: ``model.infer(batch)`` ('ref'
    mode) in row bands over `space`'s ranks, for the global host batch
    (NCHW crop tensors, as ``batch_from_numpy`` gives them; each rank
    uploads its rows).  Every rank calls it with the same batch; the
    outputs are gathered on rank 0, or on every rank with `to_all` (the
    others get (None, None)).  The fake keeps the add_feat_zeros frame,
    which the caller crops, as from ``infer``.  `model` is an inference
    model (eval mode) on `space`'s device."""
    check_spatial(model.opt, space.world)
    if model.netG.training:
        raise ValueError("spatial sharding runs the generator in eval mode only")
    bands = Bands(space)

    @torch.no_grad()
    def infer(batch: Dict[str, torch.Tensor]):
        return bands.infer(model, batch, None if to_all else 0)

    return infer
