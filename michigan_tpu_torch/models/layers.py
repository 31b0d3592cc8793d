"""Conv primitives with the reference's state_dict layout (port of
michigan_tpu/models/layers.py), NCHW.

  spectral_norm(nn.Conv2d)          -> SpectralConv2d: weight_orig + weight_u/weight_v
  spectral_norm(nn.ConvTranspose2d) -> SpectralConvTranspose2d (norm over dim=1)
  weight_norm(nn.Conv2d)            -> WeightNormConv2d: weight_g + weight_v
  the reference's Weight_norm (g 1) -> UnitNormConv2d: a plain weight
                                       normalised once, at init
  PartialConv2d                     -> PartialConv
  nn.ReflectionPad2d                -> reflect_pad
  plain convs                       -> Conv2d (nn.Conv2d under the cast rule)
  nn.ConvTranspose2d, nn.Linear     -> ConvTranspose2d, Linear (the same rule)

Spectral norm runs as torch's does: in eval, sigma = u . (W v) from the
stored u and v; in train mode one power iteration from the stored u first
(no gradient through it), then sigma from the iterated u and v.  Sigma and
the normalised weight are float32 whatever the stored dtype (the frozen
inpainters store bfloat16 under the bf16 policy).  An eval forward
recomputes W / sigma on every call; inside ``frozen_spectral_weights`` it
reads the weight computed once on entry (``ops.norms.spectral_weight``, the
same expression), as the serving session's captured graphs and the exported
program do.

One cast rule for every conv (the JAX package's ``_conv``): the weight and
the bias are cast to the input's dtype at the call, so netG's float32
parameters run bfloat16 convolutions on bfloat16 activations and float32
ones unchanged.  Casts are explicit, not ``torch.autocast``, which picks its
own dtype per op.

Inside ``cudnn_off()``, every conv of this module runs its float32
convolutions on a card with cuDNN off (``NativeConv``: PyTorch's own
im2col + GEMM, forward and both gradients): the generator opens it around
its high-channel, low-resolution blocks in train mode, where cuDNN's
float32 algorithms are the least accurate (models/generator.py).  bfloat16
and the CPU are unaffected.

Which forward may write buffers (spectral u / v here, batch-norm running
statistics in normalization.py) is explicit: a module writes them in train
mode while its ``write_buffers`` is true.  ``frozen_buffers`` clears it
around one call, which keeps the train-mode arithmetic and writes nothing
(the JAX package's ``mutable=False``); the discriminator clears it for good.

``checkpointed`` runs a module under activation checkpointing (--remat):
its recompute in the backward reads the spectral u the forward read and
writes no buffer, so the gradient is the one of the forward that ran and the
buffers are written once.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from michigan_tpu_torch.ops.norms import (
    instance_norm,
    power_iteration,
    spectral_sigma,
    spectral_weight,
)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


def cast_params(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """(w, b) in x's dtype: the per-conv cast rule (a no-op in float32)."""
    return w.to(x.dtype), None if b is None else b.to(x.dtype)


class NativeConv(torch.autograd.Function):
    """func(x, w, b, *rest) for func F.conv2d or F.conv_transpose2d, with
    rest its positional arguments after the bias, and its gradients, with
    cuDNN off: PyTorch's own im2col + GEMM (cuBLAS, float32 throughout with
    TF32 off)."""

    @staticmethod
    def forward(ctx, func, x, w, b, *rest):
        with torch.backends.cudnn.flags(enabled=False):
            y = func(x, w, b, *rest)
        ctx.save_for_backward(x, w)
        ctx.func, ctx.rest, ctx.has_b = func, rest, b is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        transposed = ctx.func is F.conv_transpose2d
        names = ("stride", "padding", "output_padding", "groups", "dilation") if transposed \
            else ("stride", "padding", "dilation", "groups")
        a = dict(stride=1, padding=0, dilation=1, groups=1, output_padding=0)
        a.update(zip(names, ctx.rest))
        pair = lambda v: list(v) if isinstance(v, (tuple, list)) else [v, v]
        n_out = w.shape[1] * a["groups"] if transposed else w.shape[0]
        with torch.backends.cudnn.flags(enabled=False):
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, [n_out] if ctx.has_b else None, pair(a["stride"]), pair(a["padding"]),
                pair(a["dilation"]), transposed, pair(a["output_padding"]), a["groups"],
                [ctx.needs_input_grad[1], ctx.needs_input_grad[2],
                 ctx.has_b and ctx.needs_input_grad[3]])
        return (None, dx, dw, db, *([None] * len(ctx.rest)))


_CUDNN_OFF = False


@contextlib.contextmanager
def cudnn_off(on: bool = True) -> Iterator[None]:
    """Inside (with `on`), conv() takes NativeConv for float32 card tensors."""
    global _CUDNN_OFF
    saved, _CUDNN_OFF = _CUDNN_OFF, on
    try:
        yield
    finally:
        _CUDNN_OFF = saved


def conv(func, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *rest):
    """func(x, w, b, *rest); through NativeConv inside cudnn_off() where x is
    a float32 tensor on a card."""
    if _CUDNN_OFF and x.is_cuda and x.dtype == torch.float32:
        return NativeConv.apply(func, x, w, b, *rest)
    return func(x, w, b, *rest)


class Conv2d(nn.Conv2d):
    """nn.Conv2d under the cast rule: weight and bias in the input's dtype."""


    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv2d, x, *cast_params(x, self.weight, self.bias), self.stride,
                    self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (with its output_padding) under the cast rule."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv_transpose2d, x, *cast_params(x, self.weight, self.bias),
                    self.stride, self.padding, self.output_padding, self.groups,
                    self.dilation)


class Linear(nn.Linear):
    """nn.Linear under the cast rule."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *cast_params(x, self.weight, self.bias))


@contextlib.contextmanager
def frozen_buffers(*nets: nn.Module) -> Iterator[None]:
    """Inside, every module of `nets` that writes buffers in train mode
    (``write_buffers``) computes as in train mode but writes nothing."""
    mods = [m for net in nets for m in net.modules() if hasattr(m, "write_buffers")]
    saved = [m.write_buffers for m in mods]
    for m in mods:
        m.write_buffers = False
    try:
        yield
    finally:
        for m, w in zip(mods, saved):
            m.write_buffers = w


@contextlib.contextmanager
def frozen_spectral_weights(*nets: nn.Module) -> Iterator[list]:
    """Inside, every eval-mode spectral conv of `nets` reads its W / sigma
    computed once on entry (``spectral_weight``, the expression an eval
    forward recomputes) instead of recomputing it; yields those weights.
    They stand for the weights of the moment: a write to a spectral conv's
    weight or u / v inside is not seen."""
    mods = [m for net in nets for m in net.modules()
            if isinstance(m, SpectralConv2d) and not m.training]
    with torch.no_grad():
        for m in mods:
            m.weight_frozen = spectral_weight(m.weight_orig, m.weight_u, m.weight_v,
                                              m.transposed)
    try:
        yield [m.weight_frozen for m in mods]
    finally:
        for m in mods:
            m.weight_frozen = None


class SpectralConv2d(nn.Module):
    """spectral_norm(nn.Conv2d(...)); W is flattened OIHW -> (O, I*kh*kw)
    for sigma, as torch does."""

    transposed = False
    write_buffers = True

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        shape = (in_ch, out_ch, k, k) if self.transposed else (out_ch, in_ch, k, k)
        self.weight_orig = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.register_buffer("weight_u", torch.zeros(out_ch))
        self.register_buffer("weight_v", torch.zeros(in_ch * k * k))
        # W / sigma inside frozen_spectral_weights, else None; not in the
        # state_dict
        self.register_buffer("weight_frozen", None, persistent=False)

    def w_mat(self) -> torch.Tensor:
        w = self.weight_orig.transpose(0, 1) if self.transposed else self.weight_orig
        return w.reshape(w.shape[0], -1)

    def weight(self) -> torch.Tensor:
        """The spectrally normalised weight, float32; with `bias`, what a
        fused kernel that computes the conv itself takes (conv3x3_in_act), as
        the JAX package's TorchConv(..., return_kernel=True) hands it out."""
        if not self.training:
            if self.weight_frozen is not None:
                return self.weight_frozen
            return spectral_weight(self.weight_orig, self.weight_u, self.weight_v,
                                   self.transposed)
        w_mat = self.w_mat().float()
        with torch.no_grad():
            u, v = power_iteration(w_mat, self.weight_u.float(), 1)
            if self.write_buffers:
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return self.weight_orig.float() / spectral_sigma(w_mat, u, v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv2d, x, *cast_params(x, self.weight(), self.bias), self.stride,
                    self.padding, self.dilation)


@contextlib.contextmanager
def _as_read(module: nn.Module, u_read: dict) -> Iterator[None]:
    """Inside, `module` computes as its train-mode forward did from the
    spectral u in `u_read` ({conv: u before the forward wrote it}) and
    writes no buffer."""
    written = {m: m.weight_u for m in u_read}
    for m, u in u_read.items():
        m.weight_u = u
    try:
        with frozen_buffers(module):
            yield
    finally:
        for m, u in written.items():
            m.weight_u = u


def checkpointed(module: nn.Module, fn, *args):
    """fn(*args), a call of `module`, with the activations it saves for the
    backward freed and recomputed there (torch.utils.checkpoint,
    non-reentrant): the JAX package's nn.remat.  The forward writes what it
    writes (batch-norm running statistics, spectral u / v); the recompute
    starts each spectral conv's power iteration from the u the forward read,
    so it gets the forward's sigma, and writes nothing.  fn draws no random
    numbers, so no RNG state is kept for the recompute."""
    u_read = {m: m.weight_u.clone() for m in module.modules()
              if isinstance(m, SpectralConv2d) and m.training}
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _as_read(module, u_read)))


class SpectralConvTranspose2d(SpectralConv2d):
    """spectral_norm(nn.ConvTranspose2d(...)); the weight is torch's
    (I, O, kh, kw) and spectral norm uses dim=1 (out-channels first)."""

    transposed = True

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 2,
                 padding: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv_transpose2d, x, *cast_params(x, self.weight(), self.bias),
                    self.stride, self.padding)


class WeightNormConv2d(nn.Module):
    """weight_norm(nn.Conv2d(...)) (--weight_norm_G --weight_norm_g 0; the
    JAX package's TorchConv(weight_norm="torch")): W = g * v / ||v||, the
    norm over each output channel's (I, kh, kw), computed in float32 on
    every forward from the parameters weight_g (O, 1, 1, 1) and weight_v
    (O, I, kh, kw); no buffer, so a recompute under ``checkpointed`` reads
    what the forward read."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.weight_g = nn.Parameter(torch.ones(out_ch, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def weight(self) -> torch.Tensor:
        v = self.weight_v.float()
        return v * (self.weight_g.float() / v.flatten(1).norm(dim=1).view(-1, 1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.conv2d, x, *cast_params(x, self.weight(), self.bias), self.stride,
                    self.padding)


class UnitNormConv2d(Conv2d):
    """The reference's Weight_norm with g fixed at 1 (--weight_norm_G
    --weight_norm_g 1; the JAX package's TorchConv(weight_norm="fixed")):
    ``init_weights`` divides each output channel's weight by its norm (+
    1e-10) once; after that, and in a loaded checkpoint, which holds the
    normalised weight, it is a plain conv."""


class PartialConv(nn.Conv2d):
    """NVIDIA partial convolution with a single-channel mask
    (partialconv2d.py:15-86): returns (out, updated_mask), where
    out = (conv(x*m) * winsize / (conv(m) + 1e-8) + b) * clamp(conv(m), 0, 1).
    The mask ratio is computed in float32 and cast to x's dtype; the updated
    mask stays float32.  `padding` (rows, columns) overrides the layer's
    own: a row band of a plane whose halo rows are already in place
    (parallel/spatial.py) takes (0, its padding)."""


    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 2,
                 padding: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, bias=bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, padding=None):
        k = self.kernel_size[0]
        pad = self.padding if padding is None else padding
        m = mask.float()
        ones = torch.ones(1, 1, k, k, dtype=m.dtype, device=x.device)
        update_mask = F.conv2d(m, ones, None, self.stride, pad)
        mask_ratio = float(k * k) / (update_mask + 1e-8)
        update_mask = update_mask.clamp(0.0, 1.0)
        mask_ratio = mask_ratio * update_mask
        w, b = cast_params(x, self.weight, self.bias)
        raw = conv(F.conv2d, x * mask.to(x.dtype), w, None, self.stride, pad)
        mask_ratio = mask_ratio.to(raw.dtype)
        if b is not None:
            out = (raw * mask_ratio + b.view(1, -1, 1, 1)) * update_mask.to(raw.dtype)
        else:
            out = raw * mask_ratio
        return out, update_mask


class ConvBlock(nn.Module):
    """pad -> conv -> norm -> act (MaskGAN_networks.py:114-173; JAX
    layers.py:323-365): pad 'reflect' (the background encoders, the
    blender's resblocks), 'replicate' or 'zero'; norm 'none' or 'in' (the
    plain instance norm, with autograd); act 'relu', 'lrelu' (0.2), 'tanh'
    or 'none'."""

    PADS = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}
    ACTS = {"relu": F.relu, "lrelu": lambda y: F.leaky_relu(y, 0.2), "tanh": torch.tanh,
            "none": lambda y: y}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                 padding: int, norm: str = "none", activation: str = "relu",
                 pad_type: str = "reflect"):
        super().__init__()
        if norm not in ("none", "in") or activation not in self.ACTS or \
                pad_type not in self.PADS:
            raise ValueError(f"ConvBlock norm {norm!r}, activation {activation!r}, "
                             f"pad {pad_type!r}")
        self.padding, self.norm, self.activation = padding, norm, activation
        self.pad_mode = self.PADS[pad_type]
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding
        y = self.conv(F.pad(x, (p, p, p, p), mode=self.pad_mode) if p else x)
        if self.norm == "in":
            y = instance_norm(y)
        return self.ACTS[self.activation](y)


# ---------------------------------------------------------------------------
# seeded initialisation (--init_type), as michigan_tpu/models/layers.py:weight_init
# ---------------------------------------------------------------------------

def _fans(module: nn.Module, w: torch.Tensor):
    # fans over the equivalent-conv kernel: in = I*kh*kw, out = O*kh*kw (a
    # Linear's (out, in) weight: in and out)
    if getattr(module, "transposed", False):
        i, o = w.shape[0], w.shape[1]
    else:
        o, i = w.shape[0], w.shape[1]
    rf = w[0, 0].numel()
    return i * rf, o * rf


def _draw(shape, init_type: str, gain: float, fan_in: int, fan_out: int,
          gen: torch.Generator) -> torch.Tensor:
    if init_type == "normal":
        return torch.randn(shape, generator=gen) * gain
    if init_type == "xavier":
        return torch.randn(shape, generator=gen) * (gain * math.sqrt(2.0 / (fan_in + fan_out)))
    if init_type == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return (torch.rand(shape, generator=gen) * 2 - 1) * a
    if init_type == "kaiming":
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
    if init_type == "none":
        # torch's default conv init, kaiming_uniform_(a=sqrt(5))
        b = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen) * 2 - 1) * b
    raise NotImplementedError(f"initialization method [{init_type}]")


POWER_ITERS = 10  # enough for sigma to settle on the random init's spectral norm


@torch.no_grad()
def init_weights(net: nn.Module, gen: torch.Generator, init_type: str = "xavier",
                 gain: Optional[float] = 0.02) -> None:
    """Seeded weights on the CPU generator `gen`: conv, transposed-conv and
    linear weights by --init_type, biases zero, and for spectral convs unit
    u/v from a few power iterations (so sigma is the weight's spectral norm,
    as in a trained checkpoint)."""
    gain = 0.02 if gain is None else gain
    for m in net.modules():
        if isinstance(m, SpectralConv2d):
            w = m.weight_orig
        elif isinstance(m, WeightNormConv2d):
            w = m.weight_v
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
        else:
            continue
        fan_in, fan_out = _fans(m, w)
        w.copy_(_draw(tuple(w.shape), init_type, gain, fan_in, fan_out, gen))
        if m.bias is not None:
            m.bias.zero_()
        if isinstance(m, WeightNormConv2d):  # W = v at init (JAX: g = ||kernel||)
            m.weight_g.copy_(w.flatten(1).norm(dim=1).view(-1, 1, 1, 1))
        if isinstance(m, UnitNormConv2d):
            w.div_(w.flatten(1).norm(dim=1).view(-1, 1, 1, 1) + 1e-10)
        if isinstance(m, SpectralConv2d):
            w_mat = m.w_mat().detach().cpu()
            u0 = F.normalize(torch.randn(w_mat.shape[0], generator=gen), dim=0)
            u, v = power_iteration(w_mat, u0, POWER_ITERS)
            m.weight_u.copy_(u)
            m.weight_v.copy_(v)
