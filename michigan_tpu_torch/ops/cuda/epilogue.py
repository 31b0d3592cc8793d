"""Fused 3x3 conv + instance norm + activation (+ residual): CUDA kernel,
plain version, wrapper.

Source: ``michigan_tpu_torch/csrc/conv_in_act.cu`` (built by ``build.py``).

conv3x3_in_act(x_pad, w, b, dilation, act, eps, residual)
    Replaces ``michigan_tpu/ops/pallas/epilogue.py:conv3x3_in_act``: a 3x3
    convolution with dilation d of an input already reflect-padded by d,
    (N, C, H+2d, W+2d), with the OIHW weight (Co, C, 3, 3) and bias (Co,);
    then instance norm per (n, co) with the biased variance; then 'relu',
    'lrelu' (0.2) or nothing; then ``+ residual`` (N, Co, H, W) if given.
    The inpainters' dilated resblocks run as two calls each under
    --use_pallas_epilogue (models/inpaint.py).

x_pad (and the residual) is float32 or bfloat16, and the output has its
dtype.  In bfloat16, as the TPU kernel under the bf16 policy, the weight is
cast to bfloat16 and the bias kept float32, the convolution sums in float32,
and the norm, the activation and the residual add run on that float32 sum;
the result is rounded to bfloat16 once.

The kernel is compute-bound (C*9 FMAs per output); the design notes are in
the CUDA source.  It computes the convolution in its own body on the tensor
cores (float32-accurate through the 3xTF32 split; in bfloat16 a layout pass,
then wgmma products with the instance norm's statistics exchanged between
the blocks of a plane), with no cuDNN, cuBLAS or CUTLASS call.  A wrapper
runs the plain PyTorch version for CPU tensors only.  For a CUDA tensor it checks dtype,
shape, contiguity and device, launches the kernel on the current stream and
counts the launch; anything the kernel does not take raises.  There is no
fallback on CUDA tensors.  As the norms' wrappers (spade.py), it calls its
body registered as a ``torch.library.custom_op``
(``torch.ops.michigan_tpu_torch.conv3x3_in_act``, with a fake
implementation) under tracing only, and the body directly otherwise.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.cuda import build
from michigan_tpu_torch.ops.cuda.spade import _ACTS, _act, _check_device
from michigan_tpu_torch.ops.norms import instance_norm


# the kernels' rings of input halos, (4 + 2d) rows per channel, fit an SM's
# shared memory up to this dilation (conv_in_act.cu)
MAX_DILATION = 4


def conv3x3_in_act_plain(x_pad, w, b, dilation=1, act=None, eps=1e-5, residual=None):
    """The unfused composition the kernel replaces (epilogue.py:_xla_reference);
    in bfloat16 the kernel's (epilogue.py:_kernel): the weight rounded to
    bfloat16, then conv, norm, act and residual in float32, one rounding."""
    if x_pad.dtype != torch.bfloat16:
        y = _act(instance_norm(F.conv2d(x_pad, w, b, dilation=dilation), eps), act)
        return y if residual is None else residual + y
    y = F.conv2d(x_pad.float(), w.to(x_pad.dtype).float(), None if b is None else b.float(),
                 dilation=dilation)
    y = _act(instance_norm(y, eps), act)
    if residual is not None:
        y = y + residual.float()
    return y.to(x_pad.dtype)


def _check(name: str, t: torch.Tensor, shape, like: torch.Tensor, dtypes) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x_pad on {like.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {', '.join(map(str, dtypes))} "
                        f"with x_pad {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_F32 = (torch.float32,)
_X_DTYPES = (torch.float32, torch.bfloat16)


def bf16_scratch(n: int, c: int, co: int, hp: int, wp: int, device) -> tuple:
    """The bf16 form's scratch (conv_in_act.cu): the layout pass's x_pad as
    8-channel chunks of each pixel, (n, 2 ceil(C/16), H+2d, W+2d, 8), and
    weight, (ceil(Co/32), ceil(C/16), 9, 2, 32, 8), both bfloat16; and the
    statistics' exchange, float32 parts and the planes' counters."""
    nk, planes = (c + 15) // 16, n * ((co + 31) // 32)
    return (torch.empty((n, 2 * nk, hp, wp, 8), dtype=torch.bfloat16, device=device),
            torch.empty(((co + 31) // 32, nk, 9, 2, 32, 8), dtype=torch.bfloat16, device=device),
            torch.empty(planes * (16 * 32 * 3 + 1), dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def bf16_prenorm(n: int, c: int, co: int, h: int, w: int, d: int, device_index: int) -> bool:
    """Whether the bf16 form needs a float32 pre-norm plane at these shapes
    on this card: more tiles per plane than the card holds blocks for
    (conv3x3_in_act_bf16_prenorm)."""
    with torch.cuda.device(device_index):
        got = build.load("conv_in_act").conv3x3_in_act_bf16_prenorm(n, c, co, h, w, d)
    build.check_launch("conv3x3_in_act_bf16_prenorm", max(0, -got))
    return got == 1


def conv3x3_in_act(x_pad: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   dilation: int = 1, act: Optional[str] = None, eps: float = 1e-5,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused [3x3 conv of a pre-padded NCHW input -> instance norm -> act
    (-> + residual)]; see the module docstring."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if torch.compiler.is_compiling():
        _check_device(x_pad)
        return _conv3x3_in_act_op(x_pad, w, b, int(dilation), act, float(eps), residual)
    return _conv3x3_in_act(x_pad, w, b, dilation, act, eps, residual)


def _conv3x3_in_act(x_pad: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                    dilation: int, act: Optional[str], eps: float,
                    residual: Optional[torch.Tensor]) -> torch.Tensor:
    if x_pad.device.type == "cpu":
        return conv3x3_in_act_plain(x_pad, w, b, dilation, act, eps, residual)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    if x_pad.dim() != 4 or w.dim() != 4:
        raise ValueError(f"expected NCHW x_pad and OIHW w, got {tuple(x_pad.shape)}, "
                         f"{tuple(w.shape)}")
    n, c, hp, wp = x_pad.shape
    co = w.shape[0]
    d = int(dilation)
    h, wd = hp - 2 * d, wp - 2 * d
    if d < 1 or h < 1 or wd < 1 or n * c * co == 0:
        raise ValueError(f"x_pad {tuple(x_pad.shape)} with dilation {dilation} leaves "
                         "no output")
    if d > MAX_DILATION:
        raise ValueError(f"the kernel takes dilation up to {MAX_DILATION}, got {d}")
    if n > 65535 or co > 65535 * (32 if x_pad.dtype == torch.bfloat16 else 64):
        raise ValueError(f"too many samples or channels for one launch: {n}, {co}")
    if x_pad.dtype == torch.bfloat16 and (
            (n * 2 + (co + 31) // 32) * ((c + 15) // 16) > 65535 or hp * wp >= 2**31):
        raise ValueError(f"the bf16 layout pass takes at most 65535 planes of 8 channels and "
                         f"weight blocks: x_pad {tuple(x_pad.shape)}, w {tuple(w.shape)}")
    _check("x_pad", x_pad, (n, c, hp, wp), x_pad, _X_DTYPES)
    bf16 = x_pad.dtype == torch.bfloat16
    # float32: everything float32.  bfloat16: the weight float32 or bfloat16
    # (rounded to bfloat16 in the kernel), the bias float32 or bfloat16 (the
    # kernel widens it exactly), the residual bfloat16
    _check("w", w, (co, c, 3, 3), x_pad, _X_DTYPES if bf16 else _F32)
    if b is not None:
        _check("b", b, (co,), x_pad, _X_DTYPES if bf16 else _F32)
    if residual is not None:
        _check("residual", residual, (n, co, h, wd), x_pad, (x_pad.dtype,))
        if residual.data_ptr() % 16:
            raise ValueError("residual must be 16-byte aligned")
    lib = build.load("conv_in_act")
    out = torch.empty((n, co, h, wd), dtype=x_pad.dtype, device=x_pad.device)
    stream = torch.cuda.current_stream(x_pad.device).cuda_stream
    b_ptr = None if b is None else b.data_ptr()
    r_ptr = None if residual is None else residual.data_ptr()
    if bf16:
        # planes of more tiles than the card holds blocks for keep their sums in
        # a float32 plane until the statistics are merged (by shape)
        prenorm = torch.empty((n, co, h, wd), dtype=torch.float32, device=x_pad.device) \
            if bf16_prenorm(n, c, co, h, wd, d, x_pad.device.index) else None
        xt, wl, xchg = bf16_scratch(n, c, co, hp, wp, x_pad.device)
        err = lib.conv3x3_in_act_bf16(
            x_pad.data_ptr(), w.data_ptr(), int(w.dtype == torch.float32), b_ptr,
            int(b is not None and b.dtype == torch.bfloat16), r_ptr, out.data_ptr(),
            None if prenorm is None else prenorm.data_ptr(), xt.data_ptr(), wl.data_ptr(),
            xchg.data_ptr(), n, c, co, h, wd, d, float(eps), _ACTS[act], stream)
    else:
        scratch = torch.empty(n * co * lib.conv3x3_in_act_tiles(h, wd) * 3,
                              dtype=torch.float32, device=x_pad.device)
        err = lib.conv3x3_in_act_f32(
            x_pad.data_ptr(), w.data_ptr(), b_ptr, r_ptr, out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), n, c, co, h, wd, d, float(eps), _ACTS[act], stream)
    build.check_launch("conv3x3_in_act", err)
    build.count_launch(conv3x3_in_act, x_pad.dtype)
    return out


_conv3x3_in_act_op = torch.library.custom_op(
    "michigan_tpu_torch::conv3x3_in_act", _conv3x3_in_act, mutates_args=())


@_conv3x3_in_act_op.register_fake
def _(x_pad, w, b, dilation, act, eps, residual):
    n, _, hp, wp = x_pad.shape
    return x_pad.new_empty((n, w.shape[0], hp - 2 * dilation, wp - 2 * dilation))


conv3x3_in_act.launches = 0
conv3x3_in_act.launches_by_dtype = {}
