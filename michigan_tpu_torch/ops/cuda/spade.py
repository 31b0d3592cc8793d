"""Fused SPADE normalisation: CUDA kernels, their plain versions, wrappers.

Source: ``michigan_tpu_torch/csrc/spade_norm.cu`` (built by ``build.py``).

spade_modulate(x, mean, invstd, gamma, beta)
    Replaces ``michigan_tpu/ops/pallas/spade.py:spade_modulate``
    (``_mod_kernel``): ``(x - mean[c]) * invstd[c] * (1 + gamma) + beta``, the
    statistics supplied by the caller.  Every SPADE norm of the generator.
fused_instance_norm(x, gamma=None, beta=None, eps=1e-5, act=None)
    Replaces ``spade.py:fused_instance_norm`` and its streaming form
    ``_streaming_instance_norm``: per-(n, c) instance norm with biased
    variance, optional ``(1 + gamma) * xhat + beta``, optional relu / lrelu.
    Every norm of the orientation inpainter.

Both kernels are memory-bound (16 B per f32 element for the modulation, 12-20
B for the instance norm in float32, against 3.35 TB/s); in bf16 the instance
norm reads x once, a plane held on chip by one block or split across a
thread-block cluster of up to 8 (``instance_norm_bf16_split``); the design
notes are in the CUDA source.

Tensors are NCHW.  A wrapper runs the plain PyTorch version for CPU tensors
only.  For a CUDA tensor it checks dtype, shape and contiguity, launches the
kernel on the current stream and counts the launch; anything the kernel does
not take raises.  There is no fallback on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.cuda import build
from michigan_tpu_torch.ops.norms import instance_norm

_ACTS = {None: 0, "relu": 1, "lrelu": 2}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "lrelu":
        return F.leaky_relu(y, 0.2)
    if act is not None:
        raise ValueError(f"unknown activation {act!r}")
    return y


def spade_modulate_plain(x, mean, invstd, gamma, beta):
    m = mean.float().view(1, -1, 1, 1)
    s = invstd.float().view(1, -1, 1, 1)
    y = (x.float() - m) * s * (1.0 + gamma.float()) + beta.float()
    return y.to(x.dtype)


def fused_instance_norm_plain(x, gamma=None, beta=None, eps=1e-5, act=None):
    y = instance_norm(x.float(), eps)
    if gamma is not None:
        y = y * (1.0 + gamma.float()) + beta.float()
    return _act(y, act).to(x.dtype)


# ---------------------------------------------------------------------------
# checks shared by the wrappers
# ---------------------------------------------------------------------------

def _check_nchw(name: str, t: torch.Tensor, like: torch.Tensor,
                per_sample: bool = False) -> None:
    """With `per_sample`, only each sample's (C, H, W) block must be
    contiguous, so the channel halves of one (N, 2C, H, W) tensor pass."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, x on {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, x has {like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, x has {tuple(like.shape)}")
    if not (t[0] if per_sample else t).is_contiguous():
        raise ValueError(f"{name} must be NCHW-contiguous"
                         + (" within each sample" if per_sample else ""))


def _check_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("empty tensor")
    if not x.is_contiguous():
        raise ValueError("x must be NCHW-contiguous")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def spade_modulate(x: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
                   gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """(x - mean[c]) * invstd[c] * (1 + gamma) + beta on NCHW tensors;
    mean and invstd are float32 (C,).  gamma and beta may be the two channel
    halves of one (N, 2C, H, W) tensor, read in place."""
    if x.device.type == "cpu":
        return spade_modulate_plain(x, mean, invstd, gamma, beta)
    _check_x(x)
    _check_nchw("gamma", gamma, x, per_sample=True)
    _check_nchw("beta", beta, x, per_sample=True)
    n, c, h, w = x.shape
    gb_stride = gamma.stride(0) if n > 1 else c * h * w
    if n > 1 and beta.stride(0) != gb_stride:
        raise ValueError(f"gamma and beta have sample strides {gb_stride} and "
                         f"{beta.stride(0)}")
    for name, v in (("mean", mean), ("invstd", invstd)):
        if v.device != x.device or v.dtype != torch.float32 or v.shape != (c,) \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) on {x.device}")
    out = torch.empty_like(x)
    fn = getattr(build.load("spade_norm"), f"spade_modulate_{_DTYPES[x.dtype]}")
    err = fn(x.data_ptr(), mean.data_ptr(), invstd.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), out.data_ptr(), n, c, h * w, gb_stride,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("spade_modulate", err)
    build.count_launch(spade_modulate, x.dtype)
    return out


spade_modulate.launches = 0
spade_modulate.launches_by_dtype = {}


def fused_instance_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                        beta: Optional[torch.Tensor] = None, eps: float = 1e-5,
                        act: Optional[str] = None) -> torch.Tensor:
    """Instance norm over H*W per (n, c), biased variance, then optional
    (1 + gamma) * xhat + beta, then optional 'relu' or 'lrelu' (0.2)."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta come together")
    if x.device.type == "cpu":
        return fused_instance_norm_plain(x, gamma, beta, eps, act)
    _check_x(x)
    if gamma is not None:
        _check_nchw("gamma", gamma, x)
        _check_nchw("beta", beta, x)
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    fn = getattr(build.load("spade_norm"), f"instance_norm_{_DTYPES[x.dtype]}")
    err = fn(x.data_ptr(), gamma.data_ptr() if gamma is not None else None,
             beta.data_ptr() if beta is not None else None, out.data_ptr(),
             n * c, h * w, float(eps), _ACTS[act],
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("fused_instance_norm", err)
    build.count_launch(fused_instance_norm, x.dtype)
    return out


fused_instance_norm.launches = 0
fused_instance_norm.launches_by_dtype = {}


def instance_norm_bf16_split(x: torch.Tensor) -> int:
    """Blocks per (n, c) plane that ``fused_instance_norm`` runs on the bf16
    CUDA tensor `x` (chosen by its shape and the card's SM count alone): 1
    for a plane held by one block, 2-8 for a plane split across a
    thread-block cluster, 0 for the two-pass form of planes too large for a
    cluster."""
    n, c, h, w = x.shape
    with torch.cuda.device(x.device):
        split = build.load("spade_norm").instance_norm_bf16_split(n * c, h * w)
    if split < 0:
        raise RuntimeError("instance_norm_bf16_split: the card's SM count could not be read")
    return split
