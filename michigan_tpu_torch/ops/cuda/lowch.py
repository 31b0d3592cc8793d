"""SAME 3x3 convolution for the low-channel / large-plane class: CUDA kernel,
plain version, wrapper.

Source: ``michigan_tpu_torch/csrc/conv_lowch.cu`` (built by ``build.py``),
whose tile it shares with ``conv_in_act.cu`` through ``conv3x3_tile.cuh``.

conv3x3_same_lowch(x, w)
    Replaces ``michigan_tpu/ops/pallas/conv_lowch.py:conv3x3_same_lowch``:
    the 3x3 correlation of x (N, C, H, W) with the OIHW weight (Co, C, 3,
    3), zero padding 1, stride 1, no bias, fp32 accumulation.  Forward
    only, like the TPU kernel, so its caller is a frozen tower under
    ``torch.no_grad()``: VGG19's ``features_2`` (64 -> 64 at 512^2) in the
    training step's tower of the tag and ref images (models/vgg.py).

The kernel is compute-bound (C*9 FMAs per output); it runs on the tensor
cores, float32-accurate through the 3xTF32 split, with no cuDNN, cuBLAS or
CUTLASS call; the design notes are in the CUDA source.  A wrapper runs the
plain PyTorch version for CPU tensors only.  For a CUDA tensor it checks
dtype, shape, contiguity and device, launches the kernel on the current
stream and counts the launch; anything the kernel does not take raises.
There is no fallback on CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.cuda import build


def conv3x3_same_lowch_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, padding=1)


def conv3x3_same_lowch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) float32 x, (Co, C, 3, 3) float32 w -> the SAME 3x3
    convolution (N, Co, H, W), without a bias."""
    if x.device.type == "cpu":
        return conv3x3_same_lowch_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"kernel takes float32, got x {x.dtype}, w {w.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"expected a non-empty NCHW x, got {tuple(x.shape)}")
    n, c, h, wd = x.shape
    if w.dim() != 4 or tuple(w.shape[1:]) != (c, 3, 3) or w.shape[0] == 0:
        raise ValueError(f"w must be (Co, {c}, 3, 3), got {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("x and w must be contiguous")
    co = w.shape[0]
    if n > 65535 or co > 65535 * 64:
        raise ValueError(f"too many samples or channels for one launch: {n}, {co}")
    out = torch.empty((n, co, h, wd), dtype=torch.float32, device=x.device)
    err = build.load("conv_lowch").conv3x3_same_f32(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, c, co, h, wd,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("conv3x3_same_lowch", err)
    build.count_launch(conv3x3_same_lowch, x.dtype)
    return out


conv3x3_same_lowch.launches = 0
conv3x3_same_lowch.launches_by_dtype = {}
