"""SAME 3x3 convolution for the low-channel / large-plane class: CUDA kernel,
plain version, wrapper.

Source: ``michigan_tpu_torch/csrc/conv_lowch.cu`` (built by ``build.py``),
whose tiles it shares with ``conv_in_act.cu``: ``conv3x3_tile.cuh`` in
float32, ``conv3x3_bf16.cuh`` in bfloat16.

conv3x3_same_lowch(x, w)
    Replaces ``michigan_tpu/ops/pallas/conv_lowch.py:conv3x3_same_lowch``:
    the 3x3 correlation of x (N, C, H, W) with the OIHW weight (Co, C, 3,
    3), zero padding 1, stride 1, no bias, fp32 accumulation.  Forward
    only, like the TPU kernel, so its caller is a frozen tower under
    ``torch.no_grad()``: VGG19's ``features_2`` (64 -> 64 at 512^2) in the
    training step's tower of the tag and ref images (models/vgg.py).

x is float32 or bfloat16 and the output has its dtype.  In bfloat16, as the
TPU kernel under the bf16 policy (VGG19 stored in bf16), the weight is cast
to bfloat16, the products are summed in float32 and the output is rounded to
bfloat16 once.

The kernel is compute-bound in float32 (C*9 FMAs per output) and about even
between bytes and products in bfloat16; it runs on the tensor cores,
float32-accurate through the 3xTF32 split, or in bfloat16 as one launch of
wgmma products on x as given (a persistent grid, the weights resident in
shared memory), with no cuDNN, cuBLAS or CUTLASS call; the design notes are
in the CUDA source.  A wrapper runs the
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
    """F.conv2d; in bfloat16 the TPU kernel's arithmetic: a float32 conv of
    x and of w rounded to bfloat16, whose products are exact, rounded to
    bfloat16 once (the kernel's fp32 sums cast to x's dtype)."""
    if x.dtype != torch.bfloat16:
        return F.conv2d(x, w, padding=1)
    return F.conv2d(x.float(), w.to(x.dtype).float(), padding=1).to(x.dtype)


def conv3x3_same_lowch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) x, (Co, C, 3, 3) w -> the SAME 3x3 convolution (N, Co,
    H, W) in x's dtype, without a bias: x and w float32, or x bfloat16 and
    w bfloat16 or float32 (rounded to bfloat16)."""
    if x.device.type == "cpu":
        return conv3x3_same_lowch_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    bf16 = x.dtype == torch.bfloat16
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            w.dtype not in ((torch.float32, torch.bfloat16) if bf16 else (torch.float32,)):
        raise TypeError(f"kernel takes float32, or bfloat16 x with a bfloat16 or float32 w; "
                        f"got x {x.dtype}, w {w.dtype}")
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
    lib = build.load("conv_lowch")
    out = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if bf16:
        err = lib.conv3x3_same_bf16(x.data_ptr(), w.data_ptr(), int(w.dtype == torch.float32),
                                    out.data_ptr(), n, c, co, h, wd, stream)
    else:
        err = lib.conv3x3_same_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, c, co, h, wd,
                                   stream)
    build.check_launch("conv3x3_same_lowch", err)
    build.count_launch(conv3x3_same_lowch, x.dtype)
    return out


conv3x3_same_lowch.launches = 0
conv3x3_same_lowch.launches_by_dtype = {}
