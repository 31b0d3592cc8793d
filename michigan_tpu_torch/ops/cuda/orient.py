"""Dense-orientation filter bank: CUDA kernel, plain version, wrapper.

Source: ``michigan_tpu_torch/csrc/filterbank.cu`` (built by ``build.py``).

filterbank_orientation(gray, bank)
    Replaces ``michigan_tpu/ops/pallas/filterbank.py:filterbank_orientation``,
    which computes ``michigan_tpu/ops/filters.py:orientation_response``: the
    'same' zero-padded correlation of an (N, 1, H, W) float32 gray plane with
    a bank of 32 oriented 17x17 filters, each response clamped at 0, then
    per pixel the first index of the largest response and that response.
    Returns (idx int32 (N, H, W), conf float32 (N, H, W)).  The bank is the
    JAX package's HWIO layout, (17, 17, 1, 32), as
    ``michigan_tpu_torch.ops.filters.bank`` makes it.

The kernel is compute-bound (9,248 FMAs per pixel); the design notes are in
the CUDA source.  A wrapper runs the plain PyTorch version for CPU tensors
only.  For a CUDA tensor it checks dtype, shape, contiguity and device,
launches the kernel on the current stream and counts the launch; anything the
kernel does not take raises.  There is no fallback on CUDA tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.cuda import build

BANK_SHAPE = (17, 17, 1, 32)


def filterbank_orientation_plain(gray: torch.Tensor, bank: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One conv with the whole bank, clamp, then max over the orientations
    (torch.max returns the first index of equal maxima)."""
    res = F.conv2d(gray.float(), bank.permute(3, 2, 0, 1), padding=bank.shape[0] // 2)
    conf, idx = res.clamp_min(0.0).max(dim=1)
    return idx.to(torch.int32), conf


def filterbank_orientation(gray: torch.Tensor, bank: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 1, H, W) float32 gray, (17, 17, 1, 32) bank -> (first argmax
    int32 (N, H, W), max response float32 (N, H, W)) over the clamped
    responses."""
    if gray.device.type == "cpu":
        return filterbank_orientation_plain(gray, bank)
    if gray.device.type != "cuda":
        raise ValueError(f"no kernel for device {gray.device}")
    if gray.dtype != torch.float32 or bank.dtype != torch.float32:
        raise TypeError(f"kernel takes float32, got gray {gray.dtype}, bank {bank.dtype}")
    if gray.dim() != 4 or gray.shape[1] != 1 or gray.numel() == 0:
        raise ValueError(f"expected a non-empty (N, 1, H, W) gray plane, got {tuple(gray.shape)}")
    if gray.shape[0] > 65535:
        raise ValueError(f"at most 65535 planes per launch, got {gray.shape[0]}")
    if tuple(bank.shape) != BANK_SHAPE:
        raise ValueError(f"bank must be {BANK_SHAPE}, got {tuple(bank.shape)}")
    if bank.device != gray.device:
        raise ValueError(f"bank is on {bank.device}, gray on {gray.device}")
    if not gray.is_contiguous() or not bank.is_contiguous():
        raise ValueError("gray and bank must be contiguous")
    if bank.data_ptr() % 16:
        raise ValueError("bank must be 16-byte aligned")
    n, _, h, w = gray.shape
    idx = torch.empty((n, h, w), dtype=torch.int32, device=gray.device)
    conf = torch.empty((n, h, w), dtype=torch.float32, device=gray.device)
    err = build.load("filterbank").filterbank_orientation_f32(
        gray.data_ptr(), bank.data_ptr(), idx.data_ptr(), conf.data_ptr(), n, h, w,
        torch.cuda.current_stream(gray.device).cuda_stream)
    build.check_launch("filterbank_orientation", err)
    filterbank_orientation.launches += 1
    return idx, conf


filterbank_orientation.launches = 0
