"""Oriented filter banks (Gabor / DoG) and dense orientation (port of
michigan_tpu/ops/filters.py).

The banks are the JAX package's, built with numpy the same way
(reference loss.py:215-271: x runs along the first spatial dim, y along the
second; sigma_x=2 sigma_y=3 lambda=4 psi=0 for Gabor, sigma_h=1 sigma_l=2
sigma_y=2 for DoG) and cached.  ``orientation_response`` goes to the
``filterbank_orientation`` wrapper: the CUDA kernel on a card, its plain
version on the CPU; ``bf16_operands`` picks its bf16-operand form, the JAX
package's ``fwd_bf16`` forward.  ``cal_orientation_two_channel`` (the training loss's
orientation) differentiates through the max response with
``OrientationResponse``, whose backward is ``filterbank_orientation_backward``.

Public functions keep the JAX layout: gray is (N, H, W, 1).  Inside, the
port is NCHW (for one channel the same memory).  The JAX package's
space-to-depth re-expression of the bank conv is not ported: it shapes a
one-channel conv for the TPU's matrix unit, and on the card the filter-bank
kernel replaces it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from michigan_tpu_torch.ops.cuda.orient import OrientationResponse, filterbank_orientation

NUM_KERNELS = 32
KERNEL_SIZE = 17


def _grid(kernel_size: int):
    r = kernel_size // 2
    coords = np.arange(-r, r + 1, dtype=np.float32)
    # reference: x varies along rows (first spatial dim), y along cols
    x = coords[:, None] * np.ones((1, kernel_size), np.float32)
    y = np.ones((kernel_size, 1), np.float32) * coords[None, :]
    return x, y


@functools.lru_cache(maxsize=8)
def _gabor_bank_np(kernel_size: int = KERNEL_SIZE, num: int = NUM_KERNELS) -> np.ndarray:
    """(k, k, 1, num) HWIO Gabor bank; theta_i = pi*i/num (loss.py:215-243)."""
    x, y = _grid(kernel_size)
    sigma_x, sigma_y, lam, psi = 2.0, 3.0, 4.0, 0.0
    kernels = []
    for i in range(num):
        t = math.pi * i / num
        xt = x * math.cos(t) + y * math.sin(t)
        yt = -x * math.sin(t) + y * math.cos(t)
        gb = np.exp(-0.5 * (xt**2 / sigma_x**2 + yt**2 / sigma_y**2)) * np.cos(
            2.0 * math.pi / lam * xt + psi
        )
        kernels.append(gb.astype(np.float32))
    return np.stack(kernels, axis=-1)[:, :, None, :]


@functools.lru_cache(maxsize=8)
def _dog_bank_np(kernel_size: int = KERNEL_SIZE, num: int = NUM_KERNELS) -> np.ndarray:
    """(k, k, 1, num) HWIO DoG bank (loss.py:245-271, cal_orientation.py:18-44)."""
    x, y = _grid(kernel_size)
    sigma_h, sigma_l, sigma_y = 1.0, 2.0, 2.0
    kernels = []
    for i in range(num):
        t = math.pi * i / num
        xt = x * math.cos(t) + y * math.sin(t)
        yt = -x * math.sin(t) + y * math.cos(t)
        gb = (
            np.exp(-0.5 * (xt**2 / sigma_h**2 + yt**2 / sigma_y**2)) / sigma_h
            - np.exp(-0.5 * (xt**2 / sigma_l**2 + yt**2 / sigma_y**2)) / sigma_l
        ) / (1.0 / sigma_h - 1.0 / sigma_l)
        kernels.append(gb.astype(np.float32))
    return np.stack(kernels, axis=-1)[:, :, None, :]


@functools.lru_cache(maxsize=8)
def bank(mode: str, device: torch.device) -> torch.Tensor:
    """The (17, 17, 1, 32) HWIO bank of `mode` ('gabor' or 'dog') as a
    float32 tensor on `device`, made once per (mode, device)."""
    if mode not in ("gabor", "dog"):
        raise ValueError(f"unknown filter bank {mode!r}")
    arr = _gabor_bank_np() if mode == "gabor" else _dog_bank_np()
    return torch.from_numpy(arr).to(device)


def rgb_to_gray255(image_pm1: torch.Tensor) -> torch.Tensor:
    """[-1,1] NHWC RGB -> single-channel gray in [0,255] (loss.py:357-359).

    The reference's blue weight is 0.144 (not .114), kept for parity."""
    img = (image_pm1 + 1.0) / 2.0 * 255.0
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.144 * img[..., 2]
    return gray[..., None]


def orientation_response(gray: torch.Tensor, mode: str = "gabor"):
    """(N,H,W,1) gray -> per pixel (argmax index int32 (N,H,W), raw max
    response (N,H,W)) over the bank, responses clamped at 0 first and ties
    to the first index (loss.py:293-311)."""
    g = gray.float().permute(0, 3, 1, 2).contiguous()
    return filterbank_orientation(g, bank(mode, gray.device))


def dense_orientation(gray: torch.Tensor, mode: str = "dog"):
    """cal_orientation.py:60-80: (argmax as a float map, confidence), both
    (N,H,W,1)."""
    idx, raw_conf = orientation_response(gray, mode)
    return idx.float()[..., None], raw_conf[..., None]


def cal_orientation_two_channel(image_pm1: torch.Tensor, mode: str = "gabor",
                                hair_mask: torch.Tensor = None, bf16_operands: bool = False,
                                response=OrientationResponse.apply):
    """loss.py:293-343: ((sin 2t, cos 2t) * confidence (N,H,W,2), confidence
    (N,H,W,1)) of an NHWC [-1,1] image.  Gabor squashes the max response
    with (tanh + 1) / 2; DoG masks it by `hair_mask` (N,H,W,1) and divides
    by its maximum over the batch.  The gradient reaches the image through
    the max response only, as in torch.  `bf16_operands`: the bank's
    bf16-operand forward (the JAX package's fwd_bf16).  `response(gray,
    bank, bf16_operands)` gives (argmax, max response): the bank on the
    plane (``OrientationResponse``), or on a band with its halo rows
    (parallel/spatial.py ``Bands.orientation_response``)."""
    gray = rgb_to_gray255(image_pm1).permute(0, 3, 1, 2).contiguous()
    idx, raw_conf = response(gray, bank(mode, gray.device), bf16_operands)
    theta = idx.float() * (math.pi / NUM_KERNELS)
    if mode == "gabor":
        conf = (torch.tanh(raw_conf) + 1.0) / 2.0
    else:
        conf = raw_conf[..., None]
        if hair_mask is not None:
            conf = conf * hair_mask
        conf = conf / conf.max().clamp_min(1e-12)
        conf = torch.where(conf <= 0, torch.zeros_like(conf), conf)[..., 0]
    two = torch.stack([torch.sin(2.0 * theta), torch.cos(2.0 * theta)], dim=-1)
    return two * conf[..., None], conf[..., None]
