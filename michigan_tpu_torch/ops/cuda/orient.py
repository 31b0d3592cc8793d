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
    ``michigan_tpu_torch.ops.filters.bank`` makes it.  With
    ``bf16_operands`` it is the JAX package's forward under --dtype
    bfloat16 (``michigan_tpu/ops/filters.py:207-225``, ``fwd_bf16``): gray
    and bank rounded to bfloat16, the products summed in float32, and each
    response rounded to bfloat16 (XLA's bf16 conv returns bf16) before the
    clamp and the argmax; idx and conf stay int32 and float32.  Its launches
    count under "bfloat16" in ``launches_by_dtype``, the operands' dtype.
filterbank_orientation_backward(dconf, idx, conf, bank)
    The gradient of conf with respect to gray, which the JAX package takes
    by autodiff through the bank conv (``michigan_tpu/ops/filters.py:
    207-250``): the upstream gradient at each pixel q, where conf[q] > 0,
    spread back through the 17x17 filter of its argmax orientation.
    Returns dgray (N, 1, H, W).
OrientationResponse
    The ``torch.autograd.Function`` that joins the two: forward
    ``filterbank_orientation``, backward ``filterbank_orientation_backward``;
    idx carries no gradient.  The training step's ORIENT / CONFIDENCE loss
    differentiates through it.

The forward kernel is a dense product (9,248 FMAs per pixel) on the tensor
cores, float32-accurate through the 3xTF32 split; with bf16 operands a
kernel of its own on bf16 tensor-core products, one float32 chain over K.
The backward is a gather (289 FMAs per pixel) bound by shared-memory reads,
which skips the output blocks that no gradient reaches; the design notes
are in the CUDA source.  A wrapper runs the plain PyTorch version for CPU
tensors only.  For a CUDA tensor it checks dtype, shape, contiguity and device,
launches the kernel on the current stream and counts the launch; anything the
kernel does not take raises.  There is no fallback on CUDA tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from michigan_tpu_torch.ops.cuda import build

BANK_SHAPE = (17, 17, 1, 32)
# (rows, columns) of output that one warp of the backward kernel computes, or
# skips with zeros where no nonzero dconf * [conf > 0] lies within 8 pixels
BACKWARD_SKIP_BLOCK = (16, 32)


def filterbank_orientation_plain(gray: torch.Tensor, bank: torch.Tensor,
                                 bf16_operands: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One conv with the whole bank, clamp, then max over the orientations
    (torch.max returns the first index of equal maxima).  With
    `bf16_operands`, a float32 conv of gray and bank rounded to bfloat16
    (exact products) whose responses are rounded to bfloat16."""
    gray = gray.float()
    if bf16_operands:
        gray, bank = (t.to(torch.bfloat16).float() for t in (gray, bank))
    res = F.conv2d(gray, bank.permute(3, 2, 0, 1).to(gray.dtype), padding=bank.shape[0] // 2)
    if bf16_operands:
        res = res.to(torch.bfloat16).float()
    conf, idx = res.clamp_min(0.0).max(dim=1)
    return idx.to(torch.int32), conf


def filterbank_orientation_backward_plain(dconf: torch.Tensor, idx: torch.Tensor,
                                          conf: torch.Tensor, bank: torch.Tensor
                                          ) -> torch.Tensor:
    """The transposed bank conv of a cotangent that is dconf at each pixel's
    argmax orientation where conf > 0, and 0 elsewhere."""
    g = torch.where(conf > 0, dconf.float(), torch.zeros((), device=dconf.device))
    cot = torch.zeros((idx.shape[0], bank.shape[3]) + tuple(idx.shape[1:]),
                      dtype=g.dtype, device=dconf.device)
    cot.scatter_(1, idx.long().unsqueeze(1), g.unsqueeze(1))
    return F.conv_transpose2d(cot, bank.permute(3, 2, 0, 1).to(g.dtype), padding=bank.shape[0] // 2)


def _check_bank(bank: torch.Tensor, like: torch.Tensor) -> None:
    if bank.dtype != torch.float32:
        raise TypeError(f"kernel takes a float32 bank, got {bank.dtype}")
    if tuple(bank.shape) != BANK_SHAPE:
        raise ValueError(f"bank must be {BANK_SHAPE}, got {tuple(bank.shape)}")
    if bank.device != like.device:
        raise ValueError(f"bank is on {bank.device}, the planes on {like.device}")
    if not bank.is_contiguous():
        raise ValueError("bank must be contiguous")
    if bank.data_ptr() % 16:
        raise ValueError("bank must be 16-byte aligned")


def filterbank_orientation(gray: torch.Tensor, bank: torch.Tensor, bf16_operands: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 1, H, W) float32 gray, (17, 17, 1, 32) bank -> (first argmax
    int32 (N, H, W), max response float32 (N, H, W)) over the clamped
    responses; with `bf16_operands` the bf16-operand form (above)."""
    if gray.device.type == "cpu":
        return filterbank_orientation_plain(gray, bank, bf16_operands)
    if gray.device.type != "cuda":
        raise ValueError(f"no kernel for device {gray.device}")
    if gray.dtype != torch.float32:
        raise TypeError(f"kernel takes float32, got gray {gray.dtype}")
    if gray.dim() != 4 or gray.shape[1] != 1 or gray.numel() == 0:
        raise ValueError(f"expected a non-empty (N, 1, H, W) gray plane, got {tuple(gray.shape)}")
    if gray.shape[0] > 65535:
        raise ValueError(f"at most 65535 planes per launch, got {gray.shape[0]}")
    if not gray.is_contiguous():
        raise ValueError("gray must be contiguous")
    _check_bank(bank, gray)
    n, _, h, w = gray.shape
    idx = torch.empty((n, h, w), dtype=torch.int32, device=gray.device)
    conf = torch.empty((n, h, w), dtype=torch.float32, device=gray.device)
    lib = build.load("filterbank")
    launch = lib.filterbank_orientation_bf16ops if bf16_operands else \
        lib.filterbank_orientation_f32
    err = launch(gray.data_ptr(), bank.data_ptr(), idx.data_ptr(), conf.data_ptr(), n, h, w,
                 torch.cuda.current_stream(gray.device).cuda_stream)
    build.check_launch("filterbank_orientation", err)
    build.count_launch(filterbank_orientation, torch.bfloat16 if bf16_operands else gray.dtype)
    return idx, conf


filterbank_orientation.launches = 0
filterbank_orientation.launches_by_dtype = {}


def filterbank_orientation_backward(dconf: torch.Tensor, idx: torch.Tensor,
                                    conf: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """dconf (N, H, W) float32 and the forward's idx (int32) and conf
    (float32, both (N, H, W)) -> dgray (N, 1, H, W) float32."""
    if dconf.device.type == "cpu":
        return filterbank_orientation_backward_plain(dconf, idx, conf, bank)
    if dconf.device.type != "cuda":
        raise ValueError(f"no kernel for device {dconf.device}")
    if dconf.dim() != 3 or dconf.numel() == 0:
        raise ValueError(f"expected a non-empty (N, H, W) dconf, got {tuple(dconf.shape)}")
    if dconf.shape[0] > 65535:
        raise ValueError(f"at most 65535 planes per launch, got {dconf.shape[0]}")
    for name, t, dtype in (("dconf", dconf, torch.float32), ("idx", idx, torch.int32),
                           ("conf", conf, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != dconf.shape or t.device != dconf.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, dconf "
                             f"{tuple(dconf.shape)} on {dconf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_bank(bank, dconf)
    n, h, w = dconf.shape
    dgray = torch.empty((n, 1, h, w), dtype=torch.float32, device=dconf.device)
    err = build.load("filterbank").filterbank_orientation_backward_f32(
        dconf.data_ptr(), idx.data_ptr(), conf.data_ptr(), bank.data_ptr(), dgray.data_ptr(),
        n, h, w, torch.cuda.current_stream(dconf.device).cuda_stream)
    build.check_launch("filterbank_orientation_backward", err)
    build.count_launch(filterbank_orientation_backward, dconf.dtype)
    return dgray


filterbank_orientation_backward.launches = 0
filterbank_orientation_backward.launches_by_dtype = {}


class OrientationResponse(torch.autograd.Function):
    """(gray, bank, bf16_operands) -> (idx, conf) as
    ``filterbank_orientation``; the gradient reaches gray through conf by
    ``filterbank_orientation_backward`` in float32 (the bank is a constant;
    the bf16 rounding of the bf16-operand form passes the gradient through
    unchanged, as a cast does)."""

    @staticmethod
    def forward(ctx, gray, bank, bf16_operands=False):
        idx, conf = filterbank_orientation(gray, bank, bf16_operands)
        ctx.save_for_backward(idx, conf, bank)
        ctx.mark_non_differentiable(idx)
        return idx, conf

    @staticmethod
    def backward(ctx, _didx, dconf):
        idx, conf, bank = ctx.saved_tensors
        return filterbank_orientation_backward(dconf.contiguous(), idx, conf, bank), None, None
