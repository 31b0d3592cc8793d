"""Hand-written CUDA kernels (``michigan_tpu_torch/csrc``) and their wrappers.

Each wrapper counts its kernel's launches in its ``launches`` attribute, and
by the dtype of the tensors it ran on in ``launches_by_dtype`` ({"float32":
n, "bfloat16": m}); ``reset_launch_counts`` and ``launch_counts`` read all of
them, so a run can show which kernels its path went through, in which dtype.
"""

from michigan_tpu_torch.ops.cuda.epilogue import conv3x3_in_act
from michigan_tpu_torch.ops.cuda.lowch import conv3x3_same_lowch
from michigan_tpu_torch.ops.cuda.orient import (
    filterbank_orientation,
    filterbank_orientation_backward,
)
from michigan_tpu_torch.ops.cuda.spade import fused_instance_norm, spade_modulate

KERNELS = (spade_modulate, fused_instance_norm, conv3x3_in_act, filterbank_orientation,
           filterbank_orientation_backward, conv3x3_same_lowch)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_by_dtype = {}


def launch_counts(by_dtype: bool = False) -> dict:
    """{kernel: launches}, or with `by_dtype` {kernel: {dtype: launches}}
    (dtypes with no launch left out)."""
    if by_dtype:
        return {k.__name__: dict(k.launches_by_dtype) for k in KERNELS}
    return {k.__name__: k.launches for k in KERNELS}
