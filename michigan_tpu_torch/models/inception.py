"""InceptionV3 pool3 feature extractor for FID (port of
michigan_tpu/models/inception.py), NCHW inside, NHWC at the interface.

torchvision's inception_v3 up to its average pool, without the aux head:
every conv is torchvision's BasicConv2d, a bias-free conv, BatchNorm with
eps 1e-3 on its running statistics, and ReLU.  The state_dict keys are
torchvision's (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.
running_mean``, ...), so its ImageNet release loads as it is; the JAX
package's ``inception_v3.npz`` (flat ``name/leaf`` keys) loads through
``convert.inception_state_dict``.  Without either file the net gets the JAX
package's kaiming-fan-in fallback and the same loud warning.

Convolutions are PyTorch's (cuDNN on a card), as the JAX package leaves them
to XLA: no TPU kernel computes any part of this net.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
FEATURE_DIM = 2048
INCEPTION_ENV = "MICHIGAN_INCEPTION"

# name -> (in_ch, out_ch, (kh, kw), (sh, sw), (ph, pw)); torchvision's
# inception_v3 geometry (the JAX package's INCEPTION_SPEC)
Spec = Dict[str, Tuple[int, int, Tuple[int, int], Tuple[int, int], Tuple[int, int]]]


def _build_spec() -> Spec:
    S: Spec = {}

    def c(name, i, o, k=(1, 1), s=(1, 1), p=(0, 0)):
        S[name] = (i, o, k, s, p)

    c("Conv2d_1a_3x3", 3, 32, (3, 3), (2, 2))
    c("Conv2d_2a_3x3", 32, 32, (3, 3))
    c("Conv2d_2b_3x3", 32, 64, (3, 3), p=(1, 1))
    c("Conv2d_3b_1x1", 64, 80)
    c("Conv2d_4a_3x3", 80, 192, (3, 3))

    def inc_a(pre, i, pool_f):
        c(f"{pre}.branch1x1", i, 64)
        c(f"{pre}.branch5x5_1", i, 48)
        c(f"{pre}.branch5x5_2", 48, 64, (5, 5), p=(2, 2))
        c(f"{pre}.branch3x3dbl_1", i, 64)
        c(f"{pre}.branch3x3dbl_2", 64, 96, (3, 3), p=(1, 1))
        c(f"{pre}.branch3x3dbl_3", 96, 96, (3, 3), p=(1, 1))
        c(f"{pre}.branch_pool", i, pool_f)

    inc_a("Mixed_5b", 192, 32)
    inc_a("Mixed_5c", 256, 64)
    inc_a("Mixed_5d", 288, 64)

    c("Mixed_6a.branch3x3", 288, 384, (3, 3), (2, 2))
    c("Mixed_6a.branch3x3dbl_1", 288, 64)
    c("Mixed_6a.branch3x3dbl_2", 64, 96, (3, 3), p=(1, 1))
    c("Mixed_6a.branch3x3dbl_3", 96, 96, (3, 3), (2, 2))

    def inc_c(pre, c7):
        c(f"{pre}.branch1x1", 768, 192)
        c(f"{pre}.branch7x7_1", 768, c7)
        c(f"{pre}.branch7x7_2", c7, c7, (1, 7), p=(0, 3))
        c(f"{pre}.branch7x7_3", c7, 192, (7, 1), p=(3, 0))
        c(f"{pre}.branch7x7dbl_1", 768, c7)
        c(f"{pre}.branch7x7dbl_2", c7, c7, (7, 1), p=(3, 0))
        c(f"{pre}.branch7x7dbl_3", c7, c7, (1, 7), p=(0, 3))
        c(f"{pre}.branch7x7dbl_4", c7, c7, (7, 1), p=(3, 0))
        c(f"{pre}.branch7x7dbl_5", c7, 192, (1, 7), p=(0, 3))
        c(f"{pre}.branch_pool", 768, 192)

    inc_c("Mixed_6b", 128)
    inc_c("Mixed_6c", 160)
    inc_c("Mixed_6d", 160)
    inc_c("Mixed_6e", 192)

    c("Mixed_7a.branch3x3_1", 768, 192)
    c("Mixed_7a.branch3x3_2", 192, 320, (3, 3), (2, 2))
    c("Mixed_7a.branch7x7x3_1", 768, 192)
    c("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7), p=(0, 3))
    c("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1), p=(3, 0))
    c("Mixed_7a.branch7x7x3_4", 192, 192, (3, 3), (2, 2))

    def inc_e(pre, i):
        c(f"{pre}.branch1x1", i, 320)
        c(f"{pre}.branch3x3_1", i, 384)
        c(f"{pre}.branch3x3_2a", 384, 384, (1, 3), p=(0, 1))
        c(f"{pre}.branch3x3_2b", 384, 384, (3, 1), p=(1, 0))
        c(f"{pre}.branch3x3dbl_1", i, 448)
        c(f"{pre}.branch3x3dbl_2", 448, 384, (3, 3), p=(1, 1))
        c(f"{pre}.branch3x3dbl_3a", 384, 384, (1, 3), p=(0, 1))
        c(f"{pre}.branch3x3dbl_3b", 384, 384, (3, 1), p=(1, 0))
        c(f"{pre}.branch_pool", i, 192)

    inc_e("Mixed_7b", 1280)
    inc_e("Mixed_7c", 2048)
    return S


INCEPTION_SPEC: Spec = _build_spec()


class BasicConv2d(nn.Module):
    """torchvision's BasicConv2d: conv (no bias), BN (eps 1e-3), ReLU."""

    def __init__(self, i, o, k, s, p):
        super().__init__()
        self.conv = nn.Conv2d(i, o, k, s, p, bias=False)
        self.bn = nn.BatchNorm2d(o, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg3(x):
    # count_include_pad=True, torchvision's default inside the branches
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _max3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionV3(nn.Module):
    """forward(x): NHWC in [-1, 1] (pytorch-fid's convention), 299^2 for
    FID (any size >= 75) -> (N, 2048) pool3 features, float32."""

    def __init__(self):
        super().__init__()
        for name, (i, o, k, s, p) in INCEPTION_SPEC.items():
            parent, _, leaf = name.rpartition(".")
            owner = self
            if parent:
                if not hasattr(self, parent):
                    self.add_module(parent, nn.Module())
                owner = getattr(self, parent)
            owner.add_module(leaf, BasicConv2d(i, o, k, s, p))
        self.eval()

    def _bc(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.get_submodule(name)(x)

    def _block_a(self, pre, x):
        b1 = self._bc(f"{pre}.branch1x1", x)
        b5 = self._bc(f"{pre}.branch5x5_2", self._bc(f"{pre}.branch5x5_1", x))
        b3 = x
        for i in (1, 2, 3):
            b3 = self._bc(f"{pre}.branch3x3dbl_{i}", b3)
        bp = self._bc(f"{pre}.branch_pool", _avg3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, x):
        b3 = self._bc("Mixed_6a.branch3x3", x)
        bd = x
        for i in (1, 2, 3):
            bd = self._bc(f"Mixed_6a.branch3x3dbl_{i}", bd)
        return torch.cat([b3, bd, _max3s2(x)], dim=1)

    def _block_c(self, pre, x):
        b1 = self._bc(f"{pre}.branch1x1", x)
        b7 = x
        for i in (1, 2, 3):
            b7 = self._bc(f"{pre}.branch7x7_{i}", b7)
        bd = x
        for i in range(1, 6):
            bd = self._bc(f"{pre}.branch7x7dbl_{i}", bd)
        bp = self._bc(f"{pre}.branch_pool", _avg3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _block_d(self, x):
        b3 = self._bc("Mixed_7a.branch3x3_2", self._bc("Mixed_7a.branch3x3_1", x))
        b7 = x
        for i in range(1, 5):
            b7 = self._bc(f"Mixed_7a.branch7x7x3_{i}", b7)
        return torch.cat([b3, b7, _max3s2(x)], dim=1)

    def _block_e(self, pre, x):
        b1 = self._bc(f"{pre}.branch1x1", x)
        b3 = self._bc(f"{pre}.branch3x3_1", x)
        b3 = torch.cat([self._bc(f"{pre}.branch3x3_2a", b3),
                        self._bc(f"{pre}.branch3x3_2b", b3)], dim=1)
        bd = self._bc(f"{pre}.branch3x3dbl_2", self._bc(f"{pre}.branch3x3dbl_1", x))
        bd = torch.cat([self._bc(f"{pre}.branch3x3dbl_3a", bd),
                        self._bc(f"{pre}.branch3x3dbl_3b", bd)], dim=1)
        bp = self._bc(f"{pre}.branch_pool", _avg3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = self._bc(name, x)
        x = _max3s2(x)
        x = self._bc("Conv2d_4a_3x3", self._bc("Conv2d_3b_1x1", x))
        x = _max3s2(x)
        for pre in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(pre, x)
        x = self._block_b(x)
        for pre in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(pre, x)
        x = self._block_d(x)
        x = self._block_e("Mixed_7b", x)
        x = self._block_e("Mixed_7c", x)
        return x.float().mean(dim=(2, 3))  # adaptive average pool -> 2048


def find_inception_weights(checkpoints_dir: str = "./checkpoints") -> Optional[str]:
    """$MICHIGAN_INCEPTION, then inception_v3.npz (the JAX package's
    converted file), inception_v3_google-0cc3c7bd.pth (torchvision's
    release) or inception_v3.pth under `checkpoints_dir` and the working
    directory."""
    cand = [os.environ.get(INCEPTION_ENV, "")]
    for base in (checkpoints_dir, "."):
        cand += [os.path.join(base, n) for n in (
            "inception_v3.npz", "inception_v3_google-0cc3c7bd.pth", "inception_v3.pth")]
    return next((p for p in cand if p and os.path.exists(p)), None)


def _state_from_file(path: str, own: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if path.endswith(".npz"):
        from michigan_tpu_torch.convert import inception_state_dict

        params: Dict[str, Dict[str, np.ndarray]] = {}
        for key, v in np.load(path).items():  # 'Mixed_5b.branch1x1/kernel'
            name, leaf = key.rsplit("/", 1)
            params.setdefault(name, {})[leaf] = v
        return inception_state_dict(params)
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = {k.removeprefix("module."): v for k, v in state.items()}
    # torchvision's file also holds the aux head and the classifier
    return {k: v for k, v in state.items() if k in own}


def load_inception_params(net: InceptionV3, gen: torch.Generator,
                          checkpoints_dir: str = "./checkpoints", context: str = "FID") -> bool:
    """Load pretrained weights into `net` if a file is found (True), else
    give it the kaiming fallback from `gen` and warn (False)."""
    path = find_inception_weights(checkpoints_dir)
    if path:
        net.load_state_dict(_state_from_file(path, net.state_dict()), strict=True)
        print(f"loaded pretrained InceptionV3 from {path}")
        return True
    warnings.warn(
        f"InceptionV3 weights not found (searched ${INCEPTION_ENV}, "
        f"{checkpoints_dir}/inception_v3.npz): {context} runs on a RANDOM "
        "Inception backbone — NOT comparable to published FID. Put torchvision's "
        f"inception_v3_google-0cc3c7bd.pth at ${INCEPTION_ENV} or in {checkpoints_dir}; "
        "it loads as it is, with no conversion.",
        stacklevel=2,
    )
    # kaiming fan_in keeps the activations' variance through conv + ReLU;
    # the batch norms stay at the identity
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BasicConv2d):
                w = m.conv.weight
                w.copy_(torch.randn(w.shape, generator=gen) * math.sqrt(2.0 / w[0].numel()))
                m.bn.reset_parameters()
    return False
