"""VGG19 feature extractor for the perceptual, style and content losses (port
of michigan_tpu/models/vgg.py), NCHW.

torchvision's vgg19.features up to relu5_1, sliced after the ReLUs at
features indices 1, 6, 11, 20 and 29 (reference architecture.py:160-190).
The state_dict keys are torchvision's (``features.<index>.weight``), so the
ImageNet release file loads as it is.  Weights are looked for as the JAX
package looks for them; without them the tower gets the JAX package's
feature-preserving fallback (kaiming fan_in), and the same warning.

``features_2`` (64 -> 64 at full resolution) runs ``conv3x3_same_lowch``
when autograd records nothing: the kernel has no backward, so it serves the
training step's no-grad tower of the tag and ref images, and the
differentiated tower of the fake keeps cuDNN.  The bias and the ReLU stay
outside the kernel, in x's dtype, as on the TPU.  Under the bf16 policy the
tower is stored in bfloat16 (``MichiGANModel.compact_frozen_nets``) and
runs on bfloat16 input, the kernel in its bfloat16 form.
"""

from __future__ import annotations

import math
import os
import re
import warnings
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from michigan_tpu_torch.models.layers import Conv2d
from michigan_tpu_torch.ops.cuda.lowch import conv3x3_same_lowch
from michigan_tpu_torch.ops.resize import max_pool_same

# torchvision vgg19.features[0:30]: ("conv", index, out_channels) with its
# ReLU, ("pool",), or ("slice",) where a feature map is handed out
PLAN = [
    ("conv", 0, 64), ("slice",),
    ("conv", 2, 64), ("pool",),
    ("conv", 5, 128), ("slice",),
    ("conv", 7, 128), ("pool",),
    ("conv", 10, 256), ("slice",),
    ("conv", 12, 256), ("conv", 14, 256), ("conv", 16, 256), ("pool",),
    ("conv", 19, 512), ("slice",),
    ("conv", 21, 512), ("conv", 23, 512), ("conv", 25, 512), ("pool",),
    ("conv", 28, 512), ("slice",),
]
LOWCH_CONV = 2  # features index of the 64 -> 64 full-resolution conv

VGG19_ENV = "MICHIGAN_VGG19"


class VGG19(nn.Module):
    """Returns [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1]."""

    def __init__(self):
        super().__init__()
        convs, cin = {}, 3
        for step in PLAN:
            if step[0] == "conv":
                convs[str(step[1])] = Conv2d(cin, step[2], 3, padding=1)
                cin = step[2]
        self.features = nn.ModuleDict(convs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for step in PLAN:
            if step[0] == "conv":
                conv = self.features[str(step[1])]
                if step[1] == LOWCH_CONV and not torch.is_grad_enabled():
                    x = conv3x3_same_lowch(x, conv.weight)
                    x += conv.bias.view(1, -1, 1, 1)
                    x = F.relu(x, inplace=True)
                else:
                    x = F.relu(conv(x))
            elif step[0] == "pool":
                x = max_pool_same(x, 2, 2, 0)
            else:
                outs.append(x)
        return outs


def find_vgg19_weights(checkpoints_dir: str) -> Optional[str]:
    """$MICHIGAN_VGG19, then vgg19.npz (the JAX package's converted cache),
    vgg19-dcbb9e9d.pth (torchvision's release) or vgg19.pth under
    `checkpoints_dir` and the working directory."""
    cand = [os.environ.get(VGG19_ENV, "")]
    for base in (checkpoints_dir, "."):
        cand += [os.path.join(base, n) for n in ("vgg19.npz", "vgg19-dcbb9e9d.pth", "vgg19.pth")]
    return next((p for p in cand if p and os.path.exists(p)), None)


def _state_from_file(path: str):
    if path.endswith(".npz"):
        from michigan_tpu_torch.convert import VGG_RENAMES, module_state_dict

        tree: dict = {}
        for key, v in np.load(path).items():  # 'params/features_0/kernel'
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return module_state_dict(tree, VGG_RENAMES)
    state = torch.load(path, map_location="cpu", weights_only=True)
    # torchvision's full-model file also holds the classifier
    return {("features." + k if not k.startswith("features.") else k): v
            for k, v in state.items() if re.match(r"^(features\.)?\d+\.(weight|bias)$", k)}


def load_vgg19(vgg: VGG19, gen: torch.Generator, checkpoints_dir: str) -> bool:
    """Load pretrained weights into `vgg` if a file is found (True), else give
    it the fallback init from `gen` and warn (False)."""
    path = find_vgg19_weights(checkpoints_dir)
    if path:
        vgg.load_state_dict(_state_from_file(path), strict=True)
        print(f"loaded pretrained VGG19 from {path}")
        return True
    warnings.warn(
        f"VGG19 weights not found (searched $MICHIGAN_VGG19, "
        f"{checkpoints_dir}/vgg19.npz, vgg19-dcbb9e9d.pth): training will "
        "run on a RANDOM VGG backbone — perceptual/style/content losses and "
        "FID are NOT comparable to the reference. Put torchvision's "
        f"vgg19-dcbb9e9d.pth at $MICHIGAN_VGG19 or in {checkpoints_dir}; it "
        "loads as it is, with no conversion.",
        stacklevel=2,
    )
    # kaiming fan_in keeps the activations' variance through conv + ReLU, so
    # the loss terms give real gradients without ImageNet weights
    with torch.no_grad():
        for conv in vgg.features.values():
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * math.sqrt(2.0 / fan_in))
            conv.bias.zero_()
    return False
