"""How a training loss reduces over the pixels of its planes.

One process holds every plane whole (``WHOLE``).  A rank of a spatial group
holds one band of rows of each (parallel/spatial.py ``Bands``, which has
the same methods) and writes each term as its share of the one process's:
the ranks' shares add up to the one process's term.  The loss functions and
``MichiGANModel``'s G and D losses take one of the two as ``red``; they are
written once, for both.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from michigan_tpu_torch.ops.cuda.orient import OrientationResponse


def mean_std(feat: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """calc_mean_std: per-(N, C) mean and sqrt(unbiased var + eps), as
    torch's .var() is unbiased."""
    f = feat.float().flatten(2)
    var, mean = torch.var_mean(f, dim=2, unbiased=True)
    return mean, torch.sqrt(var + eps)


class WholePlane:
    """The reductions on one process, every plane whole."""

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """t.mean() over the whole plane (a band: its share)."""
        return t.mean()

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """t.sum() over the whole plane, the same on every rank (a label's
        count: no gradient crosses ranks)."""
        return t.sum()

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """A term computed on whole planes, alike on every rank (a band:
        its share, t / P)."""
        return t

    def mean_std(self, feats: List[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``mean_std`` of each of `feats` over its whole plane."""
        return [mean_std(f) for f in feats]

    def vgg(self, net, x: torch.Tensor) -> List[torch.Tensor]:
        """VGG19's five slices of x."""
        return net(x)

    def orientation_response(self, gray: torch.Tensor, bank: torch.Tensor,
                             bf16_operands: bool = False):
        """``OrientationResponse`` of the (N, 1, H, W) gray plane: (argmax,
        max response), (N, H, W) each."""
        return OrientationResponse.apply(gray, bank, bf16_operands)


WHOLE = WholePlane()
