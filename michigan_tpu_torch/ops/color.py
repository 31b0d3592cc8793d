"""RGB -> Lab as the reference computes it (port of michigan_tpu/ops/color.py,
loss.py:439-482), NCHW: sRGB -> XYZ by the matrix M, XYZ divided by the row
sums of M (the D65 white point), then the CIE f() curve."""

from __future__ import annotations

import torch

_M = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def _f(t: torch.Tensor) -> torch.Tensor:
    # the cube root only where it is taken: its derivative is infinite at 0,
    # and a where() would send inf * 0 = NaN through the other branch
    pred = t > 0.008856
    safe = torch.where(pred, t, torch.ones_like(t))
    return torch.where(pred, safe.pow(1.0 / 3.0), 7.787 * t + 0.137931)


def rgb_to_lab(rgb01: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) RGB in [0, 1] -> (N, 3, H, W) Lab."""
    r, g, b = rgb01[:, 0], rgb01[:, 1], rgb01[:, 2]
    x, y, z = ((m[0] * r + m[1] * g + m[2] * b) / sum(m) for m in _M)
    fx, fy, fz = _f(x), _f(y), _f(z)
    light = torch.where(y > 0.008856, 116.0 * fy - 16.0, 903.3 * y)
    return torch.stack([light, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=1)
