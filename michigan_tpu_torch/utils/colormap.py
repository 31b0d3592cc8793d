"""Label colorization (the port's copy of michigan_tpu/utils/colormap.py;
reference util/util.py:293-353 + util/coco.py).

labelcolormap(N) builds the pix2pixHD bit-interleaved palette; Colorize maps
an integer label image to RGB with it.  The 35-class variant carries the
Cityscapes colors like the reference's hardcoded table.
"""

from __future__ import annotations

import numpy as np

_CITYSCAPES_35 = np.array(
    [
        (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (111, 74, 0),
        (81, 0, 81), (128, 64, 128), (244, 35, 232), (250, 170, 160),
        (230, 150, 140), (70, 70, 70), (102, 102, 156), (190, 153, 153),
        (180, 165, 180), (150, 100, 100), (150, 120, 90), (153, 153, 153),
        (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35),
        (152, 251, 152), (70, 130, 180), (220, 20, 60), (255, 0, 0),
        (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90), (0, 0, 110),
        (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142),
    ],
    dtype=np.uint8,
)

# COCO-stuff (N=182) perceptual overrides (util/util.py:320-328): palette
# row i is overridden when id2label(i) names one of these categories.
_IMPORTANT_COLORS = {
    "sea": (54, 62, 167),
    "sky-other": (95, 219, 255),
    "tree": (140, 104, 47),
    "clouds": (170, 170, 170),
    "grass": (29, 195, 49),
}


def _coco_overrides() -> dict:
    from michigan_tpu_torch.utils.coco import id2label

    return {
        i: _IMPORTANT_COLORS[id2label(i)]
        for i in range(182)
        if id2label(i) in _IMPORTANT_COLORS
    }


def _bitget(byteval: int, idx: int) -> int:
    return (byteval & (1 << idx)) != 0


def labelcolormap(n: int) -> np.ndarray:
    """(n, 3) uint8 palette (util/util.py:293-326)."""
    if n == 35:
        return _CITYSCAPES_35.copy()
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i + 1
        for j in range(8):
            r = r | (_bitget(c, 0) << (7 - j))
            g = g | (_bitget(c, 1) << (7 - j))
            b = b | (_bitget(c, 2) << (7 - j))
            c = c >> 3
        cmap[i] = (r, g, b)
    if n == 182:  # COCO-stuff overrides (util/util.py:320-328)
        for i, color in _coco_overrides().items():
            cmap[i] = color
    return cmap


class Colorize:
    """Integer label (H,W) -> uint8 RGB (H,W,3) (util/util.py:329-353)."""

    def __init__(self, n: int = 35):
        self.cmap = labelcolormap(n)

    def __call__(self, label: np.ndarray) -> np.ndarray:
        lab = np.asarray(label).astype(np.int64)
        if lab.ndim == 3:
            lab = lab[..., 0]
        lab = np.clip(lab, 0, len(self.cmap) - 1)
        return self.cmap[lab]
