"""Image preprocessing matching the reference's torchvision pipeline (copy of
the parts of michigan_tpu/data/transforms.py that single-image inference
uses; reference base_dataset.py:398-505).  PIL -> (H,W,C) float32 numpy;
images normalised to [-1,1], labels left in [0,1]."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance


@dataclass
class TransformSpec:
    crop_pos: Tuple[int, int]
    flip: bool


def get_params(opt, size: Tuple[int, int], rng: Optional[random.Random] = None) -> TransformSpec:
    """Random crop position + flip decision."""
    r = rng or random
    w, h = size
    new_w, new_h = w, h
    if opt.preprocess_mode == "resize_and_crop":
        new_h = new_w = opt.load_size
    elif opt.preprocess_mode == "scale_width_and_crop":
        new_w = opt.load_size
        new_h = opt.load_size * h // w
    elif opt.preprocess_mode == "scale_shortside_and_crop":
        ss, ls = min(w, h), max(w, h)
        ls = int(opt.load_size * ls / ss)
        new_w, new_h = (ss, ls) if w == ss else (ls, ss)
    x = r.randint(0, max(0, new_w - opt.crop_size))
    y = r.randint(0, max(0, new_h - opt.crop_size))
    flip = r.random() > 0.5
    return TransformSpec((x, y), flip)


def _scale_width(img: Image.Image, target: int, method) -> Image.Image:
    ow, oh = img.size
    if ow == target:
        return img
    return img.resize((target, int(target * oh / ow)), method)


def _scale_shortside(img: Image.Image, target: int, method) -> Image.Image:
    ow, oh = img.size
    ss, ls = min(ow, oh), max(ow, oh)
    if ss == target:
        return img
    ls = int(target * ls / ss)
    nw, nh = (ss, ls) if ow == ss else (ls, ss)
    return img.resize((nw, nh), method)


# torchvision ColorJitter(brightness=0.1, contrast=0.01, saturation=0.01, hue=0.01)
JITTER_BRIGHTNESS = 0.1
JITTER_CONTRAST = 0.01
JITTER_SATURATION = 0.01
JITTER_HUE = 0.01


def _adjust_hue(img: Image.Image, factor: float) -> Image.Image:
    """torchvision F.adjust_hue on PIL: shift the HSV hue channel by
    factor*255 with uint8 wraparound."""
    if img.mode in ("L", "1", "I", "F"):
        return img
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    np_h = ((np_h.astype(np.int32) + int(round(factor * 255.0))) % 256).astype(np.uint8)
    return Image.merge("HSV", (Image.fromarray(np_h, "L"), s, v)).convert(img.mode)


def color_jitter(img: Image.Image, r: random.Random) -> Image.Image:
    """torchvision ColorJitter at the reference's strengths, randomly ordered."""
    ops = [
        ("brightness", r.uniform(1 - JITTER_BRIGHTNESS, 1 + JITTER_BRIGHTNESS)),
        ("contrast", r.uniform(1 - JITTER_CONTRAST, 1 + JITTER_CONTRAST)),
        ("saturation", r.uniform(1 - JITTER_SATURATION, 1 + JITTER_SATURATION)),
        ("hue", r.uniform(-JITTER_HUE, JITTER_HUE)),
    ]
    r.shuffle(ops)
    for name, f in ops:
        if name == "brightness":
            img = ImageEnhance.Brightness(img).enhance(f)
        elif name == "contrast":
            img = ImageEnhance.Contrast(img).enhance(f)
        elif name == "saturation":
            img = ImageEnhance.Color(img).enhance(f)
        else:
            img = _adjust_hue(img, f)
    return img


def pre_geometry(img: Image.Image, opt, method) -> Image.Image:
    """The parameter-independent scaling stage."""
    if "resize" in opt.preprocess_mode:
        if img.size != (opt.load_size, opt.load_size):
            return img.resize((opt.load_size, opt.load_size), method)
        return img
    if "scale_width" in opt.preprocess_mode:
        return _scale_width(img, opt.load_size, method)
    if "scale_shortside" in opt.preprocess_mode:
        return _scale_shortside(img, opt.load_size, method)
    return img


def get_transform(opt, params: TransformSpec, method=Image.BICUBIC,
                  normalize: bool = True, color: bool = False):
    """PIL -> (H,W,C) float32 ndarray closure."""

    def apply(img: Image.Image) -> np.ndarray:
        x = pre_geometry(img, opt, method)
        if "crop" in opt.preprocess_mode:
            cx, cy = params.crop_pos
            x = x.crop((cx, cy, cx + opt.crop_size, cy + opt.crop_size))
        if opt.preprocess_mode == "none":
            ow, oh = x.size
            nw, nh = int(round(ow / 32) * 32), int(round(oh / 32) * 32)
            if (nw, nh) != (ow, oh):
                x = x.resize((nw, nh), method)
        if opt.preprocess_mode == "fixed":
            w = opt.crop_size
            h = round(opt.crop_size / opt.aspect_ratio)
            x = x.resize((w, h), method)
        if opt.isTrain and not opt.no_flip and params.flip:
            x = x.transpose(Image.FLIP_LEFT_RIGHT)
        if color:
            x = color_jitter(x, random)
        arr = np.asarray(x, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if normalize:
            # bit-identical to ToTensor + Normalize(0.5, 0.5)
            return arr / np.float32(127.5) - np.float32(1.0)
        return arr / np.float32(255.0)  # torchvision ToTensor

    return apply
