"""Single-sample loader (copy of michigan_tpu/data/single.py:
single_inference_data; reference base_dataset.py:49-160), NHWC numpy.

Returns the arrays ``michigan_tpu.data.single_inference_data`` returns,
equal under the same --seed, with a leading batch dim of 1.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional

import numpy as np
from PIL import Image

from michigan_tpu_torch.data.noise import generate_noise
from michigan_tpu_torch.data.preprocess import generate_hole, pad_zeros, trans_orient_to_rgb
from michigan_tpu_torch.data.transforms import get_params, get_transform


def _dilate_pil(img: Image.Image, k: int) -> Image.Image:
    import cv2

    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (k, k))
    return Image.fromarray(np.uint8(cv2.dilate(np.array(img), kernel))).convert("L")


def _label_tensor(transform_label, img: Image.Image, label_nc: int) -> np.ndarray:
    t = transform_label(img) * 255.0
    t[t == 255] = label_nc
    return t[None]  # (1,H,W,1)


def single_inference_data(opt, noise: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    base, sub = opt.data_dir, opt.subset
    p = lambda kind, name, ext: os.path.join(base, f"{sub}_{kind}", name + ext)
    label_ref = Image.open(p("labels", opt.inference_ref_name, ".png"))
    label_tag = Image.open(p("labels", opt.inference_tag_name, ".png"))
    orient_mask = Image.open(p("labels", opt.inference_orient_name, ".png"))
    orient_tag = Image.open(p("dense_orients", opt.inference_tag_name + "_orient_dense", ".png"))
    orient_ref = Image.open(p("dense_orients", opt.inference_orient_name + "_orient_dense", ".png"))
    image_ref = Image.open(p("images", opt.inference_ref_name, ".jpg"))
    image_tag = Image.open(p("images", opt.inference_tag_name, ".jpg"))

    if opt.add_zeros:
        padf = lambda im: pad_zeros(im, opt.add_th)
        label_ref, label_tag = padf(label_ref), padf(label_tag)
        orient_mask, orient_tag, orient_ref = padf(orient_mask), padf(orient_tag), padf(orient_ref)
        image_ref, image_tag = padf(image_ref), padf(image_tag)

    params = get_params(opt, label_ref.size)
    tl = get_transform(opt, params, method=Image.NEAREST, normalize=False)
    label_ref_t = _label_tensor(tl, label_ref, opt.label_nc)

    if opt.expand_tag_mask:
        label_tag = _dilate_pil(label_tag, 25)
    label_tag_t = _label_tensor(tl, label_tag, opt.label_nc)
    orient_mask_t = _label_tensor(tl, orient_mask, opt.label_nc)

    if opt.use_ig and not opt.no_orientation:
        rgb = trans_orient_to_rgb(
            np.array(orient_ref), np.array(label_tag), np.array(orient_mask)
        )
        orient_rgb_t = tl(rgb)[None] * label_tag_t
    else:
        orient_rgb_t = np.zeros_like(np.repeat(label_tag_t, 3, axis=-1))

    if opt.use_ig:
        if opt.inference_orient_name == opt.inference_tag_name:
            hole = generate_hole(
                np.array(label_tag), np.array(orient_mask), random.Random(opt.seed)
            )
            hole_t = tl(hole)[None] * 255.0
        else:
            hole_t = label_tag_t - orient_mask_t * label_tag_t
    else:
        hole_t = np.zeros_like(label_tag_t)

    if noise is None:
        noise = generate_noise(
            opt.crop_size, opt.crop_size, np.random.default_rng(opt.seed)
        )[None]

    ti = get_transform(opt, params, color=opt.color_jitter)
    image_ref_t = ti(image_ref.convert("RGB"))[None]
    image_tag_t = get_transform(opt, params)(image_tag.convert("RGB"))[None]
    orient_t = tl(orient_tag)[None] * 255.0

    return {
        "label_ref": label_ref_t.astype(np.float32),
        "label_tag": label_tag_t.astype(np.float32),
        "instance": np.zeros((1,), np.float32),
        "image_ref": image_ref_t.astype(np.float32),
        "image_tag": image_tag_t.astype(np.float32),
        "path": p("images", opt.inference_tag_name, ".jpg"),
        "orient": orient_t.astype(np.float32),
        "hole": hole_t.astype(np.float32),
        "orient_rgb": orient_rgb_t.astype(np.float32),
        "noise": noise.astype(np.float32),
    }
