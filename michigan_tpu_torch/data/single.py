"""Single-sample and demo loaders (copies of michigan_tpu/data/single.py:
single_inference_data and demo_inference_data; reference
base_dataset.py:49-276), NHWC numpy.

Return the arrays the JAX package's functions return, equal under the same
--seed, with a leading batch dim of 1.
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


def demo_inference_data(
    opt, ref_label_path: str, tag_label: np.ndarray, mask_orient: np.ndarray,
    ref_orient: np.ndarray, ref_image: Image.Image, tag_image: Image.Image,
    orient_stroke: Optional[np.ndarray] = None,
    mask_stroke: Optional[np.ndarray] = None,
    mask_hole: Optional[np.ndarray] = None,
    noise: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Reference demo_inference_dataLoad (base_dataset.py:162-276): one
    interactive edit's planes from the opened files and the user's masks.

    `noise` lets an interactive caller reuse one seeded pyramid across edits
    (a pure function of --seed and crop_size).  Unlike the JAX package's
    copy this keeps no memo of the opened files' planes: every call
    computes every plane."""
    label_ref = Image.open(ref_label_path)
    label_tag = Image.fromarray(np.uint8(tag_label))
    orient_mask = Image.fromarray(np.uint8(mask_orient))
    orient_ref = Image.fromarray(np.uint8(ref_orient))

    params = get_params(opt, label_ref.size)
    tl = get_transform(opt, params, method=Image.NEAREST, normalize=False)
    label_ref_t = _label_tensor(tl, label_ref, opt.label_nc)
    if opt.expand_tag_mask:
        label_tag = _dilate_pil(label_tag, 25)
    label_tag_t = _label_tensor(tl, label_tag, opt.label_nc)
    orient_mask_t = _label_tensor(tl, orient_mask, opt.label_nc)

    rgb = trans_orient_to_rgb(
        np.array(orient_ref), np.array(label_tag), np.array(orient_mask)
    )
    orient_rgb_t = tl(rgb)[None] * label_tag_t
    orient_rgb_mask = orient_mask_t * label_tag_t

    if mask_hole is None:
        hole_t = label_tag_t - orient_mask_t * label_tag_t
    else:
        hole_t = _label_tensor(tl, Image.fromarray(np.uint8(mask_hole)), opt.label_nc)
        hole_t = hole_t * label_tag_t

    if orient_stroke is not None:
        stroke_t = tl(Image.fromarray(np.uint8(orient_stroke)))[None] * label_tag_t
    else:
        stroke_t = np.zeros_like(orient_rgb_t)
    if mask_stroke is not None:
        mask_stroke_t = (
            tl(Image.fromarray(np.uint8(mask_stroke)))[None] * 255.0 * label_tag_t
        )
    else:
        mask_stroke_t = np.zeros_like(label_tag_t)

    if noise is None:
        noise = generate_noise(
            opt.crop_size, opt.crop_size, np.random.default_rng(opt.seed)
        )[None]
    ti = get_transform(opt, params, color=opt.color_jitter)
    image_ref_t = ti(ref_image.convert("RGB"))[None]
    image_tag_t = get_transform(opt, params)(tag_image.convert("RGB"))[None]
    orient_t = tl(orient_ref)[None] * 255.0

    return {
        "label_ref": label_ref_t.astype(np.float32),
        "label_tag": label_tag_t.astype(np.float32),
        "instance": np.zeros((1,), np.float32),
        "image_ref": image_ref_t.astype(np.float32),
        "image_tag": image_tag_t.astype(np.float32),
        "path": None,
        "orient": orient_t.astype(np.float32),
        "hole": hole_t.astype(np.float32),
        "orient_rgb": orient_rgb_t.astype(np.float32),
        "orient_rgb_mask": orient_rgb_mask.astype(np.float32),
        "noise": noise.astype(np.float32),
        "orient_stroke": stroke_t.astype(np.float32),
        "mask_stroke": mask_stroke_t.astype(np.float32),
    }
