"""Interactive-editing engine, headless (port of michigan_tpu/demo/engine.py;
reference demo.py:42-518 without the Qt shell).

An edit (demo.py:310-413): the user's mask or stroke -> hole dilation
(host) -> stroke -> orientation through the DoG bank (on the model's device,
the filterbank_orientation kernel on a card) -> the demo's inference
forward, ref- or stroke-mode inpainting -> the cropped uint8 result.  The
crop and the uint8 encode run on the device, and result and orientation
come back to the host in one copy.  Under --dtype bfloat16 the forward
runs the bf16 compute policy (model.py) and the encode reads its float32
fake.
"""

from __future__ import annotations

import math
import time
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from michigan_tpu_torch.ops.filters import NUM_KERNELS, dense_orientation
from michigan_tpu_torch.utils.imaging import tensor2im_u8

if TYPE_CHECKING:
    from PIL import Image


def parse_options(argv=None):
    """The demo's flags (sys.argv[1:] when `argv` is None) -> Options, by
    config.demo_options."""
    from michigan_tpu_torch.config import demo_options

    return demo_options(argv)


def engine_device(opt) -> torch.device:
    """The device --gpu_ids names (-1: the CPU; a card raises where CUDA is
    missing); on a card, cuDNN's float32 convolutions and matmuls without
    TF32, as every CLI of the port runs them."""
    from michigan_tpu_torch.inference import device_from_gpu_ids

    device = device_from_gpu_ids(opt.gpu_ids)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def stroke_to_orient(mask: torch.Tensor) -> torch.Tensor:
    """Binary stroke mask (H,W in {0,1}) -> RGB orientation image in
    [0,255], float32 (H,W,3), on the mask's device
    (ui_util/cal_orient_stroke.py:133-150): run the DoG bank on the mask
    itself, take the argmax angle, RGB-encode it with -1 outside the stroke."""
    m = mask.float()
    idx, _conf = dense_orientation(m[None, ..., None], mode="dog")
    theta = idx[0, ..., 0] * (math.pi / NUM_KERNELS)
    sin2, cos2 = torch.sin(2 * theta) * m, torch.cos(2 * theta) * m
    out_r = cos2 * m + (1 - m) * -1.0
    out_g = sin2 * m + (1 - m) * -1.0
    out_b = (1 - m) * -1.0
    rgb = torch.stack([out_r, out_g, out_b], dim=-1)
    return (rgb + 1.0) / 2.0 * 255.0


def orient_stroke_plane(mask_stroke: torch.Tensor, label_tag: torch.Tensor) -> torch.Tensor:
    """A batch's `orient_stroke` plane (1,3,H,W) made on the device from its
    `mask_stroke` (1,1,H,W): stroke_to_orient, truncated to uint8 levels
    and scaled to [0,1] within the hair, as demo_inference_data encodes the
    stroke image when it is already at crop size."""
    rgb = stroke_to_orient(mask_stroke[0, 0]).floor() / 255.0
    return rgb.permute(2, 0, 1)[None] * label_tag


@torch.no_grad()
def render_edit(model, batch, inpaint_mode: str = "ref") -> torch.Tensor:
    """An edit's forward and its display encode, on the model's device:
    (1, H, W, 3) uint8 result, stacked with the uint8 inpainted orientation
    when the IG ran, as (2, H, W, 3), so one copy brings both back."""
    opt = model.opt
    out, orient_rgb = model.infer(batch, inpaint_mode)
    if opt.add_feat_zeros:
        r = opt.add_th // 2
        out = out[:, :, r : r + opt.crop_size, r : r + opt.crop_size]
    img = tensor2im_u8(out)
    if orient_rgb is None:
        return img
    o8 = (orient_rgb.float() * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
    return torch.cat([img, o8], dim=0)


def select_tag_image(
    tag_img: Image.Image,
    recon_img: Optional[Image.Image],
    mask: np.ndarray,
    mask_m: np.ndarray,
    use_reference_mask: bool = False,
) -> Image.Image:
    """Reconstructed-tag selection (reference demo.py:330-333): when editing
    with a user mask (not the reference mask) that REMOVES hair pixels
    (1 appears in mask - mask_m), the reconstructed tag image from
    images_recon/ supplies the exposed background; otherwise the original
    tag image is used."""
    ranges = np.unique(mask.astype(np.int32) - mask_m.astype(np.int32))
    if not use_reference_mask and recon_img is not None and 1 in ranges:
        return recon_img.copy()
    return tag_img.copy()


def draw_stroke(label: np.ndarray) -> np.ndarray:
    """A scripted user stroke for headless runs: a line 6 px wide and 120
    rows long at slope 1/2 through the middle pixel of the hair (in raster
    order), cut to the hair.  (The JAX package's headless demo centres it on
    the hair's centroid, which can fall outside the hair and leave the
    stroke empty, as on sample 67172.)"""
    stroke = np.zeros_like(label, dtype=np.uint8)
    ys, xs = np.nonzero(label)
    if len(ys):
        cy, cx = int(ys[len(ys) // 2]), int(xs[len(ys) // 2])
        for d in range(-60, 60):
            y, x = cy + d, cx + d // 2
            if 0 <= y < stroke.shape[0] and 0 <= x < stroke.shape[1]:
                stroke[y, max(x - 3, 0) : x + 3] = 1
    return stroke * (label != 0)


def dilate_hole(stroke_mask: np.ndarray, k: int = 50) -> np.ndarray:
    """Hole = dilated stroke (demo.py:323-324, 50x50 ellipse)."""
    import cv2

    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    return cv2.dilate(stroke_mask.astype(np.uint8), kernel)


class DemoEngine:
    """One configuration's nets on one device, and the noise pyramid, drawn
    once from --seed (host cv2) and kept on the device.  Weights: the
    released files under checkpoints/<name>/ when present, else seeded by
    --init_type from --seed.  The device is the card unless the caller
    asks for the CPU."""

    def __init__(self, opt, device="cuda"):
        from michigan_tpu_torch.data.noise import generate_noise
        from michigan_tpu_torch.inference import load_released
        from michigan_tpu_torch.model import MichiGANModel

        self.opt = opt
        self.device = torch.device(device)
        self.model = MichiGANModel(opt, self.device)
        self.model.init_weights(opt.seed)
        load_released(self.model, opt)
        s = opt.crop_size
        noise = generate_noise(s, s, np.random.default_rng(opt.seed))[None]
        self.noise = torch.from_numpy(noise.astype(np.float32)).permute(0, 3, 1, 2) \
            .contiguous().to(self.device)
        self.last_timings = {}

    def edit(
        self,
        ref_label_path: str,
        tag_label: np.ndarray,
        mask_orient: np.ndarray,
        ref_orient: np.ndarray,
        ref_image: Image.Image,
        tag_image: Image.Image,
        orient_stroke: Optional[np.ndarray] = None,
        mask_stroke: Optional[np.ndarray] = None,
        mask_hole: Optional[np.ndarray] = None,
        inpaint_mode: str = "ref",
    ):
        """One interactive edit; returns (result uint8 HxWx3, inpainted
        orientation uint8 HxWx3 or None, latency in seconds) like the demo's
        timing print (demo.py:363-366), and sets `last_timings`."""
        from michigan_tpu_torch.data.single import demo_inference_data
        from michigan_tpu_torch.model import batch_from_numpy

        t_start = time.perf_counter()
        data = demo_inference_data(
            self.opt, ref_label_path, tag_label, mask_orient, ref_orient,
            ref_image, tag_image, orient_stroke, mask_stroke, mask_hole,
            noise=np.zeros((1,), np.float32),  # placeholder: self.noise is used
        )
        t_host = time.perf_counter()
        batch = batch_from_numpy(data, self.device)
        batch["noise"] = self.noise
        t_h2d = time.perf_counter()
        arr = render_edit(self.model, batch, inpaint_mode).cpu().numpy()  # one copy back
        t_end = time.perf_counter()
        latency = t_end - t_h2d
        print(f"inference time: {latency:.3f}s")
        # host_prep: host planes; h2d_submit: tensors to the device;
        # device_and_d2h: forward, encode and the copy back, which waits
        # for the device
        self.last_timings = {
            "host_prep_s": t_host - t_start,
            "h2d_submit_s": t_h2d - t_host,
            "device_and_d2h_s": t_end - t_h2d,
            "total_s": t_end - t_start,
        }
        return arr[0], (arr[1] if arr.shape[0] > 1 else None), latency
