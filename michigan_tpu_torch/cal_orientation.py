"""Dense-orientation extraction CLI of the port (counterpart of
cal_orientation.py; reference cal_orientation.py).

    python -m michigan_tpu_torch.cal_orientation --image_path 56000.jpg \
        --hairmask_path 56000.png --orientation_root ./

Bulk mode processes a whole directory, masks matched to images by basename:

    python -m michigan_tpu_torch.cal_orientation --image_dir train_images \
        --hairmask_dir train_labels --orientation_root train_dense_orients

The DoG bank runs through the filterbank_orientation kernel (its plain
version on the CPU) and the flow is smoothed on the same device with a plain
torch Gaussian equal to cv2.GaussianBlur, so the computation needs neither
cv2 nor the host.  PIL reads and writes the files.  The device comes from
--gpu_ids as in the inference CLI: the card by default (an error when CUDA
is absent), -1 for the CPU.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from michigan_tpu_torch.inference import device_from_gpu_ids
from michigan_tpu_torch.ops.filters import dense_orientation


def gaussian_taps(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(n, sigma, CV_32F) with n = cvRound(sigma*8+1)|1,
    the size cv2.GaussianBlur(x, (0, 0), sigma) takes for float images: the
    taps in float32, normalised by their sum taken in float64."""
    n = int(round(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32)
    return (t.astype(np.float64) * (1.0 / t.astype(np.float64).sum())).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(x, (0, 0), sigma) of a float32 (H, W) map, both
    sides larger than the kernel's radius: separable, rows then columns,
    with cv2's default border BORDER_REFLECT_101 (torch's 'reflect')."""
    taps = torch.from_numpy(gaussian_taps(sigma)).to(x.device)
    n = taps.numel()
    r = n // 2
    y = F.pad(x.float()[None, None], (r, r, 0, 0), mode="reflect")
    y = F.conv2d(y, taps.view(1, 1, 1, n))
    y = F.pad(y, (0, 0, r, r), mode="reflect")
    return F.conv2d(y, taps.view(1, 1, n, 1))[0, 0]


def compute_orientation_map(image_rgb01: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The uint8 dense orientation map (cal_orientation.py:96-110), on the
    tensors' device.

    image_rgb01: (H,W,3) float in [0,1]; mask: (H,W) in {0,1}."""
    # normalise to [-1,1], then gray in [0,255] with the reference's weights
    img = image_rgb01.float() * 2.0 - 1.0
    fake = (img + 1.0) / 2.0 * 255.0
    gray = 0.299 * fake[..., 0] + 0.587 * fake[..., 1] + 0.144 * fake[..., 2]
    idx, conf = dense_orientation(gray[None, ..., None], mode="dog")
    idx, conf = idx[0, ..., 0], conf[0, ..., 0]

    # the reference decodes with pi/31*2 (cal_orientation.py:101), kept verbatim
    theta = idx * math.pi / 31.0 * 2.0
    m = mask.float()
    flow_x = gaussian_blur(torch.cos(theta) * conf * m, 4)
    flow_y = gaussian_blur(torch.sin(theta) * conf * m, 4)
    out = torch.atan2(flow_y, flow_x) * 0.5
    out = torch.where(out < 0, out + math.pi, out)
    return (out * 255.0 / math.pi * m).to(torch.uint8)


def _process_one(image_path: str, mask_path: str, out_root: str, device) -> str:
    from PIL import Image

    image = np.asarray(Image.open(image_path).convert("RGB"), np.float32) / 255.0
    mask = np.array(Image.open(mask_path))
    if mask.ndim == 3:
        mask = mask[..., 0]
    if mask.max() > 1:
        mask = (mask > 130) * 1
    orient = compute_orientation_map(torch.from_numpy(image).to(device),
                                     torch.from_numpy(mask.astype(np.float32)).to(device))
    name = os.path.splitext(os.path.basename(image_path))[0] + ".png"
    out_path = os.path.join(out_root, name)
    Image.fromarray(orient.cpu().numpy()).save(out_path)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", type=str, default="56000.jpg")
    parser.add_argument("--hairmask_path", type=str, default="56000.png")
    parser.add_argument("--orientation_root", type=str, default="./")
    parser.add_argument(
        "--image_dir", type=str, default=None,
        help="bulk mode: process every image here (overrides --image_path)",
    )
    parser.add_argument(
        "--hairmask_dir", type=str, default=None,
        help="bulk mode: masks matched to images by basename",
    )
    parser.add_argument("--gpu_ids", type=str, default="0",
                        help="the card's index; -1 for the CPU")
    args = parser.parse_args(argv)
    device = device_from_gpu_ids(args.gpu_ids)
    if device.type == "cuda":
        # cuDNN's fp32 convolutions (the Gaussian) default to TF32; keep full fp32
        torch.backends.cudnn.allow_tf32 = False

    os.makedirs(args.orientation_root, exist_ok=True)
    if args.image_dir is None:
        out_path = _process_one(args.image_path, args.hairmask_path,
                                args.orientation_root, device)
        print(f"saved {out_path}")
        return
    if args.hairmask_dir is None:
        parser.error("--image_dir requires --hairmask_dir")
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    names = sorted(n for n in os.listdir(args.image_dir) if n.lower().endswith(exts))
    done = skipped = 0
    for n in names:
        stem = os.path.splitext(n)[0]
        mask_path = None
        for ext in (".png", ".jpg", ".bmp"):
            cand = os.path.join(args.hairmask_dir, stem + ext)
            if os.path.exists(cand):
                mask_path = cand
                break
        if mask_path is None:
            print(f"no mask for {n}, skipped")
            skipped += 1
            continue
        _process_one(os.path.join(args.image_dir, n), mask_path, args.orientation_root,
                     device)
        done += 1
        if done % 50 == 0:
            print(f"{done}/{len(names)}", flush=True)
    print(f"saved {done} orientation maps to {args.orientation_root}"
          + (f" ({skipped} skipped)" if skipped else ""))


if __name__ == "__main__":
    main()
