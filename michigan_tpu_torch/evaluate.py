"""Evaluation of the port (counterpart of evaluate.py): PSNR, and FID over a
validation list.

    python -m michigan_tpu_torch.evaluate psnr --a out.jpg --b ref.jpg
    python -m michigan_tpu_torch.evaluate fid --real_dir ... --fake_dir ... \
        [--val_list list.txt] [--extractor vgg|inception] [--gpu_ids 0|-1]

FID is ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) over pooled deep
features: InceptionV3 pool3 (``models/inception.py``, the standard
extractor) or VGG19's relu4_1, mean-pooled (``models/vgg.py``; relative
progress between checkpoints of this framework).  Without the extractor's
weights the backbone is random, and the FID line says so.  The features
run on the card unless --gpu_ids -1, as the inference CLI's device.
Reading the images needs PIL; ``extract_features`` and ``frechet_distance``
take arrays.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak**2 / mse)


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading images for evaluation needs PIL (Pillow); "
                          "extract_features and frechet_distance take arrays") from e
    return Image


def _load_images(directory: str, names=None, size=299) -> np.ndarray:
    """The .jpg / .png images of `directory` (those of `names` when given),
    bilinear-resized to size^2, NHWC float32 in [-1, 1]."""
    Image = _pil()
    files = sorted(f for f in os.listdir(directory) if f.lower().endswith((".jpg", ".png")))
    if names is not None:
        keep = set(names)
        files = [f for f in files if os.path.splitext(f)[0] in keep]
    out = []
    for f in files:
        img = Image.open(os.path.join(directory, f)).convert("RGB")
        img = img.resize((size, size), Image.BILINEAR)
        out.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    return np.stack(out) if out else np.zeros((0, size, size, 3), np.float32)


class _VGGRelu41(torch.nn.Module):
    def __init__(self, vgg):
        super().__init__()
        self.vgg = vgg

    def forward(self, x):  # NHWC -> relu4_1 mean-pooled
        return self.vgg(x.permute(0, 3, 1, 2).contiguous())[-2].mean(dim=(2, 3))


def _extractor(name: str, device, checkpoints_dir: str):
    """(net taking NHWC in [-1, 1], pretrained, feature width)."""
    gen = torch.Generator().manual_seed(0)
    if name == "inception":
        from michigan_tpu_torch.models.inception import (
            FEATURE_DIM,
            InceptionV3,
            load_inception_params,
        )

        net = InceptionV3()
        pretrained = load_inception_params(net, gen, checkpoints_dir, context="FID")
        return net.to(device).eval(), pretrained, FEATURE_DIM
    if name == "vgg":
        from michigan_tpu_torch.models.vgg import VGG19, load_vgg19

        vgg = VGG19()
        pretrained = load_vgg19(vgg, gen, checkpoints_dir)
        return _VGGRelu41(vgg).to(device).eval(), pretrained, 512
    raise ValueError(f"unknown FID extractor {name!r}")


def extract_features(images: np.ndarray, extractor: str = "vgg", batch: int = 8,
                     device="cpu", checkpoints_dir: str = "./checkpoints") -> np.ndarray:
    """(N, D) float32 features of NHWC images in [-1, 1], in chunks of
    `batch`.  After a call, ``extract_features.last_pretrained`` says
    whether the backbone had real weights: an FID on a random backbone
    measures relative progress only and must say so."""
    net, pretrained, dim = _extractor(extractor, torch.device(device), checkpoints_dir)
    extract_features.last_pretrained = pretrained
    if not pretrained:
        print(f"WARNING: FID is computed on a RANDOM {extractor} backbone — the numbers are "
              "NOT comparable to published FID or to the reference's.")
    chunks = []
    with torch.no_grad():
        for i in range(0, len(images), batch):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch], np.float32))
            chunks.append(net(x.to(device)).float().cpu().numpy())
    return np.concatenate(chunks) if chunks else np.zeros((0, dim), np.float32)


extract_features.last_pretrained = False


def frechet_distance(f1: np.ndarray, f2: np.ndarray, eps: float = 1e-6) -> float:
    """FID between two feature sets, with a ridge of `eps` on both
    covariances (stable below the feature width's sample count)."""
    from scipy import linalg

    if len(f1) < 2 or len(f2) < 2:
        # np.cov of one observation is a scalar nan
        raise ValueError(f"FID needs >=2 images per side, got {len(f1)}/{len(f2)}")
    mu1, mu2 = f1.mean(0), f2.mean(0)
    c1 = np.cov(f1, rowvar=False)
    c2 = np.cov(f2, rowvar=False)
    ridge = eps * np.eye(c1.shape[0])
    c1 = c1 + ridge
    c2 = c2 + ridge
    covmean = linalg.sqrtm(c1 @ c2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(((mu1 - mu2) ** 2).sum() + np.trace(c1 + c2 - 2 * covmean))


def main(argv=None):
    from michigan_tpu_torch.inference import device_from_gpu_ids

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("psnr")
    p1.add_argument("--a", required=True)
    p1.add_argument("--b", required=True)
    p2 = sub.add_parser("fid")
    p2.add_argument("--real_dir", required=True)
    p2.add_argument("--fake_dir", required=True)
    p2.add_argument("--val_list", default=None)
    p2.add_argument("--extractor", default="vgg", choices=["vgg", "inception"])
    p2.add_argument("--gpu_ids", default="0", help="the card's id, or -1 for the CPU")
    p2.add_argument("--checkpoints_dir", default="./checkpoints")
    args = parser.parse_args(argv)

    if args.cmd == "psnr":
        Image = _pil()
        a = np.asarray(Image.open(args.a).convert("RGB"))
        b = np.asarray(Image.open(args.b).convert("RGB"))
        val = psnr(a, b)
        print(f"PSNR: {val:.2f} dB")
        return val

    device = device_from_gpu_ids(args.gpu_ids)
    names = None
    if args.val_list and os.path.exists(args.val_list):
        with open(args.val_list) as f:
            names = [line.strip() for line in f if line.strip()]
    real = _load_images(args.real_dir, names)
    fake = _load_images(args.fake_dir, names)
    if not len(real) or not len(fake):
        raise SystemExit(f"no images found: {len(real)} in {args.real_dir}, "
                         f"{len(fake)} in {args.fake_dir}")
    kw = dict(extractor=args.extractor, device=device, checkpoints_dir=args.checkpoints_dir)
    fid = frechet_distance(extract_features(real, **kw), extract_features(fake, **kw))
    tag = "InceptionV3-pool3" if args.extractor == "inception" else "VGG-feature variant"
    if not extract_features.last_pretrained:
        tag += ", RANDOM backbone — relative-progress only"
    print(f"FID ({tag}): {fid:.3f} over {len(real)}/{len(fake)} images")
    return fid


if __name__ == "__main__":
    main()
