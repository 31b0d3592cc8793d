"""The port's demo (counterpart of demo.py): the Qt editor, or a headless
scripted edit (reference demo.py).

    python -m michigan_tpu_torch.demo --demo_data_dir ./datasets/FFHQ_demo [--gpu_ids 0]

starts the editor (michigan_tpu_torch/demo/qt_ui.py) when PyQt5 imports and
MICHIGAN_HEADLESS is not 1; otherwise it runs the headless edit:

    python -m michigan_tpu_torch.demo --demo_data_dir ./datasets/FFHQ_demo \
        --tag_name 67172 --ref_name 59144 [--stroke | --erase] [--gpu_ids 0]

The demo's options (the port's config.demo_options) and flags; the device
comes from --gpu_ids as in the inference CLI (-1 is the CPU).  --stroke
draws a stroke through the hair and inpaints it through SIG; --erase removes
the top of the hair mask, so the reconstructed tag image supplies the
background; with neither, the edit transfers the ref image's appearance in
ref mode.  Writes --out.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _load_demo_sample(demo_dir: str, name: str):
    from PIL import Image

    img = Image.open(os.path.join(demo_dir, "images", name + ".jpg"))
    label = np.array(Image.open(os.path.join(demo_dir, "labels", name + ".png")))
    orient = np.array(
        Image.open(os.path.join(demo_dir, "orients", name + "_orient_dense.png"))
    )
    # reconstructed tag (hair removed), used when a mask edit exposes
    # background (reference demo.py:137-142)
    recon_path = os.path.join(demo_dir, "images_recon", name + ".jpg")
    recon = Image.open(recon_path) if os.path.exists(recon_path) else None
    return img, label, orient, recon


def run_headless(argv=None):
    """The scripted edit (demo.py run_headless)."""
    from PIL import Image

    from michigan_tpu_torch.demo.engine import (
        DemoEngine,
        dilate_hole,
        draw_stroke,
        engine_device,
        parse_options,
        select_tag_image,
        stroke_to_orient,
    )

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--tag_name", type=str, default="67172")
    parser.add_argument("--ref_name", type=str, default="59144")
    parser.add_argument("--stroke", action="store_true",
                        help="exercise the stroke-inpainting (SIG) path")
    parser.add_argument("--erase", action="store_true",
                        help="edit that removes hair: exercises the "
                             "reconstructed-tag (images_recon) selection")
    parser.add_argument("--out", type=str, default="./inference_samples/demo_edit.jpg")
    args, rest = parser.parse_known_args(argv)

    opt = parse_options(rest)
    device = engine_device(opt)
    engine = DemoEngine(opt, device)

    demo_dir = opt.demo_data_dir
    tag_img, tag_label, tag_orient, tag_recon = _load_demo_sample(demo_dir, args.tag_name)
    ref_img, _ref_label, _ref_orient, _ = _load_demo_sample(demo_dir, args.ref_name)
    ref_label_path = os.path.join(demo_dir, "labels", args.ref_name + ".png")

    if args.erase:
        # user edit that removes the top of the hair mask: the exposed
        # region must come from the reconstructed tag (demo.py:330-333)
        mask_m = tag_label.copy()
        ys, _xs = np.nonzero(tag_label)
        if len(ys):
            mask_m[: int(np.percentile(ys, 30))] = 0
        tag_for_edit = select_tag_image(tag_img, tag_recon, tag_label, mask_m)
        result, _orient, latency = engine.edit(
            ref_label_path, mask_m, mask_m, tag_orient, ref_img, tag_for_edit,
            inpaint_mode="ref",
        )
    elif args.stroke:
        stroke = draw_stroke(tag_label)
        hole = dilate_hole(stroke, 50) * tag_label
        # the DoG bank runs on the engine's device
        orient_stroke = stroke_to_orient(torch.from_numpy(stroke).to(device)).cpu().numpy()
        result, _orient, latency = engine.edit(
            ref_label_path, tag_label, tag_label * (1 - hole), tag_orient,
            ref_img, tag_img, orient_stroke=orient_stroke, mask_stroke=stroke,
            mask_hole=hole, inpaint_mode="stroke",
        )
    else:
        # appearance transfer: tag shape + ref appearance, ref-mode inpaint
        result, _orient, latency = engine.edit(
            ref_label_path, tag_label, tag_label, tag_orient, ref_img, tag_img,
            inpaint_mode="ref",
        )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    Image.fromarray(result).save(args.out)
    print(f"saved {args.out} (latency {latency:.3f}s)")


def run_qt(argv=None):
    """The Qt editor (reference demo.py's Ex widget); needs PyQt5."""
    from michigan_tpu_torch.demo.qt_ui import launch

    launch(argv)


def main(argv=None):
    try:
        import PyQt5  # noqa: F401

        has_qt = True
    except ImportError:
        has_qt = False
    if has_qt and os.environ.get("MICHIGAN_HEADLESS", "0") != "1":
        run_qt(argv)
    else:
        if not has_qt:
            print("PyQt5 not available — running headless scripted demo")
        run_headless(argv)


if __name__ == "__main__":
    main()
