"""Loss logging and the HTML image gallery (the port's copy of
michigan_tpu/utils/visualizer.py; reference util/visualizer.py, html.py).

The console and an append-only loss_log.txt, a scalars.jsonl stream of
every printed loss and diagnostic, and a self-contained static gallery
under checkpoints/<name>/web/ (no external package: the reference used
`dominate`).  --tf_log also writes TensorBoard summaries; it imports
torch.utils.tensorboard only then, and raises naming the flag where the
tensorboard package is not installed.  Images are written with PIL, so a
machine without it passes --no_html."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from michigan_tpu_torch.utils.imaging import save_image, tensor2im, tensor2label


class HTMLGallery:
    """Minimal static gallery writer (reference util/html.py)."""

    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.refresh = refresh
        self.rows = []
        os.makedirs(self.img_dir, exist_ok=True)

    def add_images(self, ims, txts, links, width=512):
        self.rows.append((ims, txts, links, width))

    def save(self):
        parts = ["<!DOCTYPE html><html><head>"]
        if self.refresh:
            parts.append(f'<meta http-equiv="refresh" content="{self.refresh}">')
        parts.append(f"<title>{self.title}</title></head><body>")
        for ims, txts, links, width in self.rows:
            parts.append("<table border='1'><tr>")
            for im, txt, link in zip(ims, txts, links):
                parts.append(
                    f"<td align='center'><a href='images/{link}'>"
                    f"<img src='images/{im}' width='{width}'></a><br>{txt}</td>"
                )
            parts.append("</tr></table>")
        parts.append("</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write("".join(parts))


def summary_writer(log_dir: str):
    """torch.utils.tensorboard's SummaryWriter for --tf_log."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError("--tf_log needs the tensorboard package, which is not "
                          "installed") from e
    return SummaryWriter(log_dir=log_dir)


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.win_size = opt.display_winsize
        self.name = opt.name
        self.log_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_name = os.path.join(self.log_dir, "loss_log.txt")
        self.scalar_log = os.path.join(self.log_dir, "scalars.jsonl")
        self.use_html = opt.isTrain and not opt.no_html
        if self.use_html:
            self.web_dir = os.path.join(self.log_dir, "web")
            os.makedirs(os.path.join(self.web_dir, "images"), exist_ok=True)
        # --tf_log: TensorBoard scalars and images (the reference's TF-1
        # writer, util/visualizer.py:24-28,47-65); the JSONL stream stays on
        self.tf_writer = summary_writer(os.path.join(self.log_dir, "logs")) \
            if opt.tf_log else None
        with open(self.log_name, "a") as f:
            now = time.strftime("%c")
            f.write(f"================ Training Loss ({now}) ================\n")

    def print_current_errors(self, epoch: int, i: int, errors: Dict, t: float):
        message = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) "
        for k, v in errors.items():
            message += f"{k}: {float(np.mean(np.asarray(v))):.3f} "
        print(message)
        with open(self.log_name, "a") as f:
            f.write(message + "\n")

    def plot_current_errors(self, errors: Dict, step: int):
        """One JSON object of scalars a call (scalars.jsonl); with --tf_log
        the same scalars go to TensorBoard."""
        rec = {"step": int(step)}
        rec.update({k: float(np.mean(np.asarray(v))) for k, v in errors.items()})
        with open(self.scalar_log, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tf_writer is not None:
            for k, v in rec.items():
                if k != "step":
                    self.tf_writer.add_scalar(k, v, global_step=int(step))
            self.tf_writer.flush()

    def display_current_results(self, visuals: Dict, epoch: int, step: int):
        """`visuals`: {label: (H,W,C) numpy image}; label maps (a label
        containing "label" or "input") through tensor2label, images through
        tensor2im."""
        if not self.use_html and self.tf_writer is None:
            return
        ims, txts, links = [], [], []
        for label, image in visuals.items():
            arr = np.asarray(image)
            if "label" in label or "input" in label:
                img = tensor2label(arr, self.opt.label_nc + 2)
            else:
                img = tensor2im(arr)
            if self.tf_writer is not None:
                self.tf_writer.add_image(
                    label, img, global_step=int(step),
                    dataformats="HWC" if img.ndim == 3 else "HW",
                )
            if not self.use_html:
                continue
            name = f"epoch{epoch:03d}_{label}.png"
            save_image(img, os.path.join(self.web_dir, "images", name))
            ims.append(name)
            txts.append(label)
            links.append(name)
        if not self.use_html:
            return
        gallery = HTMLGallery(self.web_dir, f"Experiment = {self.name}", refresh=5)
        for e in range(epoch, 0, -1):
            row = [n.replace(f"epoch{epoch:03d}", f"epoch{e:03d}") for n in ims]
            # epochs that never reached a display step have no images
            if not all(os.path.exists(os.path.join(self.web_dir, "images", n)) for n in row):
                continue
            gallery.add_images(row, txts, links, width=self.win_size)
        gallery.save()
