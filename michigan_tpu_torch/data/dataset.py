"""Training samples from an FFHQ-layout directory and a threaded batch loader
(the port's copy of michigan_tpu/data/dataset.py, reference
custom_dataset.py and pix2pix_dataset.py:66-194), NHWC float32 numpy.

The JAX package's loader ships uint8 planes and caches decodes to feed a
remote TPU; on a local card the loader hands out float32 arrays and keeps no
cache.  ``CustomDataset(opt, step)``: in the paired stage (step 1) the ref
planes are the tag planes (the ref image color-jittered under
--color_jitter); in the unpaired stage (step 2, --unpairTrain) the ref index
is drawn from the sample's host rng right after the crop and flip, as the
JAX package draws it, and the ref label and image are that sample's.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np
from PIL import Image

from michigan_tpu_torch.data.noise import generate_noise
from michigan_tpu_torch.data.preprocess import generate_hole, trans_orient_to_rgb
from michigan_tpu_torch.data.single import _label_tensor
from michigan_tpu_torch.data.transforms import get_params, get_transform

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM",
                  ".bmp", ".BMP", ".tiff", ".webp")


def list_images(directory: str) -> List[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.endswith(IMG_EXTENSIONS))


class CustomDataset:
    """{data_dir}/{clear_}train_labels | _images | _dense_orients, or the
    directories --label_dir / --image_dir / --orient_dir name."""

    def __init__(self, opt, step: int = 1):
        if opt.dataset_mode != "custom":
            raise ValueError(f"unknown --dataset_mode {opt.dataset_mode!r} (only 'custom')")
        self.opt, self.step = opt, step
        phase = "train" if opt.isTrain else opt.subset
        pre = os.path.join(opt.data_dir, f"{'clear_' if opt.clear else ''}{phase}")
        cut = opt.max_dataset_size
        self.label_paths = list_images(opt.label_dir or pre + "_labels")[:cut]
        self.image_paths = list_images(opt.image_dir or pre + "_images")[:cut]
        self.orient_paths = list_images(opt.orient_dir or pre + "_dense_orients")[:cut]
        if not len(self.label_paths) == len(self.image_paths) == len(self.orient_paths):
            raise ValueError(f"dataset mismatch under {opt.data_dir}: {len(self.label_paths)} "
                             f"labels, {len(self.image_paths)} images, "
                             f"{len(self.orient_paths)} dense orientation maps")
        if not opt.no_pairing_check:
            for lp, ip in zip(self.label_paths, self.image_paths):
                if os.path.splitext(os.path.basename(lp))[0] != \
                        os.path.splitext(os.path.basename(ip))[0]:
                    raise ValueError(f"label/image pairing mismatch: {lp} vs {ip}")

    def __len__(self) -> int:
        return len(self.label_paths)

    def get_sample(self, index: int, rng: random.Random) -> Dict[str, np.ndarray]:
        """One sample, (H, W, C) float32 arrays with the keys of the train
        step's batch; `rng` draws the crop, flip, the unpaired stage's ref
        index, the hole and the noise."""
        opt = self.opt
        label = Image.open(self.label_paths[index])
        params = get_params(opt, label.size, rng)
        index_ref = index if self.step == 1 else rng.randint(0, len(self) - 1)
        tl = get_transform(opt, params, method=Image.NEAREST, normalize=False)
        label_t = _label_tensor(tl, label, opt.label_nc)[0]
        label_ref_t = label_t if index_ref == index else \
            _label_tensor(tl, Image.open(self.label_paths[index_ref]), opt.label_nc)[0]
        rgb_at = lambda i: Image.open(self.image_paths[i]).convert("RGB")
        image_t = get_transform(opt, params)(rgb_at(index))
        image_ref_t = image_t
        if self.step != 1 or opt.color_jitter:
            image_ref_t = get_transform(opt, params, color=opt.color_jitter)(rgb_at(index_ref))
        orient_img = Image.open(self.orient_paths[index])
        orient_t = tl(orient_img) * 255.0
        rgb = trans_orient_to_rgb(np.array(orient_img), np.array(label))
        orient_rgb_t = tl(rgb) * label_t
        other = np.array(Image.open(self.label_paths[rng.randint(0, len(self) - 1)]))
        hole_t = tl(generate_hole(np.array(label), other, rng)) * 255.0
        noise = generate_noise(opt.crop_size, opt.crop_size,
                               np.random.default_rng(rng.getrandbits(32)))
        return {"label_tag": label_t, "label_ref": label_ref_t, "image_tag": image_t,
                "image_ref": image_ref_t, "orient": orient_t, "orient_rgb": orient_rgb_t,
                "hole": hole_t, "noise": noise.astype(np.float32)}


class BatchLoader:
    """Batches of --batchSize samples (the last partial batch dropped), in a
    shuffled order per epoch unless --serial_batches, assembled by
    --nThreads threads one batch ahead of the consumer.  Each sample's rng is
    keyed by (seed, epoch, batch, position), so a run is reproducible.

    ``shard=(rank, world)`` (data parallelism): every rank draws the same
    global order and assembles only its contiguous slice of each global
    batch, batchSize / world samples; the rng keys keep the samples' global
    positions, so the ranks' slices together are the unsharded batches
    (the JAX package's PrefetchLoader)."""

    def __init__(self, dataset: CustomDataset, opt, shard: Tuple[int, int] = (0, 1)):
        self.dataset, self.opt = dataset, opt
        self.epoch = 0
        self.rank, world = shard
        if opt.batchSize % world:
            raise ValueError(f"--batchSize {opt.batchSize} (the global batch) must divide "
                             f"by the {world} replicas")
        self.local = opt.batchSize // world

    def __len__(self) -> int:
        return len(self.dataset) // self.opt.batchSize

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.dataset)))
        if not self.opt.serial_batches:
            random.Random(self.opt.seed + self.epoch).shuffle(order)
        bs = self.opt.batchSize
        off = self.rank * self.local
        batches = [order[i + off:i + off + self.local] for i in range(0, len(self) * bs, bs)]
        with ThreadPoolExecutor(max(1, self.opt.nThreads)) as pool:

            def submit(bi):
                if bi >= len(batches):
                    return None
                return [pool.submit(self.dataset.get_sample, i,
                                    random.Random(hash((self.opt.seed, self.epoch, bi, off + j))))
                        for j, i in enumerate(batches[bi])]

            try:
                pending = submit(0)
                for bi in range(len(batches)):
                    futures, pending = pending, submit(bi + 1)
                    samples = [f.result() for f in futures]
                    yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            finally:
                self.epoch += 1
