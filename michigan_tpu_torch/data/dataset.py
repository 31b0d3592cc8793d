"""Training samples from an FFHQ-layout directory and a threaded batch loader
(the port's copy of michigan_tpu/data/dataset.py, reference
custom_dataset.py and pix2pix_dataset.py:66-194), NHWC float32 numpy.

The JAX package's loader ships uint8 planes to feed a remote TPU; on a local
card the loader hands out float32 arrays of the same values.
``CustomDataset(opt, step)``: in the paired stage (step 1) the ref planes
are the tag planes (the ref image color-jittered under --color_jitter); in
the unpaired stage (step 2, --unpairTrain) the ref index is drawn from the
sample's host rng right after the crop and flip, as the JAX package draws
it, and the ref label and image are that sample's.  The noise is the native
pyramid's, seeded by the sample's last rng draw, as in the JAX package.
--decode_cache_mb keeps decoded (and, where --preprocess_mode scales,
pre-scaled) images across epochs; --cache_filelist_write / _read keep each
directory's listing in <dir>/files.list.
"""

from __future__ import annotations

import os
import random
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np
from PIL import Image

from michigan_tpu_torch.data.noise import generate_noise_fast
from michigan_tpu_torch.data.preprocess import generate_hole, trans_orient_to_rgb
from michigan_tpu_torch.data.single import _label_tensor
from michigan_tpu_torch.data.transforms import get_params, get_transform, pre_geometry

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM",
                  ".bmp", ".BMP", ".tiff", ".webp")


def list_images(directory: str, cache_read: bool = False, cache_write: bool = False) -> List[str]:
    """The directory's images, sorted (reference image_folder.py:36-64);
    `cache_read` takes the list from <directory>/files.list when it exists,
    `cache_write` writes it there."""
    cache_path = os.path.join(directory, "files.list")
    if cache_read and os.path.exists(cache_path):
        with open(cache_path) as f:
            return [line.strip() for line in f if line.strip()]
    out = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                 if f.endswith(IMG_EXTENSIONS))
    if cache_write:
        with open(cache_path, "w") as f:
            f.write("\n".join(out))
    return out


class _DecodeCache:
    """Decoded images up to `cap_bytes` (FIFO eviction by bytes), handed
    out as copies, so loader threads never share a pixel buffer.  `produce`
    runs outside the lock: two threads that miss one key may both decode
    it, and the first result is kept."""

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self.used = 0
        self.lock = threading.Lock()
        self.images: "OrderedDict[str, Image.Image]" = OrderedDict()

    @staticmethod
    def _nbytes(img: Image.Image) -> int:
        return len(img.getbands()) * img.width * img.height

    def get_or_put(self, key: str, produce) -> Image.Image:
        with self.lock:
            img = self.images.get(key)
            if img is not None:
                return img.copy()
        img = produce()
        img.load()
        nb = self._nbytes(img)
        with self.lock:
            if key not in self.images and nb <= self.cap:
                while self.used + nb > self.cap and self.images:
                    _, old = self.images.popitem(last=False)
                    self.used -= self._nbytes(old)
                self.images[key] = img
                self.used += nb
            return img.copy()

    def open(self, path: str) -> Image.Image:
        return self.get_or_put(path, lambda: Image.open(path))


class CustomDataset:
    """{data_dir}/{clear_}train_labels | _images | _dense_orients, or the
    directories --label_dir / --image_dir / --orient_dir name."""

    def __init__(self, opt, step: int = 1):
        if opt.dataset_mode != "custom":
            raise ValueError(f"unknown --dataset_mode {opt.dataset_mode!r} (only 'custom')")
        self.opt, self.step = opt, step
        self._cache = _DecodeCache(opt.decode_cache_mb << 20) if opt.decode_cache_mb > 0 else None
        phase = "train" if opt.isTrain else opt.subset
        pre = os.path.join(opt.data_dir, f"{'clear_' if opt.clear else ''}{phase}")
        cut = opt.max_dataset_size
        kw = dict(cache_read=opt.cache_filelist_read, cache_write=opt.cache_filelist_write)
        self.label_paths = list_images(opt.label_dir or pre + "_labels", **kw)[:cut]
        self.image_paths = list_images(opt.image_dir or pre + "_images", **kw)[:cut]
        self.orient_paths = list_images(opt.orient_dir or pre + "_dense_orients", **kw)[:cut]
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

    def _open(self, path: str) -> Image.Image:
        return self._cache.open(path) if self._cache else Image.open(path)

    def get_sample(self, index: int, rng: random.Random) -> Dict[str, np.ndarray]:
        """One sample, (H, W, C) float32 arrays with the keys of the train
        step's batch; `rng` draws the crop, flip, the unpaired stage's ref
        index, the hole and the noise's seed."""
        opt = self.opt
        # the scaling stage does not depend on the sample's draws, so with
        # the cache on each image is scaled once a run and cached so;
        # pre_geometry leaves a scaled image as it is
        scaled = self._cache is not None and any(
            m in opt.preprocess_mode for m in ("resize", "scale_width", "scale_shortside"))

        def open_t(path, method=Image.BICUBIC, rgb=False):
            if not scaled:
                img = self._open(path)
                return img.convert("RGB") if rgb else img

            def produce():
                img = self._open(path)
                return pre_geometry(img.convert("RGB") if rgb else img, opt, method)

            return self._cache.get_or_put(
                f"{path}@{'rgb' if rgb else ''}geo:{opt.preprocess_mode}:{opt.load_size}:m{method}",
                produce)

        label = self._open(self.label_paths[index])
        params = get_params(opt, label.size, rng)
        index_ref = index if self.step == 1 else rng.randint(0, len(self) - 1)
        tl = get_transform(opt, params, method=Image.NEAREST, normalize=False)
        label_t = _label_tensor(tl, open_t(self.label_paths[index], Image.NEAREST),
                                opt.label_nc)[0]
        label_ref_t = label_t if index_ref == index else _label_tensor(
            tl, open_t(self.label_paths[index_ref], Image.NEAREST), opt.label_nc)[0]
        rgb_at = lambda i: open_t(self.image_paths[i], rgb=True)
        image_t = get_transform(opt, params)(rgb_at(index))
        image_ref_t = image_t
        if self.step != 1 or opt.color_jitter:
            image_ref_t = get_transform(opt, params, color=opt.color_jitter)(rgb_at(index_ref))
        orient_t = tl(open_t(self.orient_paths[index], Image.NEAREST)) * 255.0

        # the encoded orientation depends on the sample's raw orient and
        # label only: cached beside the decodes (scaled where they are)
        def make_rgb():
            return trans_orient_to_rgb(np.array(self._open(self.orient_paths[index])),
                                       np.array(label))

        if scaled:
            rgb = self._cache.get_or_put(
                f"__orient_rgb__geo:{opt.preprocess_mode}:{opt.load_size}:{index}",
                lambda: pre_geometry(make_rgb(), opt, Image.NEAREST))
        elif self._cache is not None:
            rgb = self._cache.get_or_put(f"__orient_rgb__:{index}", make_rgb)
        else:
            rgb = make_rgb()
        orient_rgb_t = tl(rgb) * label_t
        other = np.array(self._open(self.label_paths[rng.randint(0, len(self) - 1)]))
        hole_t = tl(generate_hole(np.array(label), other, rng)) * 255.0
        # the sample's last draw, as in the JAX package's loader
        noise = generate_noise_fast(opt.crop_size, opt.crop_size, rng.getrandbits(32))
        return {"label_tag": label_t, "label_ref": label_ref_t, "image_tag": image_t,
                "image_ref": image_ref_t, "orient": orient_t, "orient_rgb": orient_rgb_t,
                "hole": hole_t, "noise": noise}


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
