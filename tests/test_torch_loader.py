"""The port's trainer input pipeline (michigan_tpu_torch/data/dataset.py)
against the JAX package's (michigan_tpu/data/dataset.py) on FFHQ_demo's three
samples: every key of every sample equal, in both stages, with the decode
cache off and on, over two epochs of the batch loaders (the second served
from the cache), under --color_jitter, and the files.list cache.

The JAX loader ships uint8 planes: labels, orient and hole are compared as
their values, the images through the wire's decode (v / 127.5 - 1), the
noise and orient_rgb as they are.  In the paired stage the JAX loader ships
no ref planes (the train step aliases the tag's): the port's are held to
the tag's there.  No JAX jit runs here.
"""

import os
import random
import shutil
import sys
import threading

import numpy as np
import PIL.Image
import pytest

from michigan_tpu.config import Options as JOptions
from michigan_tpu.data.dataset import CustomDataset as JDataset
from michigan_tpu.data.dataset import create_dataloader
from michigan_tpu.data.dataset import list_images as jax_list_images
from michigan_tpu_torch.config import Options
from michigan_tpu_torch.data.dataset import BatchLoader, CustomDataset, _DecodeCache, list_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "datasets", "FFHQ_demo")
KEYS = ("label_tag", "label_ref", "image_tag", "image_ref", "orient", "orient_rgb", "hole",
        "noise")


def options(demo=DEMO, **kw):
    d = dict(isTrain=True, crop_size=64, load_size=64, use_ig=True, unpairTrain=True,
             nThreads=2, batchSize=1, label_dir=os.path.join(demo, "labels"),
             image_dir=os.path.join(demo, "images"), orient_dir=os.path.join(demo, "orients"))
    d.update(kw)
    return Options(**d).finalize(), JOptions(**d).finalize()


def assert_sample_equal(got, want, where):
    """`got` the port's float32 planes, `want` the JAX loader's wire."""
    assert sorted(got) == sorted(KEYS), where
    for k in KEYS:
        w = want[k] if k in want else want[k.replace("_ref", "_tag")]
        if k.startswith("image"):
            w = w.astype(np.float32) / np.float32(127.5) - np.float32(1.0)
        assert got[k].dtype == np.float32, (where, k)
        np.testing.assert_array_equal(got[k], w.astype(np.float32), err_msg=f"{where} {k}")


@pytest.mark.parametrize("cache_mb", [0, 64])
@pytest.mark.parametrize("step", [1, 2])
def test_batch_loader_equals_jax_over_two_epochs(step, cache_mb, monkeypatch):
    """Two epochs of the port's BatchLoader against the JAX package's
    PrefetchLoader (same shuffle and per-sample rng keys); with the cache
    on, the second epoch decodes no file, and its samples equal the JAX
    loader's without the cache."""
    ours_opt, jax_opt = options(decode_cache_mb=cache_mb)
    ours = BatchLoader(CustomDataset(ours_opt, step), ours_opt)
    theirs = create_dataloader(jax_opt, step)
    plain = create_dataloader(options(decode_cache_mb=0)[1], step)
    decodes = []
    real_open = PIL.Image.open
    for epoch in range(2):
        if epoch == 1:
            monkeypatch.setattr(PIL.Image, "open", lambda *a, **k: decodes.append(a[0])
                                or real_open(*a, **k))
        got = list(ours)
        monkeypatch.setattr(PIL.Image, "open", real_open)
        want, want_plain = list(theirs), list(plain)
        assert len(got) == len(want) == len(want_plain) == 3
        for bi, (g, w, p) in enumerate(zip(got, want, want_plain)):
            assert_sample_equal(g, w, f"stage {step} epoch {epoch} batch {bi}")
            assert_sample_equal(g, p, f"stage {step} epoch {epoch} batch {bi}, JAX uncached")
    if cache_mb:
        assert decodes == [], decodes
        cache = ours.dataset._cache
        assert 0 < cache.used <= cache.cap and len(cache.images) >= 9
    else:
        assert len(decodes) >= 3 * 4  # label, image, orient and the hole's label a sample


@pytest.mark.parametrize("cache_mb", [0, 64])
def test_color_jitter_sample_equals_jax(cache_mb):
    """--color_jitter draws its factors from the global random module in both
    packages: seeded alike before each sample, one thread."""
    ours_opt, jax_opt = options(color_jitter=True, decode_cache_mb=cache_mb)
    for step in (1, 2):
        ours, theirs = CustomDataset(ours_opt, step), JDataset(jax_opt, step)
        for index in range(len(ours)):
            for epoch in range(2):
                random.seed(100 + index)
                got = ours.get_sample(index, random.Random(7 * index + epoch))
                random.seed(100 + index)
                want = theirs.get_sample(index, random.Random(7 * index + epoch))
                assert "image_ref" in want
                assert not np.array_equal(got["image_ref"], got["image_tag"])
                assert_sample_equal(got, want, f"stage {step} sample {index} epoch {epoch}")


def test_filelist_cache_written_and_read_as_jax(tmp_path):
    """--cache_filelist_write writes each directory's files.list as the JAX
    package writes it; --cache_filelist_read then lists from it (a file
    removed afterwards stays listed), as the JAX package's list_images does."""
    ours_dir, jax_dir = tmp_path / "ours", tmp_path / "jax"
    shutil.copytree(DEMO, ours_dir)
    shutil.copytree(DEMO, jax_dir)
    ours_opt, _ = options(demo=str(ours_dir), cache_filelist_write=True)
    _, jax_opt = options(demo=str(jax_dir), cache_filelist_write=True)
    ds, jds = CustomDataset(ours_opt), JDataset(jax_opt)
    for kind in ("labels", "images", "orients"):
        ours_list = (ours_dir / kind / "files.list").read_text()
        assert ours_list.replace(str(ours_dir), "") == \
            (jax_dir / kind / "files.list").read_text().replace(str(jax_dir), "")
        assert ours_list.splitlines() == jax_list_images(str(ours_dir / kind))
    assert ds.image_paths == [p.replace(str(jax_dir), str(ours_dir)) for p in jds.image_paths]

    os.remove(ours_dir / "images" / "60429.jpg")
    for kind in ("labels", "images", "orients"):
        d = str(ours_dir / kind)
        assert list_images(d, cache_read=True) == jax_list_images(d, cache_read=True)
        assert list_images(d) == jax_list_images(d)
    assert len(list_images(str(ours_dir / "images"), cache_read=True)) == 3
    assert len(list_images(str(ours_dir / "images"))) == 2
    ours_opt, _ = options(demo=str(ours_dir), cache_filelist_read=True)
    assert len(CustomDataset(ours_opt)) == 3


def test_decode_cache_under_racing_threads():
    """More threads than cores on few keys, a cap of a few images and a
    short switch interval: the cache's byte count stays its images' sum
    within the cap, and every thread gets its key's pixels."""
    cache = _DecodeCache(5 * 16 * 16 * 3)
    keys = [f"k{i}" for i in range(12)]
    image = lambda key: PIL.Image.new("RGB", (16, 16), (int(key[1:]) * 20, 0, 0))
    bad, interval = [], sys.getswitchinterval()

    def worker(seed):
        r = random.Random(seed)
        for _ in range(300):
            key = r.choice(keys)
            if cache.get_or_put(key, lambda: image(key)).getpixel((3, 3))[0] != int(key[1:]) * 20:
                bad.append(key)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert bad == []
    assert cache.used == sum(cache._nbytes(im) for im in cache.images.values()) <= cache.cap
    assert len(cache.images) == 5
