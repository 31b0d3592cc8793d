"""The port's native host library (michigan_tpu_torch/native) against the JAX
package's (michigan_tpu/native): the same C++ algorithms built with the same
g++ flags on this host give the same bits.  Both libraries must build here;
nothing skips."""

import os
import threading
import time

import numpy as np
import pytest

from michigan_tpu import native as jax_native
from michigan_tpu.ops.noise import generate_noise_fast as jax_noise_fast
from michigan_tpu_torch import native
from michigan_tpu_torch.data.noise import generate_noise, generate_noise_fast


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.get_lib()
    if lib is None:
        # another test process may have been writing the JAX package's
        # library at that moment: its loader gives up for good, so try once more
        time.sleep(2.0)
        jax_native._tried = False
        lib = jax_native.get_lib()
    assert lib is not None, "the JAX package's native library did not build"
    return lib


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
@pytest.mark.parametrize("height,width", [(64, 64), (96, 128)])
def test_noise_pyramid_equals_jax_bit_for_bit(jax_lib, height, width, seed):
    got = native.noise_pyramid(height, width, seed)
    want = jax_native.noise_pyramid(height, width, seed)
    assert got.shape == (height, width, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the loader's entry point: (width, height, seed), as the JAX package's
    np.testing.assert_array_equal(generate_noise_fast(width, height, seed),
                                  jax_noise_fast(width, height, seed))


def test_noise_pyramid_is_not_the_cv2_pyramid():
    """The noise the port's loader drew before: numpy's normal draws and
    cv2's resize, another stream (what the loader test would catch)."""
    seed = 11
    fast = generate_noise_fast(64, 64, seed)
    old = generate_noise(64, 64, np.random.default_rng(seed))
    assert np.abs(fast - old).max() > 0.1


def test_bilinear_resize_and_rasterize_hole_equal_jax(jax_lib):
    rng = np.random.default_rng(3)
    for (h, w, c), (dh, dw) in [((32, 24, 3), (64, 48)), ((8, 8, 3), (96, 128)),
                                ((37, 53, 1), (20, 30))]:
        src = rng.standard_normal((h, w, c)).astype(np.float32)
        got = native.bilinear_resize(src, dh, dw)
        np.testing.assert_array_equal(got, jax_native.bilinear_resize(src, dh, dw))
        np.testing.assert_allclose(got, native.bilinear_resize_plain(src, dh, dw),
                                   rtol=0, atol=1e-5)
    mask = (rng.uniform(size=(64, 80)) > 0.3).astype(np.float32)
    orient = mask * (rng.uniform(size=(64, 80)) > 0.5).astype(np.float32)
    for ch, cw, rr in [(30, 33, 250.0), (0, 79, 900.0), (63, 0, 1.0)]:
        got = native.rasterize_hole(mask, orient, ch, cw, rr)
        np.testing.assert_array_equal(got, jax_native.rasterize_hole(mask, orient, ch, cw, rr))
        # the numpy formula of tests/test_native.py
        yy, xx = np.arange(64)[:, None], np.arange(80)[None, :]
        circ = ((yy - ch) ** 2 + (xx - cw) ** 2) < rr
        np.testing.assert_array_equal(got, orient * circ + (mask - orient))
        np.testing.assert_array_equal(got, native.rasterize_hole_plain(mask, orient, ch, cw, rr))


def test_bad_shapes_raise_before_the_library_is_called():
    with pytest.raises(ValueError):
        native.noise_pyramid(0, 16, 1)
    with pytest.raises(ValueError):
        native.bilinear_resize(np.zeros((4, 4), np.float32), 8, 8)
    with pytest.raises(ValueError):
        native.rasterize_hole(np.zeros((4, 4)), np.zeros((4, 5)), 1, 1, 2.0)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native host library failed"):
        native.noise_pyramid(16, 16, 0)
    with pytest.raises(RuntimeError):
        generate_noise_fast(16, 16, 0)
    assert not list(tmp_path.iterdir())  # no library and no temporary left behind


def test_builds_once_for_racing_threads_and_again_when_the_source_is_newer(
        monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    builds = []
    real_build = native.build
    monkeypatch.setattr(native, "build", lambda: builds.append(1) or real_build())
    out = []
    threads = [threading.Thread(target=lambda: out.append(native.noise_pyramid(32, 32, 5)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(builds) == 1 and len(out) == 4
    for o in out[1:]:
        np.testing.assert_array_equal(o, out[0])
    # a library older than its source is rebuilt at the next load
    lib = native.library_path()
    old = native.SRC.stat().st_mtime - 10
    os.utime(lib, (old, old))
    monkeypatch.setattr(native, "_lib", None)
    np.testing.assert_array_equal(native.noise_pyramid(32, 32, 5), out[0])
    assert len(builds) == 2
