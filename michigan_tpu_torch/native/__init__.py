"""ctypes bindings for the native host-pipeline library (michigan_native.cpp).

The port's own copy of the JAX package's C++ (michigan_tpu/native), built
with g++ at first use into ``michigan_tpu_torch/_build/libmichigan_native.so``
(listed in .gitignore) with the same flags as the JAX package's build:

    g++ -O3 -march=native -ffast-math -shared -fPIC -o <lib> michigan_native.cpp -lmvec -lm

and, where libmvec is absent, the same without ``-lmvec -lm``.  Built so on
the same host, it gives the JAX package's library's bits, so the trainer's
loader draws the same noise as the JAX package's.  The library is rebuilt
when the source is newer than it; a lock keeps loader threads from building
it twice, and the build writes a temporary file that replaces the library at
once, so two processes may build side by side.  There is no fallback: a
failed build raises RuntimeError with g++'s output (a cv2 pyramid would draw
another noise stream, and the card machine has no cv2).

``bilinear_resize_plain`` and ``rasterize_hole_plain`` are numpy forms of two
of the entry points, which the tests and chip_smoke.py hold the library to;
no code path falls back to them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "michigan_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")
# -lmvec lets gcc vectorize gauss_fill's transcendental loops through glibc's
# SIMD libm; the plain link is for hosts without libmvec
LINK_FLAGS = (("-lmvec", "-lm"), ())

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    return BUILD_DIR / "libmichigan_native.so"


def build() -> Path:
    """Compile the library (see the module docstring) and return its path;
    raises RuntimeError with the compiler's output if every link fails."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    errors = []
    for extra in LINK_FLAGS:
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC), *extra]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"$ {' '.join(cmd)}\n{e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"$ {' '.join(cmd)}\n(exit {proc.returncode}) {proc.stderr}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError("building the native host library failed:\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing or older than its
    source."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists() or path.stat().st_mtime < SRC.stat().st_mtime:
                build()
            lib = ctypes.CDLL(str(path))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.noise_pyramid.argtypes = [fp, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
            lib.bilinear_resize_f32.argtypes = [
                fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, fp, ctypes.c_int, ctypes.c_int]
            lib.rasterize_hole.argtypes = [
                fp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, fp]
            for fn in (lib.noise_pyramid, lib.bilinear_resize_f32, lib.rasterize_hole):
                fn.restype = None
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def noise_pyramid(height: int, width: int, seed: int) -> np.ndarray:
    """Multi-octave noise (reference base_dataset.py:387-396): octaves of
    N(0.5, 0.25) from (height, width) halving down to 8 px, each bilinear
    upsampled, averaged; (height, width, 3) float32, deterministic in
    `seed` (a splitmix64 counter RNG, not numpy's)."""
    if height < 1 or width < 1:
        raise ValueError(f"noise_pyramid needs a positive size, got {height}x{width}")
    lib = get_lib()
    out = np.empty((height, width, 3), np.float32)
    lib.noise_pyramid(_ptr(out), height, width, ctypes.c_uint64(seed))
    return out


def bilinear_resize(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(h, w, c) -> (dh, dw, c) float32, half-pixel bilinear (cv2's
    INTER_LINEAR)."""
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 3 or min(src.shape) < 1 or dh < 1 or dw < 1:
        raise ValueError(f"bilinear_resize takes (h, w, c) to a positive size, got "
                         f"{src.shape} -> ({dh}, {dw})")
    lib = get_lib()
    h, w, c = src.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.bilinear_resize_f32(_ptr(src), h, w, c, _ptr(dst), dh, dw)
    return dst


def rasterize_hole(mask: np.ndarray, orient_mask: np.ndarray, ch: int, cw: int,
                   rr: float) -> np.ndarray:
    """orient_mask * [(y - ch)^2 + (x - cw)^2 < rr] + (mask - orient_mask),
    (h, w) float32 (reference base_dataset.py:335-361)."""
    mask = np.ascontiguousarray(mask, np.float32)
    orient_mask = np.ascontiguousarray(orient_mask, np.float32)
    if mask.ndim != 2 or orient_mask.shape != mask.shape:
        raise ValueError(f"rasterize_hole takes two (h, w) masks of one shape, got "
                         f"{mask.shape} and {orient_mask.shape}")
    lib = get_lib()
    h, w = mask.shape
    out = np.empty((h, w), np.float32)
    lib.rasterize_hole(_ptr(mask), _ptr(orient_mask), h, w, ch, cw, rr, _ptr(out))
    return out


def bilinear_resize_plain(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """numpy half-pixel bilinear in float64, edges clamped, as float32."""
    src = np.asarray(src, np.float64)
    h, w = src.shape[:2]

    def taps(n_out, n_in):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(f).astype(np.int64)
        return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), f - i0

    y0, y1, wy = taps(dh, h)
    x0, x1, wx = taps(dw, w)
    wx = wx[None, :, None]
    top = src[y0][:, x0] * (1 - wx) + src[y0][:, x1] * wx
    bot = src[y1][:, x0] * (1 - wx) + src[y1][:, x1] * wx
    return (top * (1 - wy[:, None, None]) + bot * wy[:, None, None]).astype(np.float32)


def rasterize_hole_plain(mask: np.ndarray, orient_mask: np.ndarray, ch: int, cw: int,
                         rr: float) -> np.ndarray:
    """rasterize_hole's formula in numpy."""
    yy = np.arange(mask.shape[0])[:, None]
    xx = np.arange(mask.shape[1])[None, :]
    circ = ((yy - ch) ** 2 + (xx - cw) ** 2) < rr
    return (orient_mask * circ + (mask - orient_mask)).astype(np.float32)
