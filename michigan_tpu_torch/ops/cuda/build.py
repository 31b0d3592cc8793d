"""Build the hand-written CUDA sources with nvcc and bind them with ctypes.

Each source under ``michigan_tpu_torch/csrc/`` is compiled on first use into
a shared library with a plain C interface (``extern "C"`` launchers that
return ``cudaGetLastError()``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>_<hash>.so csrc/<name>.cu

The library lands in ``michigan_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the source and the flags, so an edited source rebuilds and
an unchanged one loads at once.  Nothing is built when this module is
imported: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


_P = ctypes.c_void_p
_I64 = ctypes.c_int64

# argtypes of every launcher; without them ctypes would pass each pointer as a
# 32-bit int and cut it
SIGNATURES = {
    "spade_norm": {
        "spade_modulate_f32": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
        "spade_modulate_bf16": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
        "instance_norm_f32": (_P, _P, _P, _P, _I64, _I64, ctypes.c_float,
                              ctypes.c_int, _P),
        "instance_norm_bf16": (_P, _P, _P, _P, _I64, _I64, ctypes.c_float,
                               ctypes.c_int, _P),
    },
}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu with its argtypes set."""
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
