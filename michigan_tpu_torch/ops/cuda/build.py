"""Build the hand-written CUDA sources with nvcc and bind them with ctypes.

Each source under ``michigan_tpu_torch/csrc/`` is compiled on first use into
a shared library with a plain C interface (``extern "C"`` launchers that
return ``cudaGetLastError()``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>_<hash>.so csrc/<name>.cu

The library lands in ``michigan_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source rebuilds and an unchanged one loads at once.
``build_all`` starts one nvcc per missing library, all at once.  Nothing is
built when this module is imported: the CPU tests import every module of the
port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile csrc/<name>.cu for every name (default: every library) whose
    library does not exist yet, one nvcc each, all started together.
    Returns {name: path}; raises with nvcc's output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (cmd, tmp, proc) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
            else:
                # atomic: a concurrent process never loads a partial file
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists."""
    return build_all([name])[name]


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
    "filterbank": {
        "filterbank_orientation_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
        "filterbank_orientation_bf16ops": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
        "filterbank_orientation_backward_f32": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    },
    "conv_in_act": {
        "conv3x3_in_act_tiles": (_I64, _I64),
        "conv3x3_in_act_f32": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                               _I64, _I64, ctypes.c_float, ctypes.c_int, _P),
        "conv3x3_in_act_bf16_blocks": (_I64, _I64, _I64, _I64, _I64, _I64),
        "conv3x3_in_act_bf16_prenorm": (_I64, _I64, _I64, _I64, _I64, _I64),
        "conv3x3_in_act_bf16": (_P, _P, ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                                _I64, _I64, _I64, _I64, _I64, _I64, ctypes.c_float, ctypes.c_int,
                                _P),
    },
    "conv_lowch": {
        "conv3x3_same_f32": (_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P),
        "conv3x3_same_bf16_uses_map": (_P, _I64),
        "conv3x3_same_bf16": (_P, _P, ctypes.c_int, _P, _I64, _I64, _I64, _I64, _I64, _P),
    },
}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu with its argtypes set."""
    lib = ctypes.CDLL(str(build(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int  # a cudaError_t, or a shape query's int
    return lib


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One launch of `wrapper`'s kernel on `dtype` tensors: its total
    (``launches``) and its count by dtype (``launches_by_dtype``)."""
    wrapper.launches += 1
    name = str(dtype).removeprefix("torch.")
    wrapper.launches_by_dtype[name] = wrapper.launches_by_dtype.get(name, 0) + 1


def check_launch(kernel: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
