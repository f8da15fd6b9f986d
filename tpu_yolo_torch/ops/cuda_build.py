"""Build a kernel source of `tpu_yolo_torch/csrc/` with nvcc and load it.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
into `tpu_yolo_torch/build/lib<name>-<hash>.so` for sm_90a, where the
hash covers the source and the flags, so an edited source is rebuilt at
its next use. The library is loaded with ctypes. Nothing is built when
a module is imported: the first launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from tpu_yolo_torch/csrc at their first launch")


def build(name: str, extra_flags: tuple[str, ...] = ()) -> tuple[str, str]:
    """Compile csrc/<name>.cu unless its library is current.

    Returns (library path, ptxas report; empty when nothing was built)."""
    src = os.path.join(CSRC, name + ".cu")
    flags = (*FLAGS, *extra_flags)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    out = os.path.join(BUILD, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def load(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build(name, extra_flags)
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(path))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
