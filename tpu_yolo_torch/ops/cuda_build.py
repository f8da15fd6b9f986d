"""Build a kernel source of `tpu_yolo_torch/csrc/` with nvcc and load it.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
into `tpu_yolo_torch/build/lib<name>-<hash>.so` for sm_90a, where the
hash covers the source and the flags, so an edited source is rebuilt at
its next use. The library is loaded with ctypes. Nothing is built when
a module is imported: the first launch on a CUDA tensor builds.

`build_host` does the same for a host C++ source, `csrc/<name>.cc`, with
g++ (the host data path, csrc/image_pipeline.cc): its library is named
`lib<name>-host-<hash>.so`, so that it never meets a card library of
the same stem.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-ffp-contract=off")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from tpu_yolo_torch/csrc at their first launch")


def _compile(compiler: str, src: str, stem: str, flags: tuple[str, ...],
             libs: tuple[str, ...] = ()) -> tuple[str, str]:
    """`compiler flags -o build/lib<stem>-<hash>.so src libs` unless that
    library exists; the hash covers the source, the flags and the libs.
    Returns (library path, the compiler's stderr; empty when nothing was
    built). A build is recorded as set-up (utils/telemetry.py:
    `setup.kernels_built`, `setup.build_s.<stem>`)."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags + libs).encode())
    out = os.path.join(BUILD, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, src, *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on {src}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    from tpu_yolo_torch.utils import telemetry

    telemetry.note("setup.kernels_built", 1, accumulate=True)
    telemetry.note(f"setup.build_s.{stem}", time.perf_counter() - t0)
    return out, proc.stderr


def build(name: str, extra_flags: tuple[str, ...] = (),
          libs: tuple[str, ...] = ()) -> tuple[str, str]:
    """Compile csrc/<name>.cu unless its library is current, linking the
    toolkit's `libs` (e.g. "-lnvjpeg"), found at run time through an
    rpath to the toolkit's library directories.

    Returns (library path, ptxas report; empty when nothing was built)."""
    nvcc = _nvcc()
    if libs:
        root = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
        for sub in ("lib64", os.path.join("targets", "x86_64-linux", "lib")):
            libs = (*libs, "-Xlinker", "-rpath", "-Xlinker", os.path.join(root, sub))
    return _compile(nvcc, os.path.join(CSRC, name + ".cu"), name,
                    (*FLAGS, *extra_flags), libs)


def build_host(name: str, libs: tuple[str, ...] = ()) -> str:
    """Compile the host C++ source csrc/<name>.cc with g++ unless its
    library is current, linking `libs`; returns the library's path.
    Raises RuntimeError with the reason where g++ is missing or the
    compile fails. No -march: a library built here loads on any x86-64."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host data path is built from "
                           "tpu_yolo_torch/csrc at its first use")
    return _compile(gxx, os.path.join(CSRC, name + ".cc"), name + "-host",
                    HOST_FLAGS, libs)[0]


def load(name: str, extra_flags: tuple[str, ...] = (),
         libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build(name, extra_flags, libs)
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(path))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
