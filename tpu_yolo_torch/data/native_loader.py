"""The eval part of the native C++ data path: the port's own ctypes
binding to `native/libtpuyolo_data.so` (built by `make -C native` from
`native/image_pipeline.cc`), counterpart of the eval half of
`tpu_yolo/data/native_loader.py`.

JPEG decode + bilinear resize + letterbox run in a GIL-free C++ thread
pool, in the geometry of data/image.py's `load_image` +
`letterbox(augment=False)`; batches come out as contiguous NHWC uint8
RGB. A file libjpeg cannot read (PNG, BMP, ...) is decoded by cv2 with
the same geometry, bit for bit.

If the library is absent and cannot be built, or does not load,
`available()` is False and `make_val_loader(native="auto")` takes the
Python loader.
"""
from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading

import numpy as np

from tpu_yolo_torch.data.augment import corners_to_norm, denorm_corners

_SO_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libtpuyolo_data.so")

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:  # build on first use where the toolchain and libjpeg exist
                subprocess.run(["make", "-C", os.path.dirname(_SO_PATH)],
                               check=True, capture_output=True)
            except (OSError, subprocess.CalledProcessError):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:  # built for another machine's libraries
            return None
        lib.ip_create.restype = ctypes.c_void_p
        lib.ip_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ip_destroy.restype = None
        lib.ip_destroy.argtypes = [ctypes.c_void_p]
        lib.ip_load_batch_eval.restype = ctypes.c_int
        lib.ip_load_batch_eval.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


class NativePipeline:
    """Decode/letterbox pipeline handle over the C++ thread pool."""

    def __init__(self, input_size: int, threads: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable; run `make -C native`")
        self._lib = lib
        self.input_size = input_size
        self._h = lib.ip_create(threads, input_size, 0)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ip_destroy(h)
            self._h = None

    def _fallback(self, paths, bad_mask, out, dims, stage) -> int:
        """Decode the slots the native pool failed through cv2, in the
        eval geometry; returns how many cv2 could not read either."""
        import cv2

        remaining = 0
        for i in np.flatnonzero(bad_mask):
            img = cv2.imread(paths[int(i)])  # BGR, any format cv2 knows
            if img is None:
                remaining += 1
                continue
            self._fb_eval(img, out[int(i)], dims[int(i)], stage)
        return remaining

    @staticmethod
    def _fb_eval(img, out_i, dims_i, stage):
        """Bit-identical mirror of the Python eval image path
        (data/image.py::load_image + letterbox(augment=False)): float64
        ratio, truncated dims, cv2.INTER_LINEAR, centered round(pad - 0.1)
        placement, BGR->RGB at the end."""
        import cv2

        h, w = img.shape[:2]
        r = stage / max(h, w)
        sh, sw = h, w
        if r != 1:
            sh, sw = int(h * r), int(w * r)
            img = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_LINEAR)
        top = int(round((stage - sh) / 2 - 0.1))
        left = int(round((stage - sw) / 2 - 0.1))
        out_i[:] = 0
        out_i[top:top + sh, left:left + sw] = img[:, :, ::-1]
        dims_i[:] = (sh, sw, h, w)

    def load_batch_eval(self, paths: list[str], stage: int):
        """Parallel decode + the eval image contract in one pass:
        load_image's resize (long side == stage, truncated dims), then
        the centered letterbox pad. Returns (images (N, stage, stage, 3)
        uint8 RGB, dims (N, 4) [staged_h, staged_w, orig_h, orig_w],
        n_failures); failed slots are zeroed with dims[i, 0] == -1. Label
        geometry follows from dims: pad_w = (stage - staged_w) / 2,
        pad_h = (stage - staged_h) / 2."""
        n = len(paths)
        out = np.empty((n, stage, stage, 3), np.uint8)
        dims = np.empty((n, 4), np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        nfail = self._lib.ip_load_batch_eval(
            self._h, arr, n, stage,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if nfail:
            nfail = self._fallback(paths, dims[:, 0] < 0, out, dims, stage)
        return out, dims, int(nfail)


class NativeEvalLoader:
    """Eval data loader over the native pipeline, a drop-in for
    data/loader.py::DataLoader in eval/evaluator.py::evaluate: yields
    (images (B, S, S, 3) uint8 RGB, targets {"cls", "box", "idx"}) in
    dataset order. The label geometry is the denorm_corners /
    corners_to_norm math of the Python dataset's eval branch, from the
    returned dims; pixel values differ from cv2's only by the decoder
    and bilinear rounding (JPEG), and not at all through the cv2
    fallback.

    One batch is prefetched in a background thread, so host decode
    overlaps the device forward (the evaluator double-buffers on top).
    """

    def __init__(self, dataset, batch_size: int, threads: int = 8,
                 prefetch: int = 2):
        self.dataset = dataset          # DetectionDataset(augment=False)
        self.batch_size = batch_size
        self.input_size = dataset.input_size
        self.pipe = NativePipeline(self.input_size, threads=threads)
        self.prefetch = prefetch

    def __len__(self):
        return -(-len(self.dataset.filenames) // self.batch_size)

    def _make_batch(self, lo: int):
        paths = self.dataset.filenames[lo:lo + self.batch_size]
        images, dims, nfail = self.pipe.load_batch_eval(paths,
                                                        self.input_size)
        if nfail:
            bad = [p for p, d in zip(paths, dims) if d[0] < 0]
            raise ValueError(f"undecodable eval images: {bad}")
        s = float(self.input_size)
        cls_all, box_all, idx_all = [], [], []
        for i, d in enumerate(dims):
            sh, sw = float(d[0]), float(d[1])
            label = self.dataset.labels[lo + i].copy()
            if label.size:
                label[:, 1:] = denorm_corners(
                    label[:, 1:], sw, sh, (s - sw) / 2, (s - sh) / 2)
                box = corners_to_norm(label[:, 1:5], s, s)
            else:
                box = label[:, 1:5].copy()
            cls_all.append(label[:, 0:1].astype(np.float32))
            box_all.append(box.astype(np.float32))
            idx_all.append(np.full(len(label), i, dtype=np.float32))
        targets = {"cls": np.concatenate(cls_all, 0),
                   "box": np.concatenate(box_all, 0),
                   "idx": np.concatenate(idx_all, 0)}
        return images, targets

    def __iter__(self):
        starts = list(range(0, len(self.dataset.filenames), self.batch_size))
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for lo in starts:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(lo))
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while worker.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
