"""The port's ctypes binding to the native C++ data path,
`native/libtpuyolo_data.so` (built by `make -C native` from
`native/image_pipeline.cc`): the counterpart of
`tpu_yolo/data/native_loader.py`.

JPEG decode + resize run in a GIL-free C++ thread pool; batches come out
as contiguous NHWC uint8 RGB:
  * `load_one` / `load_batch`: decode + one resize + the centred
    letterbox, the serving geometry of `Detector`'s host decode (with
    allow_upscale the ratio is min(S/h, S/w) unclamped, which equals
    load_image's long-side scale then letterbox);
  * `load_batch_eval`: the eval geometry (data/image.py `load_image` +
    `letterbox(augment=False)`), for `NativeEvalLoader`;
  * `load_batch_raw`: raw pixels top-left in a (stage, stage) buffer,
    longer images pre-shrunk to fit, for the device letterbox of
    `Detector(device_letterbox=True)`;
  * `load_batch_scaled`: long side resized to the stage size (the
    `load_image` contract), for the device augmentation of
    data/device_augment.py and, in BGR order (`bgr=True`), for the host
    augmentation of data/native_train.py.
A file libjpeg cannot read (PNG, BMP, ...) is decoded by cv2 and placed
by the same fill function as the JAX package's (`fb_eval`, `fb_raw`,
`fb_scaled` below), bit for bit.

If the library is absent and cannot be built, or does not load,
`available()` is False: `make_val_loader(native="auto")` then takes the
Python loader, and `staging_pipeline` a `Cv2Pipeline`, which runs the
same fill functions on every image of a batch in a thread pool. Each
pipeline names its form in `.stager` ("native" or "cv2").
"""
from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpu_yolo_torch.data.augment import corners_to_norm, denorm_corners

_SO_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libtpuyolo_data.so")

_lib = None
_why = None   # why the library is unavailable, once a load has failed
_lib_lock = threading.Lock()


def _load():
    global _lib, _why
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:  # build on first use where the toolchain and libjpeg exist
                subprocess.run(["make", "-C", os.path.dirname(_SO_PATH)],
                               check=True, capture_output=True)
            except OSError as e:
                _why = f"make -C native could not run: {e}"
                return None
            except subprocess.CalledProcessError as e:
                tail = e.stderr.decode(errors="replace").strip().splitlines()[-1:]
                _why = f"make -C native failed: {' '.join(tail)}"
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:  # built for another machine's libraries
            _why = f"{_SO_PATH} does not load: {e}"
            return None
        lib.ip_create.restype = ctypes.c_void_p
        lib.ip_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ip_destroy.restype = None
        lib.ip_destroy.argtypes = [ctypes.c_void_p]
        lib.ip_load_one.restype = ctypes.c_int
        lib.ip_load_one.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
        lib.ip_load_batch.restype = ctypes.c_int
        lib.ip_load_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
        staged = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                  ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                  ctypes.POINTER(ctypes.c_float)]
        for fn in (lib.ip_load_batch_eval, lib.ip_load_batch_raw,
                   lib.ip_load_batch_scaled, lib.ip_load_batch_scaled_bgr):
            fn.restype = ctypes.c_int
            fn.argtypes = staged
        lib.ip_load_batch_scaled_interp.restype = ctypes.c_int
        lib.ip_load_batch_scaled_interp.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def why_unavailable() -> str | None:
    """Why the native library cannot be used here (None where it loads):
    the build's or the loader's error."""
    return None if available() else _why


# -- the cv2 forms of the staging contracts ---------------------------------
# Each returns fill(img_bgr, out_i, dims_i, i) that places one cv2-decoded
# image into its (stage, stage, 3) slot as RGB and writes dims_i =
# [staged_h, staged_w, orig_h, orig_w]: the JAX package's `_fb_*` closures,
# which the native pipeline runs for a slot libjpeg failed and Cv2Pipeline
# for every slot.

def fb_letterbox(size: int, allow_upscale: bool = False):
    """The load_batch contract for a slot libjpeg failed: one resize by
    min(S/h, S/w) (clamped at 1 unless allow_upscale; rounded dims,
    cv2.INTER_LINEAR), the centred round(pad -/+ 0.1) placement, RGB, and
    meta_i = [ratio, pad_w, pad_h, orig_w, orig_h]."""
    def fill(img, out_i, meta_i, i=0):
        import cv2

        h, w = img.shape[:2]
        r = min(size / h, size / w)
        if not allow_upscale:
            r = min(r, 1.0)
        new_w, new_h = int(round(w * r)), int(round(h * r))
        if (new_w, new_h) != (w, h):
            img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        pad_w, pad_h = (size - new_w) / 2, (size - new_h) / 2
        top, left = int(round(pad_h - 0.1)), int(round(pad_w - 0.1))
        out_i[:] = 0
        out_i[top:top + new_h, left:left + new_w] = img[:, :, ::-1]
        meta_i[:] = (r, pad_w, pad_h, w, h)
    return fill


def fb_eval(stage: int):
    """The eval contract, a bit-identical mirror of the Python eval image
    path (data/image.py::load_image + letterbox(augment=False)): float64
    ratio, truncated dims, cv2.INTER_LINEAR, centred round(pad - 0.1)
    placement, BGR->RGB at the end."""
    def fill(img, out_i, dims_i, i=0):
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
    return fill


def fb_raw(stage: int):
    """The raw contract: pixels top-left, an image longer than the stage
    pre-shrunk to fit (rounded dims, cv2.INTER_LINEAR)."""
    def fill(img, out_i, dims_i, i=0):
        import cv2

        h, w = img.shape[:2]
        sh, sw = h, w
        if max(h, w) > stage:
            d = stage / max(h, w)
            sw = min(int(round(w * d)), stage)
            sh = min(int(round(h * d)), stage)
            img = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_LINEAR)
        out_i[:] = 0
        out_i[:sh, :sw] = img[:, :, ::-1]
        dims_i[:] = (sh, sw, h, w)
    return fill


def fb_scaled(stage: int, interps=None, bgr: bool = False):
    """The scaled contract: long side resized to the stage, up or down,
    truncated dims (the load_image contract); `interps` holds a cv2
    interpolation code per image (None: bilinear for all). With bgr=True
    cv2's BGR pixels pass through unswapped."""
    def fill(img, out_i, dims_i, i=0):
        import cv2

        h, w = img.shape[:2]
        sh, sw = h, w
        r = stage / max(h, w)
        if max(h, w) != stage:
            sh, sw = max(int(h * r), 1), max(int(w * r), 1)
            flag = cv2.INTER_LINEAR if interps is None else int(interps[i])
            img = cv2.resize(img, (sw, sh), interpolation=flag)
        out_i[:] = 0
        out_i[:sh, :sw] = img if bgr else img[:, :, ::-1]
        dims_i[:] = (sh, sw, h, w)
    return fill


def _staging_buffer(out, n: int, stage: int) -> np.ndarray:
    """`out` checked as an (n, stage, stage, 3) C-contiguous uint8 array
    (a pinned buffer's view, say), or a new one when it is None."""
    if out is None:
        return np.empty((n, stage, stage, 3), np.uint8)
    if (out.shape != (n, stage, stage, 3) or out.dtype != np.uint8
            or not out.flags.c_contiguous):
        raise ValueError(f"staging buffer must be ({n}, {stage}, {stage}, 3) "
                         f"C-contiguous uint8, got {out.shape} {out.dtype}")
    return out


class NativePipeline:
    """Decode pipeline handle over the C++ thread pool. `allow_upscale`
    concerns load_one/load_batch only."""

    stager = "native"

    def __init__(self, input_size: int, threads: int = 8,
                 allow_upscale: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable; run `make -C native`")
        self._lib = lib
        self.input_size = input_size
        self.allow_upscale = allow_upscale
        self._h = lib.ip_create(threads, input_size, int(allow_upscale))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ip_destroy(h)
            self._h = None

    @staticmethod
    def _fallback(paths, bad_mask, out, dims, fill_one) -> int:
        """Decode the slots the native pool failed through cv2 and place
        them with `fill_one`; returns how many cv2 could not read either."""
        import cv2

        remaining = 0
        for i in np.flatnonzero(bad_mask):
            img = cv2.imread(paths[int(i)])  # BGR, any format cv2 knows
            if img is None:
                remaining += 1
                continue
            fill_one(img, out[int(i)], dims[int(i)], int(i))
        return remaining

    def _staged(self, fn, paths, stage, fill_one, out=None, extra=()):
        """Run the C++ staging call `fn` (with `extra` arguments after the
        stage size) into `out`, then the cv2 fallback on the slots it
        failed. Returns (images, dims, n_failures);
        failed slots are zeroed with dims[i, 0] == -1."""
        n = len(paths)
        out = _staging_buffer(out, n, stage)
        dims = np.empty((n, 4), np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        nfail = fn(self._h, arr, n, stage, *extra,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                   dims.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if nfail:
            nfail = self._fallback(paths, dims[:, 0] < 0, out, dims, fill_one)
        return out, dims, int(nfail)

    def load_one(self, jpeg_bytes: bytes):
        """Decode one JPEG -> (letterboxed (S, S, 3) uint8 RGB, meta dict
        {ratio, pad_w, pad_h, orig_w, orig_h}). Raises ValueError on bytes
        libjpeg cannot decode."""
        s = self.input_size
        out = np.empty((s, s, 3), np.uint8)
        meta = np.empty(5, np.float32)
        rc = self._lib.ip_load_one(
            self._h, jpeg_bytes, len(jpeg_bytes),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise ValueError("JPEG decode failed")
        return out, {"ratio": float(meta[0]), "pad_w": float(meta[1]),
                     "pad_h": float(meta[2]), "orig_w": int(meta[3]),
                     "orig_h": int(meta[4])}

    def load_batch(self, paths: list[str], out=None):
        """Parallel decode + letterbox -> ((N, S, S, 3) uint8 RGB, (N, 5)
        metas [ratio, pad_w, pad_h, orig_w, orig_h], n_failures), into
        `out` when given. A slot libjpeg fails is decoded by cv2 and
        placed by `fb_letterbox`; one cv2 cannot read either is zeroed
        with meta[i, 0] == -1."""
        s = self.input_size
        n = len(paths)
        out = _staging_buffer(out, n, s)
        metas = np.empty((n, 5), np.float32)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        nfail = self._lib.ip_load_batch(
            self._h, arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            metas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if nfail:
            nfail = self._fallback(paths, metas[:, 0] < 0, out, metas,
                                   fb_letterbox(s, self.allow_upscale))
        return out, metas, int(nfail)

    def load_batch_eval(self, paths: list[str], stage: int):
        """Parallel decode + the eval image contract in one pass:
        load_image's resize (long side == stage, truncated dims), then
        the centred letterbox pad. Returns (images (N, stage, stage, 3)
        uint8 RGB, dims (N, 4) [staged_h, staged_w, orig_h, orig_w],
        n_failures); failed slots are zeroed with dims[i, 0] == -1. Label
        geometry follows from dims: pad_w = (stage - staged_w) / 2,
        pad_h = (stage - staged_h) / 2."""
        return self._staged(self._lib.ip_load_batch_eval, paths, stage,
                            fb_eval(stage))

    def load_batch_raw(self, paths: list[str], stage: int, out=None):
        """Parallel decode into a raw (N, stage, stage, 3) top-left staging
        buffer (no letterbox: ops/letterbox.py runs it on the card);
        images longer than `stage` are pre-shrunk to fit. `out`: the
        buffer to fill, new when None. Returns (buffer, dims (N, 4)
        [staged_h, staged_w, orig_h, orig_w], n_failures); failed slots
        zeroed with dims[i, 0] == -1."""
        return self._staged(self._lib.ip_load_batch_raw, paths, stage,
                            fb_raw(stage), out)

    def load_batch_scaled(self, paths: list[str], stage: int, interps=None,
                          out=None, bgr: bool = False):
        """Parallel decode + resize so every image's long side == stage (up
        or down; truncated dims, the load_image contract), top-left in a
        (N, stage, stage, 3) buffer: the device-augment staging.
        `interps`: per-image cv2 interpolation codes (0 nearest / 1 linear
        / 2 cubic / 3 area / 4 lanczos4), the random-interp train
        prescale; None means bilinear for all. bgr=True gives BGR channel
        order (decoded straight to it), for host cv2 consumers
        (data/native_train.py). Returns as load_batch_raw."""
        fill = fb_scaled(stage, interps, bgr)
        if interps is None:
            fn = (self._lib.ip_load_batch_scaled_bgr if bgr
                  else self._lib.ip_load_batch_scaled)
            return self._staged(fn, paths, stage, fill, out)
        codes = (ctypes.c_int * len(paths))(*[int(v) for v in interps])
        return self._staged(self._lib.ip_load_batch_scaled_interp, paths,
                            stage, fill, out, extra=(codes, int(bgr)))


class Cv2Pipeline:
    """NativePipeline's staging calls with cv2 alone, for a machine where
    the native library cannot be built: every image of a batch is read by
    cv2.imread and placed by the fill function the native pipeline runs
    for a failed slot, in a thread pool (cv2 releases the GIL)."""

    stager = "cv2"

    def __init__(self, threads: int = 8):
        self.threads = max(threads, 1)

    def _staged(self, paths, stage, fill_one, out=None):
        import cv2

        n = len(paths)
        out = _staging_buffer(out, n, stage)
        dims = np.empty((n, 4), np.float32)

        def one(i):
            img = cv2.imread(paths[i])
            if img is None:
                out[i] = 0
                dims[i] = (-1, 0, 0, 0)
                return 1
            fill_one(img, out[i], dims[i], i)
            return 0

        with ThreadPoolExecutor(self.threads) as pool:
            nfail = sum(pool.map(one, range(n)))
        return out, dims, nfail

    def load_batch_raw(self, paths: list[str], stage: int, out=None):
        """NativePipeline.load_batch_raw through cv2."""
        return self._staged(paths, stage, fb_raw(stage), out)

    def load_batch_scaled(self, paths: list[str], stage: int, interps=None,
                          out=None, bgr: bool = False):
        """NativePipeline.load_batch_scaled through cv2."""
        return self._staged(paths, stage, fb_scaled(stage, interps, bgr), out)


def staging_pipeline(input_size: int, threads: int = 8):
    """The staging pipeline of this machine: NativePipeline where the
    native library loads, else Cv2Pipeline. Both offer load_batch_raw and
    load_batch_scaled, and say which they are in `.stager`."""
    if available():
        return NativePipeline(input_size, threads=threads)
    return Cv2Pipeline(threads)


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
                 prefetch: int = 2, shard=None):
        """`shard`: (index, count) to decode and yield only that contiguous
        part of each batch (data/loader.py::shard_rows)."""
        self.dataset = dataset          # DetectionDataset(augment=False)
        self.batch_size = batch_size
        self.shard = shard
        self.input_size = dataset.input_size
        self.pipe = NativePipeline(self.input_size, threads=threads)
        self.prefetch = prefetch

    def __len__(self):
        return -(-len(self.dataset.filenames) // self.batch_size)

    def _make_batch(self, start: int):
        from tpu_yolo_torch.data.loader import empty_batch, shard_rows

        rows = shard_rows(start, self.batch_size, len(self.dataset.filenames),
                          self.shard)
        if not rows:
            return empty_batch(self.input_size)
        lo = rows.start
        paths = self.dataset.filenames[lo:rows.stop]
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
