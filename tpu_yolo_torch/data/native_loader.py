"""The port's data paths from files to uint8 batches, the counterpart
of `tpu_yolo/data/native_loader.py`, in three forms that name themselves
in `.stager`:

  * "native", `NativePipeline`: ctypes over the port's host C++ data path,
    csrc/image_pipeline.cc, built at first use into tpu_yolo_torch/build/
    (ops/cuda_build.py::build_host, g++ and libjpeg); JPEG decode and
    resize in a GIL-free C++ thread pool, batches as NHWC uint8 numpy;
  * "nvjpeg", `CardPipeline`: the same five calls on a CUDA device, JPEGs
    decoded by nvJPEG and placed by the kernels of ops/image_cuda.py
    (csrc/image_card.cu), the batch a uint8 tensor on the card;
  * "cv2", `Cv2Pipeline`: the staging calls through cv2 alone.

The five calls and their geometry:
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
A file the decoder cannot read (PNG, BMP, ...) is decoded by cv2 and
placed by the same fill function as the JAX package's (`fb_eval`,
`fb_raw`, `fb_scaled` below), bit for bit.

Where the host library cannot be built (no g++ or no libjpeg headers) or
does not load, `available()` is False and `why_unavailable()` says why:
on the CPU `make_val_loader(native="auto")` then takes the Python loader,
and `staging_pipeline` a `Cv2Pipeline`. On a CUDA device the consumers
take `CardPipeline`, whose build failure raises.
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

_lib = None
_why = None   # why the library is unavailable, once a load has failed
_lib_lock = threading.Lock()


def _load():
    global _lib, _why
    with _lib_lock:
        if _lib is not None or _why is not None:
            return _lib
        from tpu_yolo_torch.ops import cuda_build

        try:  # built on first use where g++ and libjpeg exist
            path = cuda_build.build_host("image_pipeline", ("-ljpeg", "-lpthread"))
        except RuntimeError as e:
            lines = str(e).strip().splitlines()
            err = [ln for ln in lines if "error" in ln] or lines[-1:]
            _why = f"{lines[0].rstrip(':')}: {err[0].strip()}" if len(lines) > 1 \
                else lines[0]
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _why = f"{path} does not load: {e}"
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
            raise RuntimeError(f"the host data library is unavailable: {_why}")
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


_NVJPEG_STATUS = ("success", "not initialized", "invalid parameter", "bad JPEG",
                  "JPEG not supported", "allocator failure", "execution failed",
                  "arch mismatch", "internal error", "implementation not supported",
                  "incomplete bitstream")


def _status(code: int) -> str:
    if code >= 1000:
        return f"CUDA error {code - 1000}"
    name = _NVJPEG_STATUS[code] if 0 <= code < len(_NVJPEG_STATUS) else "unknown"
    return f"nvJPEG status {code} ({name})"


class _Decoder:
    """One decode thread's state on the card: an nvJPEG handle and state,
    a side stream, a pinned buffer for the file's bytes and the event
    after its last image's work."""

    def __init__(self, device, lib):
        import torch

        self.lib, self.device = lib, device
        self.pinned = np.empty(0, np.uint8)
        status = ctypes.c_int(0)
        with torch.cuda.device(device):
            self.handle = lib.ic_decoder_create(ctypes.byref(status))
            if not self.handle:
                raise RuntimeError(f"nvJPEG refused a decoder: {_status(status.value)}")
            self.stream = torch.cuda.Stream(device)
            self.done = torch.cuda.Event()

    def __del__(self):
        if getattr(self, "handle", None):
            self.done.synchronize()   # nothing of its state in flight
            self.lib.ic_decoder_destroy(self.handle)
            self.handle = None

    def read(self, item) -> int:
        """The bytes of `item` (a path, or bytes) into the pinned buffer,
        once the card has finished with the last ones; returns their
        length."""
        self.done.synchronize()
        if isinstance(item, (bytes, bytearray)):
            n = len(item)
            self._room(n)
            self.pinned[:n] = np.frombuffer(item, np.uint8)
            return n
        with open(item, "rb") as f:
            n = os.fstat(f.fileno()).st_size
            self._room(n)
            if f.readinto(memoryview(self.pinned[:n])) != n:
                raise OSError(f"{item}: short read")
        return n

    def _room(self, n: int):
        if len(self.pinned) < n:
            import torch

            size = max(n, 2 * len(self.pinned), 1 << 20)
            self.pinned = torch.empty(size, dtype=torch.uint8, pin_memory=True).numpy()

    def decode(self, n: int, bgr: bool):
        """The pixels of the bytes read, on the current stream: (h, w, 3)
        uint8 on the device, or None for bytes nvJPEG does not read. A
        4:4:4, 4:2:2 or 4:2:0 JPEG is decoded to planar YCbCr and
        converted by image_cuda.ycc_to_rgb as libjpeg converts it; the
        rest (grayscale, other subsamplings) in nvJPEG's own RGB."""
        import torch

        from tpu_yolo_torch.ops import image_cuda

        lib, data = self.lib, self.pinned.ctypes.data
        dims = [ctypes.c_int(0) for _ in range(7)]
        st = lib.ic_image_info(self.handle, data, n, *(ctypes.byref(d) for d in dims))
        w, h, comps, hs, vs, cw, ch = (d.value for d in dims)
        if st or comps not in (1, 3) or min(w, h) < 1:
            if st and not lib.ic_undecodable(st):
                raise RuntimeError(f"nvJPEG failed reading a header: {_status(st)}")
            return None
        img = torch.empty((h, w, 3), dtype=torch.uint8, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        if hs:
            y = torch.empty((h, w), dtype=torch.uint8, device=self.device)
            cb, cr = (torch.empty((ch, cw), dtype=torch.uint8, device=self.device)
                      for _ in range(2))
            st = lib.ic_decode_planes(self.handle, data, n, y.data_ptr(), w,
                                      cb.data_ptr(), cr.data_ptr(), cw, stream)
        else:
            st = lib.ic_decode(self.handle, data, n, int(bgr), img.data_ptr(), 3 * w,
                               stream)
        if st:
            if st < 1000 and lib.ic_undecodable(st):
                return None
            raise RuntimeError(f"nvJPEG decode failed: {_status(st)}")
        if hs:
            image_cuda.ycc_to_rgb(y, cb, cr, img, hs, vs, bgr)
        return img


class CardPipeline:
    """NativePipeline's five calls with the decode and the placement on
    the card (`.stager == "nvjpeg"`): each file's bytes are read in a
    host thread into that thread's pinned buffer, decoded by nvJPEG into
    device memory (the entropy decode on the host, in the thread, the
    rest on the card) and placed into the batch by the kernels of
    ops/image_cuda.py, which compute what csrc/image_pipeline.cc computes.
    Each thread works on its own stream; the batch is allocated on the
    caller's stream, which waits for every decode stream's event before
    the call returns, and `record_stream` tells the caching allocator.

    The batch and the per-image rows come back as NativePipeline's, with
    the batch a uint8 tensor on the device. A file nvJPEG does not read
    (PNG, BMP, CMYK, ...) is decoded by cv2.imread and placed by the same
    fill function as NativePipeline's fallback, then copied up; such files
    are counted in `.fallbacks`. A fault of the library or of a launch
    raises. The chroma upsampling and colour conversion are libjpeg's
    (ops/image_cuda.py::ycc_to_rgb), the IDCT nvJPEG's, so the pixels
    differ from libjpeg's by its rounding; the placement is exact."""

    stager = "nvjpeg"

    def __init__(self, input_size: int, threads: int = 8,
                 allow_upscale: bool = False, device="cuda"):
        import torch

        from tpu_yolo_torch.ops import image_cuda

        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CardPipeline runs on a CUDA device, not {self.device}")
        lib = image_cuda.library()   # built here: a failure raises now
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.input_size = input_size
        self.allow_upscale = allow_upscale
        self.threads = max(threads, 1)
        self.fallbacks = 0
        self._free: queue.Queue = queue.Queue()
        self._decoders = [_Decoder(self.device, lib) for _ in range(self.threads)]
        for d in self._decoders:
            self._free.put(d)
        self._pool = ThreadPoolExecutor(self.threads)

    def close(self):
        self._pool.shutdown(wait=True)

    def _out(self, out, n: int, size: int):
        import torch

        if out is None:
            return torch.empty((n, size, size, 3), dtype=torch.uint8,
                               device=self.device)
        if (not isinstance(out, torch.Tensor) or tuple(out.shape) != (n, size, size, 3)
                or out.dtype != torch.uint8 or out.device != self.device
                or not out.is_contiguous()):
            raise ValueError(f"the batch must be a contiguous ({n}, {size}, {size}, "
                             f"3) uint8 tensor on {self.device}")
        return out

    def _run(self, items, size: int, mode, out=None, interps=None,
             bgr: bool = False, fill_one=None):
        """Decode and place `items` (paths, or bytes for load_one) into
        `out`; returns (out, rows (n, 5 or 4), indices nvJPEG did not
        read). `mode`: "letterbox" or image_cuda's RAW / SCALED / EVAL."""
        import torch

        from tpu_yolo_torch.ops import image_cuda

        n = len(items)
        out = self._out(out, n, size)
        width = 5 if mode == "letterbox" else 4
        rows = np.zeros((n, width), np.float32)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))

        def one(i):
            dec = self._free.get()
            try:
                nbytes = dec.read(items[i])
                with torch.cuda.device(self.device), torch.cuda.stream(dec.stream):
                    dec.stream.wait_event(ready)   # the batch's last readers
                    img = dec.decode(nbytes, bgr)
                    if img is not None:
                        out.record_stream(dec.stream)
                        rows[i] = image_cuda.place_image(
                            img, out[i], mode, size,
                            image_cuda.LINEAR if interps is None else int(interps[i]),
                            self.allow_upscale)
                    dec.done.record(dec.stream)
                    return img is not None
            except OSError:
                return False
            finally:
                self._free.put(dec)

        ok = list(self._pool.map(one, range(n)))
        consumer = torch.cuda.current_stream(self.device)
        for dec in self._decoders:
            consumer.wait_event(dec.done)
        bad = [i for i, good in enumerate(ok) if not good]
        return out, rows, bad

    def _staged(self, paths, stage: int, mode: int, fill_one, out=None,
                interps=None, bgr: bool = False):
        """A staging call: (batch, dims (N, 4), n_failures), the files
        nvJPEG did not read decoded by cv2 and placed by `fill_one`."""
        out, dims, bad = self._run(paths, stage, mode, out, interps, bgr)
        return out, dims, self._fallback(paths, bad, out, dims, fill_one)

    def _fallback(self, paths, bad, out, rows, fill_one) -> int:
        """NativePipeline._fallback for the card: cv2 decodes, `fill_one`
        places into a host slot, which is copied up. Returns how many cv2
        could not read either (zeroed, rows[i, 0] = -1)."""
        import cv2
        import torch

        remaining = 0
        for i in bad:
            img = cv2.imread(paths[i])   # BGR, any format cv2 knows
            if img is None:
                out[i].zero_()
                rows[i] = 0
                rows[i, 0] = -1
                remaining += 1
                continue
            self.fallbacks += 1
            slot = np.empty(tuple(out.shape[1:]), np.uint8)
            fill_one(img, slot, rows[i], i)
            out[i].copy_(torch.from_numpy(slot))
        return remaining

    def load_one(self, jpeg_bytes: bytes):
        """NativePipeline.load_one on the card: (letterboxed (S, S, 3)
        uint8 tensor, meta dict). Raises ValueError on bytes nvJPEG does
        not read."""
        out, metas, bad = self._run([bytes(jpeg_bytes)], self.input_size, "letterbox")
        if bad:
            raise ValueError("JPEG decode failed")
        m = metas[0]
        return out[0], {"ratio": float(m[0]), "pad_w": float(m[1]),
                        "pad_h": float(m[2]), "orig_w": int(m[3]), "orig_h": int(m[4])}

    def load_batch(self, paths: list[str], out=None):
        """NativePipeline.load_batch on the card: (batch, metas (N, 5),
        n_failures)."""
        s = self.input_size
        out, metas, bad = self._run(paths, s, "letterbox", out)
        return out, metas, self._fallback(
            paths, bad, out, metas, fb_letterbox(s, self.allow_upscale))

    def load_batch_eval(self, paths: list[str], stage: int, out=None):
        """NativePipeline.load_batch_eval on the card."""
        from tpu_yolo_torch.ops.image_cuda import EVAL

        return self._staged(paths, stage, EVAL, fb_eval(stage), out)

    def load_batch_raw(self, paths: list[str], stage: int, out=None):
        """NativePipeline.load_batch_raw on the card."""
        from tpu_yolo_torch.ops.image_cuda import RAW

        return self._staged(paths, stage, RAW, fb_raw(stage), out)

    def load_batch_scaled(self, paths: list[str], stage: int, interps=None,
                          out=None, bgr: bool = False):
        """NativePipeline.load_batch_scaled on the card (per-image interps,
        BGR order with bgr=True)."""
        from tpu_yolo_torch.ops.image_cuda import SCALED

        return self._staged(paths, stage, SCALED, fb_scaled(stage, interps, bgr),
                            out, interps, bgr)


def staging_pipeline(input_size: int, threads: int = 8, device=None):
    """The staging pipeline for `device`: CardPipeline on a CUDA device
    (a build or launch failure raises); elsewhere NativePipeline where the
    host data library loads, else Cv2Pipeline. Each offers load_batch_raw
    and load_batch_scaled, and says which it is in `.stager`."""
    if device is not None and str(device).startswith("cuda"):
        return CardPipeline(input_size, threads=threads, device=device)
    if available():
        return NativePipeline(input_size, threads=threads)
    return Cv2Pipeline(threads)


class NativeEvalLoader:
    """Eval data loader over the native or the card pipeline, a drop-in
    for data/loader.py::DataLoader in eval/evaluator.py::evaluate: yields
    (images (B, S, S, 3) uint8 RGB, targets {"cls", "box", "idx"}) in
    dataset order, the images a host array (NativePipeline) or a tensor
    on the card (CardPipeline). The label geometry is the denorm_corners
    / corners_to_norm math of the Python dataset's eval branch, from the
    returned dims; pixel values differ from cv2's only by the decoder
    and bilinear rounding (JPEG), and not at all through the cv2
    fallback. `stager` names the pipeline.

    One batch is prefetched in a background thread, so decode overlaps
    the device forward (the evaluator double-buffers on top).
    """

    def __init__(self, dataset, batch_size: int, threads: int = 8,
                 prefetch: int = 2, shard=None, pipeline=None):
        """`shard`: (index, count) to decode and yield only that contiguous
        part of each batch (data/loader.py::shard_rows). `pipeline`: the
        pipeline to decode with, a NativePipeline by default."""
        self.dataset = dataset          # DetectionDataset(augment=False)
        self.batch_size = batch_size
        self.shard = shard
        self.input_size = dataset.input_size
        self.pipe = (pipeline if pipeline is not None
                     else NativePipeline(self.input_size, threads=threads))
        self.stager = self.pipe.stager
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
