"""Image decode and placement on the card: the hand-written kernels of
csrc/image_card.cu, their plain PyTorch versions, and the host geometry
that drives them.

These are the card's counterparts of the host C++ data path,
csrc/image_pipeline.cc (the port's copy of the JAX package's), not of a
TPU kernel:
  * `ycc_to_rgb`: the end of libjpeg's decode (the host copy's
    decode_jpeg_rgb) over nvJPEG's planar YCbCr: jdsample.c's "fancy"
    upsampling of 4:2:2 and 4:2:0 chroma and jdcolor.c's fixed-point
    YCbCr -> RGB; integer arithmetic, so exact;
  * `resize_bilinear`: `resize_bilinear_rgb` (image_pipeline.cc:115),
    two-pass fixed-point bilinear with 11-bit coefficients and the
    +2^21 >> 22 rounding; integer arithmetic, so exact;
  * `resize_generic`: `resize_generic_rgb` (image_pipeline.cc:269), the
    separable float resampler for nearest, cubic, area (shrink) and
    lanczos4, with its taps from `make_taps`, a port of the C++'s, on the
    host;
  * `place`: the fills, the zeroed slot around an image placed at (top,
    left) in an (S, S, 3) uint8 buffer: the letterbox's centred placement
    with the round(x -/+ 0.1) pad split, the raw and scaled stagings'
    top-left one.
`place_image` composes them as the C++ staging calls do for one decoded
image, with the geometry of `letterbox_geometry` / `staged_geometry`.

The host copy is built without FMA contraction (cuda_build.HOST_FLAGS),
the kernels with -fmad=false, and the plain versions run every product
and sum as its own PyTorch operation: all three round each float and
double operation as the C++ source writes it, so kernel, plain version
and host copy agree bit for bit. The plain versions are for the CPU and
for the comparisons on the card; a wrapper takes its plain version only
for a CPU tensor, and on a CUDA tensor launches its kernel or raises.
Each wrapper counts its launches in `.launches`. The kernels are bound
by bytes (each reads its source and writes its output once), one block
per output row: simple, not yet fast.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from tpu_yolo_torch.ops import cuda_build

NEAREST, LINEAR, CUBIC, AREA, LANCZOS4 = range(5)   # cv2's interpolation codes
_BITS = 11                                           # bilinear coefficient bits
_ONE = 1 << _BITS
_F32 = np.float32

_count_lock = threading.Lock()


def _count(name: str) -> None:
    """One more launch of the wrapper `name`'s kernel, on the wrapper's own
    function object (decode threads call the wrappers at once)."""
    with _count_lock:
        _WRAPPERS[name].launches += 1


# -- host geometry, as the C++ computes it ---------------------------------

def _lround(x: float) -> int:
    """C's lround/lroundf: halves away from zero, exactly."""
    a = abs(float(x))
    r = math.floor(a)
    if a - r >= 0.5:
        r += 1
    return int(math.copysign(r, x))


def letterbox_geometry(w: int, h: int, size: int, allow_upscale: bool):
    """image_pipeline.cc::letterbox_geom in float32: (new_w, new_h, top,
    left, ratio, pad_w, pad_h) of the one-resize centred letterbox."""
    rw, rh = _F32(size) / _F32(w), _F32(size) / _F32(h)
    r = rw if rw < rh else rh
    if not allow_upscale and r > 1:
        r = _F32(1)
    new_w, new_h = _lround(_F32(w) * r), _lround(_F32(h) * r)
    pad_w, pad_h = _F32(size - new_w) / _F32(2), _F32(size - new_h) / _F32(2)
    top, left = _lround(pad_h - _F32(0.1)), _lround(pad_w - _F32(0.1))
    return new_w, new_h, top, left, float(r), float(pad_w), float(pad_h)


RAW, SCALED, EVAL = 0, 1, 2   # the C++ staging calls' scale_mode


def staged_geometry(w: int, h: int, stage: int, mode: int):
    """image_pipeline.cc::load_batch_staged's geometry: (sh, sw, top, left,
    resize?). RAW pre-shrinks an image longer than the stage (rounded
    dims); SCALED resizes the long side to the stage (truncated dims);
    EVAL does that and centres it with the round(pad - 0.1) split."""
    long_side = max(h, w)
    resize = long_side != stage if mode != RAW else (h > stage or w > stage)
    sh, sw = h, w
    if resize:
        d = stage / long_side
        if mode != RAW:
            sh, sw = int(h * d), int(w * d)
        else:
            sh, sw = _lround(h * d), _lround(w * d)
        sh, sw = min(max(sh, 1), stage), min(max(sw, 1), stage)
    top = left = 0
    if mode == EVAL:
        top = _lround(_F32(stage - sh) / _F32(2) - _F32(0.1))
        left = _lround(_F32(stage - sw) / _F32(2) - _F32(0.1))
    return sh, sw, top, left, resize


def uses_bilinear(interp: int, sw: int, sh: int, dw: int, dh: int) -> bool:
    """Whether resize_generic_rgb takes its fixed-point bilinear path:
    linear, and area when either axis enlarges (as cv2.resize does)."""
    return interp == LINEAR or (interp == AREA and not (sw >= dw and sh >= dh))


@functools.lru_cache(maxsize=256)
def make_taps(interp: int, src: int, dst: int):
    """image_pipeline.cc::make_taps in double, the weights rounded to
    float32: (first source index (dst,) int32, weights (dst, support)
    float32). Python's floats and `math` are the C++'s doubles and libm."""
    scale = src / dst
    if interp == AREA and scale >= 1.0:
        sup = int(math.ceil(scale)) + 1
        first = np.zeros(dst, np.int32)
        w = np.zeros((dst, sup), np.float32)
        for x in range(dst):
            lo, hi = x * scale, (x + 1) * scale
            f = min(int(math.floor(lo)), src - 1)
            first[x] = f
            for t in range(sup):
                sx = f + t
                if sx >= src:
                    break
                ov = min(hi, sx + 1) - max(lo, sx)
                if ov > 0:
                    w[x, t] = ov / scale
        return first, w
    if interp == NEAREST:
        first = np.array([min(int(math.floor(x * scale)), src - 1)
                          for x in range(dst)], np.int32)
        return first, np.ones((dst, 1), np.float32)
    sup = {CUBIC: 4, LANCZOS4: 8}.get(interp, 2)
    first = np.zeros(dst, np.int32)
    w = np.zeros((dst, sup), np.float32)
    a = -0.75   # cv2 interpolateCubic
    for x in range(dst):
        fx = (x + 0.5) * scale - 0.5
        x0 = int(math.floor(fx))
        d = fx - x0
        if sup == 2:
            first[x] = x0
            w[x] = (1.0 - d, d)
        elif sup == 4:
            first[x] = x0 - 1
            w0 = _F32(((a * (d + 1) - 5 * a) * (d + 1) + 8 * a) * (d + 1) - 4 * a)
            w1 = _F32(((a + 2) * d - (a + 3)) * d * d + 1)
            w2 = _F32(((a + 2) * (1 - d) - (a + 3)) * (1 - d) * (1 - d) + 1)
            w[x] = (w0, w1, w2, _F32(1) - w0 - w1 - w2)
        else:
            first[x] = x0 - 3
            if d < 1e-12:
                wd, total = [0.0] * 3 + [1.0] + [0.0] * 4, 1.0
            else:
                wd, total = [], 0.0
                for t in range(8):
                    px = math.pi * (d - (t - 3))
                    wd.append(math.sin(px) * math.sin(px / 4.0) * 16.0 / (px * px))
                    total += wd[-1]
            w[x] = [v / total for v in wd]
    return first, w


# -- plain versions ----------------------------------------------------------

_SUBSAMPLINGS = ((1, 1), (2, 1), (2, 2))   # (hs, vs): 4:4:4, 4:2:2, 4:2:0
# jdcolor.c's tables, computed: FIX(v) = int(v * 65536 + 0.5)
_CR_R, _CB_B, _CR_G, _CB_G, _HALF = 91881, 116130, -46802, -22554, 1 << 15


def _fancy_plain(c, h: int, w: int, hs: int, vs: int):
    """(ch, cw) uint8 chroma -> (h, w) int64 by libjpeg's fancy
    upsampling (jdsample.c h2v2 / h2v1, the edge rows and columns their
    own neighbours); chroma two samples wide or less is replicated, as
    libjpeg-turbo does."""
    ch, cw = c.shape
    c = c.to(torch.int64)
    dev = c.device
    if hs == 2 and cw <= 2:
        return c[torch.arange(h, device=dev) // vs][:, torch.arange(w, device=dev) // 2]
    if vs == 2:
        y = torch.arange(h, device=dev)
        c0 = y // 2
        c1 = torch.where(y % 2 == 1, c0 + 1, c0 - 1).clamp(0, ch - 1)
        near, far = c[c0], c[c1]
    else:
        near = far = c
    if hs == 1:
        return near
    x = torch.arange(w, device=dev)
    cx, odd = x // 2, x % 2
    n = torch.where(odd == 1, cx + 1, cx - 1).clamp(0, cw - 1)
    if vs == 2:
        sums = near * 3 + far
        return (sums[:, cx] * 3 + sums[:, n] + 8 - odd) >> 4
    return (near[:, cx] * 3 + near[:, n] + 1 + odd) >> 2


def ycc_to_rgb_plain(y, cb, cr, hs: int, vs: int, bgr: bool = False):
    """Planar Y (h, w) and Cb, Cr (ceil(h/vs), ceil(w/hs)) uint8 -> (h, w,
    3) uint8 RGB (BGR with `bgr`), as libjpeg ends its decode: fancy
    upsampling, then ycc_rgb_convert's 16-bit fixed point with arithmetic
    right shifts, clamped."""
    h, w = y.shape
    luma = y.to(torch.int64)
    b = _fancy_plain(cb, h, w, hs, vs) - 128
    r = _fancy_plain(cr, h, w, hs, vs) - 128
    red = luma + ((_CR_R * r + _HALF) >> 16)
    green = luma + ((_CB_G * b + _HALF + _CR_G * r) >> 16)
    blue = luma + ((_CB_B * b + _HALF) >> 16)
    chans = (blue, green, red) if bgr else (red, green, blue)
    return torch.stack(chans, -1).clamp(0, 255).to(torch.uint8)


def _bilinear_axis(src: int, dst: int, device):
    """Per output coordinate: (i0, i1, fixed-point weight of i1), in
    double as the C++ computes them."""
    f = (torch.arange(dst, dtype=torch.float64, device=device) + 0.5) * (src / dst) - 0.5
    f = f.clamp(min=0)
    i0 = f.to(torch.int64).clamp(max=src - 1)
    i1 = torch.where(i0 + 1 < src, i0 + 1, src - 1)
    return i0, i1, ((f - i0) * _ONE + 0.5).to(torch.int64)


def resize_bilinear_plain(src, dh: int, dw: int):
    """(sh, sw, 3) uint8 -> (dh, dw, 3) uint8: the fixed-point bilinear of
    resize_bilinear_rgb, in int64 (the C++'s int32 never overflows)."""
    sh, sw = src.shape[:2]
    x0, x1, fx = _bilinear_axis(sw, dw, src.device)
    y0, y1, fy = _bilinear_axis(sh, dh, src.device)
    s = src.to(torch.int64)
    rows = s[:, x0] * (_ONE - fx)[:, None] + s[:, x1] * fx[:, None]   # (sh, dw, 3)
    v = (rows[y0] * (_ONE - fy)[:, None, None] + rows[y1] * fy[:, None, None]
         + (1 << (2 * _BITS - 1)))
    return (v >> (2 * _BITS)).to(torch.uint8)


def resize_generic_plain(src, dh: int, dw: int, interp: int):
    """(sh, sw, 3) uint8 -> (dh, dw, 3) uint8 by the separable float
    resampler of resize_generic_rgb (nearest, cubic, area-shrink,
    lanczos4): a horizontal pass into float32, then a vertical one, each
    sum taken tap by tap as the C++ loop does, then +0.5, clamp and
    truncation."""
    sh, sw = src.shape[:2]
    dev = src.device
    fx, wx = (torch.from_numpy(a).to(dev) for a in make_taps(interp, sw, dw))
    fy, wy = (torch.from_numpy(a).to(dev) for a in make_taps(interp, sh, dh))
    ix = (fx[:, None].long() + torch.arange(wx.shape[1], device=dev)).clamp(0, sw - 1)
    iy = (fy[:, None].long() + torch.arange(wy.shape[1], device=dev)).clamp(0, sh - 1)
    tmp = torch.zeros((sh, dw, 3), dtype=torch.float32, device=dev)
    for t in range(wx.shape[1]):
        tmp = tmp + wx[:, t, None] * src[:, ix[:, t]].float()
    acc = torch.zeros((dh, dw, 3), dtype=torch.float32, device=dev)
    for t in range(wy.shape[1]):
        acc = acc + wy[:, t, None, None] * tmp[iy[:, t]]
    v = acc + 0.5
    return torch.where(v <= 0, 0.0, torch.where(v >= 255, 255.0, v)).to(torch.uint8)


def place_plain(out, top: int, left: int, h: int, w: int, src=None):
    """The fill: `out` (H, W, 3) zeroed outside rows [top, top+h) and
    columns [left, left+w); `src` (h, w, 3), when given, copied inside."""
    inside = out[top:top + h, left:left + w]
    kept = src if src is not None else inside.clone()
    out.zero_()
    out[top:top + h, left:left + w] = kept


# -- kernels -------------------------------------------------------------------

def library():
    """The card's image library (csrc/image_card.cu: nvJPEG decode and the
    placement kernels), built at its first use; raises with nvcc's
    message where it cannot be built."""
    lib = cuda_build.load("image_card", ("-fmad=false",), ("-lnvjpeg",))
    if not getattr(lib, "typed", False):   # set last: decode threads call this
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        lib.ic_ycc_rgb.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, p, i, p]
        lib.ic_resize_bilinear.argtypes = [p, i, i, p, i, i, i, p]
        lib.ic_resize_generic.argtypes = [p, i, i, p, i, i, i, p, p, i, p, p, i, p, p]
        lib.ic_place.argtypes = [p, i, i, p, i, i, i, i, p]
        lib.ic_decoder_create.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.ic_decoder_create.restype = p
        lib.ic_decoder_destroy.argtypes = [p]
        lib.ic_decoder_destroy.restype = None
        lib.ic_image_info.argtypes = [p, p, ctypes.c_size_t] + [ip] * 7
        lib.ic_decode.argtypes = [p, p, ctypes.c_size_t, i, p, i, p]
        lib.ic_decode_planes.argtypes = [p, p, ctypes.c_size_t, p, i, p, p, i, p]
        lib.ic_undecodable.argtypes = [i]
        for fn in (lib.ic_ycc_rgb, lib.ic_resize_bilinear, lib.ic_resize_generic,
                   lib.ic_place, lib.ic_image_info, lib.ic_decode,
                   lib.ic_decode_planes, lib.ic_undecodable):
            fn.restype = ctypes.c_int
        lib.typed = True
    return lib


def build() -> str:
    """Compile csrc/image_card.cu now; returns nvcc's ptxas report."""
    return cuda_build.build("image_card", ("-fmad=false",), ("-lnvjpeg",))[1]


def _check_image(t, what: str, dtype=torch.uint8):
    if t.dtype != dtype or t.dim() != 3 or t.shape[2] != 3 or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (H, W, 3) {dtype} tensor, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{what}: tensor not 16-byte aligned")


def _check_target(src, out, dh: int, dw: int, top: int, left: int, what: str):
    _check_image(src, f"{what} source")
    _check_image(out, f"{what} output")
    if src.device != out.device:
        raise ValueError(f"{what}: source on {src.device}, output on {out.device}")
    if (min(dh, dw, src.shape[0], src.shape[1]) < 1 or top < 0 or left < 0
            or top + dh > out.shape[0] or left + dw > out.shape[1]):
        raise ValueError(f"{what}: a ({dh}, {dw}) image at ({top}, {left}) does "
                         f"not fit {tuple(out.shape)}, or the source "
                         f"{tuple(src.shape)} is empty")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ycc_to_rgb(y, cb, cr, out, hs: int, vs: int, bgr: bool = False):
    """Write the RGB (BGR with `bgr`) image of planar Y (h, w) and Cb, Cr
    (ceil(h/vs), ceil(w/hs)) uint8, subsampled (hs, vs) in (1, 1), (2, 1)
    or (2, 2), into `out` (h, w, 3) uint8 on the same device: libjpeg's
    fancy upsampling and colour conversion. Returns out."""
    _check_image(out, "ycc_to_rgb output")
    h, w = out.shape[:2]
    if (hs, vs) not in _SUBSAMPLINGS:
        raise ValueError(f"ycc_to_rgb: no subsampling ({hs}, {vs})")
    chroma = (-(-h // vs), -(-w // hs))
    for t, name, shape in ((y, "Y", (h, w)), (cb, "Cb", chroma), (cr, "Cr", chroma)):
        if (t.dtype != torch.uint8 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != out.device):
            raise ValueError(f"ycc_to_rgb: {name} must be a contiguous {shape} uint8 "
                             f"tensor on {out.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"ycc_to_rgb: {name} not 16-byte aligned")
    if out.device.type == "cpu":
        out.copy_(ycc_to_rgb_plain(y, cb, cr, hs, vs, bgr))
        return out
    with torch.cuda.device(out.device):
        err = library().ic_ycc_rgb(
            y.data_ptr(), w, cb.data_ptr(), cr.data_ptr(), chroma[1], chroma[1],
            chroma[0], w, h, hs, vs, int(bgr), out.data_ptr(), w * 3, _stream(out))
    cuda_build.check(err, "ycc_to_rgb")
    _count("ycc_to_rgb")
    return out


def resize_bilinear(src, out, dh: int, dw: int, top: int = 0, left: int = 0):
    """Write the fixed-point bilinear resize of `src` (sh, sw, 3) uint8 to
    (dh, dw) into out[top:top+dh, left:left+dw], `out` an (H, W, 3) uint8
    buffer on the same device. Returns out."""
    _check_target(src, out, dh, dw, top, left, "resize_bilinear")
    if out.device.type == "cpu":
        out[top:top + dh, left:left + dw] = resize_bilinear_plain(src, dh, dw)
        return out
    with torch.cuda.device(out.device):
        err = library().ic_resize_bilinear(
            src.data_ptr(), src.shape[1], src.shape[0],
            out.data_ptr() + (top * out.shape[1] + left) * 3, out.shape[1] * 3,
            dw, dh, _stream(out))
    cuda_build.check(err, "resize_bilinear")
    _count("resize_bilinear")
    return out


def resize_generic(src, out, dh: int, dw: int, interp: int, top: int = 0,
                   left: int = 0):
    """As resize_bilinear, by the separable float resampler with cv2's
    `interp` (NEAREST, CUBIC, LANCZOS4, or AREA shrinking both axes: the
    cases that uses_bilinear leaves to it)."""
    _check_target(src, out, dh, dw, top, left, "resize_generic")
    sh, sw = src.shape[:2]
    if interp not in (NEAREST, CUBIC, AREA, LANCZOS4) or uses_bilinear(
            interp, sw, sh, dw, dh):
        raise ValueError(f"resize_generic: interp {interp} at ({sh}, {sw}) -> "
                         f"({dh}, {dw}) is resize_bilinear's")
    if out.device.type == "cpu":
        out[top:top + dh, left:left + dw] = resize_generic_plain(src, dh, dw, interp)
        return out
    dev = out.device
    fx, wx = (torch.from_numpy(a).to(dev) for a in make_taps(interp, sw, dw))
    fy, wy = (torch.from_numpy(a).to(dev) for a in make_taps(interp, sh, dh))
    tmp = torch.empty((sh, dw, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().ic_resize_generic(
            src.data_ptr(), sw, sh,
            out.data_ptr() + (top * out.shape[1] + left) * 3, out.shape[1] * 3,
            dw, dh, fx.data_ptr(), wx.data_ptr(), wx.shape[1],
            fy.data_ptr(), wy.data_ptr(), wy.shape[1], tmp.data_ptr(), _stream(out))
    cuda_build.check(err, "resize_generic")
    _count("resize_generic")
    return out


def place(out, top: int, left: int, h: int, w: int, src=None):
    """The fill of one slot: `out` (H, W, 3) uint8 zeroed around the
    (h, w) image at (top, left); `src` (h, w, 3) uint8, when given,
    copied there (else what is there is kept). Returns out."""
    _check_image(out, "place output")
    if src is not None:
        _check_image(src, "place source")
        if tuple(src.shape[:2]) != (h, w) or src.device != out.device:
            raise ValueError(f"place: source {tuple(src.shape)} on {src.device} "
                             f"is not ({h}, {w}, 3) on {out.device}")
    if min(h, w) < 1 or top < 0 or left < 0 or top + h > out.shape[0] \
            or left + w > out.shape[1]:
        raise ValueError(f"place: ({h}, {w}) at ({top}, {left}) does not fit "
                         f"{tuple(out.shape)}")
    if out.device.type == "cpu":
        place_plain(out, top, left, h, w, src)
        return out
    with torch.cuda.device(out.device):
        err = library().ic_place(
            0 if src is None else src.data_ptr(), h, w, out.data_ptr(),
            out.shape[0], out.shape[1], top, left, _stream(out))
    cuda_build.check(err, "place")
    _count("place")
    return out


_WRAPPERS = {f.__name__: f for f in (ycc_to_rgb, resize_bilinear, resize_generic,
                                      place)}
for _f in _WRAPPERS.values():
    _f.launches = 0


def resize_into(src, out, dh: int, dw: int, interp: int = LINEAR, top: int = 0,
                left: int = 0):
    """resize_generic_rgb's dispatch: the fixed-point bilinear for linear
    and area-enlarge, the float resampler for the rest."""
    sh, sw = src.shape[:2]
    if uses_bilinear(interp, sw, sh, dw, dh):
        return resize_bilinear(src, out, dh, dw, top, left)
    return resize_generic(src, out, dh, dw, interp, top, left)


def place_image(img, slot, mode: int, size: int, interp: int = LINEAR,
                allow_upscale: bool = False):
    """One decoded image `img` (h, w, 3) uint8 placed into `slot` (S, S,
    3) uint8 on its device, as the host C++ places it: mode "letterbox"
    (load_batch / load_one: one bilinear resize to the letterbox size,
    centred; returns meta [ratio, pad_w, pad_h, orig_w, orig_h]) or RAW,
    SCALED, EVAL (the staging calls; returns dims [staged_h, staged_w,
    orig_h, orig_w]); `interp` for SCALED only."""
    h, w = img.shape[:2]
    if mode == "letterbox":
        nw, nh, top, left, r, pw, ph = letterbox_geometry(w, h, size, allow_upscale)
        resize, interp, row = (nw, nh) != (w, h), LINEAR, (r, pw, ph, w, h)
    else:
        nh, nw, top, left, resize = staged_geometry(w, h, size, mode)
        row = (nh, nw, h, w)
        if mode != SCALED:
            interp = LINEAR
    if resize:
        resize_into(img, slot, nh, nw, interp, top, left)
        place(slot, top, left, nh, nw)
    else:
        place(slot, top, left, nh, nw, img)
    return np.array(row, np.float32)
