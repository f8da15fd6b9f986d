"""Train augmentation on the card: mosaic + affine + HSV + flips
(counterpart of `tpu_yolo/ops/augment_device.py`).

The host draws every random number and computes the labels
(data/device_augment.py); it ships raw staged uint8 sources and each
image's transform parameters, and these programs do all the pixel work.

With the default hyperparameters (degrees = shear = 0) the mosaic
placement and the random affine are axis-aligned maps (scale and
translate), so the whole 4-sources -> output transform is separable: four
masked R_y^k · src_k · R_x^kᵀ resamples, summed. Each mosaic quadrant is
an axis-aligned rectangle of the 2S canvas, so its indicator factorizes
per axis, and placement and affine compose into one scale and offset per
axis and source; the canvas is never built. Rotation or shear makes the
map non-separable: the `*_general` programs then gather four bilinear
taps per output pixel.

Every program takes its parameters as a dict of tensors on the images'
device (flips bool or 0/1), runs under no_grad, and returns (B, S, S, 3)
uint8 RGB, the image contract of the host dataset's __getitem__. The
arithmetic is the JAX package's, operation by operation: bf16 taps,
products in f32 (ops/letterbox.py), rounding to the uint8 grid where the
host path's cv2 calls emit uint8, HSV by the LUT semantics of
data/augment.py::hsv_jitter.
"""
from __future__ import annotations

import torch

from tpu_yolo_torch.ops.letterbox import (fma, letterbox_batch, scatter_taps,
                                          separable_resample)


def _affine_taps(out_size: int, src_size: int, inv_scale, offset, lo, hi):
    """(N, out_size, src_size) bilinear tap matrices of the integer-grid
    map x_src = i * inv_scale + offset (cv2.warpAffine convention: no
    half-pixel shift, unlike cv2.resize), constant-0 border: taps whose
    source index falls outside [lo, hi) contribute nothing. All
    arguments but the sizes are (N,) f32."""
    i = torch.arange(out_size, dtype=torch.float32, device=inv_scale.device)
    s = fma(i, inv_scale[:, None], offset[:, None])
    s0 = torch.floor(s)
    w1 = s - s0
    w0 = 1.0 - w1
    taps = []
    for t, w in ((s0, w0), (s0 + 1, w1)):
        valid = ((t >= lo[:, None]) & (t < hi[:, None])
                 & (t >= 0) & (t < src_size))
        taps.append((t.clamp(0, src_size - 1).long(),
                     torch.where(valid, w, 0.0).to(torch.bfloat16).float()))
    return scatter_taps(out_size, src_size, taps)


def _mosaic_affine(srcs, inv_scale, off_x, off_y, lo_x, hi_x, lo_y, hi_y,
                   out_size: int):
    """Compose each image from its staged sources.

    srcs: (B, Q, St, St, 3) uint8; inv_scale (B,); off/lo/hi (B, Q):
      x_src = x_out * inv_scale + off_x[:, k], valid cols [lo_x, hi_x)
    (the host composes placement and affine into these,
    data/device_augment.py). Returns (B, 3, S, S) f32 in [0, 255]."""
    b, q, st = srcs.shape[:3]
    isc = inv_scale.reshape(b, 1).expand(b, q).reshape(-1)
    ry = _affine_taps(out_size, st, isc, off_y.reshape(-1), lo_y.reshape(-1),
                      hi_y.reshape(-1))
    rx = _affine_taps(out_size, st, isc, off_x.reshape(-1), lo_x.reshape(-1),
                      hi_x.reshape(-1))
    parts = separable_resample(ry, srcs.reshape(b * q, st, st, 3), rx)
    del ry, rx
    return parts.view(b, q, 3, out_size, out_size).sum(1).clamp_(0.0, 255.0)


def _hue(r, g, b):
    """cv2's uint8 hue (0..179) of float RGB channels on the uint8 grid."""
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(diff > 0, diff, 1.0)
    h = torch.where(
        v == r, 60.0 * (g - b) / safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff > 0, torch.where(h < 0, h + 360.0, h), 0.0)
    return torch.remainder(torch.round(h / 2.0), 180.0)


def _hsv(r, g, b, gain_h, gain_s, gain_v, hue_rgb=None):
    """HSV jitter of float RGB channels on the uint8 grid; the gains
    broadcast against the channels. `hue_rgb`, when given, are the
    channels the hue is read from (see plain_augment_batch_general).
    Returns (r, g, b)."""
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    h_u8 = _hue(*(hue_rgb if hue_rgb is not None else (r, g, b)))
    s_u8 = torch.round(torch.where(v > 0, 255.0 * diff / torch.clamp(v, min=1.0),
                                   0.0))
    v_u8 = v                                                 # already on the grid

    h2 = torch.floor(torch.remainder(h_u8 * gain_h, 180.0))  # LUTs truncate
    s2 = torch.floor(torch.clamp(s_u8 * gain_s, 0.0, 255.0))
    v2 = torch.floor(torch.clamp(v_u8 * gain_v, 0.0, 255.0))

    # HSV (uint8 grid) -> RGB, cv2 semantics: H2*2 degrees, S in [0, 1];
    # a division by a constant is a product with its f32 reciprocal, as
    # XLA compiles it (Python rounds 1/60 and 1/255 to the same f32)
    hh = h2 * 2.0 * (1.0 / 60.0)
    i = torch.floor(hh)
    f = hh - i
    sf = s2 * (1.0 / 255.0)
    p = v2 * (1.0 - sf)
    q = v2 * fma(-sf, f, 1.0)
    t = v2 * fma(-sf, 1.0 - f, 1.0)
    i = torch.remainder(i, 6.0)

    def select(*values):  # jnp.select over i == 0..5, in order
        out = torch.zeros_like(v2)
        for k in reversed(range(6)):
            out = torch.where(i == k, values[k], out)
        return out

    return (select(v2, q, p, p, t, v2), select(t, v2, v2, q, p, p),
            select(p, p, t, v2, v2, q))


def hsv_jitter_device(img, gains):
    """HSV color jitter with the host path's uint8-LUT semantics
    (data/augment.py::hsv_jitter).

    img: (..., 3) f32 RGB in [0, 255] on the uint8 grid; gains: (..., 3)
    the drawn (r_h, r_s, r_v) multipliers, broadcast over the pixels as a
    (3,) vector broadcasts over (H, W, 3). Channel values are rounded to
    the uint8 grid where cv2 rounds and the LUT outputs truncate; matches
    the cv2 path to a few LSB (fixed-point hue differences)."""
    gains = gains[..., None, None, :]
    out = _hsv(*img.unbind(-1), *gains.unbind(-1))
    return torch.round(torch.stack(out, -1))


def _finish(imgs, params, hue_imgs=None):
    """HSV and flips on (B, 3, S, S) f32 grid values -> (B, S, S, 3)
    uint8, the common tail of every program; the hue is read from
    `hue_imgs` when given."""
    gains = params["hsv_gains"].float()[:, :, None, None]
    hue_rgb = None if hue_imgs is None else hue_imgs.unbind(1)
    imgs = torch.round(torch.stack(
        _hsv(*imgs.unbind(1), *gains.unbind(1), hue_rgb=hue_rgb), 1))
    flip_ud = params["flip_ud"].bool()[:, None, None, None]
    flip_lr = params["flip_lr"].bool()[:, None, None, None]
    imgs = torch.where(flip_ud, imgs.flip(2), imgs)
    imgs = torch.where(flip_lr, imgs.flip(3), imgs)
    return imgs.clamp_(0.0, 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _geometry(srcs, p, out_size):
    return _mosaic_affine(srcs, p["inv_scale"], p["off_x"], p["off_y"],
                          p["lo_x"], p["hi_x"], p["lo_y"], p["hi_y"], out_size)


@torch.no_grad()
def augment_batch(srcs, params, out_size: int = 640):
    """The mosaic program.

    srcs: (B, 4, St, St, 3) uint8 staged sources (long side == St,
    top-left anchored); params: inv_scale (B,),
    off_x/off_y/lo_x/hi_x/lo_y/hi_y (B, 4), hsv_gains (B, 3),
    flip_lr/flip_ud (B,). Returns (B, S, S, 3) uint8 RGB."""
    # the host path rounds to uint8 after the warp, before HSV: the HSV
    # LUT math assumes channel values on the uint8 grid
    return _finish(torch.round(_geometry(srcs, params, out_size)), params)


@torch.no_grad()
def mixup_augment_batch(srcs, params, out_size: int = 640):
    """Mosaic-mixup program: two mosaics composed and Beta-blended.

    Each mosaic is composed and rounded to the uint8 grid (cv2.warpAffine
    emits uint8), blended img1*a + img2*(1-a) and truncated (astype
    uint8 floors), then HSV and flips run once on the blend.
    srcs: (B, 2, 4, St, St, 3) uint8; params: "a", "b" geometry dicts
    (inv_scale (B,), off/lo/hi (B, 4)), "alpha" (B,) Beta(32, 32) draws,
    hsv_gains (B, 3), flip_lr/flip_ud (B,)."""
    c1 = torch.round(_geometry(srcs[:, 0], params["a"], out_size))
    c2 = torch.round(_geometry(srcs[:, 1], params["b"], out_size))
    a = params["alpha"].float()[:, None, None, None]
    return _finish(torch.floor(fma(c1, a, c2 * (1.0 - a))), params)


@torch.no_grad()
def plain_augment_batch(staged, hw, params, out_size: int = 640):
    """The no-mosaic program (the final-epochs mode and mosaic=0):
    letterbox -> random affine (scale + translate) -> HSV -> flips, with
    the host path's two resamples (uint8 rounding between letterbox and
    affine). staged: (B, St, St, 3) uint8 long-side-prescaled sources;
    hw (B, 2) their staged dims; params: inv_scale, off_x, off_y (B,),
    hsv_gains (B, 3), flip_lr/flip_ud (B,)."""
    boxed, _ = letterbox_batch(staged, hw, out_size=out_size,
                               allow_upscale=True)
    z = torch.zeros((len(boxed), 1), dtype=torch.float32, device=boxed.device)
    f = torch.full_like(z, float(out_size))
    imgs = _mosaic_affine(boxed[:, None], params["inv_scale"],
                          params["off_x"][:, None], params["off_y"][:, None],
                          z, f, z, f, out_size)
    return _finish(torch.round(imgs), params)


def _bilinear_gather(srcs, sx, sy, lo_x, hi_x, lo_y, hi_y, x0, y0):
    """Bilinear samples of srcs (N, St, St, 3) at float coordinates sx,
    sy (N, S, S) with a validity window [lo, hi) per axis ((N, 1, 1)
    each): the gather counterpart of the masked-tap resample, for
    rotation and shear. Corner taps outside the window contribute 0
    (cv2.warpAffine's constant-0 border over the canvas). x0, y0 are
    the taps' top-left corners, floor of the coordinates as the caller
    rounds them (_mosaic_affine_general). Returns (N, S, S, 3) f32."""
    n, st = srcs.shape[:2]
    wx, wy = sx - x0, sy - y0
    flat = srcs.reshape(n * st * st, srcs.shape[-1])
    base = (torch.arange(n, device=srcs.device) * (st * st))[:, None, None]
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= lo_x) & (xi < hi_x) & (yi >= lo_y) & (yi < hi_y)
            w = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy) * valid
            xc = xi.clamp(0, st - 1).long()
            yc = yi.clamp(0, st - 1).long()
            vals = flat[(base + yc * st + xc).reshape(-1)].view(*sx.shape, -1)
            taps.append((w[..., None], vals.float()))
    # the sum as XLA's CPU compiler emits it: LLVM contracts the first
    # operand of (w00·v00 + w01·v01) into the FMA, then each further
    # product into the running sum
    (w00, v00), (w01, v01), (w10, v10), (w11, v11) = taps
    return fma(w11, v11, fma(w10, v10, fma(w00, v00, w01 * v01)))


def _canvas_coords(minv, out_size: int, contracted: bool):
    """(xs, ys), each (B, S, S): the canvas coordinate Minv @ (j, i, 1)
    of every output pixel, m·j + m'·i + m''. `contracted` rounds it as
    the JAX program's gather fusion does, where the product with j and
    the first sum share a loop body and LLVM fuses them into one FMA;
    otherwise as its floor fusions do, where the product with j is
    hoisted out of the loop and every operation rounds."""
    j = torch.arange(out_size, dtype=torch.float32, device=minv.device)[None, None, :]
    i = torch.arange(out_size, dtype=torch.float32, device=minv.device)[None, :, None]
    m = minv.float()[:, :, :, None, None]
    if contracted:
        return tuple(fma(m[:, r, 0], j, m[:, r, 1] * i) + m[:, r, 2]
                     for r in (0, 1))
    return tuple(m[:, r, 0] * j + m[:, r, 1] * i + m[:, r, 2] for r in (0, 1))


def _mosaic_affine_general(srcs, minv, shift_x, shift_y, lo_x, hi_x, lo_y,
                           hi_y, out_size: int, weights: str = "contracted",
                           corners: str = "contracted"):
    """General-affine compose (degrees or shear != 0): each output
    pixel's canvas coordinate is Minv @ (x_out, y_out, 1), and quadrant k
    samples its source at canvas - shift_k within its crop window.
    srcs (B, Q, St, St, 3); minv (B, 2, 3); shift/lo/hi (B, Q).
    `weights` and `corners` ("contracted" or "rounded", _canvas_coords)
    say how the coordinates behind the tap weights and behind the taps'
    floor corners are rounded. Returns (B, 3, S, S) f32 in [0, 255]."""
    b, q, st = srcs.shape[:3]
    s = out_size
    coords = {form: _canvas_coords(minv, s, form == "contracted")
              for form in {weights, corners}}

    def per_quadrant(v):
        return v.reshape(b * q, 1, 1)

    def sample(v, shift):                                   # -> (B*Q, S, S)
        return (v[:, None] - shift[:, :, None, None]).reshape(b * q, s, s)

    (xs, ys), (xc, yc) = coords[weights], coords[corners]
    parts = _bilinear_gather(
        srcs.reshape(b * q, st, st, 3), sample(xs, shift_x),
        sample(ys, shift_y), per_quadrant(lo_x), per_quadrant(hi_x),
        per_quadrant(lo_y), per_quadrant(hi_y),
        torch.floor(sample(xc, shift_x)), torch.floor(sample(yc, shift_y)))
    imgs = parts.view(b, q, s, s, 3).sum(1).clamp_(0.0, 255.0)
    return imgs.permute(0, 3, 1, 2)


def _geometry_general(srcs, p, out_size):
    return _mosaic_affine_general(srcs, p["minv"], p["shift_x"], p["shift_y"],
                                  p["lo_x"], p["hi_x"], p["lo_y"], p["hi_y"],
                                  out_size)


@torch.no_grad()
def augment_batch_general(srcs, params, out_size: int = 640):
    """augment_batch for rotation/shear: params hold minv (B, 2, 3)
    canvas<-output inverse affines, shift_x/shift_y/lo_x/hi_x/lo_y/hi_y
    (B, 4), hsv_gains (B, 3), flip_lr/flip_ud (B,)."""
    return _finish(torch.round(_geometry_general(srcs, params, out_size)), params)


@torch.no_grad()
def mixup_augment_batch_general(srcs, params, out_size: int = 640):
    """mixup_augment_batch for rotation/shear: params hold "a"/"b"
    general geometry dicts and alpha/hsv_gains/flips."""
    c1 = torch.round(_geometry_general(srcs[:, 0], params["a"], out_size))
    c2 = torch.round(_geometry_general(srcs[:, 1], params["b"], out_size))
    a = params["alpha"].float()[:, None, None, None]
    return _finish(torch.floor(fma(c1, a, c2 * (1.0 - a))), params)


@torch.no_grad()
def plain_augment_batch_general(staged, hw, params, out_size: int = 640):
    """plain_augment_batch for rotation/shear: the letterbox (the same two
    resamples as the host path), then the full affine by bilinear
    gathers over the one (S, S) letterboxed source."""
    boxed, _ = letterbox_batch(staged, hw, out_size=out_size,
                               allow_upscale=True)
    z = torch.zeros((len(boxed), 1), dtype=torch.float32, device=boxed.device)
    f = torch.full_like(z, float(out_size))
    args = (boxed[:, None], params["minv"], z, z, z, f, z, f, out_size)
    # XLA's CPU compiler computes this program's compose twice, in two
    # fusions that round the canvas coordinates differently: the one the
    # hue reads takes its tap weights from FMA-contracted coordinates and
    # its floor corners from rounded ones; the one that gives value,
    # saturation and the output rounds every coordinate. Bit equality
    # with the JAX program takes both.
    imgs = torch.round(_mosaic_affine_general(*args, weights="rounded",
                                              corners="rounded"))
    hue = torch.round(_mosaic_affine_general(*args, weights="contracted",
                                             corners="rounded"))
    return _finish(imgs, params, hue_imgs=hue)
