"""Device letterbox: aspect-preserving resize and centred pad of a staged
uint8 batch, on the card (counterpart of `tpu_yolo/ops/letterbox.py`).

The host only decodes: each image's raw pixels sit top-left in a fixed
(B, Hs, Ws, 3) staging buffer, its true (h, w) beside it. The geometry is
that of data/image.py's letterbox:
  r = min(S/h, S/w)            (clamped to 1 when allow_upscale=False)
  new = round(dim * r);  pad = (S - new) / 2
  top/left = round(pad - 0.1)
  bilinear taps at half-pixel centres (cv2.INTER_LINEAR), replicate
  borders; a constant fill outside the placed image.

A bilinear resize is separable, so it is two batched products with
per-image tap matrices, out = R_y · img · R_xᵀ; each row of R holds the
two taps of one output coordinate, and the rows of the pad region are
zero. As in the JAX package, taps and pixels are bf16 values, the
products accumulate in f32 and the intermediate is rounded to bf16.
Each output is a sum of at most two nonzero products, so every way of
computing it that keeps an f32 result gives the same bits
(`batched_products`).
"""
from __future__ import annotations

import torch


def fma(a, b, c):
    """a * b + c rounded once to f32, as the JAX package's compiled
    programs compute it (XLA's CPU compiler contracts such sums into
    fused multiply-adds): the f64 product of two f32 values is exact."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def scatter_taps(out_size: int, src_size: int, taps) -> torch.Tensor:
    """(N, out_size, src_size) f32 matrix with the given taps: `taps` is
    a list of (column (N, out_size) long in [0, src_size), weight (N,
    out_size) f32) pairs, each weight already a bf16 value. Built by a
    scatter, not by comparing every column with the tap's index, so no
    temporary is as large as the matrix."""
    col, w = taps[0]
    m = torch.zeros((col.shape[0], out_size, src_size), dtype=torch.float32,
                    device=col.device)
    for col, w in taps:
        m.scatter_add_(2, col[..., None], w[..., None])
    return m


def batched_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b per batch with an f32 result, for operands that hold bf16
    values (uint8 pixels, bf16 taps or intermediates) where every row of
    the tap operand has at most two nonzero entries.

    Each product of two bf16 values has at most 16 significant bits, so
    it is exact in f32; each output is then a·b + c·d plus zeros, which
    f32 accumulation rounds once whatever the order, tiling or split of
    the sum. bf16 operands with an f32 result, TF32 and full f32 thus
    all give the same bits. On the card the operands go in as bf16 to
    the tensor cores (`aten::bmm.dtype`), with no global precision flag
    touched; on the CPU the product is f32."""
    if a.device.type == "cuda":
        return torch.bmm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                         out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def separable_resample(ry: torch.Tensor, x: torch.Tensor,
                       rx: torch.Tensor) -> torch.Tensor:
    """R_y · x · R_xᵀ per image: ry (N, S, Hs), x (N, Hs, Ws, 3) with
    values exact in bf16 (uint8 pixels), rx (N, S, Ws) -> (N, 3, S, S)
    f32, the intermediate rounded to bf16 as in the JAX package."""
    n, hs, ws, _ = x.shape
    s = ry.shape[1]
    y = batched_products(ry, x.reshape(n, hs, ws * 3))          # (N, S, Ws*3)
    y = (y.view(n, s, ws, 3).permute(0, 3, 1, 2).to(torch.bfloat16)
         .contiguous())
    out = batched_products(y.view(n, 3 * s, ws), rx.transpose(1, 2))
    return out.view(n, 3, s, rx.shape[1])


def _tap_matrix(out_size: int, src_size: int, scale, offset, n_out, n_valid):
    """(B, out_size, src_size) bilinear tap matrices, one per image.

    Row i samples src coordinate s = (i - offset + 0.5) * scale - 0.5,
    split over floor(s)/floor(s)+1 with replicate-border clamping to
    [0, n_valid-1]. Rows with i outside [offset, offset + n_out) are zero
    (the pad region). All arguments but the sizes are (B,) f32. Every tap
    lies below n_valid, so the columns beyond an image's true extent
    (staging garbage) get no weight."""
    i = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    s = fma(i - offset[:, None] + 0.5, scale[:, None], -0.5)
    s0 = torch.floor(s)
    w1 = s - s0                                   # tap at s0+1
    w0 = 1.0 - w1                                 # tap at s0
    last = (torch.clamp(n_valid, max=src_size) - 1)[:, None]
    t0 = torch.minimum(torch.clamp(s0, min=0), last)
    t1 = torch.minimum(torch.clamp(s0 + 1, min=0), last)
    # both taps clamped onto one column: its weight is their f32 sum,
    # rounded to bf16 once, as the JAX package's dense matrix is
    same = t0 == t1
    w0 = torch.where(same, w0 + w1, w0)
    w1 = torch.where(same, 0.0, w1)
    in_out = (i >= offset[:, None]) & (i < (offset + n_out)[:, None])
    return scatter_taps(out_size, src_size, [
        (t.long(), torch.where(in_out, w, 0.0).to(torch.bfloat16).float())
        for t, w in ((t0, w0), (t1, w1))])


@torch.no_grad()
def letterbox_batch(images: torch.Tensor, hw: torch.Tensor, out_size: int = 640,
                    fill: float = 0.0, allow_upscale: bool = True):
    """Device letterbox over a staged batch.

    Args:
      images: (B, Hs, Ws, 3) uint8, each image's raw pixels top-left in
        the staging buffer (rows and columns beyond hw are ignored).
      hw: (B, 2) f32 true (height, width) per image.
      out_size: square output size S.
      fill: pad value (0 as data/image.py pads; 114 by argument).
      allow_upscale: False keeps eval's never-upscale rule; True is the
        serving geometry (one resize with the unclamped ratio).
    Returns:
      (B, S, S, 3) uint8 and (B, 5) f32 metas [r, pad_w, pad_h, w, h]
      (the native loader's meta contract).
    """
    b, hs, ws, _ = images.shape
    hw = hw.to(device=images.device, dtype=torch.float32)
    h, w = hw[:, 0], hw[:, 1]
    s = float(out_size)
    r = torch.minimum(s / h, s / w)
    if not allow_upscale:
        r = torch.clamp(r, max=1.0)
    new_w, new_h = torch.round(w * r), torch.round(h * r)
    pad_w, pad_h = (s - new_w) / 2, (s - new_h) / 2
    top, left = torch.round(pad_h - 0.1), torch.round(pad_w - 0.1)

    ry = _tap_matrix(out_size, hs, h / new_h, top, new_h, h)     # (B, S, Hs)
    rx = _tap_matrix(out_size, ws, w / new_w, left, new_w, w)    # (B, S, Ws)
    y = separable_resample(ry, images, rx)                       # (B, 3, S, S)
    del ry, rx

    o = torch.arange(out_size, dtype=torch.float32, device=images.device)
    rows = (o >= top[:, None]) & (o < (top + new_h)[:, None])
    cols = (o >= left[:, None]) & (o < (left + new_w)[:, None])
    inside = rows[:, None, :, None] & cols[:, None, None, :]
    out = torch.where(inside, torch.round(y), fill).clamp_(0, 255)
    out = out.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    meta = torch.stack([r, pad_w, pad_h, w, h], 1)
    return out, meta
