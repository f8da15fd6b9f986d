"""The port's device letterbox (tpu_yolo_torch/ops/letterbox.py) against
the JAX package's `letterbox_batch` and against the cv2 oracle, on the
CPU, at the sizes of tests/test_letterbox_device.py. Pixels: equal on at
least 99.9% of values, mean |diff| under 0.01 (bf16 taps and f32 sums in
both; a tap sum on a rounding boundary may land one LSB apart); metas
within 1e-6; against cv2 (fixed-point taps) the JAX test's own limits,
mean < 1.5 and q99 <= 6."""
import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_yolo.ops.letterbox import letterbox_batch as jax_letterbox
from tpu_yolo_torch.ops.letterbox import letterbox_batch

S = 192
STAGE = 256
# the JAX test's sizes; the last one upscales
SIZES = [(200, 150), (150, 200), (117, 93), (192, 192), (256, 96), (40, 64)]


def _staged(seed=0, garbage=True):
    """Smooth images top-left in the staging buffer; with `garbage`, the
    rest of each slot holds noise that the letterbox must ignore."""
    rng = np.random.default_rng(seed)
    batch = (rng.integers(0, 256, (len(SIZES), STAGE, STAGE, 3), np.uint8)
             if garbage else np.zeros((len(SIZES), STAGE, STAGE, 3), np.uint8))
    hw = np.zeros((len(SIZES), 2), np.float32)
    imgs = []
    for i, (h, w) in enumerate(SIZES):
        base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3), np.uint8)
        imgs.append(cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC))
        batch[i, :h, :w] = imgs[-1]
        hw[i] = (h, w)
    return batch, hw, imgs


def assert_pixels_match(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    assert diff.mean() < 0.01, diff.mean()


@pytest.mark.parametrize("fill", [0.0, 114.0])
@pytest.mark.parametrize("allow_upscale", [True, False])
def test_matches_jax_letterbox(allow_upscale, fill):
    batch, hw, _ = _staged()
    want, want_meta = jax_letterbox(jnp.asarray(batch), jnp.asarray(hw), out_size=S,
                                    fill=fill, allow_upscale=allow_upscale)
    got, meta = letterbox_batch(torch.from_numpy(batch), torch.from_numpy(hw),
                                out_size=S, fill=fill, allow_upscale=allow_upscale)
    assert got.dtype == torch.uint8 and got.shape == (len(SIZES), S, S, 3)
    assert_pixels_match(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(meta.numpy(), np.asarray(want_meta), rtol=0, atol=1e-6)


@pytest.mark.parametrize("allow_upscale", [True, False])
def test_matches_cv2_oracle(allow_upscale):
    batch, hw, imgs = _staged(seed=1)
    out, metas = letterbox_batch(torch.from_numpy(batch), torch.from_numpy(hw),
                                 out_size=S, allow_upscale=allow_upscale)
    out, metas = out.numpy(), metas.numpy()
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        r = min(S / h, S / w)
        if not allow_upscale:
            r = min(r, 1.0)
        nw, nh = int(round(w * r)), int(round(h * r))
        ref = cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR) \
            if (nw, nh) != (w, h) else im
        pad_w, pad_h = (S - nw) / 2, (S - nh) / 2
        top, left = int(round(pad_h - 0.1)), int(round(pad_w - 0.1))
        assert metas[i, 0] == pytest.approx(r, abs=1e-6)
        assert tuple(metas[i, 1:3]) == pytest.approx((pad_w, pad_h), abs=1e-4)
        assert tuple(metas[i, 3:5]) == (w, h)
        placed = np.zeros((S, S), bool)
        placed[top:top + nh, left:left + nw] = True
        assert (out[i][~placed] == 0).all(), f"image {i}: fill leaked"
        diff = np.abs(out[i][placed].astype(np.int16) - ref.reshape(-1, 3).astype(np.int16))
        assert diff.mean() < 1.5 and np.quantile(diff, 0.99) <= 6, i


def test_identity_when_already_square():
    """r == 1: no resize, the output is a bit-exact copy."""
    img = np.random.default_rng(2).integers(0, 256, (1, S, S, 3), np.uint8)
    out, meta = letterbox_batch(torch.from_numpy(img),
                                torch.tensor([[S, S]], dtype=torch.float32),
                                out_size=S, allow_upscale=False)
    np.testing.assert_array_equal(out.numpy(), img)
    assert float(meta[0, 0]) == 1.0
