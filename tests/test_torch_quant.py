"""The port's int8 W8A8 quantization (tpu_yolo_torch/quant.py, the int8
form of ops/nn.py::ConvBN, Detector.quantize, `detect --int8`) against
tpu_yolo's on the CPU: the int32 sums bit for bit, the quantized weights
bit for bit for the same calibration, the calibration and the quantized
forward within stated tolerances, the cases of tests/test_quant.py, the
quantized saved program and the quantized s2d stem."""
import functools
import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import tpu_yolo.ops.nn as jax_nn
from tpu_yolo.data import native_loader as jax_native_loader
from tpu_yolo.core.config import ModelConfig as JaxModelConfig
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.ops.nms import batched_nms as jax_batched_nms
from tpu_yolo.quant import calibrate as jax_calibrate
from tpu_yolo.quant import quantize_params as jax_quantize_params
from tpu_yolo.serve import Detector as JaxDetector
from tpu_yolo_torch.core.config import ModelConfig, get_model_config
from tpu_yolo_torch.data import native_loader
from tpu_yolo_torch.io.checkpoint import save_checkpoint
from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, has_s2d_stem, init_params
from tpu_yolo_torch.ops.boxes import box_iou_pairwise
from tpu_yolo_torch.ops.nms import batched_nms
from tpu_yolo_torch.ops.nn import ConvBN, int8_conv2d
from tpu_yolo_torch.quant import calibrate, quantize_model, quantize_params
from tpu_yolo_torch.seeded import eval_state, seeded_images
from tpu_yolo_torch.serve import Detector

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                   csp=(False, True), num_classes=8)
JAX_TINY = JaxModelConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                          num_classes=8)
SIZE = 128


def _jax_folded(seed=0):
    """JAX's folded TINY params as numpy."""
    params = jax_yolo.init_params(seed, JAX_TINY)
    return jax.tree_util.tree_map(np.asarray, jax_yolo.fold_batchnorm(params))


@functools.lru_cache
def _served(seed=0):
    """Folded TINY params in the JAX layout from `seeded.eval_state` (its
    BatchNorm set from seeded images, logits of unit spread), so that
    detections are distinct and depend on the image, and its images."""
    imgs = seeded_images(np.random.default_rng(seed), 2, SIZE)
    state = eval_state(TINY, seed, imgs, "cpu")
    return to_jax_params(YOLO.from_state_dict(TINY, state).fold_batchnorm()), imgs


def _images(n=2, size=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), np.uint8)


def _dotted(absmax):
    return {k.replace("/", "."): v for k, v in absmax.items()}


def _jax_int32_conv(x, w, stride, padding, groups):
    """JAX's int8 conv of NCHW/OIHW numpy arrays, as NCHW int32."""
    y = jax_nn.conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                      jnp.asarray(w.transpose(2, 3, 1, 0)), stride=stride,
                      padding=padding, groups=groups,
                      preferred_element_type=jnp.int32)
    return np.asarray(y).transpose(0, 3, 1, 2)


# (C_in, C_out, k, stride, padding, groups): the stem (C_in 3, K = 27),
# dense 3x3 at strides 1 and 2 with padding 0 and 1, 1x1, the s2d stem's
# 2x2 with its asymmetric top/left pad, depthwise at strides 1 and 2, and
# C_in = 512 with large same-sign values, whose sums pass 2^24
CONV_CASES = {
    "stem_3x3_s2": (3, 16, 3, 2, 1, 1),
    "dense_3x3_s1_p1": (16, 24, 3, 1, 1, 1),
    "dense_3x3_s2_p0": (20, 16, 3, 2, 0, 1),
    "dense_1x1": (32, 40, 1, 1, 0, 1),
    "odd_out_channels": (24, 13, 3, 1, 1, 1),
    "s2d_stem_2x2": (12, 16, 2, 1, ((1, 0), (1, 0)), 1),
    "depthwise_s1": (24, 24, 3, 1, 1, 24),
    "depthwise_s2": (16, 16, 3, 2, 1, 16),
    "wide_512_past_2e24": (512, 16, 3, 1, 1, 1),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv2d_equals_jax_int32_conv(case):
    """Bit for bit against JAX's conv2d(preferred_element_type=int32)."""
    c, o, k, stride, padding, groups = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    lo = 100 if case.startswith("wide") else -127
    x = rng.integers(lo, 128, (2, c, 9, 11)).astype(np.int8)
    w = rng.integers(lo, 128, (o, c // groups, k, k)).astype(np.int8)
    got = int8_conv2d(torch.from_numpy(x), torch.from_numpy(w), stride, padding, groups)
    want = _jax_int32_conv(x, w, stride, padding, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case.startswith("wide"):
        # where the chosen form is needed: an f32 conv rounds these sums
        assert np.abs(want).max() > 2 ** 24
        f32 = F.conv2d(torch.from_numpy(x).float(), torch.from_numpy(w).float(),
                       stride=stride, padding=padding).numpy()
        assert (f32.astype(np.int64) != want).any()


def test_int8_conv2d_takes_channels_last_and_refuses_other_forms():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 8, 5, 5)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 8, 3, 3)).astype(np.int8))
    torch.testing.assert_close(
        int8_conv2d(x.contiguous(memory_format=torch.channels_last), w, 1, 1),
        int8_conv2d(x, w, 1, 1), rtol=0, atol=0)
    with pytest.raises(TypeError):
        int8_conv2d(x.float(), w)
    with pytest.raises(ValueError, match="dense and depthwise"):
        int8_conv2d(x, w[:, :4], groups=2)


def test_quantize_params_bit_equal_to_jax():
    """For JAX's own absmax, `w_q`, `s_w`, `s_in` and `b` equal JAX's bit
    for bit, in both forms (a state dict, a model in place), at two
    margins; int8 `w_q`, 0-d `s_in`."""
    params = _jax_folded()
    images = _images()
    absmax = jax_calibrate(params, JAX_TINY, images, compute_dtype=jnp.float32)
    state = YOLO.from_state_dict(TINY, from_jax_params(params, TINY)).state_dict()
    for margin in (1.0, 1.5):
        want = from_jax_params(jax_quantize_params(params, absmax, margin), TINY)
        got_state = quantize_params(state, _dotted(absmax), margin)
        model = quantize_params(YOLO.from_state_dict(TINY, state), _dotted(absmax), margin)
        for got in (got_state, model.state_dict()):
            assert set(got) == set(want)
            for k, t in want.items():
                assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
                assert torch.equal(got[k], t), k
    assert want["net.p1.0.w_q"].dtype == torch.int8
    assert want["net.p1.0.s_in"].shape == ()


def test_quantize_params_leaves_uncalibrated_convs_float():
    state = YOLO.from_state_dict(TINY, from_jax_params(_jax_folded(), TINY)).state_dict()
    got = quantize_params(state, {"net.p1.0": 2.0})
    assert "net.p1.0.w_q" in got and "net.p2.0.w" in got and "net.p2.0.w_q" not in got
    np.testing.assert_array_equal(got["net.p1.0.s_in"].numpy(), np.float32(2.0 / 127.0))


def test_calibration_covers_every_conv():
    """The case of tests/test_quant.py, and the same keys and values as
    JAX's calibration at f32: within 1e-3 of max(|v|, 1) (measured 3.7e-9;
    the forwards agree to about 1e-5 of their largest values)."""
    params = _jax_folded()
    images = _images()
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    absmax = calibrate(model, images, compute_dtype=torch.float32)
    n_convs = sum(1 for m in model.modules() if isinstance(m, ConvBN))
    assert len(absmax) == n_convs and all(v > 0 for v in absmax.values())
    want = _dotted(jax_calibrate(params, JAX_TINY, images, compute_dtype=jnp.float32))
    assert set(absmax) == set(want)
    for k, v in want.items():
        assert abs(absmax[k] - v) <= 1e-3 * max(abs(v), 1.0), k


def test_calibration_in_bf16_close_to_jax():
    """The default calibration runs in bf16, as JAX's: each absmax within
    2% of JAX's (bf16 activations of two packages round apart, measured
    below 1%)."""
    params = _jax_folded()
    images = _images()
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    absmax = calibrate(model, images)
    want = _dotted(jax_calibrate(params, JAX_TINY, images))
    assert set(absmax) == set(want)
    worst = max(abs(absmax[k] - v) / max(abs(v), 1e-6) for k, v in want.items())
    assert worst <= 0.02, worst
    assert not model.training


def test_quantized_params_form():
    """The case of tests/test_quant.py, on the model's buffers."""
    model = quantize_model(YOLO.from_state_dict(TINY, from_jax_params(_jax_folded(), TINY)),
                           _images())
    convs = [m for m in model.modules() if isinstance(m, ConvBN)]
    assert convs and all(m.quantized for m in convs)
    for m in convs:
        assert m.w_q.dtype == torch.int8 and int(m.w_q.abs().max()) <= 127
        assert m.s_w.shape == (m.w_q.shape[0],) and m.s_w.dtype == torch.float32
        assert m.s_in.shape == () and m.b.dtype == torch.float32
        assert not hasattr(m, "w")


def _matched(a, b, iou=0.9):
    """Share of a's detections with a same-class partner in b at IoU >= iou."""
    (ba, ca), (bb, cb) = a, b
    if len(ba) == 0 or len(bb) == 0:
        return float(len(ba) == len(bb))
    overlap = box_iou_pairwise(ba, bb) * (ca[:, None] == cb[None, :])
    return float((overlap.max(1).values >= iou).float().mean())


def _dets(res, i):
    n = int(np.asarray(res["count"])[i])
    return (torch.from_numpy(np.array(res["boxes"])[i, :n]),
            torch.from_numpy(np.array(res["classes"])[i, :n]))


def test_quantized_forward_matches_jax():
    """JAX's quantized TINY params (calibrated in bf16) carried across, at
    f32: the quantized inputs of every conv equal on all but 1e-4 of
    their values (measured: all equal), the decoded boxes within 1e-2 px
    and the class probabilities within 1e-5 (measured 1.2e-4 px and
    1.2e-7: the dequantized sums differ by rounding only), and NMS
    detections matched both ways on >= 98% (same class, IoU >= 0.9)."""
    params, images = _served()
    absmax = jax_calibrate(params, JAX_TINY, images)
    q = jax_quantize_params(params, absmax)
    model = YOLO.from_state_dict(TINY, from_jax_params(
        jax.tree_util.tree_map(np.asarray, q), TINY))

    xq_port, xq_jax = {}, {}

    def port_tap(name):
        def hook(module, args):
            xq_port[name] = module.quantize_input(args[0]).numpy()
        return hook

    for name, m in model.named_modules():
        if isinstance(m, ConvBN):
            m.register_forward_pre_hook(port_tap(name))
    conv_bn = jax_nn._conv_bn

    def jax_tap(p, x, ctx, path, **kw):
        if "w_q" in p:
            xq = jnp.clip(jnp.round(x.astype(jnp.float32) / p["s_in"]), -127, 127)
            xq_jax[path.replace("/", ".")] = np.asarray(xq.astype(jnp.int8)).transpose(0, 3, 1, 2)
        return conv_bn(p, x, ctx, path, **kw)

    x = images.astype(np.float32) / 255
    jax_nn._conv_bn = jax_tap
    try:
        want = np.asarray(jax_yolo.forward(q, jnp.asarray(x), JAX_TINY, train=False))
    finally:
        jax_nn._conv_bn = conv_bn
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert set(xq_port) == set(xq_jax) and len(xq_port) == 87
    differ = sum(int((xq_port[k] != xq_jax[k]).sum()) for k in xq_jax)
    total = sum(v.size for v in xq_jax.values())
    assert differ <= 1e-4 * total, (differ, total)
    assert np.abs(got[..., :4] - want[..., :4]).max() <= 1e-2
    assert np.abs(got[..., 4:] - want[..., 4:]).max() <= 1e-5

    mine = batched_nms(torch.from_numpy(got), conf_thres=0.25)
    ref = jax_batched_nms(jnp.asarray(want), conf_thres=0.25)
    for i in range(len(images)):
        a, b = _dets(mine, i), _dets(ref, i)
        assert len(a[0]) > 0
        assert min(_matched(a, b), _matched(b, a)) >= 0.98


def test_quantized_forward_close_to_f32():
    """The fidelity case of tests/test_quant.py on the port's own
    quantization (bf16 calibration), with its thresholds."""
    params = _jax_folded()
    images = _images()
    ref_model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    q_model = quantize_model(YOLO.from_state_dict(TINY, from_jax_params(params, TINY)),
                             images)
    x = torch.from_numpy(images).float() / 255
    with torch.inference_mode():
        ref, got = ref_model(x), q_model(x)
    p_err = (ref[..., 4:] - got[..., 4:]).abs()
    assert float(p_err.max()) < 0.12 and float(p_err.mean()) < 0.01
    assert float((ref[..., :4] - got[..., :4]).abs().mean()) < 2.0
    c_ref = int(batched_nms(ref, conf_thres=0.1)["count"].sum())
    c_got = int(batched_nms(got, conf_thres=0.1)["count"].sum())
    assert abs(c_ref - c_got) <= max(3, int(0.25 * max(c_ref, 1)))


def test_margin_loosens_clipping():
    """The margin case of tests/test_quant.py."""
    model = YOLO.from_state_dict(TINY, from_jax_params(_jax_folded(), TINY))
    absmax = calibrate(model, _images(), compute_dtype=torch.float32)
    q1 = quantize_params(model.state_dict(), absmax, margin=1.0)
    q2 = quantize_params(model.state_dict(), absmax, margin=2.0)
    assert float(q2["net.p1.0.s_in"]) == 2 * float(q1["net.p1.0.s_in"])


def test_quantized_weights_cross_both_ways():
    """JAX's quantized tree -> the port's state dict -> JAX's layout again,
    bit for bit, with int8 kernels (HWIO <-> OIHW) and a 0-d s_in; a
    missing leaf is refused."""
    params = _jax_folded()
    q = jax.tree_util.tree_map(np.asarray, jax_quantize_params(
        params, jax_calibrate(params, JAX_TINY, _images(), compute_dtype=jnp.float32)))
    state = from_jax_params(q, TINY)
    back = to_jax_params(state)
    flat_q = jax.tree_util.tree_leaves_with_path(q)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_q) == len(flat_back)
    for path, leaf in flat_q:
        assert flat_back[path].dtype == leaf.dtype and flat_back[path].shape == leaf.shape
        np.testing.assert_array_equal(flat_back[path], leaf)
    del q["net"]["p2"][0]["s_in"]
    with pytest.raises(ValueError, match="not filled"):
        from_jax_params(q, TINY)


def test_quantized_s2d_stem_matches_jax():
    """The s2d stem quantized (JAX: fold_stem_space_to_depth, then
    calibrate and quantize_params): the port reads it as an int8 s2d stem
    and its forward matches JAX's at f32 within the bound of
    test_quantized_forward_matches_jax; the port's own calibration of its
    s2d model covers the same convs."""
    params = jax.tree_util.tree_map(np.asarray, jax_yolo.fold_stem_space_to_depth(
        _jax_folded()))
    images = _images()
    absmax = jax_calibrate(params, JAX_TINY, images, compute_dtype=jnp.float32)
    q = jax.tree_util.tree_map(np.asarray, jax_quantize_params(params, absmax))
    state = from_jax_params(q, TINY)
    assert has_s2d_stem(state) and state["net.p1.0.w_q"].shape == (8, 12, 2, 2)
    model = YOLO.from_state_dict(TINY, state)
    assert model.s2d_stem and model.net["p1"][0].quantized
    x = images.astype(np.float32) / 255
    want = np.asarray(jax_yolo.forward(q, jnp.asarray(x), JAX_TINY, train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(), 1.0)

    port = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    assert set(calibrate(port, images, torch.float32)) == set(_dotted(absmax))
    with pytest.raises(ValueError, match="before quantizing"):
        quantize_model(YOLO.from_state_dict(TINY, from_jax_params(_jax_folded(), TINY)),
                       images).fold_stem_space_to_depth()


def test_fold_input_scale_refuses_a_quantized_stem():
    params = _jax_folded()
    q = jax_quantize_params(params, jax_calibrate(params, JAX_TINY, _images(),
                                                  compute_dtype=jnp.float32))
    with pytest.raises(ValueError, match="unquantized stem"):
        jax_yolo.fold_input_scale(q)
    model = YOLO.from_state_dict(TINY, from_jax_params(
        jax.tree_util.tree_map(np.asarray, q), TINY))
    with pytest.raises(ValueError, match="unquantized stem"):
        model.fold_input_scale()


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Six seeded smooth JPEGs of mixed sizes and one file that does not
    decode."""
    root = tmp_path_factory.mktemp("torch_quant_jpegs")
    rng = np.random.default_rng(3)
    paths = []
    for i, (h, w) in enumerate([(120, 160), (80, 60), (128, 128), (96, 140),
                                (140, 100), (64, 64)]):
        img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), np.uint8), (5, 5), 2)
        paths.append(str(root / f"im{i}.jpg"))
        cv2.imwrite(paths[-1], img)
    bad = root / "broken.jpg"
    bad.write_bytes(b"not a jpeg")
    return paths, str(bad)


def _detector(params, **kw):
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    return Detector(model, input_size=SIZE, device="cpu",
                    compute_dtype=torch.float32, ranking="exact", **kw)


def _rel_gaps(a: dict, b: dict) -> np.ndarray:
    return np.array([abs(a[k] - v) / v for k, v in b.items()])


def test_detector_quantize_matches_jax_detector(jpegs, monkeypatch):
    """Detector.quantize against tpu_yolo.serve.Detector.quantize on the
    same JPEGs, a broken file among them, f32 serving. Both Detectors
    decode through their OpenCV path here, as where the native library
    does not load (the native pipeline decodes other pixels).

    - The port calibrates on JAX's decoded batch with the broken file
      dropped: its quantized weights equal, bit for bit, the port's
      `quantize_model` of JAX's `_decode_batch` images.
    - `w_q`, `s_w` and `b` equal JAX's bit for bit (both quantize the same
      f32 weights).
    - `s_in`: both calibrate in bf16, where the two packages' forwards
      round apart and random weights amplify it. The gap to JAX's s_in is
      held to twice JAX's own gap between its bf16 and f32 calibrations,
      in median and in maximum (measured 0.84% and 3.2%, against 1.3% and
      4.9%).
    - Serving: a port Detector given JAX's quantized weights streams the
      JPEGs to JAX's detections: classes and counts equal, boxes within
      1e-3 px, scores within 1e-5 (measured 0 and 0). Detections of the
      two calibrations are not compared: on random weights int8 moves
      them as far from the float model's as the s_in gap does."""
    paths, bad = jpegs
    params, _ = _served()
    monkeypatch.setattr(jax_native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    det = _detector(params).quantize(paths + [bad])
    ref = JaxDetector(params, JAX_TINY, input_size=SIZE,
                      compute_dtype=jnp.float32, ranking="exact")
    imgs, metas, nfail = ref._decode_batch(paths + [bad])
    assert nfail == 1
    own = quantize_model(_detector(params).model, imgs[metas[:, 0] > 0])
    ref.quantize(paths + [bad])
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, ref.params), TINY)
    got = det.model.state_dict()
    assert set(got) == set(want) == set(own.state_dict())
    for k, t in own.state_dict().items():
        assert torch.equal(got[k], t), k
    for k, t in want.items():
        if not k.endswith(".s_in"):
            assert torch.equal(got[k], t), k
    s_in = {k: float(t) for k, t in got.items() if k.endswith(".s_in")}
    jax_f32 = _dotted(jax_calibrate(params, JAX_TINY, imgs[metas[:, 0] > 0],
                                    compute_dtype=jnp.float32))
    jax_bf16 = {k: float(t) for k, t in want.items() if k.endswith(".s_in")}
    gap = _rel_gaps(s_in, jax_bf16)
    jax_gap = _rel_gaps({f"{k}.s_in": v / 127 for k, v in jax_f32.items()}, jax_bf16)
    assert np.median(gap) <= 2 * np.median(jax_gap) and gap.max() <= 2 * jax_gap.max(), (
        np.median(gap), gap.max(), np.median(jax_gap), jax_gap.max())

    carried = Detector(YOLO.from_state_dict(TINY, want), input_size=SIZE, device="cpu",
                       compute_dtype=torch.float32, ranking="exact")
    mine, theirs = list(carried.stream(paths, batch_size=4)), list(ref.stream(paths, 4))
    assert sum(len(r["boxes"]) for r in mine) > 0
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a["classes"], b["classes"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5)


def test_staged_detector_quantizes_the_same_way(jpegs):
    """The device-letterbox Detector calibrates on the same host-letterboxed
    images, so it quantizes to the same weights, and streams."""
    paths, _ = jpegs
    params, _ = _served()
    plain = _detector(params).quantize(paths)
    staged = _detector(params, device_letterbox=True, stage_size=160).quantize(paths)
    for k, t in plain.model.state_dict().items():
        assert torch.equal(staged.model.state_dict()[k], t), k
    out = list(staged.stream(paths, batch_size=4))
    assert len(out) == len(paths) and all("error" not in r for r in out)


def test_quantized_saved_program_round_trip(jpegs, tmp_path):
    """A quantized Detector saves an int8 program: loaded with the int8
    weights it gives the live Detector's detections bit for bit, carries
    the int8 leaves in its spec, and refuses float weights; a float
    program refuses int8 weights; a loaded Detector does not quantize."""
    paths, _ = jpegs
    params, imgs = _served()
    det = _detector(params).quantize(paths)
    path = str(tmp_path / "int8.pt2z")
    det.save_compiled(path, batch_size=2)
    spec = det._weights_spec()
    assert spec["net.p1.0.w_q"][1] == "int8" and spec["net.p1.0.s_in"][0] == []
    state = det.model.state_dict()
    loaded = Detector.load_compiled(path, state)
    want, got = det.detect_batch(imgs), loaded.detect_batch(imgs)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert int(want["count"].sum()) > 0
    float_state = _detector(params).model.state_dict()
    with pytest.raises(ValueError, match="int8 program"):
        Detector.load_compiled(path, float_state)
    float_path = str(tmp_path / "f32.pt2z")
    _detector(params).save_compiled(float_path, batch_size=2)
    with pytest.raises(ValueError, match="float program"):
        Detector.load_compiled(float_path, state)
    with pytest.raises(ValueError, match="saved program"):
        loaded.quantize(paths)


def test_detect_int8_entry_point(jpegs, tmp_path):
    """python -m tpu_yolo_torch.detect --int8 --device cpu on seeded JPEGs:
    calibrates on the first --batch-size images, writes every annotated
    file."""
    paths, _ = jpegs
    ckpt = str(tmp_path / "n.ckpt")
    save_checkpoint(ckpt, {"params": init_params(0, get_model_config("n"))})
    out = tmp_path / "annotated"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_yolo_torch.detect", "--int8", "--device", "cpu",
         "--weights", ckpt, "--input-size", "64", "--batch-size", "4",
         "--out", str(out), *paths],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(out)) == sorted(os.path.basename(p) for p in paths)
    assert f"over {len(paths)} images" in proc.stdout
