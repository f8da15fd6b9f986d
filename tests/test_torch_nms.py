"""NMS in the port against the JAX package: the greedy keep (plain version
vs the Pallas kernel in interpret mode and the XLA fixpoint), the
reference golden, and nms_from_raw / batched_nms on seeded head maps
through every ranking path, ties included; plus the wrapper's input
checks. The CUDA kernel's tests are in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_golden
from tpu_yolo.core.config import ModelConfig as JaxModelConfig
from tpu_yolo.ops import nms as jax_nms
from tpu_yolo.ops.nms_pallas import greedy_keep_pallas
from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.ops import nms
from tpu_yolo_torch.ops.nms_cuda import greedy_keep, greedy_keep_plain

torch.set_num_threads(1)


def _clustered(rng, b, k, nc=8, img=640.0):
    """Score-descending candidates in redundant clusters (the scenes of
    tests/test_pallas.py::TestGreedyKeepPallas)."""
    n_obj = max(4, k // 24)
    centers = rng.uniform(40, img - 40, (b, n_obj, 2))
    sizes = rng.uniform(16, 160, (b, n_obj, 2))
    obj = rng.integers(0, n_obj, (b, k))
    jit_c = rng.normal(0, 6, (b, k, 2))
    jit_s = rng.uniform(0.85, 1.15, (b, k, 2))
    c = np.take_along_axis(centers, obj[..., None], 1) + jit_c
    s = np.take_along_axis(sizes, obj[..., None], 1) * jit_s
    boxes = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    cls = rng.integers(0, nc, (b, k)).astype(np.int32)
    valid = rng.random((b, k)) > 0.1
    return boxes, cls, valid


def _uniform(rng, b, k):
    xy1 = rng.uniform(0, 600, (b, k, 2))
    wh = rng.uniform(4, 200, (b, k, 2))
    boxes = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    return (boxes, rng.integers(0, 80, (b, k)).astype(np.int32),
            rng.random((b, k)) > 0.3)


def _to_numpy(res, i):
    """One image's detections as (N, 6) [x1, y1, x2, y2, score, cls]."""
    n = int(res["count"][i])
    return torch.cat([res["boxes"][i, :n], res["scores"][i, :n, None],
                      res["classes"][i, :n, None].float()], -1).numpy()


def _plain(boxes, cls, valid, thr):
    return greedy_keep_plain(torch.from_numpy(boxes), torch.from_numpy(cls),
                             torch.from_numpy(valid), thr).numpy()


@pytest.mark.parametrize("b,k", [(2, 256), (1, 512), (3, 1024)])
def test_keep_matches_pallas_clustered(b, k):
    boxes, cls, valid = _clustered(np.random.default_rng(0), b, k)
    want = greedy_keep_pallas(jnp.asarray(boxes), jnp.asarray(cls),
                              jnp.asarray(valid), 0.65, interpret=True)
    np.testing.assert_array_equal(_plain(boxes, cls, valid, 0.65),
                                  np.asarray(want))


def test_keep_matches_pallas_uniform():
    boxes, cls, valid = _uniform(np.random.default_rng(1), 2, 512)
    want = greedy_keep_pallas(jnp.asarray(boxes), jnp.asarray(cls),
                              jnp.asarray(valid), 0.65, interpret=True)
    np.testing.assert_array_equal(_plain(boxes, cls, valid, 0.65),
                                  np.asarray(want))


def test_keep_matches_xla_fixpoint_k2048():
    boxes, cls, valid = _clustered(np.random.default_rng(2), 2, 2048, nc=3)
    want = jax_nms._greedy_keep(jnp.asarray(boxes), jnp.asarray(cls),
                                jnp.asarray(valid), iou_thres=0.45)
    np.testing.assert_array_equal(_plain(boxes, cls, valid, 0.45),
                                  np.asarray(want))


def test_golden_synthetic_exact():
    g = load_golden("nms.npz")
    synth = g["synth"]                      # (1, 84, A) reference layout
    preds = torch.from_numpy(np.ascontiguousarray(np.transpose(synth, (0, 2, 1))))
    res = nms.batched_nms(preds, max_nms=synth.shape[2] * 80)
    mine = _to_numpy(res, 0)
    ref = g["synth_det"]
    assert mine.shape == ref.shape, (mine.shape, ref.shape)
    assert np.abs(mine[:, :4] - ref[:, :4]).max() < 1e-3
    assert np.abs(mine[:, 4] - ref[:, 4]).max() < 1e-6
    assert (mine[:, 5] == ref[:, 5]).all()


def test_golden_model_outputs():
    g = load_golden("nms.npz")
    outputs = g["outputs"]                  # (2, 84, A)
    preds = torch.from_numpy(np.ascontiguousarray(np.transpose(outputs, (0, 2, 1))))
    res = nms.batched_nms(preds, max_nms=outputs.shape[2] * 80)
    for i in range(outputs.shape[0]):
        assert _to_numpy(res, i).shape == g[f"det_{i}"].shape


CFG = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True),
           num_classes=8)


def _raw_maps(rng, b=2, hw=64, nc=8, quantize=False):
    """Seeded raw head maps (B, H/s, W/s, 64+nc) whose class logits let
    candidates through conf (centered at -2); quantize=True puts the
    logits on a 0.25 grid for dense exact ties."""
    maps = []
    for s in (8, 16, 32):
        n = hw // s
        dist = rng.normal(0, 2, (b, n, n, 64))
        logits = rng.normal(-2, 1.5, (b, n, n, nc))
        if quantize:
            logits = np.round(logits * 4) / 4
        maps.append(np.concatenate([dist, logits], -1).astype(np.float32))
    return maps


def _assert_same(mine, ref, keys=("count", "valid", "classes")):
    for key in keys:
        np.testing.assert_array_equal(mine[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    v = np.asarray(ref["valid"])
    np.testing.assert_allclose(mine["boxes"].numpy()[v],
                               np.asarray(ref["boxes"])[v], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mine["scores"].numpy()[v],
                               np.asarray(ref["scores"])[v], rtol=1e-4, atol=1e-4)
    assert v.any()


# 64 px: A = 84 anchors, so max_nms < 84 ranks through a pre-gate that
# cuts anchors and max_nms >= 84 through one that keeps them all, which
# the JAX package ranks flat over the (B, A*nc) matrix
PATHS = {
    "pregated": dict(max_nms=32),
    "flat": dict(max_nms=128),
    "single_label": dict(max_nms=64, multi_label=False),
    "envelope": dict(max_nms=48, envelope=True),
    "envelope_flat": dict(max_nms=256, envelope=True),
    "approx": dict(max_nms=32, ranking="approx"),
}


@pytest.mark.parametrize("quantize", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_nms_from_raw_matches_jax(path, quantize):
    """Same seeded raw maps -> same counts, classes and candidate order
    (slot by slot), boxes and scores within 1e-4."""
    kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=100, **PATHS[path])
    maps = _raw_maps(np.random.default_rng(7), quantize=quantize)
    ref = jax_nms.nms_from_raw([jnp.asarray(m) for m in maps],
                               JaxModelConfig(**CFG), (64, 64), **kw)
    mine = nms.nms_from_raw([torch.from_numpy(m) for m in maps],
                            ModelConfig(**CFG), (64, 64), **kw)
    keys = ("count", "valid", "classes")
    if kw.get("envelope"):
        keys += ("n_above_conf", "candidate_budget")
    _assert_same(mine, ref, keys)


def test_nms_from_raw_bf16_logits_match_jax():
    """The serving dtype: bf16 head maps ranked directly in both packages."""
    maps = _raw_maps(np.random.default_rng(9))
    kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=100, max_nms=32)
    ref = jax_nms.nms_from_raw([jnp.asarray(m, jnp.bfloat16) for m in maps],
                               JaxModelConfig(**CFG), (64, 64), **kw)
    mine = nms.nms_from_raw([torch.from_numpy(m).bfloat16() for m in maps],
                            ModelConfig(**CFG), (64, 64), **kw)
    _assert_same(mine, ref)


@pytest.mark.parametrize("multi_label", [True, False])
def test_batched_nms_matches_jax_on_tied_scores(multi_label):
    """Decoded predictions with 12 score levels (dense cross-anchor ties):
    the same detections in the same order as the JAX batched_nms."""
    rng = np.random.default_rng(11)
    b, a, nc = 2, 256, 16
    cxy = rng.uniform(40, 600, (b, a, 2))
    wh = rng.uniform(8, 120, (b, a, 2))
    scores = rng.integers(0, 12, (b, a, nc)) / 12.0
    preds = np.concatenate([cxy, wh, scores], -1).astype(np.float32)
    kw = dict(max_nms=128, multi_label=multi_label, envelope=True)
    ref = jax_nms.batched_nms(jnp.asarray(preds), **kw)
    mine = nms.batched_nms(torch.from_numpy(preds), **kw)
    _assert_same(mine, ref, ("count", "valid", "classes", "n_above_conf"))


def test_ties_break_toward_the_lower_index():
    """Equal values rank by index; +0 ranks above -0, as in lax.top_k."""
    x = torch.tensor([[1.0, 3.0, 3.0, -0.0, 3.0, 1.0, 0.0]])
    vals, idx = nms._top_k(x, 7)
    assert idx.tolist() == [[1, 2, 4, 0, 5, 6, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0, 1.0, 0.0, -0.0]]


@pytest.mark.parametrize("case", ["boxes_dtype", "cls_dtype", "shape", "k",
                                  "layout"])
def test_wrapper_raises_instead_of_falling_back(case):
    boxes, cls, valid = map(torch.from_numpy,
                            _uniform(np.random.default_rng(3), 2, 64))
    if case == "boxes_dtype":
        boxes = boxes.double()
    elif case == "cls_dtype":
        cls = cls.long()
    elif case == "shape":
        valid = valid[:, :32]
    elif case == "k":
        boxes = boxes.repeat(1, 130, 1)
        cls, valid = cls.repeat(1, 130), valid.repeat(1, 130)
    else:
        boxes = boxes.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        greedy_keep(boxes, cls, valid, 0.65)
