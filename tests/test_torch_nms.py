"""NMS in the port against the JAX package: the greedy keep (plain version
vs the Pallas kernel in interpret mode and the XLA fixpoint), the
reference golden, and nms_from_raw / batched_nms on seeded head maps
through every ranking path, ties included; a numpy model of the CUDA
kernel's walk against both; plus the wrapper's input checks. The CUDA
kernel's tests are in tests/test_torch_cuda.py."""
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
from tpu_yolo_torch.seeded import nms_scene

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


def _hits(a, b, thr):
    """IoU(a, b) > thr for killers a (n, 4) and victims b (m, 4) -> (n, m),
    in the f32 operation order of csrc/nms_keep.cu: the quotient is taken
    as zero where the intersection is."""
    f = np.float32
    a, b = a[:, None, :], b[None, :, :]
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), f(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), f(0))
    inter = iw * ih

    def area(x):
        return (np.maximum(x[..., 2] - x[..., 0], f(0))
                * np.maximum(x[..., 3] - x[..., 1], f(0)))

    denom = ((area(a) + area(b)) - inter) + f(1e-12)
    assert inter.dtype == denom.dtype == np.float32
    return np.where(inter > 0, inter / denom, f(0)) > f(thr)


def _walk_model(boxes, cls, valid, thr):
    """One image through the schedule of csrc/nms_keep.cu: chunks of 32 in
    rank order; the diagonal words of each chunk; a chunk settled as the
    fixpoint of keep = alive & ~OR{diag[t]: t in keep}; only its kept
    candidates tested against the later live ones, OR-ed into a `removed`
    bitset; the all-invalid tail skipped. Returns (keep, IoU tests made
    outside the diagonal)."""
    k = len(valid)
    words = (k + 31) // 32
    kp = words * 32
    boxes = np.concatenate([boxes, np.zeros((kp - k, 4), np.float32)])
    cls = np.concatenate([cls, np.full(kp - k, -1, np.int32)])
    vbits = np.concatenate([valid, np.zeros(kp - k, bool)]).reshape(words, 32)
    live_words = np.nonzero(vbits.any(1))[0]
    n = int(live_words[-1]) + 1 if len(live_words) else 0
    removed = np.zeros((words, 32), bool)
    kept = np.zeros((words, 32), bool)
    lanes = np.arange(32)

    diag = np.zeros((kp, 32), bool)           # diag[j, u]: j kills c*32+u
    for j in np.nonzero(vbits[:n].reshape(-1))[0]:
        c0 = j & ~31
        same = (lanes > (j & 31)) & vbits[j >> 5] & (cls[c0:c0 + 32] == cls[j])
        diag[j] = same & _hits(boxes[j:j + 1], boxes[c0:c0 + 32], thr)[0]

    tests = 0
    for c in range(n):
        alive = vbits[c] & ~removed[c]
        keep = alive.copy()
        d = diag[c * 32:(c + 1) * 32] & alive[:, None]
        for _ in range(33):
            nxt = alive & ~(d & keep[:, None]).any(0)
            if (nxt == keep).all():
                break
            keep = nxt
        else:
            raise AssertionError("the chunk's fixpoint did not settle")
        kept[c] = keep
        killers = c * 32 + np.nonzero(keep)[0]
        if not len(killers):
            continue
        for w in range(c + 1, n):
            aw = vbits[w] & ~removed[w]
            victims = w * 32 + np.nonzero(aw)[0]
            if not len(victims):
                continue
            same = cls[killers][:, None] == cls[victims][None, :]
            tests += int(same.sum())
            hit = (same & _hits(boxes[killers], boxes[victims], thr)).any(0)
            removed[w, np.nonzero(aw)[0][hit]] = True
    return kept.reshape(-1)[:k], tests


WALK_SCENES = [("clustered", 2, 1024), ("uniform", 2, 512), ("disjoint", 2, 256),
               ("identical", 2, 256), ("invalid", 2, 128), ("clustered", 3, 1),
               ("clustered", 3, 33), ("uniform", 2, 1000), ("clustered", 1, 2048)]


@pytest.mark.parametrize("scene,b,k", WALK_SCENES,
                         ids=[f"{s}-{k}" for s, _, k in WALK_SCENES])
@pytest.mark.parametrize("valid_as", ["given", "prefix", "random"])
def test_kernel_walk_model_equals_plain_and_jax(scene, b, k, valid_as):
    """The CUDA kernel's schedule, modelled in numpy, is bit-equal to
    greedy_keep_plain and to the JAX package's greedy keep on the scenes
    that stress it, with `valid` as the scene gives it, as a prefix (the
    main path) and as a random pattern; and it makes fewer same-class IoU
    tests than the full upper triangle wherever something is suppressed."""
    rng = np.random.default_rng(k)
    boxes, cls, valid = nms_scene(rng, scene, b, k)
    if valid_as == "prefix":
        valid = np.arange(k)[None, :] < rng.integers(0, k + 1, (b, 1))
    elif valid_as == "random":
        valid = rng.random((b, k)) > 0.5
    thr = 0.65
    got, tests = zip(*(_walk_model(boxes[i], cls[i], valid[i], thr) for i in range(b)))
    got = np.stack(got)
    np.testing.assert_array_equal(got, _plain(boxes, cls, valid, thr))
    want = jax_nms._greedy_keep(jnp.asarray(boxes), jnp.asarray(cls),
                                jnp.asarray(valid), iou_thres=thr)
    np.testing.assert_array_equal(got, np.asarray(want))
    if scene == "identical" and valid_as == "given":
        assert got[:, 0].all() and got.sum() == b     # all but the first go
    if scene == "disjoint" and valid_as == "given":
        assert got.all()                              # the most killers
    if scene == "invalid" and valid_as == "given":
        assert not got.any() and sum(tests) == 0
    tri = np.triu(np.ones((k, k), bool), 1)
    full = int(((cls[:, :, None] == cls[:, None, :]) & tri & valid[:, :, None]
                & valid[:, None, :]).sum())
    assert sum(tests) <= full
    if (valid & ~got).any() and scene != "uniform":
        assert sum(tests) < full


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
