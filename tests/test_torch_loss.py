"""The port's CIoU, task-aligned assigner and detection loss against the
reference goldens and the JAX package, in f32 on the CPU (where the
assigner's top-k runs its plain version)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_golden
from tpu_yolo.core.config import get_model_config as jax_config
from tpu_yolo.ops.boxes import ciou as jax_ciou
from tpu_yolo.train import loss as jax_loss
from tpu_yolo.train import losses_extra as jax_extra
from tpu_yolo_torch.core.config import get_model_config
from tpu_yolo_torch.ops.boxes import ciou
from tpu_yolo_torch.train import losses_extra
from tpu_yolo_torch.train.loss import (build_padded_targets, detection_loss,
                                       task_aligned_assigner)

torch.set_num_threads(1)
T = torch.from_numpy


def test_ciou_golden_and_jax():
    """Golden within 1e-5 (the limit of tests/test_ops_parity.py); the
    JAX function within 2e-6: the same f32 operations in the same order,
    apart from atan's last ulp."""
    g = load_golden("ciou.npz")
    got = ciou(T(g["b1"]), T(g["b2"])).numpy()
    assert got.shape == g["b1"].shape[:-1] + (1,)
    np.testing.assert_allclose(got.reshape(g["ciou"].shape), g["ciou"], atol=1e-5)
    want = np.asarray(jax_ciou(jnp.asarray(g["b1"]), jnp.asarray(g["b2"])))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_ciou_alpha_takes_no_gradient():
    """d ciou / d box1 equals the JAX gradient (alpha under stop_gradient)."""
    import jax

    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 50, (2, 16, 2))
    b1 = np.concatenate([xy, xy + rng.uniform(4, 30, (2, 16, 2))], -1).astype(np.float32)
    xy = rng.uniform(0, 50, (2, 16, 2))
    b2 = np.concatenate([xy, xy + rng.uniform(4, 30, (2, 16, 2))], -1).astype(np.float32)
    t1 = T(b1).requires_grad_()
    ciou(t1, T(b2)).sum().backward()
    want = jax.grad(lambda a: jax_ciou(a, jnp.asarray(b2)).sum())(jnp.asarray(b1))
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_assigner_golden():
    """The limits of tests/test_loss_parity.py: fg mask equal, boxes at
    foreground anchors within 1e-4, scores within 1e-5."""
    g = load_golden("assigner.npz")
    tb, ts, fg = task_aligned_assigner(
        T(g["pd_scores"]), T(g["pd_boxes"]), T(g["anc"]), T(g["gt_labels"]),
        T(g["gt_boxes"]), T(g["mask_gt"]), num_classes=80)
    fg_ref = g["fg_mask"].astype(bool)
    assert (fg.numpy() == fg_ref).all()
    assert np.abs(tb.numpy()[fg_ref] - g["target_bboxes"][fg_ref]).max() < 1e-4
    assert np.abs(ts.numpy() - g["target_scores"]).max() < 1e-5


def _scene(seed, b=6, n=8, a_grid=8, nc=4, px=8.0):
    """Random predictions and GT on an a_grid x a_grid anchor grid; the
    last image is empty and every image has padded rows (the scene of
    tests/test_assigner_unit.py::test_chunked_assignment_identical)."""
    rng = np.random.default_rng(seed)
    xs = (np.arange(a_grid) + 0.5) * px
    anchors = np.stack(np.meshgrid(xs, xs, indexing="xy"), -1).reshape(-1, 2)
    a = anchors.shape[0]
    pd_scores = rng.uniform(0, 1, (b, a, nc)).astype(np.float32)
    centers = rng.uniform(8, 56, (b, a, 2)).astype(np.float32)
    wh = rng.uniform(8, 32, (b, a, 2)).astype(np.float32)
    pd_boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    gt = np.zeros((b, n, 5), np.float32)
    for i in range(b - 1):
        cnt = int(rng.integers(1, n + 1))
        xy1 = rng.uniform(0, 40, (cnt, 2))
        gt[i, :cnt, 0] = rng.integers(0, nc, cnt)
        gt[i, :cnt, 1:3] = xy1
        gt[i, :cnt, 3:5] = xy1 + rng.uniform(8, 24, (cnt, 2))
    mask = (gt[..., 1:5].sum(-1, keepdims=True) > 0).astype(np.float32)
    return (pd_scores, pd_boxes, anchors.astype(np.float32), gt[..., :1],
            gt[..., 1:5], mask), nc, n * a


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chunks", [None, 1, 2, 3], ids=lambda c: f"chunk{c}")
def test_assigner_matches_jax(seed, chunks):
    """Seeded scenes through both assigners, unchunked and with the
    element budget forced down to 1, 2 and 3 images a chunk: decisions
    equal; target scores within 1e-6 (f32 products in another order)."""
    args, nc, plane = _scene(seed)
    budget = None if chunks is None else chunks * plane
    want = jax_loss.task_aligned_assigner(*map(jnp.asarray, args), num_classes=nc)
    got = task_aligned_assigner(*map(T, args), num_classes=nc, elem_budget=budget)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    assert got[2].any()


def _assign(gt_boxes, gt_labels, a_grid=8, px=8.0):
    """The synthetic problem of tests/test_assigner_unit.py."""
    n = gt_boxes.shape[0]
    xs = (np.arange(a_grid) + 0.5) * px
    anchors = np.stack(np.meshgrid(xs, xs, indexing="xy"), -1).reshape(-1, 2)
    a = anchors.shape[0]
    pd_scores = np.full((1, a, 4), 0.5, np.float32)
    wh = np.full((a, 2), px * 2, np.float32)
    pd_boxes = np.concatenate([anchors - wh / 2, anchors + wh / 2], -1)[None]
    tb, ts, fg = task_aligned_assigner(
        T(pd_scores), T(pd_boxes.astype(np.float32)), T(anchors.astype(np.float32)),
        T(gt_labels.reshape(1, n, 1).astype(np.float32)),
        T(gt_boxes.reshape(1, n, 4).astype(np.float32)),
        T((gt_boxes.sum(-1) > 0).reshape(1, n, 1).astype(np.float32)),
        num_classes=4)
    return tb[0].numpy(), ts[0].numpy(), fg[0].numpy(), anchors


def test_anchor_claimed_by_two_gts_goes_to_higher_iou():
    gt = np.array([[8, 8, 40, 40], [24, 24, 56, 56]], np.float32)
    tb, ts, fg, anchors = _assign(gt, np.array([0, 1], np.float32))
    assert fg.any()
    for i in np.nonzero(fg)[0]:
        assert any(np.allclose(tb[i], g) for g in gt), tb[i]
        ax, ay = anchors[i]
        assert tb[i][0] < ax < tb[i][2] and tb[i][1] < ay < tb[i][3]


def test_padded_rows_never_assigned():
    gt = np.array([[8, 8, 40, 40], [0, 0, 0, 0], [0, 0, 0, 0]], np.float32)
    tb, ts, fg, _ = _assign(gt, np.array([2, 0, 0], np.float32))
    assert fg.any()
    for i in np.nonzero(fg)[0]:
        np.testing.assert_allclose(tb[i], gt[0])
        assert ts[i].argmax() == 2
    assert (ts[~fg] == 0).all()


def test_empty_image_all_background():
    _, ts, fg, _ = _assign(np.zeros((2, 4), np.float32), np.zeros(2, np.float32))
    assert not fg.any() and (ts == 0).all()


def test_512_gt_bucket_runs_chunked():
    b, n = 4, 512
    gt = np.zeros((b, n, 5), np.float32)
    gt[:, 0] = [1, 8, 8, 40, 40]
    xs = (np.arange(8) + 0.5) * 8.0
    anchors = np.stack(np.meshgrid(xs, xs, indexing="xy"), -1).reshape(-1, 2).astype(np.float32)
    a = anchors.shape[0]
    wh = np.full((a, 2), 16.0, np.float32)
    pd_boxes = np.concatenate([anchors - wh / 2, anchors + wh / 2], -1)[None].repeat(b, 0)
    tb, ts, fg = task_aligned_assigner(
        T(np.full((b, a, 4), 0.5, np.float32)), T(pd_boxes), T(anchors),
        T(gt[..., :1]), T(gt[..., 1:5]),
        T((gt[..., 1:5].sum(-1, keepdims=True) > 0).astype(np.float32)),
        num_classes=4, elem_budget=n * a)
    assert fg.shape == (b, a) and bool(fg.any())


def test_build_padded_targets_equals_jax():
    rng = np.random.default_rng(3)
    targets = {"cls": rng.integers(0, 5, (9, 1)).astype(np.float32),
               "box": rng.uniform(0.1, 0.6, (9, 4)).astype(np.float32),
               "idx": np.array([0, 0, 0, 0, 0, 2, 2, 3, 3], np.float32)}
    for max_gt in (3, 8):   # 3 truncates image 0's overflow
        np.testing.assert_array_equal(
            build_padded_targets(targets, 4, max_gt, (100, 200)),
            jax_loss.build_padded_targets(targets, 4, max_gt, (100, 200)))
    empty = {"cls": np.zeros((0, 1)), "box": np.zeros((0, 4)), "idx": np.zeros(0)}
    assert (build_padded_targets(empty, 2, 4, (64, 64)) == 0).all()


def test_full_loss_golden():
    """Reference train maps + synthetic targets: within the 2e-3 of
    tests/test_loss_parity.py."""
    g, gl = load_golden("model_n.npz"), load_golden("loss.npz")
    maps = [T(np.ascontiguousarray(np.transpose(g[f"train_out_{i}"], (0, 2, 3, 1))))
            for i in range(3)]
    gt = build_padded_targets({"idx": gl["idx"], "cls": gl["cls"], "box": gl["box"]},
                              batch_size=2, max_gt=8, input_hw=(256, 256))
    losses = detection_loss(maps, T(gt), {"box": 7.5, "cls": 0.5, "dfl": 1.5},
                            get_model_config("n"))
    for got, name in zip(losses, ("loss_box", "loss_cls", "loss_dfl")):
        assert abs(float(got) - float(gl[name])) < 2e-3 * max(1, float(gl[name])), name


@pytest.mark.parametrize("seed,n_gt", [(0, 3), (1, 8), (2, 0)])
def test_detection_loss_matches_jax(seed, n_gt):
    """Seeded head maps and boxes through both losses, and the gradient
    with respect to the maps: losses within 1e-5 relative (f32 sums in
    another order), gradients within 1e-4 of the largest entry."""
    import jax

    cfg, jcfg = get_model_config("n", 6), jax_config("n", 6)
    rng = np.random.default_rng(seed)
    maps = [rng.normal(0, 1.5, (2, 64 // s, 64 // s, cfg.no)).astype(np.float32)
            for s in cfg.strides]
    gt = np.zeros((2, 8, 5), np.float32)
    for i in range(2):
        xy1 = rng.uniform(0, 30, (n_gt, 2))
        gt[i, :n_gt, 0] = rng.integers(0, 6, n_gt)
        gt[i, :n_gt, 1:3] = xy1
        gt[i, :n_gt, 3:5] = xy1 + rng.uniform(8, 30, (n_gt, 2))
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5}

    def jax_total(ms):
        return sum(jax_loss.detection_loss(ms, jnp.asarray(gt), hyp, jcfg))

    want = jax_loss.detection_loss([jnp.asarray(m) for m in maps],
                                   jnp.asarray(gt), hyp, jcfg)
    want_grads = jax.grad(jax_total)([jnp.asarray(m) for m in maps])
    tmaps = [T(m).requires_grad_() for m in maps]
    got = detection_loss(tmaps, T(gt), hyp, cfg)
    sum(got).backward()
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5, atol=1e-7)
    for t, w in zip(tmaps, want_grads):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6)


@pytest.mark.parametrize("name", ["bce_with_logits", "focal_loss",
                                  "quality_focal_loss", "varifocal_loss"])
def test_extra_losses_match_jax(name):
    """Elementwise f32 formulas: within 1e-6."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (4, 50)).astype(np.float32)
    targets = (rng.uniform(0, 1, (4, 50)) * (rng.random((4, 50)) > 0.5)).astype(np.float32)
    got = getattr(losses_extra, name)(T(logits), T(targets)).numpy()
    want = np.asarray(getattr(jax_extra, name)(jnp.asarray(logits), jnp.asarray(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
