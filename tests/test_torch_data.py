"""The port's training data path (its own copies of the numpy/cv2
modules) against the JAX package's: with `random` and `np.random` seeded
alike, labels, samples and batches are equal byte for byte."""
import random

import numpy as np
import pytest

from tpu_yolo.core.config import load_hyperparams as jax_hyp
from tpu_yolo.data import augment as jax_augment
from tpu_yolo.data import image as jax_image
from tpu_yolo.data.dataset import DetectionDataset as JaxDataset
from tpu_yolo.data.dataset import collate as jax_collate
from tpu_yolo.data.labels import load_labels as jax_load_labels
from tpu_yolo.data.loader import DataLoader as JaxLoader
from tpu_yolo.data.loader import ShardSampler as JaxSampler
from tpu_yolo_torch.core.config import load_hyperparams
from tpu_yolo_torch.data import augment, image
from tpu_yolo_torch.data.dataset import DetectionDataset, collate
from tpu_yolo_torch.data.labels import load_labels
from tpu_yolo_torch.data.loader import DataLoader, ShardSampler
from tpu_yolo_torch.seeded import write_mini_coco


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    root = write_mini_coco(str(tmp_path_factory.mktemp("mini_coco")), 8, 2)
    with open(f"{root}/train2017.txt") as f:
        return root, [line.strip() for line in f if line.strip()]


def _seed(seed):
    random.seed(seed)
    np.random.seed(seed)


def _hyp(**over):
    hyp = load_hyperparams()
    assert hyp == jax_hyp()
    hyp.update(over)
    return hyp


def _same_sample(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_mini_coco_layout(mini_coco):
    root, files = mini_coco
    assert len(files) == 8
    labels = load_labels(files, None)
    assert all(v.shape == (1, 5) for v in labels.values())


def test_labels_equal(mini_coco, tmp_path):
    _, files = mini_coco
    mine = load_labels(files, str(tmp_path / "a.cache"))
    ref = jax_load_labels(files, str(tmp_path / "b.cache"))
    assert list(mine) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])
    # either package reads the cache file the other wrote
    again = load_labels(files, str(tmp_path / "b.cache"))
    assert list(again) == list(ref)


@pytest.mark.parametrize("augment_on", [False, True])
def test_load_image_and_letterbox_equal(mini_coco, augment_on):
    _, files = mini_coco
    for size in (64, 200):
        _seed(size)
        img, hw = image.load_image(files[0], size, augment_on)
        boxed, ratio, pad = image.letterbox(img, size, augment_on)
        _seed(size)
        rimg, rhw = jax_image.load_image(files[0], size, augment_on)
        rboxed, rratio, rpad = jax_image.letterbox(rimg, size, augment_on)
        np.testing.assert_array_equal(img, rimg)
        np.testing.assert_array_equal(boxed, rboxed)
        assert (hw, ratio, pad) == (rhw, rratio, rpad)


@pytest.mark.parametrize("over", [
    {}, {"mix_up": 1.0}, {"mosaic": 0.0}, {"degrees": 10.0, "shear": 5.0, "flip_ud": 0.5},
], ids=["default", "mixup", "no-mosaic", "rotate-shear-flipud"])
def test_training_samples_equal(mini_coco, over, tmp_path):
    """mosaic4, mixup, random_affine, HSV and flips draw the same numbers
    in the same order."""
    _, files = mini_coco
    hyp = _hyp(**over)
    mine = DetectionDataset(files, 64, hyp, augment=True, cache_path=str(tmp_path / "m"))
    ref = JaxDataset(files, 64, hyp, augment=True, cache_path=str(tmp_path / "r"))
    for index in range(len(ref)):
        _seed(index)
        a = mine[index]
        _seed(index)
        b = ref[index]
        _same_sample(a, b)
        assert a[0].shape == (64, 64, 3) and a[0].dtype == np.uint8


def test_eval_samples_equal(mini_coco, tmp_path):
    _, files = mini_coco
    hyp = _hyp()
    mine = DetectionDataset(files, 96, hyp, augment=False, cache_path=str(tmp_path / "m"))
    ref = JaxDataset(files, 96, hyp, augment=False, cache_path=str(tmp_path / "r"))
    for index in range(len(ref)):
        _same_sample(mine[index], ref[index])


def test_augment_functions_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (64, 80, 3), np.uint8)
    label = np.array([[1, 10, 12, 50, 40], [0, 30, 5, 70, 60]], np.float64)
    hyp = _hyp(degrees=15.0, shear=4.0)
    _seed(5)
    a_img, a_lbl = augment.random_affine(img.copy(), label.copy(), hyp)
    a_hsv = augment.hsv_jitter(a_img.copy(), 0.015, 0.7, 0.4)
    a_photo = augment.photometric_jitter(img.copy(), p=0.9)
    _seed(5)
    b_img, b_lbl = jax_augment.random_affine(img.copy(), label.copy(), hyp)
    b_hsv = jax_augment.hsv_jitter(b_img.copy(), 0.015, 0.7, 0.4)
    b_photo = jax_augment.photometric_jitter(img.copy(), p=0.9)
    np.testing.assert_array_equal(a_img, b_img)
    np.testing.assert_array_equal(a_lbl, b_lbl)
    np.testing.assert_array_equal(a_hsv, b_hsv)
    np.testing.assert_array_equal(a_photo, b_photo)
    box = np.array([[0.5, 0.5, 0.2, 0.4]])
    np.testing.assert_array_equal(augment.denorm_corners(box, 64, 48, 3, 2),
                                  jax_augment.denorm_corners(box, 64, 48, 3, 2))
    corners = np.array([[-4.0, 3.0, 70.0, 50.0]])
    np.testing.assert_array_equal(augment.corners_to_norm(corners.copy(), 64, 48),
                                  jax_augment.corners_to_norm(corners.copy(), 64, 48))


def test_loader_batches_equal(mini_coco, tmp_path):
    """Two epochs of shuffled training batches, one worker thread (with
    more, the order in which threads draw from the shared generators is
    not fixed in either package)."""
    _, files = mini_coco
    hyp = _hyp()
    kw = dict(shuffle=True, num_workers=1, drop_last=True)
    mine = DataLoader(DetectionDataset(files, 64, hyp, True, str(tmp_path / "m")), 3, **kw)
    ref = JaxLoader(JaxDataset(files, 64, hyp, True, str(tmp_path / "r")), 3, **kw)
    assert len(mine) == len(ref) == 2
    for epoch in range(2):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        _seed(epoch)
        got = list(mine)
        _seed(epoch)
        want = list(ref)
        assert len(got) == len(want) == 2
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert gi.shape == (3, 64, 64, 3)
            assert gt.keys() == wt.keys() == {"cls", "box", "idx"}
            for k in wt:
                np.testing.assert_array_equal(gt[k], wt[k])


def test_collate_and_keep_last_batch_equal(mini_coco, tmp_path):
    _, files = mini_coco
    ds = DetectionDataset(files, 64, _hyp(), False, str(tmp_path / "m"))
    samples = [ds[i] for i in range(3)]
    (gi, gt), (wi, wt) = collate(samples), jax_collate(samples)
    np.testing.assert_array_equal(gi, wi)
    for k in wt:
        np.testing.assert_array_equal(gt[k], wt[k])
    loader = DataLoader(ds, 3, shuffle=False, num_workers=2)
    assert len(loader) == 3 and [len(b[0]) for b in loader] == [3, 3, 2]


@pytest.mark.parametrize("n,shards", [(10, 4), (8, 2), (7, 3)])
def test_shard_sampler_equal(n, shards):
    for epoch in range(2):
        parts = [ShardSampler(n, shards, s).indices(epoch) for s in range(shards)]
        for s, part in enumerate(parts):
            np.testing.assert_array_equal(part, JaxSampler(n, shards, s).indices(epoch))
        assert len({len(p) for p in parts}) == 1
        assert set(np.concatenate(parts)) == set(range(n))
