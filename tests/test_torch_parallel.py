"""The port's data axis in one process, against the JAX package on its 8
virtual CPU devices: make_mesh / DataParallel, Detector(dp=...) against
the plain Detector and JAX's Detector(dp=...), the sharded eval loaders
and evaluate(dp=...), and the last gaps of the module map (xyxy_to_xywh,
num_anchors, nms_to_numpy, the native pool's letterbox entry points and
the Detector's host decode through them)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.data import native_loader as jax_native_loader
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.ops import anchors as jax_anchors
from tpu_yolo.ops import boxes as jax_boxes
from tpu_yolo.ops import nms as jax_nms
from tpu_yolo.parallel import DataParallel as JaxDataParallel
from tpu_yolo.parallel import make_mesh as jax_make_mesh
from tpu_yolo.serve import Detector as JaxDetector
from tpu_yolo_torch import DataParallel, make_mesh
from tpu_yolo_torch.core.config import ModelConfig, load_hyperparams
from tpu_yolo_torch.data import native_loader
from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
from tpu_yolo_torch.data.image import bgr_hwc_to_rgb, letterbox, load_image
from tpu_yolo_torch.data.loader import make_val_loader, shard_rows
from tpu_yolo_torch.eval.evaluator import evaluate
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.anchors import make_anchors, num_anchors
from tpu_yolo_torch.ops.boxes import xyxy_to_xywh
from tpu_yolo_torch.ops.nms import nms_to_numpy
from tpu_yolo_torch.parallel.mesh import Mesh
from tpu_yolo_torch.seeded import eval_state, label_from_detections, write_mini_coco
from tpu_yolo_torch.serve import Detector

torch.set_num_threads(1)

_TINY = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True),
             num_classes=8)
TINY, JTINY = ModelConfig(**_TINY), JaxConfig(**_TINY)
SIZE = 64
EVAL_SIZE = 128


def _params(seed=0):
    """TINY weights, class biases lifted to about -1 so that random images
    give candidates above the serving conf."""
    rng = np.random.default_rng(seed)
    params = init_params(seed, TINY)
    for level in params["head"]["cls"]:
        level[4]["b"] = rng.normal(-1.0, 0.5, level[4]["b"].shape).astype(np.float32)
    return params


def _model(params):
    return YOLO.from_state_dict(TINY, from_jax_params(params, TINY))


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, SIZE // 8, SIZE // 8, 3), dtype=np.uint8)
    return np.ascontiguousarray(img.repeat(8, 1).repeat(8, 2))


# -- the data axis --------------------------------------------------------


def test_make_mesh_and_data_parallel_shapes():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == {"data": 3} and mesh.process_count == 1
    assert make_mesh(n_data=2, devices=["cpu"] * 3).shape == {"data": 2}
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(n_data=4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="have 0"):
            make_mesh()      # every visible card, and there is none
    dp = DataParallel(mesh)
    assert dp.num_data_shards == 3
    assert dp.devices == (torch.device("cpu"),) * 3
    # the process form: rank 2 of 4, one device each
    ranks = DataParallel(Mesh((torch.device("cpu"),), process_count=4, process_index=2))
    assert ranks.num_data_shards == 4 and ranks.rows(8) == slice(4, 6)
    with pytest.raises(ValueError, match="does not split over 4 processes"):
        ranks.rows(6)


def test_shard_batch_rows_match_jax():
    """shard_batch gives each device the contiguous rows JAX's batch
    sharding puts on its devices; gather puts them back in order."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jdp = JaxDataParallel(jax_make_mesh(n_data=2))
    shards = sorted(jdp.shard_batch(jnp.asarray(x)).addressable_shards,
                    key=lambda s: s.index[0].start)
    parts = DataParallel(make_mesh(devices=["cpu", "cpu"])).shard_batch(x)
    assert [p.shape for p in parts] == [(4, 3), (4, 3)]
    for p, s in zip(parts, shards):
        np.testing.assert_array_equal(p.numpy(), np.asarray(s.data))
    dp = DataParallel(make_mesh(devices=["cpu", "cpu"]))
    out = dp.gather([{"v": p, "k": torch.tensor(7)} for p in parts])
    np.testing.assert_array_equal(out["v"].numpy(), x)
    assert int(out["k"]) == 7
    with pytest.raises(ValueError, match="does not split over 2 devices"):
        dp.shard_batch(x[:7])


# -- Detector(dp=...) -----------------------------------------------------


@pytest.fixture(scope="module")
def detectors():
    params = _params()
    kw = dict(input_size=SIZE, conf_thres=0.05, compute_dtype=torch.float32,
              ranking="exact")
    plain = Detector(_model(params), device="cpu", **kw)
    sharded = Detector(_model(params), dp=make_mesh(devices=["cpu", "cpu"]), **kw)
    jax_det = JaxDetector(jax_yolo.fold_batchnorm(params), JTINY, input_size=SIZE,
                          conf_thres=0.05, compute_dtype=jnp.float32, ranking="exact",
                          dp=JaxDataParallel(jax_make_mesh(n_data=2)))
    return plain, sharded, jax_det


def test_dp_detector_matches_plain_and_jax(detectors):
    """Detector(dp=make_mesh(devices=["cpu", "cpu"])) against the plain
    Detector (bit-equal: each replica runs the same program on its rows)
    and JAX's Detector(dp=DataParallel(make_mesh(n_data=2))): counts and
    classes equal, boxes within 1e-4 (tests/test_parallel.py's tolerance)."""
    plain, sharded, jax_det = detectors
    assert sharded.device == torch.device("cpu") and len(sharded._replicas) == 2
    imgs = _images(4)
    mine, one = sharded.detect_batch(imgs), plain.detect_batch(imgs)
    assert int(mine["count"].sum()) > 0
    for k in one:
        assert torch.equal(mine[k], one[k]), k
    ref = jax.device_get(jax_det.detect_batch(imgs))
    np.testing.assert_array_equal(mine["count"].numpy(), ref["count"])
    np.testing.assert_array_equal(mine["classes"].numpy(), ref["classes"])
    np.testing.assert_allclose(mine["boxes"].numpy(), ref["boxes"], rtol=1e-5, atol=1e-4)


def test_dp_detector_streams_like_the_plain_one(detectors, jpegs):
    plain, sharded, _ = detectors
    a = list(sharded.stream(jpegs, batch_size=2))
    b = list(plain.stream(jpegs, batch_size=2))
    assert [r["path"] for r in a] == jpegs
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["boxes"], y["boxes"])
        np.testing.assert_array_equal(x["classes"], y["classes"])


def test_dp_detector_refusals(detectors, tmp_path):
    """An indivisible batch is refused, and so is save_compiled (JAX
    serve.py:297-301), and a device that is not dp's first."""
    _, sharded, _ = detectors
    with pytest.raises(ValueError, match="does not split over 2 devices"):
        sharded.detect_batch(_images(3))
    with pytest.raises(ValueError, match="does not split over 2 devices"):
        list(sharded.stream(["x.jpg"], batch_size=3))
    with pytest.raises(NotImplementedError, match="Detector without dp"):
        sharded.save_compiled(str(tmp_path / "p.zip"), 2)
    with pytest.raises(ValueError, match="not the first device of dp"):
        Detector(_model(_params()), device="cuda", dp=make_mesh(devices=["cpu"]))


# -- sharded eval -----------------------------------------------------------


def test_shard_rows_partition_each_batch():
    for n, bs, count in ((10, 4, 2), (3, 8, 4), (16, 8, 1)):
        for start in range(0, n, bs):
            parts = [shard_rows(start, bs, n, (i, count)) for i in range(count)]
            assert [j for p in parts for j in p] == list(shard_rows(start, bs, n))
            assert all(len(p) <= bs // count for p in parts)
    with pytest.raises(ValueError, match="does not split over 3"):
        shard_rows(0, 8, 10, (0, 3))


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    """10 val images at 128 px labelled by eval_state's own detections, so
    that mAP is far from 0."""
    root = write_mini_coco(str(tmp_path_factory.mktemp("dp_val")), 0, n_val=10,
                           hw=(96, 128))
    files = split_files(root, "val2017")
    images = np.stack([bgr_hwc_to_rgb(letterbox(load_image(f, EVAL_SIZE)[0], EVAL_SIZE)[0])
                       for f in files])
    state = eval_state(TINY, 0, images, "cpu")
    label_from_detections(root, YOLO.from_state_dict(TINY, state), EVAL_SIZE, per_image=12)
    hyp = load_hyperparams()
    hyp["names"] = {i: str(i) for i in range(8)}
    return DetectionDataset(files, EVAL_SIZE, hyp, augment=False), state


@pytest.mark.parametrize("native", ["off", "on"])
def test_sharded_loaders_cover_each_batch(val_split, native):
    """Each process's loader yields its contiguous rows of every batch,
    empty ones included, so that all yield as many batches; put together
    they are the unsharded loader's batches."""
    dataset, _ = val_split
    if native == "on" and not native_loader.available():
        pytest.skip("the native library does not load here")
    whole = list(make_val_loader(dataset, 8, num_workers=1, native=native))
    parts = [list(make_val_loader(dataset, 8, num_workers=1, native=native,
                                  shard=(i, 4))) for i in range(4)]
    assert all(len(p) == len(whole) == 2 for p in parts)
    assert [len(p[1][0]) for p in parts] == [2, 0, 0, 0]
    for b, (images, targets) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[b][0] for p in parts]), images)
        base = np.cumsum([0] + [len(p[b][0]) for p in parts])
        idx = np.concatenate([p[b][1]["idx"] + base[i] for i, p in enumerate(parts)])
        np.testing.assert_array_equal(idx, targets["idx"])
        np.testing.assert_array_equal(np.concatenate([p[b][1]["box"] for p in parts]),
                                      targets["box"])


def test_evaluate_over_two_devices_equals_one(val_split):
    """evaluate(dp=make_mesh(devices=["cpu", "cpu"])) splits each batch
    over two replicas: the same tuple as one device, mAP far from 0."""
    dataset, state = val_split
    loader = make_val_loader(dataset, 4, num_workers=1, native="off")
    env_one, env_dp = {}, {}
    one = evaluate(YOLO.from_state_dict(TINY, state), loader, EVAL_SIZE,
                   compute_dtype=torch.float32, device="cpu", envelope_stats=env_one)
    two = evaluate(YOLO.from_state_dict(TINY, state), loader, EVAL_SIZE,
                   compute_dtype=torch.float32, dp=make_mesh(devices=["cpu", "cpu"]),
                   envelope_stats=env_dp)
    assert one[0] > 0.1 and one == two and env_one == env_dp
    with pytest.raises(ValueError, match="shard="):
        evaluate(YOLO.from_state_dict(TINY, state), loader, EVAL_SIZE,
                 dp=DataParallel(Mesh((torch.device("cpu"),), process_count=2)))


# -- the last module-map gaps ----------------------------------------------


def test_xyxy_to_xywh_and_num_anchors_match_jax():
    box = np.random.default_rng(0).uniform(0, 100, (2, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(xyxy_to_xywh(torch.from_numpy(box)).numpy(),
                                  np.asarray(jax_boxes.xyxy_to_xywh(jnp.asarray(box))))
    for hw in ((640, 640), (480, 640), (64, 96), (100, 36)):
        assert num_anchors(hw) == jax_anchors.num_anchors(hw) == len(make_anchors(hw)[0])
    assert num_anchors((64, 64), (8, 16)) == jax_anchors.num_anchors((64, 64), (8, 16))


def test_nms_to_numpy_matches_jax(detectors):
    plain, _, _ = detectors
    res = plain.detect_batch(_images(2, seed=5))
    as_numpy = {k: v.numpy() for k, v in res.items()}
    for i in range(2):
        got = nms_to_numpy(res, i)
        assert got.shape == (int(res["count"][i]), 6) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_nms.nms_to_numpy(as_numpy, i))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """JPEGs of mixed sizes, smaller and larger than SIZE, and a PNG that
    libjpeg cannot read (the cv2 fallback's slot)."""
    import cv2

    root = tmp_path_factory.mktemp("dp_jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(48, 80), (100, 60), (64, 64), (30, 41)]):
        img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), np.uint8), (5, 5), 2)
        paths.append(str(root / f"im{i}.{'png' if i == 3 else 'jpg'}"))
        cv2.imwrite(paths[-1], img)
    return paths


@pytest.mark.parametrize("allow_upscale", [False, True])
def test_native_letterbox_entry_points_equal_jax(jpegs, allow_upscale):
    """NativePipeline.load_one / load_batch (with the cv2 fallback for the
    PNG) equal the JAX package's bit for bit: one library, one fill."""
    if not native_loader.available():
        pytest.skip("the native library does not load here")
    mine = native_loader.NativePipeline(SIZE, threads=2, allow_upscale=allow_upscale)
    ref = jax_native_loader.NativePipeline(SIZE, threads=2, allow_upscale=allow_upscale)
    got, want = mine.load_batch(jpegs), ref.load_batch(jpegs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2] == 0
    with open(jpegs[0], "rb") as f:
        data = f.read()
    (img, meta), (img_ref, meta_ref) = mine.load_one(data), ref.load_one(data)
    np.testing.assert_array_equal(img, img_ref)
    assert meta == meta_ref
    with pytest.raises(ValueError, match="JPEG decode failed"):
        mine.load_one(b"not a jpeg")


def test_detector_host_decode_takes_the_native_pool(jpegs):
    """Where the library loads the Detector's host letterbox decode is the
    native pool's, with allow_upscale (JAX serve.py:411-424): bit-equal to
    the JAX Detector's decode."""
    if not native_loader.available() or not jax_native_loader.available():
        pytest.skip("the native library does not load here")
    det = Detector(_model(_params()), input_size=SIZE, device="cpu",
                   compute_dtype=torch.float32)
    assert det.stager is None
    imgs = np.zeros((len(jpegs), SIZE, SIZE, 3), np.uint8)
    metas = det._decode_batch(jpegs, imgs)
    assert det.stager == "native"
    ref = JaxDetector(jax_yolo.fold_batchnorm(_params()), JTINY, input_size=SIZE)
    want_imgs, want_metas, nfail = ref._decode_batch(jpegs)
    assert nfail == 0
    np.testing.assert_array_equal(imgs, want_imgs)
    np.testing.assert_array_equal(metas, want_metas)
