"""Every model size of the port against the JAX package, in f32 on the
CPU: each size's forward, BatchNorm folded and not, and its detections;
then one training forward and backward of v11-x.

Weights: `init_params(3)` of each size with every BatchNorm's statistics
set from one f32 pass over 8 seeded 64 px images and the class biases
drawn around -3 (seeded.serving_state), the serving weights of
chip_smoke.py at this size; the forward runs on the first of the images.
(`init_params` alone shrinks activations about 3x a layer, so the head
outputs its biases and both packages agree exactly; statistics set from
other images or sizes let the residual sums grow into the thousands at
v11-x, where both packages' f32 forwards are 1e-2 from an f64 one.)

Tolerances: the raw head maps within 2e-3 of max(|ref|, 1), near the
1.1-2.6e-3 of v11-n's head on the golden weights (ROADMAP, Queue 3);
measured 3.1e-5 to 5.5e-4, v11-x the largest, where the port's f32 is
as far from an f64 run of itself as JAX's. Detections (3 to 13 an image
at conf 0.25): each package's NMS of its own maps, the same counts and
classes, boxes within 0.05 px and scores within 5e-4 (measured 4.4e-3 px
and 4.3e-5 at most, at v11-x); and both NMS implementations on JAX's
maps, equal as tests/test_torch_nms.py holds them.

v11-x's training step: losses within 1e-4 relative, every gradient leaf
within 5e-3 of its largest entry and the median within 1e-3, the
tolerances of tests/test_torch_train.py::test_loss_and_grads_match_jax,
at batch 2 and 128 px. At 64 px BatchNorm sees 8 values a channel at
p5 and v11-x's 170 normalized layers amplify f32 rounding: there JAX's
own step is 3.0e-4 from an f64 run of the port in losses and 9.1e-2 in
gradients (the port's 8.5e-5 and 2.9e-2), past those tolerances; at
128 px both are within them (measured: losses 2.6e-5 apart, gradients
3.7e-3 at worst, median 7.9e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import get_model_config as jax_config
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.ops import nms as jax_nms
from tpu_yolo.train import step as jax_step
from tpu_yolo_torch.core.config import MODEL_CONFIGS, get_model_config
from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops import nms
from tpu_yolo_torch.seeded import serving_state
from tpu_yolo_torch.train.step import loss_and_grads

torch.set_num_threads(1)

RAW_TOL = 2e-3
SIZE = 64
NMS = dict(conf_thres=0.25, iou_thres=0.65, max_det=300, max_nms=1024)
GAINS = np.asarray([7.5, 0.5, 1.5], np.float32)

# jitted once per config: far quicker on the CPU than op-by-op dispatch
_jax_raw = jax.jit(jax_yolo.forward_raw, static_argnums=2)


def _images():
    return np.random.default_rng(0).integers(0, 256, (8, SIZE, SIZE, 3), np.uint8)


def _close(mine, ref):
    """Max error relative to max(|ref|, 1), as tests/test_torch_model.py."""
    mine, ref = np.asarray(mine, np.float32), np.asarray(ref, np.float32)
    assert mine.shape == ref.shape
    return float(np.max(np.abs(mine - ref) / np.maximum(np.abs(ref), 1.0)))


@pytest.fixture(scope="module", params=sorted(MODEL_CONFIGS))
def size_state(request):
    size = request.param
    return size, serving_state(get_model_config(size), 3, _images(), "cpu")


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_forward_and_detections_match_jax(size_state, folded):
    size, state = size_state
    cfg, jcfg = get_model_config(size), jax_config(size)
    model = YOLO.from_state_dict(cfg, state)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(state))
    if folded:
        model.fold_batchnorm()
        params = jax_yolo.fold_batchnorm(params)
    x = _images()[:1].astype(np.float32) / 255
    with torch.inference_mode():
        mine = model.eval().forward_raw(torch.from_numpy(x))
    ref = [np.asarray(r) for r in _jax_raw(params, jnp.asarray(x), jcfg)]
    errs = [_close(a, b) for a, b in zip(mine, ref)]
    assert max(errs) < RAW_TOL, errs

    # each package's detections of its own maps
    got = nms.nms_from_raw(mine, cfg, (SIZE, SIZE), **NMS)
    want = jax_nms.nms_from_raw([jnp.asarray(r) for r in ref], jcfg, (SIZE, SIZE), **NMS)
    count = int(want["count"][0])
    assert 0 < count == int(got["count"][0])
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy()[0, :count],
                               np.asarray(want["boxes"])[0, :count], atol=0.05)
    np.testing.assert_allclose(got["scores"].numpy()[0, :count],
                               np.asarray(want["scores"])[0, :count], atol=5e-4)

    # both NMS implementations on the same (JAX's) maps
    same = nms.nms_from_raw([torch.from_numpy(np.array(r)) for r in ref], cfg,
                            (SIZE, SIZE), **NMS)
    for key in ("count", "valid", "classes"):
        np.testing.assert_array_equal(same[key].numpy(), np.asarray(want[key]), err_msg=key)
    v = np.asarray(want["valid"])
    np.testing.assert_allclose(same["boxes"].numpy()[v], np.asarray(want["boxes"])[v],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(same["scores"].numpy()[v], np.asarray(want["scores"])[v],
                               rtol=1e-4, atol=1e-4)


def _flat(tree, prefix=""):
    """{dotted path: numpy leaf} of a JAX-layout tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def test_x_training_step_matches_jax():
    """One f32 forward and backward of v11-x's `init_params(3)` on 2
    seeded 128 px images with 3 boxes: losses and every gradient leaf
    against the JAX package's `loss_and_grads` (the step's own), at the
    tolerances of tests/test_torch_train.py (module docstring)."""
    cfg, jcfg = get_model_config("x"), jax_config("x")
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 128, 128, 3), np.uint8)
    gt = np.zeros((2, 2, 5), np.float32)
    gt[:, 0] = [1, 8.0, 8.0, 40.0, 40.0]
    gt[0, 1] = [3, 20.0, 30.0, 60.0, 50.0]
    params = init_params(3, cfg)
    model = YOLO.from_state_dict(cfg, from_jax_params(params, cfg)).train()
    jl, jgrads = jax.jit(jax_step.loss_and_grads, static_argnames=("cfg",))(
        params, jnp.asarray(images), jnp.asarray(gt), GAINS, cfg=jcfg)
    losses, grads = loss_and_grads(model, torch.from_numpy(images),
                                   torch.from_numpy(gt), GAINS, cfg=cfg)
    np.testing.assert_allclose([float(v) for v in losses], [float(v) for v in jl],
                               rtol=1e-4)
    got, want = _flat(to_jax_params(grads)), _flat(jgrads)
    assert set(got) == {k for k in want if k.rsplit(".", 1)[1] not in ("mean", "var")}
    rel = {k: np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-5)
           for k in got}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 5e-3, (worst, rel[worst])
    assert np.median(list(rel.values())) < 1e-3
