"""The port's space-to-depth stem (models/yolov11.py) against its plain
stem and against the JAX package's transform, on the CPU in f32."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxModelConfig
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
from tpu_yolo_torch.models import yolov11
from tpu_yolo_torch.models.yolov11 import YOLO

torch.set_num_threads(1)
TINY = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                   csp=(False, True), num_classes=8)
JAX_TINY = JaxModelConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                          num_classes=8)


def _folded_params():
    return jax_yolo.fold_batchnorm(jax_yolo.init_params(jax.random.PRNGKey(0),
                                                        JAX_TINY))


def _model(params):
    return YOLO.from_state_dict(TINY, from_jax_params(params, TINY))


def _images(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


def test_stem_space_to_depth_equivalent():
    """The counterpart of tests/test_transforms.py's case: the s2d stem's
    forward equals the plain stem's, a second fold is a no-op, and a
    batch rearranged on the host gives bitwise the device rearrange's
    result."""
    plain = _model(_folded_params())
    s2d = _model(_folded_params()).fold_stem_space_to_depth()
    assert s2d.s2d_stem and not plain.s2d_stem
    assert tuple(s2d.net["p1"][0].w.shape) == (TINY.width[1], 12, 2, 2)
    s2d.fold_stem_space_to_depth()
    assert tuple(s2d.net["p1"][0].w.shape) == (TINY.width[1], 12, 2, 2)

    x = _images()
    with torch.no_grad():
        a = plain(torch.from_numpy(x))
        b = s2d(torch.from_numpy(x))
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        c = s2d(torch.from_numpy(yolov11.space_to_depth_host(x)))
    torch.testing.assert_close(c, b, rtol=0, atol=0)


def test_s2d_forward_matches_jax():
    """The port's s2d forward against tpu_yolo's s2d forward on the same
    folded weights, within tests/test_torch_model.py's tolerances (raw
    maps 2e-4 of max(|ref|, 1); decoded boxes 0.2 px, probabilities
    2e-3), on an image batch and on a host-rearranged one."""
    params = jax_yolo.fold_stem_space_to_depth(_folded_params())
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    assert model.s2d_stem
    for x in (_images(1), yolov11.space_to_depth_host(_images(1))):
        want_raw = jax.jit(jax_yolo.forward_raw, static_argnums=2)(
            params, jnp.asarray(x), JAX_TINY)
        want = jax_yolo.forward(params, jnp.asarray(x), JAX_TINY, train=False)
        with torch.no_grad():
            raw = model.forward_raw(torch.from_numpy(x))
            got = model(torch.from_numpy(x))
        for mine, ref in zip(raw, want_raw):
            ref = np.asarray(ref)
            err = np.max(np.abs(mine.numpy() - ref) / np.maximum(np.abs(ref), 1.0))
            assert err < 2e-4, err
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (2, 84, 4 + 8)
        assert np.max(np.abs(got[..., :4] - want[..., :4])) < 0.2
        assert np.max(np.abs(got[..., 4:] - want[..., 4:])) < 2e-3


def test_s2d_weights_cross_both_ways():
    """The port's fold of the stem equals the JAX package's bit for bit,
    folded or not, and the s2d weights cross from_jax_params and
    to_jax_params under the stem's own key."""
    for folded in (False, True):
        params = jax_yolo.init_params(jax.random.PRNGKey(3), JAX_TINY)
        if folded:
            params = jax_yolo.fold_batchnorm(params)
        want = jax_yolo.fold_stem_space_to_depth(params)
        state = yolov11.fold_stem_space_to_depth(from_jax_params(params, TINY))
        mine = to_jax_params(state)
        np.testing.assert_array_equal(mine["net"]["p1"][0]["w"],
                                      np.asarray(want["net"]["p1"][0]["w"]))
        back = from_jax_params(want, TINY)
        torch.testing.assert_close(back["net.p1.0.w"], state["net.p1.0.w"],
                                   rtol=0, atol=0)
        model = YOLO.from_state_dict(TINY, back)
        assert model.s2d_stem
        np.testing.assert_array_equal(to_jax_params(model)["net"]["p1"][0]["w"],
                                      np.asarray(want["net"]["p1"][0]["w"]))


def test_space_to_depth_host_and_input_hw():
    x = np.random.default_rng(2).integers(0, 256, (2, 8, 6, 3), np.uint8)
    mine = yolov11.space_to_depth_host(x)
    np.testing.assert_array_equal(mine, jax_yolo.space_to_depth_host(x))
    assert mine.shape == (2, 4, 3, 12) and mine.dtype == np.uint8
    torch.testing.assert_close(yolov11._space_to_depth2(torch.from_numpy(x)),
                               torch.from_numpy(mine), rtol=0, atol=0)
    for a in (x, mine):
        assert yolov11._input_hw(a, TINY) == jax_yolo._input_hw(a, JAX_TINY)
    assert yolov11._input_hw(mine, TINY) == (8, 6)
