"""The port's model (tpu_yolo_torch) against the JAX package and the
reference goldens, in f32 on the CPU: seeded init, the weight bridges,
intermediate features, raw head maps and the eval decode."""
import numpy as np
import pytest
import torch

import jax

from conftest import load_golden
from tpu_yolo.core.config import get_model_config as jax_config
from tpu_yolo.io.weights import export_ultralytics_state_dict
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo_torch.core.config import MODEL_CONFIGS, get_model_config
from tpu_yolo_torch.io.weights import convert_state_dict, from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params

torch.set_num_threads(1)

# jitted once per config: far quicker on the CPU than op-by-op dispatch
_jax_raw = jax.jit(jax_yolo.forward_raw, static_argnums=2)
_jax_decoded = jax.jit(jax_yolo.forward, static_argnums=2)


def _close(mine, ref, tol=2e-4, name=""):
    """Max error relative to max(|ref|, 1), as tests/test_model_parity.py."""
    mine = np.asarray(mine, np.float32)
    ref = np.asarray(ref, np.float32)
    assert mine.shape == ref.shape, f"{name}: {mine.shape} vs {ref.shape}"
    err = np.max(np.abs(mine - ref) / np.maximum(np.abs(ref), 1.0))
    assert err < tol, f"{name}: max rel err {err:.2e}"


def _close_decoded(mine, ref, name):
    """Decoded predictions: boxes within 0.2 px, class probabilities
    within 2e-3 (the tolerances of tests/test_model_parity.py)."""
    mine = np.asarray(mine, np.float32)
    ref = np.asarray(ref, np.float32)
    assert mine.shape == ref.shape, f"{name}: {mine.shape} vs {ref.shape}"
    box_err = np.max(np.abs(mine[:, :4] - ref[:, :4]))
    cls_err = np.max(np.abs(mine[:, 4:] - ref[:, 4:]))
    assert box_err < 0.2, f"{name}: box err {box_err:.3f} px"
    assert cls_err < 2e-3, f"{name}: prob err {cls_err:.2e}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("size", sorted(MODEL_CONFIGS))
def test_init_params_bit_identical(size):
    mine = dict(_leaves(init_params(5, get_model_config(size))))
    ref = dict(_leaves(jax_yolo.init_params(5, jax_config(size))))
    assert mine.keys() == ref.keys()
    for path, a in ref.items():
        b = mine[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        assert np.array_equal(a, b), path


@pytest.fixture(scope="module")
def golden():
    g = load_golden("model_n.npz")
    state = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    cfg = get_model_config("n")
    sd = convert_state_dict(state, cfg, source_format="reference")
    x = torch.from_numpy(np.ascontiguousarray(
        np.transpose(g["input"], (0, 2, 3, 1))))          # NCHW -> NHWC
    return g, cfg, sd, x


def _features(model, x):
    """Backbone p3-p5 and FPN f3-f5 (NCHW), caught by forward hooks."""
    taps = {"p3": model.net["p3"][1], "p4": model.net["p4"][1],
            "p5": model.net["p5"][3], "f3": model.fpn["h2"],
            "f4": model.fpn["h4"], "f5": model.fpn["h6"]}
    got = {}
    hooks = [m.register_forward_hook(
        lambda _m, _i, out, name=name: got.__setitem__(name, out))
        for name, m in taps.items()]
    try:
        with torch.inference_mode():
            decoded = model(x)
    finally:
        for h in hooks:
            h.remove()
    return got, decoded


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_golden_features_and_eval_out(golden, folded):
    g, cfg, sd, x = golden
    model = YOLO.from_state_dict(cfg, sd).eval()
    if folded:
        model.fold_batchnorm()
    feats, decoded = _features(model, x)
    for name in ("p3", "p4", "p5", "f3", "f4", "f5"):
        _close(feats[name], g[name], name=name)
    _close_decoded(decoded.permute(0, 2, 1), g["eval_out"], "eval_out")


def test_golden_raw_maps(golden):
    """On the golden weights and input, the port's raw head maps equal
    the JAX package's forward_raw (rel 2e-4)."""
    from tpu_yolo.io.weights import convert_state_dict as jax_convert

    g, cfg, sd, x = golden
    model = YOLO.from_state_dict(cfg, sd).eval()
    state = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    jparams = jax_convert(state, jax_yolo.init_params(0, jax_config("n")),
                          source_format="reference")
    want = _jax_raw(jparams, x.numpy(), jax_config("n"))
    with torch.inference_mode():
        got = model.forward_raw(x)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, np.asarray(b), name=f"raw_{i}")


@pytest.mark.parametrize("size,hw", [("n", 96), ("m", 64)])
def test_forward_raw_matches_jax(size, hw):
    """Same params through from_jax_params, same input: the port's raw
    head maps equal the JAX package's in f32 (rel 2e-4)."""
    params = jax_yolo.init_params(11, jax_config(size))
    model = YOLO.from_state_dict(get_model_config(size),
                                 from_jax_params(params, get_model_config(size)))
    x = np.random.default_rng(3).uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    want = _jax_raw(params, x, jax_config(size))
    with torch.inference_mode():
        got = model.eval().forward_raw(torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, np.asarray(b), name=f"{size} raw_{i}")


def test_folded_params_bridge():
    """A BN-folded JAX tree loads into a folded model that gives the
    JAX package's decoded output."""
    cfg = get_model_config("n")
    params = jax_yolo.fold_batchnorm(jax_yolo.init_params(2, jax_config("n")))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = YOLO.from_state_dict(cfg, from_jax_params(params, cfg)).eval()
    assert all(not k.endswith(".gamma") for k in model.state_dict())
    x = np.random.default_rng(4).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(_jax_decoded(params, x, jax_config("n")))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _close_decoded(got.transpose(0, 2, 1), want.transpose(0, 2, 1), "folded")


def test_fold_input_scale_matches_jax():
    cfg = get_model_config("n")
    params = jax_yolo.init_params(6, jax_config("n"))
    want = dict(_leaves(jax_yolo.fold_input_scale(params)))["/net/p1/0/w"]
    model = YOLO.from_state_dict(cfg, from_jax_params(params, cfg))
    got = model.fold_input_scale().net["p1"][0].w.detach().numpy()
    assert np.array_equal(got, np.asarray(want).transpose(3, 2, 0, 1))


def test_ultralytics_names_convert_to_the_same_state():
    """Ultralytics-named weights (exported by the JAX package) convert to
    the state dict that from_jax_params builds from the same tree."""
    cfg = get_model_config("n")
    params = jax_yolo.init_params(8, jax_config("n"))
    ultra = export_ultralytics_state_dict(params, jax_config("n"))
    got = convert_state_dict(ultra, cfg)
    want = from_jax_params(params, cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bridges_assert_full_coverage():
    cfg = get_model_config("n")
    params = jax_yolo.init_params(0, jax_config("n"))
    del params["net"]["p1"][0]["gamma"]
    with pytest.raises(ValueError, match="not filled"):
        from_jax_params(params, cfg)
    g = load_golden("model_n.npz")
    state = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    state["net.p1.0.conv.weight"] = state["net.p1.0.conv.weight"][:, :2]
    with pytest.raises(ValueError, match="shape"):
        convert_state_dict(state, cfg, source_format="reference")
