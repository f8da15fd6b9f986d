"""The port's weight export (io/weights.py) against the JAX package's, on
the CPU: the counterparts of tests/test_export_weights.py's five cases,
each export bit-equal to tpu_yolo's of the same weights in both layouts,
and `load_partial`'s result and report against tpu_yolo's."""
import numpy as np
import pytest
import torch

import jax

from tpu_yolo.core.config import ModelConfig as JaxModelConfig
from tpu_yolo.core.config import get_model_config as jax_config
from tpu_yolo.io import weights as jax_weights
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo_torch.core.config import ModelConfig, get_model_config
from tpu_yolo_torch.io.weights import (convert_state_dict,
                                       export_reference_state_dict,
                                       export_ultralytics_state_dict,
                                       from_jax_params, load_partial,
                                       load_torch_state_dict,
                                       save_torch_checkpoint)
from tpu_yolo_torch.models.yolov11 import YOLO

torch.set_num_threads(1)


def _state(size="n", seed=0):
    """An unfolded port state dict and the JAX tree it came from, with
    BN statistics that are not the init's ones and zeros."""
    params = jax_yolo.init_params(jax.random.PRNGKey(seed), jax_config(size))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.01, np.shape(a)).astype(np.float32),
        params)
    return from_jax_params(params, get_model_config(size)), params


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("fmt,export", [
    ("reference", export_reference_state_dict),
    ("ultralytics", export_ultralytics_state_dict),
])
def test_roundtrip_bit_exact(fmt, export):
    cfg = get_model_config("n")
    state, _ = _state()
    back = convert_state_dict(export(state, cfg), cfg, source_format=fmt)
    _assert_same_state({k: v.numpy() for k, v in state.items()},
                       {k: v.numpy() for k, v in back.items()})


@pytest.mark.parametrize("fmt", ["reference", "ultralytics"])
def test_export_equals_jax_export(fmt):
    """Each export of the port equals tpu_yolo's export of the same
    weights bit for bit: keys, dtypes, shapes and values, from a state
    dict and from a model."""
    cfg = get_model_config("n")
    state, params = _state(seed=1)
    mine = {"reference": export_reference_state_dict,
            "ultralytics": export_ultralytics_state_dict}[fmt]
    want = {"reference": jax_weights.export_reference_state_dict,
            "ultralytics": jax_weights.export_ultralytics_state_dict}[fmt](
                params, jax_config("n"))
    _assert_same_state(mine(state, cfg), want)
    _assert_same_state(mine(YOLO.from_state_dict(cfg, state), cfg), want)


def test_reference_keys_match_golden_model():
    """The reference layout's keys and shapes equal the reference
    network's own state dict (the golden)."""
    from conftest import load_golden
    g = load_golden("model_n.npz")
    golden = {k[3:] for k in g.files if k.startswith("sd.")}
    state = export_reference_state_dict(_state()[0], get_model_config("n"))
    assert set(state) == golden, (
        f"missing={sorted(golden - set(state))[:5]} "
        f"extra={sorted(set(state) - golden)[:5]}")
    for k in golden:
        assert tuple(state[k].shape) == tuple(g["sd." + k].shape), k


def test_ultralytics_keys_match_independent_builder():
    from test_ultralytics_convert import make_ultra_state

    state, params = _state()
    synth, _ = make_ultra_state(params, np.random.default_rng(0))
    got = export_ultralytics_state_dict(state, get_model_config("n"))
    assert set(got) == set(synth), (
        f"missing={sorted(set(synth) - set(got))[:5]} "
        f"extra={sorted(set(got) - set(synth))[:5]}")


def test_folded_params_refuse_export():
    cfg = get_model_config("n")
    folded = YOLO.from_state_dict(cfg, _state()[0]).fold_batchnorm()
    for export in (export_ultralytics_state_dict, export_reference_state_dict):
        with pytest.raises(ValueError, match="unfolded"):
            export(folded.state_dict(), cfg)


def test_save_torch_checkpoint_file_roundtrip(tmp_path):
    """torch.save artifact -> load_torch_state_dict -> importer, and the
    file equals the one tpu_yolo writes for the same weights."""
    cfg = get_model_config("n")
    state, params = _state(seed=2)
    for fmt in ("ultralytics", "reference"):
        p, q = str(tmp_path / f"port_{fmt}.pt"), str(tmp_path / f"jax_{fmt}.pt")
        save_torch_checkpoint(p, state, cfg, target_format=fmt)
        jax_weights.save_torch_checkpoint(q, params, jax_config("n"),
                                          target_format=fmt)
        mine, want = torch.load(p), torch.load(q)
        assert mine["format"] == want["format"] == fmt
        _assert_same_state({k: v.numpy() for k, v in mine["state_dict"].items()},
                           {k: v.numpy() for k, v in want["state_dict"].items()})
        back = convert_state_dict(load_torch_state_dict(p), cfg,
                                  source_format=fmt)
        for k in state:
            torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)


def test_load_partial_matches_jax():
    """A reference-layout nc=8 state dict into an nc=3 model, plus a
    foreign key: the loaded weights and the report equal tpu_yolo's
    (report keys in the port's dotted naming, shapes OIHW)."""
    tiny = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True))
    src = jax_yolo.init_params(jax.random.PRNGKey(0), JaxModelConfig(**tiny, num_classes=8))
    template = jax_yolo.init_params(jax.random.PRNGKey(1),
                                    JaxModelConfig(**tiny, num_classes=3))
    state = export_reference_state_dict(
        from_jax_params(src, ModelConfig(**tiny, num_classes=8)),
        ModelConfig(**tiny, num_classes=8))
    state["net.p1.0.extra.scale"] = np.zeros(3, np.float32)
    cfg3 = ModelConfig(**tiny, num_classes=3)
    got, report = load_partial(state, YOLO.from_state_dict(
        cfg3, from_jax_params(template, cfg3)), source_format="reference")
    want, want_report = jax_weights.load_partial(state, template,
                                                 source_format="reference")

    def key(path):
        return path.replace("/", ".")

    def oihw(shape):
        return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape

    assert report["loaded"] == [key(p) for p in want_report["loaded"]]
    assert report["missing"] == [key(p) for p in want_report["missing"]]
    assert report["unmapped"] == want_report["unmapped"] == ["net.p1.0.extra.scale"]
    assert report["skipped_shape"] == [(k, oihw(a), oihw(b))
                                       for k, a, b in want_report["skipped_shape"]]
    assert len(report["loaded"]) > 100 and report["skipped_shape"]
    _assert_same_state({k: v.numpy() for k, v in got.items()},
                       {k: v.numpy() for k, v in from_jax_params(
                           jax.tree_util.tree_map(np.asarray, want), cfg3).items()})
