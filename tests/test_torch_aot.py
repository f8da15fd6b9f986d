"""The port's saved serving program (serve.py: Detector.save_compiled /
load_compiled over torch.export), on the CPU: the counterparts of every
case of tests/test_aot.py, run here through the custom ops' plain
implementations (the port's export runs on the CPU, so none is
skipped), the loaded program against the JAX package's Detector, the
custom ops in the exported graph and under `torch.library.opcheck`."""
import io
import json
import os
import pickle
import zipfile

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxModelConfig
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.serve import Detector as JaxDetector
from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.attention_cuda import psa_attention
from tpu_yolo_torch.ops.bias_act_cuda import bias_act_op
from tpu_yolo_torch.ops.nms_cuda import nms_greedy_keep
from tpu_yolo_torch.ops.topk_cuda import topk_mask_op
from tpu_yolo_torch.serve import Detector

torch.set_num_threads(1)
TINY = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                   csp=(False, True), num_classes=8)
SIZE = 128
BATCH = 2


def _params(seed=0, cfg=TINY):
    """A folded state dict (f32, CPU) of seeded weights, with the class
    biases drawn around -1 so that random images give candidates whose
    scores depend on the weights."""
    params = init_params(seed, cfg)
    rng = np.random.default_rng(seed)
    for level in params["head"]["cls"]:
        level[4]["b"] = rng.normal(-1.0, 0.5, level[4]["b"].shape).astype(np.float32)
    model = YOLO.from_state_dict(cfg, from_jax_params(params, cfg))
    return model.fold_batchnorm().state_dict()


def _tiny_detector(params=None, **kw):
    model = YOLO.from_state_dict(TINY, params if params is not None else _params())
    return Detector(model, input_size=SIZE, conf_thres=1e-6, device="cpu", **kw)


def _images(seed):
    return np.random.default_rng(seed).integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                                np.uint8)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def _rewrite_meta(path, out, **changes):
    with zipfile.ZipFile(path) as z:
        files = {n: z.read(n) for n in z.namelist()}
    meta = json.loads(files["meta.json"])
    meta.update(changes)
    files["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(out, "w") as z:
        for n, data in files.items():
            z.writestr(n, data)
    return out


def _graph_targets(path):
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read("program.pt2")))
    return program, {str(n.target) for n in program.graph.nodes
                     if n.op == "call_function"}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aot") / "det.pt2z")
    det = _tiny_detector(decode_threads=3)
    det.save_compiled(path, batch_size=BATCH)
    return path, det


def test_roundtrip_bit_exact(artifact):
    path, live = artifact
    loaded = Detector.load_compiled(path, _params())
    assert loaded.compute_dtype == torch.bfloat16 and not loaded.device_letterbox
    imgs = _images(0)
    _assert_same(live.detect_batch(imgs), loaded.detect_batch(imgs))
    # from a YOLO too, and detect_one pads to the artifact's batch
    loaded = Detector.load_compiled(path, YOLO.from_state_dict(TINY, _params()))
    one = loaded.detect_one(imgs[1], rescale=False)
    n = int(live.detect_batch(imgs)["count"][1])
    assert len(one["boxes"]) == n


def test_loaded_detector_rejects_other_batch(artifact):
    path, _ = artifact
    loaded = Detector.load_compiled(path, _params())
    bad = np.zeros((BATCH + 1, SIZE, SIZE, 3), np.uint8)
    with pytest.raises(ValueError, match="batch_size"):
        loaded.detect_batch(bad)


def test_stream_adopts_compiled_batch(artifact, tmp_path):
    path, live = artifact
    loaded = Detector.load_compiled(path, _params())
    rng = np.random.default_rng(1)
    paths = []
    for i in range(3):  # 3 images -> two chunks of the compiled batch 2
        p = str(tmp_path / f"im{i}.jpg")
        cv2.imwrite(p, rng.integers(0, 255, (96, 120, 3), np.uint8))
        paths.append(p)
    results = list(loaded.stream(paths, batch_size=64))  # 64 is overridden
    assert [r["path"] for r in results] == paths
    for got, want in zip(results, live.stream(paths, batch_size=BATCH)):
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("key,value", [("device_name", "NVIDIA B999"),
                                       ("torch_version", "0.1.0"),
                                       ("cuda_version", "99.9"),
                                       ("platform", "cuda")])
def test_environment_mismatch_raises(artifact, tmp_path, key, value):
    path, _ = artifact
    bad = _rewrite_meta(path, str(tmp_path / "wrong_env.pt2z"), **{key: value})
    with pytest.raises(RuntimeError, match=key):
        Detector.load_compiled(bad, _params())


def test_wrong_format_raises(artifact, tmp_path):
    path, _ = artifact
    bad = _rewrite_meta(path, str(tmp_path / "wrong_format.pt2z"),
                        format="tpu_yolo-aot-v1")
    with pytest.raises(ValueError, match="tpu_yolo_torch-export-v1"):
        Detector.load_compiled(bad, _params())
    pickled = tmp_path / "jax_artifact.aot"     # tpu_yolo's artifact is a pickle
    pickled.write_bytes(pickle.dumps({"format": "tpu_yolo-aot-v1"}))
    with pytest.raises(ValueError, match="tpu_yolo_torch-export-v1"):
        Detector.load_compiled(str(pickled), _params())


def test_architecture_mismatch_raises(artifact):
    path, _ = artifact
    other = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                        csp=(False, True), num_classes=4)
    with pytest.raises(ValueError, match="head.cls.0.4.w"):
        Detector.load_compiled(path, _params(cfg=other))
    params = _params()
    params["extra.w"] = torch.zeros(1)
    with pytest.raises(ValueError, match="extra.w"):
        Detector.load_compiled(path, params)


def test_weights_stay_outside_the_artifact(artifact):
    """The file is smaller than the weights it runs with and holds no
    parameter; the same artifact with other weights gives other scores."""
    path, _ = artifact
    weights = _params()
    nbytes = sum(t.numel() * 2 for t in weights.values())   # as bf16
    assert os.path.getsize(path) < nbytes
    program, _ = _graph_targets(path)
    assert not program.state_dict
    assert all(t.numel() < 1000 for t in program.constants.values())
    a = Detector.load_compiled(path, _params(0))
    b = Detector.load_compiled(path, _params(1))
    imgs = _images(2)
    assert not torch.equal(a.detect_batch(imgs)["scores"],
                           b.detect_batch(imgs)["scores"])


def test_staged_letterbox_roundtrip(tmp_path):
    det = _tiny_detector(device_letterbox=True, stage_size=160)
    path = str(tmp_path / "staged.pt2z")
    det.save_compiled(path, batch_size=BATCH)
    loaded = Detector.load_compiled(path, _params())
    assert loaded.device_letterbox and loaded.stage_size == 160
    rng = np.random.default_rng(3)
    staged = torch.from_numpy(rng.integers(0, 256, (BATCH, 160, 160, 3), np.uint8))
    hw = torch.tensor([[120.0, 160.0], [160.0, 96.0]])
    _assert_same(det._predict_staged(staged, hw),
                 loaded._predict_staged(staged, hw))
    _, targets = _graph_targets(path)
    assert "tpu_yolo_torch.psa_attention.default" in targets
    assert "tpu_yolo_torch.nms_greedy_keep.default" in targets


def test_graph_calls_the_custom_ops(artifact):
    """The exported program reaches attention and the greedy keep through
    the custom ops, not through plain products or a Python loop."""
    _, targets = _graph_targets(artifact[0])
    assert "tpu_yolo_torch.psa_attention.default" in targets
    assert "tpu_yolo_torch.nms_greedy_keep.default" in targets
    assert not any("softmax" in t for t in targets)


def test_knobs_recorded_and_restored(artifact):
    path, live = artifact
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    assert meta["knobs"]["decode_threads"] == 3 and meta["batch_size"] == BATCH
    assert meta["cfg"]["width"] == list(TINY.width)
    assert meta["weights"]["net.p1.0.w"] == [[8, 3, 3, 3], "bfloat16",
                                             "channels_last"]
    loaded = Detector.load_compiled(path, _params())
    assert loaded.decode_threads == 3
    assert loaded._knobs == live._knobs and loaded.cfg == TINY
    assert loaded._nms == live._nms


def test_loaded_program_matches_jax_detector(tmp_path):
    """An f32 artifact, loaded, against tpu_yolo.serve.Detector on the
    same folded weights (carried by from_jax_params): counts and classes
    equal, boxes within 1e-3 px and scores within 1e-4, the tolerance of
    tests/test_torch_serve.py::test_detect_batch_matches_jax_detector."""
    jcfg = JaxModelConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                          num_classes=8)
    params = jax_yolo.fold_batchnorm(jax_yolo.init_params(4, jcfg))
    state = from_jax_params(params, TINY)
    path = str(tmp_path / "f32.pt2z")
    _tiny_detector(state, compute_dtype=torch.float32, ranking="exact") \
        .save_compiled(path, batch_size=BATCH)
    loaded = Detector.load_compiled(path, state)
    ref_det = JaxDetector(params, jcfg, input_size=SIZE, conf_thres=1e-6,
                          compute_dtype=jnp.float32, ranking="exact")
    imgs = _images(5)
    ref = ref_det.detect_batch(imgs)
    mine = loaded.detect_batch(imgs)
    np.testing.assert_array_equal(mine["count"].numpy(), np.asarray(ref["count"]))
    np.testing.assert_array_equal(mine["classes"].numpy(), np.asarray(ref["classes"]))
    v = np.asarray(ref["valid"])
    assert v.sum(1).min() > 0
    np.testing.assert_allclose(mine["boxes"].numpy()[v], np.asarray(ref["boxes"])[v],
                               atol=1e-3)
    np.testing.assert_allclose(mine["scores"].numpy()[v],
                               np.asarray(ref["scores"])[v], atol=1e-4)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(4, 50, 32, generator=g), torch.randn(4, 50, 32, generator=g)
    v = torch.randn(4, 50, 64, generator=g)
    xy = torch.rand(2, 64, 2, generator=g) * 100
    boxes = torch.cat([xy, xy + torch.rand(2, 64, 2, generator=g) * 30], -1)
    cls = torch.randint(0, 3, (2, 64), generator=g, dtype=torch.int32)
    valid = torch.rand(2, 64, generator=g) > 0.3
    y = torch.randn(2, 16, 5, 7, generator=g).contiguous(memory_format=torch.channels_last)
    bias = torch.randn(16, generator=g)
    # a residual as `chunk` gives it: the second half of a channels_last map
    residual = torch.randn(2, 32, 5, 7, generator=g).contiguous(
        memory_format=torch.channels_last).chunk(2, 1)[1]
    return {"psa_attention": (psa_attention, (q, k, v, 32 ** -0.5)),
            "psa_attention_bf16": (psa_attention, (q.bfloat16(), k.bfloat16(),
                                                   v.bfloat16(), 32 ** -0.5)),
            "nms_greedy_keep": (nms_greedy_keep, (boxes, cls, valid, 0.5)),
            "topk_mask": (topk_mask_op, (torch.randn(2, 3, 40, generator=g), 5)),
            "bias_act": (bias_act_op, (y, bias, "silu", None, False)),
            "bias_act_residual_bf16": (bias_act_op, (y.bfloat16(), bias.bfloat16(),
                                                     "identity", residual.bfloat16(), False)),
            "bias_act_halves": (bias_act_op, (y, bias, "silu", residual, True))}


@pytest.mark.parametrize("name", list(_op_cases()))
def test_custom_op_opcheck(name):
    op, args = _op_cases()[name]
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result
