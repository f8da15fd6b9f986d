"""The port's profile and export (tpu_yolo_torch/utils/profiler.py,
utils/export.py, `--profile` and `--export`) against tpu_yolo's on the
CPU: parameter counts equal, FLOPs equal to the analytic count of JAX's
own shape record, the timeline trace naming the kernels' ops, and the
exported program from one symbolic-batch export against the port's
forward (bit for bit) and JAX's (within tests/test_aux.py's 2e-4)."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxModelConfig
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.ops.nn import Context
from tpu_yolo.quant import calibrate as jax_calibrate
from tpu_yolo.quant import quantize_params as jax_quantize_params
from tpu_yolo.utils.profiler import count_params as jax_count_params
from tpu_yolo_torch.cli import main as cli
from tpu_yolo_torch.core.config import ModelConfig, get_model_config
from tpu_yolo_torch.io.checkpoint import save_checkpoint
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.attention_cuda import psa_attention
from tpu_yolo_torch.seeded import seeded_images, serving_state
from tpu_yolo_torch.serve import Detector
from tpu_yolo_torch.utils.export import export_program, load_program
from tpu_yolo_torch.utils.profiler import (count_params, print_profile,
                                           profile_model, trace)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                   csp=(False, True), num_classes=8)
JAX_TINY = JaxModelConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                          num_classes=8)


def _jax_tree(form):
    """JAX's TINY params as numpy: unfolded, folded, or int8-quantized."""
    params = jax.tree_util.tree_map(np.asarray, jax_yolo.init_params(0, JAX_TINY))
    if form == "unfolded":
        return params
    params = jax.tree_util.tree_map(np.asarray, jax_yolo.fold_batchnorm(params))
    if form == "folded":
        return params
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8)
    absmax = jax_calibrate(params, JAX_TINY, images, compute_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax_quantize_params(params, absmax))


@pytest.mark.parametrize("form", ["unfolded", "folded", "quantized"])
def test_count_params_matches_jax(form):
    """Every leaf counted, BatchNorm statistics and the 0-d s_in included,
    for the state dict and for the model."""
    tree = _jax_tree(form)
    state = from_jax_params(tree, TINY)
    assert count_params(state) == jax_count_params(tree)
    assert count_params(YOLO.from_state_dict(TINY, state)) == jax_count_params(tree)


def _analytic_flops(params, size, batch, s2d=False):
    """FLOPs per image of JAX's eval forward from its own shape record
    (Context(convs=[])): 2·MACs of every conv, the attention products'
    noted FLOPs."""
    ctx = Context(convs=[])
    jax_yolo.forward_raw(params, jnp.zeros((batch, size, size, 3), jnp.float32),
                         JAX_TINY, ctx)
    total = 0
    for rec in ctx.convs:
        if rec["kind"] == "conv":
            kh, kw, cin_g, cout = rec["w"]
            b, ho, wo, _ = rec["out"]
            total += 2 * b * ho * wo * cout * kh * kw * cin_g
        else:
            total += rec["flops"]
    return total / batch


@pytest.mark.parametrize("size,batch,s2d", [(64, 2, False), (96, 1, False), (64, 1, True)])
def test_profile_flops_equal_jax_shape_record(size, batch, s2d):
    """profile_model's FLOPs equal the analytic count exactly (the
    attention's two products through the op's registered formula); the
    parameter count equals count_params; bytes are positive."""
    params = _jax_tree("folded")
    if s2d:
        params = jax.tree_util.tree_map(np.asarray,
                                        jax_yolo.fold_stem_space_to_depth(params))
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    r = profile_model(model, TINY, size, batch=batch, compute_dtype=torch.float32)
    assert r["flops"] == _analytic_flops(params, size, batch)
    assert r["gflops"] == r["flops"] / 1e9
    assert r["params"] == count_params(model) == jax_count_params(params)
    assert r["bytes_accessed"] > 0


def test_attention_op_flop_formula():
    """Without the formula FlopCounterMode counts nothing for the op."""
    q, k = torch.randn(6, 50, 32), torch.randn(6, 50, 32)
    v = torch.randn(6, 50, 64)
    with FlopCounterMode(display=False) as counter:
        psa_attention(q, k, v, 32 ** -0.5)
    assert counter.get_total_flops() == 2 * 6 * 50 * 50 * (32 + 64)


def test_print_profile_banner(capsys):
    model = YOLO.from_state_dict(TINY, from_jax_params(_jax_tree("folded"), TINY))
    r = print_profile(model, TINY, 64, compute_dtype=torch.float32)
    out = capsys.readouterr().out.splitlines()
    assert out == [f"Number of parameters: {r['params']}",
                   f"GFLOPs (torch.utils.flop_counter, 64px): {r['gflops']:.2f}"]


def test_trace_names_the_kernels_ops(tmp_path):
    """A Chrome trace around a served batch: the attention and greedy-keep
    ops appear in it by name."""
    imgs = seeded_images(np.random.default_rng(0), 2, 64)
    det = Detector(YOLO.from_state_dict(TINY, serving_state(TINY, 0, imgs, "cpu")),
                   input_size=64, device="cpu", compute_dtype=torch.float32)
    with trace(str(tmp_path / "tb")):
        det.detect_batch(imgs)
    events = json.loads((tmp_path / "tb" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"tpu_yolo_torch::psa_attention", "tpu_yolo_torch::nms_greedy_keep"} <= names


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One symbolic-batch export of the folded TINY model at f32."""
    params = _jax_tree("folded")
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    out = str(tmp_path_factory.mktemp("export"))
    manifest = export_program(model, TINY, 64, out, compute_dtype=torch.float32)
    return params, model, out, manifest


def test_export_manifest(exported):
    params, model, out, manifest = exported
    assert sorted(os.listdir(out)) == ["manifest.json", "program.pt2"]
    assert json.loads(open(os.path.join(out, "manifest.json")).read()) == manifest
    assert manifest["format"] == "torch.export" and manifest["input"] == "uint8[b,64,64,3]"
    assert manifest["num_classes"] == 8 and manifest["input_size"] == 64
    assert manifest["bytes"] == os.path.getsize(os.path.join(out, "program.pt2"))
    assert list(manifest["weights"]) == list(model.state_dict())


@pytest.mark.parametrize("batch", [2, 3])
def test_export_round_trip_symbolic_batch(exported, batch):
    """One export serves batches 2 and 3: bit for bit the port's forward,
    and JAX's within tests/test_aux.py's rtol = atol = 2e-4."""
    params, model, out, _ = exported
    x = np.random.default_rng(batch).integers(0, 256, (batch, 64, 64, 3), np.uint8)
    got = load_program(out)(model.state_dict(), x)
    with torch.inference_mode():
        mine = model(torch.from_numpy(x).float() / 255)
    torch.testing.assert_close(got, mine, rtol=0, atol=0)
    want = jax_yolo.forward(params, jnp.asarray(x).astype(jnp.float32) / 255, JAX_TINY,
                            train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_export_takes_the_model_and_calls_the_attention_op(exported):
    _, model, out, _ = exported
    program = torch.export.load(os.path.join(out, "program.pt2"))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "tpu_yolo_torch.psa_attention.default" in targets
    x = np.zeros((1, 64, 64, 3), np.uint8)
    torch.testing.assert_close(load_program(out)(model, x),
                               load_program(out)(model.state_dict(), x), rtol=0, atol=0)


def test_export_pinned_batch_refuses_another(tmp_path):
    model = YOLO.from_state_dict(TINY, from_jax_params(_jax_tree("folded"), TINY))
    manifest = export_program(model, TINY, 64, str(tmp_path), batch=2,
                              compute_dtype=torch.float32)
    assert manifest["input"] == "uint8[2,64,64,3]"
    run = load_program(str(tmp_path))
    assert run(model, np.zeros((2, 64, 64, 3), np.uint8)).shape == (2, 84, 12)
    with pytest.raises(Exception):
        run(model, np.zeros((3, 64, 64, 3), np.uint8))


def test_cli_flags_profile_and_export():
    assert cli.parse_args(["--profile"]).profile
    assert cli.parse_args(["--export"]).export == "torch"
    for fmt in ("torch", "onnx", "both"):
        assert cli.parse_args(["--export", fmt]).export == fmt
    with pytest.raises(SystemExit):
        cli.parse_args(["--export", "stablehlo"])


def test_cli_refuses_onnx_export_clearly(tmp_path):
    """--export onnx writes save-dir/export_n/model.onnx, which parses and
    runs in the port's interpreter against the port's f32 forward, and
    --export both writes it beside the torch.export program; a format
    that is not there is refused with the choices named."""
    from tpu_yolo_torch.utils.onnx.interp import run_graph
    from tpu_yolo_torch.utils.onnx.parse import parse_model

    cfg = get_model_config("n")
    save_checkpoint(str(tmp_path / "best.ckpt"), {"params": init_params(1, cfg)})
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    cmd = [sys.executable, "-m", "tpu_yolo_torch.cli.main", "--device", "cpu",
           "--input-size", "64", "--save-dir", str(tmp_path), "--export"]
    proc = subprocess.run(cmd + ["onnx"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = tmp_path / "export_n"
    assert sorted(os.listdir(out)) == ["model.onnx"]
    assert proc.stdout.startswith(f"exported: {{'path': '{out / 'model.onnx'}'")
    g, header = parse_model((out / "model.onnx").read_bytes())
    assert header["opset"] == 17
    x = np.random.default_rng(0).random((2, 3, 64, 64), np.float32)
    served = YOLO.from_state_dict(cfg, from_jax_params(init_params(1, cfg), cfg))
    with torch.no_grad():
        want = served.fold_batchnorm()(torch.from_numpy(x).permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(run_graph(g, {"images": x})["output"], want,
                               rtol=2e-4, atol=2e-4)

    (out / "model.onnx").unlink()
    proc = subprocess.run(cmd + ["both"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(out)) == ["manifest.json", "model.onnx", "program.pt2"]
    assert len(proc.stdout.strip().splitlines()) == 2
    parse_model((out / "model.onnx").read_bytes())

    proc = subprocess.run(cmd + ["tflite"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 2 and "invalid choice: 'tflite'" in proc.stderr


def test_cli_profile_and_export_on_the_cpu(tmp_path):
    """--profile prints the banner of v11-n and returns; bare --export
    writes the program under save-dir/export_n, which loads and runs."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-m", "tpu_yolo_torch.cli.main", "--profile",
                           "--device", "cpu", "--input-size", "64"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    cfg = get_model_config("n")
    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg))
    r = profile_model(model.fold_batchnorm(), cfg, 64)
    assert lines == [f"Number of parameters: {r['params']}",
                     f"GFLOPs (torch.utils.flop_counter, 64px): {r['gflops']:.2f}"]

    save_checkpoint(str(tmp_path / "best.ckpt"), {"params": init_params(1, cfg)})
    proc = subprocess.run([sys.executable, "-m", "tpu_yolo_torch.cli.main", "--export",
                           "--device", "cpu", "--input-size", "64", "--save-dir",
                           str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = tmp_path / "export_n"
    assert proc.stdout.startswith(f"exported: {out} ")
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["compute_dtype"] == "bfloat16" and manifest["platform"] == "cpu"
    served = YOLO.from_state_dict(cfg, from_jax_params(init_params(1, cfg), cfg))
    x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8)
    got = load_program(str(out))(served.fold_batchnorm(), x)
    with torch.inference_mode():
        want = served(torch.from_numpy(x).bfloat16() / 255)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
