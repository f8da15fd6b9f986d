"""The cell `x12_serve_bs128`: its driver (drivers/serve_yolo12.py) runs
through `run.execute` on the CPU at n's widths and a small input, fails
at once on a program without YOLO12, its reference's layout is the
program's state dict, and the three per-layer readers it adds read the
program's span, counters and the 32-wide form's launches."""
import types

import pytest
import torch

from card_bench.costs import attention_cost
from card_bench.drivers import serve_yolo12
from card_bench.reference.yolo12 import Spec12, layout, model_flops
from card_bench.run import execute, load_reader
from card_bench.tests.small import manifest, small_cell
from card_bench.trace import Trace
from tpu_yolo_torch import get_model_config
from tpu_yolo_torch.models.yolov11 import model_class
from tpu_yolo_torch.utils import telemetry

CELL = "x12_serve_bs128"
# 12n's widths and depth: the cell's driver and files at a size the CPU runs
N_WIDTHS = dict(width=[3, 16, 32, 64, 128, 256], depth=[1, 1, 2, 2, 1, 1], c3k=[False, True],
                mlp_ratio=2.0, layer_scale=False, program_size="12n")


def _cell(trace: bool):
    cell = small_cell(CELL, trace=trace, size=128)
    cell.config = {**cell.config, **N_WIDTHS}
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_through_execute(trace):
    cell = _cell(trace)
    out = execute(cell, manifest(), device_check=False)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["compared"]) == set(cell.limits)
    assert out["numbers"]["reference_due"] > 0
    if not trace:
        assert {"serve_img_per_s", "serve_batch_p95_ms", "setup_s"} <= set(out["metrics"])


def test_a_program_without_yolo12_fails_before_the_weights(monkeypatch):
    import tpu_yolo_torch

    def unknown(size, num_classes=80):
        raise KeyError(size)

    monkeypatch.setattr(tpu_yolo_torch, "get_model_config", unknown)
    driver = serve_yolo12.Driver(_cell(False))
    monkeypatch.setattr(serve_yolo12, "make", lambda *a, **k: pytest.fail("weights made"))
    with pytest.raises(KeyError):
        driver.setup()


def test_reference_layout_is_the_programs_state_dict():
    cell = small_cell(CELL)
    spec = Spec12({**cell.config, "input_size": 640})
    cfg = get_model_config(cell.config["program_size"])
    program = model_class(cfg)(cfg)
    assert {k: tuple(v.shape) for k, v in program.state_dict().items()} == {
        n: tuple(s) for n, s, _ in layout(spec)}
    calls = model_flops(spec, 128)["attention_calls"]
    assert sorted(set(calls)) == [(1536, 400, 32, 32), (6144, 400, 32, 32)]
    assert len(calls) == 16


def _traced_request():
    """One traced request of the small cell on the CPU: its profile, and
    the telemetry's counters."""
    driver = serve_yolo12.Driver(_cell(True))
    driver.setup()
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        driver._issue()
        driver._complete()
    driver.release()
    return prof, telemetry.snapshot()


def test_readers_read_the_span_counters_and_launches():
    """On the CPU: 8 area attention forwards a 12n batch, each in a span
    `layer.serve.area_attn`, counted, none in the kernel (0%; None without
    the counters). The device readers on a trace that holds the span's
    launches and the 32-wide form's: the span's ms a batch, and the calls'
    mean bound over the form's mean launch time."""
    prof, snap = _traced_request()
    spans = [h for h in Trace(prof).host if h[3] == "layer.serve.area_attn"]
    assert len(spans) == snap["attn.area.calls"] == 8
    ctx = types.SimpleNamespace(trace=None, window={}, layer={"batches_traced": 1}, cell=None)
    assert load_reader("area_attn_kernel_pct")(ctx) == 0.0
    telemetry.reset()
    assert load_reader("area_attn_kernel_pct")(ctx) is None
    assert load_reader("area_attn_device_ms")(ctx) is None

    op = types.SimpleNamespace(name="void (anonymous namespace)::attention_v32_bf16_kernel(...)",
                               seconds=4e-4)
    trace = types.SimpleNamespace(
        seconds_in_range=lambda tag: 0.09 if tag == "layer.serve.area_attn" else None,
        ops_named=lambda pattern: [op] * 4 if "v32" in pattern else [])
    calls = [(6144, 400, 32, 32)] * 2 + [(1536, 400, 32, 32)] * 2
    ctx = types.SimpleNamespace(trace=trace, window={}, cell=None,
                                layer={"batches_traced": 3, "area_attention_calls": calls})
    assert load_reader("area_attn_device_ms")(ctx) == pytest.approx(30.0)
    bound = sum(attention_cost(*c)[0] for c in calls) / 4
    assert load_reader("area_attn_roofline_pct")(ctx) == pytest.approx(100 * bound / 0.4)
