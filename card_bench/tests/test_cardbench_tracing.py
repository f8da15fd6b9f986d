"""The program's spans and counters in a traced run: on the CPU a traced
small cell prints the counter and set-up metrics and leaves out the
device-time ones (their readers read None, not 0, without device ops),
and the benchmark's hook ranges and the program's spans nest as the
metrics' readers assume."""
import types

import torch

from card_bench.drivers.serve import Driver
from card_bench.run import execute, load_reader
from card_bench.tests.small import manifest, small_cell
from card_bench.trace import Trace
from tpu_yolo_torch.utils import telemetry

NEW = ("stage_wait_ms_per_batch", "forward_host_ms_per_batch", "forward_device_ms.span",
       "nms_device_ms.span", "nms_rank_device_ms", "nms_decode_device_ms",
       "nms_live_slots_pct", "setup_first_batch_s")
# a window long enough for the profiler's warm-up step and one traced batch
# on a loaded CPU
WINDOW_S = 6.0
DEVICE_TIME = ("stage_wait_ms_per_batch", "forward_device_ms.span", "nms_device_ms.span",
               "nms_rank_device_ms", "nms_decode_device_ms")


def test_traced_small_cell_prints_counters_and_no_device_zeros():
    telemetry.reset()
    m = manifest()
    assert all(any(p["name"] == n for p in m["per_layer"]) for n in NEW)
    out = execute(small_cell("n_serve_bs128", seconds=WINDOW_S, trace=True), m,
                  device_check=False)
    got = out["metrics"]
    assert 0 < got["nms_live_slots_pct"]["value"] <= 100
    assert got["setup_first_batch_s"]["value"] > 0
    assert got["forward_host_ms_per_batch"]["value"] > 0
    for name in DEVICE_TIME:
        assert name not in got, (name, got[name])


def _ctx(trace):
    return types.SimpleNamespace(trace=trace, window={}, layer={"batches_traced": 1}, cell=None)


def test_device_time_readers_read_none_without_device_ops():
    empty = types.SimpleNamespace(ops=[], host=[(0.0, 5.0, 1, "layer.serve.stage")],
                                  launched=[("aten::add", 0.0, ["aten::add"])],
                                  ops_named=lambda pattern: [],
                                  seconds_in_range=lambda tag: None)
    for name in DEVICE_TIME:
        assert load_reader(name)(_ctx(empty)) is None, name
        assert load_reader(name)(_ctx(None)) is None, name


def test_hooks_and_program_spans_nest():
    """`layer.forward` (hook) lies inside `layer.serve.forward` (program),
    `layer.serve.nms` inside `layer.nms` (hook), and no program span takes
    a hook's name."""
    cell = small_cell("n_serve_bs128", trace=True)
    driver = Driver(cell)
    driver.setup()
    driver._hooks()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        driver._issue()
        driver._complete()
    trace = Trace(prof)
    driver.release()
    spans = {}
    for start, end, _, name in trace.host:
        spans.setdefault(name, []).append((start, end))

    def inside(inner, outer):
        assert spans.get(inner) and spans.get(outer), (inner, outer, sorted(spans))
        for s, e in spans[inner]:
            assert any(os <= s and e <= oe for os, oe in spans[outer]), (inner, outer)

    inside("layer.forward", "layer.serve.forward")
    inside("layer.serve.nms", "layer.nms")
    for name in telemetry.SERVE_SPANS:
        inside(name, "bench.request")
    assert not {"layer.forward", "layer.nms"} & set(telemetry.SERVE_SPANS)
