"""The conv epilogue's share (`conv_epilogue_fused_pct`): its reader reads
None without the program's counters and in a traced request on the CPU,
where no folded conv runs on a card, and with the CPU's tensors routed as
the card's every folded conv of a traced request counts as fused."""
import types

import torch

from card_bench.drivers.serve import Driver
from card_bench.run import load_reader
from card_bench.tests.small import manifest, small_cell
from tpu_yolo_torch.ops import nn
from tpu_yolo_torch.utils import telemetry


def _ctx():
    return types.SimpleNamespace(trace=None, window={}, layer={"batches_traced": 1}, cell=None)


def _traced_request():
    driver = Driver(small_cell("n_serve_bs128", trace=True))
    driver.setup()
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        driver._issue()
        driver._complete()
    driver.release()
    return telemetry.snapshot()


def test_cpu_request_leaves_the_epilogue_share_out():
    """On the CPU no folded conv runs on a card: a traced request counts
    NMS but no folded conv, and the reader reads None (the line leaves the
    metric out), not 0."""
    assert any(p["name"] == "conv_epilogue_fused_pct" for p in manifest()["per_layer"])
    snap = _traced_request()
    assert snap["nms.images"] > 0
    assert "conv.folded" not in snap and "conv.fused" not in snap
    assert load_reader("conv_epilogue_fused_pct")(_ctx()) is None


def test_conv_epilogue_share_reads_the_programs_counters(monkeypatch):
    """The reader reads None with no counter, as a program without them
    gives; with the CPU's tensors routed as the card's (the seam of
    tpu_yolo_torch/ops/nn.py), a traced request of a small cell counts
    every folded conv as fused: 100."""
    read = load_reader("conv_epilogue_fused_pct")
    telemetry.reset()
    assert read(_ctx()) is None
    monkeypatch.setattr(nn, "epilogue_on_card", lambda x: True)
    snap = _traced_request()
    assert read(_ctx()) == 100.0
    assert snap["conv.folded"] == snap["conv.fused"] == 87
