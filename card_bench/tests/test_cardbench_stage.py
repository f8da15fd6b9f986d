"""The asynchronous staging share (`stage_async_pct`): its reader reads None
without the program's counters and in a traced request on the CPU, where
nothing is staged on a card, and 100 where every host input staged went
through the pinned ring or was copied as it was, already pinned."""
import types

import torch

from card_bench.drivers.serve import Driver
from card_bench.run import load_reader
from card_bench.tests.small import manifest, small_cell
from tpu_yolo_torch.utils import telemetry


def _ctx():
    return types.SimpleNamespace(trace=None, window={}, layer={"batches_traced": 1}, cell=None)


def test_cpu_request_leaves_the_staging_share_out():
    """A traced request of a small cell on the CPU counts NMS but stages
    nothing on a card: the reader reads None (the line leaves the metric
    out), not 0."""
    assert any(p["name"] == "stage_async_pct" for p in manifest()["per_layer"])
    driver = Driver(small_cell("n_serve_bs128", trace=True))
    driver.setup()
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        driver._issue()
        driver._complete()
    driver.release()
    snap = telemetry.snapshot()
    assert snap["nms.images"] > 0
    assert not any(k.startswith("stage.") for k in snap)
    assert load_reader("stage_async_pct")(_ctx()) is None


def test_staging_share_reads_the_programs_counters():
    """None with no counter, as a program without them gives; 100 where
    the ring's and the direct copies make up every host input staged,
    and their share otherwise."""
    read = load_reader("stage_async_pct")
    telemetry.reset()
    assert read(_ctx()) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        telemetry.add("stage.host", 6)
        telemetry.add("stage.ring", 4)
        telemetry.add("stage.direct", 2)
    assert read(_ctx()) == 100.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        telemetry.add("stage.host", 2)
    assert read(_ctx()) == 75.0
    telemetry.reset()
