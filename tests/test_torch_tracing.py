"""The serving path's spans and counters (utils/telemetry.py) on the CPU:
off without a recording profiler (no range, no counter, no device op,
no allocation), the seven spans of one request nested and numbered alike
under one, counters equal to what the result and `batched_nms` give,
the same exported graph with a profiler running, and the set-up
records."""
import collections
import io
import zipfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_yolo_torch.core.config import get_model_config
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.ops.nms import batched_nms
from tpu_yolo_torch.seeded import seeded_images, serving_state
from tpu_yolo_torch.serve import Detector
from tpu_yolo_torch.utils import telemetry

torch.set_num_threads(1)
SIZE = 128
CPU = [ProfilerActivity.CPU]
NMS_PARTS = ("layer.serve.nms.rank", "layer.serve.nms.decode", "layer.serve.nms.keep",
             "layer.serve.nms.compact")
# the ops that tracing adds to a batch: its seven ranges, and no counter's
# kernel (the device counts are summed when read)
RANGE_OPS = collections.Counter({"profiler._record_function_enter_new": 7,
                                 "profiler._record_function_exit": 7})


@pytest.fixture(scope="module")
def state():
    cfg = get_model_config("n")
    imgs = seeded_images(np.random.default_rng(0), 2, SIZE)
    return cfg, serving_state(cfg, 0, imgs, "cpu")


def _detector(state, **kw):
    cfg, sd = state
    return Detector(YOLO.from_state_dict(cfg, sd), input_size=SIZE, device="cpu",
                    compute_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def detector(state):
    return _detector(state, max_nms=64)


@pytest.fixture(scope="module")
def images():
    return seeded_images(np.random.default_rng(1), 2, SIZE)


class _Ops(TorchDispatchMode):
    """The name of every op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def ranges(monkeypatch):
    """(name, args) of every range telemetry opens."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return opened


def test_off_without_a_profiler(detector, images, ranges):
    detector.detect_batch(images)
    telemetry.reset()
    before = telemetry.snapshot()
    with _Ops() as off:
        detector.detect_batch(images)
    assert ranges == []
    assert telemetry.snapshot() == before
    assert telemetry._vectors == {}
    assert not any(op.startswith("profiler.") for op in off.ops)

    # on: the same ops and the ranges' own, and nothing else until read
    with profile(activities=CPU):
        with _Ops() as on:
            detector.detect_batch(images)
    assert collections.Counter(on.ops) - collections.Counter(off.ops) == RANGE_OPS
    assert collections.Counter(off.ops) - collections.Counter(on.ops) == collections.Counter()
    assert telemetry._vectors == {} and len(telemetry._pending) == 1
    assert telemetry.snapshot()["nms.images"] == 2
    assert telemetry._pending == [] and len(telemetry._vectors) == 1


def test_scheduled_profiler_wait_and_warmup_steps_leave_it_off(detector, images, ranges):
    telemetry.reset()
    seen = []
    with profile(activities=CPU, schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            n = len(ranges)
            detector.detect_batch(images)
            seen.append((len(ranges) - n, telemetry.snapshot().get("nms.images", 0)))
            prof.step()
    assert seen == [(0, 0), (0, 0), (7, 2)]


def test_spans_of_one_request_nest_and_share_its_number(detector, images, ranges):
    with profile(activities=CPU) as prof:
        detector.detect_batch(images)
        detector.detect_batch(images)
    assert [n for n, _ in ranges] == list(telemetry.SERVE_SPANS) * 2
    first, second = {a for _, a in ranges[:7]}, {a for _, a in ranges[7:]}
    assert len(first) == len(second) == 1 and first != second
    assert int(second.pop()) == int(first.pop()) + 1

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name in telemetry.SERVE_SPANS)
    assert len(spans) == 14
    for s, e, name in spans:   # no partial overlap among the program's spans
        for s2, e2, name2 in spans:
            assert e <= s2 or e2 <= s or (s <= s2 and e2 <= e) or (s2 <= s and e <= e2), \
                (name, name2)
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None
              for e in prof.events() if e.name in telemetry.SERVE_SPANS}
    assert all(parent[n] == "layer.serve.nms" for n in NMS_PARTS)
    assert {parent[n] for n in telemetry.SERVE_SPANS[:3]} == {None}
    order = [n for _, _, n in spans[:7]]
    assert order == list(telemetry.SERVE_SPANS)


@pytest.mark.parametrize("max_nms,max_det", [(1024, 300), (16, 3)])
def test_counters_equal_the_result_and_batched_nms(state, images, max_nms, max_det):
    det = _detector(state, max_nms=max_nms, max_det=max_det)
    telemetry.reset()
    with profile(activities=CPU):
        res = det.detect_batch(images)
    got = telemetry.snapshot()
    with torch.inference_mode():
        x = torch.from_numpy(images).float() / 255
        env = batched_nms(det.model(x), conf_thres=0.25, iou_thres=0.65, max_det=max_det,
                          max_nms=max_nms, envelope=True)
    k = int(env["candidate_budget"])
    above = env["n_above_conf"]
    assert got["nms.images"] == 2 and got["nms.slots"] == 2 * k
    assert got["nms.live"] == int(above.clamp(max=k).sum())
    assert got["nms.budget_full"] == int((above >= k).sum())
    assert got["nms.kept"] == int(res["count"].sum())
    assert got["nms.capped"] == int((res["count"] == max_det).sum())
    assert 0 < got["nms.live"] < got["nms.slots"] or got["nms.budget_full"] == 2
    if max_det == 3:
        assert got["nms.capped"] == 2 and got["nms.budget_full"] >= 1


def test_save_compiled_graph_is_the_same_under_a_profiler(detector, tmp_path):
    def graph(path):
        with zipfile.ZipFile(path) as z:
            ep = torch.export.load(io.BytesIO(z.read("program.pt2")))
        return str(ep.graph)

    plain = graph(detector.save_compiled(str(tmp_path / "plain.zip"), 2))
    with profile(activities=CPU):
        traced = graph(detector.save_compiled(str(tmp_path / "traced.zip"), 2))
    assert traced == plain
    assert "record_function" not in plain


def test_first_batch_is_recorded_once(state, images):
    det = _detector(state)
    assert det._first_batch_s is None
    assert telemetry.snapshot()["setup.place_s"] > 0
    det.detect_batch(images)
    first = det._first_batch_s
    assert first > 0 and telemetry.snapshot()["setup.first_batch_s"] == first
    telemetry.reset()
    det.detect_batch(images)
    assert det._first_batch_s == first
    assert telemetry.snapshot()["setup.first_batch_s"] == first


def test_counter_vector_and_host_counters():
    telemetry.reset()
    telemetry.add("t.host", 3)
    assert "t.host" not in telemetry.snapshot()
    with profile(activities=CPU):
        telemetry.add("t.host", 3)
        with torch.inference_mode():
            telemetry.add(("t.a", "t.b"), torch.tensor([2, 5]))
        telemetry.add("t.a", torch.tensor(1))
        telemetry.add("t.a", lambda: torch.tensor(10))
        with pytest.raises(ValueError):
            telemetry.add(("t.b", "t.c", "t.a"), torch.tensor([1, 1, 1]))
        assert len(telemetry._pending) == 3
        for _ in range(telemetry.PENDING_MAX - 3):
            telemetry.add("t.b", torch.tensor(1))
        assert telemetry._pending == []   # held counts are summed at the bound
    snap = telemetry.snapshot()
    assert (snap["t.host"], snap["t.a"], snap["t.b"]) == (3, 13, 5 + telemetry.PENDING_MAX - 3)
    assert snap["launches.nms_greedy_keep"] >= 0
    telemetry.reset()
    assert "t.host" not in telemetry.snapshot() and "t.a" not in telemetry.snapshot()
