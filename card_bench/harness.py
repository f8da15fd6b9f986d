"""What every driver shares: the cell as the run reads it from its files,
the benchmark's own host ranges, and the traced window's profiler.

Files, found by name (`BENCHMARK.json` names them):
  configs/<file>            the configuration's sizes (BENCHMARK.json's `file`)
  traffic/<traffic>.json    the traffic mix: which driver runs it and its
                            parameters (batch, loop, weights, checks)
  limits/<workload>.json    each compared number's limit, with the
                            readings it was set from
  metrics/<metric>.py       one per-layer metric's reader
  drivers/<driver>.py       the general drivers the traffic files name
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    """One run's cell: its entry in BENCHMARK.json, its configuration,
    traffic and limits, and the run's arguments."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: str = ROOT

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def spec(self):
        from card_bench.reference.model import Spec

        return Spec(self.config)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(manifest: dict, name: str, seed: int, seconds: float, trace: bool,
              root: str = ROOT, device: str = "cuda") -> Cell:
    """The cell `name` of a BENCHMARK.json manifest, with its files."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    workload = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[workload["config"]]
    bench = os.path.join(root, "card_bench")
    return Cell(workload=workload,
                config=read_json(os.path.join(root, config["file"])),
                traffic=read_json(os.path.join(bench, "traffic", workload["traffic"] + ".json")),
                limits=read_json(os.path.join(bench, "limits", name + ".json"))["limits"],
                seed=seed, seconds=seconds, trace=trace, device=device, root=root)


class Spans:
    """`record_function` ranges of the benchmark's own, named
    "bench.<what>" around its calls and "layer.<what>" from its hooks; off
    (no cost) outside a traced run."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


def profiler(on: bool, skip: int, active: int):
    """A CUDA profiler that records `active` steps after `skip` (and one
    of warm-up), or a stand-in that does nothing. Drivers call `.step()`
    after each request."""
    if not on:
        return _NoProfiler()
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, schedule=schedule(wait=skip, warmup=1, active=active, repeat=1))


class _NoProfiler:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass


class Laps:
    """Seconds between named points of a set-up, for the run's log."""

    def __init__(self):
        import time

        self._clock = time.perf_counter
        self._last = self._clock()
        self.parts: dict = {}

    def __call__(self, name: str):
        now = self._clock()
        self.parts[name] = now - self._last
        self._last = now


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
