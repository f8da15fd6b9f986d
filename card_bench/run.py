"""The benchmark of tpu_yolo_torch on a CUDA card: one run of one cell.

    python3 card_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The run reads BENCHMARK.json and the
cell's files (harness.py), builds its traffic from the seed, makes the
weights on the card, warms the cell's shapes, measures for `--seconds`,
compares what the timed path produced with the plain reference
(reference/), and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and `compared` (each number compared, beside its limit),
which are also the last lines on standard error.

It exits non-zero and prints no result without a CUDA card (or fewer
than the cell asks for), or when jax, jaxlib, flax or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_yolo")


def _since_start() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (tpu_yolo_torch is not tpu_yolo)."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def _caches():
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into tpu_yolo_torch/build/, also inside)."""
    base = os.path.join(ROOT, "card_bench", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(name: str, root: str = ROOT):
    """The `read` function of metrics/<name>.py under `root`, or None."""
    path = os.path.join(root, "card_bench", "metrics", name + ".py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("card_bench_metric__" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(cell, manifest: dict, device_check=True) -> dict:
    """One run of `cell`; returns the result line's object. Without
    `device_check` it runs on whatever device the cell names (the CPU
    in tests)."""
    import torch

    from card_bench.compare import verdict
    from card_bench.trace import Trace

    chips = cell.workload.get("chips", 1)
    if device_check and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise SystemExit(f"card_bench: needs {chips} CUDA device(s), found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    driver = importlib.import_module(f"card_bench.drivers.{cell.traffic['driver']}").Driver(cell)
    on_card = driver.dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    begun = _since_start()
    driver.setup()
    setup_s = _since_start()
    print("set-up: " + ", ".join([f"to the driver {begun:.2f} s"] + [
        f"{k} {v:.2f} s" for k, v in driver.laps.parts.items()]), file=sys.stderr)
    win = driver.window(cell.seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"card_bench: loaded after the window: {', '.join(found)}")
    trace = Trace(driver.prof) if cell.trace and driver.prof is not None else None
    driver.release()
    numbers = driver.check()
    layer = driver.layer_context() if cell.trace else {}
    correct, compared = verdict(numbers, cell.limits)

    metrics = {}
    if cell.trace:
        import types

        ctx = types.SimpleNamespace(trace=trace, window={**win, **win["metrics"]},
                                    layer=layer, cell=cell)
        for m in manifest["per_layer"]:
            if not applies(m, cell.name):
                continue
            reader = load_reader(m["name"], cell.root)
            value = reader(ctx) if reader is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest["end_to_end"]:
            if not applies(m, cell.name):
                continue
            value = setup_s if m["name"] == "setup_s" else win["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell.workload.get("chips", 1), "memory_peak_bytes": peak,
              "power_limit": _power_limit() if on_card else None}
    out = {"correct": bool(correct) and win["failed"] == 0, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
        out["breakdown"] = trace.breakdown()
    out["numbers"] = numbers
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("card_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    _caches()
    from card_bench.harness import load_cell, read_json

    manifest = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = load_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace))
    out = execute(cell, manifest)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"card_bench: loaded in this process: {', '.join(found)}")
    numbers = out.pop("numbers")
    compared = out.pop("compared")
    print("numbers: " + json.dumps(numbers), file=sys.stderr)
    out["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
