"""Where the serving time goes on a CUDA card.

    python -m tpu_yolo_torch.profile_serve

Serves YOLOv11-n at 640 px, batch 128, with the Detector's defaults (bf16,
multi-label, K=1024) and seeded weights (seeded.py), times 10 batches by
the host clock, then traces 3 batches with torch.profiler. Prints one
JSON object: img/s, the device's busy share of the traced wall time, and
device time per batch by kernel group, for the top kernels, and for each
of the port's own kernels by name.
"""
from __future__ import annotations

import json
import re
import time

import numpy as np
import torch

from tpu_yolo_torch.core.config import get_model_config
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.seeded import seeded_images, serving_state
from tpu_yolo_torch.serve import Detector

GROUPS = (  # first match wins; matched against the lowercased kernel name
    ("psa_attention", r"attention_\w*kernel"),
    ("nms_greedy_keep", r"nms_keep_kernel"),
    ("sort", r"sort|radix"),
    ("layout", r"nchwtonhwc|nhwctonchw|transpose"),
    ("conv", r"conv|xmma|implicit|cudnn|gemm|fprop|cutlass"),
    ("cat", r"catarray"),
    ("reduce", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
    ("copy", r"memcpy|memset|copy"),
)


def _group(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, pattern in groups:
        if re.search(pattern, low):
            return group
    return "other"


def device_time(prof, per: int, groups=GROUPS):
    """Device time of a torch.profiler trace, per `per` iterations:
    ({group: ms}, [(ms, calls, kernel name), ...] longest first)."""
    by_group, kernels = {}, []
    for e in prof.key_averages():
        # device activities only (kernels, copies); the CPU-side aten::
        # rows repeat their kernels' time, and the profiler's own buffer
        # requests are no work of the program
        us = getattr(e, "self_device_time_total", 0.0)
        if (e.device_type != torch.autograd.DeviceType.CUDA or us <= 0
                or e.key.startswith("Activity Buffer")):
            continue
        ms = us / 1e3 / per
        group = _group(e.key, groups)
        by_group[group] = by_group.get(group, 0.0) + ms
        kernels.append((ms, e.count // per, e.key))
    kernels.sort(reverse=True)
    return dict(sorted(by_group.items(), key=lambda kv: -kv[1])), kernels


def main(batch: int = 128, size: int = 640, timed: int = 10, traced: int = 3):
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_model_config("n")
    imgs = seeded_images(np.random.default_rng(0), batch, size)
    det = Detector(YOLO.from_state_dict(cfg, serving_state(cfg, 0, imgs[:16], dev)),
                   input_size=size, device="cuda")
    for _ in range(3):
        det.detect_batch(imgs)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(timed):
        det.detect_batch(imgs)
    torch.cuda.synchronize()
    img_s = batch * timed / (time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            det.detect_batch(imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    groups, kernels = device_time(prof, traced)
    device_ms = sum(groups.values())
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": "v11-n", "size": size,
        "batch": batch, "img_per_s": img_s,
        "wall_ms_per_batch": wall_ms / traced,
        "device_ms_per_batch": device_ms,
        "device_busy_share": device_ms * traced / wall_ms if wall_ms else None,
        "groups_ms_per_batch": groups,
        "top_kernels": [{"ms_per_batch": ms, "calls_per_batch": n, "name": name[:120]}
                        for ms, n, name in kernels[:15]],
        "own_kernels": [{"ms_per_batch": ms, "calls_per_batch": n, "name": name[:120]}
                        for ms, n, name in kernels
                        if _group(name) in ("psa_attention", "nms_greedy_keep")],
    }))


if __name__ == "__main__":
    main()
