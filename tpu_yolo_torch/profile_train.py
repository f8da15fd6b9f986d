"""Where a training step's time goes on a CUDA card.

    python -m tpu_yolo_torch.profile_train [--remat stage|blocks]

Trains YOLOv11-n at 640 px, batch 64, in bf16 on one seeded batch
(seeded.py: 1..40 boxes an image, GT bucket 64), times 10 `train_step`s
by CUDA events and the host clock, then traces 3 steps with
torch.profiler. Prints one JSON object: img/s, ms per step, peak device
memory, the device's busy share of the traced wall time, and device time
per step by kernel group and for the top kernels.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from tpu_yolo_torch.core.config import get_model_config
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.profile_serve import device_time
from tpu_yolo_torch.seeded import seeded_train_batch
from tpu_yolo_torch.train.step import init_train_state, train_step

GROUPS = (  # first match wins; matched against the lowercased kernel name
    ("topk_mask", r"topk_mask_kernel"),
    ("optimizer_ema", r"multi_tensor|foreach"),
    ("conv_wgrad", r"wgrad"),
    ("conv_dgrad", r"dgrad"),
    ("layout", r"nchwtonhwc|nhwctonchw|transpose"),
    ("pool_upsample", r"max_pool|upsample"),
    ("softmax", r"softmax"),
    ("conv_fwd_and_gemm", r"conv|xmma|implicit|cudnn|gemm|fprop|cutlass"),
    ("cat", r"catarray"),
    ("reduce", r"reduce"),
    ("index", r"index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
    ("copy", r"memcpy|memset|copy"),
)


def main(batch: int = 64, size: int = 640, timed: int = 10, traced: int = 3,
         remat=False):
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_model_config("n")
    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg))
    state = init_train_state(model.to(device=dev, memory_format=torch.channels_last))
    images, gt = (torch.from_numpy(a).to(dev) for a in
                  seeded_train_batch(np.random.default_rng(0), batch, size))
    gains = [7.5, 0.5, 1.5]

    def step():
        return train_step(state, images, gt, 1e-4, gains, 5e-4, 0.937, cfg=cfg,
                          remat=remat)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(timed):
        losses = step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    event_ms = start.elapsed_time(end) / timed

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            step()
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels = device_time(prof, traced, GROUPS)
    device_ms = sum(groups.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "model": "v11-n", "size": size, "batch": batch, "dtype": "bfloat16",
        "remat": remat, "gt_bucket": gt.shape[1], "losses": losses.tolist(),
        "img_per_s": batch / wall_ms * 1e3, "wall_ms_per_step": wall_ms,
        "event_ms_per_step": event_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "traced_wall_ms_per_step": traced_wall_ms / traced,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms * traced / traced_wall_ms,
        "launches_per_step": sum(n for _, n, _ in kernels),
        "groups_ms_per_step": groups,
        "top_kernels": [{"ms_per_step": ms, "calls_per_step": n, "name": name[:120]}
                        for ms, n, name in kernels[:20]],
    }))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--remat", default="", choices=("", "stage", "blocks"))
    ap.add_argument("--batch", default=64, type=int)
    a = ap.parse_args()
    main(batch=a.batch, remat=a.remat or False)
