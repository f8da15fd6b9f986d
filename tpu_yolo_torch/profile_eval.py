"""Where the eval time goes on a CUDA card.

    python -m tpu_yolo_torch.profile_eval [--images 256] [--batch 32]
                                          [--native-eval auto|on|off]

Evaluates YOLOv11-n at 640 px with the `--test` settings (val batch 32,
bf16, conf 0.001, K=2048) through eval/evaluator.py::evaluate, with
seeded serving weights (seeded.py) on a seeded val split of 480x640
JPEGs labelled from those weights' own detections. Prints one JSON
object:

  * eval img/s: images over the wall time of `evaluate` (the second of
    two runs), and the host time inside it spent in matching and AP;
  * the loader alone: one pass of decode, letterbox and labels with 1
    and with 8 threads, and one `cv2.imread` of each of the first 32
    files in one thread (the files' mean size beside it);
  * per batch, each device piece alone at one captured batch, by CUDA
    events: the H2D copy of the pinned uint8 batch, the forward
    (`forward_raw`), NMS (`nms_from_raw`: ranking, decode, greedy keep,
    compaction) and, of it, the greedy keep kernel;
  * a torch.profiler trace of one more `evaluate`: the device's busy
    share of its wall time and device ms per batch by kernel group.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from tpu_yolo_torch.core.config import get_model_config, load_hyperparams
from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
from tpu_yolo_torch.data.loader import make_val_loader
from tpu_yolo_torch.data.native_loader import NativeEvalLoader
from tpu_yolo_torch.eval import evaluator
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.ops import nms
from tpu_yolo_torch.profile_serve import device_time
from tpu_yolo_torch.seeded import (label_from_detections, seeded_images,
                                   serving_state, write_mini_coco)

SIZE = 640


def _ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds of fn() by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(images: int = 256, batch: int = 32, native: str = "auto"):
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: needs a CUDA card")
    import cv2

    dev = torch.device("cuda")
    cfg = get_model_config("n")
    hyp = load_hyperparams()
    state = serving_state(cfg, 0, seeded_images(np.random.default_rng(0), 16, SIZE), dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = write_mini_coco(os.path.join(tmp, "coco"), 0, n_val=images,
                               hw=(480, 640), seed=0)
        label_from_detections(root, YOLO.from_state_dict(cfg, state), SIZE,
                              device="cuda")
        dataset = DetectionDataset(split_files(root, "val2017"), SIZE, hyp,
                                   augment=False,
                                   cache_path=os.path.join(root, "val2017.cache.npy"))

        def loader(threads=8):
            return make_val_loader(dataset, batch, num_workers=threads, native=native,
                                   device=dev)

        files = dataset.filenames[:32]
        t0 = time.perf_counter()
        for f in files:
            cv2.imread(f)
        imread_ms = (time.perf_counter() - t0) * 1e3 / len(files)
        file_kb = float(np.mean([os.path.getsize(f) for f in files])) / 1e3
        loader_s = {}
        for threads in (1, 8):
            t0 = time.perf_counter()
            alone = loader(threads)
            first = None
            for imgs, _ in alone:
                first = imgs if first is None else first
            loader_s[threads] = time.perf_counter() - t0
        loader_kind = alone.stager if isinstance(alone, NativeEvalLoader) else "python"

        model = YOLO.from_state_dict(cfg, state)
        clock = {}
        match_fn, ap_fn = evaluator.match_predictions, evaluator.average_precision

        def timed(fn):
            def tap(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    clock["host"] = clock.get("host", 0.0) + time.perf_counter() - t
            return tap

        runs = []
        for _ in range(2):
            clock.clear()
            evaluator.match_predictions = timed(match_fn)
            evaluator.average_precision = timed(ap_fn)
            try:
                t0 = time.perf_counter()
                result = evaluator.evaluate(model, loader(), SIZE, max_nms=2048, device=dev)
                runs.append((time.perf_counter() - t0, clock["host"]))
            finally:
                evaluator.match_predictions, evaluator.average_precision = match_fn, ap_fn

        # each device piece alone at the first batch
        keep_args = {}
        keep_fn = nms.greedy_keep

        def keep_tap(*a):
            keep_args.setdefault("args", a)
            return keep_fn(*a)

        host = torch.from_numpy(first).pin_memory()
        with torch.inference_mode():
            h2d = _ms(lambda: host.to(dev, non_blocking=True))
            x = host.to(dev).to(torch.bfloat16) / 255
            forward = _ms(lambda: model.forward_raw(x))
            raw = model.forward_raw(x)
            nms.greedy_keep = keep_tap
            try:
                def run_nms():
                    return nms.nms_from_raw(raw, cfg, (SIZE, SIZE), conf_thres=0.001,
                                            iou_thres=0.65, max_det=300,
                                            max_nms=2048, envelope=True)
                nms_total = _ms(run_nms)
            finally:
                nms.greedy_keep = keep_fn
            boxes, cls, valid, thr = keep_args["args"]
            keep = _ms(lambda: keep_fn(boxes, cls, valid, thr))

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            evaluator.evaluate(model, loader(), SIZE, max_nms=2048, device=dev)
            traced_wall = time.perf_counter() - t0
        n_batches = -(-images // batch)
        groups, kernels = device_time(prof, n_batches)
        device_ms = sum(groups.values())

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    wall, host_s = runs[-1]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "model": "v11-n", "size": SIZE, "val_batch": batch, "dtype": "bfloat16",
        "max_nms": 2048, "images": images, "loader": loader_kind,
        "map_tuple": list(result),
        "img_per_s": images / wall, "evaluate_s": [r[0] for r in runs],
        "host_matching_and_ap_s": host_s, "host_share": host_s / wall,
        "loader_alone_img_per_s": {f"threads_{n}": images / t for n, t in loader_s.items()},
        "imread_ms_one_thread": imread_ms, "jpeg_kb_mean": file_kb,
        "per_batch_ms": {"h2d": h2d, "forward": forward, "nms_from_raw": nms_total,
                         "greedy_keep": keep, "nms_without_keep": nms_total - keep,
                         "keep_shape": dict(b=boxes.shape[0], k=boxes.shape[1],
                                            valid=int(valid.sum()))},
        "traced_wall_s": traced_wall,
        "device_ms_per_batch": device_ms,
        "device_busy_share": device_ms * n_batches / (traced_wall * 1e3),
        "groups_ms_per_batch": groups,
        "top_kernels": [{"ms_per_batch": ms, "calls_per_batch": n, "name": name[:120]}
                        for ms, n, name in kernels[:15]],
    }))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", default=256, type=int)
    ap.add_argument("--batch", default=32, type=int)
    ap.add_argument("--native-eval", default="auto", choices=("auto", "on", "off"))
    a = ap.parse_args()
    main(images=a.images, batch=a.batch, native=a.native_eval)
