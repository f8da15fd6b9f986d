"""Readings of a serving cell's compared numbers over many seeds in one
process: the program's, and beside them its control and each fault, on
the same batches of the same window. The limits in
limits/<workload>.json are set from these readings (the program's
widest over the seeds, the control's least).

    python3 card_bench/sweep.py --workload NAME --first SEED --count N \\
        [--seconds S] [--control] [--faults half_batch,altered] [--out FILE]

Each seed prints one JSON line: {"seed", "attempted", "seconds",
"reference" (how the reference's kept logits lie), and for "program",
"control" and "fault:<name>" the numbers of compare.summary, with
image_error_pct at a few MIN_DUE besides}. The control is the program's
own path one precision below its bf16: a Detector of the same weights
switched to int8 W8A8 by `Detector.quantize`, calibrated on 16 of the
pool's images written as JPEGs. Faults, planted in what the program
returned: "half_batch" (the second half of each batch's images returns
nothing), "altered" (one image's answer altered: the classes of the
detections of the image with the most moved on by one).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_DUES = (10, 25, 50)
KEYS = ("boxes", "scores", "classes", "count")


def half_batch(prog):
    prog = {k: v.clone() for k, v in prog.items()}
    prog["count"][len(prog["count"]) // 2:] = 0
    return prog


def altered(prog, num_classes=80):
    prog = {k: v.clone() for k, v in prog.items()}
    i = int(prog["count"].argmax())
    n = int(prog["count"][i])
    prog["classes"][i, :n] = (prog["classes"][i, :n] + 1) % num_classes
    return prog


FAULTS = {"half_batch": half_batch, "altered": altered}


def int8_detector(driver):
    """The control: the program's int8 W8A8 path on the cell's weights."""
    import cv2
    from tpu_yolo_torch import YOLO, Detector, get_model_config

    t, cell = driver.t, driver.cell
    where = os.path.join(cell.root, "card_bench", ".cache", "int8_calibration")
    os.makedirs(where, exist_ok=True)
    paths = []
    for j, img in enumerate(driver.pool[:16].numpy()):
        paths.append(os.path.join(where, f"{j}.jpg"))
        cv2.imwrite(paths[-1], img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    model = YOLO.from_state_dict(get_model_config(cell.config["program_size"], driver.spec.num_classes),
                                 {k: v.cpu() for k, v in driver.W.items()})
    return Detector(model, input_size=driver.spec.input_size, conf_thres=t["conf"],
                    iou_thres=t["iou"], max_det=t["max_det"], max_nms=t["max_nms"],
                    multi_label=t["multi_label"], device=driver.dev).quantize(paths)


def numbers(driver, batches) -> dict:
    """compare.summary of (prog, ref) batches."""
    from card_bench import compare

    t = driver.t
    parts = [compare.serving(p, r, t["conf"], t["max_det"]) for p, r in batches]
    out = compare.summary(parts)
    for d in MIN_DUES:
        out[f"image_error_pct@{d}"] = compare.summary(parts, min_due=d)["image_error_pct"]
    return out


def reference_shape(refs: dict, max_det: int) -> dict:
    """How the reference's kept logits lie: images at the cap, the median
    and widest of their last kept logit, the largest kept logit."""
    capped, last, top = 0, [], []
    for r in refs.values():
        n = r["count"].long()
        at = n >= max_det
        capped += int(at.sum())
        last += r["logits"][at, max_det - 1].tolist()
        top.append(float(r["logits"][:, 0].max()))
    last = sorted(last)
    return {"images_capped": capped, "last_p50": last[len(last) // 2] if last else None,
            "last_max": last[-1] if last else None, "top_max": max(top) if top else None}


def readings(cell, control=False, faults=(), window_s=None) -> dict:
    """One seed's readings: the program's numbers after a short window,
    and those of the control and of each fault on the same batches."""
    driver = importlib.import_module(f"card_bench.drivers.{cell.traffic['driver']}").Driver(cell)
    driver.setup()
    win = driver.window(cell.seconds if window_s is None else window_s)
    driver.release()
    picked = [(i, {k: v.to(driver.dev) for k, v in res.items()}) for i, res in driver.picks()]
    refs = {i: driver.reference(i) for i, _ in picked}
    out = {"attempted": win["attempted"],
           "reference": reference_shape(refs, driver.t["max_det"]),
           "program": numbers(driver, [(p, refs[i]) for i, p in picked])}
    if control:
        det = int8_detector(driver)
        got = [({k: v for k, v in det.detect_batch(driver.batch_images(i).to(driver.dev)).items()
                 if k in KEYS}, refs[i]) for i, _ in picked]
        del det
        out["control"] = numbers(driver, got)
    for f in faults:
        out["fault:" + f] = numbers(driver, [(FAULTS[f](p), refs[i]) for i, p in picked])
    del driver
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("card_bench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--count", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from card_bench.harness import load_cell, read_json
    from card_bench.run import _caches

    _caches()
    manifest = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in range(args.first, args.first + args.count):
            cell = load_cell(manifest, args.workload, seed, args.seconds, False)
            t0 = time.perf_counter()
            row = {"seed": seed, **readings(cell, args.control,
                                            [f for f in args.faults.split(",") if f])}
            row["seconds"] = time.perf_counter() - t0
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
