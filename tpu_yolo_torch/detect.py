#!/usr/bin/env python
"""Run detection on image files and save annotated copies (the port's
counterpart of `tools/detect.py`), over `serve.Detector` and utils/viz.

    python -m tpu_yolo_torch.detect --weights yolo11n.pt --size n \
        --out ./detections img1.jpg img2.jpg ...

Runs on the card unless `--device cpu` is given; there the files are
decoded by nvJPEG and letterboxed (or, with `--device-letterbox`,
staged) on the card, on the CPU by the native C++ pool or cv2 (the line
`stager: nvjpeg|native|cv2` names it). `--int8` quantizes the model to
int8 W8A8 first, calibrated on the first `--batch-size` images.
"""
from __future__ import annotations

import argparse
import os
import sys

from tpu_yolo_torch.core.config import SIZES


def parse_args(argv=None):
    p = argparse.ArgumentParser("tpu-yolo-torch detect", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("images", nargs="+", help="image paths")
    p.add_argument("--weights", required=True, help=".pt/.npz/.ckpt")
    p.add_argument("--size", default="n", choices=SIZES,
                   help="YOLO11 n/t/s/m/l/x or YOLO12 12n/12s/12m/12l/12x")
    p.add_argument("--input-size", default=640, type=int)
    p.add_argument("--conf", default=0.25, type=float)
    p.add_argument("--iou", default=0.65, type=float)
    p.add_argument("--batch-size", default=16, type=int)
    p.add_argument("--out", default="./detections", help="output dir")
    p.add_argument("--int8", action="store_true",
                   help="quantize (calibrates on the first --batch-size images)")
    p.add_argument("--device-letterbox", action="store_true",
                   help="decode only into a raw staging buffer (nvJPEG on "
                        "a card); resize+pad runs on the device "
                        "(ops/letterbox.py)")
    p.add_argument("--latency-mode", action="store_true",
                   help="the low-latency preset (single-label ranking, "
                        "K=256) and detect_one per image instead of "
                        "batched streaming")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import cv2

    from tpu_yolo_torch.core.config import COCO_NAMES
    from tpu_yolo_torch.serve import Detector
    from tpu_yolo_torch.utils.viz import draw_detections

    det = Detector.from_checkpoint(args.weights, size=args.size,
                                   input_size=args.input_size,
                                   conf_thres=args.conf, iou_thres=args.iou,
                                   device_letterbox=args.device_letterbox,
                                   latency_mode=args.latency_mode,
                                   device=args.device)
    if args.int8:
        det.quantize(args.images[:args.batch_size])
    os.makedirs(args.out, exist_ok=True)
    n_boxes = 0
    results = ((det.detect_one(p) for p in args.images) if args.latency_mode
               else det.stream(args.images, batch_size=args.batch_size))
    for r in results:
        if r.get("error"):
            print(f"{r['path']}: decode failed", file=sys.stderr)
            continue
        img = draw_detections(cv2.imread(r["path"]), r["boxes"], r["scores"],
                              r["classes"], names=COCO_NAMES)
        dst = os.path.join(args.out, os.path.basename(r["path"]))
        cv2.imwrite(dst, img)
        n_boxes += len(r["boxes"])
        print(f"{r['path']}: {len(r['boxes'])} detections -> {dst}")
    if det.stager is not None:
        print(f"stager: {det.stager}")
    print(f"done: {n_boxes} detections over {len(args.images)} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
