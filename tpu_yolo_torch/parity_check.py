"""One-command mAP check against the published COCO numbers (the
counterpart of `tools/parity_check.py`).

    python -m tpu_yolo_torch.parity_check --weights yolo11n.pt --data-dir ./COCO
    python -m tpu_yolo_torch.parity_check --weights best.ckpt --model-size x \
        --data-dir ./COCO --device cpu

It drives the port's `--test` path as it is (`cli/main.py::run_test`: the
same loader, the same exact-top-k eval NMS), on the card unless given
`--device cpu`, compares the mAP with the expected value for the model
size, and prints one JSON verdict as its last line; it exits 0 on a pass
(or where there is nothing to compare with) and 1 otherwise.

Expected values (COCO box mAP@0.5:0.95 of the upstream Ultralytics
weights as the reference harness evaluates them):
  n 39.2   s 46.5   m 51.2   l 53.0   x 54.3
`--expect` overrides them; the tolerance is +-0.5 mAP points (`--tol`).
`--max-images` cuts the val set for a smoke run: the verdict is printed,
and `pass` is never true.

Dataset layout: DATA_DIR/val2017.txt (one image file name a line),
DATA_DIR/images/val2017/*.jpg, DATA_DIR/labels/val2017/*.txt (YOLO
format).
"""
from __future__ import annotations

import argparse
import json
import os

# COCO box mAP of the upstream weights (the reference's README table)
EXPECTED = {"n": 39.2, "s": 46.5, "m": 51.2, "l": 53.0, "x": 54.3}


def parse_args(argv=None):
    p = argparse.ArgumentParser("parity_check")
    p.add_argument("--weights", required=True,
                   help="checkpoint to check (.pt/.npz/.ckpt; Ultralytics "
                        "or reference layout auto-detected)")
    p.add_argument("--data-dir", default="./COCO")
    p.add_argument("--model-size", default="",
                   help="n/t/s/m/l/x; inferred from the weights filename "
                        "when empty")
    p.add_argument("--input-size", default=640, type=int)
    p.add_argument("--val-batch-size", default=32, type=int)
    p.add_argument("--expect", default=None, type=float,
                   help="expected mAP in points (default: the upstream "
                        "table for the model size)")
    p.add_argument("--tol", default=0.5, type=float,
                   help="pass tolerance in mAP points")
    p.add_argument("--max-images", default=None, type=int,
                   help="truncate the val set (smoke runs; parity "
                        "verdicts need the full 5k)")
    p.add_argument("--workers", default=8, type=int)
    p.add_argument("--save-dir", default="./weights")
    p.add_argument("--hyp", default="")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    # run_test's other settings, at the --test CLI's defaults
    p.set_defaults(native_eval="auto", coco_metrics=False, max_nms=2048)
    return p.parse_args(argv)


def infer_size(weights_path: str) -> str:
    """yolo11n.pt / v11_n.pt / best_s.ckpt ... -> model-size letter."""
    stem = os.path.splitext(os.path.basename(weights_path))[0].lower()
    for tail in ("11", "v11", "_", "-"):
        stem = stem.replace(tail, " ")
    for tok in reversed(stem.split()):
        if tok in EXPECTED or tok == "t":
            return tok
    raise SystemExit(
        f"cannot infer model size from {weights_path!r}; pass --model-size")


def check_layout(data_dir: str):
    listing = os.path.join(data_dir, "val2017.txt")
    if not os.path.isfile(listing):
        raise SystemExit(
            f"{listing} not found: expected the COCO layout "
            "(val2017.txt + images/val2017 + labels/val2017)")
    imgdir = os.path.join(data_dir, "images", "val2017")
    if not os.path.isdir(imgdir):
        raise SystemExit(f"{imgdir} not found")


def main(argv=None) -> int:
    args = parse_args(argv)
    if not os.path.isfile(args.weights):
        raise SystemExit(f"weights not found: {args.weights}")
    check_layout(args.data_dir)
    if not args.model_size:
        args.model_size = infer_size(args.weights)

    from tpu_yolo_torch.cli.main import run_test, setup_seed
    from tpu_yolo_torch.core.config import get_model_config, load_hyperparams

    setup_seed(args.seed)
    hyp = load_hyperparams(args.hyp or None)
    cfg = get_model_config(args.model_size, num_classes=len(hyp["names"]))

    m_ap, m_ap50, recall, precision = run_test(
        args, hyp, cfg, max_images=args.max_images)

    expect = args.expect if args.expect is not None \
        else EXPECTED.get(args.model_size)
    got = m_ap * 100.0
    verdict = {
        "metric": f"coco_val_map_v11{args.model_size}_{args.input_size}",
        "map": round(got, 3), "map50": round(m_ap50 * 100.0, 3),
        "recall": round(recall, 4), "precision": round(precision, 4),
        "expected": expect, "tol": args.tol,
        "full_set": args.max_images is None,
    }
    if expect is None:
        verdict["pass"] = None  # nothing to compare with (size "t")
    else:
        verdict["delta"] = round(got - expect, 3)
        verdict["pass"] = bool(abs(got - expect) <= args.tol
                               and args.max_images is None)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["pass"] in (True, None) else 1


if __name__ == "__main__":
    raise SystemExit(main())
