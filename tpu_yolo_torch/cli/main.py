#!/usr/bin/env python
"""tpu_yolo_torch CLI: the --train slice of `tpu_yolo/cli/main.py`, with
the flags that reach the trainer, plus --device.

    python -m tpu_yolo_torch.cli.main --train --data-dir ./COCO --batch-size 64

Evaluation (--test), export, the profile banner, the native and
on-device loaders and multi-process training are not ported yet and
their flags are not declared.
"""
from __future__ import annotations

import argparse
import random

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("tpu-yolo-torch")
    p.add_argument("--model-size", default="n", choices=list("ntsmlx"))
    p.add_argument("--input-size", default=640, type=int)
    p.add_argument("--batch-size", default=32, type=int)
    p.add_argument("--epochs", default=600, type=int)
    p.add_argument("--train", action="store_true")
    p.add_argument("--weights", default="", help=".pt/.npz to load")
    p.add_argument("--resume", default="", help="checkpoint to resume from")
    p.add_argument("--data-dir", default="./COCO")
    p.add_argument("--save-dir", default="./weights")
    p.add_argument("--hyp", default="", help="hyperparameter yaml override")
    p.add_argument("--workers", default=8, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--tensorboard", action="store_true",
                   help="also log scalars to save-dir/tb (CSV always written)")

    def _nonneg(v):
        iv = int(v)
        if iv < 0:
            raise argparse.ArgumentTypeError(
                f"--gt-bucket must be >= 0, got {iv}")
        return iv

    p.add_argument("--gt-bucket", default=0, type=_nonneg,
                   help="pin the per-step GT pad bucket (0 = adaptive: "
                        "the smallest of 32/64/128/256/512 that holds the "
                        "batch's fullest image)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward pass (less "
                        "activation memory, about 1/3 more operations)")
    p.add_argument("--remat-level", default="stage",
                   choices=("stage", "blocks"),
                   help="with --remat: checkpoint per model stage "
                        "(default), or also per CSP/PSA inner block "
                        "(lowest peak memory, interiors recompute twice)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def setup_seed(seed: int):
    """Seed the host generators the data pipeline draws from, and torch."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None):
    args = parse_args(argv)
    setup_seed(args.seed)

    from tpu_yolo_torch.core.config import get_model_config, load_hyperparams

    hyp = load_hyperparams(args.hyp or None)
    cfg = get_model_config(args.model_size, num_classes=len(hyp["names"]))

    if args.train:
        from tpu_yolo_torch.train.trainer import train

        train(args, hyp, cfg, device=args.device)


if __name__ == "__main__":
    main()
