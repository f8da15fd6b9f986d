#!/usr/bin/env python
"""tpu_yolo_torch CLI: train / test / profile / export, the slices of
`tpu_yolo/cli/main.py` that are ported, plus --device.

    python -m tpu_yolo_torch.cli.main --train --data-dir ./COCO --batch-size 64
    python -m tpu_yolo_torch.cli.main --test --data-dir ./COCO --weights best.ckpt
    python -m tpu_yolo_torch.cli.main --profile --input-size 640
    python -m tpu_yolo_torch.cli.main --export --weights best.ckpt
    python -m tpu_yolo_torch.cli.main --export onnx --weights best.ckpt

--device-augment runs the mosaic/affine/HSV/flip augmentation on the
device; --native-train decodes and prescales training images natively
(nvJPEG on the card, the C++ pool on the CPU) and augments them with
host cv2. `--profile` prints the parameter count and
GFLOPs of a seeded model and exits; the same banner opens --train.
`--export` writes the eval forward under save-dir/export_{size}: bare
`--export` (or `torch`) a `torch.export` program, `onnx` an opset-17
`model.onnx` (utils/onnx, no `onnx` package needed), `both` the two.

--distributed trains and evaluates data-parallel, one process per card,
in the process group that torchrun's environment describes (NCCL; gloo
with --device cpu):

    python -m torch.distributed.run --nproc-per-node 8 \
        -m tpu_yolo_torch.cli.main --train --distributed --batch-size 256
    python -m torch.distributed.run --nproc-per-node 8 \
        -m tpu_yolo_torch.cli.main --test --distributed --weights best.ckpt

--batch-size is the global batch: each rank takes batch // world rows of
it. Rank 0 writes the files and prints; --profile and --export run on
rank 0 alone. `python -m tpu_yolo_torch.preflight` checks a launch first.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("tpu-yolo-torch")
    p.add_argument("--model-size", default="n", choices=list("ntsmlx"))
    p.add_argument("--input-size", default=640, type=int)
    p.add_argument("--batch-size", default=32, type=int)
    p.add_argument("--val-batch-size", default=32, type=int)
    p.add_argument("--epochs", default=600, type=int)
    p.add_argument("--train", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--coco-metrics", action="store_true",
                   help="with --test: also compute the COCO-API "
                        "12-metric table (AP/AP50/AP75, AP by area, "
                        "AR@1/10/100 — first-party protocol, "
                        "eval/coco_eval.py) in original-image space")
    p.add_argument("--export", nargs="?", const="torch", default="",
                   choices=["torch", "onnx", "both"],
                   help="export the eval forward under "
                        "save-dir/export_{size}: torch (bare --export) a "
                        "torch.export program, onnx an opset-17 model.onnx "
                        "(f32, symbolic batch, NCHW input in [0, 1]), both "
                        "the two")
    p.add_argument("--profile", action="store_true",
                   help="print params + GFLOPs (torch.utils.flop_counter) "
                        "and exit")
    p.add_argument("--weights", default="",
                   help=".ckpt/.pt/.npz to load (--test and --export read "
                        "save-dir/best.ckpt without it)")
    p.add_argument("--resume", default="", help="checkpoint to resume from")
    p.add_argument("--data-dir", default="./COCO")
    p.add_argument("--save-dir", default="./weights")
    p.add_argument("--hyp", default="", help="hyperparameter yaml override")
    p.add_argument("--workers", default=8, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--plot", action="store_true",
                   help="save eval curves (needs matplotlib)")
    p.add_argument("--tensorboard", action="store_true",
                   help="also log scalars to save-dir/tb (CSV always written)")
    p.add_argument("--max-nms", default=2048, type=int,
                   help="eval NMS candidate budget K (capped at 8192). "
                        "The K-budget output is an exact prefix of the "
                        "reference's max_nms=30000 output (prefix "
                        "property, ops/nms.py); every eval prints a "
                        "per-run spill certificate and says when to "
                        "raise this")
    p.add_argument("--native-eval", default="auto",
                   choices=["auto", "on", "off"],
                   help="eval data loader: on a card (auto, the default, "
                        "and on) JPEGs decoded by nvJPEG and placed on the "
                        "card ([eval] loader: nvjpeg; a failure to build "
                        "it raises); on the CPU the native C++ pipeline "
                        "where it builds (auto; on requires it), else the "
                        "Python cv2 loader; off: the Python cv2 loader, "
                        "the parity oracle (identical geometry either way)")

    p.add_argument("--native-train", default="off",
                   choices=["auto", "on", "off"],
                   help="train data loader: decode + prescale natively, "
                        "augmentation with host cv2 (data/native_train.py; "
                        "prescale interpolation drawn per source, as the "
                        "Python loader draws it). off (default) keeps the "
                        "Python cv2 loader; on a card auto and on decode "
                        "with nvJPEG and prescale on the card ([train] "
                        "loader: nvjpeg; a failure to build it raises); on "
                        "the CPU they take the native C++ pool, auto "
                        "falling back to the Python loader with the reason "
                        "where it cannot be built")
    p.add_argument("--device-augment", action="store_true",
                   help="run mosaic/affine/HSV/flip augmentation on the "
                        "device (ops/augment_device.py); the sources are "
                        "decoded by nvJPEG and staged on the card (stager "
                        "nvjpeg), on the CPU by the native C++ pool or cv2 "
                        "where it cannot be built; the host draws the "
                        "parameters")

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
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over the ranks torchrun starts, one "
                        "process per card (NCCL), or gloo with --device cpu; "
                        "--batch-size is then the global batch")
    return p.parse_args(argv)


def setup_seed(seed: int):
    """Seed the host generators the data pipeline draws from, and torch."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def load_model(args, cfg):
    """The BN-folded YOLO of --weights, or of save-dir/best.ckpt without
    it (a `.ckpt`'s EMA weights when it has them)."""
    from tpu_yolo_torch.io.weights import load_params
    from tpu_yolo_torch.models.yolov11 import YOLO

    path = args.weights or os.path.join(args.save_dir, "best.ckpt")
    return YOLO.from_state_dict(cfg, load_params(path, cfg)).fold_batchnorm()


def print_banner(args, cfg):
    """The profile banner of a model of seeded weights (--seed), folded,
    on args.device."""
    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.serve import _device
    from tpu_yolo_torch.utils.profiler import print_profile

    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(args.seed, cfg), cfg))
    print_profile(model.fold_batchnorm().to(_device(args.device)), cfg,
                  args.input_size)


def run_test(args, hyp, cfg, max_images: int | None = None, dp=None):
    """The --test body: load the weights, build the val2017 loader, run
    the eval pass on one device (args.device) or, with `dp` (a
    DataParallel over the ranks), each rank on its rows of every batch.
    Returns (mAP, mAP50, recall, precision), the same on every rank."""
    from tpu_yolo_torch import parallel
    from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
    from tpu_yolo_torch.data.loader import make_val_loader
    from tpu_yolo_torch.data.native_loader import NativeEvalLoader
    from tpu_yolo_torch.eval import evaluator

    model = load_model(args, cfg)
    filenames = split_files(args.data_dir, "val2017")
    cache = os.path.join(args.data_dir, "val2017.cache.npy")
    if max_images is not None:
        filenames = filenames[:max_images]
        # the label cache stores the full dict it was built with, so a
        # truncated run must not share the full-set cache
        cache = os.path.join(args.data_dir,
                             f"val2017.first{max_images}.cache.npy")
    dataset = DetectionDataset(
        filenames, args.input_size, hyp, augment=False, cache_path=cache)
    loader = make_val_loader(
        dataset, args.val_batch_size, num_workers=args.workers,
        native=args.native_eval,
        shard=None if dp is None else (dp.process_index, dp.process_count),
        device=args.device if dp is None else dp.devices[0])
    is_rank0 = parallel.rank() == 0
    if is_rank0:
        print(f"[eval] loader: "
              f"{loader.stager if isinstance(loader, NativeEvalLoader) else 'python'}",
              flush=True)

    coco_ctx = None
    if args.coco_metrics:
        coco_ctx = evaluator.build_coco_ctx(dataset, args.input_size)

    result = evaluator.evaluate(
        model, loader, args.input_size,
        plot_dir=args.save_dir if args.plot else None,
        names=[v for _, v in sorted(hyp["names"].items())],
        progress=True, coco_ctx=coco_ctx, max_nms=args.max_nms,
        device=args.device, dp=dp)

    if coco_ctx is not None and is_rank0:
        from tpu_yolo_torch.eval.coco_eval import summarize
        print(summarize(coco_ctx[0].accumulate()))
    return result


def main(argv=None):
    args = parse_args(argv)
    setup_seed(args.seed)

    from tpu_yolo_torch import parallel

    dp = None
    if args.distributed:
        # one process per card: the data axis is the ranks, one device each
        dp = parallel.DataParallel(parallel.make_mesh(
            devices=[parallel.init_distributed(args.device)]))
    try:
        _run(args, dp, parallel.rank() == 0)
    finally:
        parallel.close_distributed()


def _run(args, dp, is_rank0: bool):
    from tpu_yolo_torch.core.config import get_model_config, load_hyperparams

    hyp = load_hyperparams(args.hyp or None)
    cfg = get_model_config(args.model_size, num_classes=len(hyp["names"]))

    if args.profile:
        if is_rank0:
            print_banner(args, cfg)
        return

    if args.train:
        from tpu_yolo_torch.train.trainer import train

        if is_rank0:
            print_banner(args, cfg)
        train(args, hyp, cfg, device=args.device, dp=dp)

    if args.test:
        m_ap, m_ap50, recall, precision = run_test(args, hyp, cfg, dp=dp)
        if is_rank0:
            print(f"mAP: {m_ap:.3f}  mAP@50: {m_ap50:.3f}  "
                  f"Recall: {recall:.3f}  Precision: {precision:.3f}")

    if args.export and is_rank0:
        from tpu_yolo_torch.serve import _device

        out_dir = os.path.join(args.save_dir, f"export_{args.model_size}")
        model = load_model(args, cfg).to(_device(args.device))
        if args.export in ("torch", "both"):
            from tpu_yolo_torch.utils.export import export_program

            manifest = export_program(model, cfg, args.input_size, out_dir)
            del manifest["weights"]  # one entry per tensor: too long to print
            print(f"exported: {out_dir} {manifest}")
        if args.export in ("onnx", "both"):
            from tpu_yolo_torch.utils.onnx import export_onnx

            os.makedirs(out_dir, exist_ok=True)
            meta = export_onnx(model, cfg, args.input_size,
                               os.path.join(out_dir, "model.onnx"))
            print(f"exported: {meta}")


if __name__ == "__main__":
    main()
