"""Host-side training orchestration: epochs, schedule, logging, ckpts
(counterpart of `tpu_yolo/train/trainer.py`).

The per-step device work is `train/step.py::train_step`; this module does
what stays on the host: the data pipeline, the LR lookup, CSV logging,
checkpoint save/resume and the mosaic cutoff.

Kept from the JAX package, which keeps them from the reference:
  * accumulate = max(round(64 / batch), 1);
  * weight_decay *= batch * accumulate / 64;
  * LinearLR over micro-steps with a >=100-step / 3-epoch warmup;
  * mosaic disabled when 10 epochs remain;
  * one step.csv row per epoch {epoch, box, cls, dfl, Recall, Precision,
    mAP@50, mAP};
  * best/last checkpoints in the JAX package's layout (either package
    resumes from the other's file) + strip at the end.
  * per-epoch eval of the EMA weights, BN-folded, on val2017
    (eval/evaluator.py; zeros without a val2017.txt); best.ckpt follows
    its mAP.
  * --device-augment: the host stages raw sources and draws the
    augmentation (data/device_augment.py), the pixel work runs on the
    device (ops/augment_device.py) and the augmented batch never comes
    back to the host; the mosaic cutoff switches the loader to its
    plain (letterbox + affine) program.
  * --native-train auto|on|off: decode and prescale in the native C++
    pool, augmentation with host cv2 (data/native_train.py), in the host
    loader's place; `[train] loader: native|host|device` says which
    loader runs and, where auto fell back, why.
"""
from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
from tpu_yolo_torch.data.loader import DataLoader, make_val_loader
from tpu_yolo_torch.eval.evaluator import evaluate
from tpu_yolo_torch.io import checkpoint as ckpt_io
from tpu_yolo_torch.io.weights import (from_jax_params, load_checkpoint_params,
                                       train_state_from_jax, train_state_to_jax)
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.train import optim
from tpu_yolo_torch.train.loss import build_padded_targets
from tpu_yolo_torch.train.step import init_train_state, train_step

_GT_BUCKETS = (32, 64, 128, 256, 512)


def _gt_bucket(n: int) -> int:
    for b in _GT_BUCKETS:
        if n <= b:
            return b
    return _GT_BUCKETS[-1]


class AverageMeter:
    """Running mean that skips NaN."""

    def __init__(self):
        self.num = 0.0
        self.sum = 0.0
        self.avg = 0.0

    def update(self, v, n):
        v = float(v)
        if not np.isnan(v):
            self.num += n
            self.sum += v * n
            self.avg = self.sum / self.num


def _save_train_ckpt(path: str, state, epoch: int, best: float,
                     meta: dict | None = None):
    """Serialize the full training state, in the JAX package's layout."""
    ckpt_io.save_checkpoint(path, {"epoch": epoch + 1, "best": best,
                                   "meta": meta or {},
                                   **train_state_to_jax(state)})


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    return device


def _params_to_device(params: dict, device: torch.device) -> dict:
    """A batch's augmentation parameters (a dict of numpy arrays, nested
    for mixup) on `device`: packed as f32 (flips as 0/1) into one
    buffer, pinned on the way to the card, copied once and split."""
    leaves = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append((path + (k,), np.asarray(v, np.float32)))

    walk(params, ())
    flat = torch.from_numpy(np.concatenate([v.ravel() for _, v in leaves]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    out: dict = {}
    offset = 0
    for path, v in leaves:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[offset:offset + v.size].view(v.shape)
        offset += v.size
    return out


def augment_on_device(batch, device: torch.device, size: int):
    """One DeviceAugmentLoader batch -> (uint8 (B, S, S, 3) images on
    `device`, targets). The program follows from the batch: arity 4 is
    the plain program, a 6-dim source the mixup one, "minv" in the
    parameters the rotation/shear form."""
    from tpu_yolo_torch.ops import augment_device as AD

    if len(batch) == 3:                # mosaic / mixup
        staged, params, targets = batch
        general = "minv" in params.get("a", params)
        if staged.dim() == 6:
            prog = AD.mixup_augment_batch_general if general else AD.mixup_augment_batch
        else:
            prog = AD.augment_batch_general if general else AD.augment_batch
        inputs = (staged.to(device, non_blocking=True),)
    else:                              # plain (mosaic cutoff or mosaic=0)
        staged, hw, params, targets = batch
        prog = (AD.plain_augment_batch_general if "minv" in params
                else AD.plain_augment_batch)
        inputs = (staged.to(device, non_blocking=True),
                  hw.to(device, non_blocking=True))
    images = prog(*inputs, _params_to_device(params, device), out_size=size)
    return images, targets


def train(args, hyp: dict, cfg: ModelConfig, device="cuda"):
    """Full training run; returns the final TrainState. `args` needs:
    data_dir, input_size, batch_size, epochs, save_dir, resume
    (path|None), weights (path|None), workers, model_size; optional:
    gt_bucket, remat, remat_level, tensorboard, device_augment,
    native_train ("off" without it), seed."""
    device = _device(device)
    os.makedirs(args.save_dir, exist_ok=True)
    start_epoch, best = 0, 0.0

    batch = args.batch_size
    accumulate = max(round(64 / batch), 1)
    wd = hyp["weight_decay"] * batch * accumulate / 64

    # --- model + state ------------------------------------------------
    state = None
    sd = None
    if args.resume:
        payload = ckpt_io.load_checkpoint(args.resume)
        if "opt" in payload:  # full training state
            state = train_state_from_jax(payload, cfg, device, accumulate)
            start_epoch = int(payload.get("epoch", 0))
            best = float(payload.get("best", 0.0))
            print(f"resumed from {args.resume} at epoch {start_epoch}")
        else:  # stripped (inference-only) checkpoint: params only, fresh
               # optimizer/EMA, so epoch and best start over too
            sd = from_jax_params(payload["params"], cfg)
            print(f"fine-tuning from stripped checkpoint {args.resume} "
                  "(fresh optimizer/EMA, epoch 0)")
    elif args.weights:
        sd = load_checkpoint_params(args.weights, cfg)
    if state is None:
        if sd is None:
            sd = from_jax_params(init_params(0, cfg), cfg)
        model = YOLO.from_state_dict(cfg, sd).to(
            device=device, memory_format=torch.channels_last)
        state = init_train_state(model, ema=True, accumulate=accumulate)

    # --- data ----------------------------------------------------------
    filenames = split_files(args.data_dir, "train2017")
    cache_path = os.path.join(args.data_dir, "train2017.cache.npy")
    dataset = DetectionDataset(filenames, args.input_size, hyp, augment=True,
                               cache_path=cache_path)
    loader = DataLoader(dataset, batch, shuffle=True,
                        num_workers=args.workers, drop_last=True)
    dev_loader = None
    if getattr(args, "device_augment", False):
        from tpu_yolo_torch.data.device_augment import DeviceAugmentLoader

        dev_loader = DeviceAugmentLoader(
            filenames, args.input_size, hyp, batch, cache_path=cache_path,
            threads=args.workers, seed=getattr(args, "seed", 0),
            pin_memory=device.type == "cuda")
        print(f"[train] device augment: stager {dev_loader.stager}", flush=True)
    loader, kind = _native_train_loader(args, hyp, filenames, cache_path, batch,
                                        dev_loader is not None, loader)
    print(f"[train] loader: {kind}", flush=True)
    active = loader if dev_loader is None else dev_loader
    fixed_bucket = int(getattr(args, "gt_bucket", 0) or 0)
    warned_gt_overflow = False

    # the active loader's length drives the LR schedule and the step count
    num_steps = len(active)
    schedule = optim.linear_lr(args.epochs, num_steps, hyp)
    try:
        optim.plot_lr(schedule, os.path.join(args.save_dir, "lr.png"))
    except ImportError as e:
        print(f"lr.png not written: {e}")

    hyp_gains = [hyp["box"], hyp["cls"], hyp["dfl"]]
    remat = getattr(args, "remat", False) and getattr(args, "remat_level",
                                                       "stage")
    meta = {"size": args.model_size, "num_classes": cfg.num_classes}

    # One pinned staging buffer: the copy to the card is asynchronous, and
    # the buffer is free again once the step's losses have been read.
    pinned = (torch.empty((batch, args.input_size, args.input_size, 3),
                          dtype=torch.uint8, pin_memory=True)
              if device.type == "cuda" and dev_loader is None else None)

    log = open(os.path.join(args.save_dir, "step.csv"), "w", newline="")
    logger = csv.DictWriter(log, fieldnames=[
        "epoch", "box", "cls", "dfl", "Recall", "Precision", "mAP@50", "mAP"])
    logger.writeheader()

    tb = None
    if getattr(args, "tensorboard", False):
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb = SummaryWriter(os.path.join(args.save_dir, "tb"))
        except Exception as e:  # keep training if TB is unavailable
            print(f"tensorboard disabled: {e}")

    try:
        for epoch in range(start_epoch, args.epochs):
            # mosaic off once 10 epochs remain; `<=` so a resume that
            # lands past the crossing still disables it. Runs shorter
            # than 10 epochs never cross, keeping mosaic.
            mosaic_on = args.epochs - epoch > 10 or args.epochs < 10
            dataset.mosaic = mosaic_on
            if hasattr(active, "mosaic"):  # DeviceAugment/NativeTrainLoader
                active.mosaic = mosaic_on and hyp.get("mosaic", 1.0) > 0
            active.set_epoch(epoch)

            # Gradients are zeroed at every epoch start, which drops any
            # accumulated-but-unapplied tail when num_steps % accumulate
            # != 0: a quirk of the reference that the trajectory goldens
            # pin.
            if state.accum is not None:
                torch._foreach_zero_(list(state.accum.values()))

            meters = {k: AverageMeter() for k in ("box", "cls", "dfl")}
            epoch_gt_truncated = 0  # --gt-bucket label loss this epoch
            t0 = time.perf_counter()

            for i, data in enumerate(active):
                if dev_loader is not None:
                    # the augmented batch stays on the device
                    images_dev, targets = augment_on_device(data, device,
                                                            args.input_size)
                elif pinned is not None:
                    images, targets = data
                    pinned.copy_(torch.from_numpy(images))
                    images_dev = pinned.to(device, non_blocking=True)
                else:
                    images, targets = data
                    images_dev = torch.from_numpy(images)
                step = i + num_steps * epoch
                lr = float(schedule[min(step, len(schedule) - 1)])
                apply_update = (step % accumulate) == 0

                counts = np.bincount(np.asarray(targets["idx"], np.int64),
                                     minlength=batch)
                max_n = int(counts.max()) if len(targets["idx"]) else 1
                if fixed_bucket:
                    # --gt-bucket: a fixed pad shape; overflow rows are
                    # dropped by build_padded_targets and counted, so
                    # that sustained label loss shows in the epoch's
                    # summary and not only in a once-per-run warning
                    bucket = fixed_bucket
                    if max_n > fixed_bucket:
                        epoch_gt_truncated += int(
                            np.maximum(counts - fixed_bucket, 0).sum())
                        if not warned_gt_overflow:
                            warned_gt_overflow = True
                            print(f"[train] warning: image with {max_n} "
                                  f"GT boxes truncated to --gt-bucket="
                                  f"{fixed_bucket}")
                else:
                    bucket = _gt_bucket(max(max_n, 1))
                gt = build_padded_targets(
                    targets, batch, bucket,
                    (args.input_size, args.input_size))

                losses = train_step(
                    state, images_dev, torch.from_numpy(gt).to(device), lr,
                    hyp_gains, wd, hyp["momentum"], cfg=cfg,
                    accumulate=accumulate, apply_update=apply_update,
                    remat=remat).tolist()

                for k, v in zip(("box", "cls", "dfl"), losses):
                    if not np.isfinite(v):
                        # Divergence guard: save the blown state for a
                        # post-mortem and stop with a pointer to the last
                        # good checkpoint.
                        crash = os.path.join(args.save_dir, "crash.ckpt")
                        _save_train_ckpt(crash, state, epoch, best, meta)
                        raise FloatingPointError(
                            f"loss_{k} is {v} at epoch {epoch + 1} step "
                            f"{i} (lr={lr:.2e}); diverged state saved to "
                            f"{crash}; resume from "
                            f"{os.path.join(args.save_dir, 'last.ckpt')}")
                    meters[k].update(v, batch)

            # every step's losses were read, so the device has finished
            seconds = time.perf_counter() - t0
            print(f"epoch {epoch + 1}/{args.epochs}: "
                  f"box {meters['box'].avg:.3f} cls {meters['cls'].avg:.3f} "
                  f"dfl {meters['dfl'].avg:.3f} ({seconds:.1f} s, "
                  f"{num_steps * batch / seconds:.1f} img/s)", flush=True)
            if epoch_gt_truncated:
                print(f"[train] epoch {epoch + 1}: {epoch_gt_truncated} "
                      f"GT boxes truncated by --gt-bucket={fixed_bucket} "
                      f"(raise the bucket if persistent)")

            # --- per-epoch eval + checkpoint ---------------------------
            m_ap, m_ap50, recall, precision = _run_eval(
                args, hyp, cfg, state, device)
            logger.writerow({
                "epoch": str(epoch + 1).zfill(3),
                "box": f"{meters['box'].avg:.3f}",
                "cls": f"{meters['cls'].avg:.3f}",
                "dfl": f"{meters['dfl'].avg:.3f}",
                "mAP": f"{m_ap:.3f}", "mAP@50": f"{m_ap50:.3f}",
                "Recall": f"{recall:.3f}", "Precision": f"{precision:.3f}"})
            log.flush()

            if tb is not None:
                for k, v in (("loss/box", meters["box"].avg),
                             ("loss/cls", meters["cls"].avg),
                             ("loss/dfl", meters["dfl"].avg),
                             ("val/mAP", m_ap), ("val/mAP50", m_ap50),
                             ("val/recall", recall),
                             ("val/precision", precision)):
                    tb.add_scalar(k, v, epoch + 1)
                tb.flush()

            best = max(best, m_ap)
            _save_train_ckpt(os.path.join(args.save_dir, "last.ckpt"),
                             state, epoch, best, meta)
            if best == m_ap:
                _save_train_ckpt(os.path.join(args.save_dir, "best.ckpt"),
                                 state, epoch, best, meta)
    finally:
        log.close()
        if tb is not None:
            tb.close()

    for name in ("best.ckpt", "last.ckpt"):
        p = os.path.join(args.save_dir, name)
        if os.path.exists(p):
            ckpt_io.strip_checkpoint(p)
    return state


def _native_train_loader(args, hyp, filenames, cache_path, batch,
                         device_augment: bool, host_loader):
    """(loader, what the `[train] loader:` line says) for --native-train
    auto|on|off: the native loader (data/native_train.py) where it is
    asked for and the library loads; for auto without it the host loader
    and why; for on without it an error. --device-augment stages its own
    sources and takes neither."""
    mode = getattr(args, "native_train", "off")
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"--native-train must be auto|on|off, got {mode!r}")
    if device_augment:
        if mode != "off":
            raise ValueError("--native-train cannot be combined with "
                             "--device-augment, which stages its own sources")
        return host_loader, "device"
    if mode == "off":
        return host_loader, "host"
    from tpu_yolo_torch.data import native_loader

    if not native_loader.available():
        if mode == "on":
            raise RuntimeError("--native-train on requires "
                               "native/libtpuyolo_data.so; run `make -C native`"
                               f" ({native_loader.why_unavailable()})")
        return host_loader, (f"host (--native-train auto: "
                             f"{native_loader.why_unavailable()})")
    from tpu_yolo_torch.data.native_train import NativeTrainLoader

    return NativeTrainLoader(filenames, args.input_size, hyp, batch,
                             cache_path=cache_path, threads=args.workers,
                             seed=getattr(args, "seed", 0)), "native"


def _run_eval(args, hyp, cfg, state, device):
    """(mAP, mAP@50, recall, precision) of the EMA weights, BN-folded, on
    val2017 at --val-batch-size; zeros when the data directory has no
    val2017.txt, as in the JAX package."""
    if not os.path.exists(os.path.join(args.data_dir, "val2017.txt")):
        return 0.0, 0.0, 0.0, 0.0
    dataset = DetectionDataset(
        split_files(args.data_dir, "val2017"), args.input_size, hyp,
        augment=False,
        cache_path=os.path.join(args.data_dir, "val2017.cache.npy"))
    loader = make_val_loader(dataset, args.val_batch_size,
                             num_workers=args.workers,
                             native=getattr(args, "native_eval", "auto"))
    return evaluate(YOLO.from_state_dict(cfg, state.ema), loader,
                    args.input_size, progress=True,
                    max_nms=getattr(args, "max_nms", 2048), device=device)
