"""COCO-val evaluation loop: device forward + batched NMS -> host AP
(counterpart of `tpu_yolo/eval/evaluator.py`).

  * the model runs in the compute dtype (bf16 by default) on the card,
    from raw uint8 batches: the /255 runs on the device;
  * NMS is the batched fixed-shape path of ops/nms.py (the greedy keep
    kernel on the card), with the eval settings conf 0.001, IoU 0.65,
    300 detections and a candidate budget K = `max_nms`, so a batch's
    detections return in one device-to-host copy;
  * TP matching and AP run on the host in numpy (eval/metrics.py);
  * double-buffered: batch i+1 is staged in pinned memory and launched
    before the host matches batch i, whose result comes back into pinned
    memory behind a CUDA event, so host matching overlaps device work;
  * data-parallel (`dp`, parallel/mesh.py): each process decodes and
    forwards its contiguous rows of every (padded) val batch, split over
    its devices; the rows' detections and GT are gathered on the host in
    dataset order, and every process runs the same matching and AP, so
    the mAP is replicated and equals one process's.

mAP is computed in letterboxed pixel space (GT scaled by the
letterboxed w/h), the contract of the JAX package and its reference.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_yolo_torch import parallel
from tpu_yolo_torch.eval.metrics import average_precision, match_predictions
from tpu_yolo_torch.serve import _device, fetch_async

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def predict_step(model, images, *, compute_dtype=torch.bfloat16,
                 conf_thres: float = 0.001, iou_thres: float = 0.65,
                 max_det: int = 300, max_nms: int = 2048):
    """uint8 NHWC batch on the model's device -> NMS'd detections there
    (YOLO.forward_nms, fused decode + NMS).

    envelope=True adds each image's above-conf candidate count, so that
    the eval loop certifies the candidate budget K on every run: the
    K-budget output is an exact prefix of the output with every candidate
    ranked (ops/nms.py) unless more than K candidates clear conf and
    fewer than max_det survive."""
    with torch.inference_mode():
        x = images.to(compute_dtype) / 255
        return model.forward_nms(x, conf_thres=conf_thres,
                                 iou_thres=iou_thres, max_det=max_det,
                                 max_nms=max_nms, envelope=True)


def _gt_pixel_boxes(targets: dict, image_index: int, input_hw) -> np.ndarray:
    """One image's GT as (M, 5) [cls, x1, y1, x2, y2] letterboxed pixels."""
    idx = np.asarray(targets["idx"]).reshape(-1)
    rows = idx == image_index
    cls = np.asarray(targets["cls"], np.float32).reshape(-1, 1)[rows]
    box = np.asarray(targets["box"], np.float32).reshape(-1, 4)[rows]
    if box.shape[0] == 0:
        return np.zeros((0, 5), np.float32)
    h, w = input_hw
    scale = np.array([w, h, w, h], np.float32)
    px = box * scale
    xyxy = np.concatenate([px[:, :2] - px[:, 2:] / 2,
                           px[:, :2] + px[:, 2:] / 2], axis=1)
    return np.concatenate([cls, xyxy], axis=1)


def build_coco_ctx(dataset, input_size: int):
    """(CocoEvaluator, geoms) for evaluate(coco_ctx=...): per dataset
    image, the original->letterbox geometry (from the image's size) and
    the GT in original-image pixels, the space the COCO protocol's area
    buckets are defined in."""
    import cv2

    from tpu_yolo_torch.data.image import eval_geometry
    from tpu_yolo_torch.eval.coco_eval import CocoEvaluator

    geoms = []
    for path, label in zip(dataset.filenames, dataset.labels):
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot decode image: {path}")
        oh, ow = img.shape[:2]
        gain, pad = eval_geometry((oh, ow), input_size)
        if label.size:
            px = label[:, 1:] * np.array([ow, oh, ow, oh], np.float32)
            gt = np.concatenate(
                [label[:, :1], px[:, :2] - px[:, 2:] / 2,
                 px[:, :2] + px[:, 2:] / 2], axis=1).astype(np.float32)
        else:
            gt = np.zeros((0, 5), np.float32)
        geoms.append((gain, pad, gt, (ow, oh)))
    return CocoEvaluator(), geoms


def _gather_rows(out: dict, gts: list, n: int):
    """Every process's first `n` result rows and GT lists, in rank order
    (dataset order: each holds contiguous rows of the batch)."""
    rows = {k: v if v.ndim == 0 else v[:n] for k, v in out.items()}
    parts = parallel.gather_objects((rows, gts))
    out = {k: v if v.ndim == 0 else np.concatenate([p[0][k] for p in parts])
           for k, v in rows.items()}
    return out, [g for p in parts for g in p[1]], sum(len(p[1]) for p in parts)


def evaluate(model, loader, input_size: int, plot_dir: str | None = None,
             names=(), compute_dtype=torch.bfloat16, progress: bool = False,
             coco_ctx=None, envelope_stats: dict | None = None,
             max_nms: int = 2048, device="cuda", dp=None):
    """Run the full eval pass.

    Args:
      model: a YOLO (folded or not); evaluate takes it over, as Detector
        does: it folds its BatchNorm and moves it to `device` and
        `compute_dtype` in place.
      loader: yields (images uint8 (B,H,W,3), targets dict) batches, the
        images numpy or, from a card loader, a tensor on the card; a
        smaller final batch is padded to the first one's size.
      progress: show a tqdm bar named "eval" over the loader's batches
        (on stderr) and print the candidate-envelope line even when no
        image is at risk.
      coco_ctx: optional (eval.coco_eval.CocoEvaluator, geoms) to also
        accumulate the COCO-protocol metrics; geoms is a dataset-order
        list of ((gx, gy), (pad_w, pad_h), gt_orig (M,5), (ow, oh)) per
        image (build_coco_ctx) — the loader must iterate the dataset
        unshuffled (val loaders do).
      envelope_stats: optional dict filled with the candidate-envelope
        certificate {images, at_risk, max_above_conf, budget}: at_risk
        counts images where MORE than `budget` candidates cleared conf
        AND fewer than max_det detections survived, the only case the
        K-budget NMS output can differ from the reference's
        max_nms=30000 budget. at_risk == 0 certifies the run's detection
        sets bit-exact against that budget.
      device: "cuda" (default; raises without a card) or "cpu".
      dp: a parallel Mesh or DataParallel; its devices replace `device`. The
        loader then yields this process's rows of each batch
        (make_val_loader(shard=(process_index, process_count))), which
        are padded to batch_size / process_count and split over the
        process's devices; the envelope certificate counts every
        process's images. With a process group every rank must call it.
    Returns:
      (mAP, mAP50, recall, precision). COCO results are read from the
      collector by the caller.
    """
    dp = parallel.as_data_parallel(dp)
    devices = [_device(d) for d in (dp.devices if dp is not None else [device])]
    device = devices[0]
    model = model.fold_batchnorm()
    replicas = [m.to(device=d, dtype=compute_dtype,
                     memory_format=torch.channels_last).eval()
                for m, d in zip(dp.replicate(model) if dp is not None else [model],
                                devices)]
    rows = None   # this process's padded rows of a batch, under dp
    if dp is not None:
        shard = (dp.process_index, dp.process_count)
        if dp.process_count > 1 and getattr(loader, "shard", None) != shard:
            raise ValueError(f"evaluate(dp=...) over {dp.process_count} processes "
                             f"takes a loader of this process's rows, "
                             f"make_val_loader(shard={shard})")
        rows = loader.batch_size // dp.process_count
        if loader.batch_size % dp.num_data_shards:
            raise ValueError(f"a val batch of {loader.batch_size} does not split "
                             f"over {dp.num_data_shards} data shards")
    if parallel.rank() != 0:
        progress, plot_dir = False, None

    all_tp, all_conf, all_pcls, all_tcls = [], [], [], []
    env = {"images": 0, "at_risk": 0, "max_above_conf": 0, "budget": 0}

    def consume(fetched, targets, n, base):
        out, done = fetched
        if done is not None:
            done.synchronize()
        out = {k: v.numpy() for k, v in out.items()}
        gts = [_gt_pixel_boxes(targets, b, (input_size, input_size))
               for b in range(n)]
        if dp is not None:
            out, gts, n = _gather_rows(out, gts, n)
        if "n_above_conf" in out and n:
            env["budget"] = int(out["candidate_budget"])
            na = np.asarray(out["n_above_conf"])[:n]
            cnt_b = np.asarray(out["count"])[:n]
            max_det = out["valid"].shape[1]
            env["images"] += n
            env["max_above_conf"] = max(env["max_above_conf"], int(na.max()))
            env["at_risk"] += int(((na > env["budget"])
                                   & (cnt_b < max_det)).sum())
        for b in range(n):
            cnt = int(out["count"][b])
            det = np.zeros((cnt, 6), np.float32)
            det[:, :4] = out["boxes"][b][:cnt]
            det[:, 4] = out["scores"][b][:cnt]
            det[:, 5] = out["classes"][b][:cnt]
            if coco_ctx is not None:
                coll, geoms = coco_ctx
                (gx, gy), (pw, ph), gt_orig, (ow, oh) = geoms[base + b]
                d = det.copy()
                d[:, [0, 2]] = np.clip((d[:, [0, 2]] - pw) / gx, 0, ow)
                d[:, [1, 3]] = np.clip((d[:, [1, 3]] - ph) / gy, 0, oh)
                coll.add_image(d, gt_orig)
            gt = gts[b]
            if cnt == 0:
                if gt.shape[0]:
                    all_tcls.append(gt[:, 0])
                continue
            tp = match_predictions(det, gt, IOU_THRESHOLDS)
            all_tp.append(tp)
            all_conf.append(det[:, 4])
            all_pcls.append(det[:, 5])
            all_tcls.append(gt[:, 0])

    # Batch i is staged in staging[i % 2] and copied to the device
    # asynchronously; that buffer is written again for batch i + 2, after
    # batch i's result (copied back behind its event, which follows the
    # input's copy in stream order) has been consumed.
    # Under dp the base index of a batch is the global count of the images
    # before it: the batch size times its index, as every batch but the
    # last is full.
    staging = None
    seen = 0
    pending = None  # (fetched result, targets, real batch count, base idx)
    batches = loader
    if progress:
        import tqdm

        batches = tqdm.tqdm(loader, total=len(loader), desc="eval")
    for i, (images, targets) in enumerate(batches):
        # a card loader's images are on the device already: its buffers are
        on_card = isinstance(images, torch.Tensor) and images.device.type == "cuda"
        if staging is None:
            shape = (rows or images.shape[0], *images.shape[1:])
            staging = [torch.empty(shape, dtype=torch.uint8,
                                   device=images.device if on_card else "cpu",
                                   pin_memory=device.type == "cuda" and not on_card)
                       for _ in range(2)]
        n = images.shape[0]
        host = staging[i % 2]
        host[:n].copy_(torch.as_tensor(images))
        host[n:] = 0  # pad the final batch: one shape throughout
        parts = (dp.shard_batch(host) if dp is not None
                 else [host.to(device, non_blocking=True)])
        res = [predict_step(m, x, compute_dtype=compute_dtype, max_nms=max_nms)
               for m, x in zip(replicas, parts)]
        out = fetch_async(dp.gather(res) if dp is not None else res[0])
        if pending is not None:
            consume(*pending)
        pending = (out, targets, n, seen)
        seen = (i + 1) * loader.batch_size if dp is not None else seen + n
    if pending is not None:
        consume(*pending)

    if envelope_stats is not None:
        envelope_stats.update(env)
    if env["images"] and (progress or env["at_risk"]):
        ok = ("BIT-EXACT vs the reference's 30k budget"
              if env["at_risk"] == 0 else
              "possible missed tail detections — raise --max-nms")
        print(f"[eval] candidate envelope: {env['at_risk']}/{env['images']}"
              f" images at spill risk (budget K={env['budget']}, max "
              f"above-conf count {env['max_above_conf']}): selection {ok}")

    if not all_tp:
        return 0.0, 0.0, 0.0, 0.0

    tp = np.concatenate(all_tp, 0)
    conf = np.concatenate(all_conf, 0)
    pcls = np.concatenate(all_pcls, 0)
    tcls = np.concatenate(all_tcls, 0) if all_tcls else np.zeros(0)

    res = average_precision(tp, conf, pcls, tcls, plot_dir=plot_dir, names=names)
    return res["map"], res["map50"], res["recall"], res["precision"]
