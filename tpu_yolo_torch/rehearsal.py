"""Parallel rehearsal worker: N coordinated processes of the port
(counterpart of `tools/multihost_rehearsal.py` and of the dp x tp dryrun
of `__graft_entry__.py`).

Each process is one rank: it draws the same seeded global batches,
takes its contiguous rows, and runs `train_step`s from init_params(0) in
the process group (the BatchNorm, loss and gradient all-reduces of
parallel/mesh.py), then a sharded forward of the EMA weights and, with
--eval-ap, the sharded `evaluate` with its gathered AP. The AP is that
of fixed seeded weights (`eval_weights`) on seeded images labelled with
their own detections, a third shifted and a third given another class,
so that it is far from 0 and checks the gather, not the trajectory. Topology must not change the math: the ranks' losses equal
each other bit for bit and a single process's on the same global batch
within f32 reduction order. Run one process per rank:

    python -m tpu_yolo_torch.rehearsal --num-processes 2 --process-id I \\
        --init-method tcp://localhost:PORT [--device cpu] [--steps 3] [--eval-ap]

With --num-processes 1 and no --init-method it is the single process
with no process group, the oracle; with --init-method it joins a group of
one. Rank I runs on card I modulo the card count (NCCL), and raises
where there is no card; --device cpu runs the ranks on the CPU (gloo),
and --backend gloo lets several ranks share one card. Prints one JSON
line: {"process_id", "world", "coords" (the rank's index on each mesh
axis), "losses" [[box, cls, dfl] per step], "eval_counts",
"state_sha256" (the final parameters, buffers, momentum and EMA, whole),
"sharded" (the names split over the model axis), "collectives" (calls
and bytes of the steps' collectives by axis), "launches" (each kernel's
counter), with --eval-ap "map"/"map50", and with --n-spatial "spatial"}.

  --ckpt PATH         after the last step rank 0 writes the training
                      state as the trainer's .ckpt (JAX layout); every
                      rank waits for it at a barrier
  --resume-from PATH  every rank loads that state instead of the seeded
                      init (pair with --start-step so the data continues)
  --gt-bucket B       a fixed GT pad bucket (else each rank's adaptive one)
  --accumulate K      gradient accumulation over K micro-steps
  --remat LEVEL       stage or blocks: recompute the forward in the backward
  --model tiny|n      a tiny model (8 classes) or YOLOv11-n (80)
  --lr LR             the learning rate of every step (0.01, the JAX
                      rehearsal's)
  --local-devices N   the eval's shards in this process, all on its one
                      device: an oracle at the ranks' global data axis
                      (one process, N = their count) forwards the same
                      per-device batch as each rank, as the JAX
                      rehearsal's oracle runs at the global topology
  --n-model N         a (data, model) mesh: the wide convs split over N
                      ranks (parallel/tensor.py) by --min-channels C
                      (256); the data axis is the world over N
  --n-spatial N       after the steps, the height-sharded inference
                      forward (parallel/spatial.py) on a (data, spatial)
                      mesh of N: the seeded weights --eval-ap uses (or
                      --weights), folded, on --global-batch seeded images
                      of each --spatial-size (repeatable; --size by
                      default) pixels, with each --spatial-stem
                      (repeatable: plain, the default; s2d, the stem
                      folded to space-to-depth; s2d-input, that stem fed
                      the batch already rearranged on the host and split
                      along its H / 2 rows), once per --spatial-dtype
                      (float32, the default; bfloat16). "spatial" holds
                      under "STEM/SIZE/DTYPE" each forward's rows, output
                      digest, NMS counts, time (the second of two
                      forwards) and collectives by axis, and the kernel
                      launches. With no process group, --n-spatial 1 is
                      the unsharded forward, its oracle
  --split-forward     with --n-model, the same forwards (plain stem) with
                      the wide convs split over the model axis by
                      --min-channels (parallel/tensor.py), each rank on
                      its data shard's whole images, reported as "split";
                      --n-model 1 with no process group is its oracle
  --weights PATH      the forwards' weights: a state dict saved with
                      torch.save (BatchNorm folded or not, float or int8)
  --dump DIR          each rank writes DIR/rank{R}.npz: the losses, the
                      whole state after the first step (param/, momentum/,
                      ema/ + name) and that micro-step's gradients, whole
                      (grad/ + name), and at index 0 of the spatial (or
                      model) axis each forward's output for its data shard
                      (spatial/ or split/ + STEM/SIZE/DTYPE)
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from tpu_yolo_torch import parallel
from tpu_yolo_torch.core.config import ModelConfig, get_model_config

TINY = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                   csp=(False, True), num_classes=8)
GAINS = (7.5, 0.5, 1.5)


def make_global_batch(step: int, global_bs: int, size: int, nc: int):
    """The seeded global batch of a step, the same in every process:
    (uint8 (B, S, S, 3) images, targets {cls, box (normalized cxcywh),
    idx}), as tools/multihost_rehearsal.py draws it."""
    rng = np.random.default_rng(1234 + step)
    images = rng.integers(0, 256, (global_bs, size, size, 3), np.uint8)
    cls, box, idx = [], [], []
    for b in range(global_bs):
        n = int(rng.integers(1, 6))
        x1 = rng.uniform(0, size * 0.7, (n, 2))
        wh = rng.uniform(4, size * 0.3, (n, 2))
        xyxy = np.concatenate([x1, np.minimum(x1 + wh, size - 1)], 1)
        c = rng.integers(0, nc, (n, 1)).astype(np.float32)
        cx = (xyxy[:, 0:1] + xyxy[:, 2:3]) / 2 / size
        cy = (xyxy[:, 1:2] + xyxy[:, 3:4]) / 2 / size
        w = (xyxy[:, 2:3] - xyxy[:, 0:1]) / size
        h = (xyxy[:, 3:4] - xyxy[:, 1:2]) / size
        cls.append(c)
        box.append(np.concatenate([cx, cy, w, h], 1).astype(np.float32))
        idx.append(np.full(n, b, np.float32))
    targets = {"cls": np.concatenate(cls), "box": np.concatenate(box),
               "idx": np.concatenate(idx)}
    return images, targets


def slice_rows(images, targets, rows: slice):
    """The rows of a global batch, with idx re-based to them."""
    keep = (targets["idx"] >= rows.start) & (targets["idx"] < rows.stop)
    local = {"cls": targets["cls"][keep], "box": targets["box"][keep],
             "idx": targets["idx"][keep] - rows.start}
    return np.ascontiguousarray(images[rows]), local


class _ValBatches:
    """A val loader over seeded global batches labelled with a model's
    detections, its 30 top-scoring an image: of every three, the first as
    it is, the second shifted right by an eighth of its width (IoU 7/9,
    between the 0.75 and 0.8 thresholds), the third given the next class.
    It yields this process's rows of each batch, make_val_loader(shard=...)'s
    contract for evaluate(dp=...)."""

    def __init__(self, steps, global_bs, size, label_model, dp):
        self.steps, self.batch_size, self.size = steps, global_bs, size
        self.label_model, self.dp = label_model, dp
        self.shard = (dp.process_index, dp.process_count)

    def __len__(self):
        return len(self.steps)

    def __iter__(self):
        from tpu_yolo_torch.eval.evaluator import predict_step

        device = next(self.label_model.parameters()).device
        for step in self.steps:
            images = np.random.default_rng(2000 + step).integers(
                0, 256, (self.batch_size, self.size, self.size, 3), np.uint8)
            res = predict_step(self.label_model, torch.from_numpy(images).to(device),
                               compute_dtype=torch.float32)
            slot = torch.arange(res["valid"].shape[1], device=device)
            keep = res["valid"] & (slot < 30)
            xyxy = res["boxes"][keep].cpu().numpy() / self.size
            cls = res["classes"][keep].cpu().numpy()
            third = slot.expand_as(keep)[keep].cpu().numpy() % 3
            xyxy[third == 1] += (xyxy[third == 1, 2:3] - xyxy[third == 1, 0:1]) / 8 * [1, 0, 1, 0]
            cls[third == 2] = (cls[third == 2] + 1) % self.label_model.cfg.num_classes
            targets = {"cls": cls.astype(np.float32)[:, None],
                       "box": np.concatenate([(xyxy[:, :2] + xyxy[:, 2:]) / 2,
                                              xyxy[:, 2:] - xyxy[:, :2]], 1),
                       "idx": keep.nonzero()[:, 0].float().cpu().numpy()}
            yield slice_rows(images, targets, self.dp.rows(self.batch_size))


def eval_weights(cfg, model: str, size: int, device) -> dict:
    """The seeded weights --eval-ap evaluates (an unfolded state dict):
    init_params for the tiny model; for v11-n seeded.serving_state, whose
    BatchNorm statistics and class biases give detections above the eval
    conf (init_params' give none)."""
    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import init_params
    from tpu_yolo_torch.seeded import seeded_images, serving_state

    if model == "tiny":
        return from_jax_params(init_params(0, cfg), cfg)
    return serving_state(cfg, 0, seeded_images(np.random.default_rng(0), 8, size), device)


def spatial_images(global_bs: int, size: int) -> np.ndarray:
    """The seeded (B, S, S, 3) uint8 images of the --n-spatial forward."""
    from tpu_yolo_torch.seeded import seeded_images

    return seeded_images(np.random.default_rng(3000), global_bs, size)


def state_digest(state) -> str:
    """sha256 of the training state's parameters, buffers, momentum and
    EMA, in name order: equal digests are bit-equal states."""
    h = hashlib.sha256()
    for tree in (state.model.state_dict(), state.momentum, state.ema or {}):
        for name in sorted(tree):
            h.update(name.encode())
            h.update(tree[name].detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser("tpu_yolo_torch.rehearsal")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--init-method", default="",
                    help="tcp://HOST:PORT or file://PATH; none: no process group")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--model", default="tiny", choices=("tiny", "n"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--start-step", type=int, default=0)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accumulate", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--remat", default="", choices=("", "stage", "blocks"))
    ap.add_argument("--gt-bucket", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume-from", default="")
    ap.add_argument("--eval-ap", action="store_true")
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--min-channels", type=int, default=256)
    ap.add_argument("--n-spatial", type=int, default=0)
    ap.add_argument("--spatial-size", type=int, action="append")
    ap.add_argument("--spatial-stem", action="append",
                    choices=("plain", "s2d", "s2d-input"))
    ap.add_argument("--spatial-dtype", action="append",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--split-forward", action="store_true")
    ap.add_argument("--weights", default="")
    ap.add_argument("--dump", default="")
    args = ap.parse_args(argv)
    if args.eval_ap and args.n_model > 1:
        raise SystemExit("--eval-ap evaluates over a data-only mesh: drop --n-model")
    if args.split_forward and args.n_spatial:
        raise SystemExit("--split-forward runs on the (data, model) mesh: drop --n-spatial")

    from tpu_yolo_torch.eval.evaluator import evaluate, predict_step
    from tpu_yolo_torch.io import checkpoint as ckpt_io
    from tpu_yolo_torch.io.weights import (from_jax_params, train_state_from_jax,
                                           train_state_to_jax)
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda, topk_cuda
    from tpu_yolo_torch.parallel import tensor
    from tpu_yolo_torch.train import step as step_mod
    from tpu_yolo_torch.train.loss import build_padded_targets
    from tpu_yolo_torch.train.step import init_train_state, train_step
    from tpu_yolo_torch.train.trainer import _gt_bucket

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpu_yolo_torch.rehearsal: no CUDA device "
                         "(pass --device cpu to run the ranks on the CPU)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.process_id % max(torch.cuda.device_count(), 1))
    if args.init_method:
        device = parallel.init_distributed(
            device, backend=args.backend, init_method=args.init_method,
            rank=args.process_id, world_size=args.num_processes)
    elif args.num_processes != 1:
        raise SystemExit("--num-processes > 1 needs --init-method")
    inner_loss_and_grads, first_grads = step_mod.loss_and_grads, {}

    def grads_tap(*a, **kw):   # the first micro-step's gradients, for --dump
        losses, grads = inner_loss_and_grads(*a, **kw)
        if not first_grads:
            first_grads.update({n: g.clone() for n, g in grads.items()})
        return losses, grads

    try:
        cfg = TINY if args.model == "tiny" else get_model_config("n")
        # the data axis (--local-devices shards a process for the eval;
        # training takes one device a process), and with --n-model a
        # model axis
        mesh = parallel.make_mesh(n_model=args.n_model,
                                  devices=[device] * args.local_devices)
        dp = parallel.DataParallel(mesh)
        if args.resume_from:
            state = train_state_from_jax(ckpt_io.load_checkpoint(args.resume_from),
                                         cfg, device, args.accumulate)
        else:
            model = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg))
            state = init_train_state(model.to(device=device,
                                              memory_format=torch.channels_last),
                                     ema=True, accumulate=args.accumulate)
        dp.shard_model_parallel(state, args.min_channels)
        parallel.broadcast_([*state.model.state_dict().values(),
                             *state.momentum.values(), *(state.accum or {}).values(),
                             *(state.ema or {}).values()])
        rows = dp.rows(args.global_batch)
        local_bs = rows.stop - rows.start

        if args.dump:
            step_mod.loss_and_grads = grads_tap
        parallel.COLLECTIVES.clear()
        losses, dump = [], {}
        for step in range(args.start_step, args.start_step + args.steps):
            images_g, targets_g = make_global_batch(step, args.global_batch, args.size,
                                                    cfg.num_classes)
            images, targets = slice_rows(images_g, targets_g, rows)
            if args.gt_bucket:
                bucket = args.gt_bucket
            else:
                counts = np.bincount(targets["idx"].astype(np.int64), minlength=local_bs)
                bucket = _gt_bucket(max(int(counts.max()), 1))
            gt = build_padded_targets(targets, local_bs, bucket, (args.size, args.size))
            out = train_step(
                state, torch.from_numpy(images).to(device), torch.from_numpy(gt).to(device),
                args.lr, GAINS, 5e-4, 0.937, cfg=cfg, accumulate=args.accumulate,
                apply_update=step % args.accumulate == 0, compute_dtype=torch.float32,
                remat=args.remat or False)
            losses.append(out.tolist())
            if args.dump and not dump:
                dump = _first_step_dump(state, first_grads)
        step_mod.loss_and_grads = inner_loss_and_grads
        collectives = {k: dict(v) for k, v in parallel.COLLECTIVES.items()}
        if args.dump:
            dump["losses"] = np.asarray(losses, np.float32)

        # the whole state (gathered over the model axis where it is split)
        whole = tensor.gather_state(state) if tensor.is_sharded(state.model) else state
        if args.ckpt:
            if parallel.rank() == 0:
                ckpt_io.save_checkpoint(args.ckpt, {"epoch": 0, "best": 0.0, "meta": {},
                                                    **train_state_to_jax(whole)})
            parallel.barrier()

        # one sharded forward of the EMA weights: the detections summed
        # over the data axis
        ema = YOLO.from_state_dict(cfg, whole.ema).fold_batchnorm().to(
            device=device, memory_format=torch.channels_last).eval()
        images_g, _ = make_global_batch(999, args.global_batch, args.size, cfg.num_classes)
        out = predict_step(ema, torch.from_numpy(images_g[rows]).to(device),
                           compute_dtype=torch.float32)
        eval_counts = sum(parallel.gather_objects(int(out["count"].sum()))[::mesh.n_second])
        result = {"process_id": args.process_id, "world": parallel.world_size(),
                  "coords": mesh.coords, "losses": losses, "eval_counts": eval_counts,
                  "state_sha256": state_digest(whole),
                  "sharded": sorted(tensor.split_names(state.model)),
                  "collectives": collectives}
        if args.eval_ap:
            weights = eval_weights(cfg, args.model, args.size, device)
            labeller = YOLO.from_state_dict(cfg, weights).fold_batchnorm().to(
                device=device, memory_format=torch.channels_last).eval()
            res = evaluate(YOLO.from_state_dict(cfg, weights),
                           _ValBatches((1001, 1002), args.global_batch, args.size,
                                       labeller, dp),
                           args.size, compute_dtype=torch.float32, device=device, dp=dp)
            result["map"], result["map50"] = float(res[0]), float(res[1])

        def launches():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return {"topk_mask": topk_cuda.topk_mask.launches,
                    "psa_attention": attention_cuda.fused_attention.launches,
                    "nms_greedy_keep": nms_cuda.greedy_keep.launches}

        if args.n_spatial:
            result["spatial"] = _sharded_forward(args, cfg, device, launches, dump, "spatial")
        if args.split_forward:
            result["split"] = _sharded_forward(args, cfg, device, launches, dump, "model")
        result["launches"] = launches()
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            np.savez(os.path.join(args.dump, f"rank{parallel.rank()}.npz"), **dump)
        print(json.dumps(result), flush=True)
    finally:
        step_mod.loss_and_grads = inner_loss_and_grads
        parallel.close_distributed()


def _first_step_dump(state, grads) -> dict:
    """--dump's arrays of the state after the first step and of that
    step's gradients, whole (gathered over the model axis, a collective)."""
    from tpu_yolo_torch.parallel import tensor

    if tensor.is_sharded(state.model):
        grads = tensor.gather_tensors(state.model, grads)
        state = tensor.gather_state(state)
    out = {}
    for prefix, tree in (("param", state.model.state_dict()), ("grad", grads),
                         ("momentum", state.momentum), ("ema", state.ema)):
        out.update({f"{prefix}/{n}": t.detach().float().cpu().numpy().copy()
                    for n, t in tree.items()})   # a copy: later steps update in place
    return out


def _sharded_forward(args, cfg, device, launches, dump: dict, axis: str) -> dict:
    """The --n-spatial (axis "spatial") or --split-forward (axis "model")
    forwards: this rank's part of its data shard's images through a YOLO
    partitioned over that axis, per stem, size and dtype."""
    from tpu_yolo_torch.models.yolov11 import YOLO, space_to_depth_host
    from tpu_yolo_torch.ops.nms import batched_nms
    from tpu_yolo_torch.parallel.spatial import partition_spatial

    if axis == "spatial":
        mesh = parallel.make_spatial_mesh(n_spatial=args.n_spatial, devices=[device])
        sharding, stems = parallel.spatial_batch_sharding(mesh), args.spatial_stem
    else:
        mesh = parallel.make_mesh(n_model=args.n_model, devices=[device])
        sharding, stems = parallel.batch_sharding(mesh), ["plain"]
    weights = (torch.load(args.weights, map_location="cpu") if args.weights
               else eval_weights(cfg, args.model, args.size, device))
    out = {"coords": mesh.coords, "forwards": {}}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    before = launches()
    for stem in stems or ["plain"]:
        model = YOLO.from_state_dict(cfg, weights).fold_batchnorm()
        if stem != "plain":
            model.fold_stem_space_to_depth()
        model = model.to(device=device, memory_format=torch.channels_last).eval()
        if axis == "spatial":
            partition_spatial(model, mesh)
        else:
            parallel.DataParallel(mesh).shard_model_parallel(model, args.min_channels)
        for size in args.spatial_size or [args.size]:
            images = spatial_images(args.global_batch, size)
            if stem == "s2d-input":
                images = space_to_depth_host(images)
            local = sharding.local(images)
            for name in args.spatial_dtype or ["float32"]:
                x = torch.from_numpy(local).to(device).to(getattr(torch, name)) / 255
                with torch.inference_mode():
                    model(x)   # the first forward pays the process's warm-up
                    sync()
                    parallel.COLLECTIVES.clear()
                    t0 = time.perf_counter()
                    pred = model(x)
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    counts = batched_nms(pred)["count"]
                key = f"{stem}/{size}/{name}"
                h = hashlib.sha256(pred.float().contiguous().cpu().numpy().tobytes())
                out["forwards"][key] = {
                    "rows": list(local.shape[:2]), "shape": list(pred.shape),
                    "sha256": h.hexdigest(), "counts": counts.tolist(), "forward_ms": ms,
                    "collectives": {k: dict(v) for k, v in parallel.COLLECTIVES.items()}}
                if dump and mesh.coords.get(axis, 0) == 0:   # the group holds the same
                    dump[f"{'split' if axis == 'model' else 'spatial'}/{key}"] = (
                        pred.float().cpu().numpy())
    out["launches"] = {k: v - before[k] for k, v in launches().items()}
    return out


if __name__ == "__main__":
    main()
