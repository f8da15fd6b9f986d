"""Pre-launch checks of a data-parallel run (counterpart of
`tools/multihost_preflight.py`).

Run it under the same launcher, on the same machines, as the run it
checks, one process per card:

    python -m torch.distributed.run --nproc-per-node 8 \\
        -m tpu_yolo_torch.preflight --batch-size 256 --data-dir ./COCO --prewarm

Without torchrun's environment it checks one process. Six checks:

  1. rendezvous: the process group forms (NCCL on the card, gloo with
     --device cpu) and a first collective returns, timed;
  2. devices: this rank's device is there (name, count);
  3. topology: every rank's machine has as many local devices as the
     others, each machine runs one rank per device, and the devices sum
     to the world size;
  4. batch: the global --batch-size splits evenly over the ranks;
  5. gt_bucket: a scan of the training labels, the --gt-bucket that
     holds 99.9% of per-rank batches, and a failure where an image holds
     more than 512 boxes, the largest bucket, so that even the adaptive
     bucket drops labels;
  6. prewarm (--prewarm): builds the three kernels and runs one real
     `train_step` at the per-rank batch and size, so that no rank of the
     run pays nvcc (the builds are shared under tpu_yolo_torch/build/).

Prints one line per check and a final JSON verdict {"ok", "process_id",
"checks": {name: bool}}; exits 0 only if every check passed.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch

from tpu_yolo_torch import parallel

GT_BUCKETS = (32, 64, 128, 256, 512)   # train/trainer.py


def check(results: dict, name: str, ok: bool, detail: str) -> bool:
    results[name] = bool(ok)
    print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    return bool(ok)


def gt_bucket_advice(data_dir: str, per_rank: int, results: dict) -> bool:
    """Recommend --gt-bucket from the label set: the smallest bucket that
    holds the fullest image of 99.9% of 2000 simulated per-rank batches.
    Fails where the densest image has more boxes than the largest bucket."""
    from tpu_yolo_torch.data.dataset import split_files
    from tpu_yolo_torch.data.labels import load_labels

    txt = os.path.join(data_dir, "train2017.txt")
    if not os.path.exists(txt):
        return check(results, "gt_bucket", True,
                     f"skipped (no {txt}; pass --data-dir to scan the labels)")
    cache = os.path.join(data_dir, "train2017.cache.npy")
    labels = load_labels(split_files(data_dir, "train2017"),
                         cache if os.path.exists(cache) else None)
    counts = np.asarray([len(v) for v in labels.values()])
    if not len(counts):
        return check(results, "gt_bucket", False, "no labels found")
    draws = np.random.default_rng(0).choice(counts, size=(2000, max(per_rank, 1)))
    batch_max = draws.max(axis=1)
    rec = next((b for b in GT_BUCKETS if (batch_max <= b).mean() >= 0.999),
               GT_BUCKETS[-1])
    dense = int(counts.max())
    detail = (f"images={len(counts)} gt/img p50={int(np.median(counts))} "
              f"max={dense}; per-rank batch {per_rank} -> recommend --gt-bucket "
              f"{rec} (batch overflow p={float((batch_max > rec).mean()):.2%})")
    if dense > GT_BUCKETS[-1]:
        detail += (f"; {int((counts > GT_BUCKETS[-1]).sum())} images hold more "
                   f"than {GT_BUCKETS[-1]} boxes, which every bucket truncates")
    return check(results, "gt_bucket", dense <= GT_BUCKETS[-1], detail)


def prewarm(args, device: torch.device, per_rank: int, results: dict) -> bool:
    """Build the kernels, then one train_step at the run's per-rank batch
    and size (bf16 on the card, f32 on the CPU)."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_yolo_torch.core.config import get_model_config, load_hyperparams
    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda, topk_cuda
    from tpu_yolo_torch.seeded import seeded_train_batch
    from tpu_yolo_torch.train.step import init_train_state, train_step

    t0 = time.perf_counter()
    if device.type == "cuda":
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda build: build(),
                          (attention_cuda.build, nms_cuda.build, topk_cuda.build)))
    built_s = time.perf_counter() - t0
    hyp = load_hyperparams(args.hyp or None)
    cfg = get_model_config(args.model_size, num_classes=len(hyp["names"]))
    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg))
    state = init_train_state(model.to(device=device, memory_format=torch.channels_last))
    images, gt = (torch.from_numpy(a).to(device) for a in seeded_train_batch(
        np.random.default_rng(0), per_rank, args.input_size))
    losses = train_step(state, images, gt, 1e-4, [hyp["box"], hyp["cls"], hyp["dfl"]],
                        hyp["weight_decay"], hyp["momentum"], cfg=cfg,
                        compute_dtype=torch.bfloat16 if device.type == "cuda"
                        else torch.float32)
    finite = bool(torch.isfinite(losses).all())
    return check(results, "prewarm", finite,
                 f"kernels built in {built_s:.1f}s; one train_step of "
                 f"{args.model_size}@{args.input_size} at per-rank batch {per_rank} "
                 f"in {time.perf_counter() - t0 - built_s:.1f}s, losses "
                 f"{[round(v, 4) for v in losses.tolist()]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("tpu_yolo_torch.preflight")
    ap.add_argument("--batch-size", type=int, default=256,
                    help="the global training batch of the run")
    ap.add_argument("--model-size", default="n", choices=list("ntsmlx"))
    ap.add_argument("--input-size", type=int, default=640)
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--hyp", default="")
    ap.add_argument("--prewarm", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--rendezvous-timeout", type=float, default=120.0,
                    help="seconds to wait for every rank")
    args = ap.parse_args(argv)

    results: dict = {}
    ok = True
    device = torch.device(args.device)
    process_id = int(os.environ.get("RANK", 0))
    try:
        # 1. rendezvous
        if "RANK" in os.environ:
            t0 = time.perf_counter()
            try:
                device = parallel.init_distributed(device,
                                                   timeout_s=args.rendezvous_timeout)
                parallel.barrier()
            except RuntimeError as e:   # the check's verdict, then stop
                check(results, "rendezvous", False, f"{type(e).__name__}: {e}")
                print(json.dumps({"ok": False, "process_id": process_id,
                                  "checks": results}), flush=True)
                return 1
            ok &= check(results, "rendezvous", True,
                        f"rank {parallel.rank()}/{parallel.world_size()} "
                        f"({torch.distributed.get_backend()}) joined in "
                        f"{time.perf_counter() - t0:.2f}s")
        world = parallel.world_size()

        # 2. devices
        if device.type == "cuda":
            n_local = torch.cuda.device_count()
            ok &= check(results, "devices", n_local > 0,
                        f"{device}: {torch.cuda.get_device_name(device) if n_local else 'none'}"
                        f"; {n_local} local cards")
        else:
            n_local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
            ok &= check(results, "devices", True, f"cpu; {n_local} local ranks")

        # 3. topology
        t0 = time.perf_counter()
        seen = parallel.gather_objects((socket.gethostname(), n_local))
        hosts: dict = {}
        for host, n in seen:
            hosts.setdefault(host, []).append(n)
        uniform = len({n for _, n in seen}) == 1
        one_per_device = all(len(v) == v[0] for v in hosts.values())
        total = sum(v[0] for v in hosts.values())
        ok &= check(results, "topology", uniform and one_per_device and total == world,
                    f"{len(hosts)} machines, local devices per rank "
                    f"{[n for _, n in seen]}, {total} in all for {world} ranks "
                    f"(gather {1e3 * (time.perf_counter() - t0):.0f} ms)")

        # 4. batch
        per_rank = args.batch_size // world
        accumulate = max(round(64 / args.batch_size), 1)
        ok &= check(results, "batch", per_rank >= 1 and args.batch_size % world == 0,
                    f"global {args.batch_size} -> {per_rank} a rank over {world} "
                    f"ranks, accumulate {accumulate}"
                    + ("" if args.batch_size % world == 0 else
                       f" (NOT EVEN: {args.batch_size % world} images of every "
                       f"batch would be dropped)"))

        # 5. gt bucket
        if args.data_dir:
            ok &= gt_bucket_advice(args.data_dir, max(per_rank, 1), results)

        # 6. prewarm
        if args.prewarm and results["devices"]:
            ok &= prewarm(args, device, max(per_rank, 1), results)

        print(json.dumps({"ok": bool(ok), "process_id": process_id,
                          "checks": results}), flush=True)
        parallel.barrier()
        return 0 if ok else 1
    finally:
        parallel.close_distributed()


if __name__ == "__main__":
    sys.exit(main())
