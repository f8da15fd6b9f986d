#!/usr/bin/env python3
"""Smoke run of tpu_yolo_torch on one CUDA card (written for the H100).

    python3 chip_smoke.py

Builds the port's three CUDA kernels from tpu_yolo_torch/csrc, holds each
against its plain PyTorch version, serves YOLOv11-n at 640 px through
`Detector` and checks the result against the port on the CPU, then
trains YOLOv11-n at 640 px and batch 64 in bf16 (one epoch of
`trainer.train` on a seeded mini-COCO with its per-epoch eval of 64 val
images, then timed `train_step`s) and checks an f32 training step's
losses and gradients against the CPU, then evaluates a checkpoint of the
serving weights through the `--test` entry point (`cli.main.run_test`,
val batch 32, bf16) on a seeded val split and checks an f32 eval of 8 of
its images against the CPU. Then the device image geometry: the device
letterbox and the seven augmentation programs, card against CPU and
timed (phases k, l); `Detector(device_letterbox=True).stream` at batch
128 beside the host-letterbox stream, an f32 check of the staged path
and one run of `python -m tpu_yolo_torch.detect --device-letterbox`
(phase m); the trainer with `--device-augment`, mosaic and plain, beside
the host-loader trainer on the same files (phase n). Then the saved
serving program (phase o): `Detector.save_compiled` of the plain and the
staged program at batch 128, each loaded by `Detector.load_compiled` in a
fresh process that imports only the package, its detections bit-equal to
the live Detector's and both kernels counted there, beside a fresh live
Detector's first batch and rate; and one timing row of the forward with
the space-to-depth stem beside the plain stem. Then int8 serving (phase
p): the serving Detector quantized on 16 seeded JPEGs, every int8 conv's
int32 sums on the card equal to the CPU's, both kernels counted, f32
int8 results card against CPU conv by conv and as detections, the int8
program loaded in a fresh process bit-equal to the live Detector, `detect
--int8`, and int8 timed beside bf16; and the profile and the export
(phase q): v11-n's FLOPs against the port's analytic count, a trace of
three serving batches naming both kernels, one symbolic-batch export run
at batches 1, 8 and 128 against the live forward, `--profile` through the CLI.
Then the ONNX export (phase r): phase e's serving weights exported from
a model on the card, the file parsed and run by the port's numpy
interpreter on the host at batches 1 and 2 against the live f32 forward
on the card (TF32 off, the attention kernel counted), and `--export
both` through the CLI; and the trainer with `--native-train auto` and
`--tensorboard` on phase n's mini-COCO (phase s): the loader it took
and why, the top-k kernel counted, the event file's scalars or the
message that disabled it, `--native-train on` refused without the
native library. The kernels are custom ops
(`torch.ops.tpu_yolo_torch.*`), so every launch goes through the
dispatcher. Each phase prints one JSON line; the line before the last
lists the kernels
with their launches on the main path, errors, times and bounds (`ms` and
`library_ms` from launches replayed out of a CUDA graph, so that the
host's launch time stays out; `ms_with_launch` from eager calls), and the
last line is {"ok": true, "device": {...}}. Any failed check raises, so
the script exits non-zero without that line. Without a CUDA card, or
without the tpu_yolo_torch package beside it, it exits non-zero at once.

Weights are random, made from a seed by the port's own init_params, with
BatchNorm statistics set from one pass over seeded images and the class
biases drawn around -3 (tpu_yolo_torch/seeded.py), so that the head's
outputs depend on the image and NMS sees candidates.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
BATCH = 128          # serving batch
TRAIN_BATCH = 64     # training batch
TRAIN_IMAGES = 128   # images of the seeded mini-COCO: two steps an epoch
SIZE = 640           # input pixels
TOP_K = 10           # the assigner's k
HBM_BYTES_S = 3.35e12                       # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,    # dense, per type
              "tfloat32": 495e12}
ATTN_TOL = {"bfloat16": 1e-2, "float32": 1e-5}        # atol and rtol
IOU_FLOPS_PER_PAIR = 14   # f32 operations of one masked IoU test
# attention checks (dtype, BH, T): the serving shape and T=333 (not a multiple of 8)
# with K/V resident, the 1280 px shape, eval's (val batch 32) and one
# image's, T=57 and T=1 with K/V streamed
ATTN_CASES = (("bfloat16", 256, 400), ("bfloat16", 16, 1600), ("bfloat16", 64, 400),
              ("bfloat16", 2, 400), ("bfloat16", 3, 57), ("bfloat16", 5, 1),
              ("bfloat16", 200, 333), ("float32", 32, 400))
# greedy-keep checks (scene of seeded.nms_scene, B, K); the second group
# stresses the walk: the most killers, one cluster, nothing valid, K=1 and
# ragged last words. It draws from a generator of its own: the serving
# images follow the first group in the main one.
NMS_CASES = (("clustered", 128, 1024), ("clustered", 8, 2048), ("clustered", 1, 256),
             ("uniform", 2, 8192))
NMS_STRESS_CASES = (("disjoint", 4, 1024), ("identical", 4, 1024), ("invalid", 2, 1024),
                    ("clustered", 2, 1), ("clustered", 3, 33), ("uniform", 4, 1000))
# eval's shape (val batch 32, K=2048), from a generator of its own too
NMS_EVAL_CASES = (("clustered", 32, 2048), ("uniform", 32, 2048))
EVAL_IMAGES = 256    # the seeded val split of phase (j)
EVAL_BATCH = 32      # --val-batch-size
EVAL_F32_IMAGES = 8  # its first images, evaluated in f32 on the card and the CPU
STAGE = 960          # Detector's stage_size: the staged serving buffer
# phase k: staged images of mixed aspect ratios: 1080x1920 is pre-shrunk
# to fit the stage, 300x200 and 123x777 are upscaled
LETTERBOX_SIZES = ((480, 640), (640, 480), (1080, 1920), (300, 200), (960, 960),
                   (123, 777))
AUG_CHECK_BATCH = 4  # phase l: programs card vs CPU at this batch
STAGED_FILES = 128   # phase m: JPEGs of 480x640, 640x480 and 1080x1920 in turn
ARTIFACT_BATCHES = 10  # phase o: timed batches per process
# phase k's time at (128, 960 -> 640) when the products ran in TF32 (H100)
TF32_LETTERBOX_MS = (8.69, 8.77)
DA_IMAGES = 256      # phase n: the seeded mini-COCO, 4 steps an epoch
INT8_CALIB_FILES = 16  # phase p: the seeded JPEGs Detector.quantize calibrates on
INT8_SUMS_IMAGES = 8   # phase p: images of the int8 sums check, card vs CPU
INT8_DETECT_FILES = 8  # phase p: JPEGs of `detect --int8`
# phase p, f32 int8 card vs CPU. Conv by conv, fed the same input, only
# the float work around the exact sums differs (SiLU's exp rounds apart):
# a few f32 roundings. Whole forwards then quantize some inputs a step
# apart, and random weights amplify each step: 0.506 of one image's
# detections matched both ways on the H100 (the other's all), hence
INT8_LAYER_TOL = 1e-5
INT8_F32_MATCH = 0.45
EXPORT_BATCHES = (1, 8, 128)  # phase q: batches run through one symbolic export
# phase q: the ops and the kernels a trace of serving batches must name
TRACE_NAMES = ("tpu_yolo_torch::psa_attention", "tpu_yolo_torch::nms_greedy_keep",
               "attention_bf16_kernel", "nms_keep_kernel")
PIXEL_GATE = "uint8 equal on >= 99.9% of values, mean |diff| < 0.01"


_START = time.perf_counter()


def emit(phase: str, **fields):
    """One phase's JSON line; `at_s`: seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": round(time.perf_counter() - _START, 1),
                      **fields}), flush=True)


def _cli(argv) -> list[str]:
    """tpu_yolo_torch.cli.main.main(argv) in this process; its stdout lines."""
    import contextlib
    import io

    from tpu_yolo_torch.cli import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().strip().splitlines()


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events around `iters`
    calls. With graph=True the calls are captured into one CUDA graph and
    the events are around its replay: the host's time to launch (some 0.05
    ms a call here, more than the faster kernels take) stays out."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = None
    if graph:
        run = torch.cuda.CUDAGraph()
        with torch.cuda.graph(run):
            for _ in range(iters):
                fn()
        run.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        run.replay()
    else:
        for _ in range(iters):
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_cost(q, v, bound_dtype: str):
    """(bound_ms, bound_by) of softmax(q·kᵀ)·v: q, k, v read once and the
    output written once; the two products' flops at the inputs' rate."""
    bh, t, dk = q.shape
    dh = v.shape[-1]
    nbytes = (2 * q.numel() + 2 * v.numel()) * q.element_size()
    flops = 2 * bh * t * t * (dk + dh)
    return _bound(nbytes, flops, PEAK_FLOPS[bound_dtype])


def nms_cost(boxes, cls, valid):
    """(bound_ms, bound_by) of the greedy keep: boxes, classes, valid and
    keep moved once each; the f32 flops of the IoU tests this data needs,
    pairs j < i of one class with a valid j."""
    import torch

    b, k, _ = boxes.shape
    nbytes = b * k * (16 + 4 + 1 + 1)
    same = cls[:, :, None] == cls[:, None, :]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    pairs = int((same & later & valid[:, :, None]).sum())
    return _bound(nbytes, pairs * IOU_FLOPS_PER_PAIR, PEAK_FLOPS["float32"])


def topk_cost(x):
    """(bound_ms, bound_by) of the top-k mask: x read once (4 bytes an
    entry) and the mask written once (1 byte); about k comparisons an
    entry at the f32 rate."""
    return _bound(5 * x.numel(), TOP_K * x.numel(), PEAK_FLOPS["float32"])


def _bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    # (a) device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import tpu_yolo_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the tpu_yolo_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    import importlib.util

    from tpu_yolo_torch.core.config import get_model_config
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, blocks, nms, nms_cuda, topk_cuda
    from tpu_yolo_torch.seeded import nms_scene, seeded_images, serving_state
    from tpu_yolo_torch.serve import Detector

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], numpy=np.__version__,
         have_cv2=importlib.util.find_spec("cv2") is not None,
         have_yaml=importlib.util.find_spec("yaml") is not None)

    # the host AP integrates with np.trapezoid (eval/metrics.py)
    check(np.lib.NumpyVersion(np.__version__) >= "2.0.0",
          f"numpy {np.__version__}: eval needs numpy >= 2.0 (np.trapezoid)")

    # (b) build the three kernels, one nvcc each, in parallel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        reports = list(pool.map(lambda build: build(),
                                (attention_cuda.build, nms_cuda.build,
                                 topk_cuda.build)))
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         ptxas=[line.strip() for r in reports for line in r.splitlines()
                if "registers" in line or "spill" in line])

    # (c) attention kernel against attention_plain
    gen = torch.Generator(device=dev).manual_seed(SEED)
    attn_rows = []
    for dtype, bh, t in ATTN_CASES:
        dtype = getattr(torch, dtype)
        q, k = (torch.randn(bh, t, 32, device=dev, generator=gen).to(dtype)
                for _ in range(2))
        v = torch.randn(bh, t, 64, device=dev, generator=gen).to(dtype)
        scale = 32 ** -0.5
        got = attention_cuda.fused_attention(q, k, v, scale)
        want = attention_cuda.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        row = dict(dtype=str(dtype), bh=bh, t=t,
                   form=attention_cuda.kernel_form(bh, t, dtype),
                   max_abs_err=float(err.max()),
                   tol=f"atol {tol} + rtol {tol}", ok=ok)
        attn_rows.append(row)
        check(ok, f"attention kernel vs plain {row}")
    check({"resident", "streamed", "f32"} <= {r["form"] for r in attn_rows},
          f"a form of the attention kernel was not run: {attn_rows}")
    emit("attention_check", cases=attn_rows)

    # (d) NMS kernel against greedy_keep_plain, bit for bit
    rng = np.random.default_rng(SEED)
    nms_rows = []
    stress_rng = np.random.default_rng(SEED + 3)
    eval_rng = np.random.default_rng(SEED + 4)
    for scene, b, k in NMS_CASES + NMS_STRESS_CASES + NMS_EVAL_CASES:
        scene_rng = (rng if (scene, b, k) in NMS_CASES else
                     eval_rng if (scene, b, k) in NMS_EVAL_CASES else stress_rng)
        boxes, cls, valid = (torch.from_numpy(a).to(dev)
                             for a in nms_scene(scene_rng, scene, b, k))
        got = nms_cuda.greedy_keep(boxes, cls, valid, 0.65)
        want = nms_cuda.greedy_keep_plain(boxes, cls, valid, 0.65)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        nms_rows.append(dict(scene=scene, b=b, k=k, valid=int(valid.sum()),
                             kept=int(got.sum()), equal=same))
        check(same, f"NMS kernel vs plain on {scene} B={b} K={k}")
    emit("nms_check", cases=nms_rows)

    # (d2) top-k kernel against topk_mask_plain, bit for bit
    topk_rng = np.random.default_rng(SEED + 2)
    topk_rows = []
    for shape, ties in (((64, 64, 8400), False), ((2, 512, 8400), False),
                        ((3, 7, 57), False), ((4, 9, 8400), True),
                        ((1, 8, 25200), False)):
        x = topk_rng.random(shape).astype(np.float32)
        if ties:  # quantized values, all-zero rows, -0.0 among the +0.0
            x = np.round(x * 4) / 4
            x[:, -2:] = 0.0
            x[:, -1, ::3] *= -1.0
        x_cpu = torch.from_numpy(x)
        x = x_cpu.to(dev)
        got = topk_cuda.topk_mask(x, TOP_K)
        want = topk_cuda.topk_mask_plain(x, TOP_K)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        row = dict(shape=list(shape), ties=ties, selected=int(got.sum()), equal=same)
        if ties:
            # argmax's first-index promise on the card, against the CPU, and
            # the padded-row case: an all-zero row selects anchors 0..k-1
            row["plain_card_equals_plain_cpu"] = torch.equal(
                want.cpu(), topk_cuda.topk_mask_plain(x_cpu, TOP_K))
            row["zero_rows_select_first_k"] = bool(got[:, -2:, :TOP_K].all())
            same = (same and row["plain_card_equals_plain_cpu"]
                    and row["zero_rows_select_first_k"])
        topk_rows.append(row)
        check(same and row["selected"] == TOP_K * shape[0] * shape[1],
              f"top-k kernel vs plain: {row}")
    emit("topk_check", cases=topk_rows)

    # (e) the main path: Detector serving v11-n at 640 px, bs128
    cfg = get_model_config("n")
    imgs = seeded_images(rng, BATCH, SIZE)
    state = serving_state(cfg, SEED, imgs[:16], dev)
    det = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
    for _ in range(2):
        det.detect_batch(imgs)
    torch.cuda.synchronize()

    # one serving batch with every count at 0, its kernel inputs captured
    captured = {}
    attn_fn, keep_fn = blocks.fused_attention, nms.greedy_keep

    def attn_tap(q, k, v, scale):
        captured.setdefault("attention", (q, k, v, scale))
        return attn_fn(q, k, v, scale)

    def keep_tap(boxes, cls, valid, thr):
        captured.setdefault("nms", (boxes, cls, valid, thr))
        return keep_fn(boxes, cls, valid, thr)

    blocks.fused_attention, nms.greedy_keep = attn_tap, keep_tap
    attention_cuda.fused_attention.launches = 0
    nms_cuda.greedy_keep.launches = 0
    try:
        res = det.detect_batch(imgs)
        torch.cuda.synchronize()
    finally:
        blocks.fused_attention, nms.greedy_keep = attn_fn, keep_fn
    launches = {"attention": attention_cuda.fused_attention.launches,
                "nms": nms_cuda.greedy_keep.launches}
    check(min(launches.values()) > 0, f"a kernel did not run: {launches}")

    counts = res["count"].cpu()
    check(all(bool(torch.isfinite(v.float()).all()) for v in res.values()),
          "non-finite serving output")
    check(float((counts > 0).float().mean()) >= 0.9,
          f"too few images with detections: {counts.tolist()}")

    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        det.detect_batch(imgs)
    torch.cuda.synchronize()
    img_s = BATCH * iters / (time.perf_counter() - t0)

    # detect_one(img) against row i of detect_batch in bf16: convolutions
    # at batch 1 and 128 round differently, so scores and IoUs near their
    # thresholds flip (89-97% of detections matched on the H100). Gates:
    # at least 85% matched both ways, counts within 5% (or 2), and each
    # side's 10 top-scoring detections all matched in the other, so that
    # a shifted box or a wrong row fails. Phase (f) makes the same
    # comparison in f32 with a tight gate.
    one_rows = []
    for i in range(4):
        one, row = _one(det.detect_one(imgs[i], rescale=False)), _row(res, i)
        agree = _agreement(one, row)
        top10 = [_agreement(_head(one, 10), row)["match"][0],
                 _agreement(_head(row, 10), one)["match"][0]]
        n_one, n_row = agree["count"]
        one_rows.append(dict(image=i, top10_match=top10, **agree))
        check(min(agree["match"]) >= 0.85 and min(top10) == 1.0
              and abs(n_one - n_row) <= max(2, 0.05 * max(n_one, n_row)),
              f"detect_one differs from row {i} of detect_batch: {one_rows[-1]}")

    p50 = _p50_ms(lambda: det.detect_one(imgs[0]))
    lat = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE,
                   device="cuda", latency_mode=True)
    p50_latency = _p50_ms(lambda: lat.detect_one(imgs[0]))

    with torch.inference_mode():
        x = torch.from_numpy(imgs[:16]).to(dev).to(torch.bfloat16) / 255
        ev = det.model.forward_nms(x, max_nms=2048, ranking="exact",
                                   envelope=True)
    torch.cuda.synchronize()
    check(int(ev["candidate_budget"]) == 2048, "eval budget")
    check(all(bool(torch.isfinite(v.float()).all()) for v in ev.values()),
          "non-finite eval output")
    emit("serve", model="v11-n", size=SIZE, batch=BATCH, dtype="bfloat16",
         max_nms=1024, multi_label=True, launches_per_batch=launches,
         img_per_s=img_s, count_min=int(counts.min()),
         count_mean=float(counts.float().mean()),
         bs1_p50_ms=p50, bs1_latency_mode_p50_ms=p50_latency,
         detect_one_vs_batch=one_rows,
         eval_budget=dict(images=16, count_mean=float(ev["count"].float().mean()),
                          n_above_conf_mean=float(ev["n_above_conf"].float().mean())))

    # (f) whole path in f32 on the card (TF32 off) against the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    two = imgs[:2]
    kw = dict(input_size=SIZE, compute_dtype=torch.float32, ranking="exact")
    on_card = Detector(YOLO.from_state_dict(cfg, state), device="cuda", **kw)
    on_cpu = Detector(YOLO.from_state_dict(cfg, state), device="cpu", **kw)
    card = on_card.detect_batch(two)
    cpu = on_cpu.detect_batch(two)
    rows = []
    for i in range(2):
        rows.append(dict(image=i, card_vs_cpu=_agreement(_row(card, i), _row(cpu, i)),
                         one_vs_batch_on_card=_agreement(
                             _one(on_card.detect_one(two[i], rescale=False)),
                             _row(card, i))))
    emit("f32_card_vs_cpu", images=rows,
         threshold="per image and both ways, >= 98% of detections have a "
                   "same-class partner at IoU >= 0.9; partners' boxes within "
                   "0.05 px, scores within 5e-4")
    for row in rows:
        for agree in (row["card_vs_cpu"], row["one_vs_batch_on_card"]):
            check(min(agree["match"]) >= 0.98 and agree["max_box_err_px"] <= 0.05
                  and agree["max_score_err"] <= 5e-4, f"f32 agreement: {row}")
    torch.backends.cudnn.allow_tf32 = True

    # (h) the training path: one epoch through trainer.train, then
    # train_step on one seeded batch, v11-n at 640 px, bs64, bf16
    _train_phase(cfg, dev, smi, captured, launches)

    # (i) one f32 training step's losses and gradients, card against CPU
    _train_f32_phase(cfg, dev, imgs[:2])

    # (j) the eval path: --test's run_test on a seeded val split, counted,
    # then an f32 eval of its first images on the card against the CPU
    _eval_phase(cfg, smi, state, captured, launches)

    # (k, l) the device letterbox and augmentation programs, card vs CPU
    _letterbox_phase(dev, smi)
    _augment_phase(dev, smi)

    # (m) staged serving: Detector(device_letterbox=True) and detect
    _serve_staged_phase(cfg, smi, state, launches)

    # (o) the saved serving program, loaded in fresh processes; then the
    # forward with the space-to-depth stem beside the plain stem
    _serve_artifact_phase(cfg, smi, state, imgs, launches)
    _s2d_stem_row(cfg, smi, state, imgs)

    # (p) int8 W8A8 serving; (q) the profile and the export
    _int8_phase(cfg, smi, state, imgs, launches)
    _profile_export_phase(cfg, smi, state, imgs, launches)

    # (r) the ONNX export of the serving weights, run on the host, against
    # the live f32 forward on the card; --export both through the CLI
    _onnx_phase(cfg, smi, state, imgs, launches)

    # (n) the trainer with --device-augment beside the host loader
    _train_device_augment_phase(cfg, smi, launches)

    # (s) the trainer with --native-train auto and --tensorboard
    _native_train_phase(cfg, smi, launches)

    # (g) each kernel at its main-path inputs: error, times, bound
    with torch.inference_mode():
        kernels = _kernel_rows(captured, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _train_phase(cfg, dev, smi, captured, launches):
    """Phase (h). Fills captured["topk"] and launches["topk"] (per step)."""
    import torch

    from tpu_yolo_torch.core.config import load_hyperparams
    from tpu_yolo_torch.io.checkpoint import load_checkpoint
    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda, topk_cuda
    from tpu_yolo_torch.seeded import seeded_train_batch, write_mini_coco
    from tpu_yolo_torch.train import loss as loss_mod
    from tpu_yolo_torch.train import trainer
    from tpu_yolo_torch.train.step import train_step

    hyp = load_hyperparams()
    assigner_fn, topk_fn = loss_mod.task_aligned_assigner, loss_mod.topk_mask
    calls = {"assigner": 0}

    def assigner_tap(*a, **kw):
        calls["assigner"] += 1
        return assigner_fn(*a, **kw)

    def topk_tap(x, k):
        captured["topk"] = x
        return topk_fn(x, k)

    def zero_counts():
        calls["assigner"] = 0
        for fn in (topk_cuda.topk_mask, attention_cuda.fused_attention,
                   nms_cuda.greedy_keep):
            fn.launches = 0

    # -- one epoch through the normal entry point ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data_dir = write_mini_coco(os.path.join(tmp, "coco"), TRAIN_IMAGES,
                                   n_val=TRAIN_BATCH, hw=(480, 640), seed=SEED)
        write_s = time.perf_counter() - t0
        args = argparse.Namespace(
            model_size="n", input_size=SIZE, batch_size=TRAIN_BATCH, epochs=1,
            data_dir=data_dir, save_dir=os.path.join(tmp, "weights"), resume="",
            weights="", workers=8, gt_bucket=0, remat=False, remat_level="stage",
            tensorboard=False, val_batch_size=EVAL_BATCH, native_eval="auto",
            max_nms=2048)
        loss_mod.task_aligned_assigner = assigner_tap
        zero_counts()
        t0 = time.perf_counter()
        try:
            state = trainer.train(args, hyp, cfg, device="cuda")
            torch.cuda.synchronize()
        finally:
            loss_mod.task_aligned_assigner = assigner_fn
        epoch_s = time.perf_counter() - t0
        epoch_launches = topk_cuda.topk_mask.launches
        # the per-epoch eval of the EMA weights on the val split
        eval_launches = {"attention": attention_cuda.fused_attention.launches,
                         "nms": nms_cuda.greedy_keep.launches}
        with open(os.path.join(args.save_dir, "step.csv")) as f:
            csv_rows = f.read().strip().splitlines()
        stripped = load_checkpoint(os.path.join(args.save_dir, "last.ckpt"))

    steps = TRAIN_IMAGES // TRAIN_BATCH
    accumulate = max(round(64 / TRAIN_BATCH), 1)   # the trainer's rule
    check(state.step == steps
          and state.ema_updates == len(range(0, steps, accumulate)),
          f"trainer took {state.step} steps, {state.ema_updates} updates")
    check(epoch_launches > 0 and epoch_launches == calls["assigner"] == steps,
          f"top-k launches {epoch_launches}, assigner calls {calls['assigner']}")
    check(len(csv_rows) == 2 and all(
        np.isfinite(float(v)) for v in csv_rows[1].split(",")[1:]),
        f"step.csv: {csv_rows}")
    check(min(eval_launches.values()) > 0,
          f"the epoch's eval did not run both kernels: {eval_launches}")

    def moved(now, before):
        return max(float((now[k].float().cpu() - before[k]).abs().max())
                   for k in before)

    init = from_jax_params(init_params(0, cfg), cfg)
    sd = state.model.state_dict()
    stats = {k: v for k, v in init.items() if k.endswith((".mean", ".var"))}
    weights = {k: v for k, v in init.items() if k not in stats}
    movement = dict(bn_stats=moved(sd, stats), params=moved(sd, weights),
                    ema=moved(state.ema, init))
    check(min(movement.values()) > 0, f"something did not move: {movement}")
    check(all(bool(torch.isfinite(v).all()) for v in sd.values()),
          "non-finite weights after the epoch")
    # last.ckpt read back: the final strip keeps the EMA in fp16
    back = YOLO.from_state_dict(cfg, from_jax_params(stripped["params"], cfg))
    ckpt_err = max(float((v - state.ema[k].cpu()).abs().max()
                         / state.ema[k].abs().max().clamp(min=1).cpu())
                   for k, v in back.state_dict().items())
    check(set(stripped) == {"epoch", "best", "params", "meta"}
          and stripped["epoch"] == 1 and ckpt_err < 1e-3,
          f"last.ckpt read back: {sorted(stripped)}, err {ckpt_err}")

    # -- train_step on one seeded batch, counted and timed -----------------
    images, gt = (torch.from_numpy(a).to(dev) for a in
                  seeded_train_batch(np.random.default_rng(SEED), TRAIN_BATCH, SIZE))
    gains = [hyp["box"], hyp["cls"], hyp["dfl"]]

    def step():
        return train_step(state, images, gt, 1e-4, gains, hyp["weight_decay"],
                          hyp["momentum"], cfg=cfg)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    loss_mod.task_aligned_assigner, loss_mod.topk_mask = assigner_tap, topk_tap
    zero_counts()
    try:
        losses = step()
        torch.cuda.synchronize()
    finally:
        loss_mod.task_aligned_assigner, loss_mod.topk_mask = assigner_fn, topk_fn
    launches["topk"] = topk_cuda.topk_mask.launches
    check(launches["topk"] > 0 and launches["topk"] == calls["assigner"],
          f"top-k launches {launches['topk']} in a step, assigner calls "
          f"{calls['assigner']}")
    check(attention_cuda.fused_attention.launches == 0,
          "the training forward went through the inference attention kernel")
    check(bool(torch.isfinite(losses).all()), f"losses {losses.tolist()}")

    iters = 10
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ms = cuda_ms(step, iters=iters, warmup=0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    last = step()
    check(bool(torch.isfinite(last).all()), f"losses {last.tolist()}")
    emit("train", model="v11-n", size=SIZE, batch=TRAIN_BATCH, dtype="bfloat16",
         nvidia_smi=smi, epoch=dict(
             images=TRAIN_IMAGES, steps=steps, seconds=epoch_s,
             write_images_seconds=write_s, topk_launches=epoch_launches,
             assigner_calls=steps, step_csv=csv_rows[1], moved=movement,
             val_images=TRAIN_BATCH, eval_launches=eval_launches,
             last_ckpt_vs_ema_max_rel_err=ckpt_err),
         train_step=dict(
             gt_bucket=gt.shape[1], topk_shape=list(captured["topk"].shape),
             topk_launches_per_step=launches["topk"], losses=losses.tolist(),
             losses_after=last.tolist(), device_ms_per_step=ms,
             wall_ms_per_step=wall_ms, img_per_s=TRAIN_BATCH / wall_ms * 1e3,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9))


def _train_f32_phase(cfg, dev, two_images):
    """Phase (i): loss_and_grads on 2 images in f32, TF32 off, on the card
    and on the CPU."""
    import torch

    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.seeded import seeded_train_batch
    from tpu_yolo_torch.train import loss as loss_mod
    from tpu_yolo_torch.train.step import loss_and_grads

    _, gt = seeded_train_batch(np.random.default_rng(SEED + 1), 2, SIZE, max_boxes=12)
    sd = from_jax_params(init_params(SEED, cfg), cfg)
    assigner_fn = loss_mod.task_aligned_assigner
    fg = {}

    def run(device):
        def tap(*a, **kw):
            out = assigner_fn(*a, **kw)
            fg[device] = out[2].cpu()
            return out

        model = YOLO.from_state_dict(cfg, sd).to(
            device=device, memory_format=torch.channels_last).train()
        loss_mod.task_aligned_assigner = tap
        try:
            losses, grads = loss_and_grads(
                model, torch.from_numpy(two_images).to(device),
                torch.from_numpy(gt).to(device), [7.5, 0.5, 1.5], cfg=cfg)
        finally:
            loss_mod.task_aligned_assigner = assigner_fn
        return ([float(v) for v in losses],
                {k: v.float().cpu() for k, v in grads.items()})

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card_losses, card_grads = run("cuda")
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    cpu_losses, cpu_grads = run("cpu")

    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    # a gradient leaf's error against its largest entry (floor 1e-5: leaves
    # whose gradient is zero hold rounding noise); cuDNN's backward sums
    # in another order than the CPU's
    rel = {k: float((card_grads[k] - v).abs().max() / v.abs().max().clamp(min=1e-5))
           for k, v in cpu_grads.items()}
    worst = max(rel, key=rel.get)
    median = float(np.median(list(rel.values())))
    fg_equal = torch.equal(fg["cuda"], fg["cpu"])
    emit("train_f32_card_vs_cpu", images=2, losses_card=card_losses,
         losses_cpu=cpu_losses, max_loss_rel_err=loss_err, fg_anchors=int(fg["cpu"].sum()),
         fg_mask_equal=fg_equal, grad_leaves=len(rel), grad_worst_leaf=worst,
         grad_worst_rel_err=rel[worst], grad_median_rel_err=median,
         threshold="losses within 1e-4 relative; fg mask equal; every gradient "
                   "leaf within 2e-2 of its largest entry, median within 1e-3")
    check(loss_err <= 1e-4 and fg_equal and rel[worst] <= 2e-2 and median <= 1e-3,
          f"f32 training step, card vs CPU: loss {loss_err}, fg equal {fg_equal}, "
          f"worst gradient {worst} {rel[worst]}, median {median}")


def _eval_phase(cfg, smi, state, captured, launches):
    """Phase (j). Fills captured["eval_attention"], captured["eval_nms"]
    and launches["eval_attention"], launches["eval_nms"] (per run_test)."""
    import contextlib
    import io

    import torch

    from tpu_yolo_torch.cli import main as cli
    from tpu_yolo_torch.core.config import load_hyperparams
    from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
    from tpu_yolo_torch.data.loader import make_val_loader
    from tpu_yolo_torch.eval import evaluator
    from tpu_yolo_torch.io.checkpoint import save_checkpoint
    from tpu_yolo_torch.io.weights import to_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, blocks, nms, nms_cuda
    from tpu_yolo_torch.seeded import label_from_detections, write_mini_coco

    hyp = load_hyperparams()
    attn_fn, keep_fn = blocks.fused_attention, nms.greedy_keep
    eval_fn = evaluator.evaluate
    match_fn, ap_fn = evaluator.match_predictions, evaluator.average_precision
    clock = {}

    def timed(name, fn):
        def tap(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0
        return tap

    def attn_tap(q, k, v, scale):
        captured.setdefault("eval_attention", (q, k, v, scale))
        return attn_fn(q, k, v, scale)

    def keep_tap(boxes, cls, valid, thr):
        captured.setdefault("eval_nms", (boxes, cls, valid, thr))
        return keep_fn(boxes, cls, valid, thr)

    def run_test(args):
        """run_test with its stdout kept, the wall time of `evaluate` and
        the host's matching and AP timed, and both kernels counted."""
        clock.clear()
        attention_cuda.fused_attention.launches = 0
        nms_cuda.greedy_keep.launches = 0
        blocks.fused_attention, nms.greedy_keep = attn_tap, keep_tap
        evaluator.evaluate = timed("evaluate", eval_fn)
        evaluator.match_predictions = timed("host", match_fn)
        evaluator.average_precision = timed("host", ap_fn)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                result = cli.run_test(args, hyp, cfg)
            torch.cuda.synchronize()
        finally:
            blocks.fused_attention, nms.greedy_keep = attn_fn, keep_fn
            evaluator.evaluate = eval_fn
            evaluator.match_predictions, evaluator.average_precision = match_fn, ap_fn
        counts = {"attention": attention_cuda.fused_attention.launches,
                  "nms": nms_cuda.greedy_keep.launches}
        lines = out.getvalue().strip().splitlines()
        print("\n".join(lines), flush=True)
        return result, counts, lines, dict(clock)

    with tempfile.TemporaryDirectory() as tmp:
        # the val split's labels are 30 f32 detections an image of the
        # evaluated weights (a third shifted, a third with another class),
        # so that mAP is far from 0 and moves at every IoU threshold
        t0 = time.perf_counter()
        root = write_mini_coco(os.path.join(tmp, "coco"), 0, n_val=EVAL_IMAGES,
                               hw=(480, 640), seed=SEED)
        label_from_detections(root, YOLO.from_state_dict(cfg, state), SIZE,
                              device="cuda")
        ckpt = os.path.join(tmp, "serving.ckpt")
        save_checkpoint(ckpt, {"params": to_jax_params(state)})
        setup_s = time.perf_counter() - t0
        args = argparse.Namespace(
            weights=ckpt, save_dir=tmp, data_dir=root, input_size=SIZE,
            val_batch_size=EVAL_BATCH, workers=8, native_eval="auto",
            coco_metrics=False, plot=False, max_nms=2048, device="cuda")
        runs = [run_test(args) for _ in range(2)]
        result, counts, lines, _ = runs[0]
        launches["eval_attention"] = counts["attention"]
        launches["eval_nms"] = counts["nms"]
        batches = -(-EVAL_IMAGES // EVAL_BATCH)
        check(counts["nms"] == batches and counts["attention"] >= batches,
              f"kernel launches in run_test: {counts}, {batches} batches")
        check(all(np.isfinite(v) and 0 <= v <= 1 for v in result) and result[1] > 0,
              f"run_test result {result}")
        cert = [ln for ln in lines if ln.startswith("[eval] candidate envelope: ")]
        check(len(cert) == 1 and f"/{EVAL_IMAGES} images at spill risk (budget "
              f"K=2048," in cert[0], f"no spill certificate line: {lines}")
        loader = [ln for ln in lines if ln.startswith("[eval] loader: ")]
        check(len(loader) == 1, f"no loader line: {lines}")

        # f32 on the card (TF32 off) against the CPU, first images
        dataset = DetectionDataset(split_files(root, "val2017")[:EVAL_F32_IMAGES],
                                   SIZE, hyp, augment=False)
        outs, f32 = {}, {}
        predict = evaluator.predict_step
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for device in ("cuda", "cpu"):
                def tap(*a, device=device, **kw):
                    out = predict(*a, **kw)
                    outs[device] = out
                    return out

                evaluator.predict_step = tap
                f32[device] = eval_fn(
                    YOLO.from_state_dict(cfg, state),
                    make_val_loader(dataset, EVAL_F32_IMAGES, native="off"), SIZE,
                    compute_dtype=torch.float32, device=device)
        finally:
            evaluator.predict_step = predict
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    rows = [_agreement(_row(outs["cuda"], i), _row(outs["cpu"], i))
            for i in range(EVAL_F32_IMAGES)]
    tuple_err = max(abs(a - b) for a, b in zip(f32["cuda"], f32["cpu"]))
    walls = [r[3]["evaluate"] for r in runs]
    emit("eval", model="v11-n", size=SIZE, val_batch=EVAL_BATCH, dtype="bfloat16",
         max_nms=2048, images=EVAL_IMAGES, nvidia_smi=smi, loader=loader[0],
         setup_seconds=setup_s, map_tuple=list(result), certificate=cert[0],
         launches_per_run=counts, second_run_map_tuple=list(runs[1][0]),
         runs=[dict(evaluate_s=r[3]["evaluate"], img_per_s=EVAL_IMAGES / r[3]["evaluate"],
                    host_matching_and_ap_s=r[3]["host"],
                    host_share=r[3]["host"] / r[3]["evaluate"]) for r in runs],
         img_per_s=EVAL_IMAGES / walls[1],
         f32_card_vs_cpu=dict(images=EVAL_F32_IMAGES, card=list(f32["cuda"]),
                              cpu=list(f32["cpu"]), tuple_max_abs_err=tuple_err,
                              per_image=rows),
         threshold="f32 card vs CPU: per image and both ways, >= 98% of detections "
                   "have a same-class partner at IoU >= 0.9, partners' boxes within "
                   "0.05 px and scores within 5e-4; (mAP, mAP50, R, P) within 1e-4")
    for i, agree in enumerate(rows):
        check(min(agree["match"]) >= 0.98 and agree["max_box_err_px"] <= 0.05
              and agree["max_score_err"] <= 5e-4, f"f32 eval, image {i}: {agree}")
    check(tuple_err <= 1e-4, f"f32 eval tuples: card {f32['cuda']}, cpu {f32['cpu']}")


def _pixel_agreement(got, want) -> dict:
    """Share of equal uint8 values and mean |diff| of two image tensors."""
    diff = (got.cpu().int() - want.cpu().int()).abs().float()
    return dict(equal_share=float((diff == 0).float().mean()),
                mean_abs_diff=float(diff.mean()), max_abs_diff=float(diff.max()))


def _pixels_ok(agree: dict) -> bool:
    return agree["equal_share"] >= 0.999 and agree["mean_abs_diff"] < 0.01


def _smooth_image(rng, h: int, w: int) -> np.ndarray:
    """A seeded (h, w, 3) uint8 image with photo-like local correlation."""
    import cv2

    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), np.uint8)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)


def _peak_gb(fn) -> float:
    """GB the card allocates beyond what is live, over one call of fn()."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def _letterbox_phase(dev, smi):
    """Phase (k): the device letterbox, card against CPU (bit for bit) and
    against cv2 on staged images of mixed aspect ratios, the global TF32
    flag left as it was, then timed at (128, 960 -> 640) beside the bytes
    and operations of its two products and the time its TF32 products
    took."""
    import cv2
    import torch

    from tpu_yolo_torch.data.native_loader import fb_raw
    from tpu_yolo_torch.ops.letterbox import letterbox_batch

    flag = torch.backends.cuda.matmul.allow_tf32
    small = torch.randint(0, 256, (2, 96, 96, 3), dtype=torch.uint8, device=dev)
    small_hw = torch.tensor([[96.0, 80.0], [50.0, 96.0]], device=dev)
    flag_kept = []
    for value in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = value
        outs = letterbox_batch(small, small_hw, out_size=64)[0]
        torch.cuda.synchronize()
        flag_kept.append(torch.backends.cuda.matmul.allow_tf32 == value)
        if value:
            check(torch.equal(outs, off_out), "letterbox depends on the TF32 flag")
        off_out = outs
    torch.backends.cuda.matmul.allow_tf32 = flag
    check(all(flag_kept), f"the letterbox changed the global TF32 flag: {flag_kept}")

    rng = np.random.default_rng(SEED + 5)
    n = len(LETTERBOX_SIZES)
    staged = np.zeros((n, STAGE, STAGE, 3), np.uint8)
    dims = np.zeros((n, 4), np.float32)
    for i, (h, w) in enumerate(LETTERBOX_SIZES):
        fb_raw(STAGE)(_smooth_image(rng, h, w), staged[i], dims[i])
    hw = torch.from_numpy(np.maximum(dims[:, :2], 1.0))
    card, card_meta = letterbox_batch(torch.from_numpy(staged).to(dev), hw.to(dev),
                                      out_size=SIZE)
    cpu, cpu_meta = letterbox_batch(torch.from_numpy(staged), hw, out_size=SIZE)
    agree = _pixel_agreement(card, cpu)
    meta_err = float((card_meta.cpu() - cpu_meta).abs().max())
    oracle = []
    for i in range(n):
        sh, sw = int(dims[i, 0]), int(dims[i, 1])
        r = min(SIZE / sh, SIZE / sw)
        nw, nh = int(round(sw * r)), int(round(sh * r))
        ref = cv2.resize(staged[i, :sh, :sw], (nw, nh), interpolation=cv2.INTER_LINEAR)
        top, left = int(round((SIZE - nh) / 2 - 0.1)), int(round((SIZE - nw) / 2 - 0.1))
        diff = np.abs(card[i, top:top + nh, left:left + nw].cpu().numpy().astype(np.int16)
                      - ref.astype(np.int16))
        oracle.append(dict(original=list(LETTERBOX_SIZES[i]), staged=[sh, sw],
                           mean=float(diff.mean()), q99=float(np.quantile(diff, 0.99))))
    check(agree["equal_share"] == 1.0 and meta_err <= 1e-6,
          f"letterbox card vs CPU: {agree}, metas {meta_err}")
    check(all(o["mean"] < 1.5 and o["q99"] <= 6 for o in oracle),
          f"letterbox card vs cv2: {oracle}")

    # timed at the staged serving batch: sizes drawn per image
    b, s, st = BATCH, SIZE, STAGE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randint(0, 256, (b, st, st, 3), dtype=torch.uint8, device=dev, generator=gen)
    hw_big = torch.from_numpy(rng.integers(200, st + 1, (b, 2)).astype(np.float32)).to(dev)
    ms = cuda_ms(lambda: letterbox_batch(x, hw_big, out_size=s), iters=5, warmup=2)
    peak = _peak_gb(lambda: letterbox_batch(x, hw_big, out_size=s))
    flops = 2 * b * s * st * st * 3 + 2 * b * 3 * s * st * s
    product_bytes = 4 * (b * s * st + b * st * st * 3 + b * s * st * 3      # R_y, x, y
                         + b * 3 * s * st + b * s * st + b * 3 * s * s)    # y, R_x, out
    bound, bound_by = _bound(b * st * st * 3 + b * s * s * 3 + b * 8, flops,
                             PEAK_FLOPS["bfloat16"])
    emit("letterbox_check", nvidia_smi=smi, images=n, stage=STAGE, size=SIZE,
         card_vs_cpu=agree, metas_max_abs_err=meta_err, card_vs_cv2=oracle,
         global_tf32_flag_kept=flag_kept,
         products="bf16 operands, f32 result (aten::bmm.dtype)",
         threshold="card vs CPU: uint8 equal everywhere, metas within 1e-6, "
                   "the same output with the TF32 flag off and on; card vs cv2: "
                   "mean < 1.5, q99 <= 6",
         timed=dict(batch=b, shape=[b, st, st, 3], ms=ms, tf32_products_ms=TF32_LETTERBOX_MS,
                    products_tflop=flops / 1e12, products_f32_bytes_gb=product_bytes / 1e9,
                    tap_matrix_mb=b * s * st * 4 / 1e6, bound_ms=bound, bound_by=bound_by,
                    peak_memory_gb=peak))


_ARTIFACT_CHILD = r"""
import io, json, sys, time, zipfile

import numpy as np
import torch

from tpu_yolo_torch.core.config import get_model_config
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.ops import attention_cuda, nms_cuda
from tpu_yolo_torch.serve import Detector

mode, tmp, size, batches = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
imgs = np.load(tmp + "/images.npy")
params = torch.load(tmp + "/weights.pt")
out = {"mode": mode, "jax_imported": "jax" in sys.modules}
t0 = time.perf_counter()
torch.zeros(1, device="cuda").add_(1).cpu()      # CUDA context
out["cuda_init_s"] = time.perf_counter() - t0
if mode == "loaded":   # where a load's time goes: the program alone
    t0 = time.perf_counter()
    with zipfile.ZipFile(tmp + "/plain.pt2z") as z:
        torch.export.load(io.BytesIO(z.read("program.pt2"))).module()
    out["export_load_s"] = time.perf_counter() - t0


def zero():
    attention_cuda.fused_attention.launches = 0
    nms_cuda.greedy_keep.launches = 0


def counts():
    return {"attention": attention_cuda.fused_attention.launches,
            "nms": nms_cuda.greedy_keep.launches}


t0 = time.perf_counter()
if mode == "loaded":
    det = Detector.load_compiled(tmp + "/plain.pt2z", params)
else:
    det = Detector(YOLO.from_state_dict(get_model_config("n"), params),
                   input_size=size, device="cuda")
out["load_s"] = time.perf_counter() - t0
zero()
t0 = time.perf_counter()
res = {k: v.cpu().numpy() for k, v in det.detect_batch(imgs).items()}
out["first_batch_s"] = time.perf_counter() - t0
out["launches"] = counts()
t0 = time.perf_counter()
for _ in range(batches):
    det.detect_batch(imgs)
torch.cuda.synchronize()
out["img_per_s"] = len(imgs) * batches / (time.perf_counter() - t0)
np.savez(tmp + "/" + mode + "_plain.npz", **res)
if mode == "loaded":
    files = json.load(open(tmp + "/files.json"))
    staged = Detector.load_compiled(tmp + "/staged.pt2z", params)
    zero()
    t0 = time.perf_counter()
    got = list(staged.stream(files, batch_size=7))   # the artifact's batch wins
    out["staged_stream_s"] = time.perf_counter() - t0
    out["staged_launches"] = counts()
    out["staged_batch"] = staged._fixed_batch
    np.savez(tmp + "/loaded_staged.npz",
             **{f"{k}_{i}": r[k] for i, r in enumerate(got)
                for k in ("boxes", "scores", "classes")})
    with zipfile.ZipFile(tmp + "/plain.pt2z") as z:
        entries = {n: z.read(n) for n in z.namelist()}
    meta = json.loads(entries["meta.json"])
    meta["device_name"] = "NVIDIA B999"
    entries["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(tmp + "/other_env.pt2z", "w") as z:
        for n, data in entries.items():
            z.writestr(n, data)
    try:
        Detector.load_compiled(tmp + "/other_env.pt2z", params)
        out["environment_mismatch"] = "not raised"
    except RuntimeError as e:
        out["environment_mismatch"] = str(e)
out["jax_imported"] = out["jax_imported"] or "jax" in sys.modules
print(json.dumps(out))
"""


def _serve_artifact_phase(cfg, smi, state, imgs, launches):
    """Phase (o): the saved serving program. The plain program (phase e's
    images, bs128) and the staged one (phase m's JPEGs, stage 960) are
    saved, then loaded in a fresh process that imports only the package:
    their detections must equal the live Detector's bit for bit and both
    kernels' counters must advance there, and an artifact whose
    environment differs must raise. A second fresh process builds a live
    Detector, for the first batch's wall time and the rate beside the
    loaded one's."""
    import torch

    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.serve import Detector

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        files = _write_jpegs(os.path.join(tmp, "jpegs"), STAGED_FILES)
        with open(os.path.join(tmp, "files.json"), "w") as f:
            json.dump(files, f)
        np.save(os.path.join(tmp, "images.npy"), imgs)
        folded = YOLO.from_state_dict(cfg, state).fold_batchnorm().cpu().state_dict()
        torch.save(folded, os.path.join(tmp, "weights.pt"))

        live = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
        staged = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE,
                          device="cuda", device_letterbox=True, stage_size=STAGE)
        save_s = {}
        for key, det in (("plain", live), ("staged", staged)):
            t0 = time.perf_counter()
            det.save_compiled(os.path.join(tmp, f"{key}.pt2z"), batch_size=BATCH)
            save_s[key] = time.perf_counter() - t0
        want = {k: v.cpu().numpy() for k, v in live.detect_batch(imgs).items()}
        want_staged = list(staged.stream(files, batch_size=BATCH))
        # loaded and live in this process, alternated: the rate of each
        in_process = {"loaded": [], "live": []}
        loaded_here = Detector.load_compiled(os.path.join(tmp, "plain.pt2z"), folded)
        x = torch.from_numpy(imgs).cuda()
        for _ in range(3):
            for key, det in (("loaded", loaded_here), ("live", live)):
                det.detect_batch(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ARTIFACT_BATCHES):
                    det.detect_batch(x)
                torch.cuda.synchronize()
                in_process[key].append(BATCH * ARTIFACT_BATCHES
                                       / (time.perf_counter() - t0))
        del live, staged, loaded_here, x
        torch.cuda.empty_cache()

        children = {}
        for mode in ("loaded", "live"):
            proc = subprocess.run(
                [sys.executable, "-c", _ARTIFACT_CHILD, mode, tmp, str(SIZE),
                 str(ARTIFACT_BATCHES)], cwd=root, capture_output=True, text=True,
                timeout=600)
            check(proc.returncode == 0,
                  f"{mode} child: rc {proc.returncode}, {proc.stderr[-3000:]}")
            children[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
        loaded, fresh = children["loaded"], children["live"]
        got = np.load(os.path.join(tmp, "loaded_plain.npz"))
        fresh_res = np.load(os.path.join(tmp, "live_plain.npz"))
        plain_equal = all(np.array_equal(got[k], want[k]) for k in want)
        fresh_equal = all(np.array_equal(fresh_res[k], want[k]) for k in want)
        got_staged = np.load(os.path.join(tmp, "loaded_staged.npz"))
        staged_equal = all(
            np.array_equal(got_staged[f"{k}_{i}"], r[k])
            for i, r in enumerate(want_staged) for k in ("boxes", "scores", "classes"))
        sizes = {key: os.path.getsize(os.path.join(tmp, f"{key}.pt2z"))
                 for key in ("plain", "staged")}
    weights_bytes = sum(t.numel() * 2 for t in folded.values())   # bf16 in the program
    batches = STAGED_FILES // BATCH
    check(plain_equal, "loaded plain program vs live Detector: detections differ")
    check(staged_equal, "loaded staged program vs live Detector: detections differ")
    check(min(loaded["launches"].values()) > 0
          and min(loaded["staged_launches"].values()) >= batches,
          f"kernels not launched by the loaded programs: {loaded}")
    check("device_name" in loaded["environment_mismatch"],
          f"environment mismatch: {loaded['environment_mismatch']}")
    check(not loaded["jax_imported"] and not fresh["jax_imported"],
          "a child imported jax")
    check(loaded["staged_batch"] == BATCH and max(sizes.values()) < weights_bytes,
          f"artifact: batch {loaded['staged_batch']}, sizes {sizes}")
    emit("serve_artifact", nvidia_smi=smi, model="v11-n", size=SIZE, batch=BATCH,
         stage=STAGE, dtype="bfloat16", max_nms=1024,
         artifact_bytes=sizes, weights_bytes_bf16=weights_bytes,
         save_s=save_s, load_s=loaded["load_s"],
         cuda_init_s=dict(loaded=loaded["cuda_init_s"], fresh_live=fresh["cuda_init_s"]),
         export_load_s=loaded["export_load_s"],
         in_process_img_per_s=in_process,
         first_batch_s=dict(loaded=loaded["first_batch_s"],
                            fresh_live=fresh["first_batch_s"]),
         fresh_live_construct_s=fresh["load_s"],
         img_per_s=dict(loaded=loaded["img_per_s"], fresh_live=fresh["img_per_s"]),
         batches_timed=ARTIFACT_BATCHES,
         launches_first_batch=dict(loaded=loaded["launches"], fresh_live=fresh["launches"]),
         staged=dict(files=STAGED_FILES, launches=loaded["staged_launches"],
                     stream_s=loaded["staged_stream_s"], equal=staged_equal),
         plain_equal=plain_equal, fresh_live_equal=fresh_equal,
         environment_mismatch=loaded["environment_mismatch"],
         threshold="loaded vs live: detections bit-equal, plain on phase e's "
                   "images and staged on phase m's JPEGs; both kernels launched "
                   "in the loading process; a device-name mismatch raises")


def _s2d_stem_row(cfg, smi, state, imgs):
    """One timing row, no gate on time: the forward (forward_raw) at
    bs128, 640 px, bf16 with the space-to-depth stem beside the plain
    stem, and how far their raw maps are apart."""
    import torch

    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.serve import Detector

    plain = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
    s2d = Detector(YOLO.from_state_dict(cfg, state).fold_batchnorm()
                   .fold_stem_space_to_depth(), input_size=SIZE, device="cuda")
    x = (torch.from_numpy(imgs).cuda().to(torch.bfloat16) / 255)
    with torch.inference_mode():
        a, b = plain.model.forward_raw(x), s2d.model.forward_raw(x)
        diff = max(float((p.float() - q.float()).abs().max()) for p, q in zip(a, b))
        scale = max(float(p.float().abs().max()) for p in a)
        check(all(bool(torch.isfinite(q.float()).all()) for q in b),
              "non-finite s2d-stem forward")
        ms = {key: cuda_ms(lambda m=det.model: m.forward_raw(x), iters=10)
              for key, det in (("plain", plain), ("s2d", s2d))}
        ms["plain_again"] = cuda_ms(lambda: plain.model.forward_raw(x), iters=10)
    emit("s2d_stem", nvidia_smi=smi, model="v11-n", size=SIZE, batch=BATCH,
         dtype="bfloat16", forward_raw_ms=ms, s2d_over_plain=ms["s2d"] / ms["plain"],
         raw_max_abs_diff=diff, raw_max_abs=scale)


_INT8_CHILD = r"""
import json, sys, time

import numpy as np
import torch

from tpu_yolo_torch.ops import attention_cuda, nms_cuda
from tpu_yolo_torch.serve import Detector

tmp = sys.argv[1]
imgs = np.load(tmp + "/images.npy")
t0 = time.perf_counter()
det = Detector.load_compiled(tmp + "/int8.pt2z", torch.load(tmp + "/int8_weights.pt"))
out = {"load_s": time.perf_counter() - t0}
attention_cuda.fused_attention.launches = 0
nms_cuda.greedy_keep.launches = 0
res = {k: v.cpu().numpy() for k, v in det.detect_batch(imgs).items()}
out["launches"] = {"attention": attention_cuda.fused_attention.launches,
                   "nms": nms_cuda.greedy_keep.launches}
try:
    Detector.load_compiled(tmp + "/int8.pt2z", torch.load(tmp + "/float_weights.pt"))
    out["float_weights"] = "not refused"
except ValueError as e:
    out["float_weights"] = str(e)
np.savez(tmp + "/loaded_int8.npz", **res)
out["jax_imported"] = "jax" in sys.modules
print(json.dumps(out))
"""


def _int8_sums_check(model, x):
    """Runs model.forward_raw(x) with a hook on every int8 conv that
    computes its int32 sums on the card and in the CPU's exact form from
    the same quantized input; returns (convs, convs equal, values)."""
    import torch

    from tpu_yolo_torch.ops.nn import ConvBN, int8_conv2d

    seen = []

    def hook(m, args):
        xq = m.quantize_input(args[0])
        conv = (m.stride, m.padding, m.groups)
        card = int8_conv2d(xq, m.w_q, *conv).cpu()
        seen.append((torch.equal(card, int8_conv2d(xq.cpu(), m.w_q.cpu(), *conv)),
                     card.numel()))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, ConvBN) and m.quantized]
    try:
        with torch.inference_mode():
            model.forward_raw(x)
    finally:
        for h in hooks:
            h.remove()
    return len(seen), sum(ok for ok, _ in seen), sum(n for _, n in seen)


def _int8_f32_layers(card_model, cpu_model, x):
    """The f32 int8 forward on the card against the CPU, conv by conv, on
    the CPU images x (NHWC f32). Fed the CPU run's input, each int8 conv
    on the card against the CPU's output (the largest difference over the
    output's largest value): the sums are exact and the quantized inputs
    equal, so only the float work around them (the dequantize, SiLU) can
    differ. Then each device's own forward: the quantized inputs of every
    conv counted where they differ (an input a rounding apart at a .5
    boundary quantizes to the neighbouring integer)."""
    import torch

    from tpu_yolo_torch.ops.nn import ConvBN

    def run(model, xx, keep_io):
        io, xq = {}, {}

        def pre(name):
            def hook(m, args):
                xq[name] = m.quantize_input(args[0]).cpu()
                if keep_io:
                    io[name] = [args[0].cpu()]
            return hook

        def post(name):
            def hook(m, args, out):
                if keep_io:
                    io[name].append(out.cpu())
            return hook

        handles = []
        for name, m in model.named_modules():
            if isinstance(m, ConvBN):
                handles += [m.register_forward_pre_hook(pre(name)),
                            m.register_forward_hook(post(name))]
        try:
            with torch.inference_mode():
                model.forward_raw(xx)
        finally:
            for h in handles:
                h.remove()
        return io, xq

    io, xq_cpu = run(cpu_model, x, True)
    _, xq_card = run(card_model, x.cuda(), False)
    modules = dict(card_model.named_modules())
    worst = 0.0
    with torch.inference_mode():
        for name, (inp, out) in io.items():
            got = modules[name](inp.cuda()).cpu()
            worst = max(worst, float((got - out).abs().max() / out.abs().max()))
    differ = {name: int((xq_card[name] != q).sum()) for name, q in xq_cpu.items()}
    return dict(convs=len(io), teacher_forced_max_rel_err=worst,
                xq_values=sum(q.numel() for q in xq_cpu.values()),
                xq_differ=sum(differ.values()),
                convs_differing=sum(1 for d in differ.values() if d),
                first_conv_differing=next((n for n, d in differ.items() if d), None))


def _device_breakdown(fn, top: int = 8) -> dict:
    """Device time of one fn() call by kernel, from torch.profiler: the
    total and the `top` kernels with their calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return dict(device_ms=sum(r[1] for r in rows),
                kernels=[dict(name=n[:90], ms=ms, calls=c) for n, ms, c in rows[:top]])


def _int8_phase(cfg, smi, state, imgs, launches):
    """Phase (p): int8 W8A8 serving. The serving weights of phase e in a
    bf16 Detector, `Detector.quantize` on 16 seeded JPEGs; the int32 sums
    of every int8 conv on the card equal to the CPU's exact form (8
    images); both kernels counted in the int8 `detect_batch` at bs128;
    f32 int8 detections on the card against the CPU; the int8 program
    saved, loaded in a fresh process and bit-equal to the live Detector,
    float weights refused there; `detect --int8` on 8 JPEGs. Printed:
    int8 against bf16 agreement, img/s alternated (3 pairs, inputs on the
    card), forward ms, weight bytes, calibration seconds."""
    import torch

    from tpu_yolo_torch.io.checkpoint import save_checkpoint
    from tpu_yolo_torch.io.weights import to_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda
    from tpu_yolo_torch.ops.nn import ConvBN
    from tpu_yolo_torch.serve import Detector

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        files = _write_jpegs(os.path.join(tmp, "jpegs"), INT8_CALIB_FILES)
        bf16 = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
        int8 = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        int8.quantize(files)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        convs = [m for m in int8.model.modules() if isinstance(m, ConvBN)]
        check(all(m.quantized for m in convs), "a conv was left float by quantize")

        x = torch.from_numpy(imgs).cuda()
        n, equal, values = _int8_sums_check(
            int8.model, x[:INT8_SUMS_IMAGES].to(torch.bfloat16) / 255)
        check(n == len(convs) and equal == n,
              f"int8 sums card vs CPU: {equal} of {n} convs equal")

        int8.detect_batch(x)
        torch.cuda.synchronize()
        attention_cuda.fused_attention.launches = 0
        nms_cuda.greedy_keep.launches = 0
        res8 = int8.detect_batch(x)
        torch.cuda.synchronize()
        launches["int8_attention"] = attention_cuda.fused_attention.launches
        launches["int8_nms"] = nms_cuda.greedy_keep.launches
        check(launches["int8_attention"] > 0 and launches["int8_nms"] > 0,
              f"kernels in the int8 detect_batch: {launches}")
        counts = res8["count"].cpu()
        check(all(bool(torch.isfinite(v.float()).all()) for v in res8.values())
              and float((counts > 0).float().mean()) >= 0.9,
              f"int8 serving output: counts {counts.tolist()}")
        res16 = bf16.detect_batch(x)
        vs_bf16 = [_agreement(_row(res8, i), _row(res16, i)) for i in range(4)]

        rates = {"int8": [], "bf16": []}
        for _ in range(3):
            for key, det in (("int8", int8), ("bf16", bf16)):
                det.detect_batch(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ARTIFACT_BATCHES):
                    det.detect_batch(x)
                torch.cuda.synchronize()
                rates[key].append(BATCH * ARTIFACT_BATCHES / (time.perf_counter() - t0))
        xb = x.to(torch.bfloat16) / 255
        with torch.inference_mode():
            forward_ms = {key: cuda_ms(lambda m=det.model: m.forward_raw(xb), iters=10)
                          for key, det in (("int8", int8), ("bf16", bf16))}
            forward_ms["int8_again"] = cuda_ms(lambda: int8.model.forward_raw(xb), iters=10)
        weight_bytes = {key: sum(t.numel() * t.element_size()
                                 for t in det.model.state_dict().values())
                        for key, det in (("int8", int8), ("bf16", bf16))}
        del xb

        # f32 int8 detections, card (TF32 off) against the CPU, same
        # weights, and the same forward conv by conv
        qstate = {k: v.cpu() for k, v in int8.model.state_dict().items()}
        kw = dict(input_size=SIZE, compute_dtype=torch.float32, ranking="exact")
        on_card = Detector(YOLO.from_state_dict(cfg, qstate), device="cuda", **kw)
        on_cpu = Detector(YOLO.from_state_dict(cfg, qstate), device="cpu", **kw)
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            card = on_card.detect_batch(imgs[:2])
            layers = _int8_f32_layers(on_card.model, on_cpu.model,
                                      torch.from_numpy(imgs[:2]).float() / 255)
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        cpu = on_cpu.detect_batch(imgs[:2])
        f32_rows = [_agreement(_row(card, i), _row(cpu, i)) for i in range(2)]
        del on_card, on_cpu
        check(layers["teacher_forced_max_rel_err"] <= INT8_LAYER_TOL
              and layers["first_conv_differing"] != "net.p1.0",
              f"f32 int8 forward, card vs CPU conv by conv: {layers}")

        # where the int8 forward's time goes, by kernel
        with torch.inference_mode():
            breakdown = _device_breakdown(lambda: int8.model.forward_raw(
                x.to(torch.bfloat16) / 255))

        # the int8 program, saved and loaded in a fresh process
        t0 = time.perf_counter()
        int8.save_compiled(os.path.join(tmp, "int8.pt2z"), batch_size=BATCH)
        save_s = time.perf_counter() - t0
        np.save(os.path.join(tmp, "images.npy"), imgs)
        torch.save(qstate, os.path.join(tmp, "int8_weights.pt"))
        torch.save({k: v.cpu() for k, v in bf16.model.state_dict().items()},
                   os.path.join(tmp, "float_weights.pt"))
        want = {k: v.cpu().numpy() for k, v in res8.items()}
        del int8, bf16, x, res8, res16
        torch.cuda.empty_cache()
        proc = subprocess.run([sys.executable, "-c", _INT8_CHILD, tmp], cwd=root,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"int8 child: rc {proc.returncode}, {proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        got = np.load(os.path.join(tmp, "loaded_int8.npz"))
        loaded_equal = all(np.array_equal(got[k], want[k]) for k in want)
        artifact_bytes = os.path.getsize(os.path.join(tmp, "int8.pt2z"))

        # the detect entry point with --int8, in its own process
        ckpt = os.path.join(tmp, "serving.ckpt")
        save_checkpoint(ckpt, {"params": to_jax_params(state)})
        out_dir = os.path.join(tmp, "annotated")
        t0 = time.perf_counter()
        detect = subprocess.run(
            [sys.executable, "-m", "tpu_yolo_torch.detect", "--int8", "--weights", ckpt,
             "--batch-size", str(INT8_DETECT_FILES), "--out", out_dir,
             *files[:INT8_DETECT_FILES]], cwd=root, capture_output=True, text=True,
            timeout=600)
        detect_s = time.perf_counter() - t0
        check(detect.returncode == 0 and len(os.listdir(out_dir)) == INT8_DETECT_FILES,
              f"detect --int8: rc {detect.returncode}, {detect.stderr[-2000:]}")
    check(loaded_equal, "loaded int8 program vs live int8 Detector: detections differ")
    check(min(child["launches"].values()) > 0 and not child["jax_imported"],
          f"int8 child: {child}")
    check("int8 program" in child["float_weights"],
          f"float weights for the int8 program: {child['float_weights']}")
    emit("int8", nvidia_smi=smi, model="v11-n", size=SIZE, batch=BATCH, dtype="bfloat16",
         calib_files=INT8_CALIB_FILES, calibration_s=calib_s,
         sums_check=dict(images=INT8_SUMS_IMAGES, convs=n, convs_equal=equal,
                         int32_values=values),
         launches_per_batch=dict(attention=launches["int8_attention"],
                                 nms=launches["int8_nms"]),
         count_mean=float(counts.float().mean()), int8_vs_bf16=vs_bf16,
         img_per_s_alternated=rates, forward_raw_ms=forward_ms,
         int8_over_bf16_forward=forward_ms["int8"] / forward_ms["bf16"],
         weight_bytes=weight_bytes, forward_device_breakdown=breakdown,
         f32_card_vs_cpu=f32_rows, f32_conv_by_conv=layers,
         saved_program=dict(bytes=artifact_bytes, save_s=save_s, load_s=child["load_s"],
                            launches=child["launches"], equal=loaded_equal,
                            float_weights=child["float_weights"]),
         detect=dict(files=INT8_DETECT_FILES, seconds=detect_s,
                     lines=detect.stdout.strip().splitlines()[-1:]),
         threshold="sums card vs CPU equal for every int8 conv; f32 int8 card vs CPU: "
                   f"each conv fed the CPU's input within {INT8_LAYER_TOL} of its "
                   "largest output, the stem's quantized input equal, >= "
                   f"{INT8_F32_MATCH} of detections matched both ways (same class, "
                   "IoU >= 0.9); loaded program bit-equal to live")
    for agree in f32_rows:
        check(min(agree["match"]) >= INT8_F32_MATCH, f"f32 int8 card vs CPU: {agree}")


def _analytic_flops(model, x):
    """FLOPs of one eval forward from the port's own modules: 2·MACs of
    every conv from the shapes its hooks see, and the attention's two
    products from the shapes its wrapper is called with."""
    import torch

    from tpu_yolo_torch.ops import blocks
    from tpu_yolo_torch.ops.nn import ConvBN

    flops = []

    def conv_hook(m, args, out):
        w = m.w_q if m.quantized else m.w
        flops.append(2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3])

    attn_fn = blocks.fused_attention

    def attn_tap(q, k, v, scale):
        flops.append(2 * q.shape[0] * q.shape[1] * k.shape[1] * (q.shape[2] + v.shape[2]))
        return attn_fn(q, k, v, scale)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, ConvBN)]
    blocks.fused_attention = attn_tap
    try:
        with torch.inference_mode():
            model(x)
    finally:
        blocks.fused_attention = attn_fn
        for h in hooks:
            h.remove()
    return sum(flops) / x.shape[0]


def _profile_export_phase(cfg, smi, state, imgs, launches):
    """Phase (q): the profile and the export. profile_model at 640 on the
    card (bf16) against the port's analytic count; a trace around 3
    serving batches that names the attention and greedy-keep ops and
    kernels; one symbolic-batch export of the eval forward run at batches
    1, 8 and 128 against the live forward, the attention kernel counted;
    `--profile` through the CLI (phase r runs `--export both`)."""
    import re

    import torch

    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda
    from tpu_yolo_torch.serve import Detector
    from tpu_yolo_torch.utils.export import export_program, load_program
    from tpu_yolo_torch.utils.profiler import profile_model, trace

    model = YOLO.from_state_dict(cfg, state).fold_batchnorm().to(
        "cuda", memory_format=torch.channels_last)
    t0 = time.perf_counter()
    prof = profile_model(model, cfg, SIZE)
    profile_s = time.perf_counter() - t0
    analytic = _analytic_flops(model, torch.zeros((1, SIZE, SIZE, 3), device="cuda",
                                                  dtype=torch.bfloat16))
    check(prof["flops"] == analytic, f"profile_model {prof['flops']} vs analytic {analytic}")

    det = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
    x = torch.from_numpy(imgs).cuda()
    det.detect_batch(x)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(os.path.join(tmp, "tb")):
            for _ in range(3):
                det.detect_batch(x)
            torch.cuda.synchronize()
        with open(os.path.join(tmp, "tb", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(os.path.join(tmp, "tb", "trace.json"))
    names = {}
    for e in events:
        name = e.get("name", "")
        for key in TRACE_NAMES:
            if key in name:
                names.setdefault(key, set()).add((e.get("cat"), name))
    found = {key: sorted(f"{c}: {n}" for c, n in v) for key, v in names.items()}
    check(set(found) == set(TRACE_NAMES), f"names missing from the trace: {found}")
    del det

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        manifest = export_program(model, cfg, SIZE, os.path.join(tmp, "export"))
        export_s = time.perf_counter() - t0
        run = load_program(os.path.join(tmp, "export"))
        rows = []
        for b in EXPORT_BATCHES:
            xb = x[:b]
            attention_cuda.fused_attention.launches = 0
            got = run(model, xb)
            torch.cuda.synchronize()
            counted = attention_cuda.fused_attention.launches
            with torch.inference_mode():
                want = model(xb.to(torch.bfloat16) / 255)
            rows.append(dict(batch=b, shape=list(got.shape), equal=torch.equal(got, want),
                             max_abs_diff=float((got - want).abs().max()),
                             attention_launches=counted))
            check(rows[-1]["equal"] and counted > 0, f"exported program: {rows[-1]}")
        launches["export_attention"] = rows[-1]["attention_launches"]
        program_ms = cuda_ms(lambda: run(model, x), iters=5)
        with torch.inference_mode():
            live_ms = cuda_ms(lambda: model(x.to(torch.bfloat16) / 255), iters=5)

        # the CLI's --profile, in this process (a fresh one costs seconds)
        banner = _cli(["--profile"])
    gflops = re.search(r"GFLOPs .*: ([\d.]+)", "\n".join(banner))
    check(banner[:1] == [f"Number of parameters: {prof['params']}"] and gflops is not None
          and abs(float(gflops.group(1)) - prof["gflops"]) < 0.01,
          f"--profile banner {banner} vs profile_model {prof}")
    emit("profile_export", nvidia_smi=smi, model="v11-n", size=SIZE, dtype="bfloat16",
         params=prof["params"], flops=prof["flops"], gflops=prof["gflops"],
         bytes_accessed=prof["bytes_accessed"], analytic_flops=analytic,
         profile_s=profile_s, trace=dict(batches=3, bytes=trace_bytes, names=found),
         export=dict(seconds=export_s, bytes=manifest["bytes"], input=manifest["input"],
                     runs=rows, program_ms_bs128=program_ms, live_forward_ms_bs128=live_ms),
         cli=dict(profile=banner),
         threshold="FLOPs equal the analytic count; trace names both ops and "
                   "kernels; exported program bit-equal to the live forward at "
                   "every batch, attention counted")


def _onnx_phase(cfg, smi, state, imgs, launches):
    """Phase (r): the ONNX export of phase e's serving weights (v11-n, 640
    px, f32, symbolic batch) from a model on the card; the file parsed and
    interpreted on the host at batches 1 and 2 against the live f32
    forward on the card (TF32 off, as in phase f), the attention kernel
    counted there; then `--export both` through the CLI."""
    import torch

    from tpu_yolo_torch.io.checkpoint import save_checkpoint
    from tpu_yolo_torch.io.weights import to_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda
    from tpu_yolo_torch.ops.nms import batched_nms
    from tpu_yolo_torch.utils.onnx import export_onnx
    from tpu_yolo_torch.utils.onnx.interp import run_graph
    from tpu_yolo_torch.utils.onnx.parse import parse_model

    model = YOLO.from_state_dict(cfg, state).fold_batchnorm().to(
        "cuda", memory_format=torch.channels_last)
    x_u8 = imgs[:2]
    x_nchw = np.ascontiguousarray(x_u8.transpose(0, 3, 1, 2), np.float32) / np.float32(255)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.onnx")
        t0 = time.perf_counter()
        meta = export_onnx(model, cfg, SIZE, path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            graph, header = parse_model(f.read())
        parse_s = time.perf_counter() - t0
        ops = {}
        for n in graph.nodes:
            ops[n.op_type] = ops.get(n.op_type, 0) + 1
        check(header["opset"] == 17 and "Softmax" not in ops and "Cast" not in ops
              and meta["input"] == f"float32[batch,3,{SIZE},{SIZE}]",
              f"ONNX header {header}, meta {meta}, ops {ops}")

        rows, dets = [], {}
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for b in (1, 2):
                t0 = time.perf_counter()
                got = run_graph(graph, {"images": x_nchw[:b]})["output"]
                interp_s = time.perf_counter() - t0
                attention_cuda.fused_attention.launches = 0
                with torch.inference_mode():
                    live = model(torch.from_numpy(x_u8[:b]).cuda().float() / 255)
                torch.cuda.synchronize()
                counted = attention_cuda.fused_attention.launches
                live = live.cpu().numpy()
                box_err = np.abs(got[..., :4] - live[..., :4])
                score_err = np.abs(got[..., 4:] - live[..., 4:])
                rows.append(dict(
                    batch=b, shape=list(got.shape), interp_s=interp_s,
                    attention_launches=counted,
                    box_err_px=dict(max=float(box_err.max()),
                                    **{f"p{q}": float(np.percentile(box_err, q))
                                       for q in (50, 99, 99.9)},
                                    above_0_05=int((box_err > 0.05).sum())),
                    score_err=dict(max=float(score_err.max()),
                                   **{f"p{q}": float(np.percentile(score_err, q))
                                      for q in (50, 99, 99.9)},
                                   above_5e_4=int((score_err > 5e-4).sum()))))
                check(got.shape == live.shape and np.isfinite(got).all() and counted > 0,
                      f"ONNX file at batch {b}: {rows[-1]}")
                dets[b] = [batched_nms(torch.from_numpy(o)) for o in (got, live)]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        launches["onnx_attention"] = rows[-1]["attention_launches"]
        anchors_ok = all(r["box_err_px"]["max"] <= 0.05 and r["score_err"]["max"] <= 5e-4
                         for r in rows)
        # phase f's two-way criterion after NMS, per image
        after_nms = [dict(batch=b, image=i, **_agreement(_row(onnx, i), _row(live, i)))
                     for b, (onnx, live) in dets.items() for i in range(b)]
        nms_ok = all(min(a["match"]) >= 0.98 and a["max_box_err_px"] <= 0.05
                     and a["max_score_err"] <= 5e-4 for a in after_nms)
        check(anchors_ok or nms_ok, f"ONNX file vs the live f32 forward: {rows}, {after_nms}")

        # --export both through the CLI (in this process), from a
        # checkpoint of the same weights
        ckpt = os.path.join(tmp, "serving.ckpt")
        save_checkpoint(ckpt, {"params": to_jax_params(state)})
        t0 = time.perf_counter()
        cli_lines = _cli(["--export", "both", "--weights", ckpt, "--save-dir", tmp])
        cli_s = time.perf_counter() - t0
        out = os.path.join(tmp, "export_n")
        check(sorted(os.listdir(out)) == ["manifest.json", "model.onnx", "program.pt2"],
              f"--export both: {cli_lines}")
        with open(os.path.join(out, "model.onnx"), "rb") as f:
            cli_blob = f.read()
        with open(path, "rb") as f:
            same_bytes = cli_blob == f.read()
        cli_graph, _ = parse_model(cli_blob)
        check(len(cli_graph.nodes) == meta["nodes"], "--export both: another ONNX graph")
    emit("onnx", nvidia_smi=smi, model="v11-n", size=SIZE, dtype="float32",
         bytes=meta["bytes"], nodes=meta["nodes"], initializers=meta["initializers"],
         input=meta["input"], output=meta["output"], ops=ops, export_s=export_s,
         parse_s=parse_s, runs=rows, gate="anchors" if anchors_ok else "after_nms",
         after_nms=after_nms,
         cli=dict(export_both_s=cli_s, onnx_bytes_equal=same_bytes, lines=cli_lines),
         threshold="every anchor: boxes within 0.05 px, scores within 5e-4 of the live "
                   "f32 forward on the card (TF32 off); where the gap is larger, phase "
                   "f's criterion after NMS; attention counted in the live forward")


def _native_train_phase(cfg, smi, launches):
    """Phase (s): the trainer one epoch with --native-train auto and
    --tensorboard on phase n's seeded mini-COCO (v11-n, 640 px, batch 64,
    bf16): the loader it takes and why, the top-k kernel counted; without
    the native library --native-train on must raise its message, and where
    the library loads the native loader's img/s beside the host loader's."""
    import contextlib
    import io

    import torch

    from tpu_yolo_torch.core.config import load_hyperparams
    from tpu_yolo_torch.data import native_loader
    from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
    from tpu_yolo_torch.data.loader import DataLoader
    from tpu_yolo_torch.ops import topk_cuda
    from tpu_yolo_torch.seeded import write_mini_coco
    from tpu_yolo_torch.train import trainer

    available = native_loader.available()
    why = native_loader.why_unavailable()
    steps = DA_IMAGES // TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = write_mini_coco(os.path.join(tmp, "coco"), DA_IMAGES, hw=(480, 640),
                                   seed=SEED + 1)

        def args(mode, name):
            return argparse.Namespace(
                model_size="n", input_size=SIZE, batch_size=TRAIN_BATCH, epochs=1,
                data_dir=data_dir, save_dir=os.path.join(tmp, name), resume="",
                weights="", workers=8, gt_bucket=0, remat=False, remat_level="stage",
                tensorboard=True, val_batch_size=EVAL_BATCH, native_eval="auto",
                max_nms=2048, device_augment=False, native_train=mode, seed=SEED)

        out = io.StringIO()
        topk_cuda.topk_mask.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            state = trainer.train(args("auto", "auto"), load_hyperparams(), cfg,
                                  device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        topk = topk_cuda.topk_mask.launches
        lines = out.getvalue().strip().splitlines()
        print("\n".join(lines), flush=True)
        loader_line = [ln for ln in lines if ln.startswith("[train] loader: ")]
        want = ("[train] loader: native" if available
                else "[train] loader: host (--native-train auto: ")
        check(state.step == steps and topk == steps and len(loader_line) == 1
              and loader_line[0].startswith(want),
              f"--native-train auto: {state.step} steps, {topk} top-k launches, {lines}")
        launches["native_train_topk"] = topk
        del state

        tb_dir = os.path.join(tmp, "auto", "tb")
        tb_lines = [ln for ln in lines if ln.startswith("tensorboard disabled: ")]
        tensorboard = dict(disabled=tb_lines[0] if tb_lines else None)
        if not tb_lines:
            from tensorboard.backend.event_processing.event_accumulator import (
                EventAccumulator)

            events = [f for f in os.listdir(tb_dir) if f.startswith("events.")]
            acc = EventAccumulator(tb_dir)
            acc.Reload()
            tags = sorted(acc.Tags()["scalars"])
            tensorboard.update(event_files=events, scalars={
                t: [[e.step, e.value] for e in acc.Scalars(t)] for t in tags})
            check(len(events) == 1 and {"loss/box", "loss/cls", "loss/dfl", "val/mAP"}
                  <= set(tags), f"--tensorboard: {tensorboard}")

        refusal, rates = None, None
        if not available:
            try:
                trainer.train(args("on", "on"), load_hyperparams(), cfg, device="cuda")
            except RuntimeError as e:
                refusal = str(e)
            check(refusal is not None and refusal.startswith(
                "--native-train on requires native/libtpuyolo_data.so"),
                f"--native-train on without the library: {refusal}")
        else:
            from tpu_yolo_torch.data.native_train import NativeTrainLoader

            files = split_files(data_dir, "train2017")
            cache = os.path.join(data_dir, "train2017.cache.npy")
            hyp = load_hyperparams()
            loaders = {
                "native": NativeTrainLoader(files, SIZE, hyp, TRAIN_BATCH,
                                            cache_path=cache, threads=8, seed=SEED),
                "host": DataLoader(DetectionDataset(files, SIZE, hyp, augment=True,
                                                    cache_path=cache), TRAIN_BATCH,
                                   shuffle=True, num_workers=8, drop_last=True)}
            rates = {}
            for name, loader in loaders.items():
                t0 = time.perf_counter()
                n = TRAIN_BATCH * sum(1 for _ in loader)
                rates[name] = n / (time.perf_counter() - t0)
    emit("native_train", nvidia_smi=smi, model="v11-n", size=SIZE, batch=TRAIN_BATCH,
         dtype="bfloat16", images=DA_IMAGES, native_available=available,
         unavailable_because=why, loader_line=loader_line[0], topk_launches=topk,
         train_s=train_s, epoch=[ln for ln in lines if ln.startswith("epoch ")][-1],
         native_on_refusal=refusal, loader_alone_img_per_s=rates,
         tensorboard=tensorboard)


def _augment_params(mode: str, b: int, hyp: dict, dims, seed: int, general=False):
    """Host draws for `b` samples of one mode over sources of the given
    staged dims: (source indices, hw rows, stacked params)."""
    import random

    from tpu_yolo_torch.data import device_augment as da

    n = len(dims)
    rng, np_rng = random.Random(seed), np.random.default_rng(seed)
    no_labels = np.zeros((0, 5), np.float32)
    outs, idx = [], []
    for k in range(b):
        if mode == "mosaic":
            d = da.draw_mosaic(rng, np_rng, k % n, n, hyp, SIZE)
            outs.append(da.assemble_mosaic(d, lambda i: dims[i], lambda i: no_labels,
                                           SIZE, general=general))
            idx.append(d["indices"])
        elif mode == "mixup":
            d1, d2, alpha = da.draw_mixup_pair(rng, np_rng, k % n, n, hyp, SIZE)
            outs.append(da.assemble_mixup(d1, d2, alpha, lambda i: dims[i],
                                          lambda i: no_labels, SIZE, general=general))
            idx.append([d1["indices"], d2["indices"]])
        else:
            d = da.draw_plain(rng, np_rng, hyp, SIZE)
            outs.append(da.assemble_plain(d, dims[k % n], no_labels, SIZE,
                                          general=general))
            idx.append(k % n)
    params = da.DeviceAugmentLoader._stack_params([o[0] for o in outs])
    hw = np.asarray([dims[k % n] for k in range(b)], np.float32)
    return np.asarray(idx), hw, params


def _tensors(tree, device):
    import torch

    return {k: (_tensors(v, device) if isinstance(v, dict)
                else torch.as_tensor(np.asarray(v)).to(device)) for k, v in tree.items()}


def _augment_phase(dev, smi):
    """Phase (l): the seven augmentation programs and the HSV jitter,
    card against CPU at B=4, St=S=640; then augment_batch,
    mixup_augment_batch and plain_augment_batch timed at B=64 with their
    peak memory."""
    import torch

    from tpu_yolo_torch.core.config import load_hyperparams
    from tpu_yolo_torch.ops import augment_device as ad

    hyp = load_hyperparams()
    general_hyp = dict(hyp, degrees=10.0, shear=4.0)
    rng = np.random.default_rng(SEED + 6)
    # staged dims of the scaled contract (long side == SIZE)
    dims = [(h * SIZE // 640, w * SIZE // 640) for h, w in
            ((640, 480), (360, 640), (640, 640), (300, 640), (640, 213), (512, 640))]
    sources = np.zeros((len(dims), SIZE, SIZE, 3), np.uint8)
    for i, (h, w) in enumerate(dims):
        sources[i, :h, :w] = _smooth_image(rng, h, w)
    rows = []
    for name, mode, general in (
            ("augment_batch", "mosaic", False), ("mixup_augment_batch", "mixup", False),
            ("plain_augment_batch", "plain", False),
            ("augment_batch_general", "mosaic", True),
            ("mixup_augment_batch_general", "mixup", True),
            ("plain_augment_batch_general", "plain", True)):
        idx, hw, params = _augment_params(mode, AUG_CHECK_BATCH,
                                          general_hyp if general else hyp, dims,
                                          SEED + len(rows), general)
        srcs = torch.from_numpy(sources[idx])
        extra = (torch.from_numpy(hw),) if mode == "plain" else ()
        outs = [getattr(ad, name)(srcs.to(d), *(t.to(d) for t in extra),
                                  _tensors(params, d), out_size=SIZE)
                for d in (dev, torch.device("cpu"))]
        rows.append(dict(program=name, **_pixel_agreement(*outs)))
    img = torch.from_numpy(sources[:2].astype(np.float32))
    gains = torch.tensor([[1.01, 0.8, 1.2], [0.99, 1.3, 0.7]])
    hsv = [ad.hsv_jitter_device(img.to(d), gains.to(d)).clamp(0, 255).to(torch.uint8)
           for d in (dev, torch.device("cpu"))]
    rows.append(dict(program="hsv_jitter_device", **_pixel_agreement(*hsv)))
    for row in rows:
        check(_pixels_ok(row), f"augmentation program card vs CPU: {row}")

    # timed at the training batch, on seeded sources staged on the card
    b, s = TRAIN_BATCH, SIZE
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    timed = []
    for name, mode in (("augment_batch", "mosaic"), ("mixup_augment_batch", "mixup"),
                       ("plain_augment_batch", "plain")):
        _, hw, params = _augment_params(mode, b, hyp, dims, SEED)
        shape = {"mosaic": (b, 4), "mixup": (b, 2, 4), "plain": (b,)}[mode]
        srcs = torch.randint(0, 256, (*shape, s, s, 3), dtype=torch.uint8, device=dev,
                             generator=gen)
        extra = (torch.from_numpy(hw).to(dev),) if mode == "plain" else ()
        p = _tensors(params, dev)

        def run(name=name, srcs=srcs, extra=extra, p=p):
            return getattr(ad, name)(srcs, *extra, p, out_size=s)

        resamples = {"mosaic": 4, "mixup": 8, "plain": 2}[mode]   # per image
        flops = resamples * b * (2 * s * s * s * 3 + 2 * 3 * s * s * s)
        timed.append(dict(program=name, batch=b, source_shape=list(srcs.shape),
                          ms=cuda_ms(run, iters=3, warmup=1), peak_memory_gb=_peak_gb(run),
                          products_tflop=flops / 1e12))
    emit("augment_check", nvidia_smi=smi, size=SIZE, check_batch=AUG_CHECK_BATCH,
         card_vs_cpu=rows, threshold=f"card vs CPU: {PIXEL_GATE}", timed=timed)


def _write_jpegs(root: str, n: int) -> list[str]:
    """n seeded JPEGs of 480x640, 640x480 and 1080x1920 in turn."""
    import cv2

    rng = np.random.default_rng(SEED + 7)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        h, w = ((480, 640), (640, 480), (1080, 1920))[i % 3]
        paths.append(os.path.join(root, f"im{i:04d}.jpg"))
        cv2.imwrite(paths[-1], _smooth_image(rng, h, w))
    return paths


def _serve_staged_phase(cfg, smi, state, launches):
    """Phase (m): Detector(device_letterbox=True).stream at batch 128,
    bf16, K=1024 beside the host-letterbox stream on the same JPEGs, both
    kernels counted on the staged path; an f32 check of 2 images through
    the staged path, card against CPU; one run of
    `python -m tpu_yolo_torch.detect --device-letterbox`."""
    import torch

    from tpu_yolo_torch.io.checkpoint import save_checkpoint
    from tpu_yolo_torch.io.weights import to_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda
    from tpu_yolo_torch.serve import Detector

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = _write_jpegs(os.path.join(tmp, "jpegs"), STAGED_FILES)
        write_s = time.perf_counter() - t0
        staged = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE,
                          device="cuda", device_letterbox=True, stage_size=STAGE)
        host = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
        for det in (staged, host):            # warm both paths
            list(det.stream(files, batch_size=BATCH))

        def timed(det):
            t0 = time.perf_counter()
            out = list(det.stream(files * 2, batch_size=BATCH))
            return len(out) / (time.perf_counter() - t0), out

        attention_cuda.fused_attention.launches = 0
        nms_cuda.greedy_keep.launches = 0
        rate, out = timed(staged)
        launches["staged_attention"] = attention_cuda.fused_attention.launches
        launches["staged_nms"] = nms_cuda.greedy_keep.launches
        batches = 2 * STAGED_FILES // BATCH
        check(launches["staged_nms"] == batches and launches["staged_attention"] >= batches,
              f"kernel launches on the staged path: {launches}, {batches} batches")
        counts = [len(r["boxes"]) for r in out]
        check(all("error" not in r for r in out) and np.mean([c > 0 for c in counts]) >= 0.9,
              f"staged serving results: {counts}")
        rates = {"staged": [rate], "host_letterbox": []}
        for det, key in ((host, "host_letterbox"), (staged, "staged"),
                         (host, "host_letterbox")):
            rates[key].append(timed(det)[0])
        # the host's decode alone, into the same kind of buffer, per path
        decode = {}
        for key, size, run in (
                ("staged_raw", STAGE, staged._decode_batch_raw),
                ("host_letterbox", SIZE, host._decode_batch)):
            buf = np.zeros((BATCH, size, size, 3), np.uint8)
            t0 = time.perf_counter()
            for lo in range(0, STAGED_FILES, BATCH):
                run(files[lo:lo + BATCH], buf[:len(files[lo:lo + BATCH])])
            decode[key] = STAGED_FILES / (time.perf_counter() - t0)
        # the H2D copy of one pinned batch per path
        h2d_ms = {}
        for key, size in (("staged_raw", STAGE), ("host_letterbox", SIZE)):
            buf = torch.zeros((BATCH, size, size, 3), dtype=torch.uint8, pin_memory=True)
            h2d_ms[key] = cuda_ms(lambda buf=buf: buf.to("cuda", non_blocking=True),
                                  iters=5)

        # f32 on the card (TF32 off) against the CPU, through the staged path
        two = [files[0], files[2]]
        kw = dict(input_size=SIZE, compute_dtype=torch.float32, ranking="exact",
                  device_letterbox=True, stage_size=STAGE)
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            card = list(Detector(YOLO.from_state_dict(cfg, state), device="cuda", **kw)
                        .stream(two, batch_size=2, rescale=False))
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
        cpu = list(Detector(YOLO.from_state_dict(cfg, state), device="cpu", **kw)
                   .stream(two, batch_size=2, rescale=False))
        f32_rows = [_agreement(_one(a), _one(b)) for a, b in zip(card, cpu)]
        for agree in f32_rows:
            check(min(agree["match"]) >= 0.98 and agree["max_box_err_px"] <= 0.05
                  and agree["max_score_err"] <= 5e-4, f"f32 staged agreement: {agree}")

        # the detect entry point on a few files, in its own process
        ckpt = os.path.join(tmp, "serving.ckpt")
        save_checkpoint(ckpt, {"params": to_jax_params(state)})
        out_dir = os.path.join(tmp, "annotated")
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_yolo_torch.detect", "--device-letterbox",
             "--weights", ckpt, "--out", out_dir, *files[:3]],
            capture_output=True, text=True, timeout=600)
        detect_lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0 and len(os.listdir(out_dir)) == 3,
              f"detect --device-letterbox: rc {proc.returncode}, {proc.stderr[-2000:]}")
    emit("serve_staged", nvidia_smi=smi, model="v11-n", size=SIZE, batch=BATCH,
         stage=STAGE, dtype="bfloat16", max_nms=1024, files=STAGED_FILES,
         images_per_pass=2 * STAGED_FILES, write_jpegs_seconds=write_s,
         stager=staged.stager, launches_per_pass=dict(
             attention=launches["staged_attention"], nms=launches["staged_nms"]),
         img_per_s=rates, decode_alone_img_per_s=decode, h2d_ms_per_batch=h2d_ms,
         count_mean=float(np.mean(counts)),
         f32_card_vs_cpu=f32_rows, detect=detect_lines[-2:],
         threshold="f32 staged, card vs CPU: per image and both ways, >= 98% of "
                   "detections matched, boxes within 0.05 px, scores within 5e-4")


def _train_device_augment_phase(cfg, smi, launches):
    """Phase (n): trainer.train on a seeded mini-COCO, v11-n, 640 px,
    batch 64, bf16, 2 epochs each: the host loader, --device-augment
    (mosaic), --device-augment with mosaic=0 (the plain program); the
    top-k kernel counted in each; then the loaders alone."""
    import contextlib
    import io
    import re

    import torch

    from tpu_yolo_torch.core.config import load_hyperparams
    from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
    from tpu_yolo_torch.data.device_augment import DeviceAugmentLoader
    from tpu_yolo_torch.data.loader import DataLoader
    from tpu_yolo_torch.ops import topk_cuda
    from tpu_yolo_torch.seeded import write_mini_coco
    from tpu_yolo_torch.train import trainer

    epochs, steps = 2, DA_IMAGES // TRAIN_BATCH
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data_dir = write_mini_coco(os.path.join(tmp, "coco"), DA_IMAGES, hw=(480, 640),
                                   seed=SEED + 1)
        write_s = time.perf_counter() - t0
        for name, device_augment, mosaic in (("host_loader", False, 1.0),
                                             ("device_mosaic", True, 1.0),
                                             ("device_plain", True, 0.0)):
            hyp = dict(load_hyperparams(), mosaic=mosaic)
            args = argparse.Namespace(
                model_size="n", input_size=SIZE, batch_size=TRAIN_BATCH, epochs=epochs,
                data_dir=data_dir, save_dir=os.path.join(tmp, name), resume="",
                weights="", workers=8, gt_bucket=0, remat=False, remat_level="stage",
                tensorboard=False, val_batch_size=EVAL_BATCH, native_eval="auto",
                max_nms=2048, device_augment=device_augment, seed=SEED)
            out = io.StringIO()
            topk_cuda.topk_mask.launches = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stdout(out):
                state = trainer.train(args, hyp, cfg, device="cuda")
            torch.cuda.synchronize()
            topk = topk_cuda.topk_mask.launches
            lines = out.getvalue().strip().splitlines()
            print("\n".join(lines), flush=True)
            epoch_rates = [float(m.group(1)) for m in
                           (re.search(r"s, ([\d.]+) img/s\)", ln) for ln in lines) if m]
            check(state.step == epochs * steps and topk == epochs * steps
                  and len(epoch_rates) == epochs,
                  f"{name}: {state.step} steps, {topk} top-k launches, {lines}")
            stager = [ln for ln in lines if ln.startswith("[train] device augment")]
            runs[name] = dict(epoch_img_per_s=epoch_rates, topk_launches=topk,
                              peak_memory_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                              stager=stager[0] if stager else None,
                              last_epoch=[ln for ln in lines if ln.startswith("epoch ")][-1])
            del state
        launches["augment_topk"] = runs["device_mosaic"]["topk_launches"]

        # the loaders alone: one epoch each, nothing on the device
        files = split_files(data_dir, "train2017")
        cache = os.path.join(data_dir, "train2017.cache.npy")
        loaders = {}
        for name, mosaic in (("device_mosaic", 1.0), ("device_plain", 0.0)):
            loaders[name] = DeviceAugmentLoader(
                files, SIZE, dict(load_hyperparams(), mosaic=mosaic), TRAIN_BATCH,
                cache_path=cache, threads=8, seed=SEED, pin_memory=True)
        loaders["host_loader"] = DataLoader(
            DetectionDataset(files, SIZE, load_hyperparams(), augment=True,
                             cache_path=cache), TRAIN_BATCH, shuffle=True,
            num_workers=8, drop_last=True)
        loader_rates = {}
        for name, loader in loaders.items():
            t0 = time.perf_counter()
            n = TRAIN_BATCH * sum(1 for _ in loader)
            loader_rates[name] = n / (time.perf_counter() - t0)
    emit("train_device_augment", nvidia_smi=smi, model="v11-n", size=SIZE,
         batch=TRAIN_BATCH, dtype="bfloat16", images=DA_IMAGES, epochs=epochs,
         write_images_seconds=write_s, runs=runs, loader_alone_img_per_s=loader_rates,
         stager=loaders["device_mosaic"].stager)


def _kernel_rows(captured, launches):
    import torch

    from tpu_yolo_torch.ops import attention_cuda, nms_cuda, topk_cuda

    q, k, v, scale = captured["attention"]
    got = attention_cuda.fused_attention(q, k, v, scale)
    want = attention_cuda.attention_plain(q, k, v, scale)
    attn_err = float((got.float() - want.float()).abs().max())
    tol = ATTN_TOL[str(q.dtype).split(".")[1]]
    check(bool(((got.float() - want.float()).abs()
                <= tol + tol * want.float().abs()).all()),
          "attention kernel vs plain at the main-path inputs")
    kernels = [dict(
        name="psa_attention", route="cuda", op="tpu_yolo_torch::psa_attention",
        source="tpu_yolo_torch/csrc/attention.cu",
        replaces="tpu_yolo/ops/attention_pallas.py:66",
        launches=launches["attention"], max_abs_err=attn_err,
        staged_serving_launches=launches["staged_attention"],
        int8_serving_launches=launches["int8_attention"],
        export_launches=launches["export_attention"],
        onnx_live_forward_launches=launches["onnx_attention"],
        **_attention_times(q, k, v, scale))]

    # at eval's inputs (val batch 32: K/V streamed), counted in run_test
    q2, k2, v2, scale2 = captured["eval_attention"]
    want = attention_cuda.attention_plain(q2, k2, v2, scale2).float()
    err = (attention_cuda.fused_attention(q2, k2, v2, scale2).float() - want).abs()
    check(bool((err <= tol + tol * want.abs()).all()) and q2.dtype == q.dtype,
          "attention kernel vs plain at eval's inputs")
    kernels[0]["eval_shape"] = dict(launches=launches["eval_attention"],
                                    max_abs_err=float(err.max()),
                                    **_attention_times(q2, k2, v2, scale2))

    # the same kernel at the 1280 px shape, K/V streamed (not on the main path)
    gen = torch.Generator(device=q.device).manual_seed(SEED)
    q2, k2 = (torch.randn(16, 1600, 32, device=q.device, generator=gen).to(q.dtype)
              for _ in range(2))
    v2 = torch.randn(16, 1600, 64, device=q.device, generator=gen).to(q.dtype)
    kernels[0]["second_shape"] = _attention_times(q2, k2, v2, scale)

    kernels.append(dict(
        name="nms_greedy_keep", route="cuda", op="tpu_yolo_torch::nms_greedy_keep",
        source="tpu_yolo_torch/csrc/nms_keep.cu",
        replaces="tpu_yolo/ops/nms_pallas.py:145",
        launches=launches["nms"], staged_serving_launches=launches["staged_nms"],
        int8_serving_launches=launches["int8_nms"],
        **_keep_times(*captured["nms"]),
        eval_shape=dict(launches=launches["eval_nms"],
                        **_keep_times(*captured["eval_nms"]))))

    x = captured["topk"]
    got = topk_cuda.topk_mask(x, TOP_K)
    want = topk_cuda.topk_mask_plain(x, TOP_K)
    check(torch.equal(got, want), "top-k kernel vs plain at the main-path inputs")
    bound, bound_by = topk_cost(x)

    def library():  # tie order not promised: a yardstick of speed only
        idx = torch.topk(x, TOP_K, dim=-1).indices
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device).scatter_(
            -1, idx, True)

    kernels.append(dict(
        name="assigner_topk_mask", route="cuda", op="tpu_yolo_torch::topk_mask",
        source="tpu_yolo_torch/csrc/topk_mask.cu",
        replaces="tpu_yolo/ops/topk_pallas.py:78",
        shape=dict(b=x.shape[0], n=x.shape[1], a=x.shape[2], k=TOP_K,
                   nonzero=int((x > 0).sum()), selected=int(got.sum())),
        launches=launches["topk"], device_augment_launches=launches["augment_topk"],
        native_train_launches=launches["native_train_topk"],
        max_abs_err=float((got.int() - want.int()).abs().max()),
        ms=cuda_ms(lambda: topk_cuda.topk_mask(x, TOP_K), graph=True),
        ms_with_launch=cuda_ms(lambda: topk_cuda.topk_mask(x, TOP_K)),
        plain_ms=cuda_ms(lambda: topk_cuda.topk_mask_plain(x, TOP_K), iters=5),
        bound_ms=bound, bound_by=bound_by,
        library_ms=cuda_ms(library, iters=5, graph=True)))
    return kernels


def _keep_times(boxes, cls, valid, thr):
    """The greedy keep at these inputs: bit-equal to its plain version
    (checked), its shape with the valid and kept counts, times and bound.
    `ms` is of launches replayed from a CUDA graph."""
    import torch

    from tpu_yolo_torch.ops import nms_cuda

    got = nms_cuda.greedy_keep(boxes, cls, valid, thr)
    want = nms_cuda.greedy_keep_plain(boxes, cls, valid, thr)
    check(torch.equal(got, want),
          f"NMS kernel vs plain at the captured inputs {tuple(boxes.shape)}")
    bound, bound_by = nms_cost(boxes, cls, valid)
    ms = cuda_ms(lambda: nms_cuda.greedy_keep(boxes, cls, valid, thr), graph=True)
    return dict(
        shape=dict(b=boxes.shape[0], k=boxes.shape[1],
                   valid=int(valid.sum()), kept=int(got.sum())),
        max_abs_err=float((got.int() - want.int()).abs().max()),
        ms=ms, ms_with_launch=cuda_ms(
            lambda: nms_cuda.greedy_keep(boxes, cls, valid, thr)),
        plain_ms=cuda_ms(lambda: nms_cuda.greedy_keep_plain(boxes, cls, valid, thr),
                         iters=5),
        bound_ms=bound, bound_by=bound_by, ms_over_bound=ms / bound,
        library_ms=None)


def _attention_times(q, k, v, scale):
    """The attention kernel's shape, form, times and bound on q, k, v. `ms`
    and `library_ms` are of launches replayed from a CUDA graph;
    `ms_with_launch` is of eager calls, which the host's launch time bounds."""
    import torch.nn.functional as F

    from tpu_yolo_torch.ops import attention_cuda

    dtype = str(q.dtype).split(".")[1]
    bound, bound_by = attention_cost(q, v, dtype)
    q4, k4, v4 = (t[None] for t in (q, k, v))
    ms = cuda_ms(lambda: attention_cuda.fused_attention(q, k, v, scale), graph=True)
    library = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale),
                      graph=True)
    return dict(
        shape=dict(bh=q.shape[0], t=q.shape[1], dk=q.shape[2], dh=v.shape[2],
                   dtype=str(q.dtype),
                   form=attention_cuda.kernel_form(q.shape[0], q.shape[1], q.dtype)),
        ms=ms, ms_with_launch=cuda_ms(
            lambda: attention_cuda.fused_attention(q, k, v, scale)),
        plain_ms=cuda_ms(lambda: attention_cuda.attention_plain(q, k, v, scale)),
        bound_ms=bound, bound_by=bound_by, library_ms=library,
        ms_over_bound=ms / bound, ms_over_library=ms / library)


def _row(res, i):
    """(boxes, scores, classes) of image i of a batched result, on the CPU."""
    n = int(res["count"][i])
    return tuple(res[k][i, :n].cpu() for k in ("boxes", "scores", "classes"))


def _one(result):
    """(boxes, scores, classes) of a detect_one result."""
    import torch

    return tuple(torch.from_numpy(result[k]) for k in ("boxes", "scores", "classes"))


def _head(dets, n: int):
    """The n top-scoring detections of a score-ordered list."""
    return tuple(t[:n] for t in dets)


def _agreement(a, b, iou: float = 0.9) -> dict:
    """How far two detection lists agree: their counts, whether their
    classes are equal in order, the share of each one's detections with a
    same-class partner at IoU >= iou in the other, and the largest box
    and score differences between partners."""
    from tpu_yolo_torch.ops.boxes import box_iou_pairwise

    def one_way(x, y):
        (bx, sx, cx), (by, sy, cy) = x, y
        if len(bx) == 0 or len(by) == 0:
            return float(len(bx) == len(by)), 0.0, 0.0
        overlap = box_iou_pairwise(bx, by) * (cx[:, None] == cy[None, :])
        best, j = overlap.max(1)
        hit = best >= iou
        if not bool(hit.any()):
            return 0.0, 0.0, 0.0
        return (float(hit.float().mean()),
                float((bx[hit] - by[j[hit]]).abs().max()),
                float((sx[hit] - sy[j[hit]]).abs().max()))

    ab, ba = one_way(a, b), one_way(b, a)
    return dict(count=[len(a[0]), len(b[0])],
                same_classes_in_order=len(a[2]) == len(b[2])
                and bool((a[2] == b[2]).all()),
                match=[ab[0], ba[0]], max_box_err_px=max(ab[1], ba[1]),
                max_score_err=max(ab[2], ba[2]))


def _p50_ms(fn, warmup: int = 10, iters: int = 50) -> float:
    """Median wall milliseconds of fn(), which ends in a host copy."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


if __name__ == "__main__":
    sys.exit(main())
