#!/usr/bin/env python3
"""Smoke run of tpu_yolo_torch on one CUDA card (written for the H100).

    python3 chip_smoke.py

Builds the port's CUDA sources from tpu_yolo_torch/csrc (the three
kernels of the TPU's and the card's image kernels, one nvcc each, in
parallel), holds each kernel against its plain PyTorch version, serves YOLOv11-n at 640 px through
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
(nvjpeg), the top-k kernel counted, the event file's scalars or the
message that disabled it. Then the port's own data path on the card
(phase w): JPEGs decoded by nvJPEG and placed by the image kernels through
staged and host-letterbox serving, `run_test` with `--native-eval auto`
and a device-augment epoch, each image kernel counted there and held
against its plain version; the decode held against cv2's within a bound
that each control exceeds; the staged detections against the cv2
stager's beside a witness; mAP against the Python loader's; every rate
beside the cv2 form's. Then data parallelism (phase t); tensor and
spatial parallelism (phase u): two gloo ranks sharing the card train v11-n with its wide convs split over a
model axis, then run the forward of 1280 px images split by height,
each held against one process with no group and against witnesses that
repeat the ranks' split arithmetic in one process. Then what the JAX
package's meshes take beyond that (phase v): 1312 px images, whose p5
rows split unevenly over two ranks, in f32 and bf16; the s2d stem under
the same mesh; phase p's int8 weights over the spatial axis and split
over a model axis, their detections equal to one process's; the
attention kernel at the gathered map's 1681 tokens. Then every model size
(phase x): n, t, s, m, l and x each serve batches of 128 through
`Detector`, both kernels counted and held against their plain versions at
each size's inputs, the forward's time beside its roofline bound and its
device time by stage (tpu_yolo_torch/roofline.py); v11-x's f32 path card
against CPU beside an f64 witness; v11-x evaluates through `run_test` (the
attention kernel in its resident form at (192, 400)) and the parity
harness (tpu_yolo_torch/parity_check.py), trains one epoch through
`trainer.train`, times `train_step` at the largest batch each remat level
fits on the card, and holds an f32 step card against CPU. Then v12-x
(phase y) serves batches of 128 with its counters on for one batch:
16 launches of the area attention op, held against its plain version at
their inputs, and its f32 path card against CPU. The kernels are custom ops
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
# attention checks (dtype, BH, T, value width): the serving shape and T=333
# (not a multiple of 8) with K/V resident, the 1280 px shape, eval's (val
# batch 32) and one image's, T=57 and T=1 with K/V streamed; 32-wide values
# (YOLO12's area attention) at v12-x's P4 and P5 and streamed
ATTN_CASES = (("bfloat16", 256, 400, 64), ("bfloat16", 16, 1600, 64), ("bfloat16", 64, 400, 64),
              ("bfloat16", 2, 400, 64), ("bfloat16", 3, 57, 64), ("bfloat16", 5, 1, 64),
              ("bfloat16", 200, 333, 64), ("float32", 32, 400, 64),
              ("bfloat16", 6144, 400, 32), ("bfloat16", 1536, 400, 32),
              ("bfloat16", 3, 57, 32), ("float32", 32, 400, 32))
# the 32-wide form's rows of phase (g): v12-x's P4 (128 images, 4 strips,
# 12 heads) and P5 (128 images, 12 heads), T = 400
V32_SHAPES = ((6144, 400), (1536, 400))
# the area attention op (q, k and v read in place from a qkv conv's NHWC
# map, the output an NHWC map) in phases (c) and (g), on random maps
# (dtype, B, H, W, strips) of 12 heads: v12-x's P4 (128 images of 40x40
# in 4 strips of 400 tokens) and P5 (20x20, one strip), and the f32 form
AREA_HEADS = 12
AREA_CASES = (("bfloat16", 128, 40, 40, 4), ("bfloat16", 128, 20, 20, 1),
              ("float32", 4, 40, 40, 4))
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
# phase w: the card's data path on phase m's kind of JPEGs, and run_test's
# mAP with it against the Python loader's
W_FILES = 128
W_MAP_TOL = 0.01
# nvJPEG's decode against cv2's (libjpeg's), per set of JPEGs: the mean
# |difference| stays under W_DECODE_GAP levels and every channel's mean
# difference under W_CHANNEL_GAP; the controls (nvJPEG's own RGB, which
# replicates the chroma; the channels swapped; cv2's pixels moved by +-1)
# must exceed W_DECODE_GAP, so that the gate can fail
W_DECODE_GAP = 0.2
W_CHANNEL_GAP = 0.05
# staged serving: the detections of the nvjpeg stager matched both ways
# against the cv2 stager's (phase f's criterion) fall no more than
# W_WITNESS_SLACK below a witness's: the cv2 stager with as many values
# moved by one level as nvJPEG's differ from it, streamed alike, the same
# noise on the random weights; phase f's 98% is printed beside it
W_WITNESS_SLACK = 0.05
W_MATCH = 0.98
CARD_KERNELS = ("ycc_to_rgb", "resize_bilinear", "resize_generic", "place")
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
               "tpu_yolo_torch::bias_act", "attention_bf16_kernel", "nms_keep_kernel",
               "bias_act_kernel")
PIXEL_GATE = "uint8 equal on >= 99.9% of values, mean |diff| < 0.01"
# phase t: data parallelism. t1's epoch losses against a plain trainer's
# (cuDNN's backward is not bit-reproducible between runs); t2's two ranks
# of 8 (f32, one card shared through gloo) against one process of 16 at
# tests/test_multihost.py's tolerance over the first DP_GATED_STEPS of
# DP_STEPS, and every step within DP_LATE_RTOL relative. From the third
# step on, v11-n's task-aligned assigner turns f32 rounding into
# different anchor picks: the BatchNorm moments' summation order alone
# (one process summing them in the ranks' order, also run) moves the
# third step's losses by about 2e-3, cuDNN's algorithm choice alone (one
# process under cudnn.benchmark, also run) by about 7e-3, and the same
# run repeated by up to 1e-3 absolute. t3's f32 Detector over two
# replicas at tests/test_parallel.py's box tolerance
DP_EPOCH_LOSS_RTOL = 1e-3
DP_GLOBAL_BATCH = 16
DP_STEPS = 3
DP_GATED_STEPS = 2
DP_LOSS_TOL = 2e-4
DP_LATE_RTOL = 1e-2
DP_BOX_TOL = dict(rtol=1e-5, atol=1e-4)
DP_TIMEOUT_S = 300
# phase u: two gloo ranks sharing the card on a (data 1, model 2) mesh,
# then a (data 1, spatial 2) one, beside one process with no group. u1
# gates the first step's losses at JAX's tolerance between topologies
# (later steps amplify f32 rounding: phase t2) and the state after it
# at TP_STATE_TOL; u2 the f32 class scores at SP_F32_TOL and the bf16
# detections by _agreement, as phase (f) does. The split convs' input
# gradients are summed in two halves, and cuDNN picks other algorithms
# for half-width and half-height convs: a tensor of the state off the
# oracle by more than TP_STATE_TOL (at --min-channels 64, the early
# layers' momentum) is held at TP_STATE_TOL to a witness that splits the
# same convs in halves of channels in one process, without gloo; u2's f32
# boxes (DFL expectations times the stride), where off by more than
# SP_F32_TOL, are held there to a witness that runs each conv in two
# halves of rows (phase t2's way: a witness that reproduces the gap in
# one process). PERF.md §5
TP_GLOBAL_BATCH = 8
TP_STEPS = 2
TP_LOSS_RTOL = 2e-4
TP_STATE_TOL = dict(rtol=1e-4, atol=1e-4)
SP_SIZE = 1280
SP_KEY = f"plain/{SP_SIZE}/"   # the rehearsal's forwards: STEM/SIZE/DTYPE
SP_F32_TOL = dict(rtol=1e-5, atol=1e-4)
SP_BF16_MATCH = 0.98
U_TIMEOUT_S = 600
# phase v: the meshes take what JAX's take, on two gloo ranks sharing the
# card beside one process (f32 without TF32). v1: SPV_SIZE px over (data
# 1, spatial 2), whose 41 p5 rows split 21 and 20 (blocks of 32 image
# rows): every f32 value within SP_F32_TOL of the oracle's or, where not,
# of the witness that runs each conv on the ranks' rows (u2's rule for
# boxes), bf16 detections matched at SP_BF16_MATCH; v2 the f32 forward with
# the s2d stem under v1's f32 gate; v3 phase p's int8 weights (bf16) over
# the spatial axis at SPV_SIZE and split over a model axis of 2 at
# --min-channels 64 at SIZE, their detections equal to the oracle's (the
# int32 sums are exact and the dequantize is per channel); v4 the
# attention kernel at the gathered p5 map's SPV_ATTN_T tokens
SPV_SIZE = 1312
SPV_ATTN_T = (SPV_SIZE // 32) ** 2
SPV_TP_MIN_CHANNELS = 64
V_TIMEOUT_S = 600
# phase x (model_sizes): every size serves as phase e does, then v11-x
# evaluates (run_test and the parity harness on phase j's split) and
# trains. Timed serving batches per size; the training batches tried at
# each remat level, the largest first, of which the one the card holds is
# reckoned from the peak at the smallest: peak(B) = base + (peak(8) -
# base) * B / 8, at most MS_MEMORY_SHARE of the card; the f32 train step
# card vs CPU at MS_F32_TRAIN_SIZE px (at 64 px both packages' f32 steps
# of v11-x are 3e-4 from an f64 one in losses: tests/test_torch_sizes.py)
MS_SIZES = "ntsmlx"
MS_SERVE_BATCHES = {"x": 10}   # the others 5
MS_TRAIN_BATCHES = (64, 32, 16, 8)
MS_REMAT = (False, "stage", "blocks")
MS_MEMORY_SHARE = 0.9
MS_TRAIN_STEPS = 3
MS_F32_TRAIN_SIZE = 128
MS_PARITY_MAX_IMAGES = 64
# phase x holds the attention kernel to its plain version at 1e-2 abs + rel
# plus MS_P_STEP * (P|V|): each p may round to the neighbouring bf16 value
# (a step is at most 2^-7 of p), as the kernel rounds p before dividing by
# its row's sum and the plain version after, each summing in its own order.
# v11-x's inputs (v up to 12 serving, 195 on phase j's split, p near
# one-hot) put outputs that cancel past the bare 1e-2; so they put a kernel
# that divides first (tests/test_torch_attention.py; PERF.md section 6)
MS_P_STEP = 2.0 ** -7
PARITY_KEYS = {"metric", "map", "map50", "recall", "precision", "expected", "tol",
               "full_set", "delta", "pass"}
# t2's witnesses: the one-process oracle under cudnn.benchmark, and the
# oracle with ConvBN._train_norm taking its moments over each half of the
# batch and summing them weighted by 1/2, in the order in which two ranks'
# all-reduce sums them (the body is tpu_yolo_torch/ops/nn.py's otherwise)
_ORACLE_CUDNN_BENCHMARK = """
import sys, torch
torch.backends.cudnn.benchmark = True
from tpu_yolo_torch import rehearsal
rehearsal.main(sys.argv[1:])
"""
_ORACLE_HALVES_BN = """
import sys, torch
from tpu_yolo_torch.ops import nn


def _train_norm(self, y):
    yf = y.float()
    h = yf.shape[0] // 2
    a, b = (torch.stack([p.mean((0, 2, 3)), p.square().mean((0, 2, 3))]) * 0.5
            for p in (yf[:h], yf[h:]))
    mean, sq_mean = (a + b).unbind(0)
    n = yf.numel() // yf.shape[1]
    var = (sq_mean - mean.square()).clamp(min=0)
    if not getattr(nn._state, "recomputing", False):
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            self.mean.copy_((1.0 - nn.BN_MOMENTUM) * self.mean + nn.BN_MOMENTUM * mean)
            self.var.copy_((1.0 - nn.BN_MOMENTUM) * self.var + nn.BN_MOMENTUM * unbiased)
    scale = torch.rsqrt(var + nn.BN_EPS) * self.gamma
    return self.act(yf * scale.view(1, -1, 1, 1)
                    + (self.beta - mean * scale).view(1, -1, 1, 1))


nn.ConvBN._train_norm = _train_norm
from tpu_yolo_torch import rehearsal
rehearsal.main(sys.argv[1:])
"""


_START = time.perf_counter()


# phases n, s and t train on one seeded mini-COCO, and phase t tests on
# phase j's labelled val split: each is written once, into one directory
# that is removed when the script exits
_WORK: dict = {}


def _work_dir() -> str:
    if "dir" not in _WORK:
        _WORK["dir"] = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    return _WORK["dir"].name


def _mini_coco():
    """The seeded mini-COCO of phases n, s and t (DA_IMAGES train images,
    480x640): (its path, the seconds it took to write, 0 after the first
    call)."""
    from tpu_yolo_torch.seeded import write_mini_coco

    if "coco" not in _WORK:
        t0 = time.perf_counter()
        _WORK["coco"] = write_mini_coco(os.path.join(_work_dir(), "coco"), DA_IMAGES,
                                        hw=(480, 640), seed=SEED + 1)
        return _WORK["coco"], time.perf_counter() - t0
    return _WORK["coco"], 0.0


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
    from tpu_yolo_torch.ops import (attention_cuda, bias_act_cuda, blocks, image_cuda, nms,
                                    nms_cuda, topk_cuda)
    from tpu_yolo_torch.ops import nn as ops_nn
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

    # (b) build the five kernel sources, one nvcc each, in parallel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        reports = list(pool.map(lambda build: build(),
                                (attention_cuda.build, nms_cuda.build,
                                 topk_cuda.build, image_cuda.build, bias_act_cuda.build)))
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         ptxas=[line.strip() for r in reports for line in r.splitlines()
                if "registers" in line or "spill" in line])

    # (c) attention kernel against attention_plain
    gen = torch.Generator(device=dev).manual_seed(SEED)
    attn_rows = []
    for dtype, bh, t, dh in ATTN_CASES:
        dtype = getattr(torch, dtype)
        q, k = (torch.randn(bh, t, 32, device=dev, generator=gen).to(dtype)
                for _ in range(2))
        v = torch.randn(bh, t, dh, device=dev, generator=gen).to(dtype)
        scale = 32 ** -0.5
        got = attention_cuda.fused_attention(q, k, v, scale)
        want = attention_cuda.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        row = dict(dtype=str(dtype), bh=bh, t=t, dh=dh,
                   form=attention_cuda.kernel_form(bh, t, dtype, dh),
                   max_abs_err=float(err.max()),
                   tol=f"atol {tol} + rtol {tol}", ok=ok)
        attn_rows.append(row)
        check(ok, f"attention kernel vs plain {row}")
    check({"resident", "streamed", "f32"} <= {r["form"] for r in attn_rows},
          f"a form of the attention kernel was not run: {attn_rows}")
    # the area attention op on random qkv maps, from a generator of its own
    area_gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    area_rows = []
    for dtype, b, h, w, area in AREA_CASES:
        qkv = _area_map(b, h, w, getattr(torch, dtype), area_gen)
        ok, err = _area_check(qkv, AREA_HEADS, area, 32 ** -0.5)
        row = dict(dtype=dtype, b=b, h=h, w=w, area=area, heads=AREA_HEADS,
                   bh=b * area * AREA_HEADS, t=h * w // area,
                   form=attention_cuda.kernel_form(b * area * AREA_HEADS, h * w // area,
                                                   qkv.dtype, 32),
                   max_abs_err=err, tol=f"atol {ATTN_TOL[dtype]} + rtol {ATTN_TOL[dtype]}",
                   ok=ok)
        area_rows.append(row)
        check(ok, f"area attention op vs plain {row}")
    emit("attention_check", cases=attn_rows, area_cases=area_rows)

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
    # (the epilogue pass's at its largest map, with and without a residual)
    captured = {}
    attn_fn, keep_fn, epilogue_fn = blocks.fused_attention, nms.greedy_keep, ops_nn.bias_act

    def attn_tap(q, k, v, scale):
        captured.setdefault("attention", (q, k, v, scale))
        return attn_fn(q, k, v, scale)

    def keep_tap(boxes, cls, valid, thr):
        captured.setdefault("nms", (boxes, cls, valid, thr))
        return keep_fn(boxes, cls, valid, thr)

    def epilogue_tap(y, b, act, residual=None, halves=False):
        key = "bias_act" if residual is None else "bias_act_residual"
        if key not in captured or y.numel() > captured[key][0].numel():
            captured[key] = (y, b, act, residual, halves)
        return epilogue_fn(y, b, act, residual, halves)

    blocks.fused_attention, nms.greedy_keep = attn_tap, keep_tap
    ops_nn.bias_act = epilogue_tap
    attention_cuda.fused_attention.launches = 0
    nms_cuda.greedy_keep.launches = 0
    bias_act_cuda.bias_act.launches = 0
    try:
        res = det.detect_batch(imgs)
        torch.cuda.synchronize()
    finally:
        blocks.fused_attention, nms.greedy_keep = attn_fn, keep_fn
        ops_nn.bias_act = epilogue_fn
    launches = {"attention": attention_cuda.fused_attention.launches,
                "nms": nms_cuda.greedy_keep.launches,
                "bias_act": bias_act_cuda.bias_act.launches}
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
    val_split = _eval_phase(cfg, smi, state, captured, launches)

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
    int8_state = _int8_phase(cfg, smi, state, imgs, launches)
    _profile_export_phase(cfg, smi, state, imgs, launches)

    # (r) the ONNX export of the serving weights, run on the host, against
    # the live f32 forward on the card; --export both through the CLI
    _onnx_phase(cfg, smi, state, imgs, launches)

    # (n) the trainer with --device-augment beside the host loader
    augment = _train_device_augment_phase(cfg, smi, launches)

    # (s) the trainer with --native-train auto and --tensorboard
    native = _native_train_phase(cfg, smi, launches)

    # (w) the port's own data path on the card: nvJPEG and the placement
    # kernels through serving, eval and the trainer, beside cv2
    _card_decode_phase(cfg, smi, state, captured, launches, val_split, augment, native)

    # (t) data parallelism: a one-rank NCCL run of --train and --test
    # --distributed, two gloo ranks sharing the card, Detector(dp=...),
    # the preflight
    _data_parallel_phase(cfg, smi, state, imgs, launches, native["epoch"], val_split)

    # (u) tensor and spatial parallelism: two gloo ranks sharing the card
    # on a (data 1, model 2) mesh, then a (data 1, spatial 2) one, beside
    # one process with no group
    _tensor_spatial_phase(cfg, smi, captured, launches)

    # (v) the meshes take what JAX's take: uneven height shards, the s2d
    # stem and int8 under a spatial mesh, int8 in a model split
    _spatial_uneven_phase(cfg, smi, captured, launches, int8_state)

    # (x) every model size: each serves; v11-x evaluates (run_test, the
    # parity harness) and trains at the batch and remat level the card holds
    _model_sizes_phase(smi, captured, launches, val_split)

    # (y) v12-x serves: the area attention op counted in its own batch
    _yolo12_phase(smi, captured, launches)

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


def _train_f32_phase(cfg, dev, two_images, size=SIZE, phase="train_f32_card_vs_cpu"):
    """Phase (i): loss_and_grads on 2 images of `size` px in f32, TF32 off,
    on the card and on the CPU. Returns the phase's fields."""
    import torch

    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.seeded import seeded_train_batch
    from tpu_yolo_torch.train import loss as loss_mod
    from tpu_yolo_torch.train.step import loss_and_grads

    _, gt = seeded_train_batch(np.random.default_rng(SEED + 1), 2, size, max_boxes=12)
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
    fields = dict(images=2, size=size, losses_card=card_losses,
                  losses_cpu=cpu_losses, max_loss_rel_err=loss_err,
                  fg_anchors=int(fg["cpu"].sum()), fg_mask_equal=fg_equal,
                  grad_leaves=len(rel), grad_worst_leaf=worst,
                  grad_worst_rel_err=rel[worst], grad_median_rel_err=median,
                  threshold="losses within 1e-4 relative; fg mask equal; every "
                            "gradient leaf within 2e-2 of its largest entry, median "
                            "within 1e-3")
    emit(phase, **fields)
    check(loss_err <= 1e-4 and fg_equal and rel[worst] <= 2e-2 and median <= 1e-3,
          f"f32 training step, card vs CPU: loss {loss_err}, fg equal {fg_equal}, "
          f"worst gradient {worst} {rel[worst]}, median {median}")
    return fields


def _eval_phase(cfg, smi, state, captured, launches):
    """Phase (j). Fills captured["eval_attention"], captured["eval_nms"]
    and launches["eval_attention"], launches["eval_nms"] (per run_test).
    Returns the val split, the checkpoint and the first run_test's
    (mAP, mAP50, recall, precision)."""
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

    tmp = os.path.join(_work_dir(), "eval")
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
    # phase t tests these weights on this split beside this run_test
    return dict(root=root, ckpt=ckpt, map_tuple=[float(v) for v in result])


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
            def hook(m, args, kwargs):
                xq[name] = m.quantize_input(args[0]).cpu()
                if keep_io:
                    io[name] = [args[0].cpu(), {k: v.cpu() if torch.is_tensor(v) else v
                                                for k, v in kwargs.items()}]
            return hook

        def post(name):
            def hook(m, args, out):
                if keep_io:
                    io[name].append(_whole(out).cpu())
            return hook

        handles = []
        for name, m in model.named_modules():
            if isinstance(m, ConvBN):
                handles += [m.register_forward_pre_hook(pre(name), with_kwargs=True),
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
        for name, (inp, kwargs, out) in io.items():
            got = _whole(modules[name](inp.cuda(), **{
                k: v.cuda() if torch.is_tensor(v) else v for k, v in kwargs.items()})).cpu()
            worst = max(worst, float((got - out).abs().max() / out.abs().max()))
    differ = {name: int((xq_card[name] != q).sum()) for name, q in xq_cpu.items()}
    return dict(convs=len(io), teacher_forced_max_rel_err=worst,
                xq_values=sum(q.numel() for q in xq_cpu.values()),
                xq_differ=sum(differ.values()),
                convs_differing=sum(1 for d in differ.values() if d),
                first_conv_differing=next((n for n, d in differ.items() if d), None))


def _whole(out):
    """A conv's output, its two halves (`ConvBN(x, halves=True)`) joined."""
    import torch

    return torch.cat(out, 1) if isinstance(out, tuple) else out


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
    return qstate


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
        flops.append(2 * _whole(out).numel() * w.shape[1] * w.shape[2] * w.shape[3])

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
    bf16): on the card auto takes the native loader with its sources
    decoded and prescaled by nvJPEG and the placement kernels (`[train]
    loader: nvjpeg`), the top-k kernel counted; then that loader's img/s
    alone beside the host loader's. Returns the epoch line, the loader
    line and the top-k launches."""
    import contextlib
    import io

    import torch

    from tpu_yolo_torch.core.config import load_hyperparams
    from tpu_yolo_torch.data import native_loader
    from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
    from tpu_yolo_torch.data.loader import DataLoader
    from tpu_yolo_torch.data.native_train import NativeTrainLoader
    from tpu_yolo_torch.ops import topk_cuda
    from tpu_yolo_torch.train import trainer

    host_library = native_loader.why_unavailable()
    steps = DA_IMAGES // TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, _ = _mini_coco()

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
        check(state.step == steps and topk == steps
              and loader_line == ["[train] loader: nvjpeg"],
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

        files = split_files(data_dir, "train2017")
        cache = os.path.join(data_dir, "train2017.cache.npy")
        hyp = load_hyperparams()
        loaders = {
            "native_nvjpeg": NativeTrainLoader(files, SIZE, hyp, TRAIN_BATCH,
                                               cache_path=cache, threads=8, seed=SEED,
                                               device="cuda"),
            "host": DataLoader(DetectionDataset(files, SIZE, hyp, augment=True,
                                                cache_path=cache), TRAIN_BATCH,
                               shuffle=True, num_workers=8, drop_last=True)}
        rates = {}
        for name, loader in loaders.items():
            t0 = time.perf_counter()
            n = TRAIN_BATCH * sum(1 for _ in loader)
            rates[name] = n / (time.perf_counter() - t0)
    epoch = [ln for ln in lines if ln.startswith("epoch ")][-1]
    emit("native_train", nvidia_smi=smi, model="v11-n", size=SIZE, batch=TRAIN_BATCH,
         dtype="bfloat16", images=DA_IMAGES, host_library_unavailable_because=host_library,
         loader_line=loader_line[0], topk_launches=topk, train_s=train_s, epoch=epoch,
         loader_alone_img_per_s=rates, tensorboard=tensorboard)
    return dict(epoch=epoch, loader_line=loader_line[0], topk=topk)


def _card_decode_phase(cfg, smi, state, captured, launches, val_split, augment, native):
    """Phase (w): the port's own data path on the card, JPEGs decoded by
    nvJPEG and placed by the kernels of csrc/image_card.cu.

    The main path, with the three placement kernels' counts at 0: staged
    serving (`Detector(device_letterbox=True).stream`, stage 960) and the
    host-letterbox `stream` on phase m's kind of JPEGs (480x640, 640x480,
    1080x1920), `run_test` with --native-eval auto on phase j's split and
    a DeviceAugmentLoader epoch over the mixed JPEGs with its random
    prescale interpolations; each kernel's largest call is captured. Then:
    w1 each kernel against its plain version at the captured inputs and
    on nvJPEG's own planes and pixels of each size, in all five
    interpolations, bit for bit; w2 nvJPEG's decode against cv2's on
    phase j's noise JPEGs, the smooth ones, the smooth ones at 4:4:4 and a
    grayscale one, within W_DECODE_GAP and W_CHANNEL_GAP, each control
    beyond W_DECODE_GAP; w3 staged serving against the cv2 stager: the
    same dims, nothing outside the images, two passes bit-equal, the
    detections matched both ways no more than W_WITNESS_SLACK under a
    witness's (the cv2 stager with as many values moved by one level as
    nvJPEG's differ, streamed alike: random weights move with any pixel
    noise), phase f's 98% printed, and the rates of both stagers; w4 run_test's mAP against the Python loader's (within
    W_MAP_TOL), both eval kernels counted as phase j counts them; w5 the
    trainer: phase n's --device-augment and phase s's --native-train auto
    epochs read nvjpeg, launched top-k and have finite losses, beside one
    --device-augment epoch through the cv2 stager and the loaders alone
    through cv2. Returns the captured kernel inputs' rows for the kernels
    line."""
    import contextlib
    import io
    import re
    import threading

    import cv2
    import torch

    from tpu_yolo_torch.cli import main as cli
    from tpu_yolo_torch.core.config import load_hyperparams
    from tpu_yolo_torch.data import native_loader
    from tpu_yolo_torch.data.dataset import split_files
    from tpu_yolo_torch.data.device_augment import DeviceAugmentLoader
    from tpu_yolo_torch.data.native_train import NativeTrainLoader
    from tpu_yolo_torch.eval import evaluator
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda, topk_cuda
    from tpu_yolo_torch.ops import image_cuda as ic
    from tpu_yolo_torch.serve import Detector, _Cv2Letterbox
    from tpu_yolo_torch.train import trainer

    hyp = load_hyperparams()
    real = {name: getattr(ic, name) for name in CARD_KERNELS}
    lock = threading.Lock()

    def tap(name):
        def call(*a, **kw):
            src = a[0] if name != "place" else kw.get("src", a[5] if len(a) > 5 else None)
            size = 0 if src is None else src.numel()
            with lock:
                keep = size > captured.get(f"card_{name}", (None, -1))[1]
            if keep:
                args = [x.clone() if isinstance(x, torch.Tensor) else x for x in a]
                kw2 = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in kw.items()}
                with lock:
                    captured[f"card_{name}"] = ((args, kw2), size)
            return real[name](*a, **kw)
        return call

    with tempfile.TemporaryDirectory() as tmp:
        files = _write_jpegs(os.path.join(tmp, "jpegs"), W_FILES)
        val_files = split_files(val_split["root"], "val2017")
        staged = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE,
                          device="cuda", device_letterbox=True, stage_size=STAGE)
        host = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
        for det in (staged, host):            # warm both paths
            list(det.stream(files, batch_size=BATCH))
        args = argparse.Namespace(
            weights=val_split["ckpt"], save_dir=tmp, data_dir=val_split["root"],
            input_size=SIZE, val_batch_size=EVAL_BATCH, workers=8, native_eval="auto",
            coco_metrics=False, plot=False, max_nms=2048, device="cuda")
        clock = {}
        eval_fn = evaluator.evaluate

        def run_test(mode):
            """run_test with --native-eval `mode`: its result, its lines,
            the eval kernels' counts and evaluate's wall seconds."""
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return eval_fn(*a, **kw)
                finally:
                    clock["evaluate"] = time.perf_counter() - t0

            attention_cuda.fused_attention.launches = 0
            nms_cuda.greedy_keep.launches = 0
            evaluator.evaluate = timed
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    result = cli.run_test(argparse.Namespace(**{**vars(args),
                                                                "native_eval": mode}),
                                          hyp, cfg)
                torch.cuda.synchronize()
            finally:
                evaluator.evaluate = eval_fn
            return (list(result), buf.getvalue().strip().splitlines(),
                    {"attention": attention_cuda.fused_attention.launches,
                     "nms": nms_cuda.greedy_keep.launches}, clock["evaluate"])

        def stream_rate(det):
            t0 = time.perf_counter()
            res = list(det.stream(files * 2, batch_size=BATCH))
            return len(res) / (time.perf_counter() - t0), res

        def loader_rate(loader):
            t0 = time.perf_counter()
            n = sum(b[0].shape[0] for b in loader)
            torch.cuda.synchronize()
            return n / (time.perf_counter() - t0)

        # -- the main path, the placement kernels counted ---------------
        for name in CARD_KERNELS:
            setattr(ic, name, tap(name))
        for fn in real.values():
            fn.launches = 0
        try:
            staged_rate, staged_out = stream_rate(staged)
            host_rate, _ = stream_rate(host)
            auto = run_test("auto")
            mixed = DeviceAugmentLoader(files, SIZE, hyp, TRAIN_BATCH, threads=8,
                                        seed=SEED, device="cuda")
            da_rate = {"nvjpeg": loader_rate(mixed)}
            torch.cuda.synchronize()
        finally:
            for name in CARD_KERNELS:
                setattr(ic, name, real[name])
        path_launches = {name: real[name].launches for name in CARD_KERNELS}
        launches.update({f"card_{k}": v for k, v in path_launches.items()})
        check(min(path_launches.values()) > 0,
              f"a placement kernel did not run on the main path: {path_launches}")
        check(staged.stager == host.stager == mixed.stager == "nvjpeg",
              f"stagers {staged.stager}, {host.stager}, {mixed.stager}")

        # -- w1: the kernels against their plain versions ---------------
        dec = staged._stager._decoders[0]

        def decoded(path, bgr=False):
            nbytes = dec.read(path)
            with torch.cuda.stream(dec.stream):
                img = dec.decode(nbytes, bgr)
                dec.done.record(dec.stream)
            torch.cuda.synchronize()
            return img

        kernel_rows = []
        for path in files[:3] + val_files[:1]:
            planes, (hs, vs) = _nvjpeg_planes(dec, path)
            for bgr in (False, True):
                kernel_rows.append(dict(
                    src=list(planes[0].shape), kernel="ycc_to_rgb", subsampling=[hs, vs],
                    bgr=bgr, equal=bool(torch.equal(
                        decoded(path, bgr), ic.ycc_to_rgb_plain(*planes, hs, vs, bgr)))))
            img = decoded(path)
            h, w = img.shape[:2]
            for interp in range(5):
                for dh, dw in ((h // 3, w // 3), (min(2 * h, 960), min(2 * w, 960)),
                               (640 * h // max(h, w), 640 * w // max(h, w))):
                    slot = torch.full((968, 968, 3), 7, dtype=torch.uint8, device="cuda")
                    ic.resize_into(img, slot, dh, dw, interp, 5, 3)
                    want = (ic.resize_bilinear_plain(img, dh, dw)
                            if ic.uses_bilinear(interp, w, h, dw, dh)
                            else ic.resize_generic_plain(img, dh, dw, interp))
                    kernel_rows.append(dict(
                        src=[h, w], dst=[dh, dw], interp=interp,
                        kernel="resize_bilinear" if ic.uses_bilinear(interp, w, h, dw, dh)
                        else "resize_generic",
                        equal=bool(torch.equal(slot[5:5 + dh, 3:3 + dw], want))))
            slot, want = (torch.full((960, 960, 3), 7, dtype=torch.uint8, device="cuda")
                          for _ in range(2))
            small = img[:min(h, 960), :min(w, 900)].contiguous()
            ic.place(slot, 0, 60, small.shape[0], small.shape[1], small)
            ic.place_plain(want, 0, 60, small.shape[0], small.shape[1], small)
            kernel_rows.append(dict(src=[h, w], kernel="place",
                                    equal=bool(torch.equal(slot, want))))
        torch.cuda.synchronize()
        check(all(r["equal"] for r in kernel_rows),
              f"a card kernel differs from its plain version: "
              f"{[r for r in kernel_rows if not r['equal']]}")

        # -- w2: nvJPEG's decode against cv2's, gated, with controls ----
        def decode_gap(paths):
            """Over `paths`: the card decode's gap to cv2 and the controls'
            (nvJPEG's own RGB, the channels swapped, cv2 moved by +-1)."""
            rows = {k: [] for k in ("mean", "share", "channel", "own", "swapped",
                                    "plus_minus_one")}
            d_max = 0
            noise_rng = np.random.default_rng(SEED + 11)
            for p in paths:
                want = torch.from_numpy(cv2.imread(p)[:, :, ::-1].copy()).cuda().int()
                got = decoded(p).int()
                d = (got - want).abs()
                d_max = max(d_max, int(d.max()))
                rows["mean"].append(float(d.float().mean()))
                rows["share"].append(float((d > 0).float().mean()))
                rows["channel"].append(float((got - want).float().mean((0, 1)).abs().max()))
                rows["own"].append(float((_nvjpeg_own_rgb(dec, p).int() - want)
                                         .abs().float().mean()))
                rows["swapped"].append(float((got.flip(2) - want).abs().float().mean()))
                moved = (want + torch.from_numpy(noise_rng.integers(
                    -1, 2, tuple(want.shape))).cuda()).clamp(0, 255)
                rows["plus_minus_one"].append(float((moved - want).abs().float().mean()))
            return dict(files=len(paths), max_abs_diff=d_max,
                        share_differing=float(np.mean(rows["share"])),
                        mean_abs_diff=float(np.mean(rows["mean"])),
                        worst_file_mean_abs_diff=float(np.max(rows["mean"])),
                        worst_channel_mean_diff=float(np.max(rows["channel"])),
                        controls_mean_abs_diff=dict(
                            nvjpeg_own_rgb=float(np.mean(rows["own"])),
                            swapped_channels=float(np.mean(rows["swapped"])),
                            cv2_plus_minus_one=float(np.mean(rows["plus_minus_one"]))))

        gray = os.path.join(tmp, "gray.jpg")
        cv2.imwrite(gray, cv2.cvtColor(cv2.imread(files[0]), cv2.COLOR_BGR2GRAY))
        full = []
        for i, path in enumerate(files[:6]):
            full.append(os.path.join(tmp, f"full{i}.jpg"))
            cv2.imwrite(full[-1], cv2.imread(path), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
        decode = {"noise_480x640_phase_j": decode_gap(val_files),
                  "smooth_mixed_phase_m": decode_gap(files),
                  "smooth_444": decode_gap(full),
                  "grayscale_480x640": decode_gap([gray])}
        emit("card_decode_pixels", nvidia_smi=smi, decode_vs_cv2=decode,
             bounds=dict(mean_abs_diff=W_DECODE_GAP, channel_mean_diff=W_CHANNEL_GAP))
        for key, gap in decode.items():
            check(gap["worst_file_mean_abs_diff"] < W_DECODE_GAP
                  and gap["worst_channel_mean_diff"] < W_CHANNEL_GAP,
                  f"nvJPEG's decode against cv2's on {key}: {gap}")
            controls = gap["controls_mean_abs_diff"]
            check((key == "grayscale_480x640"   # R = G = B: a swap changes nothing
                   or controls["swapped_channels"] > W_DECODE_GAP)
                  and controls["cv2_plus_minus_one"] > W_DECODE_GAP,
                  f"a control of the decode gate passes it on {key}: {controls}")
        for key in ("noise_480x640_phase_j", "smooth_mixed_phase_m"):   # 4:2:0
            check(decode[key]["controls_mean_abs_diff"]["nvjpeg_own_rgb"] > W_DECODE_GAP,
                  f"nvJPEG's replicated chroma passes the decode gate on {key}")

        # -- w3: staged serving, nvjpeg against the cv2 stager ----------
        nv_stager, nv_host = staged._stager, host._host_pipe
        staged._stager = _HostPipeOnCard(native_loader.Cv2Pipeline(8))
        host._host_pipe = _HostPipeOnCard(_Cv2Letterbox(SIZE, 8))
        try:
            list(staged.stream(files, batch_size=BATCH))
            cv2_staged_rate, cv2_out = stream_rate(staged)
            cv2_host_rate, _ = stream_rate(host)
        finally:
            staged._stager, host._host_pipe = nv_stager, nv_host

        def matched(pairs):
            """Detections with a partner both ways, pooled over images."""
            hit, total = [0, 0], [0, 0]
            for a, b in pairs:
                agree = _agreement(a, b)
                for k in range(2):
                    hit[k] += agree["match"][k] * agree["count"][k]
                    total[k] += agree["count"][k]
            return [h / max(t, 1) for h, t in zip(hit, total)], total

        n = len(files)
        match, total = matched((_one(a), _one(b)) for a, b in zip(staged_out, cv2_out))
        check(all(np.array_equal(a[k], b[k]) for a, b in zip(staged_out[:n], staged_out[n:])
                  for k in ("boxes", "scores", "classes")),
              "the nvjpeg stream's two passes over the same files differ")

        # the same staged batch from both stagers: the geometry exact (dims,
        # every pixel outside the image zero) and the share of values that
        # differ; then the witness, streamed as both stagers are: the cv2
        # stager with as many values moved by one level
        nv_buf, nv_dims, _ = nv_stager.load_batch_raw(files, STAGE)
        cv_buf, cv_dims, _ = native_loader.Cv2Pipeline(8).load_batch_raw(files, STAGE)
        check(np.array_equal(nv_dims, cv_dims), "nvjpeg and cv2 staged dims differ")
        inside = torch.zeros(nv_buf.shape[:3], dtype=torch.bool, device="cuda")
        for i, (sh, sw) in enumerate(nv_dims[:, :2].astype(int)):
            inside[i, :sh, :sw] = True
        check(not bool(nv_buf[~inside].any()), "nvjpeg staged pixels outside the images")
        gap = (nv_buf.int() - torch.from_numpy(cv_buf).cuda().int()).abs()[inside].float()
        share = float((gap > 0).float().mean())
        del nv_buf, cv_buf, inside
        staged._stager = _NoisyStager(native_loader.Cv2Pipeline(8), share, SEED + 9)
        try:
            witness_out = stream_rate(staged)[1]
        finally:
            staged._stager = nv_stager
        witness = dict(
            matched_share_vs_cv2=matched((_one(a), _one(b))
                                         for a, b in zip(witness_out, cv2_out))[0],
            values_moved_share=share,
            staged_pixel_gap=dict(mean=float(gap.mean()), share_differing=share,
                                  max=float(gap.max())))
        floor = min(witness["matched_share_vs_cv2"]) - W_WITNESS_SLACK
        emit("card_decode_serving", nvidia_smi=smi, detections_matched_vs_cv2=match,
             detections=total, witness=witness, gate=floor,
             phase_f_criterion=dict(threshold=W_MATCH, met=min(match) >= W_MATCH))
        check(min(match) >= floor,
              f"staged serving, nvjpeg against the cv2 stager: {match} of {total} "
              f"matched, under the witness's less {W_WITNESS_SLACK}: {witness}")

        # -- decode-and-place alone, back to back -----------------------
        alone = {}
        for key, pipe in (("nvjpeg", nv_stager), ("cv2", native_loader.Cv2Pipeline(8))):
            pipe.load_batch_raw(files, STAGE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                pipe.load_batch_raw(files, STAGE)
            torch.cuda.synchronize()
            alone[key] = 3 * len(files) / (time.perf_counter() - t0)

        # -- w4: eval, nvjpeg against the Python loader ------------------
        off = run_test("off")
        loader_lines = [ln for ln in auto[1] + off[1] if ln.startswith("[eval] loader: ")]
        batches = -(-EVAL_IMAGES // EVAL_BATCH)
        check(loader_lines == ["[eval] loader: nvjpeg", "[eval] loader: python"],
              f"eval loader lines {loader_lines}")
        check(auto[2]["nms"] == batches and auto[2]["attention"] >= batches,
              f"eval kernels with the nvjpeg loader: {auto[2]}, {batches} batches")
        map_gap = abs(auto[0][0] - off[0][0])
        check(map_gap <= W_MAP_TOL, f"eval mAP nvjpeg {auto[0]} vs python {off[0]}")

        # -- w5: the trainer ----------------------------------------------
        def finite_epoch(line):
            vals = re.findall(r"(box|cls|dfl) (\S+)", line)
            return len(vals) == 3 and all(np.isfinite(float(v)) for _, v in vals)

        da_line = augment["runs"]["device_mosaic"]
        check(da_line["stager"] == "[train] device augment: stager nvjpeg"
              and da_line["topk_launches"] > 0 and finite_epoch(da_line["last_epoch"]),
              f"--device-augment through nvjpeg: {da_line}")
        check(native["loader_line"] == "[train] loader: nvjpeg" and native["topk"] > 0
              and finite_epoch(native["epoch"]),
              f"--native-train auto through nvjpeg: {native}")
        data_dir, _ = _mini_coco()
        train_files = split_files(data_dir, "train2017")
        cache = os.path.join(data_dir, "train2017.cache.npy")
        choose = native_loader.staging_pipeline
        native_loader.staging_pipeline = \
            lambda input_size, threads=8, device=None: native_loader.Cv2Pipeline(threads)
        try:
            da_rate["cv2"] = loader_rate(DeviceAugmentLoader(
                files, SIZE, hyp, TRAIN_BATCH, threads=8, seed=SEED, pin_memory=True))
            cv2_args = argparse.Namespace(
                model_size="n", input_size=SIZE, batch_size=TRAIN_BATCH, epochs=1,
                data_dir=data_dir, save_dir=os.path.join(tmp, "da_cv2"), resume="",
                weights="", workers=8, gt_bucket=0, remat=False, remat_level="stage",
                tensorboard=False, val_batch_size=EVAL_BATCH, native_eval="off",
                max_nms=2048, device_augment=True, seed=SEED)
            topk_cuda.topk_mask.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer.train(cv2_args, hyp, cfg, device="cuda")
            torch.cuda.synchronize()
        finally:
            native_loader.staging_pipeline = choose
        cv2_lines = buf.getvalue().strip().splitlines()
        cv2_epoch = [ln for ln in cv2_lines if ln.startswith("epoch ")][-1]
        check("[train] device augment: stager cv2" in cv2_lines
              and topk_cuda.topk_mask.launches > 0 and finite_epoch(cv2_epoch),
              f"--device-augment through cv2: {cv2_lines}")
        nt = {}
        for key in ("nvjpeg", "cv2"):
            loader = NativeTrainLoader(train_files, SIZE, hyp, TRAIN_BATCH,
                                       cache_path=cache, threads=8, seed=SEED,
                                       device="cuda")
            if key == "cv2":
                loader._pipe, loader.stager = native_loader.Cv2Pipeline(8), "cv2"
            nt[key] = loader_rate(loader)

        def epoch_rate(line):
            m = re.search(r"s, ([\d.]+) img/s\)", line)
            return float(m.group(1)) if m else None

    emit("card_decode", nvidia_smi=smi, model="v11-n", size=SIZE, dtype="bfloat16",
         stage=STAGE, files=W_FILES, main_path_launches=path_launches,
         fallbacks_to_cv2=dict(staged=nv_stager.fallbacks, host=nv_host.fallbacks),
         kernels_vs_plain=dict(cases=len(kernel_rows),
                               equal=sum(r["equal"] for r in kernel_rows)),
         decode_vs_cv2=decode,
         staged_serving=dict(stager=staged.stager, img_per_s=dict(
             nvjpeg=staged_rate, cv2=cv2_staged_rate),
             host_letterbox_img_per_s=dict(nvjpeg=host_rate, cv2=cv2_host_rate),
             detections_matched_vs_cv2=match, detections=total,
             sensitivity_witness=witness, phase_f_criterion_met=min(match) >= W_MATCH,
             gates=f"stager nvjpeg; dims equal to the cv2 stager's; zero outside "
             f"every image; two passes bit-equal; detections matched both ways "
             f">= the witness's less {W_WITNESS_SLACK}"),
         decode_and_place_alone_img_per_s=alone,
         eval=dict(loader_lines=loader_lines, launches_nvjpeg=auto[2],
                   launches_python=off[2], map_tuple_nvjpeg=auto[0],
                   map_tuple_python=off[0], map_abs_gap=map_gap, threshold=W_MAP_TOL,
                   img_per_s=dict(nvjpeg=EVAL_IMAGES / auto[3],
                                  python=EVAL_IMAGES / off[3])),
         trainer=dict(
             device_augment_epoch_img_per_s=dict(
                 nvjpeg=da_line["epoch_img_per_s"], cv2=epoch_rate(cv2_epoch)),
             device_augment_topk=dict(nvjpeg=da_line["topk_launches"],
                                      cv2=topk_cuda.topk_mask.launches),
             native_train_epoch_img_per_s=dict(
                 nvjpeg=epoch_rate(native["epoch"]),
                 host_loader_cv2=augment["runs"]["host_loader"]["epoch_img_per_s"]),
             native_train_topk=native["topk"],
             epochs=dict(device_augment_nvjpeg=da_line["last_epoch"],
                         device_augment_cv2=cv2_epoch, native_train=native["epoch"]),
             loader_alone_img_per_s=dict(device_augment_mixed_sizes=da_rate,
                                         native_train=nt)))


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


class _HostPipeOnCard:
    """A host pipeline (cv2's, or the host copy's) behind a card
    Detector: it decodes into a pinned host batch and copies that into
    the Detector's device batch on the current stream, as a Detector on
    the card staged before it had a decoder there. Phase m's f32 check
    and phase w's cv2 rates put it in a card Detector's place."""

    def __init__(self, pipe):
        self.pipe, self.stager, self.fallbacks = pipe, pipe.stager, 0

    def _up(self, load, out):
        import torch

        host = torch.empty(tuple(out.shape), dtype=torch.uint8, pin_memory=True)
        _, rows, nfail = load(host.numpy())
        out.copy_(host, non_blocking=True)
        return out, rows, nfail

    def load_batch_raw(self, paths, stage, out):
        return self._up(lambda host: self.pipe.load_batch_raw(paths, stage, out=host), out)

    def load_batch(self, paths, out):
        return self._up(lambda host: self.pipe.load_batch(paths, out=host), out)


class _NoisyStager(_HostPipeOnCard):
    """_HostPipeOnCard whose staged images have a `share` of their values
    moved by one level up or down (seeded, on the card): phase w's
    witness of how far that much pixel noise moves the detections."""

    def __init__(self, pipe, share: float, seed: int):
        import torch

        super().__init__(pipe)
        self.share = share
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def load_batch_raw(self, paths, stage, out):
        import torch

        out, dims, nfail = super().load_batch_raw(paths, stage, out)
        inside = torch.zeros(out.shape[:3], dtype=torch.bool, device=out.device)
        for i, (sh, sw) in enumerate(dims[:, :2].astype(int)):
            inside[i, :max(sh, 0), :max(sw, 0)] = True
        step = torch.randint(0, 2, out.shape, generator=self.gen, device=out.device) * 2 - 1
        moved = torch.rand(out.shape, generator=self.gen, device=out.device) < self.share
        step = step * (moved & inside[..., None])
        out.copy_((out.int() + step).clamp(0, 255).to(torch.uint8))
        return out, dims, nfail


def _nvjpeg_planes(dec, path):
    """nvJPEG's planar YCbCr of a colour JPEG through a card decoder `dec`
    (data/native_loader.py::_Decoder), as its decode takes them: (Y, Cb,
    Cr) on the card and (hs, vs), or None where the decode is nvJPEG's
    own RGB."""
    import ctypes

    import torch

    n = dec.read(path)
    dims = [ctypes.c_int(0) for _ in range(7)]
    check(dec.lib.ic_image_info(dec.handle, dec.pinned.ctypes.data, n,
                                *(ctypes.byref(d) for d in dims)) == 0, path)
    w, h, _, hs, vs, cw, ch = (d.value for d in dims)
    if not hs:
        return None
    y = torch.empty((h, w), dtype=torch.uint8, device="cuda")
    cb, cr = (torch.empty((ch, cw), dtype=torch.uint8, device="cuda") for _ in range(2))
    with torch.cuda.stream(dec.stream):
        check(dec.lib.ic_decode_planes(dec.handle, dec.pinned.ctypes.data, n,
                                       y.data_ptr(), w, cb.data_ptr(), cr.data_ptr(),
                                       cw, dec.stream.cuda_stream) == 0, path)
        dec.done.record(dec.stream)
    torch.cuda.synchronize()
    return (y, cb, cr), (hs, vs)


def _nvjpeg_own_rgb(dec, path, bgr=False):
    """nvJPEG's own interleaved RGB of `path` (its chroma replicated): the
    decode the card pipeline does not use for colour JPEGs, a control."""
    import ctypes

    import torch

    n = dec.read(path)
    dims = [ctypes.c_int(0) for _ in range(7)]
    check(dec.lib.ic_image_info(dec.handle, dec.pinned.ctypes.data, n,
                                *(ctypes.byref(d) for d in dims)) == 0, path)
    w, h = dims[0].value, dims[1].value
    img = torch.empty((h, w, 3), dtype=torch.uint8, device="cuda")
    with torch.cuda.stream(dec.stream):
        check(dec.lib.ic_decode(dec.handle, dec.pinned.ctypes.data, n, int(bgr),
                                img.data_ptr(), 3 * w, dec.stream.cuda_stream) == 0, path)
        dec.done.record(dec.stream)
    torch.cuda.synchronize()
    return img


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
        # the decode alone, into the same kind of buffer, per path (on the
        # card: nvJPEG and the placement kernels into a device batch)
        decode = {}
        for key, size, run in (
                ("staged_raw", STAGE, staged._decode_batch_raw),
                ("host_letterbox", SIZE, host._decode_batch)):
            buf = torch.zeros((BATCH, size, size, 3), dtype=torch.uint8, device="cuda")
            t0 = time.perf_counter()
            for lo in range(0, STAGED_FILES, BATCH):
                run(files[lo:lo + BATCH], buf[:len(files[lo:lo + BATCH])])
            torch.cuda.synchronize()
            decode[key] = STAGED_FILES / (time.perf_counter() - t0)
        # the H2D copy of one pinned batch per path
        h2d_ms = {}
        for key, size in (("staged_raw", STAGE), ("host_letterbox", SIZE)):
            buf = torch.zeros((BATCH, size, size, 3), dtype=torch.uint8, pin_memory=True)
            h2d_ms[key] = cuda_ms(lambda buf=buf: buf.to("cuda", non_blocking=True),
                                  iters=5)

        # f32 on the card (TF32 off) against the CPU, through the staged
        # path; the card Detector stages through the CPU's stager, so that
        # both run the model on the same pixels (phase w holds nvJPEG's)
        two = [files[0], files[2]]
        kw = dict(input_size=SIZE, compute_dtype=torch.float32, ranking="exact",
                  device_letterbox=True, stage_size=STAGE)
        on_cpu = Detector(YOLO.from_state_dict(cfg, state), device="cpu", **kw)
        cpu = list(on_cpu.stream(two, batch_size=2, rescale=False))
        on_card = Detector(YOLO.from_state_dict(cfg, state), device="cuda", **kw)
        on_card._stager = _HostPipeOnCard(on_cpu._stager)
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            card = list(on_card.stream(two, batch_size=2, rescale=False))
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
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
    from tpu_yolo_torch.train import trainer

    epochs, steps = 2, DA_IMAGES // TRAIN_BATCH
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, write_s = _mini_coco()
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
                cache_path=cache, threads=8, seed=SEED, pin_memory=True,
                device="cuda")
        loaders["host_loader"] = DataLoader(
            DetectionDataset(files, SIZE, load_hyperparams(), augment=True,
                             cache_path=cache), TRAIN_BATCH, shuffle=True,
            num_workers=8, drop_last=True)
        loader_rates = {}
        for name, loader in loaders.items():
            t0 = time.perf_counter()
            n = TRAIN_BATCH * sum(1 for _ in loader)
            torch.cuda.synchronize()
            loader_rates[name] = n / (time.perf_counter() - t0)
    emit("train_device_augment", nvidia_smi=smi, model="v11-n", size=SIZE,
         batch=TRAIN_BATCH, dtype="bfloat16", images=DA_IMAGES, epochs=epochs,
         write_images_seconds=write_s, runs=runs, loader_alone_img_per_s=loader_rates,
         stager=loaders["device_mosaic"].stager)
    return dict(runs=runs, loader_alone_img_per_s=loader_rates)


_RANK_CHILD = r"""
import json, os, sys, time

import torch

from tpu_yolo_torch.cli import main as cli
from tpu_yolo_torch.ops import attention_cuda, nms_cuda, topk_cuda
from tpu_yolo_torch.parallel import mesh
from tpu_yolo_torch.train import trainer

out = {"rank": int(os.environ["RANK"]), "world": int(os.environ["WORLD_SIZE"])}
events, steps = [], []
reduce_fn, step_fn, test_fn = mesh._all_reduce, trainer.train_step, cli.run_test


def timed_reduce(t, *group):   # every all-reduce of the package, timed on the stream
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    r = reduce_fn(t, *group)
    end.record()
    events.append((start, end, t.numel() * t.element_size()))
    return r


def step_tap(*a, **kw):   # the trainer reads the losses next, so the sync moves no work
    first, t0 = len(events), time.perf_counter()
    losses = step_fn(*a, **kw)
    torch.cuda.synchronize()
    steps.append((losses, time.perf_counter() - t0, first, len(events)))
    return losses


def test_tap(*a, **kw):
    res = test_fn(*a, **kw)
    out["map_tuple"] = [float(v) for v in res]
    return res


mesh._all_reduce, trainer.train_step, cli.run_test = timed_reduce, step_tap, test_tap
for fn in (topk_cuda.topk_mask, attention_cuda.fused_attention, nms_cuda.greedy_keep):
    fn.launches = 0
t0 = time.perf_counter()
cli.main(sys.argv[1:])
torch.cuda.synchronize()
out["seconds"] = time.perf_counter() - t0
out["losses"] = [s[0].tolist() for s in steps]
out["step_ms"] = [s[1] * 1e3 for s in steps]
out["collectives"] = [b - a for _, _, a, b in steps]
out["collective_ms"] = [sum(s.elapsed_time(e) for s, e, _ in events[a:b])
                        for _, _, a, b in steps]
out["collective_bytes"] = [sum(n for _, _, n in events[a:b]) for _, _, a, b in steps]
out["launches"] = {"topk_mask": topk_cuda.topk_mask.launches,
                   "psa_attention": attention_cuda.fused_attention.launches,
                   "nms_greedy_keep": nms_cuda.greedy_keep.launches}
out["jax_imported"] = "jax" in sys.modules
print("RANK_RESULT " + json.dumps(out), flush=True)
"""


def _run_group(cmd, env=None, timeout=DP_TIMEOUT_S):
    """Run `cmd` in a session of its own and return (rc, stdout, stderr);
    at the time limit the whole session (torchrun's workers too) is
    killed and the phase fails."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"chip_smoke: {cmd[:6]} passed its {timeout} s limit")
    return proc.returncode, out, err


def _epoch_mean(losses):
    return np.asarray(losses, np.float64).mean(0)


def _data_parallel_phase(cfg, smi, state, imgs, launches, native_epoch, val_split):
    """Phase (t): data parallelism on the one card.

    t1: `python -m torch.distributed.run --nproc-per-node 1 ... -m` style
    runs of the CLI with --distributed (NCCL, one rank): one epoch of
    --train --device-augment on phase n's mini-COCO beside the plain
    trainer's epoch on the same data and seed (losses within 1e-3
    relative), then --test on phase j's val split beside the plain --test
    (mAP within 1e-6); top-k counted in the training rank, both eval
    kernels in the test rank; the collectives per step, counted and timed
    on the stream. t2: two gloo ranks sharing the card through
    `python -m tpu_yolo_torch.rehearsal` (v11-n, 640 px, f32, global batch
    16, 3 steps at lr 1e-3, --eval-ap) beside the one-process oracle, whose
    eval forwards the ranks' per-device batch (--local-devices 2), and
    two witnesses of f32 rounding, the oracle with its BatchNorm moments
    summed in the ranks' order and the oracle under cudnn.benchmark: ranks
    bit-equal, their losses within 2e-4 of the oracle and of the first
    witness at the first two steps and within 1e-2 relative at every step
    (each gap printed), mAP replicated, above 0 and within 1e-6, every
    kernel counted in every rank. t3: Detector(dp=make_mesh(devices=["cuda:0"]))
    bit-equal to the plain Detector at batch 128, two replicas on the card
    at f32 against the plain f32 Detector. t4: the preflight under
    torchrun, one rank, with --prewarm, beside t2."""
    import re
    import socket

    import torch

    from tpu_yolo_torch import make_mesh
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, nms_cuda
    from tpu_yolo_torch.serve import Detector
    from tpu_yolo_torch.train import trainer

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- t1: one NCCL rank through the CLI --------------------------
        # phase n's mini-COCO, phase j's val split, weights and plain --test
        coco, _ = _mini_coco()
        val, ckpt, plain_map = val_split["root"], val_split["ckpt"], val_split["map_tuple"]
        child = os.path.join(tmp, "rank_child.py")
        with open(child, "w") as f:
            f.write(_RANK_CHILD)
        train_argv = ["--train", "--device-augment", "--data-dir", coco,
                      "--input-size", str(SIZE), "--batch-size", str(TRAIN_BATCH),
                      "--epochs", "1", "--workers", "8", "--seed", str(SEED)]
        test_argv = ["--test", "--weights", ckpt, "--data-dir", val, "--input-size",
                     str(SIZE), "--val-batch-size", str(EVAL_BATCH), "--workers", "8"]

        def rank(argv, save):
            rc, stdout, err = _run_group(torchrun + [child, *argv, "--distributed",
                                                     "--save-dir", save], env)
            print(stdout, flush=True)
            check(rc == 0, f"torchrun {argv[0]} --distributed: rc {rc}: {err[-3000:]}")
            res = [json.loads(ln[len("RANK_RESULT "):]) for ln in stdout.splitlines()
                   if ln.startswith("RANK_RESULT ")]
            check(len(res) == 1 and res[0]["world"] == 1 and not res[0]["jax_imported"],
                  f"torchrun {argv[0]}: {res}")
            return res[0], stdout.splitlines()

        dist_train, dist_lines = rank(train_argv, os.path.join(tmp, "w_dist"))
        dist_test, _ = rank(test_argv, os.path.join(tmp, "w_test"))

        plain_steps, plain_ms, step_fn = [], [], trainer.train_step

        def step_tap(*a, **kw):   # timed as in the rank
            t0 = time.perf_counter()
            losses = step_fn(*a, **kw)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            plain_steps.append(losses.tolist())
            return losses

        trainer.train_step = step_tap
        try:
            plain_lines = _cli([*train_argv, "--save-dir", os.path.join(tmp, "w_plain")])
        finally:
            trainer.train_step = step_fn
        print("\n".join(plain_lines), flush=True)

        steps = DA_IMAGES // TRAIN_BATCH
        dist_mean, plain_mean = _epoch_mean(dist_train["losses"]), _epoch_mean(plain_steps)
        loss_rel = np.abs(dist_mean - plain_mean) / np.abs(plain_mean)
        map_err = max(abs(a - b) for a, b in zip(dist_test["map_tuple"], plain_map))

        def rate(lines):
            m = [re.search(r"s, ([\d.]+) img/s\)", ln) for ln in lines
                 if ln.startswith("epoch ")]
            return float(m[-1].group(1)) if m and m[-1] else None

        warm = slice(1, None)   # the rank's first step pays its process's warm-up
        out["t1"] = dict(
            steps=steps, losses_distributed=dist_train["losses"],
            losses_plain=plain_steps, epoch_mean_distributed=dist_mean.tolist(),
            epoch_mean_plain=plain_mean.tolist(), epoch_loss_rel_err=loss_rel.tolist(),
            epoch_img_per_s_distributed=rate(dist_lines),
            epoch_img_per_s_plain=rate(plain_lines),
            phase_s_plain_trainer_epoch=native_epoch,
            map_tuple_distributed=dist_test["map_tuple"], map_tuple_plain=plain_map,
            map_max_abs_err=map_err, train_rank_launches=dist_train["launches"],
            test_rank_launches=dist_test["launches"],
            step_ms_distributed=dist_train["step_ms"], step_ms_plain=plain_ms,
            warm_step_ms_distributed=float(np.mean(dist_train["step_ms"][warm])),
            warm_step_ms_plain=float(np.mean(plain_ms[warm])),
            collectives_per_step=dist_train["collectives"],
            collective_ms_per_step=dist_train["collective_ms"],
            warm_collective_ms_per_step=float(np.mean(dist_train["collective_ms"][warm])),
            collective_mb_per_step=[b / 1e6 for b in dist_train["collective_bytes"]],
            train_rank_s=dist_train["seconds"], test_rank_s=dist_test["seconds"])
        print(f"t1 mAP tuple: --test --distributed {dist_test['map_tuple']}, "
              f"plain --test {plain_map}", flush=True)
        check(len(dist_train["losses"]) == len(plain_steps) == steps
              and float(loss_rel.max()) <= DP_EPOCH_LOSS_RTOL,
              f"t1 epoch losses: {out['t1']}")
        check(map_err <= 1e-6 and plain_map[0] > 0, f"t1 mAP: {out['t1']}")
        check(dist_train["launches"]["topk_mask"] >= steps
              and min(dist_test["launches"][k] for k in
                      ("psa_attention", "nms_greedy_keep")) > 0,
              f"t1 kernel launches: {out['t1']}")
        launches["dp_train_rank_topk"] = dist_train["launches"]["topk_mask"]
        launches["dp_test_rank"] = dist_test["launches"]

        # -- t2: two gloo ranks sharing the card, and one process ---------
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        # lr 1e-3: at the JAX rehearsal's 0.01 three steps of v11-n from
        # its init amplify f32 rounding a hundredfold a step, so that a
        # correct run and one whose BatchNorm backward skips its all-reduce
        # both end 1e-2 from the oracle (v11-n at 320 px on the CPU); at
        # 1e-3 the correct run ends 5.5e-5 from it and the broken one 1.6e-2
        common = ["--device", "cuda", "--model", "n", "--size", str(SIZE),
                  "--global-batch", str(DP_GLOBAL_BATCH), "--steps", str(DP_STEPS),
                  "--lr", "1e-3"]
        worker = [sys.executable, "-m", "tpu_yolo_torch.rehearsal"]
        oracle_argv = ["--local-devices", "2", *common]
        # f32 means f32: no TF32 in cuDNN or cuBLAS in these processes
        env32 = dict(env, NVIDIA_TF32_OVERRIDE="0")
        # -- t4, the preflight (one NCCL rank), runs beside t2 -------------
        preflight = torchrun + ["-m", "tpu_yolo_torch.preflight", "--batch-size",
                                str(TRAIN_BATCH), "--input-size", str(SIZE), "--data-dir",
                                coco, "--prewarm"]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(6) as pool:
            t4_run = pool.submit(_run_group, preflight, env)
            runs = list(pool.map(lambda cmd: _run_group(cmd, env32), [
                worker + ["--num-processes", "2", "--process-id", str(i), "--init-method",
                          f"tcp://localhost:{port}", "--backend", "gloo", "--eval-ap",
                          *common] for i in range(2)]
                + [worker + ["--eval-ap", *oracle_argv],
                   [sys.executable, "-c", _ORACLE_HALVES_BN, *oracle_argv],
                   [sys.executable, "-c", _ORACLE_CUDNN_BENCHMARK, *oracle_argv]]))
            t2_s = time.perf_counter() - t0
            t4_run = t4_run.result()
        res = []
        for rc, stdout, err in runs:
            check(rc == 0, f"t2 rehearsal rc {rc}: {err[-3000:]}")
            res.append(json.loads(stdout.strip().splitlines()[-1]))
        ranks, oracle, halves, benchmark = res[:2], res[2], res[3], res[4]
        mine = np.asarray(ranks[0]["losses"])

        def rel(losses, to):
            want = np.asarray(to["losses"])
            return (np.abs(np.asarray(losses) - want) / np.abs(want)).max(1).tolist()

        def close(to, steps):
            want = np.asarray(to["losses"])[:steps]
            return (np.allclose(mine[:steps], want, rtol=DP_LOSS_TOL, atol=DP_LOSS_TOL)
                    and max(rel(mine, to)) <= DP_LATE_RTOL)

        out["t2"] = dict(seconds=t2_s, ranks=ranks, oracle=oracle,
                         oracle_halves_bn=halves, oracle_cudnn_benchmark=benchmark,
                         losses_rel_err_per_step=rel(mine, oracle),
                         halves_bn_rel_err_per_step=rel(mine, halves),
                         halves_bn_oracle_rel_err_per_step=rel(halves["losses"], oracle),
                         cudnn_benchmark_oracle_rel_err_per_step=rel(benchmark["losses"],
                                                                     oracle),
                         gated_steps=DP_GATED_STEPS, late_rtol=DP_LATE_RTOL,
                         map_abs_err=abs(ranks[0]["map"] - oracle["map"]))
        print("t2 relative loss gap per step: ranks to the one process "
              f"{out['t2']['losses_rel_err_per_step']}, ranks to the one process "
              f"with the ranks' BatchNorm order {out['t2']['halves_bn_rel_err_per_step']}, "
              "the one process under cudnn.benchmark to the one process "
              f"{out['t2']['cudnn_benchmark_oracle_rel_err_per_step']}", flush=True)
        check(ranks[0]["losses"] == ranks[1]["losses"]
              and ranks[0]["state_sha256"] == ranks[1]["state_sha256"],
              f"t2 ranks differ: {out['t2']}")
        check(close(halves, DP_GATED_STEPS) and close(oracle, DP_GATED_STEPS),
              f"t2 losses against one process: {out['t2']}")
        check(ranks[0]["map"] == ranks[1]["map"] and oracle["map"] > 0
              and abs(ranks[0]["map"] - oracle["map"]) <= 1e-6
              and abs(ranks[0]["map50"] - oracle["map50"]) <= 1e-6,
              f"t2 mAP: {out['t2']}")
        check(all(min(r["launches"].values()) > 0 for r in ranks),
              f"t2 a kernel did not run in a rank: {[r['launches'] for r in ranks]}")
        launches["dp_rehearsal_ranks"] = [r["launches"] for r in ranks]

        # -- t4: the preflight's verdict ---------------------------------
        rc, stdout, err = t4_run
        print(stdout, flush=True)
        verdict = json.loads(stdout.strip().splitlines()[-1]) if stdout.strip() else {}
        out["t4"] = dict(rc=rc, verdict=verdict,
                         lines=[ln for ln in stdout.splitlines() if ln.startswith("[")])
        check(rc == 0 and verdict.get("ok") and set(verdict["checks"]) == {
            "rendezvous", "devices", "topology", "batch", "gt_bucket", "prewarm"}
              and all(verdict["checks"].values()), f"t4 preflight: {out['t4']} {err[-2000:]}")

    # -- t3: Detector(dp=...) on the card ----------------------------------
    def counted(fn):
        attention_cuda.fused_attention.launches = 0
        nms_cuda.greedy_keep.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, {"psa_attention": attention_cuda.fused_attention.launches,
                     "nms_greedy_keep": nms_cuda.greedy_keep.launches}

    plain = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
    one = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE,
                   dp=make_mesh(devices=["cuda:0"]))
    want = plain.detect_batch(imgs)
    got, one_launches = counted(lambda: one.detect_batch(imgs))
    one_equal = all(torch.equal(got[k], want[k]) for k in want)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(input_size=SIZE, compute_dtype=torch.float32)
        plain32 = Detector(YOLO.from_state_dict(cfg, state), device="cuda", **kw)
        two = Detector(YOLO.from_state_dict(cfg, state),
                       dp=make_mesh(devices=["cuda:0", "cuda:0"]), **kw)
        want32 = {k: v.cpu() for k, v in plain32.detect_batch(imgs).items()}
        got32, two_launches = counted(lambda: two.detect_batch(imgs))
        got32 = {k: v.cpu() for k, v in got32.items()}
        t0 = time.perf_counter()
        for _ in range(5):
            two.detect_batch(imgs)
        torch.cuda.synchronize()
        two_img_s = 5 * BATCH / (time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    valid = want32["valid"]
    box_err = float((got32["boxes"] - want32["boxes"])[valid].abs().max())
    out["t3"] = dict(
        batch=BATCH, one_replica_bit_equal=one_equal, one_replica_launches=one_launches,
        two_replicas_counts_equal=torch.equal(got32["count"], want32["count"]),
        two_replicas_classes_equal=torch.equal(got32["classes"], want32["classes"]),
        two_replicas_max_box_err_px=box_err, two_replicas_launches=two_launches,
        two_replicas_f32_img_per_s=two_img_s,
        detections=int(want32["count"].sum()))
    check(one_equal and min(one_launches.values()) > 0, f"t3 one replica: {out['t3']}")
    check(out["t3"]["two_replicas_counts_equal"] and out["t3"]["two_replicas_classes_equal"]
          and torch.allclose(got32["boxes"][valid], want32["boxes"][valid], **DP_BOX_TOL)
          and min(two_launches.values()) > 0, f"t3 two replicas: {out['t3']}")
    launches["dp_detector"] = two_launches
    emit("data_parallel", nvidia_smi=smi, model="v11-n", size=SIZE,
         thresholds=dict(t1_epoch_loss_rtol=DP_EPOCH_LOSS_RTOL, t1_map_abs=1e-6,
                         t2_loss_tol=DP_LOSS_TOL, t2_gated_steps=DP_GATED_STEPS,
                         t2_late_rtol=DP_LATE_RTOL,
                         t2_map_abs=1e-6, t3_box_tol=DP_BOX_TOL),
         **out)


_PARALLEL_CHILD = r"""
import contextlib, io, json, sys, time, types

import torch

from tpu_yolo_torch import rehearsal
from tpu_yolo_torch.ops import attention_cuda, blocks, nms, nms_cuda, nn, topk_cuda
from tpu_yolo_torch.parallel import mesh, spatial
from tpu_yolo_torch.train import loss, step

config = json.loads(sys.argv[1])
events, steps, tag, run = [], [], ["setup"], {"name": "", "size": 0}
plain_forward, plain_partition = nn.ConvBN.forward, spatial.partition_spatial


# ConvBN.forward with each conv that --min-channels splits over two ranks
# computed as its two halves of output channels side by side, in one
# process: the ranks' arithmetic (a depthwise half reads its input
# channels; autograd sums the two halves' input gradients, as
# copy_model's all-reduce does) without the process group
def split_forward(min_channels):
    def forward(self, x, residual=None, halves=False):
        o = self.w.shape[0]
        if o < min_channels or o % 2:
            return plain_forward(self, x, residual, halves)
        outs = []
        for keep in (slice(0, o // 2), slice(o // 2, o)):
            half = types.SimpleNamespace(
                w=self.w[keep], stride=self.stride, padding=self.padding, act=self.act,
                groups=self.groups // 2 if self.groups > 1 else 1, training=self.training,
                quantized=False, spatial=None, folded=self.folded)
            for leaf in ("b",) if self.folded else ("gamma", "beta", "mean", "var"):
                setattr(half, leaf, getattr(self, leaf)[keep])
            for name in ("_conv", "_window", "_run", "_train_norm"):
                setattr(half, name, types.MethodType(getattr(nn.ConvBN, name), half))
            outs.append(nn.ConvBN._forward(half, x[:, keep] if self.groups > 1 else x))
        return nn._plus(residual, torch.cat(outs, 1), halves)
    return forward


# The spatial ranks' arithmetic in one process: each conv outside the PSA
# block run on the two ranks' rows of its input (spatial.Shards: whole
# blocks of 32 image rows, the first rank's share rounded up), each with
# the rows its window reads beyond them (zeros past the map's edges),
# side by side
def rows_forward(self, x, residual=None, halves=False):
    if not getattr(self, "in_halves", False):
        return plain_forward(self, x, residual, halves)
    k, s = self.w.shape[2], self.stride
    (top, _), lr = nn._pads(self.padding)
    bottom = max(k - top - s, 0)
    first = spatial.Shards.of(run["size"], run["size"], 2).rows(x.shape[3])[0]
    padded = torch.nn.functional.pad(x, (0, 0, top, bottom))
    view = types.SimpleNamespace(
        w=self.w, stride=s, padding=((0, 0), lr), act=self.act, groups=self.groups,
        training=self.training, quantized=False, spatial=None, folded=True, b=self.b)
    for name in ("_conv", "_window", "_run"):
        setattr(view, name, types.MethodType(getattr(nn.ConvBN, name), view))
    return nn._plus(residual, torch.cat([nn.ConvBN._forward(view, padded[
        :, :, lo:hi + top + bottom].contiguous(memory_format=torch.channels_last))
        for lo, hi in ((0, first), (first, x.shape[2]))], 2), halves)


def mark_halves(model, mesh):   # in partition_spatial's place, on one rank
    def mark(m):
        if isinstance(m, nn.ConvBN):
            m.in_halves = True
        if not isinstance(m, blocks.PSA):
            for child in m.children():
                mark(child)
    mark(model)
    return model
captured = {"attention": {}, "topk": [], "nms": {}}
collectives = mesh._all_reduce, mesh._all_gather, mesh._broadcast
step_fn, attn_fn, topk_fn = step.train_step, blocks.fused_attention, loss.topk_mask
keep_fn = nms.greedy_keep


def timed(fn, at, group_at):   # every collective of the package, timed on the stream
    def call(*a):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        r = fn(*a)
        end.record()
        t, group = a[at], a[group_at] if len(a) > group_at else None
        events.append((tag[0], mesh.axis_name(group), t.numel() * t.element_size(),
                       start, end))
        return r
    return call


def step_tap(*a, **kw):   # the rehearsal reads the losses next: the sync moves no work
    tag[0] = f"step{len(steps) + 1}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = step_fn(*a, **kw)
    torch.cuda.synchronize()
    steps.append((time.perf_counter() - t0) * 1e3)
    tag[0] = "other"
    return losses


def attn_tap(q, k, v, scale):
    if q.shape[1] == config.get("attn_t", 1600):
        captured["attention"].setdefault(str(q.dtype).split(".")[1], (q, k, v, scale))
    return attn_fn(q, k, v, scale)


def keep_tap(boxes, cls, valid, thr):   # each run's first greedy keep
    captured["nms"].setdefault(run["name"], (boxes, cls, valid, thr))
    return keep_fn(boxes, cls, valid, thr)


def topk_tap(x, k):
    captured["topk"].append(x)
    return topk_fn(x, k)


mesh._all_reduce, mesh._all_gather, mesh._broadcast = (
    timed(fn, at, group_at) for fn, (at, group_at) in zip(collectives, ((0, 1), (1, 2), (0, 2))))
step.train_step, blocks.fused_attention, loss.topk_mask = step_tap, attn_tap, topk_tap
nms.greedy_keep = keep_tap
out = {"runs": {}}
for name, argv in config["runs"].items():
    run.update(name=name, size=int(argv[argv.index("--spatial-size") + 1])
               if "--spatial-size" in argv else 0)
    for fn in (topk_cuda.topk_mask, attention_cuda.fused_attention, nms_cuda.greedy_keep):
        fn.launches = 0
    events.clear()
    steps.clear()
    tag[0] = "setup"
    t0 = time.perf_counter()
    text = io.StringIO()
    # the witnesses (*_split): the ranks' arithmetic in one process
    if name == "sp_split" or name.endswith("_rows"):
        nn.ConvBN.forward, spatial.partition_spatial = rows_forward, mark_halves
    elif name.endswith("_split"):
        nn.ConvBN.forward = split_forward(int(argv[argv.index("--min-channels") + 1]))
    with contextlib.redirect_stdout(text):
        rehearsal.main(argv)
    torch.cuda.synchronize()
    nn.ConvBN.forward, spatial.partition_spatial = plain_forward, plain_partition
    line = json.loads(text.getvalue().strip().splitlines()[-1])
    timed_by = {}
    for tg, axis, nbytes, start, end in events:
        d = timed_by.setdefault(tg, {}).setdefault(axis, {"calls": 0, "mb": 0.0, "ms": 0.0})
        d["calls"] += 1
        d["mb"] += nbytes / 1e6
        d["ms"] += start.elapsed_time(end)
    line.update(seconds=time.perf_counter() - t0, step_ms=list(steps),
                collectives_timed=timed_by)
    out["runs"][name] = line
# the kernels against their plain versions at the inputs the runs gave them
# (after the counts were read)
out["topk_bit_equal"] = [bool(torch.equal(topk_cuda.topk_mask(x, 10),
                                          topk_cuda.topk_mask_plain(x, 10)))
                         for x in captured["topk"]]
out["nms_bit_equal"] = {name: bool(torch.equal(nms_cuda.greedy_keep(*a),
                                               nms_cuda.greedy_keep_plain(*a)))
                        for name, a in captured["nms"].items()}
out["attention"] = {}
for dtype, (q, k, v, scale) in captured["attention"].items():
    got, want = (f(q, k, v, scale).float() for f in (attention_cuda.fused_attention,
                                                     attention_cuda.attention_plain))
    tol, err = config["attn_tol"][dtype], (got - want).abs()
    out["attention"][dtype] = dict(shape=[list(q.shape), list(v.shape)],
                                   max_abs_err=float(err.max()),
                                   ok=bool((err <= tol + tol * want.abs()).all()))
    if dtype == "float32":   # each one's distance from the exact (f64) result
        exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) * scale, -1) @ v.double()
        out["attention"][dtype].update(
            kernel_to_exact=float((got.double() - exact).abs().max()),
            plain_to_exact=float((want.double() - exact).abs().max()))
if config["save"] and "bfloat16" in captured["attention"]:
    q, k, v, scale = captured["attention"]["bfloat16"]
    torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "scale": scale}, config["save"])
out["jax_imported"] = "jax" in sys.modules
print("PARALLEL_RESULT " + json.dumps(out), flush=True)
"""


def _tensor_spatial_phase(cfg, smi, captured, launches):
    """Phase (u): tensor and spatial parallelism on the one card.

    One process with no group (the oracle), then two gloo ranks sharing
    the card (`_PARALLEL_CHILD` around `python -m tpu_yolo_torch.rehearsal`
    runs; f32 without TF32). u1: v11-n at 640 px on the rehearsal's
    seeded global batch of TP_GLOBAL_BATCH at lr 1e-3, on a (data 1,
    model 2) mesh at --min-channels 256 for TP_STEPS steps (writing a
    .ckpt), then one step at 64 with accumulate 2 (the JAX dryrun's form):
    the ranks' losses and states bit-equal, the first step's losses
    within TP_LOSS_RTOL of the oracle's and the state after it within
    TP_STATE_TOL of the oracle's or, tensor by tensor, of the witness
    that splits the same convs in one process, the .ckpt read back into
    a plain YOLO holding the ranks' state bit for bit, top-k launched once per
    micro-step in each rank and bit-equal to its plain version on the
    inputs it had. u2: v11-n's seeded serving weights, folded, on
    TP_GLOBAL_BATCH seeded SP_SIZE px images on a (data 1, spatial 2)
    mesh: the f32 class scores within SP_F32_TOL of the unsharded
    forward's, and the whole output within it of the oracle's or of the
    witness that runs each conv in two halves of rows, the bf16
    detections after the port's NMS matched both ways at SP_BF16_MATCH,
    the attention kernel launched in each rank at the gathered p5 map's
    (16, 1600) and held against its plain version. Prints the
    collectives by axis and step (calls, MB, ms by CUDA events) and the
    step and forward times, ranks against the oracle; the times are of
    two processes sharing the card against one alone."""
    import torch

    from tpu_yolo_torch.io.checkpoint import load_checkpoint
    from tpu_yolo_torch.io.weights import from_jax_params, train_state_from_jax
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops.nms import batched_nms
    from tpu_yolo_torch.rehearsal import state_digest

    root = os.path.dirname(os.path.abspath(__file__))
    env32 = dict(os.environ, PYTHONPATH=root, NVIDIA_TF32_OVERRIDE="0")
    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        child = os.path.join(tmp, "parallel_child.py")
        with open(child, "w") as f:
            f.write(_PARALLEL_CHILD)
        common = ["--device", "cuda", "--model", "n", "--size", str(SIZE),
                  "--global-batch", str(TP_GLOBAL_BATCH), "--lr", "1e-3"]
        ckpt = os.path.join(tmp, "tp.ckpt")

        def runs(who, group):
            """The rehearsal's argv of each run; `group` gives a rank's
            process-group arguments for a run, None for the oracle."""
            tp = ["--n-model", "2"] if group else []
            group = group or (lambda run: [])
            argvs = {
                "tp256": [*common, *group("tp256"), "--steps", str(TP_STEPS), *tp,
                          "--min-channels", "256", *(["--ckpt", ckpt] if tp else [])],
                "tp64": [*common, *group("tp64"), "--steps", "1", "--accumulate", "2", *tp,
                         "--min-channels", "64"],
                "sp": [*common, *group("sp"), "--steps", "0",
                       "--n-spatial", "2" if tp else "1", "--spatial-size", str(SP_SIZE),
                       "--spatial-dtype", "float32", "--spatial-dtype", "bfloat16"]}
            if not tp:   # the oracle's witnesses
                argvs.update({f"{run}_split": argv for run, argv in argvs.items()})
            return {run: [*argv, "--dump", os.path.join(tmp, who, run)]
                    for run, argv in argvs.items()}

        def command(who, group):
            config = {"runs": runs(who, group), "attn_tol": ATTN_TOL,
                      "save": os.path.join(tmp, f"attn_{who}.pt")}
            return [sys.executable, child, json.dumps(config)]

        def group_of(rank):
            return lambda run: ["--num-processes", "2", "--process-id", str(rank),
                                "--init-method", f"file://{tmp}/init_{run}",
                                "--backend", "gloo"]

        # the oracle alone, then the two ranks together
        t0 = time.perf_counter()
        oracle = _parallel_result("u", *_run_group(command("oracle", None), env32,
                                                   U_TIMEOUT_S), "oracle")
        oracle_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            ranks = list(pool.map(lambda r: _run_group(
                command(f"rank{r}", group_of(r)), env32, U_TIMEOUT_S), range(2)))
        ranks = [_parallel_result("u", *r, f"rank {i}") for i, r in enumerate(ranks)]
        ranks_s = time.perf_counter() - t0

        # -- u1: tensor parallel -------------------------------------------
        u1 = {}
        for run, steps in (("tp256", TP_STEPS), ("tp64", 1)):
            mine = [r["runs"][run] for r in ranks]
            one = oracle["runs"][run]
            rel = (np.abs(np.asarray(mine[0]["losses"]) - np.asarray(one["losses"]))
                   / np.abs(np.asarray(one["losses"]))).max(1).tolist()
            got = np.load(os.path.join(tmp, "rank0", run, "rank0.npz"))
            want = np.load(os.path.join(tmp, "oracle", run, "rank0.npz"))
            split = np.load(os.path.join(tmp, "oracle", f"{run}_split", "rank0.npz"))
            worst, off = {}, []
            for key in want.files:
                kind = key.split("/")[0]
                if kind in ("param", "momentum", "ema", "grad"):
                    ratios = [float((np.abs(got[key] - ref[key])
                                     / (TP_STATE_TOL["atol"] + TP_STATE_TOL["rtol"]
                                        * np.abs(ref[key]))).max()) for ref in (want, split)]
                    if ratios[0] > worst.get(kind, (0.0,))[0]:
                        worst[kind] = (ratios[0], key, float(np.abs(got[key] - want[key]).max()),
                                       ratios[1], float(np.abs(split[key] - want[key]).max()))
                    if kind != "grad" and min(ratios) > 1.0:
                        off.append(key)
            convs = sorted({n.rsplit(".", 1)[0] for n in mine[0]["sharded"]})
            u1[run] = dict(
                coords=[m["coords"] for m in mine], split_convs=len(convs),
                split_params=sum(int(np.prod(got[f"param/{n}"].shape))
                                 for n in mine[0]["sharded"] if f"param/{n}" in got.files),
                losses_ranks=mine[0]["losses"], losses_oracle=one["losses"],
                losses_rel_err_per_step=rel, gated_steps=1,
                state_worst_over_tol={k: dict(ratio=v[0], key=v[1], max_abs=v[2],
                                              ratio_to_split_witness=v[3],
                                              split_witness_max_abs=v[4])
                                      for k, v in worst.items()},
                state_off_both=off,
                topk_launches=[m["launches"]["topk_mask"] for m in mine],
                step_ms_ranks=[m["step_ms"] for m in mine], step_ms_oracle=one["step_ms"],
                collectives_by_step=mine[0]["collectives_timed"],
                rank_seconds=[m["seconds"] for m in mine], oracle_seconds=one["seconds"])
            check(mine[0]["losses"] == mine[1]["losses"]
                  and mine[0]["state_sha256"] == mine[1]["state_sha256"],
                  f"u1 {run}: the ranks differ: {u1[run]}")
            check(rel[0] <= TP_LOSS_RTOL, f"u1 {run}: step-1 losses: {u1[run]}")
            check(not off, f"u1 {run}: the state after step 1: {u1[run]}")
            check(u1[run]["topk_launches"] == [steps, steps],
                  f"u1 {run}: top-k launches per micro-step: {u1[run]}")
        check(u1["tp256"]["split_convs"] == 11 and u1["tp64"]["split_convs"] == 70,
              f"u1 split convs at 256 and 64: {u1}")
        check(all(all(r["topk_bit_equal"]) and len(r["topk_bit_equal"]) == TP_STEPS + 1
                  for r in ranks), f"u1 top-k vs plain: {[r['topk_bit_equal'] for r in ranks]}")
        payload = load_checkpoint(ckpt)
        plain = YOLO.from_state_dict(cfg, from_jax_params(payload["params"], cfg))
        restored = train_state_from_jax(payload, cfg, "cuda")
        u1["ckpt"] = dict(step=int(payload["step"]), params=sum(
            p.numel() for p in plain.parameters()),
            digest_equal=state_digest(restored) == ranks[0]["runs"]["tp256"]["state_sha256"])
        check(u1["ckpt"]["step"] == TP_STEPS and u1["ckpt"]["digest_equal"],
              f"u1 .ckpt: {u1['ckpt']}")

        # -- u2: spatial ---------------------------------------------------
        mine = [r["runs"]["sp"] for r in ranks]
        one = oracle["runs"]["sp"]
        got = np.load(os.path.join(tmp, "rank0", "sp", "rank0.npz"))
        want = np.load(os.path.join(tmp, "oracle", "sp", "rank0.npz"))
        split = np.load(os.path.join(tmp, "oracle", "sp_split", "rank0.npz"))
        f32, f32_split = want[f"spatial/{SP_KEY}float32"], split[f"spatial/{SP_KEY}float32"]
        f32_gap = np.abs(got[f"spatial/{SP_KEY}float32"] - f32)
        split_gap = np.abs(got[f"spatial/{SP_KEY}float32"] - f32_split)
        over = f32_gap > SP_F32_TOL["atol"] + SP_F32_TOL["rtol"] * np.abs(f32)
        f32_ok = (not over[..., 4:].any()
                  and bool(np.allclose(got[f"spatial/{SP_KEY}float32"], f32_split, **SP_F32_TOL)))
        with torch.inference_mode():
            dets = [batched_nms(torch.from_numpy(d[f"spatial/{SP_KEY}bfloat16"]).cuda())
                    for d in (got, want)]
        agree = [_agreement(_row(dets[0], i), _row(dets[1], i))
                 for i in range(TP_GLOBAL_BATCH)]
        fwd = lambda line, dt: line["spatial"]["forwards"][SP_KEY + dt]
        u2 = dict(
            coords=[m["spatial"]["coords"] for m in mine],
            rows_per_rank=fwd(mine[0], "float32")["rows"], shape=fwd(one, "float32")["shape"],
            f32_max_abs_err=dict(boxes=float(f32_gap[..., :4].max()),
                                 scores=float(f32_gap[..., 4:].max())),
            f32_values_over_tol=dict(boxes=int(over[..., :4].sum()),
                                     scores=int(over[..., 4:].sum())),
            f32_to_split_witness_max_abs_err=dict(
                boxes=float(split_gap[..., :4].max()), scores=float(split_gap[..., 4:].max())),
            f32_split_witness_to_oracle_max_abs_err=float(np.abs(f32_split - f32).max()),
            f32_ok=f32_ok,
            bf16_agreement=agree,
            launches=[m["spatial"]["launches"] for m in mine],
            oracle_launches=one["spatial"]["launches"],
            attention_vs_plain=[r["attention"] for r in ranks],
            forward_ms={dt: dict(ranks=[fwd(m, dt)["forward_ms"] for m in mine],
                                 unsharded=fwd(one, dt)["forward_ms"])
                        for dt in ("float32", "bfloat16")},
            halo_and_gather_mb_per_forward={
                dt: fwd(mine[0], dt)["collectives"]["spatial"]["bytes"] / 1e6
                for dt in ("float32", "bfloat16")},
            collective_calls_per_forward={
                dt: fwd(mine[0], dt)["collectives"]["spatial"]["calls"]
                for dt in ("float32", "bfloat16")},
            collectives_timed=mine[0]["collectives_timed"])
        check(fwd(mine[0], "float32")["shape"] == [TP_GLOBAL_BATCH, 33600, 4 + cfg.num_classes]
              and f32_ok, f"u2 f32 decoded output: {u2}")
        check(all(min(a["match"]) >= SP_BF16_MATCH for a in agree)
              and sum(a["count"][1] for a in agree) > 0, f"u2 bf16 detections: {u2}")
        check(all(m["spatial"]["launches"]["psa_attention"] > 0 for m in mine)
              and all(set(r["attention"]) == {"float32", "bfloat16"}
                      and all(a["ok"] and a["shape"][0] == [16, 1600, 32]
                              for a in r["attention"].values()) for r in ranks),
              f"u2 attention kernel in the ranks: {u2}")
        q = torch.load(os.path.join(tmp, "attn_rank0.pt"))
        captured["spatial_attention"] = tuple(
            q[k].cuda() for k in ("q", "k", "v")) + (q["scale"],)
        launches["tp_ranks_topk"] = {run: u1[run]["topk_launches"] for run in u1
                                     if run != "ckpt"}
        launches["sp_ranks"] = u2["launches"]
        launches["sp_attention_err"] = max(a["max_abs_err"] for r in ranks
                                           for a in r["attention"].values()
                                           if a["shape"][0] == [16, 1600, 32])
    out.update(u1=u1, u2=u2, oracle_seconds=oracle_s, ranks_seconds=ranks_s,
               phase_seconds=time.perf_counter() - t_phase)
    print(f"u1 losses, ranks vs oracle (relative, per step): "
          f"{ {r: u1[r]['losses_rel_err_per_step'] for r in ('tp256', 'tp64')} }; "
          f"u2 f32 max |err| {u2['f32_max_abs_err']} (to the witness in halves "
          f"{u2['f32_to_split_witness_max_abs_err']}), forward ms {u2['forward_ms']}",
          flush=True)
    emit("tensor_spatial_parallel", nvidia_smi=smi, model="v11-n", size=SIZE,
         spatial_size=SP_SIZE, global_batch=TP_GLOBAL_BATCH,
         thresholds=dict(u1_loss_rtol=TP_LOSS_RTOL, u1_state_tol=TP_STATE_TOL,
                         u2_f32_tol=SP_F32_TOL,
                         u2_f32_boxes="SP_F32_TOL of the oracle's or, everywhere, of "
                                      "the witness computing each conv in two halves of rows",
                         u2_bf16_match=SP_BF16_MATCH),
         **out)


def _parallel_result(phase: str, rc, stdout, err, what):
    """The PARALLEL_RESULT line of a `_PARALLEL_CHILD` run."""
    check(rc == 0, f"{phase} {what}: rc {rc}: {err[-3000:]}")
    res = [json.loads(ln[len("PARALLEL_RESULT "):]) for ln in stdout.splitlines()
           if ln.startswith("PARALLEL_RESULT ")]
    check(len(res) == 1 and not res[0]["jax_imported"], f"{phase} {what}: {stdout[-2000:]}")
    return res[0]


def _spatial_uneven_phase(cfg, smi, captured, launches, int8_state):
    """Phase (v): the configurations of the JAX package's meshes that PR
    10's port refused, on the one card. One process with no group (the
    oracle, and the witnesses that run each conv on the ranks' rows), then
    two gloo ranks sharing the card, each one `_PARALLEL_CHILD` around
    four rehearsal runs: v1 v11-n's seeded serving weights, folded, on
    TP_GLOBAL_BATCH seeded SPV_SIZE px images over (data 1, spatial 2), f32
    and bf16; v2 the f32 forward with the s2d stem; v3 phase p's int8
    weights in bf16 over the spatial axis (v3s) and split over a model
    axis of 2 at SPV_TP_MIN_CHANNELS on SIZE px images (v3t). Gates as set
    out beside SPV_SIZE; the greedy keep launched in every rank of every
    run and bit-equal to its plain version at each run's first input; the
    attention kernel launched in each rank at (16, SPV_ATTN_T) and held
    against its plain version there. Prints the rows per rank, the halo
    and gather MB and calls a forward, and the forward times of the ranks
    (two processes sharing the card) beside the oracle's."""
    import torch

    from tpu_yolo_torch.ops.nms import batched_nms

    root = os.path.dirname(os.path.abspath(__file__))
    env32 = dict(os.environ, PYTHONPATH=root, NVIDIA_TF32_OVERRIDE="0")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        child = os.path.join(tmp, "parallel_child.py")
        with open(child, "w") as f:
            f.write(_PARALLEL_CHILD)
        weights = os.path.join(tmp, "int8.pt")
        torch.save(int8_state, weights)
        common = ["--device", "cuda", "--model", "n", "--size", str(SIZE),
                  "--global-batch", str(TP_GLOBAL_BATCH), "--steps", "0"]
        at = ["--spatial-size", str(SPV_SIZE)]

        def command(who, rank):
            """The child's argv: the oracle's runs (rank None) or rank's."""
            group = (lambda run: []) if rank is None else (lambda run: [
                "--num-processes", "2", "--process-id", str(rank), "--init-method",
                f"file://{tmp}/init_{run}", "--backend", "gloo"])
            sp = ["--n-spatial", "1" if rank is None else "2"]
            runs = {"v1": [*sp, *at, "--spatial-dtype", "float32", "--spatial-dtype", "bfloat16"],
                    "v2": [*sp, *at, "--spatial-stem", "s2d"],
                    "v3s": [*sp, *at, "--weights", weights, "--spatial-dtype", "bfloat16"],
                    "v3t": [*(["--n-model", "2"] if rank is not None else []),
                            "--min-channels", str(SPV_TP_MIN_CHANNELS), "--split-forward",
                            "--weights", weights, "--spatial-size", str(SIZE),
                            "--spatial-dtype", "bfloat16"]}
            if rank is None:   # the witnesses of v1 and v2 in f32
                runs.update(v1_rows=[*sp, *at], v2_rows=runs["v2"])
            config = {"runs": {run: [*common, *group(run), *argv, "--dump",
                                     os.path.join(tmp, who, run)]
                               for run, argv in runs.items()},
                      "attn_tol": ATTN_TOL, "attn_t": SPV_ATTN_T,
                      "save": os.path.join(tmp, f"attn_{who}.pt")}
            return [sys.executable, child, json.dumps(config)]

        t0 = time.perf_counter()
        oracle = _parallel_result("v", *_run_group(command("oracle", None), env32,
                                                   V_TIMEOUT_S), "oracle")
        oracle_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            ranks = list(pool.map(lambda r: _run_group(command(f"rank{r}", r), env32,
                                                       V_TIMEOUT_S), range(2)))
        ranks = [_parallel_result("v", *r, f"rank {i}") for i, r in enumerate(ranks)]
        ranks_s = time.perf_counter() - t0

        def dump(who, run):
            return np.load(os.path.join(tmp, who, run, "rank0.npz"))

        out = {}
        # -- v1, v2: f32 against the oracle's scores and the rows witness
        for run, stem in (("v1", "plain"), ("v2", "s2d")):
            mine = [r["runs"][run]["spatial"] for r in ranks]
            one = oracle["runs"][run]["spatial"]
            fwd = lambda sec, dt: sec["forwards"][f"{stem}/{SPV_SIZE}/{dt}"]
            key = f"spatial/{stem}/{SPV_SIZE}/float32"
            got, want, witness = (dump(who, r)[key] for who, r in (
                ("rank0", run), ("oracle", run), ("oracle", f"{run}_rows")))
            gap, witness_gap = np.abs(got - want), np.abs(got - witness)
            over = gap > SP_F32_TOL["atol"] + SP_F32_TOL["rtol"] * np.abs(want)
            witness_over = witness_gap > SP_F32_TOL["atol"] + SP_F32_TOL["rtol"] * np.abs(witness)
            f32_ok = not (over & witness_over).any()
            dts = ("float32", "bfloat16") if run == "v1" else ("float32",)
            out[run] = dict(
                stem=stem, coords=[m["coords"] for m in mine],
                rows_per_rank=[fwd(m, "float32")["rows"] for m in mine],
                shape=fwd(one, "float32")["shape"],
                ranks_equal=len({fwd(m, "float32")["sha256"] for m in mine}) == 1,
                f32_max_abs_err=dict(boxes=float(gap[..., :4].max()),
                                     scores=float(gap[..., 4:].max())),
                f32_values_over_tol=dict(boxes=int(over[..., :4].sum()),
                                         scores=int(over[..., 4:].sum())),
                f32_values_over_tol_of_the_rows_witness=int(witness_over.sum()),
                f32_to_rows_witness_max_abs_err=dict(
                    boxes=float(witness_gap[..., :4].max()),
                    scores=float(witness_gap[..., 4:].max())),
                rows_witness_to_oracle_max_abs_err=float(np.abs(witness - want).max()),
                f32_ok=f32_ok,
                forward_ms={dt: dict(ranks=[fwd(m, dt)["forward_ms"] for m in mine],
                                     unsharded=fwd(one, dt)["forward_ms"]) for dt in dts},
                halo_and_gather_mb_per_forward={
                    dt: fwd(mine[0], dt)["collectives"]["spatial"]["bytes"] / 1e6 for dt in dts},
                collective_calls_per_forward={
                    dt: fwd(mine[0], dt)["collectives"]["spatial"]["calls"] for dt in dts},
                launches=[m["launches"] for m in mine], oracle_launches=one["launches"])
            check(out[run]["shape"] == fwd(mine[0], "float32")["shape"]
                  == [TP_GLOBAL_BATCH, sum((SPV_SIZE // st) ** 2 for st in (8, 16, 32)),
                      4 + cfg.num_classes]
                  and out[run]["ranks_equal"] and f32_ok, f"{run} f32 decoded output: {out[run]}")
        check(out["v1"]["rows_per_rank"] == [[TP_GLOBAL_BATCH, SPV_SIZE // 2]] * 2,
              f"v1 rows: {out['v1']['rows_per_rank']}")
        with torch.inference_mode():
            dets = [batched_nms(torch.from_numpy(
                dump(who, "v1")[f"spatial/plain/{SPV_SIZE}/bfloat16"]).cuda())
                for who in ("rank0", "oracle")]
        agree = [_agreement(_row(dets[0], i), _row(dets[1], i))
                 for i in range(TP_GLOBAL_BATCH)]
        out["v1"]["bf16_agreement"] = agree
        check(all(min(a["match"]) >= SP_BF16_MATCH for a in agree)
              and sum(a["count"][1] for a in agree) > 0, f"v1 bf16 detections: {agree}")

        # -- v3: int8 detections equal to the oracle's
        for run, section, key, size in (
                ("v3s", "spatial", f"plain/{SPV_SIZE}/bfloat16", SPV_SIZE),
                ("v3t", "split", f"plain/{SIZE}/bfloat16", SIZE)):
            mine = [r["runs"][run][section] for r in ranks]
            one = oracle["runs"][run][section]
            got, want = (dump(who, run)[f"{section}/{key}"] for who in ("rank0", "oracle"))
            with torch.inference_mode():
                dg, dw = (batched_nms(torch.from_numpy(a).cuda()) for a in (got, want))
            equal = all(torch.equal(dg[k], dw[k]) for k in dw)
            collectives = mine[0]["forwards"][key]["collectives"]
            out[run] = dict(
                size=size, coords=[m["coords"] for m in mine],
                rows_per_rank=[m["forwards"][key]["rows"] for m in mine],
                ranks_equal=len({m["forwards"][key]["sha256"] for m in mine}) == 1,
                raw_bit_equal=bool(np.array_equal(got, want)),
                raw_max_abs_err=float(np.abs(got.astype(np.float64) - want).max()),
                detections_equal=equal, detections=int(dw["count"].sum()),
                forward_ms=dict(ranks=[m["forwards"][key]["forward_ms"] for m in mine],
                                unsharded=one["forwards"][key]["forward_ms"]),
                collective_mb_per_forward={k: v["bytes"] / 1e6 for k, v in collectives.items()},
                collective_calls_per_forward={k: v["calls"] for k, v in collectives.items()},
                launches=[m["launches"] for m in mine], oracle_launches=one["launches"])
            check(equal and out[run]["ranks_equal"] and out[run]["detections"] > 0,
                  f"{run} int8 detections vs the one-process int8 forward: {out[run]}")

        # -- the kernels in the ranks
        for r in ranks + [oracle]:
            check(all(r["nms_bit_equal"].get(run) for run in ("v1", "v2", "v3s", "v3t")),
                  f"v greedy keep vs plain: {r['nms_bit_equal']}")
        for run in ("v1", "v2", "v3s", "v3t"):
            check(all(k["nms_greedy_keep"] > 0 and k["psa_attention"] > 0
                      for k in out[run]["launches"]), f"v {run} kernel launches: {out[run]}")
        check(all(a["ok"] and a["shape"][0] == [16, SPV_ATTN_T, 32]
                  for r in ranks for a in r["attention"].values())
              and all("bfloat16" in r["attention"] for r in ranks),
              f"v4 attention kernel in the ranks: {[r['attention'] for r in ranks]}")
        q = torch.load(os.path.join(tmp, "attn_rank0.pt"))
        captured["spatial_uneven_attention"] = tuple(
            q[k].cuda() for k in ("q", "k", "v")) + (q["scale"],)
        launches["v_ranks"] = {run: out[run]["launches"] for run in ("v1", "v2", "v3s", "v3t")}
        launches["v_attention_err"] = max(a["max_abs_err"] for r in ranks
                                          for a in r["attention"].values())
    out.update(attention_vs_plain=[r["attention"] for r in ranks],
               nms_vs_plain=[r["nms_bit_equal"] for r in ranks],
               oracle_seconds=oracle_s, ranks_seconds=ranks_s,
               phase_seconds=time.perf_counter() - t_phase)
    f32 = ("v1", "v2")
    print(f"v f32 max |err| to the oracle {[out[r]['f32_max_abs_err'] for r in f32]} "
          f"(to the rows witness {[out[r]['f32_to_rows_witness_max_abs_err'] for r in f32]}); "
          f"int8 detections equal {[out[r]['detections_equal'] for r in ('v3s', 'v3t')]}; "
          f"v1 forward ms {out['v1']['forward_ms']}", flush=True)
    emit("spatial_uneven_int8_parallel", nvidia_smi=smi, model="v11-n",
         spatial_size=SPV_SIZE, split_size=SIZE, global_batch=TP_GLOBAL_BATCH,
         thresholds=dict(f32_tol=SP_F32_TOL,
                         f32="every value within f32_tol of the oracle's or, where not, of "
                             "the witness running each conv on the ranks' rows",
                         bf16_match=SP_BF16_MATCH,
                         int8="detections after NMS equal to the one-process int8 forward's"),
         **out)


def _model_sizes_phase(smi, captured, launches, val_split):
    """Phase (x): every model size on the card through the entry points a
    user calls, each from its seeded serving weights (seeded.py).
    x1, each size: `Detector.detect_batch` at SIZE px, BATCH images,
    bf16, multi-label, K=1024: img/s, bs=1 p50 of `detect_one`, peak
    memory; both kernels counted in one batch with every count at 0 and
    held against their plain versions at its inputs; the attention's form
    at (BATCH x heads, 400); the forward's ms (CUDA events) beside its
    roofline bound and its device ms by stage (tpu_yolo_torch/roofline.py);
    for v11-x the f32 path card vs CPU on 2 images, phase f's criterion.
    x2, v11-x: `run_test` on phase j's split, twice (mAP; eval img/s of
    the second), the attention kernel once a batch in its resident form at
    (EVAL_BATCH x 6, 400), held against its plain version; the parity
    harness on the split in full (`--expect` the mAP just measured) and
    under `--max-images`. x3, v11-x: `train_step` at each remat level, the
    batch of MS_TRAIN_BATCHES that fits reckoned from the peak at the
    smallest, then confirmed and timed; one epoch of `trainer.train` on
    phase n's mini-COCO at the batch that fits without remat, top-k
    launched every step, finite losses; one f32 step card vs CPU at
    MS_F32_TRAIN_SIZE px. Fills captured["x_attention"],
    captured["x_eval_attention"] and launches["sizes"], launches["x_*"]."""
    import contextlib
    import io
    import re

    import torch

    from tpu_yolo_torch import parity_check, roofline
    from tpu_yolo_torch.cli import main as cli
    from tpu_yolo_torch.core.config import get_model_config, load_hyperparams
    from tpu_yolo_torch.eval import evaluator
    from tpu_yolo_torch.io.checkpoint import save_checkpoint
    from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.ops import attention_cuda, blocks, nms, nms_cuda, topk_cuda
    from tpu_yolo_torch.seeded import seeded_images, seeded_train_batch, serving_state
    from tpu_yolo_torch.serve import Detector
    from tpu_yolo_torch.train import trainer
    from tpu_yolo_torch.train.step import init_train_state, train_step

    t_phase = time.perf_counter()
    card, peak_flops, peak_bw = roofline.card_peaks()
    attn_fn, keep_fn = blocks.fused_attention, nms.greedy_keep
    tol = ATTN_TOL["bfloat16"]
    imgs = seeded_images(np.random.default_rng(SEED + 7), BATCH, SIZE)
    x_card = torch.from_numpy(imgs).cuda()
    t_attn = (SIZE // 32) ** 2

    def first_inputs():
        """Taps that keep each kernel's first inputs, and their undo."""
        first = {}

        def attn_tap(q, k, v, scale):
            first.setdefault("attention", (q, k, v, scale))
            return attn_fn(q, k, v, scale)

        def keep_tap(boxes, cls, valid, thr):
            first.setdefault("nms", (boxes, cls, valid, thr))
            return keep_fn(boxes, cls, valid, thr)

        attention_cuda.fused_attention.launches = 0
        nms_cuda.greedy_keep.launches = 0
        blocks.fused_attention, nms.greedy_keep = attn_tap, keep_tap
        return first

    def untap():
        blocks.fused_attention, nms.greedy_keep = attn_fn, keep_fn
        return {"attention": attention_cuda.fused_attention.launches,
                "nms": nms_cuda.greedy_keep.launches}

    def held(first, what):
        """Both kernels against their plain versions at `first`'s inputs:
        the attention within MS_ATTN_GATE (bf16), the keep bit for bit.
        Returns the attention's max error and the values past the bare
        1e-2 abs + rel."""
        q, k, v, scale = first["attention"]
        want = attention_cuda.attention_plain(q, k, v, scale).float()
        err = (attention_cuda.fused_attention(q, k, v, scale).float() - want).abs()
        p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, -1)
        steps = MS_P_STEP * torch.matmul(p, v.float().abs())
        bare = tol + tol * want.abs()
        check(q.dtype == torch.bfloat16 and bool((err <= bare + steps).all()),
              f"{what}: attention kernel vs plain, max err {float(err.max())}")
        boxes, cls, valid, thr = first["nms"]
        check(torch.equal(nms_cuda.greedy_keep(boxes, cls, valid, thr),
                          nms_cuda.greedy_keep_plain(boxes, cls, valid, thr)),
              f"{what}: NMS kernel vs plain")
        return float(err.max()), int((err > bare).sum())

    # -- x1: each size serves ---------------------------------------------
    serve_rows, launches["sizes"] = [], {}
    for size in MS_SIZES:
        cfg = get_model_config(size)
        heads = max(cfg.width[5] // 128, 1)
        state = serving_state(cfg, SEED, imgs[:16], "cuda")
        det = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
        for _ in range(2):
            det.detect_batch(imgs)
        torch.cuda.synchronize()
        first = first_inputs()
        try:
            res = det.detect_batch(imgs)
            torch.cuda.synchronize()
        finally:
            counted = untap()
        # one attention launch a PSA block (two in v11-l and v11-x)
        check(counted == {"attention": cfg.depth[4], "nms": 1},
              f"v11-{size}: kernel launches in a serving batch {counted}")
        launches["sizes"][size] = counted
        check(first["attention"][0].shape[:2] == (BATCH * heads, t_attn),
              f"v11-{size}: attention at {tuple(first['attention'][0].shape)}")
        attn_err, past_bare = held(first, f"v11-{size} serving")
        counts = res["count"].cpu()
        check(all(bool(torch.isfinite(v.float()).all()) for v in res.values()),
              f"v11-{size}: non-finite serving output")
        check(float((counts > 0).float().mean()) >= 0.9,
              f"v11-{size}: too few images with detections: {counts.tolist()}")

        iters = MS_SERVE_BATCHES.get(size, 5)
        t0 = time.perf_counter()
        for _ in range(iters):
            det.detect_batch(imgs)
        torch.cuda.synchronize()
        img_s = BATCH * iters / (time.perf_counter() - t0)
        p50 = _p50_ms(lambda: det.detect_one(imgs[0]))
        batch_gb = _peak_gb(lambda: det.detect_batch(imgs))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with torch.inference_mode():
            xin = x_card.to(torch.bfloat16) / 255
            fwd_ms = cuda_ms(lambda: det.model.forward_raw(xin), iters=5, warmup=1)
        by_stage = roofline.profile_stage_ms(det.model, xin, steps=2)
        rows = roofline.roofline_rows(
            roofline.stage_costs(roofline.trace_convs(size, SIZE, BATCH), False),
            peak_flops, peak_bw, by_stage)
        total = rows[-1]
        row = dict(model=f"v11-{size}", heads=heads,
                   attention_form=attention_cuda.kernel_form(BATCH * heads, t_attn),
                   launches_per_batch=counted, attention_max_abs_err=attn_err,
                   attention_values_past_bare_gate=past_bare,
                   img_per_s=img_s, timed_batches=iters, bs1_p50_ms=p50,
                   batch_peak_gb_beyond_live=batch_gb, peak_memory_gb=peak_gb,
                   count_mean=float(counts.float().mean()),
                   gflop_per_image=total["gflop"] / BATCH,
                   forward_ms=fwd_ms, forward_bound_ms=total["bound_ms"],
                   forward_bound_by=total["bound_by"],
                   forward_over_bound=fwd_ms / total["bound_ms"],
                   profiled_forward_ms=total["measured_ms"],
                   stages=[{k: r[k] for k in ("stage", "gflop", "mb", "bound_ms",
                                               "bound_by", "measured_ms")}
                           for r in rows[:-1]],
                   unattributed_ms=by_stage.get("(unattributed)", 0.0))
        if size == "x":
            captured["x_attention"] = first["attention"]
            launches["x_attention_err"] = attn_err
            x_state = state
            row["f32_card_vs_cpu"] = _f32_card_vs_cpu(cfg, state, imgs[:2])
        serve_rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "stages"}), flush=True)
        del det, res, first
        torch.cuda.empty_cache()
    emit("model_sizes_serve", nvidia_smi=smi, card=card, size=SIZE, batch=BATCH,
         dtype="bfloat16", max_nms=1024, multi_label=True,
         peaks=dict(bf16_flops=peak_flops, bytes_s=peak_bw), sizes=serve_rows)

    # -- x2: v11-x evaluates: run_test, then the parity harness -------------
    cfg = get_model_config("x")
    hyp = load_hyperparams()
    tmp = os.path.join(_work_dir(), "sizes")
    os.makedirs(tmp, exist_ok=True)
    ckpt = os.path.join(tmp, "v11x.ckpt")
    save_checkpoint(ckpt, {"params": to_jax_params(x_state)})
    root = val_split["root"]
    args = argparse.Namespace(
        weights=ckpt, save_dir=tmp, data_dir=root, input_size=SIZE,
        val_batch_size=EVAL_BATCH, workers=8, native_eval="auto",
        coco_metrics=False, plot=False, max_nms=2048, device="cuda")
    eval_fn, runs = evaluator.evaluate, []
    for _ in range(2):
        clock = {}

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return eval_fn(*a, **kw)
            finally:
                clock["evaluate"] = time.perf_counter() - t0

        out = io.StringIO()
        first = first_inputs()
        evaluator.evaluate = timed
        try:
            with contextlib.redirect_stdout(out):
                result = cli.run_test(args, hyp, cfg)
            torch.cuda.synchronize()
        finally:
            counted = untap()
            evaluator.evaluate = eval_fn
        runs.append(dict(first=first, counted=counted, result=[float(v) for v in result],
                         lines=out.getvalue().strip().splitlines(), **clock))
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    first = runs[0]["first"]
    eval_bh = first["attention"][0].shape[0]
    eval_form = attention_cuda.kernel_form(eval_bh, first["attention"][0].shape[1])
    check(all(r["counted"] == {"attention": batches * cfg.depth[4], "nms": batches}
              for r in runs),
          f"v11-x run_test kernel launches {[r['counted'] for r in runs]}, {batches} batches")
    check(eval_bh == EVAL_BATCH * 6 and eval_form == "resident",
          f"v11-x eval attention at {tuple(first['attention'][0].shape)}: {eval_form}")
    eval_err, eval_past_bare = held(first, "v11-x run_test")
    result = runs[0]["result"]
    check(all(np.isfinite(v) and 0 <= v <= 1 for v in result),
          f"v11-x run_test result {result}")
    captured["x_eval_attention"] = first["attention"]
    launches["x_eval"] = runs[0]["counted"]
    launches["x_eval_attention_err"] = eval_err

    def harness(*extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = parity_check.main([
                "--weights", ckpt, "--model-size", "x", "--data-dir", root,
                "--input-size", str(SIZE), "--val-batch-size", str(EVAL_BATCH),
                "--save-dir", tmp, "--expect", repr(result[0] * 100), "--tol", "0.5",
                "--device", "cuda", *extra])
        lines = out.getvalue().strip().splitlines()
        return dict(rc=rc, verdict=json.loads(lines[-1]))

    full, cut = harness(), harness("--max-images", str(MS_PARITY_MAX_IMAGES))
    check(full["rc"] == 0 and set(full["verdict"]) == PARITY_KEYS
          and full["verdict"]["pass"] is True and full["verdict"]["full_set"] is True
          and full["verdict"]["metric"] == f"coco_val_map_v11x_{SIZE}",
          f"parity harness, full split: {full}")
    check(cut["rc"] == 1 and set(cut["verdict"]) == PARITY_KEYS
          and cut["verdict"]["pass"] is False and cut["verdict"]["full_set"] is False,
          f"parity harness, --max-images: {cut}")
    emit("model_sizes_eval", nvidia_smi=smi, model="v11-x", size=SIZE,
         val_batch=EVAL_BATCH, dtype="bfloat16", max_nms=2048, images=EVAL_IMAGES,
         map_tuple=result, second_run_map_tuple=runs[1]["result"],
         loader=[ln for ln in runs[0]["lines"] if ln.startswith("[eval] loader: ")],
         certificate=[ln for ln in runs[0]["lines"] if ln.startswith("[eval] candidate")],
         launches_per_run=runs[0]["counted"],
         attention=dict(bh=eval_bh, t=first["attention"][0].shape[1], form=eval_form,
                        max_abs_err=eval_err, values_past_bare_gate=eval_past_bare),
         evaluate_s=[r["evaluate"] for r in runs],
         img_per_s=EVAL_IMAGES / runs[1]["evaluate"],
         parity_harness=dict(full=full, max_images=cut))
    del runs, first
    torch.cuda.empty_cache()

    # -- x3: v11-x trains ----------------------------------------------------
    gains = [hyp["box"], hyp["cls"], hyp["dfl"]]
    images, gt = (torch.from_numpy(a).cuda() for a in seeded_train_batch(
        np.random.default_rng(SEED), max(MS_TRAIN_BATCHES), SIZE))
    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(SEED, cfg), cfg))
    state = init_train_state(model.to(device="cuda", memory_format=torch.channels_last))
    card_bytes = torch.cuda.get_device_properties(0).total_memory

    def step(b, remat):
        return train_step(state, images[:b], gt[:b], 1e-4, gains, hyp["weight_decay"],
                          hyp["momentum"], cfg=cfg, remat=remat)

    small, levels = min(MS_TRAIN_BATCHES), {}
    for remat in MS_REMAT:
        step(small, remat)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(small, remat)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        reckoned = {b: base + (peak - base) * b / small for b in MS_TRAIN_BATCHES}
        fits = [b for b in MS_TRAIN_BATCHES if reckoned[b] <= MS_MEMORY_SHARE * card_bytes]
        check(bool(fits), f"v11-x train_step, remat {remat!r}: batch {small} takes "
                          f"{peak / 1e9:.2f} GB")
        levels[str(remat)] = dict(remat=remat, batch=max(fits), state_gb=base / 1e9,
                                  peak_gb_at_smallest=peak / 1e9,
                                  reckoned_gb={b: v / 1e9 for b, v in reckoned.items()})
    for lv in levels.values():
        b, remat = lv["batch"], lv["remat"]
        step(b, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        topk_cuda.topk_mask.launches = 0
        t0 = time.perf_counter()
        ms = cuda_ms(lambda: step(b, remat), iters=MS_TRAIN_STEPS, warmup=0)
        wall_ms = (time.perf_counter() - t0) * 1e3 / MS_TRAIN_STEPS
        losses = step(b, remat)
        check(bool(torch.isfinite(losses).all()) and topk_cuda.topk_mask.launches > 0,
              f"v11-x train_step at batch {b}, remat {remat!r}: losses "
              f"{losses.tolist()}, top-k launches {topk_cuda.topk_mask.launches}")
        lv.update(step_ms=ms, wall_ms_per_step=wall_ms, img_per_s=b / wall_ms * 1e3,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                  losses=losses.tolist(), topk_launches=topk_cuda.topk_mask.launches)
        check(lv["peak_gb"] * 1e9 <= card_bytes, f"v11-x train_step: {lv}")
    del state, model, images, gt
    torch.cuda.empty_cache()

    # one epoch through the entry point, at the batch that fits without remat
    batch = levels["False"]["batch"]
    data_dir, _ = _mini_coco()
    args = argparse.Namespace(
        model_size="x", input_size=SIZE, batch_size=batch, epochs=1,
        data_dir=data_dir, save_dir=os.path.join(tmp, "train_x"), resume="",
        weights="", workers=8, gt_bucket=0, remat=False, remat_level="stage",
        tensorboard=False, val_batch_size=EVAL_BATCH, native_eval="auto",
        max_nms=2048, seed=SEED)
    out = io.StringIO()
    topk_cuda.topk_mask.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = trainer.train(args, hyp, cfg, device="cuda")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    print("\n".join(lines), flush=True)
    steps = DA_IMAGES // batch
    launches["x_train_topk"] = topk_cuda.topk_mask.launches
    with open(os.path.join(args.save_dir, "step.csv")) as f:
        csv_rows = f.read().strip().splitlines()
    rates = [float(m.group(1)) for m in
             (re.search(r"s, ([\d.]+) img/s\)", ln) for ln in lines) if m]
    check(state.step == steps and launches["x_train_topk"] == steps and len(rates) == 1
          and len(csv_rows) == 2
          and all(np.isfinite(float(v)) for v in csv_rows[1].split(",")[1:]),
          f"v11-x epoch: {state.step} steps, {launches['x_train_topk']} top-k "
          f"launches, step.csv {csv_rows}, {lines}")
    del state
    torch.cuda.empty_cache()
    f32 = _train_f32_phase(cfg, torch.device("cuda"),
                           seeded_images(np.random.default_rng(SEED + 8), 2,
                                         MS_F32_TRAIN_SIZE),
                           size=MS_F32_TRAIN_SIZE,
                           phase="model_sizes_train_f32_card_vs_cpu")
    emit("model_sizes", nvidia_smi=smi, model="v11-x", size=SIZE, dtype="bfloat16",
         gt_bucket=64, card_gb=card_bytes / 1e9, memory_share=MS_MEMORY_SHARE,
         train_step=levels,
         epoch=dict(batch=batch, images=DA_IMAGES, steps=steps, seconds=epoch_s,
                    img_per_s=rates, topk_launches=launches["x_train_topk"],
                    step_csv=csv_rows[1]),
         train_f32_card_vs_cpu=f32, phase_seconds=time.perf_counter() - t_phase)


def _yolo12_phase(smi, captured, launches):
    """Phase (y): v12-x serves batches of 128 seeded 640 px images in bf16
    through `Detector`. One batch runs with every count at 0 and a
    profiler recording, so that the port's own counters count: each area
    attention forward (`attn.area.calls`) is one launch of the area
    attention op (`attn.area.kernel`, `launches.area_attention`), 16 a
    batch, and PSA's op none; every folded conv's bias, SiLU, layer scale
    and residual ran in the `bias_act` pass (`conv.fused` = `conv.folded`);
    one greedy keep. The op's first inputs at P4 (4 strips) and P5 (one)
    are held against its plain version within phase x's gate and kept for
    phase (g); the keep's bit for bit. Then img/s, the forward's time,
    and the f32 path card against CPU (phase x's check at v11-x)."""
    import torch

    from tpu_yolo_torch.core.config import get_model_config
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, blocks, nms, nms_cuda
    from tpu_yolo_torch.seeded import seeded_images, serving_state
    from tpu_yolo_torch.serve import Detector
    from tpu_yolo_torch.utils import telemetry

    t_phase = time.perf_counter()
    cfg = get_model_config("12x")
    imgs = seeded_images(np.random.default_rng(SEED + 9), BATCH, SIZE)
    state = serving_state(cfg, SEED, imgs[:16], "cuda")
    det = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, device="cuda")
    blocks_n = sum(isinstance(m, blocks.AreaAttention) for m in det.model.modules())
    check(blocks_n == 16, f"v12-x has {blocks_n} area attention blocks, not 16")
    for _ in range(2):
        det.detect_batch(imgs)
    torch.cuda.synchronize()

    area_fn, keep_fn = blocks.area_attention, nms.greedy_keep
    first = {}

    def area_tap(qkv, heads, area, scale):
        first.setdefault(area, (qkv, heads, area, scale))
        return area_fn(qkv, heads, area, scale)

    def keep_tap(boxes, cls, valid, thr):
        first.setdefault("nms", (boxes, cls, valid, thr))
        return keep_fn(boxes, cls, valid, thr)

    telemetry.reset()
    blocks.area_attention, nms.greedy_keep = area_tap, keep_tap
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            res = det.detect_batch(imgs)
            torch.cuda.synchronize()
        snap = telemetry.snapshot()
    finally:
        blocks.area_attention, nms.greedy_keep = area_fn, keep_fn
        telemetry.reset()
    counted = {k: snap.get(k, 0) for k in (
        "launches.area_attention", "attn.area.calls", "attn.area.kernel",
        "launches.psa_attention", "launches.nms_greedy_keep", "launches.bias_act",
        "conv.folded", "conv.fused")}
    check(counted["launches.area_attention"] == counted["attn.area.calls"]
          == counted["attn.area.kernel"] == blocks_n
          and counted["launches.psa_attention"] == 0
          and counted["launches.nms_greedy_keep"] == 1
          and counted["conv.fused"] == counted["conv.folded"] > 0,
          f"v12-x: counts in a serving batch {counted}")
    launches["x12"] = counted
    check(sorted(k for k in first if k != "nms") == [1, 4],
          f"v12-x: area attention strips {sorted(k for k in first if k != 'nms')}")
    captured["x12_area"] = [first[4], first[1]]
    errs = {}
    for area in (4, 1):
        qkv = first[area][0]
        check(qkv.dtype == torch.bfloat16 and tuple(qkv.shape) == (
            BATCH, 3 * 384, SIZE // (16 if area == 4 else 32), SIZE // (16 if area == 4 else 32)),
            f"v12-x: area attention at {tuple(qkv.shape)}, {qkv.dtype}")
        ok, errs[area] = _area_check(*first[area], p_step=MS_P_STEP)
        check(ok, f"v12-x serving: area attention op vs plain, area {area}, "
                  f"max err {errs[area]}")
    boxes, cls, valid, thr = first["nms"]
    check(torch.equal(nms_cuda.greedy_keep(boxes, cls, valid, thr),
                      nms_cuda.greedy_keep_plain(boxes, cls, valid, thr)),
          "v12-x serving: NMS kernel vs plain")
    counts = res["count"].cpu()
    check(all(bool(torch.isfinite(v.float()).all()) for v in res.values()),
          "v12-x: non-finite serving output")
    check(float((counts > 0).float().mean()) >= 0.9,
          f"v12-x: too few images with detections: {counts.tolist()}")

    iters = MS_SERVE_BATCHES["x"]
    t0 = time.perf_counter()
    for _ in range(iters):
        det.detect_batch(imgs)
    torch.cuda.synchronize()
    img_s = BATCH * iters / (time.perf_counter() - t0)
    with torch.inference_mode():
        xin = torch.from_numpy(imgs).cuda().to(torch.bfloat16) / 255
        fwd_ms = cuda_ms(lambda: det.model.forward_raw(xin), iters=5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del det, res, xin
    torch.cuda.empty_cache()
    f32 = _f32_card_vs_cpu(cfg, state, imgs[:2])
    emit("yolo12", model="v12-x", nvidia_smi=smi, counted=counted,
         area_attention_max_abs_err={str(a): e for a, e in errs.items()},
         area_attention_forms={str(a): attention_cuda.kernel_form(
             BATCH * a * AREA_HEADS, 400, torch.bfloat16, 32) for a in (4, 1)},
         img_per_s=img_s, timed_batches=iters, forward_ms=fwd_ms,
         peak_memory_gb=peak_gb, count_mean=float(counts.float().mean()),
         f32_card_vs_cpu=f32, seconds=round(time.perf_counter() - t_phase, 1))


def _f32_card_vs_cpu(cfg, state, two):
    """Phase (f)'s check for one model, the f32 path (TF32 off) of two
    images on the card against the CPU, and both against an f64 witness
    (the same weights' forward in f64 on the card, its maps cast to f32
    for the same NMS). Per image: >= 98% of detections matched both ways,
    card against CPU (phase f); and the card's f32 as near the witness as
    the CPU's: its share of detections with a partner within 0.05 px and
    5e-4 (phase f's tolerance) no more than 0.05 below the CPU's, its
    largest box and score gaps no more than twice the CPU's (or phase f's
    tolerance, the larger). Phase f holds every partner to that tolerance,
    card against CPU; v11-x's f32 forward is itself farther from exact on
    a few detections: the CPU's f32 boxes 0.17 px from f64, 91% of its
    detections within the tolerance, on phase x's first image."""
    import torch

    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops import attention_cuda, blocks
    from tpu_yolo_torch.ops.nms import nms_from_raw
    from tpu_yolo_torch.serve import Detector

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    attn_fn, area_fn = blocks.fused_attention, blocks.area_attention
    try:
        kw = dict(input_size=SIZE, compute_dtype=torch.float32, ranking="exact")
        on_card = Detector(YOLO.from_state_dict(cfg, state), device="cuda", **kw)
        card = on_card.detect_batch(two)
        cpu = Detector(YOLO.from_state_dict(cfg, state), device="cpu",
                       **kw).detect_batch(two)
        # the f64 witness: the attention's plain version (the kernel takes
        # bf16 and f32), NCHW convs
        blocks.fused_attention = attention_cuda.attention_plain
        blocks.area_attention = attention_cuda.area_attention_plain
        f64 = YOLO.from_state_dict(cfg, state).fold_batchnorm().to("cuda", torch.float64)
        with torch.inference_mode():
            raw = f64.forward_raw(torch.from_numpy(two).cuda().double() / 255)
            exact = nms_from_raw([m.float() for m in raw], cfg, (SIZE, SIZE),
                                 **on_card._nms)
    finally:
        blocks.fused_attention, blocks.area_attention = attn_fn, area_fn
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    rows = []
    for i in range(len(two)):
        pairs = {"card_vs_cpu": (_row(card, i), _row(cpu, i)),
                 "card_vs_f64": (_row(card, i), _row(exact, i)),
                 "cpu_vs_f64": (_row(cpu, i), _row(exact, i))}
        rows.append({k: _agreement(a, b) for k, (a, b) in pairs.items()})
        agree, card_x, cpu_x = (rows[-1][k] for k in ("card_vs_cpu", "card_vs_f64",
                                                      "cpu_vs_f64"))
        check(min(agree["match"]) >= 0.98
              and min(card_x["within"]) >= min(cpu_x["within"]) - 0.05
              and card_x["max_box_err_px"] <= max(0.05, 2 * cpu_x["max_box_err_px"])
              and card_x["max_score_err"] <= max(5e-4, 2 * cpu_x["max_score_err"]),
              f"f32 card vs CPU, image {i}: {rows[-1]}")
    return rows


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
        data_parallel_launches=dict(
            t1_test_rank=launches["dp_test_rank"]["psa_attention"],
            t2_ranks=[r["psa_attention"] for r in launches["dp_rehearsal_ranks"]],
            t3_two_replicas=launches["dp_detector"]["psa_attention"]),
        staged_serving_launches=launches["staged_attention"],
        model_sizes_launches={k: v["attention"] for k, v in launches["sizes"].items()},
        int8_serving_launches=launches["int8_attention"],
        export_launches=launches["export_attention"],
        onnx_live_forward_launches=launches["onnx_attention"],
        spatial_parallel_launches=dict(
            u2_ranks=[r["psa_attention"] for r in launches["sp_ranks"]],
            **{f"{run}_ranks": [r["psa_attention"] for r in ranks]
               for run, ranks in launches["v_ranks"].items()}),
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

    # at the spatial forward's inputs (phase u2: the gathered p5 map of 8
    # images at 1280 px, bf16), captured in rank 0, where it was held
    # against its plain version
    kernels[0]["spatial_path_shape"] = dict(
        launches=[r["psa_attention"] for r in launches["sp_ranks"]],
        max_abs_err=launches["sp_attention_err"],
        **_attention_times(*captured["spatial_attention"]))

    # at the uneven spatial forward's inputs (phase v1: the gathered p5 map
    # of 8 images at 1312 px, 1681 tokens, bf16), captured in rank 0, where
    # it was held against its plain version
    kernels[0]["spatial_uneven_shape"] = dict(
        launches=[r["psa_attention"] for r in launches["v_ranks"]["v1"]],
        max_abs_err=launches["v_attention_err"],
        **_attention_times(*captured["spatial_uneven_attention"]))

    # at v11-x's serving inputs (phase x: 6 heads, BATCH images) and its
    # run_test's (EVAL_BATCH images: K/V resident), held against the plain
    # version there
    kernels[0]["x_serving_shape"] = dict(
        launches=launches["sizes"]["x"]["attention"],
        max_abs_err=launches["x_attention_err"],
        **_attention_times(*captured["x_attention"]))
    kernels[0]["x_eval_shape"] = dict(
        launches=launches["x_eval"]["attention"],
        max_abs_err=launches["x_eval_attention_err"],
        **_attention_times(*captured["x_eval_attention"]))

    # the same kernel at the 1280 px shape, K/V streamed, on random inputs
    gen = torch.Generator(device=q.device).manual_seed(SEED)
    q2, k2 = (torch.randn(16, 1600, 32, device=q.device, generator=gen).to(q.dtype)
              for _ in range(2))
    v2 = torch.randn(16, 1600, 64, device=q.device, generator=gen).to(q.dtype)
    kernels[0]["second_shape"] = _attention_times(q2, k2, v2, scale)

    # the 32-wide-value form at v12-x's area attention shapes, on random
    # inputs, held against the plain version
    for bh, t in V32_SHAPES:
        q2, k2, v2 = (torch.randn(bh, t, 32, device=q.device, generator=gen).to(q.dtype)
                      for _ in range(3))
        want = attention_cuda.attention_plain(q2, k2, v2, scale).float()
        err = (attention_cuda.fused_attention(q2, k2, v2, scale).float() - want).abs()
        check(bool((err <= tol + tol * want.abs()).all()),
              f"attention kernel, 32-wide values, vs plain at ({bh}, {t})")
        kernels[0].setdefault("v32_shapes", []).append(
            dict(max_abs_err=float(err.max()), **_attention_times(q2, k2, v2, scale)))

    kernels.append(dict(
        name="nms_greedy_keep", route="cuda", op="tpu_yolo_torch::nms_greedy_keep",
        source="tpu_yolo_torch/csrc/nms_keep.cu",
        replaces="tpu_yolo/ops/nms_pallas.py:145",
        launches=launches["nms"], staged_serving_launches=launches["staged_nms"],
        model_sizes_launches=dict({k: v["nms"] for k, v in launches["sizes"].items()},
                                  x_run_test=launches["x_eval"]["nms"]),
        data_parallel_launches=dict(
            t1_test_rank=launches["dp_test_rank"]["nms_greedy_keep"],
            t2_ranks=[r["nms_greedy_keep"] for r in launches["dp_rehearsal_ranks"]],
            t3_two_replicas=launches["dp_detector"]["nms_greedy_keep"]),
        int8_serving_launches=launches["int8_nms"],
        spatial_parallel_launches=dict(
            u2_ranks=[r["nms_greedy_keep"] for r in launches["sp_ranks"]],
            **{f"{run}_ranks": [r["nms_greedy_keep"] for r in ranks]
               for run, ranks in launches["v_ranks"].items()}),
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
        data_parallel_launches=dict(
            t1_train_rank=launches["dp_train_rank_topk"],
            t2_ranks=[r["topk_mask"] for r in launches["dp_rehearsal_ranks"]]),
        tensor_parallel_launches=launches["tp_ranks_topk"],
        x_epoch_launches=launches["x_train_topk"],
        max_abs_err=float((got.int() - want.int()).abs().max()),
        ms=cuda_ms(lambda: topk_cuda.topk_mask(x, TOP_K), graph=True),
        ms_with_launch=cuda_ms(lambda: topk_cuda.topk_mask(x, TOP_K)),
        plain_ms=cuda_ms(lambda: topk_cuda.topk_mask_plain(x, TOP_K), iters=5),
        bound_ms=bound, bound_by=bound_by,
        library_ms=cuda_ms(library, iters=5, graph=True)))
    kernels += _area_rows(captured, launches)
    kernels += _bias_act_rows(captured, launches)
    kernels += _card_kernel_rows(captured, launches)
    return kernels


def _area_map(b, h, w, dtype, gen):
    """A random qkv map of AREA_HEADS heads, (B, 3·32·heads, H, W) in
    channels_last memory, as the qkv conv writes it."""
    import torch

    qkv = torch.randn(b, 3 * 32 * AREA_HEADS, h, w, device=gen.device, generator=gen)
    return qkv.to(dtype).contiguous(memory_format=torch.channels_last)


def _area_heads(x, heads, area, d=32):
    """q, k, v of a qkv map (B, 3·d·heads, H, W) as contiguous (B·area·heads,
    T, d) tensors, in area_attention_plain's order."""
    b, _, h, w = x.shape
    t = h * w // area
    x = x.permute(0, 2, 3, 1).reshape(b * area, t, heads, 3, d)
    return tuple(x[..., i, :].transpose(1, 2).reshape(b * area * heads, t, d)
                 for i in range(3))


def _area_check(qkv, heads, area, scale, p_step=0.0):
    """The area attention op against area_attention_plain on `qkv`:
    (within ATTN_TOL abs + rel, plus p_step · (P|V|) where given, as phase
    x's gate; the largest error)."""
    import torch

    from tpu_yolo_torch.ops import attention_cuda

    got = attention_cuda.area_attention(qkv, heads, area, scale).float()
    want = attention_cuda.area_attention_plain(qkv, heads, area, scale).float()
    torch.cuda.synchronize()
    tol = ATTN_TOL[str(qkv.dtype).split(".")[1]]
    err = (got - want).abs()
    gate = tol + tol * want.abs()
    if p_step:
        q, k, v = (t.float() for t in _area_heads(qkv, heads, area))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, -1)
        b, c3, h, w = qkv.shape
        steps = p_step * torch.matmul(p, v.abs())
        gate = gate + steps.view(b * area, heads, -1, c3 // 3 // heads).transpose(1, 2).reshape(
            b, h, w, c3 // 3).permute(0, 3, 1, 2)
    ok = bool((err <= gate).all()) and got.is_contiguous(memory_format=torch.channels_last)
    return ok, float(err.max())


def _area_times(qkv, heads, area, scale):
    """The area attention op's shape, form, times and bound on a qkv map,
    as _attention_times gives the (BH, T, d) op's. `library_ms` is
    F.scaled_dot_product_attention's on q, k, v already copied to
    (1, BH, T, 32): the copies that the op does without are left out."""
    import torch.nn.functional as F

    from tpu_yolo_torch.ops import attention_cuda

    q, k, v = _area_heads(qkv, heads, area)
    bound, bound_by = attention_cost(q, v, str(qkv.dtype).split(".")[1])
    ms = cuda_ms(lambda: attention_cuda.area_attention(qkv, heads, area, scale), graph=True)
    library = cuda_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                             scale=scale), graph=True)
    b, c3, h, w = qkv.shape
    return dict(
        shape=dict(b=b, c=c3 // 3, h=h, w=w, heads=heads, area=area, bh=q.shape[0],
                   t=q.shape[1], dk=32, dh=32, dtype=str(qkv.dtype),
                   form=attention_cuda.kernel_form(q.shape[0], q.shape[1], qkv.dtype, 32)),
        ms=ms, ms_with_launch=cuda_ms(
            lambda: attention_cuda.area_attention(qkv, heads, area, scale)),
        plain_ms=cuda_ms(lambda: attention_cuda.area_attention_plain(qkv, heads, area, scale),
                         iters=5),
        bound_ms=bound, bound_by=bound_by, library_ms=library,
        ms_over_bound=ms / bound, ms_over_library=ms / library)


def _area_rows(captured, launches):
    """Phase (g)'s row of the area attention op: its launches in v12-x's
    counted batch (phase y), its error and times at that batch's inputs
    (P4 and P5) and on phase (c)'s random maps."""
    import torch

    main = []
    for qkv, heads, area, scale in captured["x12_area"]:
        ok, err = _area_check(qkv, heads, area, scale, p_step=MS_P_STEP)
        check(ok, f"area attention op vs plain at v12-x's inputs, area {area}")
        main.append(dict(max_abs_err=err, **_area_times(qkv, heads, area, scale)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    random = []
    for dtype, b, h, w, area in AREA_CASES:
        qkv = _area_map(b, h, w, getattr(torch, dtype), gen)
        ok, err = _area_check(qkv, AREA_HEADS, area, 32 ** -0.5)
        check(ok, f"area attention op vs plain on a random map {(dtype, b, h, w, area)}")
        random.append(dict(max_abs_err=err, **_area_times(qkv, AREA_HEADS, area, 32 ** -0.5)))
    return [dict(
        name="area_attention", route="cuda", op="tpu_yolo_torch::area_attention",
        source="tpu_yolo_torch/csrc/attention.cu",
        replaces="none: the JAX package has no YOLO12",
        launches=launches["x12"]["launches.area_attention"],
        x12_serving_shapes=main, random_shapes=random)]


def _bias_act_rows(captured, launches):
    """The folded conv's epilogue pass at v11-n's serving inputs (phase e):
    its largest map, and its largest with a residual. Bit-equal to the
    plain version (checked); `ms` from launches replayed out of a CUDA
    graph; the byte bound (y and the residual read, the output written
    once); `library_ms` the PyTorch calls the pass replaces,
    `F.silu(y.add_(b))` (+ the residual), as a yardstick only."""
    import torch
    import torch.nn.functional as F

    from tpu_yolo_torch.ops import bias_act_cuda as ba

    rows = []
    for key in ("bias_act", "bias_act_residual"):
        y, b, act, r, halves = captured[key]
        got = ba.bias_act(y, b, act, r, halves)
        want = ba.bias_act_plain(y, b, act, r, halves)
        got, want = (torch.cat(t, 1) if halves else t for t in (got, want))
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{key} kernel vs plain at the main path's inputs")
        y2, bias = y.clone(), b.view(1, -1, 1, 1)
        act_fn = F.silu if act == "silu" else (lambda t: t)

        def library():
            out = act_fn(y2.add_(bias))
            return out if r is None else r + out

        nbytes = (2 * y.numel() + (0 if r is None else r.numel())) * y.element_size()
        ms = cuda_ms(lambda: ba.bias_act(y, b, act, r, halves), graph=True)
        bound = nbytes / HBM_BYTES_S * 1e3
        rows.append(dict(
            name=key, route="cuda", op="tpu_yolo_torch::bias_act",
            source="tpu_yolo_torch/csrc/bias_act.cu",
            replaces="no TPU kernel: XLA fuses a conv's bias, SiLU and residual",
            shape=dict(y=list(y.shape), dtype=str(y.dtype), act=act, halves=halves,
                       residual=None if r is None else dict(stride=list(r.stride())),
                       form=ba.kernel_form(y, b, r, halves)),
            launches=launches["bias_act"], max_abs_err=float((got.float() - want.float())
                                                             .abs().max()),
            ms=ms, ms_with_launch=cuda_ms(lambda: ba.bias_act(y, b, act, r, halves)),
            plain_ms=cuda_ms(lambda: ba.bias_act_plain(y, b, act, r, halves), iters=5),
            bound_ms=bound, bound_by="bytes", ms_over_bound=ms / bound,
            library_ms=cuda_ms(library, graph=True),
            library_call="F.silu(y.add_(b))" + ("" if r is None else " + r")))
    return rows


# the host C++ functions that the card's placement kernels compute: no
# TPU kernel has them (the JAX package runs them on its host)
CARD_KERNEL_REPLACES = {
    "ycc_to_rgb": "tpu_yolo_torch/csrc/image_pipeline.cc:53",
    "resize_bilinear": "tpu_yolo_torch/csrc/image_pipeline.cc:115",
    "resize_generic": "tpu_yolo_torch/csrc/image_pipeline.cc:269",
    "place": "tpu_yolo_torch/csrc/image_pipeline.cc:354"}


def _card_kernel_rows(captured, launches):
    """The card's image kernels at the largest inputs phase w's main path
    gave them: bit-equal to their plain versions (checked), times (`ms`
    from launches replayed out of a CUDA graph), the byte bound, and the
    nearest PyTorch call where there is one (`library_call` names it)."""
    import torch
    import torch.nn.functional as F

    from tpu_yolo_torch.ops import image_cuda as ic

    rows = []
    for name in CARD_KERNELS:
        (a, kw), _ = captured[f"card_{name}"]
        out = a[1] if name != "place" else a[0]
        if name == "ycc_to_rgb":
            y, cb, cr, out, hs, vs = a[:6]
            bgr = a[6] if len(a) > 6 else kw.get("bgr", False)

            def kernel():
                ic.ycc_to_rgb(y, cb, cr, out, hs, vs, bgr)

            def plain():
                return ic.ycc_to_rgb_plain(y, cb, cr, hs, vs, bgr)

            nbytes = y.numel() + cb.numel() + cr.numel() + out.numel()
            library, call = None, None
            shape = dict(y=list(y.shape), chroma=list(cb.shape), subsampling=[hs, vs],
                         bgr=bool(bgr))
        elif name == "place":
            top, left, h, w = a[1:5]
            src = kw.get("src", a[5] if len(a) > 5 else None)

            def kernel():
                ic.place(out, top, left, h, w, src)

            def plain():
                ic.place_plain(out, top, left, h, w, src)

            s_size = out.shape[0]
            nbytes = out.numel() + (0 if src is None else src.numel())
            library, call = None, None
            if src is not None:
                pads = (0, 0, left, s_size - left - w, top, s_size - top - h)
                library, call = (lambda: F.pad(src, pads)), "F.pad(src, zeros)"
            shape = dict(slot=list(out.shape), image=[h, w], top=top, left=left,
                         copies=src is not None)
        else:
            src, dh, dw = a[0], a[2], a[3]
            interp = a[4] if name == "resize_generic" else ic.LINEAR
            top, left = (a[5:7] if name == "resize_generic" else a[4:6]) or (0, 0)
            sh, sw = src.shape[:2]
            region = (slice(top, top + dh), slice(left, left + dw))
            nbytes = src.numel() + dh * dw * 3
            shape = dict(src=[sh, sw], dst=[dh, dw], interp=interp)
            if name == "resize_bilinear":
                def kernel():
                    ic.resize_bilinear(src, out, dh, dw, top, left)

                def plain():
                    return ic.resize_bilinear_plain(src, dh, dw)
            else:
                lib = ic.library()
                taps = [torch.from_numpy(t).cuda()
                        for t in (*ic.make_taps(interp, sw, dw), *ic.make_taps(interp, sh, dh))]
                tmp = torch.empty((sh, dw, 3), dtype=torch.float32, device="cuda")

                def kernel():   # the wrapper's launch with its taps uploaded
                    check(lib.ic_resize_generic(
                        src.data_ptr(), sw, sh,
                        out.data_ptr() + (top * out.shape[1] + left) * 3,
                        out.shape[1] * 3, dw, dh, taps[0].data_ptr(), taps[1].data_ptr(),
                        taps[1].shape[1], taps[2].data_ptr(), taps[3].data_ptr(),
                        taps[3].shape[1], tmp.data_ptr(),
                        torch.cuda.current_stream().cuda_stream) == 0, "resize_generic")

                def plain():
                    return ic.resize_generic_plain(src, dh, dw, interp)
            mode = {ic.LINEAR: "bilinear", ic.NEAREST: "nearest", ic.CUBIC: "bicubic",
                    ic.AREA: "area"}.get(interp)
            library, call = None, None
            if mode is not None:
                x = src.permute(2, 0, 1)[None].float().contiguous()
                library = (lambda: F.interpolate(x, size=(dh, dw), mode=mode))
                call = f"F.interpolate(float32 NCHW, mode={mode!r})"
        if name == "ycc_to_rgb":
            want = plain()
            kernel()
            got = out
        elif name == "place":
            want, got = out.clone(), out.clone()
            ic.place_plain(want, top, left, h, w, src)
            ic.place(got, top, left, h, w, src)
        else:
            want = plain()
            getattr(ic, name)(src, out, dh, dw, *((interp,) if name == "resize_generic"
                                                  else ()), top, left)
            got = out[region]
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        check(err == 0, f"{name} kernel vs plain at the main path's inputs: {err}")
        ms = cuda_ms(kernel, graph=True)
        bound = nbytes / HBM_BYTES_S * 1e3
        rows.append(dict(
            name=f"image_{name}", route="cuda", source="tpu_yolo_torch/csrc/image_card.cu",
            replaces=CARD_KERNEL_REPLACES[name],
            replaces_kind="a host C++ function of the data path (no TPU kernel)",
            launches=launches[f"card_{name}"], max_abs_err=err, shape=shape,
            ms=ms, ms_with_launch=cuda_ms(kernel), plain_ms=cuda_ms(plain, iters=5),
            bound_ms=bound, bound_by="bytes", ms_over_bound=ms / bound,
            library_ms=None if library is None else cuda_ms(library, graph=True),
            library_call=call))
    return rows


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
                   form=attention_cuda.kernel_form(q.shape[0], q.shape[1], q.dtype,
                                                   v.shape[2])),
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
    same-class partner at IoU >= iou in the other, the largest box and
    score differences between partners, and the share of each one's
    detections whose partner is within 0.05 px and 5e-4 (phase f's
    tolerance)."""
    from tpu_yolo_torch.ops.boxes import box_iou_pairwise

    def one_way(x, y):
        (bx, sx, cx), (by, sy, cy) = x, y
        if len(bx) == 0 or len(by) == 0:
            return float(len(bx) == len(by)), 0.0, 0.0, float(len(bx) == len(by))
        overlap = box_iou_pairwise(bx, by) * (cx[:, None] == cy[None, :])
        best, j = overlap.max(1)
        hit = best >= iou
        if not bool(hit.any()):
            return 0.0, 0.0, 0.0, 0.0
        box, score = (bx - by[j]).abs().amax(1), (sx - sy[j]).abs()
        close = hit & (box <= 0.05) & (score <= 5e-4)
        return (int(hit.sum()) / len(hit),   # exact: not a float32 mean
                float(box[hit].max()), float(score[hit].max()),
                int(close.sum()) / len(close))

    ab, ba = one_way(a, b), one_way(b, a)
    return dict(count=[len(a[0]), len(b[0])],
                same_classes_in_order=len(a[2]) == len(b[2])
                and bool((a[2] == b[2]).all()),
                match=[ab[0], ba[0]], max_box_err_px=max(ab[1], ba[1]),
                max_score_err=max(ab[2], ba[2]), within=[ab[3], ba[3]])


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
