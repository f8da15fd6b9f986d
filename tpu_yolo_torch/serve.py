"""Serving pipeline: uint8 images or paths -> detections (counterpart of
`tpu_yolo/serve.py`).

  decode:  paths are decoded and letterboxed on the card by nvJPEG and
           the placement kernels (data/native_loader.py::CardPipeline),
           into the batch on the device; on the CPU in the native C++
           pool or, where it cannot be built, with OpenCV in a thread
           pool. With device_letterbox=True, decode only: raw pixels
           top-left in a (stage_size, stage_size) buffer, through the
           same pipelines. `stager` names it ("nvjpeg", "native", "cv2");
  device:  [letterbox (ops/letterbox.py)] -> /255 in the compute dtype ->
           YOLO.forward_raw -> nms_from_raw, on the card unless the caller
           passes device="cpu";
  stage:   on the card a host batch is copied on a copy stream of the
           Detector's, from a ring of pinned buffers (a pageable batch is
           first copied into one on the host), and the compute stream
           waits for it by an event: batch i+1's copy runs under batch
           i's forward (`Detector._stage`);
  overlap: `stream` double-buffers: batch i+1 is decoded (on the card,
           into one of two device buffers; on the CPU, into pinned host
           memory) while batch i runs, and each result comes back through
           its own pinned buffer and CUDA event, so the host waits only on
           the result it emits;
  dp:      with `dp` (parallel/mesh.py) a replica per device of the data
           axis: each batch is split into contiguous equal parts, one per
           device, and the results are gathered in order.

Boxes are returned in original-image pixel coordinates by inverting the
letterbox transform ((xy - pad) / ratio), clipped to the image.

A saved serving program (`save_compiled` / `load_compiled`) is the device
program exported by `torch.export` at a fixed batch, with the weights as
its inputs: it runs without tracing the Python model again, and the
three kernels appear in it as the custom ops of ops/*_cuda.py.
`quantize` switches the Detector to int8 W8A8 convs (quant.py); a
quantized Detector saves an int8 program, which takes int8 weights.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from tpu_yolo_torch.core.config import ModelConfig, get_model_config
from tpu_yolo_torch.data import native_loader
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.ops.anchors import device_anchors
from tpu_yolo_torch.ops.letterbox import letterbox_batch
from tpu_yolo_torch.ops.nn import ConvBN
from tpu_yolo_torch.parallel.mesh import as_data_parallel
from tpu_yolo_torch.utils import telemetry
from tpu_yolo_torch.utils.export import WeightsAsInputs

EXPORT_FORMAT = "tpu_yolo_torch-export-v1"
RING_SLOTS = 2  # pinned staging slots: a batch is copied in while the one before runs


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def fetch_async(res: dict):
    """Start copying a dict of result tensors to the host; returns
    (tensors, event). On the card each tensor is copied asynchronously
    into pinned memory and the event marks the copies' end; CPU tensors
    come back as they are, with no event."""
    if next(iter(res.values())).device.type != "cuda":
        return res, None
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            .copy_(v, non_blocking=True) for k, v in res.items()}
    done = torch.cuda.Event()
    done.record()
    return host, done


class Detector:
    """Batched streaming detector.

    >>> det = Detector.from_checkpoint("yolo11n.pt", size="n")
    >>> for res in det.stream(paths, batch_size=64):
    ...     res["boxes"], res["scores"], res["classes"]  # per image
    """

    def __init__(self, model: YOLO, input_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.65,
                 max_det: int = 300, compute_dtype=torch.bfloat16,
                 ranking: str = "approx", max_nms: int | None = None,
                 multi_label: bool | None = None, latency_mode: bool = False,
                 device_letterbox: bool = False, stage_size: int = 960,
                 decode_threads: int = 8, device=None, dp=None):
        """The Detector takes `model` over: it folds its BatchNorm and
        moves it to `device` and `compute_dtype` in place.

        `ranking`: "approx" (the serving default) or "exact"; both rank
        exactly here (ops/nms.py).
        `max_nms`: NMS candidate budget K, 1024 by default.
        `multi_label`: True keeps every (anchor, class) pair above conf as
        a candidate; False keeps each anchor's argmax class only.
        `latency_mode`: the low-latency preset, multi_label=False and
        max_nms=256; explicitly passed values still win.
        `device_letterbox`: `stream` decodes only (raw uint8 top-left in a
        (stage_size, stage_size) staging buffer) and the aspect-preserving
        resize + pad runs on the device (ops/letterbox.py); originals
        longer than stage_size are pre-shrunk on the host to fit, and that
        ratio is folded into the returned boxes per axis. `stager` then
        says which decoder staged them ("nvjpeg", "native" or "cv2").
        `decode_threads`: host threads that decode (and stage) images.
        `device`: "cuda" (the default) or "cpu"; raises without a card
        unless the CPU is asked for.
        `dp`: a parallel Mesh or DataParallel of this process's devices
        (make_mesh(devices=[...]), repeats allowed): a replica of the
        model on each, every batch split into contiguous equal parts over
        them (a batch that does not divide is refused) and the results
        gathered in order on the first, which is the Detector's device
        (`device` must then be it or None)."""
        if max_nms is None:
            max_nms = 256 if latency_mode else 1024
        if multi_label is None:
            multi_label = not latency_mode
        dp = as_data_parallel(dp)
        if dp is not None:
            if device is not None and torch.device(device) != dp.devices[0]:
                raise ValueError(f"device={device!r} is not the first device of "
                                 f"dp, {dp.devices[0]}")
            for d in dp.devices:
                _device(d)
            device = dp.devices[0]
        self.device = _device("cuda" if device is None else device)
        self._dp = dp
        self.cfg = model.cfg
        self.input_size = input_size
        self.compute_dtype = compute_dtype
        self.device_letterbox = device_letterbox
        self.stage_size = stage_size
        self.decode_threads = decode_threads
        self._stager = None  # the staging pipeline, made at first use
        self._host_pipe = None  # the host letterbox pipeline, made at first use
        self._fixed_batch = None  # set by load_compiled
        self._first_batch_s = None  # host seconds of the first batch served
        self._copy_stream = None  # the host inputs' copy stream, made at first use
        self._ring = [[] for _ in range(RING_SLOTS)]  # each slot's pinned byte buffers
        self._ring_done = [None] * RING_SLOTS  # the event of each slot's last copies
        self._ring_next = 0
        t0 = time.perf_counter()
        self.model = self._place(model)
        self._replicas = dp.replicate(self.model) if dp is not None else None
        telemetry.note("setup.place_s", time.perf_counter() - t0)
        self._nms = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                         max_det=max_det, ranking=ranking, max_nms=max_nms,
                         multi_label=multi_label)
        # the construction knobs, as save_compiled records them
        self._knobs = dict(
            input_size=input_size, conf_thres=conf_thres, iou_thres=iou_thres,
            max_det=max_det, compute_dtype=str(compute_dtype).split(".")[-1],
            ranking=ranking, max_nms=max_nms, multi_label=multi_label,
            latency_mode=latency_mode, device_letterbox=device_letterbox,
            stage_size=stage_size, decode_threads=decode_threads)

    def _place(self, model: YOLO) -> YOLO:
        """Fold the model's BatchNorm and move it, in place, to the device
        in channels_last memory, its float convs in the compute dtype; an
        int8 conv keeps its float32 scales and bias."""
        model = model.fold_batchnorm().to(device=self.device,
                                          memory_format=torch.channels_last)
        for m in model.modules():
            if isinstance(m, ConvBN) and not m.quantized:
                m.to(dtype=self.compute_dtype)
        return model.eval()

    def quantize(self, calib_paths: list[str], margin: float = 1.0) -> "Detector":
        """Switch to int8 W8A8 inference (tpu_yolo_torch/quant.py),
        calibrated in bf16 on `calib_paths`, decoded and letterboxed as
        `stream` does on the host (failed decodes are dropped), as the JAX
        package's `Detector.quantize`. The weights quantized are the ones
        the Detector holds, in its compute dtype. Then `save_compiled`
        saves the int8 program. Returns self."""
        from tpu_yolo_torch.quant import quantize_model

        if self._fixed_batch is not None:
            raise ValueError("this Detector runs a saved program: quantize the "
                             "Detector it was saved from, then save_compiled")
        imgs = self._decode_buffer(len(calib_paths))
        metas = self._decode_batch(list(calib_paths), imgs)
        imgs = np.asarray(imgs.cpu() if isinstance(imgs, torch.Tensor) else imgs)
        imgs = imgs[metas[:, 0] > 0]
        if not len(imgs):
            raise ValueError("Detector.quantize: no calibration image decoded")
        self.model = self._place(quantize_model(self.model, imgs, margin))
        if self._dp is not None:
            self._replicas = self._dp.replicate(self.model)
        return self

    @classmethod
    def from_checkpoint(cls, path: str, size: str = "n", num_classes: int = 80,
                        **kw):
        """Load a tpu_yolo .ckpt (EMA weights when present) or an
        Ultralytics / reference .pt / .npz state dict."""
        from tpu_yolo_torch.io.weights import load_params

        cfg = get_model_config(size, num_classes)
        return cls(YOLO.from_state_dict(cfg, load_params(path, cfg)), **kw)

    # -- host decode ------------------------------------------------------
    def _decode_buffer(self, n: int):
        """A zeroed (n, S, S, 3) uint8 batch for _decode_batch: a tensor on
        the card, else a host array."""
        s = self.input_size
        if self.device.type == "cuda":
            return torch.zeros((n, s, s, 3), dtype=torch.uint8, device=self.device)
        return np.zeros((n, s, s, 3), np.uint8)

    def _decode_batch(self, paths: list[str], out):
        """Decode + letterbox `paths` into the first rows of `out` (N, S,
        S, 3) uint8 RGB, a host array or, on the card, a device tensor:
        on the card by nvJPEG and the placement kernels, on the CPU
        through the native pool where it loads (the ratio unclamped:
        load_image's long-side scale then the letterbox, in one resize),
        else cv2's load_image + letterbox, as the JAX package's Detector
        does. Returns (N, 5) metas [ratio, pad_w, pad_h, orig_w, orig_h],
        -1 for an image that failed to decode."""
        if self._host_pipe is None:
            self._host_pipe = (
                native_loader.CardPipeline(self.input_size, threads=self.decode_threads,
                                           allow_upscale=True, device=self.device)
                if self.device.type == "cuda" else
                native_loader.NativePipeline(self.input_size, threads=self.decode_threads,
                                             allow_upscale=True)
                if native_loader.available()
                else _Cv2Letterbox(self.input_size, self.decode_threads))
        return self._host_pipe.load_batch(paths, out=out[:len(paths)])[1]

    @property
    def stager(self) -> str | None:
        """The decoder of image paths, "nvjpeg", "native" or "cv2": the
        staged path's with device_letterbox, else the host letterbox's
        (None before its first batch)."""
        pipe = self._stager if self.device_letterbox else self._host_pipe
        return pipe.stager if pipe is not None else None

    def _decode_batch_raw(self, paths: list[str], out):
        """Raw decode of `paths` into the staging buffer `out` (N, St, St,
        3) uint8 RGB (a host array, or a device tensor on the card), for
        the device letterbox. Returns (N, 4) dims [staged_h, staged_w,
        orig_h, orig_w], -1 in column 0 for an image that failed to
        decode."""
        if self._stager is None:
            self._stager = native_loader.staging_pipeline(
                self.input_size, threads=self.decode_threads, device=self.device)
        return self._stager.load_batch_raw(paths, self.stage_size, out=out)[1]

    @staticmethod
    def _metas_from_dims(dims: np.ndarray, out_size: int) -> np.ndarray:
        """Host mirror of the device letterbox geometry, combined with the
        host pre-shrink: (N, 4) dims -> (N, 6) metas [rx, pad_w, pad_h,
        orig_w, orig_h, ry] in the _emit contract. The pre-shrink rounds
        each axis on its own, so the total ratio differs per axis by up to
        about a pixel on large originals: the sixth column is the y
        ratio (column 0 the x ratio)."""
        metas = np.full((len(dims), 6), -1, np.float32)
        for i, (sh, sw, oh, ow) in enumerate(np.asarray(dims, np.float64)):
            if sh < 0:
                continue
            r = min(out_size / sh, out_size / sw)
            new_w, new_h = round(sw * r), round(sh * r)
            dx = sw / ow if ow else 1.0
            dy = sh / oh if oh else 1.0
            metas[i] = (r * dx, (out_size - new_w) / 2,
                        (out_size - new_h) / 2, ow, oh, r * dy)
        return metas

    # -- inference --------------------------------------------------------
    def _program(self, x_u8, model=None):
        """The serving program: uint8 (B, S, S, 3) -> /255 in the compute
        dtype -> forward -> NMS, on `model` (the Detector's by default)."""
        x = x_u8.to(self.compute_dtype) / 255
        return (self.model if model is None else model).forward_nms(x, **self._nms)

    def _program_staged(self, staged_u8, hw, model=None):
        """The device-letterbox program: raw staged uint8 (B, St, St, 3)
        and true sizes (B, 2) -> letterbox (the single-resize serving
        geometry) -> /255 -> forward -> NMS."""
        boxed, _ = letterbox_batch(staged_u8, hw, out_size=self.input_size,
                                   allow_upscale=True)
        return self._program(boxed, model)

    def _stage(self, inputs) -> list:
        """The inputs on the Detector's device, inside `layer.serve.stage`.

        On a CUDA Detector each host tensor is copied to the card on the
        Detector's copy stream, and the current (compute) stream waits
        for the copies through an event, so a batch's copy runs under the
        work queued before it. A tensor in pageable memory is first
        copied on the host into the next of RING_SLOTS slots of pinned
        buffers (a slot is reused once its last copies have ended; its
        buffers grow to the largest input seen); a pinned contiguous one
        is copied as it is, and waited for. Either way the caller's
        tensor has been read when this returns. Each device copy is
        allocated on the copy stream and recorded for the compute
        stream, so its memory goes to no later copy before the compute
        stream has read it. Device tensors, and every input of a CPU
        Detector, are moved by `.to` as they are.

        Counters: `stage.host` (host tensors staged), `stage.ring`
        (through the pinned ring), `stage.direct` (pinned, copied as
        they are), `stage.slot_wait` (slots whose last copies had not
        ended when they were claimed)."""
        on_host = [x.device.type == "cpu" for x in inputs]
        if self.device.type != "cuda" or not any(on_host):
            return [x.to(self.device, non_blocking=True) for x in inputs]
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy, compute = self._copy_stream, torch.cuda.current_stream(self.device)
        out, slot, ring, direct = [], None, 0, False
        for x, host in zip(inputs, on_host):
            if not host:
                out.append(x.to(self.device, non_blocking=True))
                continue
            telemetry.add("stage.host", 1)
            if x.is_pinned() and x.is_contiguous():
                telemetry.add("stage.direct", 1)
                src, direct = x, True
            else:
                if slot is None:
                    slot = self._claim_slot()
                src = self._ring_buffer(slot, ring, x).copy_(x)
                ring += 1
                telemetry.add("stage.ring", 1)
            with torch.cuda.stream(copy):
                dev = torch.empty(x.shape, dtype=x.dtype, device=self.device)
                dev.copy_(src, non_blocking=True)
            dev.record_stream(compute)
            out.append(dev)
        done = torch.cuda.Event()
        done.record(copy)
        compute.wait_event(done)
        if slot is not None:
            self._ring_done[slot] = done
        if direct:
            done.synchronize()
        return out

    def _claim_slot(self) -> int:
        """The next slot of the pinned ring, once its last copies have
        ended."""
        slot = self._ring_next
        self._ring_next = (slot + 1) % RING_SLOTS
        done = self._ring_done[slot]
        if done is not None and not done.query():
            telemetry.add("stage.slot_wait", 1)
            done.synchronize()
        return slot

    def _ring_buffer(self, slot: int, i: int, x: torch.Tensor) -> torch.Tensor:
        """A contiguous pinned view shaped as `x`, over the slot's i-th
        byte buffer (allocated anew only for a larger input)."""
        bufs = self._ring[slot]
        n = x.numel() * x.element_size()
        if i == len(bufs):
            bufs.append(None)
        if bufs[i] is None or len(bufs[i]) < n:
            bufs[i] = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
        return bufs[i][:n].view(x.dtype).view(x.shape)

    def _run(self, program, *inputs):
        """program(*inputs) with the inputs (on the host or the device) on
        the Detector's device or, with dp, split over its devices, one
        replica each, the results gathered in order on the first."""
        with torch.inference_mode():
            if self._dp is None:
                with telemetry.span("layer.serve.stage"):
                    inputs = self._stage(inputs)
                return program(*inputs)
            with telemetry.span("layer.serve.stage"):
                parts = list(zip(*(self._dp.shard_batch(x) for x in inputs)))
            return self._dp.gather([program(*p, model=m)
                                    for p, m in zip(parts, self._replicas)])

    def _predict(self, x_u8):
        return self._run(self._program, x_u8)

    def _predict_staged(self, staged_u8, hw):
        return self._run(self._program_staged, staged_u8, hw)

    def _serve(self, predict, *inputs):
        """predict(*inputs) as one request of the spans (utils/telemetry.py);
        the host seconds of the Detector's first call, its one-time loads
        (kernel libraries, CUDA's lazy module loads, cuDNN's choices) with
        no synchronize added, are recorded as `setup.first_batch_s`."""
        t0 = time.perf_counter()
        with telemetry.request():
            out = predict(*inputs)
        if self._first_batch_s is None:
            self._first_batch_s = time.perf_counter() - t0
            telemetry.note("setup.first_batch_s", self._first_batch_s)
        return out

    def detect_batch(self, images_u8):
        """(B, S, S, 3) uint8 RGB (numpy or torch) -> result dict of
        tensors on the device, in letterbox coordinates. A Detector from
        `load_compiled` takes its artifact's batch size only.

        When this returns, a host array has been read (on the card it is
        copied from pinned memory on a stream of its own, `_stage`): the
        caller may overwrite it at once. The detections are computed
        asynchronously on the card."""
        x = torch.as_tensor(images_u8)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"detect_batch expects (B, S, S, 3) uint8, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if self._fixed_batch is not None and len(x) != self._fixed_batch:
            raise ValueError(
                f"this Detector runs a saved program exported for "
                f"batch_size={self._fixed_batch}; got a batch of {len(x)} "
                f"(pad it, or save_compiled at this size)")
        return self._serve(self._predict, x)

    # -- saved serving program --------------------------------------------
    def _weights_spec(self) -> dict:
        """key -> [shape, dtype, memory format] of the folded weights as
        the program takes them, in the program's input order."""
        return {k: [list(t.shape), str(t.dtype).split(".")[-1],
                    "channels_last" if t.dim() == 4 and t.is_contiguous(
                        memory_format=torch.channels_last) else "contiguous"]
                for k, t in self.model.state_dict().items()}

    def _example_inputs(self, batch_size: int):
        if self.device_letterbox:
            st = self.stage_size
            return (torch.zeros((batch_size, st, st, 3), dtype=torch.uint8,
                                device=self.device),
                    torch.ones((batch_size, 2), dtype=torch.float32,
                               device=self.device))
        s = self.input_size
        return (torch.zeros((batch_size, s, s, 3), dtype=torch.uint8,
                            device=self.device),)

    def save_compiled(self, path: str, batch_size: int) -> str:
        """Export the serving program at a fixed batch with `torch.export`
        and write it to `path`, with the Detector's configuration.

        The program is the plain one (uint8 (B, S, S, 3) -> detections)
        or, with device_letterbox, the staged one (uint8 (B, St, St, 3)
        and f32 (B, 2) sizes), on this Detector's device, in its compute
        dtype and memory format. The weights are inputs of the program
        and stay outside the file: one artifact serves every fine-tune of
        the architecture. The file is a zip of `meta.json` (format tag,
        staged flag, batch, model config, construction knobs, the
        weights' spec and the torch/CUDA/device environment) and
        `program.pt2` (`torch.export.save`). It runs only where it was
        made: `load_compiled` checks the environment. A Detector with dp
        raises: its program spans several devices."""
        if self._dp is not None:
            raise NotImplementedError(
                "save_compiled exports the one-device serving program; a "
                "Detector(dp=...) runs a replica per device: save_compiled a "
                "Detector without dp")
        spec = self._weights_spec()
        program = WeightsAsInputs(_ServingProgram(self))
        weights = tuple(self.model.state_dict().values())
        # the anchor grid is a constant of the program: made here, outside
        # the trace, so the cache never holds a traced tensor (keyed by the
        # device as tensors carry it, "cuda:0" and not "cuda")
        device_anchors((self.input_size, self.input_size), tuple(self.cfg.strides),
                       torch.empty(0, device=self.device).device)
        exported = torch.export.export(
            program, (weights, *self._example_inputs(batch_size)), strict=False)
        exported.example_inputs = None  # they hold the weights
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        meta = {"format": EXPORT_FORMAT, "staged": bool(self.device_letterbox),
                "batch_size": int(batch_size),
                "cfg": dataclasses.asdict(self.cfg), "knobs": dict(self._knobs),
                "weights": spec, **_environment(self.device)}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("meta.json", json.dumps(meta, indent=1))
            z.writestr("program.pt2", buf.getvalue())
        return path

    @classmethod
    def load_compiled(cls, path: str, params) -> "Detector":
        """A Detector that runs the program a `save_compiled` artifact
        holds, with `params`: a folded state dict, or a YOLO (folded in
        place and taken over, as the constructor does).

        Before the program runs it raises ValueError on a file of another
        format, RuntimeError naming the key where the platform, device
        name or torch/CUDA version differ from the artifact's, and
        ValueError naming the first weight whose key or shape differs
        from the artifact's spec. The Detector is locked to the
        artifact's batch: detect_batch refuses another one and `stream`
        takes it whatever its batch_size argument."""
        try:
            archive = zipfile.ZipFile(path)
        except zipfile.BadZipFile as e:
            raise ValueError(f"{path}: not a {EXPORT_FORMAT} artifact") from e
        with archive as z:
            meta = (json.loads(z.read("meta.json"))
                    if "meta.json" in z.namelist() else {})
            if meta.get("format") != EXPORT_FORMAT:
                raise ValueError(f"{path}: not a {EXPORT_FORMAT} artifact")
            device = torch.device(meta["platform"])
            have = (_environment(device) if device.type == "cpu"
                    or torch.cuda.is_available() else {"platform": "cpu"})
            for key in ("platform", "device_name", "torch_version",
                        "cuda_version"):
                if meta[key] != have[key]:
                    raise RuntimeError(
                        f"{path} was exported for {key}={meta[key]!r} but "
                        f"this process has {have[key]!r}: save_compiled it "
                        f"again in this environment")
            program_bytes = z.read("program.pt2")
        if isinstance(params, YOLO):
            params = params.fold_batchnorm().state_dict()
        want = meta["weights"]
        int8_program = any(k.endswith(".w_q") for k in want)
        if int8_program != any(k.endswith(".w_q") for k in params):
            raise ValueError(
                f"{path} holds an int8 program and the weights given are "
                f"float: quantize them as the saved Detector was "
                f"(Detector.quantize)" if int8_program else
                f"{path} holds a float program and the weights given are "
                f"int8: save_compiled the quantized Detector")
        for key in list(want) + [k for k in params if k not in want]:
            got = list(params[key].shape) if key in params else None
            if key not in want or got != want[key][0]:
                raise ValueError(
                    f"weights do not match the artifact's architecture: "
                    f"first difference at {key!r}: artifact "
                    f"{want.get(key, [None])[0]} vs given {got}")
        c = meta["cfg"]
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in c.items()})
        knobs = dict(meta["knobs"])
        knobs["compute_dtype"] = getattr(torch, knobs["compute_dtype"])
        det = cls(YOLO.from_state_dict(cfg, params), device=device, **knobs)
        if list(det._weights_spec().items()) != list(want.items()):
            raise ValueError("weights do not match the artifact's spec after "
                             "conversion to its dtype and memory format")
        weights = tuple(det.model.state_dict().values())
        program = torch.export.load(io.BytesIO(program_bytes)).module()

        def run(*inputs):
            with torch.inference_mode():
                with telemetry.span("layer.serve.stage"):
                    inputs = det._stage(inputs)
                return program(weights, *inputs)

        if meta["staged"]:
            det._predict_staged = run
        else:
            det._predict = run
        det._fixed_batch = meta["batch_size"]
        return det

    def detect_one(self, image, rescale: bool = True) -> dict:
        """Single-image detection. `image` is a path or an (H, W, 3) uint8
        RGB array; returns {path, boxes (N,4) xyxy (original pixels when
        `rescale`), scores, classes}."""
        s = self.input_size
        if isinstance(image, (str, os.PathLike)):
            path = os.fspath(image)
            imgs = self._decode_buffer(self._fixed_batch or 1)
            metas = self._decode_batch([path], imgs)
        else:
            imgs = np.zeros((self._fixed_batch or 1, s, s, 3), np.uint8)
            img = np.asarray(image)
            if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
                raise ValueError(f"detect_one expects (H, W, 3) uint8 RGB, "
                                 f"got {img.shape} {img.dtype}")
            path = "<array>"
            h, w = img.shape[:2]
            # the serving decode geometry: long side -> s (up or down),
            # then the centered round(pad -/+ 0.1) letterbox pad
            r = s / max(h, w)
            if r != 1:
                import cv2

                img = cv2.resize(img, (int(w * r), int(h * r)),
                                 interpolation=cv2.INTER_LINEAR)
            nh, nw = img.shape[:2]
            pad_w, pad_h = (s - nw) / 2, (s - nh) / 2
            top, left = int(round(pad_h - 0.1)), int(round(pad_w - 0.1))
            imgs[0, top:top + nh, left:left + nw] = img
            metas = np.array([[nw / w, pad_w, pad_h, w, h]], np.float32)
        res = self._fetch(self.detect_batch(imgs))
        return next(iter(self._emit(res, metas, [path], rescale)))

    def stream(self, paths: Iterable[str], batch_size: int = 64,
               rescale: bool = True) -> Iterator[dict]:
        """Double-buffered streaming over image paths; yields one dict per
        image: {path, boxes (N,4) xyxy original pixels, scores, classes}.
        With device_letterbox the buffers hold (batch_size, stage_size,
        stage_size, 3) raw pixels and (batch_size, 2) true sizes; a
        partial last batch is padded with zero pixels of size 1 x 1. A
        Detector from `load_compiled` streams at its artifact's batch size
        whatever `batch_size` says."""
        if self._fixed_batch is not None:
            batch_size = self._fixed_batch
        paths = list(paths)
        if self._dp is not None and batch_size % len(self._dp.devices):
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{len(self._dp.devices)} devices")
        staged = self.device_letterbox
        s = self.stage_size if staged else self.input_size
        pin = self.device.type == "cuda"
        # on the card the images are decoded into device buffers
        staging = [torch.zeros((batch_size, s, s, 3), dtype=torch.uint8,
                               device=self.device if pin else "cpu")
                   for _ in range(2)]
        sizes = [torch.ones((batch_size, 2), dtype=torch.float32, pin_memory=pin)
                 for _ in range(2)]
        pending = None  # (fetched result, metas, batch paths)
        for n, start in enumerate(range(0, len(paths), batch_size)):
            chunk = paths[start:start + batch_size]
            # staging[n % 2] and sizes[n % 2] are free: batch n-2's
            # result, emitted last round, came after their copies in
            # stream order (and on the card the decode streams wait for
            # the batches enqueued before)
            host = staging[n % 2]
            host[len(chunk):] = 0
            # the pipelines fill a device tensor on the card, else an array
            batch = host[:len(chunk)] if pin else host[:len(chunk)].numpy()
            if staged:
                dims = self._decode_batch_raw(chunk, batch)
                metas = self._metas_from_dims(dims, self.input_size)
                hw = sizes[n % 2]
                hw[:len(chunk)] = torch.from_numpy(np.maximum(dims[:, :2], 1.0))
                hw[len(chunk):] = 1.0
                res = self._serve(self._predict_staged, host, hw)
            else:
                metas = self._decode_batch(chunk, batch)
                res = self._serve(self._predict, host)
            res = self._fetch(res)
            if pending is not None:
                yield from self._emit(*pending, rescale)
            pending = (res, metas, chunk)
        if pending is not None:
            yield from self._emit(*pending, rescale)

    _fetch = staticmethod(fetch_async)

    def _emit(self, fetched, metas, chunk, rescale):
        res, done = fetched
        if done is not None:
            done.synchronize()
        res = {k: v.numpy() for k, v in res.items()}
        for i, path in enumerate(chunk):
            n = int(res["count"][i])
            if metas[i, 0] < 0:  # decode failure
                yield {"path": path, "boxes": np.zeros((0, 4), np.float32),
                       "scores": np.zeros(0, np.float32),
                       "classes": np.zeros(0, np.int32), "error": "decode"}
                continue
            boxes = np.array(res["boxes"][i][:n], np.float32)
            if rescale and n:
                r, pw, ph, ow, oh = metas[i][:5]
                ry = metas[i][5] if metas.shape[1] > 5 else r
                boxes[:, [0, 2]] = ((boxes[:, [0, 2]] - pw) / r).clip(0, ow)
                boxes[:, [1, 3]] = ((boxes[:, [1, 3]] - ph) / ry).clip(0, oh)
            yield {"path": path, "boxes": boxes,
                   "scores": np.array(res["scores"][i][:n], np.float32),
                   "classes": np.array(res["classes"][i][:n], np.int32)}


def _environment(device: torch.device) -> dict:
    """What a saved program is bound to: the platform, the device's name,
    torch's and CUDA's versions."""
    return {"platform": device.type,
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}


class _Cv2Letterbox:
    """NativePipeline.load_batch's contract through cv2, for a machine
    where the native library cannot be built: load_image + letterbox per
    image in a thread pool (cv2 releases the GIL)."""

    stager = "cv2"

    def __init__(self, input_size: int, threads: int):
        self.input_size, self.threads = input_size, threads

    def load_batch(self, paths: list[str], out: np.ndarray):
        import cv2

        from tpu_yolo_torch.data.image import letterbox, load_image

        s = self.input_size
        metas = np.full((len(paths), 5), -1, np.float32)

        def decode(i):
            try:
                img, (h, w) = load_image(paths[i], s)
                boxed, ratio, pad = letterbox(img, s)
            except (OSError, cv2.error):
                out[i] = 0
                return
            out[i] = boxed[:, :, ::-1]
            # load_image pre-scales (long side -> input_size); fold that
            # and the letterbox ratio into one original->net scale
            metas[i] = (ratio[0] * img.shape[1] / w, pad[0], pad[1], w, h)

        with ThreadPoolExecutor(self.threads) as pool:
            list(pool.map(decode, range(len(paths))))
        return out, metas, int((metas[:, 0] < 0).sum())


class _ServingProgram(torch.nn.Module):
    """A Detector's serving program as a module over its model."""

    def __init__(self, det: Detector):
        super().__init__()
        self.model = det.model
        self._body = det._program_staged if det.device_letterbox else det._program

    def forward(self, *inputs):
        return self._body(*inputs)
