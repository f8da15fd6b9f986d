"""Batch serving of YOLO12 in a closed loop: drivers/serve.py's Driver (the
loop, the window, the hooks, the comparison) with the seeded weights, the
reference detections and the per-layer context of YOLO12's reference
(reference/yolo12.py).

Weights as weights.py makes them for YOLO11, from YOLO12's layout: every
conv kernel Kaiming-uniform from one draw, BatchNorm's beta 0, mean 0,
var 1 and gamma the traffic's, the head's prior biases and class biases
N(class_bias, 0.5), the layer scales at Ultralytics' initial 0.01; then
the reference's "calibrate" pass sets the BatchNorm statistics.

The program has to know the configuration's `program_size`: one that
does not (a program without YOLO12) fails before anything is made.
"""
from __future__ import annotations

import collections

import torch

from card_bench import costs, data
from card_bench.drivers import serve
from card_bench.harness import Laps
from card_bench.reference.detect import decode, nms
from card_bench.reference.model import prior_biases
from card_bench.reference.precision import exact_f32
from card_bench.reference.yolo12 import Net12, Spec12, layout, model_flops
from card_bench.weights import _generator

LAYER_SCALE = 0.01   # Ultralytics' A2C2f initialises its gamma at 0.01


def init_weights(spec: Spec12, seed: int, device) -> dict:
    """{leaf name: float32 tensor on `device`} of a fresh YOLO12."""
    rows = layout(spec)
    convs = [(n, s, f) for n, s, f in rows if f]
    flat = torch.rand(sum(torch.Size(s).numel() for _, s, _ in convs),
                      generator=_generator(seed, device), device=device).mul_(2).sub_(1)
    W, off = {}, 0
    for name, shape, fan_in in convs:
        n = torch.Size(shape).numel()
        W[name] = flat[off:off + n].view(shape).mul_(fan_in ** -0.5)
        off += n
    fills = {"gamma": 1.0, "var": 1.0, "scale": LAYER_SCALE}
    for name, shape, fan_in in rows:
        if not fan_in:
            W[name] = torch.full(shape, fills.get(name.rsplit(".", 1)[1], 0.0), device=device)
    prior_biases(spec, W)
    return W


def make(spec: Spec12, seed: int, calib_u8: torch.Tensor, gamma: float,
         class_bias: float) -> dict:
    """Seeded weights on `calib_u8`'s device (module docstring), as
    weights.make makes YOLO11's; `calib_u8` (N, H, W, 3) uint8."""
    device = calib_u8.device
    W = init_weights(spec, seed, device)
    for k, v in W.items():
        if k.endswith(".gamma"):
            v.fill_(gamma)
    gen = _generator(seed + 1, device)
    for i in range(len(spec.strides)):
        W[f"head.cls.{i}.4.b"] = torch.randn(spec.num_classes, generator=gen,
                                             device=device).mul_(0.5).add_(class_bias)
    with torch.no_grad(), exact_f32():
        Net12(spec, W, mode="calibrate").forward(calib_u8.permute(0, 3, 1, 2).float() / 255)
    return W


class Driver(serve.Driver):
    def __init__(self, cell):
        super().__init__(cell)
        self.spec = Spec12(cell.config)

    def setup(self):
        from tpu_yolo_torch import YOLO, Detector, get_model_config

        t, spec, cfg = self.t, self.spec, self.cell.config
        program_cfg = get_model_config(cfg["program_size"], spec.num_classes)
        s = spec.input_size
        self.laps = lap = Laps()
        images = data.seeded_images(data.generator(self.cell.seed, 0, self.dev),
                                    t["pool_images"], s, self.dev)
        self.W = make(spec, self.cell.seed, images[:t["calib_images"]], gamma=t["gamma"],
                      class_bias=t["class_bias"])
        lap("weights")
        self.pool = images.cpu()              # pageable host memory
        del images
        lap("pool")
        model = YOLO.from_state_dict(program_cfg, {k: v.cpu() for k, v in self.W.items()})
        self.det = Detector(model, input_size=s, conf_thres=t["conf"], iou_thres=t["iou"],
                            max_det=t["max_det"], max_nms=t["max_nms"],
                            multi_label=t["multi_label"],
                            compute_dtype=getattr(torch, cfg["compute_dtype"]),
                            device=self.dev)
        b, d = t["batch"], t["max_det"]
        pin = self.dev.type == "cuda"
        self.ring = [{"boxes": torch.empty((b, d, 4), pin_memory=pin),
                      "scores": torch.empty((b, d), pin_memory=pin),
                      "classes": torch.empty((b, d), dtype=torch.int32, pin_memory=pin),
                      "count": torch.empty((b,), dtype=torch.int32, pin_memory=pin)}
                     for _ in range(t["in_flight"] + 1)]
        lap("program")
        self.slots = t["pool_images"] // b
        self.inflight = collections.deque()
        self.latency = []
        self.next = 0
        self._sample()
        for _ in range(t["warmup_batches"]):
            self._issue()
            self._complete()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        lap("warm-up")

    @torch.no_grad()
    def reference(self, i: int) -> dict:
        """serve.Driver.reference with YOLO12's reference forward."""
        cache = self.__dict__.setdefault("_ref", {})
        slot = i % self.slots
        if slot in cache:
            return cache[slot]
        t = self.t
        x_u8 = self.batch_images(i).to(self.dev)
        dets = []
        with exact_f32():
            for lo in range(0, len(x_u8), t["ref_block"]):
                xb = x_u8[lo:lo + t["ref_block"]].permute(0, 3, 1, 2).float() / 255
                boxes, logits, _, _ = decode(self.spec, Net12(self.spec, self.W).forward(xb))
                dets.append(nms(boxes, logits, t["conf"], t["iou"], t["max_det"], t["max_nms"]))
        cand = [torch.cat([d["candidates"][j] for d in dets]) for j in range(3)]
        self.keep_bound_ms[slot] = costs.nms_cost(*cand)[0]
        cache[slot] = {k: torch.cat([d[k] for d in dets]) for k in dets[0] if k != "candidates"}
        return cache[slot]

    def layer_context(self) -> dict:
        """serve.Driver.layer_context from YOLO12's reference: the FLOPs
        of an image, and the area attention's calls of a batch
        (`area_attention_calls`: YOLO12 has no other attention)."""
        f = model_flops(self.spec, 1)
        lo = self.first + self.t["trace_skip"] + 1
        traced = [i % self.slots for i in range(lo, lo + self.t["trace_batches"])]
        return {"flops_per_item": f["conv"] + f["attention"],
                "area_attention_calls": model_flops(self.spec, self.t["batch"])["attention_calls"],
                "keep_bounds_ms": [self.keep_bound_ms[s] for s in traced if s in self.keep_bound_ms],
                "batches_traced": self.t["trace_batches"]}
