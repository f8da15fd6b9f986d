"""Batch serving in a closed loop: one client keeps `in_flight` batch
requests outstanding. It calls `Detector.detect_batch` for batch i+1
before it waits for batch i's detections; each batch is `batch` distinct
images, taken in turn from a pool of `pool_images` seeded images in
pageable host memory, so the input copy is part of every request; each
request ends when its detections (boxes, scores, classes, counts) are in
host memory.

Traffic parameters (traffic/<name>.json): batch, in_flight, pool_images,
calib_images, conf, iou, max_det, max_nms, multi_label, gamma,
class_bias, warmup_batches, trace_skip, trace_batches, check_batches,
ref_block.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from card_bench import compare, costs, data, weights
from card_bench.harness import Laps, Spans, profiler, quantile
from card_bench.reference.detect import decode, nms
from card_bench.reference.model import Net
from card_bench.reference.precision import exact_f32

KEYS = ("boxes", "scores", "classes", "count")


class Driver:
    def __init__(self, cell):
        self.cell, self.t, self.spec = cell, cell.traffic, cell.spec
        self.dev = torch.device(cell.device)
        self.spans = Spans(cell.trace)
        self.keep_bound_ms = {}
        self._open = []   # ranges opened by the traced run's hooks

    # -- set-up -----------------------------------------------------------
    def setup(self):
        from tpu_yolo_torch import YOLO, Detector, get_model_config

        t, spec, cfg = self.t, self.spec, self.cell.config
        s = spec.input_size
        self.laps = lap = Laps()
        images = data.seeded_images(data.generator(self.cell.seed, 0, self.dev),
                                    t["pool_images"], s, self.dev)
        self.W = weights.make(spec, self.cell.seed, images[:t["calib_images"]],
                              gamma=t["gamma"], class_bias=t["class_bias"])
        lap("weights")
        self.pool = images.cpu()              # pageable host memory
        del images
        lap("pool")
        model = YOLO.from_state_dict(get_model_config(cfg["program_size"], spec.num_classes),
                                     {k: v.cpu() for k, v in self.W.items()})
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

    def batch_images(self, i):
        b = self.t["batch"]
        slot = i % self.slots
        return self.pool[slot * b:(slot + 1) * b]

    # -- one request --------------------------------------------------------
    def _issue(self):
        i = self.next
        self.next += 1
        buf = self.ring[i % len(self.ring)]
        t0 = time.perf_counter()
        with self.spans("bench.request"):
            res = self.det.detect_batch(self.batch_images(i))
            while self._open:
                self._open.pop().__exit__(None, None, None)
        with self.spans("bench.fetch"):
            for k in KEYS:
                buf[k].copy_(res[k], non_blocking=True)
            done = None
            if self.dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        self.inflight.append((i, t0, buf, done))

    def _sample(self):
        """Start the window's sample afresh: one batch a pool slot, each
        the window's batches of that slot sampled evenly from the seed
        (reservoir sampling), so the window keeps a few results, not all."""
        self.latency.clear()
        self.failed = 0
        self.kept, self.seen = {}, [0] * self.slots
        self.rng = np.random.default_rng(self.cell.seed % (2 ** 63))

    def _complete(self):
        i, t0, buf, done = self.inflight.popleft()
        with self.spans("bench.wait"):
            if done is not None:
                done.synchronize()
        self.latency.append(time.perf_counter() - t0)
        count = buf["count"]
        self.failed += not (0 <= int(count.min()) and int(count.max()) <= self.t["max_det"])
        slot = i % self.slots
        self.seen[slot] += 1
        if self.rng.random() * self.seen[slot] < 1:
            self.kept[slot] = (i, {k: v.clone() for k, v in buf.items()})

    # -- the measured window --------------------------------------------------
    def window(self, seconds: float) -> dict:
        t = self.t
        first = self.first = self.next
        self._sample()
        if self.cell.trace:
            self._hooks()
        prof = profiler(self.cell.trace, t["trace_skip"], t["trace_batches"])
        with prof:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                self._issue()
                prof.step()
                if len(self.inflight) >= t["in_flight"]:
                    self._complete()
            while self.inflight:
                self._complete()
            wall = time.perf_counter() - t0
        self.prof = prof if self.cell.trace else None
        n = self.next - first
        imgs = n * t["batch"]
        return {"attempted": n, "failed": self.failed, "window_s": wall, "items": imgs,
                "metrics": {"serve_img_per_s": imgs / wall,
                            "serve_batch_p95_ms": quantile(self.latency, 0.95) * 1e3}}

    def _hooks(self):
        """Traced runs only: layer.forward from the stem's call to the end
        of the last head conv, layer.nms from there to detect_batch's
        return."""
        model = self.det.model

        def enter(tag):
            def hook(*_):
                self._open.append(torch.profiler.record_function(tag).__enter__())
            return hook

        def leave(*_):
            self._open.pop().__exit__(None, None, None)

        def forward_done(*_):
            leave()
            enter("layer.nms")()

        stem, last = model.net["p1"][0], model.head["cls"][-1][-1]
        stem.register_forward_pre_hook(enter("layer.forward"))
        last.register_forward_hook(forward_done)

    # -- after the window ---------------------------------------------------------
    def release(self):
        del self.det
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def picks(self) -> list:
        """The window's batches the comparison takes: `check_batches` of
        the pool slots the window served, drawn from the seed, and of each
        the batch the window kept (`_sample`), as (index, its detections
        in host memory)."""
        slots = np.random.default_rng(self.cell.seed % (2 ** 63) + 1).permutation(self.slots)
        served = [s for s in slots if s in self.kept]
        return sorted(self.kept[s] for s in served[:self.t["check_batches"]])

    def check(self) -> dict:
        """The comparison (compare.py) of the picked batches, as they
        reached host memory, with the reference's detections of their
        images."""
        t = self.t
        parts = [compare.serving({k: v.to(self.dev) for k, v in result.items()},
                                 self.reference(i), t["conf"], t["max_det"])
                 for i, result in self.picks()]
        return {**compare.summary(parts), "batches_compared": len(parts)}

    @torch.no_grad()
    def reference(self, i: int) -> dict:
        """The reference's detections of batch `i`'s images, in blocks of
        `ref_block` images, kept for the run; beside them the least time
        of the greedy keep over the reference's candidates of the batch
        (costs.nms_cost), which is the keep's work on these images."""
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
                boxes, logits, _, _ = decode(self.spec, Net(self.spec, self.W).forward(xb))
                dets.append(nms(boxes, logits, t["conf"], t["iou"], t["max_det"], t["max_nms"]))
        cand = [torch.cat([d["candidates"][j] for d in dets]) for j in range(3)]
        self.keep_bound_ms[slot] = costs.nms_cost(*cand)[0]
        cache[slot] = {k: torch.cat([d[k] for d in dets]) for k in dets[0] if k != "candidates"}
        return cache[slot]

    def layer_context(self) -> dict:
        """What the per-layer readers need besides the trace; after
        `check`, which works out the keep's bounds of the compared slots."""
        f = costs.model_flops(self.spec, 1)
        lo = self.first + self.t["trace_skip"] + 1
        traced = [i % self.slots for i in range(lo, lo + self.t["trace_batches"])]
        return {"flops_per_item": f["conv"] + f["attention"],
                "attention_calls": costs.model_flops(self.spec, self.t["batch"])["attention_calls"],
                "keep_bounds_ms": [self.keep_bound_ms[s] for s in traced if s in self.keep_bound_ms],
                "batches_traced": self.t["trace_batches"]}
