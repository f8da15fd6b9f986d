"""Spans and counters of the serving path, on the profiler's clock.

Tracing is on while a `torch.profiler` records (`utils/profiler.trace`,
`profile_serve.py`, a benchmark's traced run, any operator's profiler);
a scheduled profiler's wait and warm-up steps leave it off, and inside
`torch.export` or `torch.compile` it is always off, so an exported graph
is the same with a profiler running or not. There is no flag of its own.

  span(name)        a `torch.profiler.record_function` range, its `args`
                    the sequence number of the request it serves; the
                    device work it launches is attributed to it in the
                    profiler's trace, on the same clock
  request()         one served batch: the spans opened inside it share
                    its sequence number
  add(name, value)  a counter: a host number, or a device count (a 0-d
                    tensor, a 1-d one for a tuple of names, or a function
                    that returns one), summed on the device into one
                    int64 vector with no synchronisation when the counts
                    are next read
  note(name, value) a set-up record (`setup.*`), kept whether tracing is
                    on or not
  snapshot()        every counter and record as a plain number (the
                    device vector read once), with the kernel wrappers'
                    launch counts (`launches.<kernel>`)
  reset()           clears the counters and the launch counts; the
                    set-up records stand

Off, a span or a counter costs one boolean test: no `record_function`,
no device op, no allocation. On, a batch launches no kernel for its
counters: the first launch of a kernel in a process can wait for the
device to drain (CUDA's lazy loading), which would stall the first
traced batch, so device counts are held as given and summed by
`snapshot()`, or once `PENDING_MAX` are held.

The serving path's spans (Detector, YOLO.forward_nms, ops/nms.py):
`layer.serve.stage` (the inputs' copy to the device; counters
`stage.host`, host inputs staged on the card, `stage.ring`, those
copied through serve.py's pinned ring, `stage.direct`, those already
pinned, and `stage.slot_wait`, ring slots claimed before their last
copies had ended),
`layer.serve.forward` (`forward_raw`), `layer.serve.nms` (decode and
NMS), split without remainder into `layer.serve.nms.rank`,
`.decode`, `.keep` and `.compact`. Counters: `nms.images`, `nms.slots`
(keep slots offered, B·K), `nms.live` (ranked candidates above conf),
`nms.budget_full` (images whose K-th candidate is above conf),
`nms.kept`, `nms.capped` (images at max_det); `conv.folded` (folded
float convs run on a CUDA tensor, ops/nn.py) and `conv.fused` (those
whose bias, activation and residual ran in the `bias_act` pass). YOLO12
(ops/blocks.py): the span `layer.serve.area_attn` around each area
attention forward in eval (its qkv conv, the kernel, pe and proj), and
the counter `attn.area.calls` (those forwards); `attn.area.kernel`
(ops/attention_cuda.py: the hand-written kernel's launches for them). Set-up:
`setup.place_s`, `setup.first_batch_s` (host seconds of the Detector's
placement and of its first batch), `setup.kernels_built` and
`setup.build_s.<library>` (ops/cuda_build.py's compiles in this
process).
"""
from __future__ import annotations

import sys
import threading

import torch
import torch.autograd.profiler as _autograd_profiler

SERVE_SPANS = ("layer.serve.stage", "layer.serve.forward", "layer.serve.nms",
               "layer.serve.nms.rank", "layer.serve.nms.decode",
               "layer.serve.nms.keep", "layer.serve.nms.compact")
# (launch-count key, module, wrapper) of the kernels counted in `.launches`
_KERNELS = (("psa_attention", "tpu_yolo_torch.ops.attention_cuda", "fused_attention"),
            ("nms_greedy_keep", "tpu_yolo_torch.ops.nms_cuda", "greedy_keep"),
            ("topk_mask", "tpu_yolo_torch.ops.topk_cuda", "topk_mask"),
            ("bias_act", "tpu_yolo_torch.ops.bias_act_cuda", "bias_act"),
            ("area_attention", "tpu_yolo_torch.ops.attention_cuda", "area_attention"))
_SLOTS = 16   # device counters a process may name
PENDING_MAX = 32   # device counts held before they are summed

_lock = threading.Lock()
_host: dict[str, float] = {}
_setup: dict[str, float] = {}
_slots: dict[str, int] = {}            # counter name -> slot of the device vectors
_vectors: dict[torch.device, torch.Tensor] = {}
_pending: list = []                    # (first slot, device count) not yet summed
_request: str | None = None            # the request being served, as `args`
_requests = 0


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def on() -> bool:
    """Whether a profiler records here, outside export and compile."""
    return _autograd_profiler._is_profiler_enabled and not torch.compiler.is_compiling()


def span(name: str):
    """A context manager: the range `name` while tracing is on."""
    if not on():
        return _OFF
    return torch.profiler.record_function(name, _request)


class _Request:
    def __enter__(self):
        global _request, _requests
        self._outer = _request
        _requests += 1
        _request = str(_requests)

    def __exit__(self, *exc):
        global _request
        _request = self._outer
        return False


def request():
    """A context manager around one served batch: the spans opened in it
    carry its sequence number (1, 2, ... in the process) while tracing is
    on."""
    if not on():
        return _OFF
    return _Request()


def _slot(name: str) -> int:
    with _lock:
        if name not in _slots:
            if len(_slots) == _SLOTS:
                raise RuntimeError(f"telemetry: more than {_SLOTS} device counters")
            _slots[name] = len(_slots)
        return _slots[name]


def _vector(device: torch.device) -> torch.Tensor:
    vec = _vectors.get(device)
    if vec is None:
        # a plain tensor, so that it takes adds in and out of inference mode
        with torch.inference_mode(False):
            vec = _vectors.setdefault(device, torch.zeros(_SLOTS, dtype=torch.int64,
                                                          device=device))
    return vec


def add(name, value) -> None:
    """Add `value` to the counter `name` while tracing is on: a host
    number now; a device count (an integer tensor, 0-d for one name or
    1-d for a tuple of names whose slots then follow one another, or a
    function that returns one) when the counts are next summed."""
    if not on():
        return
    if not (isinstance(value, torch.Tensor) or callable(value)):
        with _lock:
            _host[name] = _host.get(name, 0) + value
        return
    names = (name,) if isinstance(name, str) else tuple(name)
    lo = _slot(names[0])
    if [_slot(n) for n in names] != list(range(lo, lo + len(names))):
        raise ValueError(f"telemetry: counters {names} were named apart before")
    with _lock:
        _pending.append((lo, value))
        full = len(_pending) >= PENDING_MAX
    if full:
        _sum_pending()


def _sum_pending() -> None:
    """Sum the held device counts into the device vectors."""
    with _lock:
        held = list(_pending)
        _pending.clear()
    for lo, value in held:
        value = value() if callable(value) else value
        vec = _vector(value.device)
        vec[lo:lo + value.numel()].add_(value)


def note(name: str, value: float, accumulate: bool = False) -> None:
    """Record the set-up quantity `name` (set, or added to with
    `accumulate`), whether tracing is on or not."""
    with _lock:
        _setup[name] = _setup.get(name, 0) + value if accumulate else value


def _wrappers():
    """(key, wrapper) of each kernel wrapper loaded: each counts its
    launches in `.launches`."""
    for key, module, attr in _KERNELS:
        mod = sys.modules.get(module)
        if mod is not None:
            yield key, getattr(mod, attr)
    image = sys.modules.get("tpu_yolo_torch.ops.image_cuda")
    if image is not None:
        yield from image._WRAPPERS.items()


def launches() -> dict:
    """{`launches.<kernel>`: the launches its wrapper has counted}, read
    from the wrappers."""
    return {"launches." + key: w.launches for key, w in _wrappers()}


def snapshot() -> dict:
    """Every counter, set-up record and launch count, as plain numbers."""
    _sum_pending()
    out = dict(_setup)
    out.update(_host)
    for vec in list(_vectors.values()):
        values = vec.tolist()
        for name, i in _slots.items():
            out[name] = out.get(name, 0) + values[i]
    out.update(launches())
    return out


def reset() -> None:
    """Clear the counters and the wrappers' launch counts."""
    with _lock:
        _host.clear()
        _pending.clear()
        _vectors.clear()
    for _, w in _wrappers():
        w.launches = 0


def device_seconds(prof, prefix: str = "layer.serve") -> dict:
    """{span: device seconds of the work launched inside it} over a
    finished `torch.profiler.profile`, for the ranges whose names start
    with `prefix`."""
    out: dict = {}
    for e in prof.events():
        if not e.kernels:
            continue
        chain, p = set(), e.cpu_parent
        while p is not None:
            if p.name.startswith(prefix):
                chain.add(p.name)
            p = p.cpu_parent
        if e.name.startswith(prefix):
            chain.add(e.name)
        for k in e.kernels:
            if k.name.startswith(prefix):   # a range's own span on the device
                continue
            for name in chain:
                out[name] = out.get(name, 0.0) + k.duration / 1e6
    return out
