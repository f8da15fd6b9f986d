"""Model profiling: parameter count, FLOPs, bytes and timeline traces
(the counterpart of `tpu_yolo/utils/profiler.py`).

FLOPs come from `torch.utils.flop_counter.FlopCounterMode` over the eval
forward: 2·MACs of every convolution and product, and of the PSA
attention custom op by the formula registered beside it
(ops/attention_cuda.py). The JAX package reads XLA's cost model instead,
which counts the same products plus the elementwise work it fuses. The
timeline tracer is `torch.profiler` (a Chrome trace) in place of
`jax.profiler`.
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from tpu_yolo_torch.core.config import ModelConfig

aten = torch.ops.aten


def count_params(model_or_state) -> int:
    """Every tensor of the state dict: parameters and buffers (BatchNorm
    statistics and int8 scales included), as the JAX package counts every
    leaf of its tree."""
    if isinstance(model_or_state, torch.nn.Module):
        model_or_state = model_or_state.state_dict()
    return sum(int(t.numel()) for t in model_or_state.values())


class _ProductBytes(TorchDispatchMode):
    """Sums the operand and result bytes of every convolution and product
    (the attention op included) dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0
        # an op is seen once, at the level it is called from (under
        # inference mode, conv2d and matmul before their decomposition)
        self._products = {aten.conv2d, aten.convolution, aten.matmul, aten.mm,
                          aten.addmm, aten.bmm, aten._int_mm,
                          torch.ops.tpu_yolo_torch.psa_attention}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self._products:
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in tree_leaves((args, kwargs, out))
                               if isinstance(t, torch.Tensor))
        return out


def profile_model(model, cfg: ModelConfig, input_size: int = 640, batch: int = 1,
                  compute_dtype=torch.bfloat16) -> dict:
    """One eval forward of `model` on its device at (batch, input_size) in
    `compute_dtype`: {params, flops, gflops, bytes_accessed}, FLOPs and
    bytes per image. `bytes_accessed` is the operand and result bytes of
    the convolutions and products, not XLA's cost-model figure, which
    also counts the elementwise work."""
    import tpu_yolo_torch.ops.attention_cuda  # noqa: F401  (the op and its formula)

    device = next(iter(model.state_dict().values())).device
    x = torch.zeros((batch, input_size, input_size, cfg.width[0]), dtype=torch.uint8,
                    device=device)
    flops, io = FlopCounterMode(display=False), _ProductBytes()
    with torch.inference_mode(), flops, io:
        model(x.to(compute_dtype) / 255)
    per_image = flops.get_total_flops() / batch
    return {"params": count_params(model), "flops": per_image,
            "gflops": per_image / 1e9, "bytes_accessed": io.nbytes / batch}


def print_profile(model, cfg: ModelConfig, input_size: int = 640,
                  compute_dtype=torch.bfloat16) -> dict:
    """The startup banner: parameters and GFLOPs at `input_size`."""
    r = profile_model(model, cfg, input_size, compute_dtype=compute_dtype)
    print(f"Number of parameters: {r['params']}")
    print(f"GFLOPs (torch.utils.flop_counter, {input_size}px): {r['gflops']:.2f}")
    return r


@contextlib.contextmanager
def trace(log_dir: str):
    """Timeline trace: `with trace(dir):` records the host and, where
    there is a card, the device, and writes dir/trace.json (a Chrome
    trace for Perfetto or chrome://tracing) at the end. Yields the
    `torch.profiler.profile` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
