"""Model export: the eval forward as a `torch.export` program (the
counterpart of `tpu_yolo/utils/export.py`, whose artifact is StableHLO).

The program is the eval forward with the decode and without NMS: uint8
(B, S, S, 3) images -> /255 in the compute dtype -> (B, A, 4+nc) pixel
xywh boxes and class probabilities. The weights are its first input, as
in `serve.Detector.save_compiled`, so the file holds the graph alone and
every fine-tune of the architecture runs through it; the PSA attention
kernel appears in it as the custom op `tpu_yolo_torch::psa_attention`.
`batch=None` gives a symbolic batch (`torch.export.Dim`), the StableHLO
export's symbolic shape. The program runs on the device it was exported
on (its anchor grid is a constant there). No ahead-of-time compilation.
"""
from __future__ import annotations

import io
import json
import os

import torch
from torch import nn

from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.ops.anchors import device_anchors

PROGRAM = "program.pt2"
MANIFEST = "manifest.json"


class WeightsAsInputs(nn.Module):
    """`module` with its state dict as the first input (a tuple in
    state-dict order), for torch.export: the module is held outside the
    module tree, so the export lifts no parameter, and
    `torch.func.functional_call` runs it with the given tensors in place
    of its own."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self._module = (module,)
        self.keys = list(module.state_dict())

    def forward(self, weights, *inputs):
        return torch.func.functional_call(self._module[0],
                                          dict(zip(self.keys, weights)), inputs)


class _EvalForward(nn.Module):
    """uint8 NHWC images -> the model's decoded eval forward."""

    def __init__(self, model: nn.Module, compute_dtype):
        super().__init__()
        self.model, self.compute_dtype = model, compute_dtype

    def forward(self, images_u8):
        return self.model(images_u8.to(self.compute_dtype) / 255)


def export_program(model, cfg: ModelConfig, input_size: int, out_dir: str,
                   batch: int | None = None, compute_dtype=torch.bfloat16) -> dict:
    """Export the eval forward of `model` (BatchNorm folded in place
    first), on its device, to out_dir/program.pt2 with a manifest.json.
    batch=None exports a symbolic batch of any size >= 1; an int pins it.
    The program takes the model's state dict as it is (the compute dtype
    is applied inside, as the model's forward does). Returns the
    manifest."""
    model = model.fold_batchnorm().eval()
    weights = tuple(t.detach() for t in model.state_dict().values())
    device = weights[0].device
    program = WeightsAsInputs(_EvalForward(model, compute_dtype))
    # the anchor grid is a constant of the program: made here, outside
    # the trace (keyed by the device as tensors carry it)
    device_anchors((input_size, input_size), tuple(cfg.strides),
                   torch.empty(0, device=device).device)
    images = torch.zeros((2 if batch is None else batch, input_size, input_size,
                          cfg.width[0]), dtype=torch.uint8, device=device)
    dynamic = None
    if batch is None:
        dynamic = (tuple(None for _ in weights),          # weights, *inputs
                   ({0: torch.export.Dim("batch", min=1)},))
    with torch.no_grad():
        exported = torch.export.export(program, (weights, images),
                                       dynamic_shapes=dynamic, strict=False)
    exported.example_inputs = None  # they hold the weights
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, PROGRAM), "wb") as f:
        f.write(blob)
    manifest = {
        "format": "torch.export",
        "input": f"uint8[{'b' if batch is None else batch},{input_size},"
                 f"{input_size},{cfg.width[0]}]",
        "output": "(B, A, 4+nc) pixel xywh + class probabilities",
        "num_classes": cfg.num_classes,
        "input_size": input_size,
        "compute_dtype": str(compute_dtype).split(".")[-1],
        "platform": device.type,
        "weights": {k: [list(t.shape), str(t.dtype).split(".")[-1]]
                    for k, t in model.state_dict().items()},
        "bytes": len(blob),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_program(out_dir: str):
    """Reload an exported program; returns callable(params, images): the
    state dict (or the model) it was exported from, in the same dtypes
    and on its device, and uint8 (B, S, S, 3) images -> (B, A, 4+nc)."""
    with open(os.path.join(out_dir, MANIFEST)) as f:
        keys = list(json.load(f)["weights"])
    program = torch.export.load(os.path.join(out_dir, PROGRAM)).module()

    def run(params, images):
        if isinstance(params, nn.Module):
            params = params.state_dict()
        weights = tuple(params[k] for k in keys)
        with torch.inference_mode():
            return program(weights, torch.as_tensor(images).to(weights[0].device))

    return run
