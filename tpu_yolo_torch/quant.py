"""Post-training int8 quantization (W8A8) for the inference path, the
counterpart of `tpu_yolo/quant.py`.

  * every folded conv runs int8 x int8 -> exact int32 sums
    (ops/nn.py::int8_conv2d): weights per output channel symmetric,
    inputs per tensor symmetric with a scale calibrated on sample images;
  * the quantize and dequantize passes sit around each conv, so the
    activations between ops keep the compute dtype: concats, residual
    adds, SiLU, the attention kernel and SPPF's pooling are unchanged;
  * calibration runs the eval forward once over the sample images and
    records each folded conv's input absmax (f32) through forward
    pre-hooks, the role of the JAX package's `Context(calibrate=True)`.

A module path (`net.p1.0`) names a conv here where the JAX package has
its param-tree path (`net/p1/0`). The weight arithmetic is numpy f32 as
there, so for the same absmax both packages give the same `w_q`, `s_w`
and `s_in` bits. A quantized conv's state-dict leaves are
{w_q int8 OIHW, s_w (O,) f32, s_in () f32, b (O,) f32}.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu_yolo_torch.ops.nn import ConvBN, quantize_weight


def calibrate(model: nn.Module, sample_images_u8,
              compute_dtype=torch.bfloat16) -> dict[str, float]:
    """Run the sample images (N, H, W, 3) uint8 through the model's eval
    forward in `compute_dtype` on the model's device, in one batch, and
    return {module path: max |input|} (in f32) of every folded conv that
    is not quantized yet."""
    absmax: dict[str, torch.Tensor] = {}

    def observer(name):
        def hook(module, args):
            m = args[0].float().abs().amax()
            absmax[name] = m if name not in absmax else torch.maximum(absmax[name], m)
        return hook

    handles = [m.register_forward_pre_hook(observer(name))
               for name, m in model.named_modules()
               if isinstance(m, ConvBN) and m.folded and not m.quantized]
    device = next(iter(model.state_dict().values())).device
    training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(sample_images_u8)).to(device)
            model.forward_raw(x.to(compute_dtype) / 255)
    finally:
        model.train(training)
        for h in handles:
            h.remove()
    return {k: float(v) for k, v in absmax.items()}


def input_scale(absmax: float, margin: float = 1.0) -> np.float32:
    """s_in = max(absmax · margin, 1e-12) / 127, in f32."""
    return np.float32(max(absmax * margin, 1e-12) / 127.0)


def quantize_params(model_or_state, absmax: dict, margin: float = 1.0):
    """Folded convs -> the int8 form. A model is changed in place and
    returned (ConvBN.quantize_); a state dict gives a new one with the
    {w_q, s_w, s_in, b} leaves. Convs whose path is missing from `absmax`
    stay float. `margin` scales the activation range (> 1 trades
    resolution for fewer clipped inputs)."""
    if isinstance(model_or_state, nn.Module):
        for name, m in model_or_state.named_modules():
            if (isinstance(m, ConvBN) and m.folded and not m.quantized
                    and name in absmax):
                m.quantize_(input_scale(absmax[name], margin))
        return model_or_state
    state = model_or_state

    def folded_conv(prefix):
        w = state.get(f"{prefix}.w")
        return w is not None and w.dim() == 4 and f"{prefix}.b" in state

    out = {}
    for key, t in state.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix not in absmax or not folded_conv(prefix):
            out[key] = t
        elif leaf == "w":
            w_q, s_w = quantize_weight(t.detach().float().cpu().numpy())
            out[f"{prefix}.w_q"] = torch.from_numpy(w_q)
            out[f"{prefix}.s_w"] = torch.from_numpy(s_w)
            out[f"{prefix}.s_in"] = torch.tensor(input_scale(absmax[prefix], margin))
        else:   # the bias
            out[key] = t.detach().float().cpu()
    return out


def quantize_model(model: nn.Module, sample_images_u8, margin: float = 1.0,
                   compute_dtype=torch.bfloat16) -> nn.Module:
    """Calibrate on the sample images, then quantize the model in place.
    Its BatchNorm must be folded."""
    return quantize_params(model, calibrate(model, sample_images_u8, compute_dtype),
                           margin)
