"""The yardstick's arithmetic: the card's peaks, the least time of each
hand-written kernel's work, and the model's operations.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its 700 W limit. The kernel costs are frozen copies of `chip_smoke.py`'s
`attention_cost`, `nms_cost` and `_bound`; the conv byte
and FLOP model is `tpu_yolo_torch/roofline.py`'s `conv_cost`. The
model's shapes come from the reference model (reference/model.py) run
over meta tensors, so the count follows the architecture and not the
program's code.
"""
from __future__ import annotations

import torch

PEAK_BF16 = 989.4e12         # FLOP/s, dense
PEAK_F32 = 67e12             # FLOP/s, outside the tensor cores
HBM_BYTES_S = 3.35e12        # bytes/s
IOU_FLOPS_PER_PAIR = 14      # f32 operations of one masked IoU test


def _bound(nbytes, flops, peak):
    """(least ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_cost(bh, t, dk, dh, element_size=2, peak=PEAK_BF16):
    """softmax(q·kᵀ)·v over (bh, t) heads: q, k, v read once and the
    output written once; the two products' flops at the inputs' rate."""
    nbytes = (2 * bh * t * dk + 2 * bh * t * dh) * element_size
    flops = 2 * bh * t * t * (dk + dh)
    return _bound(nbytes, flops, peak)


def nms_cost(boxes, cls, valid):
    """The greedy keep over (B, K) candidates: boxes, classes, valid and
    keep moved once each; the f32 flops of the IoU tests this data
    needs, pairs j < i of one class with a valid j."""
    b, k, _ = boxes.shape
    nbytes = b * k * (16 + 4 + 1 + 1)
    same = cls[:, :, None] == cls[:, None, :]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    pairs = int((same & later & valid[:, :, None]).sum())
    return _bound(nbytes, pairs * IOU_FLOPS_PER_PAIR, PEAK_F32)


def conv_cost(x_shape, w_shape, y_shape):
    """(flops, bytes) of one inference conv, NCHW shapes: it reads its
    input and weight and writes its output once (bf16)."""
    b, _, hi, wi = x_shape
    cout, cin_g, kh, kw = w_shape
    ho, wo = y_shape[2], y_shape[3]
    flops = 2 * b * ho * wo * cout * kh * kw * cin_g
    n_in, n_out, n_w = b * x_shape[1] * hi * wi, b * cout * ho * wo, cout * cin_g * kh * kw
    return flops, 2 * (n_in + n_out + n_w)


def model_flops(spec, batch: int) -> dict:
    """Operations of one forward of `batch` images at the configuration's
    input size: {"conv": flops, "attention": flops, "attention_calls":
    [(bh, t, dk, dh), ...]}, from the reference model's shapes."""
    from card_bench.reference.model import Net, layout

    with torch.device("meta"):
        W = {n: torch.empty(s) for n, s, _ in layout(spec)}
        net = Net(spec, W)
        net.convs, net.products = [], []
        s = spec.input_size
        net.forward(torch.empty(batch, spec.width[0], s, s))
    conv = sum(conv_cost(x, w, y)[0] for _, x, w, y, _, _ in net.convs)
    attn = sum(2 * bh * t * t * (dk + dh) for bh, t, dk, dh in net.products)
    return {"conv": conv, "attention": attn, "attention_calls": net.products}
