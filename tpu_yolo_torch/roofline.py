"""Per-stage roofline of the YOLOv11 forward on a CUDA card (the
counterpart of `tools/roofline.py`).

    python -m tpu_yolo_torch.roofline [--size n] [--input 640] [--batch 128]
        [--train] [--profile] [--steps 3] [--json OUT]
        [--peak-tf 989.4] [--peak-gbs 3350]

Every convolution's real shapes are recorded by forward hooks on the
model's `ConvBN`s, and the PSA attention's two products by a hook on its
`qkv` conv, in one forward over meta tensors: shapes only, no memory and
no card, so the numbers cannot drift from the model code. The forward
runs in training mode, whose convolutions have the same shapes as the
eval forward's and whose attention is plain products (the kernel's
wrapper takes CPU and CUDA tensors only). The records are grouped by
stage (net/p1..p5, fpn/h1..h6, head/P3..P5) and each stage's lower
bound is the larger of its operations at the card's bf16 peak and its
bytes at its memory rate.

Byte model (bf16 activations and weights, fusion taken as given: lower
bounds on traffic, not estimates of it), the JAX package's:
  inference (folded BN, activation fused into the conv):
      2*in + 2*out + 2*w
  training forward (unfolded BN: y is written before the batch-stats
  reduce, then read again by the normalize and the activation):
      2*in + 2*out + 2*out + 2*out + 2*out
  training backward (dx: read dy, write dx; dw: read dy, read x):
      4*in + 4*out + 2*w      with FLOPs twice the forward's
  attention: the two products' FLOPs, q/k/v read and the output written.

Peaks: the card `nvidia-smi` names. An H100 SXM (and a run without a
card) takes NVIDIA's data sheet, 989.4 TFLOP/s bf16 dense and 3.35 TB/s;
another card needs --peak-tf and --peak-gbs.

--profile (inference, on a card) runs the bf16 forward of seeded folded
weights at (batch, input) under torch.profiler, each stage's modules
inside a `record_function` range named after the stage, and joins the
device time of the kernels launched inside each range (ms a forward,
over --steps forwards). Kernels outside every range (the input's layout
change, the concatenations between stages) are "(unattributed)".
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess

import torch

from tpu_yolo_torch.core.config import get_model_config

H100_SXM = (989.4e12, 3.35e12)   # bf16 dense FLOP/s, HBM bytes/s (data sheet)


def stage_of(path: str) -> str:
    """A module path (net/p2/1/conv1, head/box/1/0) -> its stage."""
    parts = path.split("/")
    if parts[0] == "head":
        return f"head/P{3 + int(parts[2])}"   # head/box/i/j -> level 3+i
    return "/".join(parts[:2])                 # net/p1, fpn/h1


def _stage_modules(model):
    """(path, module) of the modules whose calls make up the stages, in
    order: net.pK.J, fpn.hK and head.{box,cls}.I.J. They do not nest."""
    depth = {"net": 3, "fpn": 2, "head": 4}
    for name, m in model.named_modules():
        parts = name.split(".")
        if depth.get(parts[0]) == len(parts):
            yield name.replace(".", "/"), m


def trace_convs(size: str, input_size: int, batch: int) -> list[dict]:
    """The forward's convolutions and attention products at (batch,
    input_size), in the order they run: {"path", "kind": "conv", "in"
    (NHWC), "w" (HWIO), "out" (NHWC), "stride", "groups"} and {"path",
    "kind": "dot", "flops", "bytes"}, the JAX package's records."""
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.ops.blocks import Attention
    from tpu_yolo_torch.ops.nn import ConvBN

    cfg = get_model_config(size)
    with torch.device("meta"):
        model = YOLO(cfg).train()
    names = {m: n.replace(".", "/") for n, m in model.named_modules()}
    recs = []

    def conv(m, inputs, y):
        x = inputs[0]
        o, cin_g, kh, kw = m.w.shape
        recs.append({"path": names[m], "kind": "conv",
                     "in": (x.shape[0], x.shape[2], x.shape[3], x.shape[1]),
                     "w": (kh, kw, cin_g, o),
                     "out": (y.shape[0], y.shape[2], y.shape[3], y.shape[1]),
                     "stride": m.stride, "groups": m.groups})

    def products(attn):
        def note(_m, _inputs, qkv):   # after the qkv conv, as JAX notes it
            b, _, h, w = qkv.shape
            c, heads = attn.qkv.w.shape[1], attn.num_head
            dh = c // heads
            t = h * w
            recs.append({"path": names[attn] + "/attn", "kind": "dot",
                         "flops": 2 * b * heads * t * t * (dh // 2 + dh),
                         "bytes": 2 * (b * t * c * 2 + b * t * dh * heads)})
        return note

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, ConvBN)]
    hooks += [m.qkv.register_forward_hook(products(m)) for m in model.modules()
              if isinstance(m, Attention)]
    try:
        with torch.no_grad():
            model.forward_raw(torch.empty((batch, input_size, input_size, cfg.width[0]),
                                          device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return recs


def conv_cost(rec: dict, train: bool) -> tuple[int, int]:
    """(flops, bytes) of one record under the byte model above."""
    if rec["kind"] == "dot":
        f, by = rec["flops"], rec["bytes"]
        return (3 * f, 3 * by) if train else (f, by)
    b, hi, wi, cin = rec["in"]
    _, ho, wo, cout = rec["out"]
    kh, kw, cin_g, _ = rec["w"]
    flops = 2 * b * ho * wo * cout * kh * kw * cin_g
    n_in = b * hi * wi * cin
    n_out = b * ho * wo * cout
    n_w = kh * kw * cin_g * cout
    if not train:
        return flops, 2 * (n_in + n_out + n_w)
    fwd_bytes = 2 * n_in + 8 * n_out + 2 * n_w
    bwd_bytes = 4 * n_in + 4 * n_out + 2 * n_w
    return 3 * flops, fwd_bytes + bwd_bytes


def stage_costs(recs, train: bool) -> dict:
    """{stage: (flops, bytes, records)} in the order the stages run."""
    stages = collections.OrderedDict()
    for r in recs:
        f, by = conv_cost(r, train)
        s = stages.setdefault(stage_of(r["path"]), [0, 0, 0])
        s[0] += f
        s[1] += by
        s[2] += 1
    return {k: tuple(v) for k, v in stages.items()}


def card_peaks(peak_tf=None, peak_gbs=None):
    """(card, bf16 FLOP/s, bytes/s): the card nvidia-smi names (None
    without one), its peaks, or the ones given."""
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        card = None
    tf, bw = H100_SXM
    if card is not None and not ("H100" in card and "HBM3" in card) and (
            peak_tf is None or peak_gbs is None):
        raise SystemExit(f"roofline: no peaks on record for {card!r}: "
                         f"give --peak-tf and --peak-gbs")
    return (card, tf if peak_tf is None else peak_tf * 1e12,
            bw if peak_gbs is None else peak_gbs * 1e9)


def roofline_rows(stages: dict, peak_flops: float, peak_bw: float,
                  measured: dict | None = None) -> list[dict]:
    """One row a stage and a "TOTAL" row: GFLOP, MB, intensity, the two
    times and the bound (ms), and beside them the measured ms where
    given."""
    rows = []
    items = list(stages.items())
    items.append(("TOTAL", tuple(sum(v[i] for _, v in items) for i in range(3))))
    for name, (f, by, n) in items:
        t_ops, t_bytes = f / peak_flops * 1e3, by / peak_bw * 1e3
        row = {"stage": name, "ops": n, "gflop": f / 1e9, "mb": by / 1e6,
               "intensity": f / by, "t_ops_ms": t_ops, "t_bytes_ms": t_bytes,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "bytes" if t_bytes > t_ops else "operations"}
        if measured:
            m = (sum(measured.values()) if name == "TOTAL"
                 else measured.get(name, 0.0))
            row["measured_ms"] = m
            row["x_bound"] = m / row["bound_ms"]
        rows.append(row)
    return rows


def profile_stage_ms(model, x, steps: int = 3) -> dict:
    """Device ms a forward per stage: `model.forward_raw(x)` run `steps`
    times under torch.profiler after one untraced run, each stage's
    modules in a `record_function` range named after its stage, and every
    kernel's time given to the range its launching op ran in. Kernels
    outside every range are "(unattributed)"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ranges = []
    tags = set()

    def enter(tag):
        def hook(_m, _inputs):
            ranges.append(record_function(tag).__enter__())
        return hook

    def leave(_m, _inputs, _out):
        ranges.pop().__exit__(None, None, None)

    hooks = []
    for path, m in _stage_modules(model):
        tags.add(stage_of(path))
        hooks += [m.register_forward_pre_hook(enter(stage_of(path))),
                  m.register_forward_hook(leave)]
    try:
        with torch.inference_mode():
            model.forward_raw(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    model.forward_raw(x)
                torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    per = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        # the range's own device-side marker carries its name: not a kernel
        us = sum(k.duration for k in e.kernels if k.name not in tags)
        p = e.cpu_parent
        while p is not None and p.name not in tags:
            p = p.cpu_parent
        per["(unattributed)" if p is None else p.name] += us
    return {k: v / 1e3 / steps for k, v in per.items()}


def _profile(size: str, input_size: int, batch: int, steps: int) -> dict:
    """profile_stage_ms of seeded folded weights of `size` in bf16."""
    import numpy as np

    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params

    if not torch.cuda.is_available():
        raise SystemExit("roofline --profile: needs a CUDA card")
    cfg = get_model_config(size)
    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg))
    model = model.fold_batchnorm().to(device="cuda", dtype=torch.bfloat16,
                                      memory_format=torch.channels_last).eval()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, input_size, input_size, 3), np.uint8)).cuda()
    return profile_stage_ms(model, x.to(torch.bfloat16) / 255, steps)


def main(argv=None):
    ap = argparse.ArgumentParser("roofline")
    ap.add_argument("--size", default="n", choices=list("ntsmlx"))
    ap.add_argument("--input", type=int, default=640)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--train", action="store_true",
                    help="fwd+bwd byte/FLOP model (unfolded BN)")
    ap.add_argument("--profile", action="store_true",
                    help="join measured device ms per stage (inference, "
                         "needs a card)")
    ap.add_argument("--steps", type=int, default=3,
                    help="forwards traced by --profile")
    ap.add_argument("--peak-tf", type=float, default=None,
                    help="bf16 TFLOP/s (default: the card's)")
    ap.add_argument("--peak-gbs", type=float, default=None,
                    help="memory GB/s (default: the card's)")
    ap.add_argument("--json", default="", help="also write the rows as JSON")
    args = ap.parse_args(argv)
    if args.profile and args.train:
        raise SystemExit("roofline: --profile measures the inference forward; "
                         "drop --train")

    card, peak_flops, peak_bw = card_peaks(args.peak_tf, args.peak_gbs)
    stages = stage_costs(trace_convs(args.size, args.input, args.batch), args.train)
    measured = (_profile(args.size, args.input, args.batch, args.steps)
                if args.profile else None)
    rows = roofline_rows(stages, peak_flops, peak_bw, measured)

    mode = "train fwd+bwd" if args.train else "inference (folded)"
    print(f"# v11-{args.size} @ {args.input}px bs{args.batch} - {mode}; card "
          f"{card or 'none found'}; peaks {peak_flops / 1e12:.1f} TFLOP/s bf16, "
          f"{peak_bw / 1e9:.0f} GB/s")
    hdr = (f"{'stage':<10} {'ops':>3} {'GFLOP':>9} {'MB':>9} {'FLOP/B':>7} "
           f"{'t_ops':>8} {'t_bytes':>8} {'bound':>10}")
    if measured:
        hdr += f" {'meas_ms':>8} {'x_bound':>7}"
    print(hdr)
    for r in rows:
        line = (f"{r['stage']:<10} {r['ops']:>3} {r['gflop']:>9.1f} {r['mb']:>9.1f} "
                f"{r['intensity']:>7.0f} {r['t_ops_ms']:>8.3f} {r['t_bytes_ms']:>8.3f} "
                f"{r['bound_by']:>10}")
        if measured:
            line += f" {r['measured_ms']:>8.3f} {r['x_bound']:>7.1f}"
        print(line)
    if measured:
        print(f"(unattributed device time: {measured.get('(unattributed)', 0.0):.3f} "
              f"ms a forward: layout changes and concatenations between stages)")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"size": args.size, "input": args.input, "batch": args.batch,
                       "mode": mode, "card": card, "peak_flops": peak_flops,
                       "peak_bytes_s": peak_bw, "rows": rows,
                       "measured_ms": measured}, fh, indent=1)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
