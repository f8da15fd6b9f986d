"""Device time of YOLO12's area attention a batch (ms): the kernels
launched inside the program's `layer.serve.area_attn` spans (each AAttn
forward in eval: the qkv conv, the values' copy, the attention kernel,
the pe conv and the proj conv; tpu_yolo_torch/ops/blocks.py), over the
traced batches. A program without the span reads None."""


def read(ctx):
    s = ctx.trace.seconds_in_range("layer.serve.area_attn") if ctx.trace else None
    return None if s is None else s * 1e3 / ctx.layer["batches_traced"]
