"""Device time of NMS's ranking a batch (ms): the kernels launched inside
the program's `layer.serve.nms.rank` span (the logits' concat, the
per-anchor pre-gate, the sorts and gathers, the sigmoid of the K
winners)."""


def read(ctx):
    s = ctx.trace.seconds_in_range("layer.serve.nms.rank") if ctx.trace else None
    return None if s is None else s * 1e3 / ctx.layer["batches_traced"]
