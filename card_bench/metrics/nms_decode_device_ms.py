"""Device time of NMS's box decode a batch (ms): the kernels launched
inside the program's `layer.serve.nms.decode` span (the DFL decode of
every level and the gather of the K candidates' boxes)."""


def read(ctx):
    s = ctx.trace.seconds_in_range("layer.serve.nms.decode") if ctx.trace else None
    return None if s is None else s * 1e3 / ctx.layer["batches_traced"]
