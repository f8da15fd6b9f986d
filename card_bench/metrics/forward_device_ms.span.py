"""Device time of the model's forward a batch (ms), from the program's own
`layer.serve.forward` span around `forward_raw`: the kernels launched
inside it. The benchmark's hook range `layer.nms` opens at the last head
conv, before the last per-level concat, so the profiler gives that concat
to `layer.nms` and not to this span."""


def read(ctx):
    s = ctx.trace.seconds_in_range("layer.serve.forward") if ctx.trace else None
    return None if s is None else s * 1e3 / ctx.layer["batches_traced"]
