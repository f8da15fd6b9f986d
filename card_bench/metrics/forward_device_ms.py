"""Device time of the model's forward a batch (ms): the kernels launched
between the stem's call and the end of the last head conv (the traced
run's `layer.forward` range, opened by the benchmark's hooks)."""


def read(ctx):
    s = ctx.trace.seconds_in_range("layer.forward") if ctx.trace else None
    return None if s is None else s * 1e3 / ctx.layer["batches_traced"]
