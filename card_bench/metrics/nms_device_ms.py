"""Device time of decode and NMS a batch (ms): the kernels launched from
the end of the last head conv to `detect_batch`'s return (the traced
run's `layer.nms` range): ranking, decode, the greedy keep and the
compaction."""


def read(ctx):
    s = ctx.trace.seconds_in_range("layer.nms") if ctx.trace else None
    return None if s is None else s * 1e3 / ctx.layer["batches_traced"]
