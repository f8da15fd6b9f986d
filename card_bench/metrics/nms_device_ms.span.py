"""Device time of decode and NMS a batch (ms), from the program's own
`layer.serve.nms` span around `nms_from_raw`'s body: ranking, decode, the
greedy keep and the compaction."""


def read(ctx):
    s = ctx.trace.seconds_in_range("layer.serve.nms") if ctx.trace else None
    return None if s is None else s * 1e3 / ctx.layer["batches_traced"]
