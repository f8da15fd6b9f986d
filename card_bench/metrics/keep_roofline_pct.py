"""The NMS greedy-keep kernel's share of its roofline (%): the least time
of the keep's work on each traced batch's images (costs.nms_cost on the
reference's ranked candidates of those images: the bytes moved and the
IoU tests they need; the serving driver works them out in its check)
over the mean device time of one launch of the kernel in the trace."""


def read(ctx):
    ops = ctx.trace.ops_named(r"nms_keep_kernel") if ctx.trace else []
    bounds = ctx.layer.get("keep_bounds_ms")
    if not ops or not bounds:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(o.seconds for o in ops) * 1e3 / len(ops))
