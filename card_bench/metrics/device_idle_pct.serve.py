"""The device's idle share of the traced window (%): 100 · (1 - the union
of every device activity's interval / the window)."""


def read(ctx):
    if not ctx.trace or not ctx.trace.ops or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
