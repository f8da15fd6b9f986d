"""Host-to-device copy time a batch (ms): every HtoD copy on the card in
the traced batches, over their number. Reads the device trace."""


def read(ctx):
    ops = ctx.trace.ops_named(r"memcpy htod") if ctx.trace else []
    if not ops:
        return None
    return sum(o.seconds for o in ops) * 1e3 / ctx.layer["batches_traced"]
