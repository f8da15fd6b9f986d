"""The host's wait behind the stream a batch (ms): for each traced batch,
the start of the first host-to-device copy on the device after the
program's `layer.serve.stage` span opened, less the span's start, on the
profiler's one clock. A pageable copy starts when the stream reaches it
and holds the host until then, so this is how long the input waited for
the work ahead of it. Mean over the traced batches."""


def read(ctx):
    if not ctx.trace:
        return None
    stages = sorted(h[0] for h in ctx.trace.host if h[3] == "layer.serve.stage")
    copies = sorted(o.start for o in ctx.trace.ops_named(r"memcpy htod"))
    waits = []
    for i, start in enumerate(stages):
        until = stages[i + 1] if i + 1 < len(stages) else float("inf")
        first = next((c for c in copies if start <= c < until), None)
        if first is not None:
            waits.append(first - start)
    return sum(waits) / len(waits) / 1e3 if waits else None
