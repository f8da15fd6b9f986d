"""The host's time to enqueue the model's forward a batch (ms): the mean
host duration of the program's `layer.serve.forward` span (around
`forward_raw`), under the profiler. Near the forward's device time, the
forward is bound by its launches."""


def read(ctx):
    spans = [h for h in ctx.trace.host if h[3] == "layer.serve.forward"] if ctx.trace else []
    if not spans:
        return None
    return sum(end - start for start, end, _, _ in spans) / len(spans) / 1e3
