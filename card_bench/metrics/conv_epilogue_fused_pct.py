"""The share of the folded float convs on the card whose bias, activation
and residual ran in the hand-written `bias_act` pass (%): 100 · the
program's counter `conv.fused` over `conv.folded`, summed over the traced
batches (tpu_yolo_torch/ops/nn.py through utils/telemetry.py; counted
only while the profiler records). A program without the counters reads
None."""


def read(ctx):
    try:
        from tpu_yolo_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    fused, folded = snap.get("conv.fused", 0), snap.get("conv.folded")
    return 100.0 * fused / folded if folded else None
