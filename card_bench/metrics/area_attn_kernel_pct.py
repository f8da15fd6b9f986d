"""The share of YOLO12's area attention forwards whose products ran in the
hand-written kernel (%): 100 · the program's counter `attn.area.kernel`
over `attn.area.calls`, summed over the traced batches
(tpu_yolo_torch/ops/blocks.py through utils/telemetry.py; counted only
while the profiler records). A program without the counters reads
None."""


def read(ctx):
    try:
        from tpu_yolo_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    kernel, calls = snap.get("attn.area.kernel", 0), snap.get("attn.area.calls")
    return 100.0 * kernel / calls if calls else None
