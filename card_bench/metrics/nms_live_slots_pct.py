"""The share of the greedy keep's slots that hold a candidate above conf
(%): 100 · the program's counter `nms.live` (ranked candidates above
conf) over `nms.slots` (B·K slots offered), summed over the traced
batches (utils/telemetry.py; counted only while the profiler records)."""


def read(ctx):
    try:
        from tpu_yolo_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    live, slots = snap.get("nms.live"), snap.get("nms.slots")
    return 100.0 * live / slots if live is not None and slots else None
