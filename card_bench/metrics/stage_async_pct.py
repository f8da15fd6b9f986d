"""The share of the host inputs staged on the card whose copy ran on the
program's copy stream from pinned memory (%): 100 · the program's counters
`stage.ring` (copied on the host into its pinned ring first) plus
`stage.direct` (already pinned) over `stage.host`, summed over the traced
batches (tpu_yolo_torch/serve.py's `Detector._stage` through
utils/telemetry.py; counted only while the profiler records). A program
without the counters reads None."""


def read(ctx):
    try:
        from tpu_yolo_torch.utils import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    host = snap.get("stage.host")
    if not host:
        return None
    return 100.0 * (snap.get("stage.ring", 0) + snap.get("stage.direct", 0)) / host
