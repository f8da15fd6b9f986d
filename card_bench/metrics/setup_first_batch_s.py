"""Host seconds of the Detector's first batch (s), from the program's
set-up record `setup.first_batch_s` (utils/telemetry.py): one-time loads
(kernel libraries, CUDA's lazy module loads, cuDNN's choices) with no
synchronize added. Part of `setup_s`."""


def read(ctx):
    try:
        from tpu_yolo_torch.utils import telemetry
    except ImportError:
        return None
    return telemetry.snapshot().get("setup.first_batch_s")
