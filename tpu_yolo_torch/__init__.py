"""tpu_yolo_torch — YOLOv11 serving, training and evaluation in PyTorch
on an NVIDIA H100.

The PyTorch/CUDA port of `tpu_yolo`, which stays the reference. It
imports torch and numpy only, never JAX or `tpu_yolo`. Convolutions go
through cuDNN; the three kernels that `tpu_yolo` wrote in Pallas for the
TPU are CUDA C++ kernels for sm_90a here, built from `csrc/` with nvcc
at their first launch:

  ops/attention_cuda.py  csrc/attention.cu  PSA attention (inference)
  ops/nms_cuda.py        csrc/nms_keep.cu   NMS greedy keep
  ops/topk_cuda.py       csrc/topk_mask.cu  the assigner's top-k mask

Package layout:
  core/    model configs and hyperparameters
  ops/     conv/BN/pool/upsample, blocks, anchors, boxes, NMS, kernels,
           the device letterbox and augmentation programs
  models/  the YOLOv11 graph (n/t/s/m/l/x) as an nn.Module
  io/      JAX param trees and train states, torch/Ultralytics state
           dicts, .ckpt files (read and written)
  data/    image decode and letterbox, labels, augmentation, dataset,
           loaders (eval and staging also over the native C++ pipeline,
           cv2 where it cannot be built), the device-augment loader
  train/   loss and assigner, optimizer and EMA, train step, trainer
  eval/    evaluator, TP matching and AP, the COCO protocol, plots
  utils/   drawing detections, the profiler, the torch.export export
  cli/     `python -m tpu_yolo_torch.cli.main --train | --test | --profile
           | --export`
  parallel/ the mesh (data, model or spatial axes), the process group and
           its collectives (one process per card); channel tensor
           parallelism (tensor.py) and the height-sharded forward
           (spatial.py)
  quant.py int8 W8A8 calibration and quantization
  serve.py the Detector; detect.py `python -m tpu_yolo_torch.detect`
  rehearsal.py, preflight.py  the multi-process rehearsal worker and the
           pre-launch checks of a `--distributed` run
"""

__version__ = "0.1.0"

from tpu_yolo_torch.core.config import (  # noqa: E402
    COCO_NAMES,
    MODEL_CONFIGS,
    ModelConfig,
    get_model_config,
    load_hyperparams,
)
from tpu_yolo_torch.io.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
    strip_checkpoint,
)
from tpu_yolo_torch.io.weights import (  # noqa: E402
    convert_state_dict,
    export_reference_state_dict,
    export_ultralytics_state_dict,
    from_jax_params,
    load_checkpoint_params,
    load_partial,
    load_torch_state_dict,
    save_torch_checkpoint,
    to_jax_params,
)
from tpu_yolo_torch.models.yolov11 import YOLO, init_params  # noqa: E402
from tpu_yolo_torch.ops.nms import batched_nms, nms_from_raw  # noqa: E402
from tpu_yolo_torch.parallel import DataParallel, make_mesh  # noqa: E402
from tpu_yolo_torch.serve import Detector  # noqa: E402

__all__ = [
    "COCO_NAMES", "MODEL_CONFIGS", "ModelConfig", "get_model_config", "load_hyperparams",
    "load_checkpoint", "save_checkpoint", "strip_checkpoint",
    "convert_state_dict", "from_jax_params", "to_jax_params",
    "load_checkpoint_params", "load_torch_state_dict", "load_partial",
    "export_reference_state_dict", "export_ultralytics_state_dict",
    "save_torch_checkpoint", "YOLO", "init_params",
    "batched_nms", "nms_from_raw", "Detector", "DataParallel", "make_mesh",
]
