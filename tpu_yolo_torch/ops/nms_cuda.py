"""NMS greedy keep: the hand-written Hopper kernel (csrc/nms_keep.cu) and
its plain PyTorch version.

Replaces the TPU kernel `tpu_yolo/ops/nms_pallas.py::greedy_keep_pallas`.
The kernel is the custom op `torch.ops.tpu_yolo_torch.nms_greedy_keep`:
the plain version on CPU tensors, the kernel on CUDA tensors, and a fake
implementation for `torch.export` (importing this module registers it).
`greedy_keep` is the wrapper: it checks its inputs, calls the op and
counts the kernel's launches in `greedy_keep.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from tpu_yolo_torch.ops import cuda_build

MAX_K = 8192           # the candidate budget's cap (ops/nms.py)
_FLAGS = ("-fmad=false",)  # no contracted FMA in the IoU arithmetic


def pair_iou_mask(boxes_kill, cls_kill, boxes_vic, cls_vic, iou_thres):
    """(B, Kk, Kv) bool: killer k suppresses victim v (IoU > thr and same
    class), in the f32 operation order of the JAX `_pair_iou_mask`."""
    ax1, ay1, ax2, ay2 = boxes_kill.unbind(-1)
    bx1, by1, bx2, by2 = boxes_vic.unbind(-1)
    iw = (torch.minimum(ax2[:, :, None], bx2[:, None, :])
          - torch.maximum(ax1[:, :, None], bx1[:, None, :])).clamp(min=0)
    ih = (torch.minimum(ay2[:, :, None], by2[:, None, :])
          - torch.maximum(ay1[:, :, None], by1[:, None, :])).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    iou = inter / (area_a[:, :, None] + area_b[:, None, :] - inter + 1e-12)
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=iou.device)
    return (iou > thr) & (cls_kill[:, :, None] == cls_vic[:, None, :])


def greedy_keep_plain(cand_boxes, cls_idx, valid, iou_thres: float):
    """Exact sorted-greedy keep mask as the fixpoint of
    keep[i] = valid[i] ∧ ¬∃ j < i: keep[j] ∧ mask[j, i]
    (the JAX `_tri_fixpoint` recurrence). The dependency graph is acyclic,
    so the iteration ends at the unique greedy solution."""
    k = cand_boxes.shape[1]
    tri = torch.ones(k, k, dtype=torch.bool, device=cand_boxes.device).triu(1)
    mask = (pair_iou_mask(cand_boxes, cls_idx, cand_boxes, cls_idx, iou_thres)
            & tri & valid[:, :, None]).float()
    keep = valid.clone()
    for _ in range(k):
        # any(mask & keep) as a 0/1 product: exact in f32 for K < 2^24
        suppressed = torch.bmm(keep.float()[:, None, :], mask)[:, 0] > 0
        new = valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _library():
    lib = cuda_build.load("nms_keep", _FLAGS)
    fn = lib.nms_greedy_keep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build() -> str:
    """Compile csrc/nms_keep.cu now; returns nvcc's ptxas report."""
    return cuda_build.build("nms_keep", _FLAGS)[1]


@torch.library.custom_op("tpu_yolo_torch::nms_greedy_keep", mutates_args=(),
                         device_types="cpu")
def nms_greedy_keep(cand_boxes: torch.Tensor, cls_idx: torch.Tensor,
                    valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return greedy_keep_plain(cand_boxes, cls_idx, valid, iou_thres)


@nms_greedy_keep.register_kernel("cuda")
def _nms_greedy_keep_cuda(cand_boxes, cls_idx, valid, iou_thres):
    if cand_boxes.data_ptr() % 16:
        raise ValueError("greedy_keep: boxes not 16-byte aligned")
    b, k, _ = cand_boxes.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=cand_boxes.device)
    with torch.cuda.device(cand_boxes.device):
        err = _library().nms_greedy_keep(
            cand_boxes.data_ptr(), cls_idx.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), b, k, iou_thres,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "nms_greedy_keep")
    greedy_keep.launches += 1
    return keep


@nms_greedy_keep.register_fake
def _nms_greedy_keep_fake(cand_boxes, cls_idx, valid, iou_thres):
    return torch.empty(cand_boxes.shape[:2], dtype=torch.bool,
                       device=cand_boxes.device)


def greedy_keep(cand_boxes, cls_idx, valid, iou_thres: float):
    """(B, K) bool keep mask of score-descending candidates: cand_boxes
    (B, K, 4) f32 xyxy, cls_idx (B, K) int32, valid (B, K) bool, all
    contiguous, 1 <= K <= 8192, on the CPU or a card. Raises on anything
    else."""
    if (cand_boxes.dtype != torch.float32 or cls_idx.dtype != torch.int32
            or valid.dtype != torch.bool):
        raise TypeError(f"greedy_keep takes f32 boxes, int32 classes and "
                        f"bool valid, got {cand_boxes.dtype}, "
                        f"{cls_idx.dtype}, {valid.dtype}")
    if (cand_boxes.dim() != 3 or cand_boxes.shape[-1] != 4
            or cls_idx.shape != cand_boxes.shape[:2]
            or valid.shape != cand_boxes.shape[:2]
            or not 1 <= cand_boxes.shape[1] <= MAX_K):
        raise ValueError(f"greedy_keep takes boxes (B, K, 4), classes and "
                         f"valid (B, K) with 1 <= K <= {MAX_K}, got "
                         f"{tuple(cand_boxes.shape)}, {tuple(cls_idx.shape)},"
                         f" {tuple(valid.shape)}")
    if not (cand_boxes.is_contiguous() and cls_idx.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("greedy_keep takes contiguous inputs")
    if not (cand_boxes.device == cls_idx.device == valid.device):
        raise ValueError("greedy_keep: inputs on different devices")
    if cand_boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"greedy_keep: no kernel for {cand_boxes.device}")
    return nms_greedy_keep(cand_boxes, cls_idx, valid, iou_thres)


greedy_keep.launches = 0
