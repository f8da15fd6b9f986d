"""Top-k selection mask of the assigner: the hand-written Hopper kernel
(csrc/topk_mask.cu) and its plain PyTorch version.

Replaces the TPU kernel `tpu_yolo/ops/topk_pallas.py::topk_mask`.
The kernel is the custom op `torch.ops.tpu_yolo_torch.topk_mask`: the
plain version on a CPU tensor, the kernel on a CUDA tensor, and a fake
implementation for `torch.export` (importing this module registers it).
`topk_mask` is the wrapper: it checks its input, calls the op and counts
the kernel's launches in `topk_mask.launches`. Only comparisons touch
the values, so kernel and plain version agree bit for bit. NaN is out of
contract.
"""
from __future__ import annotations

import ctypes

import torch

from tpu_yolo_torch.ops import cuda_build

MAX_K = 256       # one thread of the block keeps each round's winner
# a row lives in the block's shared memory: 232,448 bytes less 128 static
MAX_A = (232448 - 128) // 4


def topk_mask_plain(x, k: int):
    """Bool mask of the k largest entries along the last axis, ties to the
    lower index: k rounds of argmax over where(taken, -inf, x) and a
    scatter of the pick (`torch.argmax` returns the first maximal index).
    The counterpart of `tpu_yolo/train/loss.py::_topk_mask_by_argmax`."""
    taken = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    for _ in range(k):
        pick = torch.where(taken, neg, x).argmax(-1, keepdim=True)
        taken.scatter_(-1, pick, True)
    return taken


def _library():
    lib = cuda_build.load("topk_mask")
    fn = lib.topk_mask
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build() -> str:
    """Compile csrc/topk_mask.cu now; returns nvcc's ptxas report."""
    return cuda_build.build("topk_mask")[1]


@torch.library.custom_op("tpu_yolo_torch::topk_mask", mutates_args=(),
                         device_types="cpu")
def topk_mask_op(x: torch.Tensor, k: int) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return topk_mask_plain(x, k)


@topk_mask_op.register_kernel("cuda")
def _topk_mask_cuda(x, k):
    if x.data_ptr() % 16:
        raise ValueError("topk_mask: input not 16-byte aligned")
    b, n, a = x.shape
    out = torch.empty((b, n, a), dtype=torch.bool, device=x.device)
    if b * n == 0:
        return out
    with torch.cuda.device(x.device):
        err = _library().topk_mask(
            x.data_ptr(), out.data_ptr(), b * n, a, k,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "topk_mask")
    topk_mask.launches += 1
    return out


@topk_mask_op.register_fake
def _topk_mask_fake(x, k):
    return torch.empty(x.shape, dtype=torch.bool, device=x.device)


def topk_mask(x, k: int):
    """(B, N, A) bool mask of the k largest entries of each row of a
    contiguous (B, N, A) f32 tensor, ties to the lower index. On the card
    1 <= k <= 256 and A <= 58,080 (a row must fit the 227 KB of shared
    memory a block can have). Raises on anything else."""
    if x.dtype != torch.float32:
        raise TypeError(f"topk_mask takes an f32 tensor, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] < 1 or k < 1:
        raise ValueError(f"topk_mask takes (B, N, A) with A >= 1 and "
                         f"k >= 1, got {tuple(x.shape)}, k={k}")
    if not x.is_contiguous():
        raise ValueError("topk_mask takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_mask: no kernel for {x.device}")
    b, n, a = x.shape
    if x.device.type == "cuda" and (a > MAX_A or k > MAX_K or b * n >= 2 ** 31):
        raise ValueError(
            f"topk_mask: the kernel takes rows of at most {MAX_A} entries "
            f"({MAX_A * 4} bytes of shared memory), k <= {MAX_K} and fewer "
            f"than 2^31 rows, got A={a}, k={k}, rows={b * n}")
    return topk_mask_op(x, k)


topk_mask.launches = 0
