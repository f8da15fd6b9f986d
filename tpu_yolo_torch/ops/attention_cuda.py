"""PSA attention: the hand-written Hopper kernel (csrc/attention.cu) and
its plain PyTorch version.

Replaces the TPU kernel `tpu_yolo/ops/attention_pallas.py::fused_attention`.
The kernel is the custom op `torch.ops.tpu_yolo_torch.psa_attention`: the
plain version on CPU tensors, the kernel on CUDA tensors, and a fake
implementation that gives `torch.export` the output's shape, so an
exported program calls the op, and a FLOP formula for FlopCounterMode
(importing this module registers all three).
`fused_attention` is the wrapper: it checks its inputs, calls the op and
counts the kernel's launches in `fused_attention.launches`.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from tpu_yolo_torch.ops import cuda_build

DK, DH = 32, 64  # per-head q/k and v widths of every zoo size's PSA block


def attention_plain(q, k, v, scale: float):
    """softmax(q @ kᵀ · scale) @ v with the TPU kernel's casts: scores and
    softmax in f32, p cast to v's dtype, PV accumulated in f32, output in
    v's dtype. q, k: (BH, T, dk); v: (BH, T, dh)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def _library():
    lib = cuda_build.load("attention")
    fn = lib.psa_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.psa_attention_form.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.psa_attention_form.restype = ctypes.c_int
    return lib


def build() -> str:
    """Compile csrc/attention.cu now; returns nvcc's ptxas report."""
    return cuda_build.build("attention")[1]


def kernel_form(bh: int, t: int, dtype=torch.bfloat16) -> str:
    """Which form of the kernel `fused_attention` launches on the current
    card for (bh, t): the bf16 kernel keeps a head's K/V "resident" in
    shared memory or has them "streamed" through a ring (the rule is the
    shape's alone, in csrc/attention.cu); the f32 kernel is always "f32"."""
    if dtype != torch.bfloat16:
        return "f32"
    form = _library().psa_attention_form(bh, t)
    if form not in (0, 1):
        raise RuntimeError("psa_attention_form: no CUDA device")
    return ("resident", "streamed")[form]


@torch.library.custom_op("tpu_yolo_torch::psa_attention", mutates_args=(),
                         device_types="cpu")
def psa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return attention_plain(q, k, v, scale)


@psa_attention.register_kernel("cuda")
def _psa_attention_cuda(q, k, v, scale):
    # the kernel reads q, k, v as contiguous: an exported program hands
    # the op what its graph gives, which at another batch than the one
    # traced can be a strided view where the trace saw a copy
    q, k, v = (x.contiguous() for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("fused_attention: inputs not 16-byte aligned")
    out = torch.empty_like(v)
    bh, t, _ = q.shape
    with torch.cuda.device(q.device):
        err = _library().psa_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t,
            scale, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "psa_attention")
    fused_attention.launches += 1
    return out


@psa_attention.register_fake
def _psa_attention_fake(q, k, v, scale):
    return torch.empty_like(v, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.tpu_yolo_torch.psa_attention)
def _psa_attention_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """The two products, Q·Kᵀ and P·V, for FlopCounterMode: 2·BH·T·T'·(dk + dv)."""
    bh, t, dk = q_shape
    return 2 * bh * t * k_shape[1] * (dk + v_shape[-1])


def fused_attention(q, k, v, scale: float):
    """softmax(q·kᵀ·scale)·v for q, k (BH, T, 32) and v (BH, T, 64), all
    bf16 or all f32 and contiguous (and 16-byte aligned on the card), on
    the CPU or a card. Raises on anything else."""
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError(f"fused_attention takes bf16 or f32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 3 or q.shape[-1] != DK or k.shape != q.shape
            or v.shape != (*q.shape[:2], DH) or q.shape[1] < 1):
        raise ValueError(f"fused_attention takes q, k (BH, T, {DK}) and v "
                         f"(BH, T, {DH}), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention takes contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("fused_attention: q, k, v on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention: no kernel for {q.device}")
    return psa_attention(q, k, v, scale)


fused_attention.launches = 0
