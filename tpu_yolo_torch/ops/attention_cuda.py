"""Attention: the hand-written Hopper kernel (csrc/attention.cu) and its
plain PyTorch version, for YOLO11's PSA block and YOLO12's area attention.

Replaces the TPU kernel `tpu_yolo/ops/attention_pallas.py::fused_attention`.
The kernel is two custom ops: `torch.ops.tpu_yolo_torch.psa_attention`
(q, k, v as (BH, T, d) tensors) and `torch.ops.tpu_yolo_torch.area_attention`
(q, k and v read in place from a qkv conv's NHWC map, the output written
as an NHWC map). Each is the plain version on CPU tensors, the kernel on
CUDA tensors, and a fake implementation that gives `torch.export` the
output's shape, so an exported program calls the op, and a FLOP formula
for FlopCounterMode (importing this module registers all of them).
`fused_attention` and `area_attention` are the wrappers: they check their
inputs, call the op and count the kernel's launches in `.launches`.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from tpu_yolo_torch.ops import cuda_build
from tpu_yolo_torch.utils import telemetry

DK = 32          # per-head q/k width of every attention of the port
DHS = (32, 64)   # value widths: YOLO12's area attention, YOLO11's PSA block


def attention_plain(q, k, v, scale: float):
    """softmax(q @ kᵀ · scale) @ v with the TPU kernel's casts: scores and
    softmax in f32, p cast to v's dtype, PV accumulated in f32, output in
    v's dtype. q, k: (BH, T, dk); v: (BH, T, dh)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def area_attention_plain(qkv, heads: int, area: int, scale: float):
    """YOLO12's area attention on a qkv map (B, 3C, H, W): channel j is of
    head j // 3d (d = C / heads), whose [0, d) are q, [d, 2d) k and
    [2d, 3d) v; the H·W tokens in row-major order are cut into `area`
    runs of consecutive tokens, each a sequence of its own; the output
    (B, C, H, W), channel head·d + i, in channels_last memory. The
    products are attention_plain's."""
    b, c3, h, w = qkv.shape
    c = c3 // 3
    d, t = c // heads, h * w // area
    x = qkv.permute(0, 2, 3, 1).reshape(b * area, t, heads, 3, d)
    q, k, v = (x[..., i, :].transpose(1, 2).reshape(b * area * heads, t, d)
               for i in range(3))
    o = attention_plain(q, k, v, scale)
    return o.view(b * area, heads, t, d).transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)


def _library():
    lib = cuda_build.load("attention")
    fn = lib.psa_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.psa_attention_form.argtypes = [ctypes.c_int] * 3
        lib.psa_attention_form.restype = ctypes.c_int
    return lib


def _launch(q: int, k: int, v: int, out, bh: int, t: int, dh: int, heads: int,
            strides: tuple, scale: float) -> None:
    """One launch on `out`'s stream: q, k, v are data pointers, `strides`
    the (batch, head, row) element strides of q, k and v, then of out
    (csrc/attention.cu; read at dh 32 alone)."""
    with torch.cuda.device(out.device):
        err = _library().psa_attention(
            q, k, v, out.data_ptr(), bh, t, dh, heads, (ctypes.c_longlong * 6)(*strides),
            scale, int(out.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "psa_attention")


def build() -> str:
    """Compile csrc/attention.cu now; returns nvcc's ptxas report."""
    return cuda_build.build("attention")[1]


def kernel_form(bh: int, t: int, dtype=torch.bfloat16, dh: int = 64) -> str:
    """Which form of the kernel launches on the current card for (bh, t)
    with values dh wide: the bf16 kernel keeps a head's K/V "resident" in
    shared memory or has them "streamed" through a ring (the rule is the
    shape's alone, in csrc/attention.cu); the f32 kernel is always "f32"."""
    if dtype != torch.bfloat16:
        return "f32"
    form = _library().psa_attention_form(bh, t, dh)
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
    bh, t, dk = q.shape
    dh = v.shape[-1]
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, bh, t, dh, 1,
            (t * dk, 0, dk, t * dh, 0, dh), scale)
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
    """softmax(q·kᵀ·scale)·v for q, k (BH, T, 32) and v (BH, T, 32 or 64),
    all bf16 or all f32 and contiguous (and 16-byte aligned on the card),
    on the CPU or a card. Raises on anything else."""
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError(f"fused_attention takes bf16 or f32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (q.dim() != 3 or q.shape[-1] != DK or k.shape != q.shape or v.dim() != 3
            or v.shape[:2] != q.shape[:2] or v.shape[-1] not in DHS or q.shape[1] < 1):
        raise ValueError(f"fused_attention takes q, k (BH, T, {DK}) and v "
                         f"(BH, T, one of {DHS}), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention takes contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("fused_attention: q, k, v on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention: no kernel for {q.device}")
    return psa_attention(q, k, v, scale)


fused_attention.launches = 0


@torch.library.custom_op("tpu_yolo_torch::area_attention", mutates_args=(),
                         device_types="cpu")
def area_attention_op(qkv: torch.Tensor, heads: int, area: int,
                      scale: float) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return area_attention_plain(qkv, heads, area, scale)


def _area_output(qkv, heads):
    b, c3, h, w = qkv.shape
    return torch.empty((b, c3 // 3, h, w), dtype=qkv.dtype, device=qkv.device,
                       memory_format=torch.channels_last)


@area_attention_op.register_kernel("cuda")
def _area_attention_cuda(qkv, heads, area, scale):
    # q, k and v in place: rows 3C apart, heads 3d apart, v at 2d; the
    # output an NHWC map (rows C apart, heads d apart)
    qkv = qkv.contiguous(memory_format=torch.channels_last)
    out = _area_output(qkv, heads)
    b, c3, h, w = qkv.shape
    c = c3 // 3
    d, t = c // heads, h * w // area
    base, size = qkv.data_ptr(), qkv.element_size()
    if base % 16:
        raise ValueError("area_attention: qkv not 16-byte aligned")
    _launch(base, base + d * size, base + 2 * d * size, out, b * area * heads, t, d, heads,
            (t * c3, 3 * d, c3, t * c, d, c), scale)
    area_attention.launches += 1
    telemetry.add("attn.area.kernel", 1)
    return out


@area_attention_op.register_fake
def _area_attention_fake(qkv, heads, area, scale):
    return _area_output(qkv, heads)


@register_flop_formula(torch.ops.tpu_yolo_torch.area_attention)
def _area_attention_flops(qkv_shape, heads, area, *args, **kwargs) -> int:
    """The two products of every head and strip: 2·B·C·(H·W)²/area·2."""
    b, c3, h, w = qkv_shape
    return 2 * b * (c3 // 3) * (h * w) ** 2 // area * 2


def area_attention(qkv, heads: int, area: int, scale: float):
    """YOLO12's area attention (area_attention_plain) of a qkv conv's
    output (B, 3C, H, W), bf16 or f32, heads 32 wide, H·W a multiple of
    `area`, on the CPU or a card; the output (B, C, H, W) in channels_last
    memory. Raises on anything else."""
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"area_attention takes a bf16 or f32 map, got {qkv.dtype}")
    if qkv.dim() != 4 or qkv.shape[1] != 3 * DK * heads:
        raise ValueError(f"area_attention takes (B, 3·{DK}·heads, H, W) with heads "
                         f"{heads}, got {tuple(qkv.shape)}")
    if area < 1 or qkv.shape[2] * qkv.shape[3] % area or not qkv.shape[2] * qkv.shape[3]:
        raise ValueError(f"area_attention: {qkv.shape[2]}x{qkv.shape[3]} tokens in "
                         f"{area} strips")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"area_attention: no kernel for {qkv.device}")
    return area_attention_op(qkv, heads, area, scale)


area_attention.launches = 0
