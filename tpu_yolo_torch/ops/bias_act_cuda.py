"""The folded convolution's epilogue: the hand-written Hopper pass
(csrc/bias_act.cu) and its plain PyTorch version.

Replaces no TPU kernel: on the TPU, XLA fuses a convolution's bias,
activation and residual into the convolution. On the card cuDNN's
convolution takes no bias, so PyTorch adds it, applies the activation
and adds the residual in three elementwise passes over the map; the
kernel is the three in one pass, bit-equal to them.

YOLO12's A2C2f stages at l and x add a per-channel scale of the
activated output before the residual (`residual + scale * act(y + b)`,
Ultralytics' layer scale `gamma`), which no fold can take into the conv:
the pass takes it too, as a fourth of PyTorch's passes.

The pass is the custom op `torch.ops.tpu_yolo_torch.bias_act`: the plain
version on CPU tensors, the kernel on CUDA tensors (out of place), and a
fake implementation that gives `torch.export` the output's shape, so an
exported program calls the op (importing this module registers all
three). `bias_act` is the wrapper: it checks its inputs, calls the op and
counts the kernel's launches in `bias_act.launches`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_yolo_torch.ops import cuda_build

ACTS = ("identity", "silu")   # the kernel's `act` codes, in order
DTYPES = (torch.bfloat16, torch.float32)


def bias_act_plain(y, b, act: str, residual=None, halves: bool = False, scale=None):
    """residual + scale * act(y + b) in the order and roundings of
    PyTorch's own passes after cuDNN's bias-less convolution: the bias
    added over the channels (as `add_`), the activation, the per-channel
    scale where given, then the residual added, each rounded to y's dtype.
    y (N, C, H, W), b and scale (C,). With `halves`, the two halves of the
    channels, as `chunk(2, 1)` gives them."""
    out = y + b.view(1, -1, 1, 1)
    if act == "silu":
        out = F.silu(out)
    if scale is not None:
        out = scale.view(1, -1, 1, 1) * out
    out = out if residual is None else residual + out
    return out.chunk(2, 1) if halves else out


def pixel_stride(r) -> int | None:
    """The elements between neighbouring pixels of an (N, C, H, W) tensor
    whose channels are contiguous and whose pixels lie one stride apart
    in NHWC order (channels_last, or a channel slice of it, as `chunk`
    gives); None for any other layout. The batch's size is never tested,
    so a symbolic batch (torch.export) takes no guard."""
    _, c, h, w = r.shape
    if not (c and h and w):
        return c
    sn, sc, sh, sw = r.stride()
    p = sw if w > 1 else sh if h > 1 else sn
    if p < c or sn != h * w * p or any(size > 1 and got != want for size, got, want
                                       in ((c, sc, 1), (h, sh, w * p))):
        return None
    return p


def _library():
    lib = cuda_build.load("bias_act")
    fn = lib.bias_act
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.bias_act_form.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                              ctypes.c_longlong,
                                                              ctypes.c_int]
        lib.bias_act_form.restype = ctypes.c_int
    return lib


def build() -> str:
    """Compile csrc/bias_act.cu now; returns nvcc's ptxas report."""
    return cuda_build.build("bias_act")[1]


def _outputs(y, halves: bool) -> list:
    """The output maps in channels_last memory: one of y's shape, or the
    two halves of its channels, each contiguous."""
    if not halves:
        return [torch.empty_like(y, memory_format=torch.channels_last)]
    n, c, h, w = y.shape
    return [torch.empty((n, c // 2, h, w), dtype=y.dtype, device=y.device,
                        memory_format=torch.channels_last) for _ in range(2)]


def _arguments(y, b, residual, halves, scale=None):
    """(the outputs, the C functions' pointers, the residual's pixel
    stride): y in channels_last memory and the residual with its pixels
    one stride apart, each copied there only where it is not (a conv's
    output on the card and its residuals are)."""
    if not y.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    stride = 0 if residual is None else pixel_stride(residual)
    if stride is None:
        residual = residual.contiguous(memory_format=torch.channels_last)
        stride = residual.shape[1]
    outs = _outputs(y, halves)
    pointers = (y.data_ptr(), b.data_ptr(), None if residual is None else residual.data_ptr(),
                None if scale is None else scale.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr() if halves else None)
    return outs, pointers, stride


def kernel_form(y, b, residual=None, halves: bool = False, scale=None) -> str:
    """Which form the kernel takes for these tensors on the card:
    "vector" (16-byte loads and stores) or "scalar" (one element at a
    time); the rule is the C function's, from C, the dtype and the
    pointers' alignment (the outputs' is the allocator's, 16 bytes or
    more)."""
    _, pointers, stride = _arguments(y, b, residual, halves, scale)
    form = _library().bias_act_form(*pointers, y.shape[1], stride,
                                    int(y.dtype == torch.bfloat16))
    return ("scalar", "vector")[form]


@torch.library.custom_op("tpu_yolo_torch::bias_act", mutates_args=(), device_types="cpu")
def bias_act_op(y: torch.Tensor, b: torch.Tensor, act: str,
                residual: Optional[torch.Tensor], halves: bool,
                scale: Optional[torch.Tensor] = None) -> list[torch.Tensor]:
    """The op on the CPU: the plain version, each output in channels_last
    memory of its own as the kernel writes them."""
    out = bias_act_plain(y, b, act, residual, halves, scale)
    if halves:   # each half a map of its own: returns may not share storage
        return [t.clone(memory_format=torch.channels_last) for t in out]
    return [out.contiguous(memory_format=torch.channels_last)]


@bias_act_op.register_kernel("cuda")
def _bias_act_cuda(y, b, act, residual, halves, scale=None):
    outs, pointers, stride = _arguments(y, b, residual, halves, scale)
    n, c, h, w = y.shape
    if y.numel() == 0:
        return outs
    with torch.cuda.device(y.device):
        err = _library().bias_act(*pointers, n * h * w, c, stride, ACTS.index(act),
                                  int(y.dtype == torch.bfloat16),
                                  torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "bias_act")
    bias_act.launches += 1
    return outs


@bias_act_op.register_fake
def _bias_act_fake(y, b, act, residual, halves, scale=None):
    return _outputs(y, halves)


def bias_act(y, b, act: str, residual=None, halves: bool = False, scale=None):
    """residual + scale * act(y + b) for y (N, C, H, W) (a convolution's
    output without its bias), b (C,), act "silu" or "identity", residual
    None or of y's shape and scale None or (C,); all bf16 or all f32, on
    the CPU or a card. The kernel
    reads y in channels_last memory and the residual with its pixels one
    stride apart in NHWC order (a channel slice of a channels_last map
    is), and copies either there first where it is not. The output is
    channels_last; with `halves` (C even) it is the two halves of the
    channels, each a contiguous map of its own (and no scale). Raises on
    anything else."""
    if act not in ACTS:
        raise ValueError(f"bias_act: act is one of {ACTS}, got {act!r}")
    tensors = tuple(t for t in (y, b, residual, scale) if t is not None)
    if y.dtype not in DTYPES or any(t.dtype != y.dtype for t in tensors):
        raise TypeError(f"bias_act takes bf16 or f32 tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    if y.dim() != 4 or b.shape != (y.shape[1],) or (
            residual is not None and residual.shape != y.shape):
        raise ValueError(f"bias_act takes y (N, C, H, W), b (C,) and a residual of y's "
                         f"shape, got {tuple(y.shape)}, {tuple(b.shape)}, "
                         f"{None if residual is None else tuple(residual.shape)}")
    if scale is not None and scale.shape != b.shape:
        raise ValueError(f"bias_act takes a scale of b's shape {tuple(b.shape)}, got "
                         f"{tuple(scale.shape)}")
    if not b.is_contiguous() or (scale is not None and not scale.is_contiguous()):
        raise ValueError("bias_act takes a contiguous b and scale")
    if halves and (y.shape[1] % 2 or scale is not None):
        raise ValueError(f"bias_act: halves of {y.shape[1]} channels"
                         + ("" if scale is None else " with a scale"))
    if any(t.device != y.device for t in tensors):
        raise ValueError("bias_act: tensors on different devices")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bias_act: no kernel for {y.device}")
    outs = bias_act_op(y, b, act, residual, halves, scale)
    return tuple(outs) if halves else outs[0]


bias_act.launches = 0
