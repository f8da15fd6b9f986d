"""The arithmetic the reference runs in: float32 with TF32 off."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """float32 convolutions and matrix products without TF32, restored
    on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
