"""Conv (+BatchNorm) (+SiLU), pooling and upsampling as torch modules.

Counterpart of `tpu_yolo/ops/nn.py`. Tensors inside the
model are NCHW in shape and channels_last in memory, which is the
layout cuDNN's NHWC convolutions take without a transpose; the model's
public functions convert to and from NHWC at its boundary.

`ConvBN` holds its weights under the JAX parameter names, so a state
dict key is the JAX tree path joined with dots:
  unfolded: w (OIHW), gamma, beta, mean, var  — BatchNorm; batch
                                                statistics in training
                                                mode, running ones in eval
  folded:   w (OIHW), b                       — BN folded in, or a plain
                                                conv with a bias
`w`, `b`, `gamma` and `beta` are parameters; `mean` and `var` are buffers.

A module in training mode updates its running statistics in `forward`,
as torch's BatchNorm does. A checkpointed region (`ckpt_region`) runs its
forward a second time in the backward pass; that second run leaves the
buffers alone, or the momentum update would be applied twice.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03

_state = threading.local()


@contextlib.contextmanager
def _recomputing():
    """Marks the backward pass's second run of a checkpointed region."""
    before = getattr(_state, "recomputing", False)
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = before


def ckpt_region(fn, *args):
    """fn(*args) under activation checkpointing: only the region's inputs
    and outputs are kept, and the backward pass recomputes its interior.
    Regions nest. Counterpart of the JAX package's `ckpt_region`; the BN
    running statistics are kept out of the second run by a flag where the
    JAX package routes them through the region's outputs."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


def identity(x):
    return x


class ConvBN(nn.Module):
    """One convolution with its BatchNorm and activation."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 1, stride: int = 1,
                 padding: int = 0, groups: int = 1, act=F.silu,
                 folded: bool = False):
        super().__init__()
        self.stride, self.padding, self.groups, self.act = (
            stride, padding, groups, act)
        self.w = nn.Parameter(torch.empty(out_ch, in_ch // groups, k, k))
        if folded:
            self.b = nn.Parameter(torch.zeros(out_ch))
        else:
            self.gamma = nn.Parameter(torch.ones(out_ch))
            self.beta = nn.Parameter(torch.zeros(out_ch))
            self.register_buffer("mean", torch.zeros(out_ch))
            self.register_buffer("var", torch.ones(out_ch))

    @property
    def folded(self) -> bool:
        return hasattr(self, "b")

    def forward(self, x):
        w = self.w if self.w.dtype == x.dtype else self.w.to(x.dtype)
        if self.folded:
            b = self.b if self.b.dtype == x.dtype else self.b.to(x.dtype)
            return self.act(F.conv2d(x, w, b, stride=self.stride,
                                     padding=self.padding, groups=self.groups))
        y = F.conv2d(x, w, stride=self.stride, padding=self.padding,
                     groups=self.groups)
        if self.training:
            return self._train_norm(y).to(x.dtype)
        scale = self.gamma.float() * torch.rsqrt(self.var.float() + BN_EPS)
        bias = self.beta.float() - self.mean.float() * scale
        return self.act(y * scale.to(y.dtype).view(1, -1, 1, 1)
                        + bias.to(y.dtype).view(1, -1, 1, 1))

    def _train_norm(self, y):
        """BatchNorm over the batch and the activation, in f32: biased
        variance (clipped at 0) for the normalize, unbiased for the
        running update with momentum 0.03."""
        yf = y.float()
        mean = yf.mean((0, 2, 3))
        var = (yf.square().mean((0, 2, 3)) - mean.square()).clamp(min=0)
        if not getattr(_state, "recomputing", False):
            with torch.no_grad():
                n = yf.numel() // yf.shape[1]
                unbiased = var * (n / max(n - 1, 1))
                # in place: the buffers keep their identity for the EMA
                # and the state dict
                self.mean.copy_((1.0 - BN_MOMENTUM) * self.mean + BN_MOMENTUM * mean)
                self.var.copy_((1.0 - BN_MOMENTUM) * self.var + BN_MOMENTUM * unbiased)
        scale = torch.rsqrt(var + BN_EPS) * self.gamma
        return self.act(yf * scale.view(1, -1, 1, 1)
                        + (self.beta - mean * scale).view(1, -1, 1, 1))

    @torch.no_grad()
    def fold_(self):
        """Fold BatchNorm into the conv in place:
        W' = W·gamma/sqrt(var+eps) per output channel,
        b' = beta − mean·gamma/sqrt(var+eps)."""
        if self.folded:
            return self
        scale = self.gamma / torch.sqrt(self.var + BN_EPS)
        w = self.w * scale.view(-1, 1, 1, 1)
        b = self.beta - self.mean * scale
        for name in ("gamma", "beta", "mean", "var"):
            delattr(self, name)
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)
        return self


def max_pool(x, k: int, stride: int = 1, padding: int | None = None):
    """Max pool with implicit −inf padding (the JAX reduce_window form)."""
    if padding is None:
        padding = k // 2
    return F.max_pool2d(x, k, stride=stride, padding=padding)


def upsample2x(x):
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
