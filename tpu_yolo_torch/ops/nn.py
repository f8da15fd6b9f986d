"""Conv (+BatchNorm) (+SiLU), pooling and upsampling as torch modules.

Counterpart of `tpu_yolo/ops/nn.py` for inference. Tensors inside the
model are NCHW in shape and channels_last in memory, which is the
layout cuDNN's NHWC convolutions take without a transpose; the model's
public functions convert to and from NHWC at its boundary.

`ConvBN` holds its weights under the JAX parameter names, so a state
dict key is the JAX tree path joined with dots:
  unfolded: w (OIHW), gamma, beta, mean, var  — BatchNorm in eval form
  folded:   w (OIHW), b                       — BN folded in, or a plain
                                                conv with a bias
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


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
        self.w = nn.Parameter(torch.empty(out_ch, in_ch // groups, k, k),
                              requires_grad=False)
        if folded:
            self.b = nn.Parameter(torch.zeros(out_ch), requires_grad=False)
        else:
            for name, fill in (("gamma", 1.0), ("beta", 0.0),
                               ("mean", 0.0), ("var", 1.0)):
                self.register_buffer(name, torch.full((out_ch,), fill))

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
        scale = self.gamma.float() * torch.rsqrt(self.var.float() + BN_EPS)
        bias = self.beta.float() - self.mean.float() * scale
        return self.act(y * scale.to(y.dtype).view(1, -1, 1, 1)
                        + bias.to(y.dtype).view(1, -1, 1, 1))

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
