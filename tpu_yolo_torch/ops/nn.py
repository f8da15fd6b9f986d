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
  int8:     w_q (int8 OIHW), s_w (O,),        — W8A8 (tpu_yolo_torch/quant.py):
            s_in (), b                          quantize the input, int8 conv
                                                with exact int32 sums,
                                                dequantize, bias
`w`, `b`, `gamma` and `beta` are parameters; `mean` and `var` are buffers,
as are the four leaves of the int8 form (all float32 but `w_q`).

Under a mesh with a second axis (tpu_yolo_torch/parallel) a module may
be split or sharded: `shard` (parallel/tensor.py) when it holds only this
rank's output channels, and `spatial` (parallel/spatial.py) when its
input holds only this rank's rows of the map; both are None otherwise.

A module in training mode updates its running statistics in `forward`,
as torch's BatchNorm does. A checkpointed region (`ckpt_region`) runs its
forward a second time in the backward pass; that second run leaves the
buffers alone, or the momentum update would be applied twice.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tpu_yolo_torch import parallel
from tpu_yolo_torch.parallel import spatial, tensor

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


def _pads(padding):
    """An int (symmetric) or ((top, bottom), (left, right)) -> the pair."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (top, bottom), (left, right) = padding
    return (top, bottom), (left, right)


def int8_conv2d(xq, w_q, stride: int = 1, padding=0, groups: int = 1):
    """The exact int32 sums of an int8 convolution, on the CPU or a card:
    xq (B, C, H, W) int8 (any memory format), w_q (O, C/groups, kh, kw)
    int8 -> (B, O, Ho, Wo) int32 in channels_last memory. `padding` is an
    int or ((top, bottom), (left, right)). The counterpart of the JAX
    package's `conv2d(xq, w_q, preferred_element_type=int32)`.

    A dense conv (groups 1) is one `torch._int_mm` over an NHWC im2col:
    the kh·kw shifted views of the padded input side by side, K = kh·kw·C
    padded with zeros to a multiple of 8 and N = O to a multiple of 16
    (the card's rules: its int8 GEMM refuses N = 40, half of a split
    80-channel conv; zeros leave the sums exact), the weight as a
    column-major operand, and M padded past 16 rows on the card. An f32 conv would not do: its sums
    leave the exact range once C·kh·kw·127² >= 2^24. A depthwise conv
    (groups == C == O) is an f32 conv of the int8 values, exact since
    kh·kw·127² < 2^24, and int8 values are exact in TF32 too. Other
    groupings raise."""
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 tensors, got {xq.dtype}, {w_q.dtype}")
    (top, bottom), (left, right) = _pads(padding)
    b, c, h, w = xq.shape
    o, cg, kh, kw = w_q.shape
    if groups == c and o == c and cg == 1:
        xf, pad = xq.float(), (top, left)
        if (top, left) != (bottom, right):
            xf, pad = F.pad(xf, (left, right, top, bottom)), (0, 0)
        return F.conv2d(xf, w_q.float(), stride=stride, padding=pad,
                        groups=groups).to(torch.int32)
    if groups != 1 or cg != c:
        raise ValueError(f"int8_conv2d: groups={groups} with C={c}, O={o}, "
                         f"C/groups={cg}: dense and depthwise convs only")
    x = xq.permute(0, 2, 3, 1)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    taps = [x[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            for i in range(kh) for j in range(kw)]
    k = kh * kw * c
    k8, o8 = -(-k // 8) * 8, -(-o // 16) * 16
    if k8 > k:
        taps.append(x.new_zeros((b, ho, wo, k8 - k)))
    a = (taps[0] if len(taps) == 1 else torch.cat(taps, -1)).reshape(b * ho * wo, k8)
    weight = w_q.permute(0, 2, 3, 1).reshape(o, k)       # (O, (i, j, c))
    if (k8, o8) != (k, o):
        weight = F.pad(weight, (0, k8 - k, 0, o8 - o))
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    y = torch._int_mm(a, weight.t())[:m, :o]
    return y.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def quantize_weight(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """An f32 OIHW kernel -> (w_q int8 OIHW, s_w (O,) f32): per output
    channel symmetric, s_w = max|w| over I, H, W / 127, floored at
    1e-12, and w_q = clip(round(w / s_w), -127, 127), rounding half to even. numpy
    f32 arithmetic, as the JAX package's `quantize_params` does it, so
    both give the same bits."""
    w = np.asarray(w, np.float32)
    s_w = np.abs(w).reshape(w.shape[0], -1).max(1) / 127.0
    s_w = np.maximum(s_w, 1e-12).astype(np.float32)
    w_q = np.clip(np.round(w / s_w[:, None, None, None]), -127, 127).astype(np.int8)
    return w_q, s_w


class ConvBN(nn.Module):
    """One convolution with its BatchNorm and activation."""

    shard = None     # parallel/tensor.py::ConvShard: this rank's output channels
    spatial = None   # parallel/spatial.py::SpatialAxis: this rank's rows

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

    @property
    def quantized(self) -> bool:
        return hasattr(self, "w_q")

    def forward(self, x):
        if self.shard is None:
            return self._forward(x)
        # split over the model axis (parallel/tensor.py): this rank's output
        # channels from the whole input (a depthwise conv's from its own
        # input channels), then every rank's side by side
        x = tensor.copy_model(x, self.shard)
        if self.groups > 1:
            x = x[:, self.shard.lo:self.shard.hi]
        return tensor.gather_model(self._forward(x), self.shard)

    def _window(self, x, k: int):
        """(x, (ph, pw)): the input a k x k window runs over and the
        symmetric padding the conv then takes. With `spatial`, x takes the
        halo rows the window reads beyond this rank's rows (its padding
        along H) from its neighbours; an asymmetric padding (the s2d
        stem's ((1, 0), (1, 0))) is applied here."""
        (top, bottom), (left, right) = _pads(self.padding)
        if self.spatial is not None:
            x = spatial.halo_for(x, self.spatial, k, self.stride, top, 0.0)
            top = bottom = 0
        if (top, left) != (bottom, right):
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        return x, (top, left)

    def _run(self, conv, x, k: int):
        """conv(x) on the window's input; on a spatial rank that holds no
        row of the map, its empty output (spatial.window)."""
        return conv(x) if self.spatial is None else spatial.window(conv, x, k)

    def _conv(self, x, w, b=None):
        """The convolution; with `spatial`, over this rank's rows and the
        halo rows the kernel reads from its neighbours."""
        x, pad = self._window(x, w.shape[2])
        return self._run(lambda v: F.conv2d(v, w, b, stride=self.stride, padding=pad,
                                            groups=self.groups), x, w.shape[2])

    def _forward(self, x):
        if self.quantized:
            return self._forward_int8(x)
        w = self.w if self.w.dtype == x.dtype else self.w.to(x.dtype)
        if self.folded:
            b = self.b if self.b.dtype == x.dtype else self.b.to(x.dtype)
            return self.act(self._conv(x, w, b))
        y = self._conv(x, w)
        if self.training:
            return self._train_norm(y).to(x.dtype)
        scale = self.gamma.float() * torch.rsqrt(self.var.float() + BN_EPS)
        bias = self.beta.float() - self.mean.float() * scale
        return self.act(y * scale.to(y.dtype).view(1, -1, 1, 1)
                        + bias.to(y.dtype).view(1, -1, 1, 1))

    def _train_norm(self, y):
        """BatchNorm over the batch and the activation, in f32: biased
        variance (clipped at 0) for the normalize, unbiased for the
        running update with momentum 0.03.

        In a process group the batch is the global one: each rank's
        per-channel moments E[y] and E[y²], weighted by its share of the
        batch, are summed over the ranks in one differentiable all-reduce
        (parallel/mesh.py), and the count is the global one. The ranks
        hold equal shares (the trainer splits the batch evenly), so the
        weight is 1/world and the global count n·world, known on the host
        without a collective; the weight is exact at world 1, where the
        result equals the no-group one bit for bit. A recomputation under
        remat reduces too: every rank recomputes the same regions in the
        same order.

        The ranks are those of the data axis (`parallel.axis_size()`): on
        a mesh with a model axis each model group holds one copy of the
        batch, and a split conv's moments are its own channels'."""
        yf = y.float()
        mean = yf.mean((0, 2, 3))
        sq_mean = yf.square().mean((0, 2, 3))
        n = yf.numel() // yf.shape[1]
        if parallel.is_distributed():
            n_data = parallel.axis_size()
            mean, sq_mean = parallel.all_reduce_sum(
                torch.stack([mean, sq_mean]) * (1.0 / n_data)).unbind(0)
            n *= n_data
        var = (sq_mean - mean.square()).clamp(min=0)
        if not getattr(_state, "recomputing", False):
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                # in place: the buffers keep their identity for the EMA
                # and the state dict
                self.mean.copy_((1.0 - BN_MOMENTUM) * self.mean + BN_MOMENTUM * mean)
                self.var.copy_((1.0 - BN_MOMENTUM) * self.var + BN_MOMENTUM * unbiased)
        scale = torch.rsqrt(var + BN_EPS) * self.gamma
        return self.act(yf * scale.view(1, -1, 1, 1)
                        + (self.beta - mean * scale).view(1, -1, 1, 1))

    def quantize_input(self, x):
        """An int8 module's quantized input: clip(round(x / s_in), ±127)
        in f32, a division rounding half to even, as the JAX package's."""
        return torch.clamp(torch.round(x.float() / self.s_in), -127, 127).to(torch.int8)

    def _forward_int8(self, x):
        """The JAX package's order: the quantized input, the int32 conv,
        y·(s_in·s_w) + b and the activation in f32, cast back to x's
        dtype. With `spatial` the halo carries the quantized input."""
        k = self.w_q.shape[2]
        xq, (ph, pw) = self._window(self.quantize_input(x), k)
        y = self._run(lambda v: int8_conv2d(v, self.w_q, self.stride, ((ph, ph), (pw, pw)),
                                            self.groups), xq, k)
        y = (y.float() * (self.s_in * self.s_w).view(1, -1, 1, 1)
             + self.b.view(1, -1, 1, 1))
        return self.act(y).to(x.dtype)

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

    @torch.no_grad()
    def quantize_(self, s_in: float | None = None):
        """Turn a folded module in place into the int8 form, its input
        scale `s_in` (f32) and its kernel by `quantize_weight`. With
        s_in=None the form is made with zero leaves, for a state dict to
        fill (YOLO.from_state_dict)."""
        if self.quantized:
            raise ValueError("ConvBN.quantize_: already quantized")
        if self.shard is not None:
            raise ValueError("ConvBN.quantize_: the conv is split over the model "
                             "axis; int8 takes a whole model")
        if not self.folded:
            raise ValueError("ConvBN.quantize_: fold BatchNorm first")
        w, b = self.w.detach(), self.b.detach().float()
        if s_in is None:
            w_q, s_w = np.zeros(w.shape, np.int8), np.zeros(w.shape[0], np.float32)
        else:
            w_q, s_w = quantize_weight(w.float().cpu().numpy())
        del self.w, self.b
        self.register_buffer("w_q", torch.from_numpy(w_q).to(w.device))
        self.register_buffer("s_w", torch.from_numpy(s_w).to(w.device))
        self.register_buffer("s_in", torch.tensor(
            np.float32(0.0 if s_in is None else s_in), device=w.device))
        self.register_buffer("b", b)
        return self


def max_pool(x, k: int, stride: int = 1, padding: int | None = None, axis=None):
    """Max pool with implicit −inf padding (the JAX reduce_window form).
    With a spatial `axis` (parallel/spatial.py) x is this rank's rows,
    and the rows the window reads beyond them come from its neighbours,
    −inf beyond the map's edges."""
    if padding is None:
        padding = k // 2
    if axis is None:
        return F.max_pool2d(x, k, stride=stride, padding=padding)
    x = spatial.halo_for(x, axis, k, stride, padding, float("-inf"))
    return spatial.window(lambda v: F.max_pool2d(v, k, stride=stride, padding=(0, padding)),
                          x, k)


def upsample2x(x):
    """Nearest-neighbour 2x upsample of an NCHW tensor (of no rows on a
    spatial rank that holds none of the map)."""
    if not x.shape[2]:
        b, c, _, w = x.shape
        return x.new_empty((b, c, 0, 2 * w))
    return F.interpolate(x, scale_factor=2, mode="nearest")
