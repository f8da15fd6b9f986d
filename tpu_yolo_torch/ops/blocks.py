"""YOLOv11 composite blocks as torch modules (counterpart of
`tpu_yolo/ops/blocks.py`), and YOLO12's (`AreaAttention`, `ABlock`,
`A2C2f`, after Ultralytics' `AAttn`, `ABlock` and `A2C2f`; the JAX
package has no YOLO12). Attribute names follow the JAX param tree.
Tensors are NCHW in shape (channels_last in memory); a channel index is
the NHWC channel index of the JAX package, so its splits carry over as
they are."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_yolo_torch.ops.attention_cuda import (DK, area_attention, area_attention_plain,
                                               fused_attention)
from tpu_yolo_torch.ops.nn import ConvBN, ckpt_region, identity, max_pool
from tpu_yolo_torch.parallel import spatial
from tpu_yolo_torch.utils import telemetry


class Residual(nn.Module):
    """Two 3x3 convs with a skip."""

    def __init__(self, ch: int, e: float = 0.5):
        super().__init__()
        mid = int(ch * e)
        self.conv1 = ConvBN(ch, mid, 3, padding=1)
        self.conv2 = ConvBN(mid, ch, 3, padding=1)

    def forward(self, x):
        return self.conv2(self.conv1(x), residual=x)


class CSPModule(nn.Module):
    """C3k-style inner module."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        half = out_ch // 2
        self.conv1 = ConvBN(in_ch, half)
        self.conv2 = ConvBN(in_ch, half)
        self.conv3 = ConvBN(2 * half, out_ch)
        self.m = nn.ModuleList([Residual(half, e=1.0), Residual(half, e=1.0)])

    def forward(self, x):
        y = self.conv1(x)
        for block in self.m:
            y = block(y)
        return self.conv3(torch.cat((y, self.conv2(x)), 1))


class CSP(nn.Module):
    """C3k2-style CSP stage: conv1 -> split 2 -> n chained inner blocks on
    the tail -> concat(2+n) -> conv2. `remat=True` checkpoints each inner
    block (the interior is the bulk of a stage's activation memory)."""

    def __init__(self, in_ch: int, out_ch: int, n: int, use_csp_module: bool,
                 r: int):
        super().__init__()
        hidden = out_ch // r
        self.conv1 = ConvBN(in_ch, 2 * hidden)
        self.conv2 = ConvBN((2 + n) * hidden, out_ch)
        self.m = nn.ModuleList([
            CSPModule(hidden, hidden) if use_csp_module else Residual(hidden)
            for _ in range(n)])

    def forward(self, x, remat: bool = False):
        parts = list(self.conv1(x, halves=True))
        for block in self.m:
            parts.append(ckpt_region(block, parts[-1]) if remat
                         else block(parts[-1]))
        return self.conv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast."""

    spatial = None   # parallel/spatial.py: the pools' halos over this axis

    def __init__(self, in_ch: int, out_ch: int, k: int = 5):
        super().__init__()
        self.k = k
        self.conv1 = ConvBN(in_ch, in_ch // 2)
        self.conv2 = ConvBN(in_ch * 2, out_ch)

    def forward(self, x):
        x = self.conv1(x)
        y1 = max_pool(x, self.k, axis=self.spatial)
        y2 = max_pool(y1, self.k, axis=self.spatial)
        y3 = max_pool(y2, self.k, axis=self.spatial)
        return self.conv2(torch.cat((x, y1, y2, y3), 1))


class Attention(nn.Module):
    """Self-attention with a depthwise positional branch. The qkv channels
    of each head are [dk | dk | dh] with dk = dh/2, grouped head-major
    over the NHWC channel axis as in the JAX package."""

    def __init__(self, ch: int, num_head: int):
        super().__init__()
        self.num_head = num_head
        dk = ch // num_head // 2
        self.qkv = ConvBN(ch, ch + 2 * dk * num_head, act=identity)
        self.pe = ConvBN(ch, ch, 3, padding=1, groups=ch, act=identity)
        self.proj = ConvBN(ch, ch, act=identity)

    def forward(self, x, residual=None):
        """proj(attention + pe(v)), plus `residual` where given (added in
        the proj conv's epilogue)."""
        b, c, h, w = x.shape
        heads = self.num_head
        dh = c // heads
        dk = dh // 2
        t = h * w
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, t, heads, 2 * dk + dh)
        q, k, v = qkv.split((dk, dk, dh), -1)

        def to_heads(a, d):
            return a.transpose(1, 2).reshape(b * heads, t, d).contiguous()

        if self.training:
            # The JAX package's own dispatch, not a fallback: its fused
            # kernel serves inference only, and its training forward is
            # two products outside any kernel, differentiated by autodiff.
            # Scores and softmax in f32, p cast to the input's type, PV
            # accumulated in f32.
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dk ** -0.5
            p = torch.softmax(s, -1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(x.dtype)
        else:
            out = fused_attention(to_heads(q, dk), to_heads(k, dk),
                                  to_heads(v, dh), dk ** -0.5)
            out = out.reshape(b, heads, t, dh).transpose(1, 2)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        # attention + pe(v), the sum taken in the pe conv's epilogue
        y = self.pe(v.reshape(b, h, w, c).permute(0, 3, 1, 2), residual=out)
        return self.proj(y, residual=residual)


class PSABlock(nn.Module):
    """Residual attention + 2-layer conv MLP."""

    def __init__(self, ch: int, num_head: int):
        super().__init__()
        self.attn = Attention(ch, num_head)
        self.ffn = nn.ModuleList([ConvBN(ch, ch * 2),
                                  ConvBN(ch * 2, ch, act=identity)])

    def forward(self, x):
        x = self.attn(x, residual=x)
        return self.ffn[1](self.ffn[0](x), residual=x)


class PSA(nn.Module):
    """Partial self-attention: split channels, attend on half, concat,
    project. `remat=True` checkpoints each block (the training attention
    keeps its (B, heads, T, T) scores for the backward pass). With
    `spatial` (parallel/spatial.py) x is this rank's rows: the module runs
    on the whole map, gathered, and returns this rank's rows of it."""

    spatial = None

    def __init__(self, ch: int, n: int):
        super().__init__()
        half = ch // 2
        self.conv1 = ConvBN(ch, 2 * half)
        self.conv2 = ConvBN(2 * half, ch)
        self.m = nn.ModuleList([PSABlock(half, max(ch // 128, 1))
                                for _ in range(n)])

    def forward(self, x, remat: bool = False):
        if self.spatial is not None:
            return spatial.own_rows(self._forward(spatial.gather_rows(x, self.spatial),
                                                  remat), self.spatial)
        return self._forward(x, remat)

    def _forward(self, x, remat):
        a, y = self.conv1(x, halves=True)
        for block in self.m:
            y = ckpt_region(block, y) if remat else block(y)
        return self.conv2(torch.cat((a, y), 1))


class AreaAttention(nn.Module):
    """YOLO12's area attention (Ultralytics' `AAttn`): heads 32 wide; the
    qkv conv's channels are [q | k | v] a head, head-major; the map's
    tokens (row-major) are cut into `area` strips of whole rows, each
    attended on its own; the output is proj(attention + pe(v)), pe a
    depthwise 7x7 conv. In eval the products run in the hand-written
    kernel on the card (`area_attention`, which reads q, k and v in place
    and writes an NHWC map), inside the span `layer.serve.area_attn`."""

    def __init__(self, ch: int, area: int):
        super().__init__()
        self.num_head, self.area = ch // DK, area
        self.qkv = ConvBN(ch, 3 * ch, act=identity)
        self.pe = ConvBN(ch, ch, 7, padding=3, groups=ch, act=identity)
        self.proj = ConvBN(ch, ch, act=identity)

    def forward(self, x, residual=None):
        """proj(attention + pe(v)), plus `residual` where given (added in
        the proj conv's epilogue)."""
        if self.training:
            return self._forward(x, residual)
        with telemetry.span("layer.serve.area_attn"):
            telemetry.add("attn.area.calls", 1)
            return self._forward(x, residual)

    def _forward(self, x, residual):
        heads, scale = self.num_head, DK ** -0.5
        qkv = self.qkv(x)
        if self.training:
            # the kernel serves inference only; the plain version's
            # products and softmax are differentiable
            o = area_attention_plain(qkv, heads, self.area, scale)
        else:
            o = area_attention(qkv, heads, self.area, scale)
        b, _, h, w = qkv.shape
        v = qkv.permute(0, 2, 3, 1).unflatten(-1, (heads, 3, DK))[..., 2, :]
        v = v.reshape(b, h, w, heads * DK).permute(0, 3, 1, 2)   # channels_last
        # attention + pe(v), the sum taken in the pe conv's epilogue
        return self.proj(self.pe(v, residual=o), residual=residual)


class ABlock(nn.Module):
    """YOLO12's transformer block: x + attention(x), then x + mlp(x), the
    MLP a 1x1 conv to int(ch · mlp_ratio) channels (SiLU) and one back.
    Folded for serving (`pad_mlp_`), the hidden width is padded with zero
    channels to a multiple of 8 (v12-x's 460 to 464), which cuDNN's
    tensor-core convs and the epilogue pass's 16-byte vectors want: the
    padded channels are SiLU(0 + 0) = 0 and read by zero weights, so the
    block's function is unchanged."""

    def __init__(self, ch: int, mlp_ratio: float, area: int):
        super().__init__()
        hidden = int(ch * mlp_ratio)
        self.attn = AreaAttention(ch, area)
        self.mlp = nn.ModuleList([ConvBN(ch, hidden), ConvBN(hidden, ch, act=identity)])

    def forward(self, x):
        x = self.attn(x, residual=x)
        return self.mlp[1](self.mlp[0](x), residual=x)

    @torch.no_grad()
    def pad_mlp_(self):
        """Zero-pad the folded float MLP's hidden width to a multiple of 8,
        in place (a no-op where it is one, or where the MLP is not folded
        or is int8)."""
        first, second = self.mlp
        extra = -first.w.shape[0] % 8 if first.folded and not first.quantized else 0
        if not extra:
            return self
        first.w = nn.Parameter(F.pad(first.w, (0, 0, 0, 0, 0, 0, 0, extra)), requires_grad=False)
        first.b = nn.Parameter(F.pad(first.b, (0, extra)), requires_grad=False)
        second.w = nn.Parameter(F.pad(second.w, (0, 0, 0, 0, 0, extra)), requires_grad=False)
        return self


class A2C2f(nn.Module):
    """YOLO12's stage: conv1 (no split) -> n chained blocks -> concat(1+n)
    -> conv2. A block is two ABlocks attending in `area` strips, or, with
    `area` None, a C3k (`CSPModule`). With `layer_scale` (attention stages
    of v12-l and v12-x) the stage returns x + scale · conv2(...), `scale`
    a learned per-channel vector (Ultralytics' `gamma`, 0.01 at init),
    taken in conv2's epilogue pass."""

    def __init__(self, in_ch: int, out_ch: int, n: int, area: int | None = None,
                 mlp_ratio: float = 2.0, layer_scale: bool = False):
        super().__init__()
        hidden = out_ch // 2
        self.conv1 = ConvBN(in_ch, hidden)
        self.conv2 = ConvBN((1 + n) * hidden, out_ch)
        self.m = nn.ModuleList([
            nn.Sequential(ABlock(hidden, mlp_ratio, area), ABlock(hidden, mlp_ratio, area))
            if area else CSPModule(hidden, hidden) for _ in range(n)])
        if area and layer_scale:
            self.scale = nn.Parameter(torch.full((out_ch,), 0.01))

    def forward(self, x, remat: bool = False):
        parts = [self.conv1(x)]
        for block in self.m:
            parts.append(ckpt_region(block, parts[-1]) if remat else block(parts[-1]))
        scale = getattr(self, "scale", None)
        return self.conv2(torch.cat(parts, 1), residual=None if scale is None else x,
                          scale=scale)
