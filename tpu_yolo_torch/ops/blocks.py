"""YOLOv11 composite blocks as torch modules (counterpart of
`tpu_yolo/ops/blocks.py`). Attribute names follow the JAX param tree.
Tensors are NCHW in shape (channels_last in memory); a channel index is
the NHWC channel index of the JAX package, so its splits carry over as
they are."""
from __future__ import annotations

import torch
from torch import nn

from tpu_yolo_torch.ops.attention_cuda import fused_attention
from tpu_yolo_torch.ops.nn import ConvBN, ckpt_region, identity, max_pool
from tpu_yolo_torch.parallel import spatial


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
