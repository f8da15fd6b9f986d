"""The height-sharded forward (counterpart of `make_spatial_mesh` /
`spatial_batch_sharding` of `tpu_yolo/parallel/mesh.py`).

The JAX package shards an NHWC batch as P("data", "spatial") and lets
GSPMD partition every conv with halo exchange. Here each rank of a
(data, spatial) mesh holds its rows of its images, and `partition_spatial`
makes a YOLO's inference forward compute the unsharded one from them:

  * a conv or max pool whose window reaches beyond the rank's rows takes
    the rows it reads from the ranks above and below (`halo`): p rows on
    top and k - p - s at the bottom for a k x k window with padding p and
    stride s, so a stride-2 conv, whose shards start on even rows, takes
    a top row only. Beyond the map's edges the rows are zeros for a conv
    and −inf for a max pool, the unsharded forward's padding. A halo may
    be deeper than a shard (SPPF's 5 x 5 pool reads 2 rows; a p5 shard
    may hold 1), so it is drawn from every rank's edge rows at once;
  * 1 x 1 convs, upsampling and concatenation stay within the rank's rows;
  * the PSA block attends over the whole p5 map: its input is gathered
    over the spatial group, the block (and its attention kernel) runs on
    the whole map in every rank, and each keeps its rows;
  * the head's three raw maps are gathered along H, so that the anchors,
    global and row-major per level, decode as the unsharded forward's.

Every map's rows must split evenly: H a multiple of 32 x n_spatial (the
p5 map's H / 32 rows over the ranks). GSPMD would reshard uneven interior
maps; that is not done here, and such an H is refused. The forward is
for inference: its collectives have no backward.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_yolo_torch.parallel import mesh as mesh_mod
from tpu_yolo_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class SpatialAxis:
    """This rank's place on the spatial axis: `index` of `size` ranks,
    each holding an even share of every map's rows."""

    index: int
    size: int


def halo(x: torch.Tensor, axis: SpatialAxis, top: int, bottom: int,
         fill: float) -> torch.Tensor:
    """This rank's rows of an NCHW map (B, C, h, W) -> (B, C, top + h +
    bottom, W): the `top` rows above them and the `bottom` rows below, from
    whichever ranks hold them, `fill` beyond the map's edges. One
    all-gather of every rank's first and last min(max(top, bottom), h)
    rows; a rank whose shard is shallower than the halo sends all of its
    rows, so the rows above rank i are the last `top` of the edges of
    ranks 0..i-1 in order."""
    if not top and not bottom:
        return x
    b, c, h, w = x.shape
    e = min(max(top, bottom), h)
    edges = torch.stack((x[:, :, :e], x[:, :, h - e:]))        # (2, B, C, e, W)
    ranks = mesh_mod.all_gather_cat(edges[None], 0, "spatial")   # (n, 2, B, C, e, W)
    i = axis.index
    pieces = []
    if top:
        above = ranks[:i, 1].permute(1, 2, 0, 3, 4).reshape(b, c, i * e, w)[:, :, -top:]
        pieces += [x.new_full((b, c, top - above.shape[2], w), fill), above]
    pieces.append(x)
    if bottom:
        n = ranks.shape[0]
        below = ranks[i + 1:, 0].permute(1, 2, 0, 3, 4).reshape(
            b, c, (n - i - 1) * e, w)[:, :, :bottom]
        pieces += [below, x.new_full((b, c, bottom - below.shape[2], w), fill)]
    out = torch.cat(pieces, 2)
    if x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def halo_for(x, axis: SpatialAxis, k: int, stride: int, padding: int, fill: float):
    """x with the halo rows a k x k window of `stride` and `padding` reads:
    `padding` on top and k - padding - stride at the bottom. The window
    then runs with no padding along H and gives h / stride rows."""
    return halo(x, axis, padding, max(k - padding - stride, 0), fill)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole NCHW map from every rank's rows, in rank order."""
    return mesh_mod.all_gather_cat(x, 2, "spatial")


def own_rows(x: torch.Tensor, axis: SpatialAxis) -> torch.Tensor:
    """This rank's rows of a whole NCHW map (channels_last)."""
    per = x.shape[2] // axis.size
    return x[:, :, axis.index * per:(axis.index + 1) * per].contiguous(
        memory_format=torch.channels_last)


def partition_spatial(model, mesh: Mesh):
    """Make a YOLO's forward (`forward`, `forward_raw`, `forward_nms`) take
    this rank's rows of its images (spatial_batch_sharding(mesh).local)
    and give the unsharded forward's whole outputs, in place: its convs
    and SPPF pools exchange halos, its PSA block runs on the gathered p5
    map. An int8 model is refused. Returns the model."""
    from tpu_yolo_torch.ops.blocks import PSA, SPPF
    from tpu_yolo_torch.ops.nn import ConvBN

    if "spatial" not in mesh.shape:
        raise ValueError(f"partition_spatial takes a (data, spatial) mesh, got {mesh.shape}")
    axis = SpatialAxis(mesh.coords["spatial"], mesh.shape["spatial"])
    if axis.size == 1:   # the whole map in every rank: the unsharded forward
        return model

    def mark(m):
        if isinstance(m, ConvBN) and m.quantized:
            raise ValueError("the spatial forward takes float convs, not int8")
        if isinstance(m, (ConvBN, SPPF, PSA)):
            m.spatial = axis
        if not isinstance(m, PSA):   # the block's own convs see the whole map
            for child in m.children():
                mark(child)

    mark(model)
    model.spatial = axis
    return model
