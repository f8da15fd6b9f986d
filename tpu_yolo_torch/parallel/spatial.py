"""The height-sharded forward (counterpart of `make_spatial_mesh` /
`spatial_batch_sharding` of `tpu_yolo/parallel/mesh.py`).

The JAX package shards an NHWC batch as P("data", "spatial") and lets
GSPMD partition every conv with halo exchange, resharding maps whose
rows do not split evenly. Here each rank of a (data, spatial) mesh holds
its rows of its images, and `partition_spatial` makes a YOLO's inference
forward compute the unsharded one from them:

  * at the stem the input rows are moved once (`to_blocks`), so that each
    rank holds a run of whole blocks of BLOCK image rows: of the
    B = H / 32 blocks, rank i holds blocks ceil(i·B/n) to
    ceil((i+1)·B/n) (`Shards`). A map of stride s then splits at 32 / s
    rows a block, so every shard starts on a row its strides divide, and
    the p5 map's rows split as the blocks do: unevenly where n does not
    divide B (41 rows over 2 ranks: 21 and 20), with ranks that hold no
    row where B < n (2 rows over 4 ranks). Every rank's row count at
    every level is known on the host from H, so no collective finds it:
    the forward sets the layout for its duration (`sharded`), and a
    map's level is read from its width (the image's width over its
    stride);
  * a conv or max pool whose window reaches beyond the rank's rows takes
    the rows it reads from the ranks above and below (`halo`): p rows on
    top and k - p - s at the bottom for a k x k window with top padding p
    and stride s, so a stride-2 conv takes a top row only (and the s2d
    stem's 2 x 2 window, padded by one row on top, the row above). Beyond
    the map's edges the rows are zeros for a conv and −inf for a max
    pool, the unsharded forward's padding. A halo may be deeper than a
    shard (SPPF's 5 x 5 pool reads 2 rows; a p5 shard may hold 1 or 0),
    so it is drawn from every rank's edge rows at once. An int8 conv
    exchanges its quantized input;
  * a rank that holds no row of a map takes part in every exchange with
    an empty map, and its windows compute nothing (`window`);
  * 1 x 1 convs, upsampling and concatenation stay within the rank's rows;
  * the PSA block attends over the whole p5 map: its input is gathered
    over the spatial group, the block (and its attention kernel) runs on
    the whole map in every rank, and each keeps its rows;
  * the head's three raw maps are gathered along H, so that the anchors,
    global and row-major per level, decode as the unsharded forward's.

A gather pads every rank's rows to the longest shard and trims after it.
The forward takes what the unsharded one takes, an H and a W that are
multiples of 32, where the H input rows split evenly over the spatial
axis (`spatial_batch_sharding`); an s2d batch (4·C_in channels) splits
along its H / 2 rows. The forward is for inference: its collectives have
no backward.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.nn.functional as F

from tpu_yolo_torch.parallel import mesh as mesh_mod
from tpu_yolo_torch.parallel.mesh import Mesh

BLOCK = 32   # image rows of one block: the p5 map's stride


@dataclasses.dataclass(frozen=True)
class SpatialAxis:
    """This rank's place on the spatial axis: `index` of `size` ranks."""

    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class Shards:
    """The row layout of one forward: rank i holds `blocks[i]` blocks of
    BLOCK image rows, in rank order, of images `width` columns wide."""

    blocks: tuple
    width: int

    @classmethod
    def of(cls, height: int, width: int, n: int) -> "Shards":
        """H / BLOCK blocks over n ranks: rank i's run ends at
        ceil((i+1)·B/n)."""
        b = height // BLOCK
        ends = [-(-i * b // n) for i in range(n + 1)]
        return cls(tuple(hi - lo for lo, hi in zip(ends, ends[1:])), width)

    def rows(self, w: int) -> tuple:
        """Every rank's rows of a map `w` columns wide (stride width / w)."""
        per = BLOCK * w // self.width
        return tuple(b * per for b in self.blocks)


_SHARDS = contextvars.ContextVar("tpu_yolo_torch_spatial_shards", default=None)


@contextlib.contextmanager
def sharded(shards: Shards):
    """The block layout of the forward run inside, for `rows_of`."""
    token = _SHARDS.set(shards)
    try:
        yield
    finally:
        _SHARDS.reset(token)


def _rows(w: int, axis: SpatialAxis, even: int) -> tuple:
    """Every rank's rows of a map `w` columns wide: those of the forward's
    block layout (`sharded`), else `even` each."""
    shards = _SHARDS.get()
    return shards.rows(w) if shards is not None else (even,) * axis.size


def rows_of(x: torch.Tensor, axis: SpatialAxis) -> tuple:
    """Every rank's rows of the NCHW map of which x is this rank's."""
    rows = _rows(x.shape[3], axis, x.shape[2])
    if rows[axis.index] != x.shape[2]:
        raise ValueError(f"spatial rank {axis.index} holds {x.shape[2]} rows of a map "
                         f"split as {rows}")
    return rows


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y in x's memory format (channels_last or not)."""
    if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
        return y.contiguous(memory_format=torch.channels_last)
    return y


def halo(x: torch.Tensor, axis: SpatialAxis, top: int, bottom: int,
         fill: float, rows: tuple | None = None) -> torch.Tensor:
    """This rank's rows of an NCHW map (B, C, h, W) -> (B, C, top + h +
    bottom, W): the `top` rows above them and the `bottom` rows below, from
    whichever ranks hold them, `fill` beyond the map's edges. `rows` is
    every rank's row count (`rows_of` by default). One all-gather of every
    rank's first and last e = min(max(top, bottom), max(rows)) rows; a
    shallower shard sends all of its rows, padded to e, so the rows above
    rank i are the last `top` of the valid edges of ranks 0..i-1 in
    order."""
    if not top and not bottom:
        return x
    b, c, h, w = x.shape
    rows = rows_of(x, axis) if rows is None else rows
    e = min(max(top, bottom), max(rows))
    first, last = x[:, :, :e], x[:, :, h - min(h, e):]
    if h < e:
        pad = x.new_full((b, c, e - h, w), fill)
        first, last = torch.cat((first, pad), 2), torch.cat((pad, last), 2)
    ranks = mesh_mod.all_gather_cat(torch.stack((first, last))[None], 0, "spatial")
    i, n = axis.index, len(rows)       # ranks: (n, 2, B, C, e, W)
    pieces = []
    if top:
        above = [ranks[j, 1, :, :, e - min(rows[j], e):] for j in range(i)]
        above = torch.cat(above, 2)[:, :, -top:] if above else x[:, :, :0]
        pieces += [x.new_full((b, c, top - above.shape[2], w), fill), above]
    pieces.append(x)
    if bottom:
        below = [ranks[j, 0, :, :, :min(rows[j], e)] for j in range(i + 1, n)]
        below = torch.cat(below, 2)[:, :, :bottom] if below else x[:, :, :0]
        pieces += [below, x.new_full((b, c, bottom - below.shape[2], w), fill)]
    return _like(torch.cat(pieces, 2), x)


def halo_for(x, axis: SpatialAxis, k: int, stride: int, padding: int, fill: float):
    """x with the halo rows a k x k window of `stride` and top padding
    `padding` reads: `padding` on top and k - padding - stride at the
    bottom. The window then runs with no padding along H and gives
    h / stride rows."""
    return halo(x, axis, padding, max(k - padding - stride, 0), fill)


def window(fn, x: torch.Tensor, k: int) -> torch.Tensor:
    """fn(x) for a window of k rows run over x, this rank's rows with
    their halo; on a rank that holds no row of the map (x then has fewer
    than k rows), fn's output with no rows."""
    if x.shape[2] >= k:
        return fn(x)
    return fn(F.pad(x, (0, 0, 0, k - x.shape[2])))[:, :, :0]


def to_blocks(x: torch.Tensor, axis: SpatialAxis) -> torch.Tensor:
    """This rank's rows of an evenly split NCHW input (its rows under
    spatial_batch_sharding) -> its rows under the forward's block layout.
    Each rank's run starts at or below its even share's start and ends
    fewer than a block's rows below its end, so one halo of the rows
    below moves them (none where the two splits agree)."""
    n, h = axis.size, x.shape[2]
    want = _rows(x.shape[3], axis, h)
    starts = [sum(want[:j]) for j in range(n + 1)]
    more = max(starts[j + 1] - (j + 1) * h for j in range(n))
    x = halo(x, axis, 0, more, 0.0, rows=(h,) * n)
    lo = starts[axis.index] - axis.index * h
    return x[:, :, lo:lo + want[axis.index]]


def gather_rows(x: torch.Tensor, axis: SpatialAxis) -> torch.Tensor:
    """The whole NCHW map from every rank's rows, in rank order: each
    rank's rows padded to the longest shard, gathered, trimmed. Every rank
    sends its rows channels_last (an empty shard's too), so that the
    gathered bytes are in one order."""
    rows = rows_of(x, axis)
    most = max(rows)
    if x.shape[2] < most:
        b, c, h, w = x.shape
        x = torch.cat((x, x.new_zeros((b, c, most - h, w))), 2)
    whole = mesh_mod.all_gather_cat(x.contiguous(memory_format=torch.channels_last), 2,
                                    "spatial")
    if min(rows) == most:
        return whole
    return _like(torch.cat([whole[:, :, j * most:j * most + r] for j, r in enumerate(rows)],
                           2), whole)


def own_rows(x: torch.Tensor, axis: SpatialAxis) -> torch.Tensor:
    """This rank's rows of a whole NCHW map (channels_last)."""
    rows = _rows(x.shape[3], axis, x.shape[2] // axis.size)
    lo = sum(rows[:axis.index])
    return x[:, :, lo:lo + rows[axis.index]].contiguous(memory_format=torch.channels_last)


def partition_spatial(model, mesh: Mesh):
    """Make a YOLO's forward (`forward`, `forward_raw`, `forward_nms`) take
    this rank's rows of its images (spatial_batch_sharding(mesh).local)
    and give the unsharded forward's whole outputs, in place: its convs
    (float or int8, the s2d stem's too) and SPPF pools exchange halos,
    its PSA block runs on the gathered p5 map. Returns the model."""
    from tpu_yolo_torch.ops.blocks import PSA, SPPF
    from tpu_yolo_torch.ops.nn import ConvBN

    if "spatial" not in mesh.shape:
        raise ValueError(f"partition_spatial takes a (data, spatial) mesh, got {mesh.shape}")
    axis = SpatialAxis(mesh.coords["spatial"], mesh.shape["spatial"])
    if axis.size == 1:   # the whole map in every rank: the unsharded forward
        return model

    def mark(m):
        if isinstance(m, (ConvBN, SPPF, PSA)):
            m.spatial = axis
        if not isinstance(m, PSA):   # the block's own convs see the whole map
            for child in m.children():
                mark(child)

    mark(model)
    model.spatial = axis
    return model
