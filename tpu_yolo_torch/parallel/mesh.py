"""Data parallelism: the data axis, the process group and its collectives
(counterpart of the data-parallel half of `tpu_yolo/parallel/mesh.py`).

The JAX package runs one SPMD program over a mesh of chips and lets XLA
place the collectives. Here the rule is one process per card: each
process holds a whole replica of the model, its own rows of the global
batch, and its own launches of the three kernels, and the collectives
are explicit. The math is the JAX step's over the global batch:

  * BatchNorm statistics are means over the global batch: `ConvBN` sums
    its per-channel moments over the ranks through `all_reduce_sum`,
    whose backward sums the incoming gradient over the ranks, which is
    SyncBatchNorm's math;
  * the loss normalizer max(sum of target scores, 1) is taken over the
    global batch, and the loss is scaled by the global batch;
  * gradients (and the reported losses) are summed over the ranks in
    one flattened all-reduce per micro-step, where XLA places its psum;
  * parameters, momentum and EMA are replicated: rank 0's are broadcast
    once at the start, and every rank then applies the same update.

With no process group nothing is reduced, and every function here is the
identity or a no-op. A collective that fails raises on its rank; nothing
here catches it.

`make_mesh` / `DataParallel` name the data axis: the processes of the
group, each with its devices, or one process's list of devices (repeats
allowed), over which `Detector(dp=...)` and `evaluate(dp=...)` split a
batch into contiguous parts and gather the results in order.

A mesh may have a second axis over the ranks, one device each:
`make_mesh(n_data, n_model)` a `model` axis (channel tensor parallelism,
parallel/tensor.py) and `make_spatial_mesh(n_data, n_spatial)` a
`spatial` one (height shards, parallel/spatial.py). Rank r sits at
(r // n_second, r % n_second), the JAX package's row-major layout, and
belongs to two subgroups of the process group: its data group (the ranks
of its second index) and its model or spatial group (the ranks of its
data index). The mesh made last is the process's layout: its data group
is where the collectives above reduce by default (`group="data"`), so
that BatchNorm, the loss normalizer and the gradients sum over the data
axis only. The subgroups belong to the process group, which is the
process's own, so the layout is kept beside it and `close_distributed`
drops both. On a data-only mesh the data group is the whole process
group, as it was before the second axis existed; on a mesh with a second
axis a data group of one rank reduces nothing.

Every collective but `gather_objects`'s and `barrier`'s goes through
`_all_reduce`, `_all_gather` or `_broadcast` here; `COLLECTIVES` counts
them by axis (calls, and the bytes of the tensor this rank passed).
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """Whether this process is a rank of an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def init_distributed(device="cuda", backend: str | None = None,
                     init_method: str = "env://", rank: int | None = None,
                     world_size: int | None = None,
                     timeout_s: float = 1800.0) -> torch.device:
    """Join the process group and return this rank's device.

    The rank, the world size and the local rank come from torchrun's
    RANK, WORLD_SIZE and LOCAL_RANK unless `rank`/`world_size` are given
    (with an explicit `init_method`, tcp:// or file://). A CUDA device
    without an index becomes cuda:LOCAL_RANK and takes NCCL; the CPU takes
    gloo. `backend` overrides that choice: gloo on CUDA tensors is what
    lets two ranks share one card (NCCL refuses two ranks on one device),
    and serves only such checks. Raises where the device or the backend
    is missing; it never falls back to another."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: no CUDA device "
                               "(pass --device cpu to run the ranks on the CPU)")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = backend or "nccl"
    elif device.type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"the CPU takes the gloo backend, not {backend}")
    else:
        raise ValueError(f"no process group for device {device}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL: it cannot run --distributed "
                           "on the card")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def close_distributed():
    """Leave the process group (no-op without one) and forget its layout."""
    _LAYOUT.clear()
    _SUBGROUPS.clear()
    if is_distributed():
        dist.destroy_process_group()


# -- collectives ----------------------------------------------------------

# this process's layout ("mesh": the Mesh made last in the process group)
# and the subgroups made for each mesh shape, which every rank makes once,
# in the same order
_LAYOUT: dict = {}
_SUBGROUPS: dict = {}
# calls and bytes, by axis name, of _all_reduce, _all_gather and _broadcast
COLLECTIVES: dict = {}


def _group(group: str):
    """(whether the ranks of axis `group` reduce at all, their process
    group: None for the whole process group)."""
    if not is_distributed():
        return False, None
    mesh = _LAYOUT.get("mesh")
    if mesh is None or not mesh.second:
        if group != "data":
            raise ValueError(f"no {group!r} axis: this process's mesh is data-only "
                             f"(make_mesh(n_model=...) or make_spatial_mesh first)")
        return True, None
    if group not in mesh.shape:
        raise ValueError(f"no {group!r} axis in this process's mesh {mesh.shape}")
    return mesh.shape[group] > 1, mesh.groups[mesh.axis_names.index(group)]


def axis_size(group: str = "data") -> int:
    """The number of ranks on axis `group` of this process's mesh (1
    without a process group)."""
    if not is_distributed():
        return 1
    _group(group)   # refuses an axis the mesh lacks
    mesh = _LAYOUT.get("mesh")
    return mesh.shape[group] if mesh is not None and mesh.second else world_size()


def axis_name(group) -> str:
    """The mesh axis whose ranks process group `group` holds (None: the
    whole process group, the data axis of a data-only mesh)."""
    mesh = _LAYOUT.get("mesh")
    return ("data" if group is None or mesh is None
            else mesh.axis_names[mesh.groups.index(group)])


def _count(group, t: torch.Tensor):
    c = COLLECTIVES.setdefault(axis_name(group), {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` (contiguous) over the ranks of process group `group` (None:
    all of them) in place. Every all-reduce of the package goes through
    here."""
    _count(group, t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _all_gather(parts: list[torch.Tensor], t: torch.Tensor, group=None) -> list:
    """Every rank's `t` (contiguous, one shape on every rank) into
    `parts`, in the group's rank order. Every all-gather of the package
    goes through here."""
    _count(group, t)
    dist.all_gather(parts, t, group=group)
    return parts


def _broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite `t` (contiguous) with global rank `src`'s, in place, over
    process group `group`. Every broadcast of the package goes through
    here."""
    _count(group, t)
    dist.broadcast(t, src, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; dx = the sum of dy over the ranks
    (every rank's loss depends on the sum, so each x's gradient is the
    sum of the ranks' gradients of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: str = "data") -> torch.Tensor:
    """The sum of `x` over the ranks of axis `group`, differentiable; `x`
    itself without a process group or where the axis has one rank (on a
    mesh with a second axis)."""
    active, pg = _group(group)
    return _AllReduceSum.apply(x, pg) if active else x


def all_reduce_flat_(tensors: list[torch.Tensor], group: str = "data") -> None:
    """Sum each tensor (all of one dtype) over the ranks of axis `group`,
    in place, through one flattened buffer: one collective for all of
    them."""
    active, pg = _group(group)
    if not active or not tensors:
        return
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), pg)
    torch._foreach_copy_(tensors, [part.view(t.shape) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def all_gather_cat(x: torch.Tensor, dim: int, group: str = "data") -> torch.Tensor:
    """The ranks' `x` (one shape on every rank) concatenated along `dim`
    in the axis's rank order; not differentiable. A channels_last NCHW
    tensor is gathered in its memory order and comes back channels_last."""
    active, pg = _group(group)
    if not active:
        return x
    if (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        nhwc = all_gather_cat(x.permute(0, 2, 3, 1), (0, 3, 1, 2)[dim], group)
        return nhwc.permute(0, 3, 1, 2)
    x = x.contiguous()
    parts = _all_gather([torch.empty_like(x) for _ in range(axis_size(group))], x, pg)
    return torch.cat(parts, dim)


def broadcast_(tensors: list[torch.Tensor], src: int = 0, group: str = "data") -> None:
    """Overwrite each tensor with that of the rank at index `src` of axis
    `group` (of this rank's data group, by default), in place: one
    flattened broadcast per dtype."""
    active, pg = _group(group)
    if not active:
        return
    if pg is not None:
        src = dist.get_global_rank(pg, src)
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for same in groups.values():
        flat = _broadcast(torch.cat([t.reshape(-1) for t in same]), src, pg)
        torch._foreach_copy_(same, [part.view(t.shape) for part, t in zip(
            flat.split([t.numel() for t in same]), same)])


def gather_objects(obj) -> list:
    """Every rank's `obj` (picklable host data), in rank order; [obj]
    without a process group."""
    if not is_distributed():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier():
    """Wait for every rank (no-op without a process group)."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# -- the mesh -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: `process_count` processes, each with `devices`, one
    data shard per device. This process is `process_index`.

    With a second axis (`second`: ("model", n) or ("spatial", n)) the
    processes are the ranks of the process group, one device each, on an
    (n_data, n) grid; `groups` holds this rank's data group and its
    second axis's group (process groups of torch.distributed)."""

    devices: tuple
    process_count: int = 1
    process_index: int = 0
    second: tuple = ()
    groups: tuple = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def n_second(self) -> int:
        return self.second[1] if self.second else 1

    @property
    def axis_names(self) -> tuple:
        return ("data",) + self.second[:1]

    @property
    def shape(self) -> dict:
        if not self.second:
            return {"data": self.process_count * len(self.devices)}
        return {"data": self.process_count // self.n_second, self.second[0]: self.n_second}

    @property
    def coords(self) -> dict:
        """This process's index on each axis: (r // n, r % n) on an
        (n_data, n) grid, the JAX package's row-major device layout."""
        r, n = self.process_index, self.n_second
        return dict(zip(self.axis_names, (r // n, r % n)))

    def processes(self, axis: str) -> tuple[int, int]:
        """(this process's index, the count) along `axis` counted in
        processes: the data axis of a data-only mesh is its processes,
        whatever devices each holds."""
        if axis == "data" and not self.second:
            return self.process_index, self.process_count
        return self.coords[axis], self.shape[axis]


def _default_devices() -> list:
    if is_distributed():
        return [torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == "nccl" else torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """The data axis over `devices` (names or torch.devices; repeats
    allowed, so that one card or the CPU can hold several shards) or, by
    default, over every visible CUDA card; the first `n_data` of them.
    In a process group the axis spans the ranks, each with its devices
    (by default the rank's card under NCCL, else the CPU): `n_data`, if
    given, must be their total.

    With `n_model` > 1, a (data, model) mesh over the ranks of the
    process group, one device each (by default the rank's; `devices`, if
    given, is that one): `n_data` (by default the world over n_model)
    times n_model must be the world."""
    if n_model != 1:
        return _mesh2(n_data, n_model, "model", devices)
    devices = [torch.device(d) for d in (_default_devices() if devices is None
                                         else devices)]
    world, index = world_size(), rank()
    if is_distributed():
        if n_data not in (None, world * len(devices)):
            raise ValueError(f"a data axis of {n_data} shards over {world} "
                             f"processes of {len(devices)} devices each")
        mesh = Mesh(tuple(devices), world, index)
        _LAYOUT["mesh"] = mesh
        return mesh
    if n_data is None:
        n_data = len(devices)
    if n_data < 1 or n_data > len(devices):
        raise ValueError(f"need {max(n_data, 1)} devices for a data mesh, "
                         f"have {len(devices)}")
    return Mesh(tuple(devices[:n_data]))


def make_spatial_mesh(n_data: int | None = None, n_spatial: int = 2,
                      devices=None) -> Mesh:
    """A (data, spatial) mesh over the ranks of the process group, one
    device each: a batch's rows over the data axis and each image's
    height over the spatial one (parallel/spatial.py). As make_mesh with
    a model axis; without a process group only n_spatial 1 is possible."""
    return _mesh2(n_data, n_spatial, "spatial", devices)


def _mesh2(n_data, n_second: int, name: str, devices) -> Mesh:
    """The JAX package's `_mesh2` over ranks: the first n_data·n_second
    ranks row-major on an (n_data, n_second) grid, which here must be all
    of them. In a process group every rank makes the subgroups of every
    data index and every second index, in the same order, once per mesh
    shape."""
    world = world_size()
    if n_second < 1:
        raise ValueError(f"a {name} axis of {n_second}")
    if n_data is None:
        if world % n_second:
            raise ValueError(f"a {name} axis of {n_second} does not divide the "
                             f"{world} ranks of the process group")
        n_data = world // n_second
    axes = ("data", name)
    if n_data < 1 or n_data * n_second > world:
        raise ValueError(f"need {max(n_data, 1) * n_second} devices for a {axes} "
                         f"mesh, have {world} (one device a rank)")
    if n_data * n_second != world:
        raise ValueError(f"a {axes} mesh of {n_data}x{n_second} over {world} ranks: "
                         "every rank of the process group must be on it")
    devices = tuple(torch.device(d) for d in (_default_devices()[:1] if devices is None
                                              else devices))
    if len(devices) != 1:
        raise ValueError(f"a {axes} mesh takes one device a rank, got {devices}")
    if not is_distributed():
        return Mesh(devices, 1, 0, (name, n_second))
    key = (name, n_data, n_second)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = (
            [dist.new_group([d * n_second + s for d in range(n_data)])
             for s in range(n_second)],
            [dist.new_group([d * n_second + s for s in range(n_second)])
             for d in range(n_data)])
    data_groups, second_groups = _SUBGROUPS[key]
    r = rank()
    mesh = Mesh(devices, world, r, (name, n_second),
                (data_groups[r % n_second], second_groups[r // n_second]))
    _LAYOUT["mesh"] = mesh
    return mesh


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which part of a global array this process holds: the JAX package's
    NamedSharding over the port's mesh. `spec` names, for each leading
    dimension, the mesh axis it is split over evenly (None: whole), as a
    PartitionSpec does; the dimensions after it are whole."""

    mesh: Mesh
    spec: tuple = ()

    def slices(self, shape) -> tuple:
        out = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                out.append(slice(None))
                continue
            i, n = self.mesh.processes(axis)
            if shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does not split "
                                 f"over the {n} shards of the {axis!r} axis")
            per = shape[dim] // n
            out.append(slice(i * per, (i + 1) * per))
        return tuple(out)

    def local(self, x):
        """This process's part of the global array `x`."""
        return x[self.slices(x.shape)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading (batch) axis split over the data axis, the rest whole."""
    return Sharding(mesh, ("data",))


def spatial_batch_sharding(mesh: Mesh) -> Sharding:
    """An NHWC batch split over (batch -> data, height -> spatial)."""
    return Sharding(mesh, ("data", "spatial"))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def as_data_parallel(dp):
    """`dp` as a DataParallel: a Mesh is wrapped; a DataParallel or None
    comes back as it is."""
    return DataParallel(dp) if isinstance(dp, Mesh) else dp


@dataclasses.dataclass
class DataParallel:
    """A batch split over the data axis, the model replicated on it (or,
    with `shard_model_parallel`, its wide convs split over the model axis).

    `shard_batch` splits this process's rows of the global batch into one
    contiguous part per local device; `replicate` gives a copy of a model
    per local device, holding rank 0's values; `gather` puts per-device
    results back together in order; `rows` says which contiguous rows of
    a global batch are this process's."""

    mesh: Mesh

    @property
    def num_data_shards(self) -> int:
        return self.mesh.shape["data"]

    @property
    def devices(self) -> tuple:
        return self.mesh.devices

    @property
    def process_count(self) -> int:
        return self.mesh.process_count

    @property
    def process_index(self) -> int:
        return self.mesh.process_index

    def rows(self, n: int) -> slice:
        """This process's contiguous rows of a global batch of `n`: those of
        its index on the data axis."""
        i, p = self.mesh.processes("data")
        if n % p:
            raise ValueError(f"a global batch of {n} does not split over {p} processes")
        per = n // p
        return slice(i * per, (i + 1) * per)

    def model_sharding_spec(self, x, min_channels: int = 256) -> Sharding:
        """The Sharding of one of the model's tensors under channel tensor
        parallelism (parallel/tensor.py): split over the model axis on its
        output channels when they are at least `min_channels` and divide
        evenly, else replicated."""
        from tpu_yolo_torch.parallel import tensor

        return tensor.model_sharding_spec(self.mesh, x, min_channels)

    def shard_model_parallel(self, model_or_state, min_channels: int = 256):
        """Split a YOLO or a TrainState in place over the model axis
        (parallel/tensor.py::shard_model_parallel); nothing changes on a
        model axis of 1. Returns it."""
        from tpu_yolo_torch.parallel import tensor

        return tensor.shard_model_parallel(self.mesh, model_or_state, min_channels)

    def shard_batch(self, x) -> list[torch.Tensor]:
        """This process's rows (a tensor or an array, leading axis the
        batch) -> one contiguous part per local device, on it (copied
        without blocking from pinned memory)."""
        x = torch.as_tensor(x)
        n = len(self.devices)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{n} devices")
        return [part.to(d, non_blocking=True)
                for part, d in zip(x.chunk(n) if n > 1 else (x,), self.devices)]

    def replicate(self, model: torch.nn.Module) -> list[torch.nn.Module]:
        """A copy of `model` per local device (the first is `model` itself,
        moved), its parameters and buffers rank 0's."""
        first = model.to(self.devices[0])   # where the backend can reach it
        broadcast_(list(first.state_dict().values()))
        return [first] + [copy.deepcopy(first).to(d) for d in self.devices[1:]]

    def gather(self, parts: list[dict]) -> dict:
        """Per-device result dicts -> one dict on the first device, rows in
        device order; a 0-dim entry is the first part's."""
        if len(parts) == 1:
            return parts[0]
        d0 = self.devices[0]
        return {k: parts[0][k] if parts[0][k].dim() == 0 else
                torch.cat([p[k].to(d0) for p in parts]) for k in parts[0]}
