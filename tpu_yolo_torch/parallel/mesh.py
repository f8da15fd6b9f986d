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
    """Leave the process group (no-op without one)."""
    if is_distributed():
        dist.destroy_process_group()


# -- collectives ----------------------------------------------------------

def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` (contiguous) over the ranks in place. Every all-reduce of
    the package goes through here."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; dx = the sum of dy over the ranks
    (every rank's loss depends on the sum, so each x's gradient is the
    sum of the ranks' gradients of the sum)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable; `x` itself without a
    process group."""
    return _AllReduceSum.apply(x) if is_distributed() else x


def all_reduce_flat_(tensors: list[torch.Tensor]) -> None:
    """Sum each tensor (all of one dtype) over the ranks, in place, through
    one flattened buffer: one collective for all of them."""
    if not is_distributed() or not tensors:
        return
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    torch._foreach_copy_(tensors, [part.view(t.shape) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def broadcast_(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place: one flattened
    broadcast per dtype."""
    if not is_distributed():
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        torch._foreach_copy_(group, [part.view(t.shape) for part, t in zip(
            flat.split([t.numel() for t in group]), group)])


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


# -- the data axis --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: `process_count` processes, each with `devices`, one
    data shard per device. This process is `process_index`."""

    devices: tuple
    process_count: int = 1
    process_index: int = 0

    @property
    def shape(self) -> dict:
        return {"data": self.process_count * len(self.devices)}


def make_mesh(n_data: int | None = None, devices=None) -> Mesh:
    """The data axis over `devices` (names or torch.devices; repeats
    allowed, so that one card or the CPU can hold several shards) or, by
    default, over every visible CUDA card; the first `n_data` of them.
    In a process group the axis spans the ranks, each with its devices
    (by default the rank's card under NCCL, else the CPU): `n_data`, if
    given, must be their total."""
    if devices is None:
        if is_distributed():
            devices = [torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl" else torch.device("cpu")]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    world, index = world_size(), rank()
    if is_distributed():
        if n_data not in (None, world * len(devices)):
            raise ValueError(f"a data axis of {n_data} shards over {world} "
                             f"processes of {len(devices)} devices each")
        return Mesh(tuple(devices), world, index)
    if n_data is None:
        n_data = len(devices)
    if n_data < 1 or n_data > len(devices):
        raise ValueError(f"need {max(n_data, 1)} devices for a data mesh, "
                         f"have {len(devices)}")
    return Mesh(tuple(devices[:n_data]))


def as_data_parallel(dp):
    """`dp` as a DataParallel: a Mesh is wrapped; a DataParallel or None
    comes back as it is."""
    return DataParallel(dp) if isinstance(dp, Mesh) else dp


@dataclasses.dataclass
class DataParallel:
    """A batch split over the data axis, the model replicated on it.

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
        """This process's contiguous rows of a global batch of `n`."""
        p = self.process_count
        if n % p:
            raise ValueError(f"a global batch of {n} does not split over {p} processes")
        per = n // p
        return slice(self.process_index * per, (self.process_index + 1) * per)

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
