"""Channel tensor parallelism over the model axis (counterpart of
`DataParallel.model_sharding_spec` / `shard_model_parallel` of
`tpu_yolo/parallel/mesh.py`).

The JAX package annotates its wide conv kernels as split on their output
channels and lets GSPMD place the collectives; the sharded step computes
the unsharded one. Here the split and the collectives are explicit, in
the Megatron column form, and compute the same thing:

  * the rule (`model_sharding_spec`): a tensor whose last dimension in
    the JAX layout is at least `min_channels` and divides evenly over the
    model axis is split on it; everything else is replicated. For a
    `ConvBN` that dimension is its output channels, dim 0 of every leaf
    (w (O, I/g, k, k), gamma, beta, mean, var, b; an int8 conv's w_q,
    s_w and b, its scalar s_in whole), so a conv is split
    whole or not at all, and its momentum, accumulation and EMA mirrors
    with it;
  * a split conv's forward is y = gather_model(conv(copy_model(x), W_r)):
    `copy_model` is the identity whose backward sums dx over the model
    group (each rank's slice of outputs contributes part of every input's
    gradient), and `gather_model` concatenates the ranks' channels, whose
    backward takes the rank's own slice (everything after the gather is
    replicated within the model group, so every rank holds the whole
    gradient). A depthwise conv takes its input's channel slice instead
    of the whole input;
  * BatchNorm moments of a split conv are its rank's channels', summed
    over the data group only (ops/nn.py), as are the gradients
    (train/step.py): the replicated parameters' gradients are whole on
    every rank of a model group, the split ones' are the rank's slices;
  * the replicated parameters' gradients are broadcast from the model
    group's first rank each micro-step (`broadcast_replicated_`), so that
    nondeterministic backward kernels cannot make their copies drift;
  * a checkpoint holds whole tensors: `gather_state` gathers a split
    state, which then writes the `.ckpt` one process writes, and
    `shard_state` slices a whole one for a split model.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from tpu_yolo_torch.parallel import mesh as mesh_mod
from tpu_yolo_torch.parallel.mesh import Mesh, Sharding, replicated_sharding


@dataclasses.dataclass(frozen=True)
class ConvShard:
    """One conv's output channels split over the model axis: this rank
    holds channels [lo, hi) of `full`; `group` is its model group."""

    group: object
    index: int
    size: int
    full: int

    @property
    def lo(self) -> int:
        return self.index * self.full // self.size

    @property
    def hi(self) -> int:
        return (self.index + 1) * self.full // self.size


def model_sharding_spec(mesh: Mesh, x, min_channels: int = 256) -> Sharding:
    """The Sharding of one of the model's tensors: split over the model
    axis on dim 0 (the output channels, the last dimension of the JAX
    layout) when that is at least `min_channels` and divisible by the
    axis, else replicated."""
    n = mesh.shape.get("model", 1)
    shape = tuple(getattr(x, "shape", ()))
    if n > 1 and len(shape) >= 1 and shape[0] >= min_channels and shape[0] % n == 0:
        return Sharding(mesh, ("model",))
    return replicated_sharding(mesh)


class _CopyModel(torch.autograd.Function):
    """y = x; dx = the sum of dy over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return mesh_mod._all_reduce(grad.contiguous().clone(), ctx.group), None


class _GatherModel(torch.autograd.Function):
    """y = the ranks' channels (dim 1) side by side; dy -> this rank's
    channels of it."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.lo, ctx.hi = shard.lo, shard.hi
        return mesh_mod.all_gather_cat(x, 1, "model")

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.lo:ctx.hi], None


def copy_model(x: torch.Tensor, shard: ConvShard) -> torch.Tensor:
    return _CopyModel.apply(x, shard.group)


def gather_model(x: torch.Tensor, shard: ConvShard) -> torch.Tensor:
    return _GatherModel.apply(x, shard)


def _convs(model):
    from tpu_yolo_torch.ops.nn import ConvBN

    return [(name, m) for name, m in model.named_modules() if isinstance(m, ConvBN)]


def shard_model_parallel(mesh: Mesh, model_or_state, min_channels: int = 256):
    """Split, in place, each conv of a YOLO (or of a TrainState's model,
    with its momentum, accumulation and EMA mirrors) whose output
    channels `model_sharding_spec` splits: every leaf keeps this rank's
    channels, and the conv gathers its output over the model group in
    its forward. Nothing changes on a model axis of 1. An int8 conv splits
    w_q, s_w and b and keeps its scalar s_in whole, as JAX's rule does
    (a scalar has no last dimension to split). Returns the argument."""
    state = model_or_state if hasattr(model_or_state, "momentum") else None
    model = state.model if state is not None else model_or_state
    n = mesh.shape.get("model", 1)
    if n == 1:
        return model_or_state
    mirrors = [] if state is None else [t for t in (state.momentum, state.accum,
                                                     state.ema) if t is not None]
    index = mesh.coords["model"]
    for name, m in _convs(model):
        if m.shard is not None:
            raise ValueError(f"{name}: already split over the model axis")
        w = m.w_q if m.quantized else m.w
        full = w.shape[0]
        if not model_sharding_spec(mesh, w, min_channels).spec:
            continue
        if m.groups not in (1, full) or (m.groups == full and w.shape[1] != 1):
            raise ValueError(f"{name}: groups={m.groups} over {full} outputs: dense "
                             "and depthwise convs only")
        shard = ConvShard(mesh.groups[1] if mesh.groups else None, index, n, full)
        keep = slice(shard.lo, shard.hi)
        for leaf, t in list(m.named_parameters(recurse=False)):
            setattr(m, leaf, nn.Parameter(t.detach()[keep].clone(),
                                          requires_grad=t.requires_grad))
        for leaf, t in list(m.named_buffers(recurse=False)):
            if t.dim():
                setattr(m, leaf, t[keep].clone())
        for tree in mirrors:
            for key in [k for k in tree if k.rsplit(".", 1)[0] == name]:
                tree[key] = tree[key][keep].clone()
        if m.groups > 1:
            m.groups = full // n
        m.shard = shard
    return model_or_state


def split_names(model) -> dict:
    """{state-dict name: ConvShard} of a model's split leaves (an int8
    conv's s_in, a scalar, is whole)."""
    return {f"{name}.{leaf}": m.shard for name, m in _convs(model)
            if m.shard is not None for leaf, t in m.state_dict().items() if t.dim()}


def is_sharded(model) -> bool:
    return any(m.shard is not None for _, m in _convs(model))


def broadcast_replicated_(model, named: dict) -> None:
    """Make the replicated (unsplit) tensors of `named` (state-dict names of
    a split `model` -> tensors, e.g. its gradients) those of the model
    group's first rank, in place. Every rank of a model group computes
    them alike, but a backward kernel that sums in a nondeterministic
    order (cuDNN's weight gradients on a card) gives each copy its own
    last bits, and the copies of a parameter would drift apart step by
    step."""
    split = split_names(model)
    mesh_mod.broadcast_([t for k, t in named.items() if k not in split], group="model")


def gather_tensors(model, named: dict) -> dict:
    """Whole tensors of `named` (state-dict names of a split `model` ->
    this rank's tensors): the split ones gathered over the model group in
    one all-gather per dtype, the others as they are. A collective: call
    it on every rank."""
    split = split_names(model)
    out = dict(named)
    by_dtype: dict = {}
    for key, t in named.items():
        if key in split:
            by_dtype.setdefault(t.dtype, []).append(key)
    for keys in by_dtype.values():
        flat = torch.cat([named[k].detach().reshape(-1) for k in keys])
        ranks = mesh_mod.all_gather_cat(flat[None], 0, "model")
        sizes = [named[k].numel() for k in keys]
        per_rank = [r.split(sizes) for r in ranks]
        for i, key in enumerate(keys):
            local = named[key]
            whole = torch.cat([parts[i].view(local.shape) for parts in per_rank])
            out[key] = whole.contiguous(memory_format=torch.channels_last) \
                if local.dim() == 4 else whole
    return out


def shard_state(model, named: dict) -> dict:
    """This rank's part of whole tensors (state-dict names of the split
    `model` -> whole tensors): the inverse of gather_tensors, no
    collective."""
    split = split_names(model)
    return {k: t[split[k].lo:split[k].hi].clone() if k in split else t
            for k, t in named.items()}


def gather_state(state):
    """A split TrainState -> a whole one: an unsplit YOLO of the same
    config on the same device holding the gathered parameters and
    buffers, and the gathered momentum, accumulation and EMA. What it
    writes (io/weights.py::train_state_to_jax) is the `.ckpt` one process
    writes. A collective: call it on every rank."""
    from tpu_yolo_torch.models.yolov11 import YOLO
    from tpu_yolo_torch.train.step import TrainState

    model = state.model
    sd = gather_tensors(model, model.state_dict())
    device = next(iter(sd.values())).device
    whole = YOLO.from_state_dict(model.cfg, sd).to(
        device=device, memory_format=torch.channels_last).train(model.training)
    gather = lambda tree: None if tree is None else gather_tensors(model, tree)
    return TrainState(model=whole, momentum=gather(state.momentum),
                      accum=gather(state.accum), ema=gather(state.ema),
                      step=state.step, ema_updates=state.ema_updates)
