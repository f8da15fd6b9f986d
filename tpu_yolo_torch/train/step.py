"""The training step: forward + loss + gradients + SGD + EMA (counterpart
of `tpu_yolo/train/step.py`).

  * the compute dtype is bfloat16 by explicit casts, as in the JAX
    package: each conv casts its f32 master weight to its input's type,
    BatchNorm statistics, the normalize and the loss run in f32. The f32
    tests on the CPU and the bf16 run on the card follow one code path.
    bf16 does not underflow the way fp16 does, so there is no GradScaler;
  * BatchNorm running statistics update on every micro-step (in the
    modules' forward); parameters and the EMA only when `apply_update`;
  * gradient accumulation is a summed-gradient buffer in the state,
    applied every k-th call;
  * the EMA runs over the full float state (parameters and BN buffers)
    after each optimizer step;
  * the loss is a batch sum / sum(target_scores), scaled once by the
    batch size;
  * in a process group (parallel/mesh.py) the batch is the global one:
    each rank differentiates its own sums over the global
    sum(target_scores), scaled by the global batch, and the gradients and
    the reported losses are summed over the ranks in one all-reduce per
    micro-step, before they reach the accumulation buffer, where the JAX
    package's SPMD step has XLA's psum. The update, the momentum and the
    EMA then run alike on every rank. The model is not wrapped in
    DistributedDataParallel: its reducer fires from hooks on gradient
    accumulation into `.grad`, which `torch.autograd.grad` never reaches;
  * on a mesh with a model axis (parallel/tensor.py) "the ranks" above
    are those of the data axis: each model group holds one copy of its
    rows and computes the whole loss, the split convs' gradients are the
    rank's slices and the others whole, so the gradients are summed over
    the data group only; the whole ones (and the losses) are then the
    model group's first rank's (parallel/tensor.py). The state's split
    tensors stay split through the update, the momentum and the EMA.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_yolo_torch import parallel
from tpu_yolo_torch.parallel import tensor
from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.train import optim
from tpu_yolo_torch.train.loss import detection_loss


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step. `momentum`, `accum`
    and `ema` map state-dict names to tensors: momentum and accumulated
    gradients for the trainable parameters, the EMA for every entry."""

    model: YOLO
    momentum: dict
    accum: dict | None
    ema: dict | None
    step: int = 0
    ema_updates: int = 0


def init_train_state(model: YOLO, ema: bool = True,
                     accumulate: int = 1) -> TrainState:
    """A fresh state around `model` (unfolded, on its device, f32)."""
    if not any(k.endswith(".gamma") for k in model.state_dict()):
        raise ValueError("training needs a model with unfolded BatchNorm")
    model.train()
    params = dict(model.named_parameters())
    zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
    return TrainState(
        model=model, momentum=zeros(),
        accum=zeros() if accumulate > 1 else None,
        ema={n: t.detach().clone() for n, t in model.state_dict().items()}
        if ema else None)


def loss_and_grads(model: YOLO, images_u8, gt, hyp_gains, *, cfg: ModelConfig,
                   compute_dtype=torch.float32, remat=False):
    """Losses and parameter gradients of one training forward/backward:
    ((loss_box, loss_cls, loss_dfl), {name: grad}). The loss that is
    differentiated is their sum times the batch size. As a training
    forward does, it updates the model's BN running statistics.

    In a process group `images_u8` and `gt` are this rank's equal share of
    the global batch (the share of its index on the data axis), and the
    losses and gradients returned are the global batch's, the same on
    every rank of a data group."""
    x = images_u8.to(compute_dtype) / 255
    raw = model.forward_raw(x, remat=remat)
    hyp = {"box": hyp_gains[0], "cls": hyp_gains[1], "dfl": hyp_gains[2]}
    lb, lc, ld = detection_loss(raw, gt, hyp, cfg)
    params = dict(model.named_parameters())
    batch = images_u8.shape[0] * parallel.axis_size()
    grads = torch.autograd.grad((lb + lc + ld) * batch, list(params.values()))
    losses = torch.stack([lb, lc, ld]).detach()
    parallel.all_reduce_flat_([*grads, losses])
    grads = dict(zip(params, grads))
    if tensor.is_sharded(model):
        tensor.broadcast_replicated_(model, {**grads, "losses": losses})
    return tuple(losses.unbind(0)), grads


def train_step(state: TrainState, images_u8, gt, lr: float, hyp_gains,
               wd: float, momentum: float, *, cfg: ModelConfig,
               accumulate: int = 1, apply_update: bool = True,
               compute_dtype=torch.bfloat16, remat=False):
    """One micro-step on `state`, in place. Returns the (3,) f32 tensor
    [loss_box, loss_cls, loss_dfl] on the model's device (reading it is
    the caller's synchronization).

    Args:
      images_u8: (B, H, W, 3) uint8 on the model's device.
      gt: (B, N, 5) padded [cls, x1, y1, x2, y2] pixel targets, f32.
      lr: learning rate of this micro-step (the host's schedule lookup).
      hyp_gains: [box, cls, dfl] loss gains.
      wd, momentum: weight decay (already scaled by the batch) and SGD
        momentum.
      accumulate/apply_update: the accumulation window, and whether this
        call updates the parameters (the host decides by step index).
      remat: False, True/"stage" or "blocks" (YOLO.forward_raw).
    """
    model = state.model
    if not model.training:
        raise RuntimeError("train_step needs the model in training mode")
    losses, grads = loss_and_grads(model, images_u8, gt, hyp_gains, cfg=cfg,
                                   compute_dtype=compute_dtype, remat=remat)
    if accumulate > 1:
        names = list(grads)
        # summed into the buffer in place; `grads` then names the sums
        torch._foreach_add_([state.accum[n] for n in names],
                            [grads[n] for n in names])
        grads = state.accum
    if apply_update:
        optim.sgd_update(dict(model.named_parameters()), grads, state.momentum, lr=lr,
                         momentum=momentum, weight_decay=wd)
        if accumulate > 1:
            torch._foreach_zero_(list(state.accum.values()))
        if state.ema is not None:
            state.ema_updates += 1
            optim.ema_update(state.ema, model.state_dict(), state.ema_updates)
    state.step += 1
    return torch.stack(losses).float()
