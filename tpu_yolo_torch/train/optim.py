"""SGD(+Nesterov) with param-group weight decay, LR schedules, and EMA
(counterpart of `tpu_yolo/train/optim.py`).

Group rule, by the last component of a parameter's name: 'w' leaves
decay; 'b', 'gamma' and 'beta' do not; 'mean' and 'var' are buffers that
the optimizer never sees (BatchNorm updates them in its forward).

The update in torch.optim.SGD's order: grad' = grad + wd*p;
buf = mu*buf + grad'; nesterov step d = grad' + mu*buf; p -= lr*d.
It is a plain function over lists of tensors (one multi-tensor launch per
operation), so that the momentum buffers are ordinary tensors that a
checkpoint can carry to the JAX package and back.
"""
from __future__ import annotations

import numpy as np
import torch

TRAINABLE = ("w", "b", "gamma", "beta")


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def decay_mask(names) -> dict[str, bool]:
    """{name: weight-decayed?}: True for 'w' leaves only."""
    return {name: _leaf(name) == "w" for name in names}


def trainable_mask(names) -> dict[str, bool]:
    """{name: updated by the optimizer?}: excludes BN running stats."""
    return {name: _leaf(name) in TRAINABLE for name in names}


@torch.no_grad()
def sgd_update(params: dict, grads: dict, momentum_bufs: dict, *, lr: float,
               momentum: float, weight_decay: float) -> None:
    """One Nesterov update of `params` (name -> tensor) in place; the
    momentum buffers are updated in place too (they save two copies of
    the model per step). `grads` is left as it was."""
    names = [n for n in params if _leaf(n) in TRAINABLE]
    p = [params[n] for n in names]
    decayed = [n for n in names if _leaf(n) == "w"]
    g = dict(zip(decayed, torch._foreach_add(
        [grads[n] for n in decayed], [params[n] for n in decayed],
        alpha=weight_decay))) if decayed else {}
    g = [g.get(n, grads[n]) for n in names]
    bufs = [momentum_bufs[n] for n in names]
    torch._foreach_mul_(bufs, momentum)
    torch._foreach_add_(bufs, g)
    step = torch._foreach_add(g, bufs, alpha=momentum)
    torch._foreach_add_(p, step, alpha=-lr)


# ---------------------------------------------------------------------------
# LR schedules: precomputed per-microstep arrays.
# ---------------------------------------------------------------------------


def linear_lr(epochs: int, num_steps: int, hyp: dict) -> np.ndarray:
    """Linear warmup (>=100 steps or warmup_epochs) then linear decay."""
    max_lr, min_lr = hyp["max_lr"], hyp["min_lr"]
    warmup = int(max(hyp["warmup_epochs"] * num_steps, 100))
    decay = max(int(epochs * num_steps - warmup), 1)
    return np.concatenate([
        np.linspace(min_lr, max_lr, warmup, endpoint=False),
        np.linspace(max_lr, min_lr, decay),
    ]).astype(np.float32)


def cosine_lr(epochs: int, num_steps: int, hyp: dict) -> np.ndarray:
    """Linear warmup then cosine decay."""
    max_lr, min_lr = hyp["max_lr"], hyp["min_lr"]
    warmup = int(max(hyp["warmup_epochs"] * num_steps, 100))
    decay = max(int(epochs * num_steps - warmup), 1)
    steps = np.arange(1, decay + 1)
    cos = min_lr + 0.5 * (max_lr - min_lr) * (1 + np.cos(np.pi * steps / decay))
    return np.concatenate([
        np.linspace(min_lr, max_lr, warmup), cos]).astype(np.float32)


def plot_lr(schedule: np.ndarray, out_path: str):
    """LR curve PNG."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot

    pyplot.plot(schedule, ".-", label="LR")
    pyplot.xlabel("step")
    pyplot.ylabel("LR")
    pyplot.grid()
    pyplot.xlim(0, len(schedule))
    pyplot.ylim(0)
    pyplot.savefig(out_path, dpi=200)
    pyplot.close()


# ---------------------------------------------------------------------------
# EMA over the full float state (parameters and BN buffers).
# ---------------------------------------------------------------------------


def ema_decay(updates, decay: float = 0.9999, tau: float = 2000.0) -> float:
    """Exponential ramp so early epochs track the live model."""
    return decay * (1.0 - float(np.exp(-updates / tau)))


@torch.no_grad()
def ema_update(ema: dict, state: dict, updates: int) -> None:
    """ema = d*ema + (1-d)*value for every float entry of the state dict,
    in place; `updates` is the running update count after its increment."""
    d = ema_decay(updates)
    names = [n for n, e in ema.items() if e.is_floating_point()]
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, [state[n].to(ema[n].dtype) for n in names],
                        alpha=1.0 - d)
