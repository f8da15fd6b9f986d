"""The port's training stack against the JAX package, in f32 on the CPU:
optimizer, schedules, EMA, the training-mode attention, gradients of one
step, three train steps from a state carried across, accumulation, the
three remat levels, and the reference's 4-step trajectory golden."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import load_golden
from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.ops import blocks as jax_blocks
from tpu_yolo.ops.nn import Context
from tpu_yolo.train import optim as jax_optim
from tpu_yolo.train import step as jax_step
from tpu_yolo_torch.core.config import ModelConfig, get_model_config
from tpu_yolo_torch.io.weights import (convert_state_dict, from_jax_params,
                                       to_jax_params, train_state_from_jax,
                                       train_state_to_jax)
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.blocks import Attention
from tpu_yolo_torch.train import optim
from tpu_yolo_torch.train.loss import build_padded_targets
from tpu_yolo_torch.train.step import (init_train_state, loss_and_grads,
                                       train_step)

torch.set_num_threads(1)

_TINY = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True),
             num_classes=8)
TINY, JTINY = ModelConfig(**_TINY), JaxConfig(**_TINY)
GAINS = np.asarray([7.5, 0.5, 1.5], np.float32)


def _flat(tree, prefix=""):
    """{dotted path: numpy leaf} of a JAX-layout tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _batch(seed, b=2, size=64):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, 3), np.uint8)
    gt = np.zeros((b, 2, 5), np.float32)
    gt[:, 0] = [1, 8.0, 8.0, 40.0, 40.0]
    gt[0, 1] = [3, 20.0, 30.0, 60.0, 50.0]
    return images, gt


def _model(seed):
    params = init_params(seed, TINY)
    return params, YOLO.from_state_dict(TINY, from_jax_params(params, TINY))


# -- optimizer, schedules, EMA ---------------------------------------------


def test_sgd_matches_torch_and_jax():
    """The multi-tensor update == torch.optim.SGD(nesterov) == the JAX
    package's sgd_update over 5 steps (rtol 1e-5: f32, fused multiply-adds
    in another place)."""
    w0 = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    g_seq = [np.random.RandomState(i + 1).randn(4, 3).astype(np.float32)
             for i in range(5)]
    tw = torch.nn.Parameter(torch.tensor(w0))
    opt = torch.optim.SGD([tw], lr=0.01, momentum=0.937, nesterov=True,
                          weight_decay=5e-4)
    params = {"m.w": torch.tensor(w0), "m.gamma": torch.ones(3)}
    bufs = {k: torch.zeros_like(v) for k, v in params.items()}
    jparams = {"w": jnp.asarray(w0)}
    jstate = jax_optim.init_sgd_state(jparams)
    masks = (jax_optim.trainable_mask(jparams), jax_optim.decay_mask(jparams))
    for g in g_seq:
        tw.grad = torch.tensor(g)
        opt.step()
        optim.sgd_update(params, {"m.w": torch.tensor(g), "m.gamma": torch.zeros(3)},
                         bufs, lr=0.01, momentum=0.937, weight_decay=5e-4)
        jparams, jstate["momentum"] = jax_optim.sgd_update(
            jparams, {"w": jnp.asarray(g)}, jstate, lr=0.01, momentum=0.937,
            weight_decay=5e-4, masks=masks)
    np.testing.assert_allclose(params["m.w"].numpy(), tw.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(params["m.w"].numpy(), np.asarray(jparams["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bufs["m.w"].numpy(), np.asarray(jstate["momentum"]["w"]),
                               rtol=1e-5, atol=1e-6)
    # gamma has a zero gradient and no decay: it must not move
    assert torch.equal(params["m.gamma"], torch.ones(3))


def test_to_jax_params_inverts_from_jax_params():
    params, model = _model(6)
    want = _flat(params)
    for got in (_flat(to_jax_params(model)), _flat(to_jax_params(model.state_dict()))):
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert isinstance(to_jax_params(model)["net"]["p5"], list)


def test_decay_and_trainable_groups_equal_jax():
    """'w' leaves decay; biases and norm params do not; mean/var are
    buffers the optimizer never sees."""
    params, model = _model(0)
    names = list(model.state_dict())
    want_decay = _flat(jax_optim.decay_mask(params))
    want_train = _flat(jax_optim.trainable_mask(params))
    assert {k: bool(v) for k, v in want_decay.items()} == optim.decay_mask(names)
    assert {k: bool(v) for k, v in want_train.items()} == optim.trainable_mask(names)
    assert {n for n, _ in model.named_parameters()} == {
        n for n, t in optim.trainable_mask(names).items() if t}
    assert {n.rsplit(".", 1)[1] for n, _ in model.named_buffers()} == {"mean", "var"}


@pytest.mark.parametrize("name", ["linear_lr", "cosine_lr"])
@pytest.mark.parametrize("epochs,steps", [(10, 100), (300, 10), (2, 3)])
def test_lr_schedules_equal_jax(name, epochs, steps):
    hyp = {"max_lr": 0.01, "min_lr": 1e-4, "warmup_epochs": 3}
    got = getattr(optim, name)(epochs, steps, hyp)
    np.testing.assert_array_equal(got, getattr(jax_optim, name)(epochs, steps, hyp))
    assert got.dtype == np.float32


def test_lr_schedule_shape():
    hyp = {"max_lr": 0.01, "min_lr": 1e-4, "warmup_epochs": 3}
    lin = optim.linear_lr(10, 100, hyp)
    assert len(lin) == 1000 and lin[0] == pytest.approx(1e-4)
    assert lin[300] == pytest.approx(0.01) and lin[-1] == pytest.approx(1e-4)
    assert np.argmax(optim.linear_lr(300, 10, hyp)) >= 99   # 100-step floor


def test_ema_decay_ramp_and_update():
    assert optim.ema_decay(2000) == pytest.approx(0.9999 * (1 - np.exp(-1.0)), rel=1e-6)
    # the JAX package computes the ramp in f32, where 1 - exp(-u/2000)
    # cancels: 2e-4 relative at u=1, which is 1e-7 of the EMA's weights
    for updates in (1, 7, 2000):
        assert optim.ema_decay(updates) == pytest.approx(
            float(jax_optim.ema_decay(jnp.asarray(updates, jnp.float32))), rel=2e-4)
    ema = {"w": torch.zeros(3), "n": torch.tensor(5)}
    optim.ema_update(ema, {"w": torch.ones(3), "n": torch.tensor(9)}, 1)
    d1 = 0.9999 * (1 - np.exp(-1 / 2000))
    np.testing.assert_allclose(ema["w"].numpy(), (1 - d1) * np.ones(3), rtol=1e-5)
    assert int(ema["n"]) == 5            # integer entries are left alone


# -- the training-mode attention ---------------------------------------------


def test_training_attention_matches_jax_einsum_form():
    """Attention in training mode (batch-statistics BN, the two-product
    form) against the JAX block with Context(train=True): output and input
    gradient within 1e-4, new running statistics within 1e-5."""
    ch, heads = 128, 2
    rng = np.random.default_rng(0)
    params = jax_yolo._init_attention(jax_yolo._KeyGen(3), ch, heads)
    x = rng.standard_normal((2, 6, 5, ch)).astype(np.float32)

    def f(xx):
        ctx = Context(train=True)
        return jax_blocks.attention(params, xx, ctx, "attn", heads), ctx.updates

    want, ups = f(jnp.asarray(x))
    want_grad = jax.grad(lambda xx: (f(xx)[0] ** 2).sum())(jnp.asarray(x))

    block = Attention(ch, heads).train()
    block.load_state_dict(from_flat(params), strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    got = block(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-3, atol=1e-4)
    for name in ("qkv", "pe", "proj"):
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(getattr(block, name), stat).numpy(),
                np.asarray(ups[f"attn/{name}"][stat]), rtol=1e-5, atol=1e-6)


def from_flat(tree):
    """A JAX-layout subtree -> a state dict (OIHW kernels)."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
        for k, v in _flat(tree).items()}


# -- gradients and steps against the JAX package -----------------------------


def test_loss_and_grads_match_jax():
    """One f32 forward/backward on TINY at 64 px: losses within 1e-4
    relative; every gradient leaf within 5e-3 of its largest entry (or of
    1e-5: three betas have a zero gradient and hold 1e-8 of noise), median
    under 1e-3. Both packages sum f32 in their own order through 60 layers
    of batch-norm backward with 8 values a channel at stride 32; against an
    f64 run of the port the JAX gradients are within 2.4e-3 and the port's
    within 9.4e-4."""
    params, model = _model(3)
    images, gt = _batch(3)
    # jitted: far quicker on the CPU than dispatching op by op
    jl, jgrads = jax.jit(jax_step.loss_and_grads, static_argnames=("cfg",))(
        params, jnp.asarray(images), jnp.asarray(gt), GAINS, cfg=JTINY)
    losses, grads = loss_and_grads(model.train(), torch.from_numpy(images),
                                   torch.from_numpy(gt), GAINS, cfg=TINY)
    np.testing.assert_allclose([float(v) for v in losses],
                               [float(v) for v in jl], rtol=1e-4)
    got, want = _flat(to_jax_params(grads)), _flat(jgrads)
    assert set(got) == {k for k in want if k.rsplit(".", 1)[1] not in ("mean", "var")}
    rel = {k: np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-5)
           for k in got}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 5e-3, (worst, rel[worst])
    assert np.median(list(rel.values())) < 1e-3


def _state_errors(state, jstate):
    """Largest differences between the port's state and the JAX state:
    BN running statistics and parameters (model and EMA) relative to
    max(|ref|, 1), momentum relative to its leaf's largest entry."""
    got = train_state_to_jax(state)
    assert int(got["step"]) == int(jstate["step"])
    assert int(got["ema_updates"]) == int(jstate["ema_updates"])
    errs = {"stats": 0.0, "params": 0.0, "momentum": 0.0}
    for key, mine, theirs in (("params", got["params"], jstate["params"]),
                              ("momentum", got["opt"]["momentum"],
                               jstate["opt"]["momentum"]),
                              ("params", got["ema_params"], jstate["ema_params"])):
        a, b = _flat(mine), _flat(theirs)
        assert a.keys() == b.keys()
        for k in a:
            kind = "stats" if k.endswith(("mean", "var")) else key
            floor = 1e-3 if kind == "momentum" else 1.0
            errs[kind] = max(errs[kind], float(
                np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), floor)))
    return errs


def test_three_train_steps_match_jax():
    """One state carried across to the port, then three f32 train steps in
    both packages on three seeded batches of 8 images at 96 px (at batch 2
    and 64 px BatchNorm sees 8 values a channel at stride 32, and an f64
    run of the port then drifts from its own f32 run by 18% of the
    momentum in three steps). Losses within 1e-4 relative at every step.
    After step 1, 2, 3: running statistics within 1e-5, 1e-5, 1e-4 and
    parameters and EMA within 1e-5, 1e-4, 1e-3 of max(|ref|, 1); momentum
    within 2e-3, 1e-2, 1e-1 of its leaf's largest entry. The limits grow
    because each update feeds the f32 differences of the last gradient
    back in (measured 1.3e-6/2.7e-6/3.7e-5, 1.2e-6/1.4e-5/2.3e-4 and
    5e-4/1.5e-3/4.1e-2)."""
    params, _ = _model(4)
    jstate = jax_step.init_train_state(params, ema=True)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), TINY)
    assert max(_state_errors(state, jstate).values()) == 0.0
    limits = [dict(stats=1e-5, params=1e-5, momentum=2e-3),
              dict(stats=1e-5, params=1e-4, momentum=1e-2),
              dict(stats=1e-4, params=1e-3, momentum=1e-1)]
    for s, limit in enumerate(limits):
        images, gt = _batch(10 + s, b=8, size=96)
        jstate, m = jax_step.train_step(
            jstate, jnp.asarray(images), jnp.asarray(gt), 0.001, GAINS, 5e-4,
            0.937, cfg=JTINY, accumulate=1, apply_update=True,
            compute_dtype=jnp.float32)
        losses = train_step(state, torch.from_numpy(images), torch.from_numpy(gt),
                            0.001, GAINS, 5e-4, 0.937, cfg=TINY, accumulate=1,
                            apply_update=True, compute_dtype=torch.float32)
        np.testing.assert_allclose(
            losses.numpy(), [float(m[k]) for k in ("loss_box", "loss_cls", "loss_dfl")],
            rtol=1e-4)
        errs = _state_errors(state, jstate)
        assert all(errs[k] < limit[k] for k in limit), (s, errs)
    assert state.step == 3 and state.ema_updates == 3


def test_grad_accumulation():
    """accumulate=2: the first micro-step stores gradients and moves only
    the BN statistics; the second applies the sum, which equals one update
    with the summed gradients, and clears the buffer."""
    _, model = _model(1)
    images, gt = _batch(1)
    ti, tg = torch.from_numpy(images), torch.from_numpy(gt)
    state = init_train_state(model, ema=False, accumulate=2)
    w0 = model.net["p1"][0].w.detach().clone()
    mean0 = model.net["p1"][0].mean.clone()
    kw = dict(cfg=TINY, accumulate=2, compute_dtype=torch.float32)
    train_step(state, ti, tg, 0.01, GAINS, 0.0, 0.9, apply_update=False, **kw)
    assert torch.equal(model.net["p1"][0].w, w0)
    assert not torch.equal(model.net["p1"][0].mean, mean0)
    g1 = {k: v.clone() for k, v in state.accum.items()}
    assert max(float(v.abs().max()) for v in g1.values()) > 0

    ref = copy.deepcopy(model)
    _, g2 = loss_and_grads(ref, ti, tg, GAINS, cfg=TINY)
    train_step(state, ti, tg, 0.01, GAINS, 0.0, 0.9, apply_update=True, **kw)
    assert all(float(v.abs().max()) == 0 for v in state.accum.values())
    # zero momentum and no decay: the nesterov step is (1 + mu) * grad
    want = w0 - 0.01 * 1.9 * (g1["net.p1.0.w"] + g2["net.p1.0.w"])
    torch.testing.assert_close(model.net["p1"][0].w.detach(), want,
                               rtol=1e-5, atol=1e-7)
    assert state.step == 2


def test_remat_levels_match():
    """remat per stage and per block give the losses, updated weights and
    BN running statistics of remat=False within 1e-5 (a second momentum
    update by the recompute would show in the statistics)."""
    outs = {}
    for remat in (False, True, "blocks"):
        _, model = _model(2)
        images, gt = _batch(2)
        state = init_train_state(model, ema=False)
        losses = train_step(state, torch.from_numpy(images), torch.from_numpy(gt),
                            0.01, GAINS, 5e-4, 0.937, cfg=TINY, remat=remat,
                            compute_dtype=torch.float32)
        outs[remat] = (losses, model.state_dict())
    for level in (True, "blocks"):
        torch.testing.assert_close(outs[level][0], outs[False][0], rtol=1e-5, atol=0)
        for k, v in outs[False][1].items():
            torch.testing.assert_close(outs[level][1][k], v, rtol=1e-5, atol=1e-6,
                                       msg=lambda m, k=k: f"{k}: {m}")


def test_bf16_train_step_learns():
    """The bf16 path on the CPU: eight steps on one batch stay finite, the
    loss comes down, BN statistics and the EMA move."""
    _, model = _model(0)
    images, gt = _batch(0, b=8)
    ti, tg = torch.from_numpy(images), torch.from_numpy(gt)
    state = init_train_state(model, ema=True)
    mean0 = model.net["p1"][0].mean.clone()
    totals = [float(train_step(state, ti, tg, 0.01, GAINS, 5e-4, 0.937,
                               cfg=TINY).sum()) for _ in range(8)]
    assert all(np.isfinite(totals)), totals
    assert min(totals[-3:]) < totals[0], totals
    assert not torch.equal(model.net["p1"][0].mean, mean0)
    assert any(not torch.equal(state.ema[k], v) for k, v in model.state_dict().items())
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fold_works_on_a_copy_of_a_trained_model():
    _, model = _model(5)
    images, gt = _batch(5)
    state = init_train_state(model, ema=False)
    train_step(state, torch.from_numpy(images), torch.from_numpy(gt), 0.01, GAINS,
               5e-4, 0.937, cfg=TINY, compute_dtype=torch.float32)
    x = torch.from_numpy(images).float() / 255
    served = copy.deepcopy(model).eval()
    with torch.inference_mode():
        want = served.forward_raw(x)
        got = served.fold_batchnorm().forward_raw(x)
    assert all(not k.endswith(".gamma") for k in served.state_dict())
    assert any(k.endswith(".gamma") for k in model.state_dict())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- the reference's 4-step trajectory ---------------------------------------


def _subtree(g, prefix):
    return {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}


def _dequant(g, tag, base=None):
    """A quantize16 section of the golden (tools/make_goldens.py): int16
    codes under '<tag>q.' times the scale under '<tag>s.', plus `base`."""
    out = {}
    for k in g.files:
        if not k.startswith(f"{tag}q."):
            continue
        leaf, v = k[len(tag) + 2:], g[k]
        if v.dtype == np.int16:
            v = v.astype(np.float32) * g[f"{tag}s.{leaf}"]
            if base is not None:
                v = base[leaf].astype(np.float32) + v
        out[leaf] = v
    return out


def test_train_trajectory_matches_reference():
    """tests/golden/train_traj.npz, the way tests/test_train_trajectory.py
    replays it, with its tolerances: step-0 losses (1e-4) and gradients
    (worst leaf 2.5e-2 of its scale, median 1e-3), the state after one
    update (1e-4), the 4-step losses (5e-3) and the final model and EMA
    (1e-2)."""
    g = load_golden("train_traj.npz")
    cfg = get_model_config("n")
    sd0 = _subtree(g, "sd0.")
    ref = lambda tree: convert_state_dict(tree, cfg, source_format="reference")

    def batch(s):
        img = np.ascontiguousarray(np.transpose(g[f"img_{s}"], (0, 2, 3, 1)))
        gt = build_padded_targets(
            {"idx": g[f"idx_{s}"], "cls": g[f"cls_{s}"], "box": g[f"box_{s}"]},
            batch_size=2, max_gt=32, input_hw=img.shape[1:3])
        return torch.from_numpy(img), torch.from_numpy(gt)

    def leaf_diffs(want, got):
        assert want.keys() == got.keys()
        return [(float((got[k].detach() - want[k]).abs().max()),
                 float(want[k].abs().max()), k) for k in want]

    model = YOLO.from_state_dict(cfg, ref(sd0)).train()
    img0, gt0 = batch(0)
    losses, grads = loss_and_grads(copy.deepcopy(model), img0.float(), gt0,
                                   GAINS, cfg=cfg)
    np.testing.assert_allclose([float(v) for v in losses], g["losses"][0], rtol=1e-4)
    gref = {k: v for k, v in ref({**sd0, **_dequant(g, "gr")}).items() if k in grads}
    scaled = [(d / max(scale, 1e-6), k) for d, scale, k in leaf_diffs(gref, grads)]
    assert max(scaled)[0] < 2.5e-2, max(scaled)
    assert float(np.median([s for s, _ in scaled])) < 1e-3

    state = init_train_state(model, ema=True)
    steps = []
    for s in range(4):
        img, gt = batch(s)
        steps.append(train_step(state, img.float(), gt, 0.002, GAINS, 5e-4, 0.937,
                                cfg=cfg, compute_dtype=torch.float32).tolist())
        if s == 0:
            diffs = leaf_diffs(ref(_dequant(g, "sd1", sd0)), model.state_dict())
            assert max(diffs)[0] < 1e-4, max(diffs)
    np.testing.assert_allclose(np.asarray(steps), g["losses"], rtol=5e-3, atol=1e-4)
    for tag, ours in (("sdf", model.state_dict()), ("sde", state.ema)):
        diffs = leaf_diffs(ref(_dequant(g, tag, sd0)), ours)
        assert max(diffs)[0] < 1e-2, (tag, max(diffs))


def test_train_trajectory_long_matches_reference():
    """tests/golden/train_traj_long.npz, the 112-step production-schedule
    trajectory, the way tests/test_train_trajectory.py replays it and with
    its tolerances: LinearLR through its warmup/decay turn, accumulate=16,
    the epoch-start zeroing of accumulated gradients, EMA coupled to the
    update count; stitched at epoch 4 on the reference's stored state.
    About 20 s of eager CPU steps, so it runs with the other tests."""
    g, g0 = load_golden("train_traj_long.npz"), load_golden("train_traj.npz")
    cfg = get_model_config("n")
    sd0 = _subtree(g0, "sd0.")
    ref = lambda tree: convert_state_dict(tree, cfg, source_format="reference")
    bs, size, num_steps, epochs, accumulate = 4, 96, 14, 8, 16
    hyp = {"max_lr": 0.001, "min_lr": 0.00001, "warmup_epochs": 3.0}
    np.testing.assert_allclose(optim.linear_lr(epochs, num_steps, hyp),
                               g["total_lr"], rtol=2e-6, atol=0)

    def batch(b):
        img = np.ascontiguousarray(np.transpose(g[f"pimg_{b}"], (0, 2, 3, 1)))
        gt = build_padded_targets(
            {"idx": g[f"pidx_{b}"], "cls": g[f"pcls_{b}"], "box": g[f"pbox_{b}"]},
            batch_size=bs, max_gt=32, input_hw=(size, size))
        return torch.from_numpy(img).float(), torch.from_numpy(gt)

    batches = [batch(b) for b in range(8)]
    want = np.asarray(g["losses"])

    def run_half(state, lo, hi):
        losses = []
        for epoch in range(lo, hi):
            torch._foreach_zero_(list(state.accum.values()))
            for i in range(num_steps):
                step = epoch * num_steps + i
                img, gt = batches[step % 8]
                losses.append(train_step(
                    state, img, gt, float(g["total_lr"][step]), GAINS, 5e-4, 0.937,
                    cfg=cfg, accumulate=accumulate,
                    apply_update=step % accumulate == 0,
                    compute_dtype=torch.float32).tolist())
        return np.asarray(losses)

    def check_losses(losses, part, label, early_tol):
        rel = np.abs(losses - part) / np.maximum(np.abs(part), 1e-6)
        assert rel[:32].max() < early_tol, (label, rel[:32].max())
        assert rel.max() < 0.12, (label, rel.max(), rel.argmax())
        assert np.median(rel) < 2e-3, (label, np.median(rel))

    def check_state(tag, ours, base, tol):
        tree = ref(_dequant(g, tag, base))
        worst = max((float((ours[k].detach() - v).abs().max()
                           / max(float(v.abs().max()), 1.0)), k)
                    for k, v in tree.items())
        assert worst[0] < tol, (tag, worst)

    half = epochs // 2
    state = init_train_state(YOLO.from_state_dict(cfg, ref(sd0)), ema=True,
                             accumulate=accumulate)
    check_losses(run_half(state, 0, half), want[:half * num_steps],
                 "first-half", 2e-3)
    assert state.ema_updates == int(g["ema_updates_mid"]) == 4
    check_state("sdm", state.model.state_dict(), sd0, 2e-2)
    check_state("sme", state.ema, sd0, 2e-2)

    sdm = _dequant(g, "sdm", sd0)
    state = init_train_state(YOLO.from_state_dict(cfg, ref(sdm)), ema=True,
                             accumulate=accumulate)
    with torch.no_grad():
        for dst, tree in ((state.ema, ref(_dequant(g, "sme", sd0))),
                          (state.momentum, ref({**sd0, **_dequant(g, "smo")}))):
            for k, t in dst.items():
                t.copy_(tree[k])
    state.ema_updates = int(g["ema_updates_mid"])
    check_losses(run_half(state, half, epochs), want[half * num_steps:],
                 "second-half", 3e-2)
    assert state.ema_updates == int(g["ema_updates"]) == 7
    check_state("sdf", state.model.state_dict(), sdm, 6e-2)
    check_state("sde", state.ema, sdm, 6e-2)
