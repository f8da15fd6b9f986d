"""The port's channel tensor parallelism (parallel/tensor.py) across gloo
processes on the CPU, against the JAX package's GSPMD step under
`shard_model_parallel(min_channels=64)` on its virtual CPU devices and
against the port's single process: `python -m tpu_yolo_torch.rehearsal
--n-model 2` workers (a tiny model at 64 px, f32), all started at once
from one fixture, one process group per run rendezvousing on a file in
tmp_path; JAX's int8 weights split the same way (`--split-forward`)
against JAX's split int8 forward and the port's one-process one; the
sharded names and the rank layout against JAX's mesh; the refusals. The
workers import torch and the port only."""
import json
import os
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax

from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.io import checkpoint as jax_ckpt
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.parallel import DataParallel as JaxDataParallel
from tpu_yolo.parallel import make_mesh as jax_make_mesh
from tpu_yolo.parallel import make_spatial_mesh as jax_make_spatial_mesh
from tpu_yolo_torch import parallel
from tpu_yolo_torch.core.config import get_model_config, load_hyperparams
from tpu_yolo_torch.io.checkpoint import load_checkpoint
from tpu_yolo_torch.io.weights import from_jax_params, train_state_from_jax
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.parallel import tensor
from tpu_yolo_torch.parallel.mesh import Mesh
from tpu_yolo_torch.rehearsal import TINY, spatial_images
from test_torch_spatial import INT8_BOX_TOL, INT8_SCORE_TOL, SIZE, _int8_weights

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4          # tests/test_parallel.py's tolerance between topologies
GRAD_TOL = 1e-5     # the replicated stem's gradient against one process
TIMEOUT = 300
CPU = torch.device("cpu")
JTINY = JaxConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                  num_classes=TINY.num_classes)
# the (n_data, accumulate) cases of the dp x tp step, on a model axis of 2
CASES = [(1, 1), (1, 2), (2, 1), (2, 2)]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")


def _start(n: int, extra, init: str | None):
    """n rehearsal processes; one process group on the file `init`, or a
    single process with no group when init is None."""
    group = ["--init-method", f"file://{init}"] if init else []
    return [subprocess.Popen(
        [sys.executable, "-m", "tpu_yolo_torch.rehearsal", "--device", "cpu",
         "--num-processes", str(n), "--process-id", str(i), *group, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(),
        cwd=ROOT) for i in range(n)]


def _collect(procs):
    outs, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errs.append(err[-4000:])
            else:
                outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, "\n---\n".join(errs)
    return outs


# One JAX train_step on make_mesh(n_data, n_model) with the state under
# shard_model_parallel(min_channels=64) (on one device when both are 1),
# on the rehearsal's first global batch of 8, in a process of its own
# (the cases trace and compile at once): argv n_data, n_model,
# accumulate, out.npz; writes the losses and the state in the port's
# names ("param/", "momentum/", "ema/" + name, OIHW).
_JAX_STEP = """
import sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
from tpu_yolo.core.config import ModelConfig
from tpu_yolo.parallel import DataParallel, make_mesh
from tpu_yolo.train import loss, step
from tpu_yolo.train.trainer import _gt_bucket
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import init_params
from tpu_yolo_torch.rehearsal import GAINS, TINY, make_global_batch

n_data, n_model, accumulate = (int(a) for a in sys.argv[1:4])
cfg = ModelConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                  num_classes=TINY.num_classes)
dp = DataParallel(make_mesh(n_data=n_data, n_model=n_model,
                            devices=jax.devices()[:n_data * n_model]))
state = step.init_train_state(init_params(0, TINY), ema=True, accumulate=accumulate)
state = dp.shard_model_parallel(jax.tree_util.tree_map(jnp.asarray, state), min_channels=64)
assert (state["params"]["fpn"]["h6"]["conv1"]["w"].sharding.spec[-1:] == ("model",)) == (
    n_model > 1)
images, targets = make_global_batch(0, 8, 64, TINY.num_classes)
counts = np.bincount(targets["idx"].astype(np.int64), minlength=8)
gt = loss.build_padded_targets(targets, 8, _gt_bucket(int(counts.max())), (64, 64))
state, m = step.train_step(
    state, dp.shard_batch(jnp.asarray(images)), dp.shard_batch(jnp.asarray(gt)),
    0.01, jnp.asarray(GAINS, jnp.float32), 5e-4, 0.937, cfg=cfg,
    accumulate=accumulate, apply_update=True, compute_dtype=jnp.float32)
state = jax.tree_util.tree_map(np.asarray, state)
arrays = {"losses": np.asarray([float(m[k]) for k in ("loss_box", "loss_cls", "loss_dfl")])}
for prefix, tree in (("param", state["params"]), ("momentum", state["opt"]["momentum"]),
                     ("ema", state["ema_params"])):
    arrays.update({f"{prefix}/{n}": t.numpy() for n, t in from_jax_params(tree, TINY).items()})
np.savez(sys.argv[4], **arrays)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this file, started together: the single process (the
    oracle) at accumulate 1 and 2 and for two steps, two data-parallel
    ranks with no model axis, the (1, 2) and (2, 2)
    meshes at accumulate 1 and 2 (the (1, 2) one at accumulate 1 writes a
    .ckpt) and JAX's step on each mesh; then a plain process resuming
    that .ckpt."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    ckpt = str(d / "tp.ckpt")
    q = _int8_weights()
    torch.save(from_jax_params(q, TINY), d / "int8.pt")
    specs = {"oracle2": (1, ["--steps", "2"], None), "dp2": (2, [], d / "dp2"),
             "int8_split": (2, ["--steps", "0", "--n-model", "2", "--min-channels", "64",
                                "--split-forward", "--weights", str(d / "int8.pt"),
                                "--spatial-size", str(SIZE), "--global-batch", "2"],
                            d / "int8_split")}
    for acc in (1, 2):
        specs[f"oracle_acc{acc}"] = (1, ["--accumulate", str(acc)], None)
        for n_data in (1, 2):
            extra = ["--n-model", "2", "--min-channels", "64", "--accumulate", str(acc)]
            if (n_data, acc) == (1, 1):
                extra += ["--ckpt", ckpt]
            specs[f"tp{n_data}_acc{acc}"] = (2 * n_data, extra, d / f"tp{n_data}_acc{acc}")
    dumps = {k: d / f"dump_{k}" for k in specs}
    jax_cases = [(n_data, 2, acc) for n_data, acc in CASES] + [(1, 1, 1), (1, 1, 2)]
    jax_runs = {c: subprocess.Popen(
        [sys.executable, "-c", _JAX_STEP, *map(str, c), str(d / f"jax{c}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
        for c in jax_cases}
    started = {k: _start(n, ["--steps", "1", "--dump", str(dumps[k]), *extra]
                         if k != "oracle2" else ["--dump", str(dumps[k]), *extra],
                         init and str(init))
               for k, (n, extra, init) in specs.items()}
    try:   # JAX's int8 forward, its convs split as shard_model_parallel(64) splits them
        jdp = JaxDataParallel(jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2]))
        fwd = jax.jit(lambda p, v: jax_yolo.forward(p, v, JTINY, train=False))
        x = jax.numpy.asarray(spatial_images(2, SIZE).astype(np.float32) / 255)
        split = jdp.shard_model_parallel(q, min_channels=64)
        assert split["fpn"]["h6"]["conv1"]["w_q"].sharding.spec[-1:] == ("model",)
        assert split["fpn"]["h6"]["conv1"]["s_in"].sharding.spec == ()
        jax_int8 = {"split": np.asarray(fwd(split, x)), "unsharded": np.asarray(fwd(q, x))}
    finally:
        out = {k: _collect(p) for k, p in started.items()}
    out["jax_int8"], out["int8_state"] = jax_int8, torch.load(d / "int8.pt")
    for c, proc in jax_runs.items():
        _, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, err[-4000:]
    out["jax"] = {c: dict(np.load(d / f"jax{c}.npz")) for c in jax_cases}
    out["resumed"] = _collect(_start(1, ["--steps", "1", "--start-step", "1",
                                         "--resume-from", ckpt], None))[0]
    out["dump"] = {k: dict(np.load(v / "rank0.npz")) for k, v in dumps.items()}
    out["ckpt"] = ckpt
    return out


@pytest.mark.parametrize("n_data,accumulate", CASES)
def test_dp_x_tp_step_matches_jax_and_one_process(runs, n_data, accumulate):
    """(c) One dp x tp train_step on a (n_data, 2) mesh: the ranks' losses
    and whole states bit-equal to each other; the losses within 2e-4 of
    JAX's GSPMD step on the same mesh shape and of the port's single
    process; the gathered parameters, BN statistics, momentum and EMA
    within 2e-4 of the single process's, and all but the momentum within
    2e-4 of JAX's one-device step; the replicated stem's gradient
    (upstream of every split conv, so whole only through copy_model's
    all-reduce) within 1e-5 of that of the same data axis with no model
    axis: the single process's at n_data 1, two data-parallel ranks' at 2
    (their BatchNorm moments, summed over the data axis, move it further
    than 1e-5 from the single process's).

    The momentum is the first gradient, which the two packages sum in
    their own order through the BatchNorm backward: at the stem their
    single processes differ by more than 2e-4 (test_torch_train.py bounds
    that gap at 5e-3 of a leaf's largest entry). The state is held to
    JAX's one-device step, not its (2, 2) one: there JAX's replicated
    depthwise convs (head.cls.0.0) take a gradient far from its own
    one-device and (1, 2) steps', a fault of the JAX side (ROADMAP.md)."""
    ranks = runs[f"tp{n_data}_acc{accumulate}"]
    oracle = runs[f"oracle_acc{accumulate}"][0]
    assert [r["coords"] for r in ranks] == [
        {"data": i // 2, "model": i % 2} for i in range(2 * n_data)]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert len({r["state_sha256"] for r in ranks}) == 1
    assert ranks[0]["collectives"]["model"]["calls"] > 0
    assert ("data" in ranks[0]["collectives"]) == (n_data > 1)
    same_mesh, one_device = runs["jax"][(n_data, 2, accumulate)], runs["jax"][(1, 1, accumulate)]
    for got in (ranks[0]["losses"][0], oracle["losses"][0]):
        np.testing.assert_allclose(got, same_mesh["losses"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ranks[0]["losses"], oracle["losses"], rtol=TOL, atol=TOL)

    mine = runs["dump"][f"tp{n_data}_acc{accumulate}"]
    one = runs["dump"][f"oracle_acc{accumulate}"]
    keys = [k for k in one if k.split("/")[0] in ("param", "momentum", "ema")]
    assert keys and set(keys) <= set(one_device)
    for key in keys:
        np.testing.assert_allclose(mine[key], one[key], rtol=TOL, atol=TOL, err_msg=key)
        if not key.startswith("momentum/"):
            np.testing.assert_allclose(mine[key], one_device[key], rtol=TOL, atol=TOL,
                                       err_msg=key)
    stem, data_only = "grad/net.p1.0.w", runs["dump"]["oracle_acc1" if n_data == 1 else "dp2"]
    assert not np.array_equal(data_only[stem], 0)
    np.testing.assert_allclose(mine[stem], data_only[stem], rtol=GRAD_TOL, atol=GRAD_TOL)


def test_tp_checkpoint_resumes_in_one_process(runs):
    """(d) The (1, 2) ranks' .ckpt holds whole tensors: train_state_from_jax
    reads it into a plain model equal to the ranks' gathered state, the
    JAX package's loader reads the same shapes as its own init, and a
    plain port process resumed from it takes the single process's second
    step within 2e-4."""
    payload = load_checkpoint(runs["ckpt"])
    state = train_state_from_jax(payload, TINY)
    mine = runs["dump"]["tp1_acc1"]
    for name, t in state.model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), mine[f"param/{name}"], err_msg=name)
    for name, t in state.momentum.items():
        np.testing.assert_array_equal(t.numpy(), mine[f"momentum/{name}"], err_msg=name)
    jax_payload = jax_ckpt.load_checkpoint(runs["ckpt"])
    shapes = jax.tree_util.tree_map(np.shape, init_params(0, TINY))
    assert jax.tree_util.tree_map(np.shape, jax_payload["params"]) == shapes
    assert int(jax_payload["step"]) == 1
    np.testing.assert_allclose(runs["resumed"]["losses"][0], runs["oracle2"][0]["losses"][1],
                               rtol=TOL, atol=TOL)


def _dotted(tree) -> dict:
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("model,min_channels", [("tiny", 64), ("tiny", 256),
                                                 ("n", 64), ("n", 256)])
def test_sharded_names_equal_jax(model, min_channels):
    """(a) The tensors the port splits over a model axis of 2, name for
    name, are those JAX's DataParallel.model_sharding_spec splits; at
    v11-n, 70 of 87 convs at 64 and the 11 of the p5 level at 256."""
    cfg = TINY if model == "tiny" else get_model_config("n")
    params = init_params(0, cfg)
    jdp = JaxDataParallel(jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2]))
    want = {name for name, leaf in _dotted(params).items()
            if jdp.model_sharding_spec(leaf, min_channels).spec[-1:] == ("model",)}
    dp = parallel.DataParallel(Mesh((CPU,), 2, 0, ("model", 2)))
    yolo = YOLO.from_state_dict(cfg, from_jax_params(params, cfg))
    by_spec = {name for name, t in yolo.state_dict().items()
               if dp.model_sharding_spec(t, min_channels).spec == ("model",)}
    dp.shard_model_parallel(yolo, min_channels)
    split = set(tensor.split_names(yolo))
    assert split == by_spec == want
    convs = {name.rsplit(".", 1)[0] for name in split}
    if model == "n":
        assert len(convs) == {64: 70, 256: 11}[min_channels]
        if min_channels == 256:
            assert all(c.startswith(("net.p5.", "fpn.h6.", "head.cls.2.")) for c in convs)
    for name, t in yolo.state_dict().items():
        full = dict(_dotted(params))[name].shape[-1] if name in want else None
        if full is not None:
            assert t.shape[0] == full // 2, name


@pytest.mark.parametrize("axis", ["model", "spatial"])
@pytest.mark.parametrize("n_data,n_second", [(1, 2), (2, 2), (4, 2)])
def test_rank_layout_equals_jax_device_grid(axis, n_data, n_second):
    """(b) Rank r of the port's (data, model|spatial) mesh sits where
    device r sits in the JAX package's mesh of the same shape."""
    make = jax_make_mesh if axis == "model" else jax_make_spatial_mesh
    jm = make(n_data, n_second)
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    for r in range(n_data * n_second):
        mesh = Mesh((CPU,), n_data * n_second, r, (axis, n_second))
        assert mesh.shape == dict(jm.shape)
        assert tuple(np.argwhere(ids == r)[0]) == (mesh.coords["data"], mesh.coords[axis])


def test_refusals():
    """(e) A model axis that does not divide the ranks, a mesh asking for
    more ranks than there are, the trainer given a model axis, quantizing
    a split conv (JAX's quantize_params makes whole arrays of split
    leaves, so its result is no longer split either); an int8 conv is
    split as JAX splits it."""
    with pytest.raises(ValueError, match="a model axis of 2 does not divide the 1 ranks"):
        parallel.make_mesh(n_model=2)
    with pytest.raises(ValueError, match=r"need 4 devices for a \('data', 'model'\) mesh"):
        parallel.make_mesh(n_data=2, n_model=2)
    with pytest.raises(ValueError, match="a spatial axis of 3 does not divide"):
        parallel.make_spatial_mesh(n_spatial=3)

    from tpu_yolo_torch.train.trainer import train

    tp = parallel.DataParallel(Mesh((CPU,), 2, 0, ("model", 2)))
    with pytest.raises(ValueError, match="the trainer is data-parallel only"):
        train(Namespace(save_dir="unused", batch_size=4), load_hyperparams(), TINY,
              device="cpu", dp=tp)

    folded = YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY))
    folded.fold_batchnorm()
    tp.shard_model_parallel(folded, 64)
    with pytest.raises(ValueError, match="split over the model axis; int8"):
        folded.fpn["h6"].conv1.quantize_(0.1)
    # the other order is JAX's: an int8 conv splits w_q, s_w and b, not s_in
    int8 = YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY))
    int8.fold_batchnorm()
    int8.fpn["h6"].conv1.quantize_(0.1)
    tp.shard_model_parallel(int8, 64)
    conv = int8.fpn["h6"].conv1
    assert conv.shard is not None and conv.w_q.shape[0] == conv.s_w.shape[0] == conv.b.shape[0]
    assert conv.w_q.shape[0] * 2 == conv.shard.full and conv.s_in.dim() == 0


def test_int8_split_forward_matches_jax_and_one_process(runs):
    """JAX's int8 weights split over a model axis of 2 at --min-channels 64
    (w_q, s_w and b on their output channels, s_in whole) on 2 images at
    128 px: the ranks hold the same output, within
    tests/test_torch_quant.py's tolerances of JAX's int8 forward under
    shard_model_parallel(min_channels=64) and unsplit (boxes 1e-3 px,
    scores 1e-5), and bit-equal to the port's one-process int8 forward
    (each rank's half of a conv's output channels sums exact integers)."""
    ranks = runs["int8_split"]
    assert [r["coords"] for r in ranks] == [{"data": 0, "model": i} for i in range(2)]
    key = f"plain/{SIZE}/float32"
    fwds = [r["split"]["forwards"][key] for r in ranks]
    assert fwds[0]["sha256"] == fwds[1]["sha256"] and fwds[0]["rows"] == [2, SIZE]
    assert fwds[0]["collectives"]["model"]["calls"] > 0
    got = runs["dump"]["int8_split"][f"split/{key}"]
    for ref in runs["jax_int8"].values():
        assert np.abs(got[..., :4] - ref[..., :4]).max() <= INT8_BOX_TOL
        assert np.abs(got[..., 4:] - ref[..., 4:]).max() <= INT8_SCORE_TOL
    model = YOLO.from_state_dict(TINY, runs["int8_state"])
    with torch.inference_mode():
        one = model(torch.from_numpy(spatial_images(2, SIZE)).float() / 255).numpy()
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("rank", [0, 1])
def test_int8_split_names_equal_jax(rank):
    """An int8 model's split leaves, name for name, are those JAX's
    model_sharding_spec splits in its int8 tree at min_channels 64 (w_q,
    s_w and b of each wide conv; no s_in), and shard_state slices a whole
    int8 state as the split model holds it."""
    q = _int8_weights()
    jdp = JaxDataParallel(jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2]))
    want = {name for name, leaf in _dotted(q).items()
            if jdp.model_sharding_spec(leaf, 64).spec[-1:] == ("model",)}
    whole = YOLO.from_state_dict(TINY, from_jax_params(q, TINY))
    split = YOLO.from_state_dict(TINY, from_jax_params(q, TINY))
    parallel.DataParallel(Mesh((CPU,), 2, rank, ("model", 2))).shard_model_parallel(split, 64)
    names = set(tensor.split_names(split))
    assert names == want and any(n.endswith(".w_q") for n in names)
    assert not any(n.endswith(".s_in") for n in names)
    mine = tensor.shard_state(split, whole.state_dict())
    for name, t in split.state_dict().items():
        assert torch.equal(mine[name], t), name


def test_shard_state_inverts_the_split():
    """shard_state slices whole tensors as shard_model_parallel splits
    the model, on each rank of the model axis."""
    whole = YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY))
    sd = whole.state_dict()
    for r in range(2):
        split = YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY))
        parallel.DataParallel(Mesh((CPU,), 2, r, ("model", 2))).shard_model_parallel(split, 64)
        mine = tensor.shard_state(split, sd)
        for name, t in split.state_dict().items():
            assert torch.equal(mine[name], t), name
