"""The port's height-sharded forward (parallel/spatial.py) across gloo
processes on the CPU: the halo exchange of a conv and a max pool against
the unsharded op, and YOLO's forward on a tiny model through `python -m
tpu_yolo_torch.rehearsal --n-spatial N` workers, against the JAX
package's forward under `make_spatial_mesh` (GSPMD's halo exchange) and
its unsharded forward: at 128 px over (data 1, spatial 4) and (data 2,
spatial 2) meshes, where every map's rows split evenly; at heights whose
p5 rows do not (96 px over 2 ranks, 160 px over (2, 2)) or leave ranks
without a p5 row (64 px over 4); with the space-to-depth stem, fed images
or a batch already rearranged; and JAX's int8 weights at 128 px over 2
ranks, bit-equal to the port's one-process int8 forward. Then the block
layout and the refusals. Every worker process is started at once from
one fixture; the workers import torch and the port only."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.parallel import make_spatial_mesh as jax_make_spatial_mesh
from tpu_yolo.parallel import spatial_batch_sharding as jax_spatial_batch_sharding
from tpu_yolo.quant import calibrate as jax_calibrate
from tpu_yolo.quant import quantize_params as jax_quantize_params
from tpu_yolo_torch import parallel
from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params, space_to_depth_host
from tpu_yolo_torch.ops.nn import max_pool
from tpu_yolo_torch.parallel.mesh import Mesh
from tpu_yolo_torch.parallel.spatial import Shards, partition_spatial
from tpu_yolo_torch.rehearsal import TINY, spatial_images
from tpu_yolo_torch.seeded import eval_state

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JTINY = JaxConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                  num_classes=TINY.num_classes)
TIMEOUT = 300
SIZE = 128
HALO_TOL = 1e-6
FWD_TOL = 1e-5      # tests/test_parallel.py's rtol and atol
CPU = torch.device("cpu")
# (op, ranks, H): every op over 2 ranks of 4 rows; over 4 ranks a stride-1
# conv and the 5x5 pool at 1 row a rank (the pool's halo of 2 spans two
# ranks), the stride-2 conv at 2 rows a rank (its shards start on even rows)
HALO_CASES = [("conv_s1", 2, 8), ("conv_s2", 2, 8), ("pool5", 2, 8),
              ("conv_s1", 4, 4), ("conv_s2", 4, 8), ("pool5", 4, 4)]
# the rehearsal's spatial runs: name -> (n_data, n_spatial, argv); the
# (1, 4) and (2, 2) runs at 128 px also take an uneven height each
SPATIAL_RUNS = {
    "1x4": (1, 4, ["--spatial-size", str(SIZE), "--spatial-size", "64"]),
    "2x2": (2, 2, ["--spatial-size", str(SIZE), "--spatial-size", "160"]),
    "1x2": (1, 2, ["--spatial-size", "96", "--spatial-stem", "plain", "--spatial-stem", "s2d",
                   "--spatial-stem", "s2d-input"]),
    "int8": (1, 2, ["--spatial-size", str(SIZE), "--global-batch", "2"]),
}
# (run, stem, size): the forwards held to JAX beyond the even 128 px ones;
# at 96 px the p5 map's 3 rows split 2 and 1, at 160 px its 5 rows 3 and
# 2, at 64 px its 2 rows 1, 0, 1 and 0 over 4 ranks
UNEVEN_CASES = [("1x2", "plain", 96), ("2x2", "plain", 160), ("1x4", "plain", 64),
                ("1x2", "s2d", 96), ("1x2", "s2d-input", 96)]
INT8_BOX_TOL, INT8_SCORE_TOL = 1e-3, 1e-5   # tests/test_torch_quant.py's

# One rank of the halo checks: argv rank, world, init file, data.npz,
# out.npz. Each case's input is the whole map; the rank runs the op on its
# rows (a ConvBN marked spatial, or max_pool with the axis) and writes its
# output rows; "halo3" is the map with 3 halo rows each side, filled -7.
_HALO = textwrap.dedent('''
    import sys
    import numpy as np, torch
    from tpu_yolo_torch import parallel
    from tpu_yolo_torch.ops.nn import ConvBN, max_pool
    from tpu_yolo_torch.parallel.spatial import SpatialAxis, halo

    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    data = np.load(sys.argv[4])
    parallel.init_distributed("cpu", init_method="file://" + init, rank=rank,
                              world_size=world)
    mesh = parallel.make_spatial_mesh(n_spatial=world)
    axis = SpatialAxis(mesh.coords["spatial"], world)

    def own(x):
        per = x.shape[2] // world
        return torch.from_numpy(x[:, :, rank * per:(rank + 1) * per])

    out = {}
    for key in data.files:
        if not key.startswith("x/"):
            continue
        op, x = key[2:], data[key]
        if op.startswith("conv"):
            conv = ConvBN(x.shape[1], 6, 3, stride=int(op[-1]), padding=1, folded=True)
            with torch.no_grad():
                conv.w.copy_(torch.from_numpy(data["w"]))
                conv.b.copy_(torch.from_numpy(data["b"]))
            conv.spatial = axis
            y = conv(own(x))
        elif op.startswith("pool5"):
            y = max_pool(own(x), 5, axis=axis)
        else:
            y = halo(own(x), axis, 3, 3, -7.0)
        out[op] = y.detach().numpy()
    np.savez(sys.argv[5], **out)
    parallel.close_distributed()
''')


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")


def _popen(argv):
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env(), cwd=ROOT)


def _halo_data(world: int):
    rng = np.random.default_rng(world)
    data = {"w": rng.normal(size=(6, 3, 3, 3)).astype(np.float32) * 0.3,
            "b": rng.normal(size=6).astype(np.float32),
            "x/halo3": rng.normal(size=(2, 3, 4, 5)).astype(np.float32)}
    for op, ranks, h in HALO_CASES:
        if ranks == world:   # mostly negative, so that a 0 fill would show
            data[f"x/{op}"] = rng.normal(-1.0, 1.0, size=(2, 3, h, 5)).astype(np.float32)
    return data


def _int8_weights():
    """JAX's int8 TINY weights (numpy tree): `seeded.eval_state`'s folded
    weights (logits of unit spread) set from, and calibrated on, the int8
    run's two images, as tests/test_torch_quant.py's JAX case makes them.
    On other images this tiny int8 model saturates, and JAX's FMA in the
    dequantize (ROADMAP.md, known differences) then moves quantized inputs
    by a step and its outputs far apart, sharded or not."""
    imgs = spatial_images(2, SIZE)
    params = to_jax_params(YOLO.from_state_dict(TINY, eval_state(TINY, 0, imgs, "cpu"))
                           .fold_batchnorm())
    q = jax_quantize_params(params, jax_calibrate(params, JTINY, imgs))
    return jax.tree_util.tree_map(np.asarray, q)


def _jax_forwards(params, x, meshes):
    """JAX's forward of x: unsharded, and under each (n_data, n_spatial)
    mesh with x split as P("data", "spatial")."""
    fwd = jax.jit(lambda p, v: jax_yolo.forward(p, v, JTINY, train=False))
    out = {"unsharded": np.asarray(fwd(params, jnp.asarray(x)))}
    for n_data, n_spatial in meshes:
        mesh = jax_make_spatial_mesh(n_data=n_data, n_spatial=n_spatial)
        assert dict(mesh.shape) == {"data": n_data, "spatial": n_spatial}
        xs = jax.device_put(jnp.asarray(x), jax_spatial_batch_sharding(mesh))
        ps = jax.device_put(params, NamedSharding(mesh, PartitionSpec()))
        out[(n_data, n_spatial)] = np.asarray(fwd(ps, xs))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The halo workers over 2 and 4 ranks, and the rehearsal's spatial
    forwards of SPATIAL_RUNS, started together; JAX's forwards run
    meanwhile. Returns the halo outputs per world (each rank's rows, in
    rank order), the spatial forwards' JSON lines and dumps per run, and
    JAX's outputs by (stem, size) and by int8."""
    d = tmp_path_factory.mktemp("spatial")
    q = _int8_weights()
    torch.save(from_jax_params(q, TINY), d / "int8.pt")
    halo_procs = {}
    for world in (2, 4):
        np.savez(d / f"halo{world}.npz", **_halo_data(world))
        halo_procs[world] = [_popen([sys.executable, "-c", _HALO, str(r), str(world),
                                     str(d / f"init{world}"), str(d / f"halo{world}.npz"),
                                     str(d / f"halo{world}_{r}.npz")]) for r in range(world)]
    fwd_procs = {}
    for name, (n_data, n_spatial, extra) in SPATIAL_RUNS.items():
        world = n_data * n_spatial
        weights = ["--weights", str(d / "int8.pt")] if name == "int8" else []
        fwd_procs[name] = [_popen(
            [sys.executable, "-m", "tpu_yolo_torch.rehearsal", "--device", "cpu",
             "--num-processes", str(world), "--process-id", str(r), "--init-method",
             f"file://{d / f'fwd_{name}'}", "--steps", "0", "--n-spatial", str(n_spatial),
             *extra, *weights, "--dump", str(d / f"dump_{name}")]) for r in range(world)]
    out = {"jax": {}}
    try:
        params = jax_yolo.fold_batchnorm(init_params(0, TINY))
        s2d = jax_yolo.fold_stem_space_to_depth(params)
        images = {size: spatial_images(8, size).astype(np.float32) / 255
                  for size in (SIZE, 96, 160, 64)}
        out["jax"][("plain", SIZE)] = _jax_forwards(params, images[SIZE], [(1, 4), (2, 2)])
        for run, stem, size in UNEVEN_CASES:
            x = images[size]
            if stem == "s2d-input":
                x = space_to_depth_host(x)
            out["jax"][(stem, size)] = _jax_forwards(
                params if stem == "plain" else s2d, x, [SPATIAL_RUNS[run][:2]])
        out["jax"]["int8"] = _jax_forwards(q, images[SIZE][:2], [(1, 2)])
    finally:
        errs = []
        for p in [p for procs in (*halo_procs.values(), *fwd_procs.values()) for p in procs]:
            try:
                p.stdout_text, err = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                p.stdout_text, err = p.communicate()
            if p.returncode:
                errs.append(err[-4000:])
        assert not errs, "\n---\n".join(errs)
    out["halo"] = {world: [dict(np.load(d / f"halo{world}_{r}.npz")) for r in range(world)]
                   for world in (2, 4)}
    out["halo_data"] = {world: dict(np.load(d / f"halo{world}.npz")) for world in (2, 4)}
    out["fwd"] = {k: [json.loads(p.stdout_text.strip().splitlines()[-1]) for p in procs]
                  for k, procs in fwd_procs.items()}
    out["dump"] = {k: [dict(np.load(d / f"dump_{k}" / f"rank{r}.npz")) for r in range(len(procs))]
                   for k, procs in fwd_procs.items()}
    out["int8_state"] = torch.load(d / "int8.pt")
    return out


def _sharded_output(runs, name, key):
    """The whole output of a spatial run's forward `key` (STEM/SIZE/DTYPE):
    its data shards side by side, after checking that the ranks sit on
    the mesh, hold the rows they should and that every rank of a data
    shard holds the same output."""
    n_data, n_spatial, argv = SPATIAL_RUNS[name]
    batch = int(argv[argv.index("--global-batch") + 1]) if "--global-batch" in argv else 8
    lines, dumps = runs["fwd"][name], runs["dump"][name]
    coords = [r["spatial"]["coords"] for r in lines]
    assert coords == [{"data": i // n_spatial, "spatial": i % n_spatial}
                      for i in range(n_data * n_spatial)]
    stem, size, _ = key.split("/")
    rows = int(size) // (2 if stem == "s2d-input" else 1)
    for r in lines:
        fwd = r["spatial"]["forwards"][key]
        assert fwd["rows"] == [batch // n_data, rows // n_spatial]
        assert fwd["collectives"]["spatial"]["calls"] > 0 and "data" not in fwd["collectives"]
    for i in range(n_data):
        shard = lines[i * n_spatial:(i + 1) * n_spatial]
        assert len({r["spatial"]["forwards"][key]["sha256"] for r in shard}) == 1
    return np.concatenate([dumps[i * n_spatial][f"spatial/{key}"] for i in range(n_data)])


@pytest.mark.parametrize("op,world,h", HALO_CASES)
def test_halo_exchange_matches_the_unsharded_op(runs, op, world, h):
    """(a) A 3x3 conv at stride 1 and 2 and the 5x5 max pool on each
    rank's rows with their halos: the ranks' rows side by side equal the
    op on the whole map within 1e-6 (zeros beyond the edges for the conv,
    −inf for the pool, on inputs that are mostly negative)."""
    data = runs["halo_data"][world]
    x = torch.from_numpy(data[f"x/{op}"])
    if op == "pool5":
        want = max_pool(x, 5)
    else:
        want = F.conv2d(x, torch.from_numpy(data["w"]), torch.from_numpy(data["b"]),
                        stride=int(op[-1]), padding=1)
        want = F.silu(want)
    got = np.concatenate([r[op] for r in runs["halo"][world]], 2)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got, want.numpy(), rtol=HALO_TOL, atol=HALO_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_deeper_than_a_shard(runs, world):
    """(a) A halo of 3 rows each side over ranks of 1 row (4 ranks) or 2
    rows (2 ranks): each rank's extended rows are the whole map's rows
    around its own, from as many ranks as they span, the fill beyond."""
    x = runs["halo_data"][world]["x/halo3"]
    padded = np.pad(x, ((0, 0), (0, 0), (3, 3), (0, 0)), constant_values=-7.0)
    per = x.shape[2] // world
    for r, out in enumerate(runs["halo"][world]):
        np.testing.assert_array_equal(out["halo3"], padded[:, :, r * per:r * per + per + 6])


@pytest.mark.parametrize("n_data,n_spatial", [(1, 4), (2, 2)])
def test_spatial_forward_matches_jax(runs, n_data, n_spatial):
    """(b) The tiny model's decoded (8, 336, 12) at 128 px from ranks that
    each hold H / n_spatial rows of 8 / n_data images (p5 at 1 row a rank
    over 4 ranks): the data shards side by side within 1e-5 of JAX's
    forward under make_spatial_mesh of the same shape and of its unsharded
    forward; every rank of a data shard holds the same output, and the
    spatial group's all-gathers are counted."""
    got = _sharded_output(runs, f"{n_data}x{n_spatial}", f"plain/{SIZE}/float32")
    assert got.shape == (8, 336, 4 + TINY.num_classes)
    want = runs["jax"][("plain", SIZE)]
    for ref in (want[(n_data, n_spatial)], want["unsharded"]):
        np.testing.assert_allclose(got, ref, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("run,stem,size", UNEVEN_CASES)
def test_uneven_spatial_forward_matches_jax(runs, run, stem, size):
    """(b) Heights whose p5 rows do not split over the spatial ranks (or
    leave ranks with none), and the s2d stem (fed images, or the batch
    already rearranged and split along its H / 2 rows): the ranks' output
    within 1e-5 of JAX's forward under make_spatial_mesh of the same shape
    and of its unsharded forward."""
    n_data, n_spatial, _ = SPATIAL_RUNS[run]
    got = _sharded_output(runs, run, f"{stem}/{size}/float32")
    anchors = sum((size // s) ** 2 for s in (8, 16, 32))
    assert got.shape == (8, anchors, 4 + TINY.num_classes)
    want = runs["jax"][(stem, size)]
    for ref in (want[(n_data, n_spatial)], want["unsharded"]):
        np.testing.assert_allclose(got, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_int8_spatial_forward_matches_jax_and_one_process(runs):
    """(b) JAX's int8 weights on 2 images over 2 ranks at 128 px (each conv exchanges
    its quantized input): within tests/test_torch_quant.py's tolerances of
    JAX's int8 forward under make_spatial_mesh(1, 2) and unsharded (boxes
    1e-3 px, scores 1e-5), and bit-equal to the port's one-process int8
    forward (the int32 sums are exact and every other op is elementwise
    or runs on the whole map)."""
    got = _sharded_output(runs, "int8", f"plain/{SIZE}/float32")
    want = runs["jax"]["int8"]
    for ref in (want[(1, 2)], want["unsharded"]):
        assert np.abs(got[..., :4] - ref[..., :4]).max() <= INT8_BOX_TOL
        assert np.abs(got[..., 4:] - ref[..., 4:]).max() <= INT8_SCORE_TOL
    model = YOLO.from_state_dict(TINY, runs["int8_state"])
    assert all(m.quantized for m in model.modules() if hasattr(m, "w_q"))
    with torch.inference_mode():
        one = model(torch.from_numpy(spatial_images(2, SIZE)).float() / 255).numpy()
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("height,n,blocks", [(1312, 2, (21, 20)), (96, 2, (2, 1)),
                                             (160, 2, (3, 2)), (64, 4, (1, 0, 1, 0)),
                                             (1280, 2, (20, 20)), (224, 4, (2, 2, 2, 1))])
def test_block_layout(height, n, blocks):
    """Rank i holds blocks ceil(i·B/n) to ceil((i+1)·B/n) of the B = H / 32
    blocks; a map of stride s splits at 32 / s rows a block (its width is
    the image's over s)."""
    shards = Shards.of(height, 640, n)
    assert shards.blocks == blocks and sum(blocks) == height // 32
    for s in (1, 2, 8, 32):
        assert shards.rows(640 // s) == tuple(b * 32 // s for b in blocks)


def _tiny_folded():
    return YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY)).fold_batchnorm()


def test_spatial_refusals():
    """(c) An image height that is not a multiple of 32, one that does not
    split over the ranks at all, the training forward, and a mesh
    without a spatial axis."""
    mesh = Mesh((CPU,), 2, 1, ("spatial", 2))
    model = partition_spatial(_tiny_folded(), mesh)
    with pytest.raises(ValueError, match=r"multiples of 32: this rank holds 40 of H = 80 rows"):
        model(torch.zeros(1, 40, 64, 3))
    with pytest.raises(ValueError, match="does not split over the 2 shards of the 'spatial'"):
        parallel.spatial_batch_sharding(mesh).local(np.zeros((2, 127, 64, 3), np.uint8))
    assert parallel.spatial_batch_sharding(mesh).local(
        np.arange(2 * 4).reshape(2, 4)).tolist() == [[2, 3], [6, 7]]
    with pytest.raises(ValueError, match="for inference"):
        model.train()(torch.zeros(1, 32, 64, 3))
    with pytest.raises(ValueError, match="takes a \\(data, spatial\\) mesh"):
        partition_spatial(_tiny_folded(), Mesh((CPU,), 2, 0, ("model", 2)))
