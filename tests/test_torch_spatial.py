"""The port's height-sharded forward (parallel/spatial.py) across gloo
processes on the CPU: the halo exchange of a conv and a max pool against
the unsharded op, and YOLO's forward on a tiny model at 128 px over
(data 1, spatial 4) and (data 2, spatial 2) meshes, through `python -m
tpu_yolo_torch.rehearsal --n-spatial N` workers, against the JAX
package's forward under `make_spatial_mesh` (GSPMD's halo exchange) and
its unsharded forward; and the refusals. Every worker process is
started at once from one fixture; the workers import torch and the port
only."""
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
from tpu_yolo_torch import parallel
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.nn import max_pool
from tpu_yolo_torch.parallel.mesh import Mesh
from tpu_yolo_torch.parallel.spatial import partition_spatial
from tpu_yolo_torch.rehearsal import TINY, spatial_images

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The halo workers over 2 and 4 ranks, and the rehearsal's spatial
    forward over (1, 4) and (2, 2) meshes, started together; JAX's
    forwards run meanwhile. Returns the halo outputs per world (each
    rank's rows, in rank order), the spatial forward's JSON lines and
    dumps per mesh, and JAX's outputs."""
    d = tmp_path_factory.mktemp("spatial")
    halo_procs = {}
    for world in (2, 4):
        np.savez(d / f"halo{world}.npz", **_halo_data(world))
        halo_procs[world] = [_popen([sys.executable, "-c", _HALO, str(r), str(world),
                                     str(d / f"init{world}"), str(d / f"halo{world}.npz"),
                                     str(d / f"halo{world}_{r}.npz")]) for r in range(world)]
    fwd_procs = {}
    for n_data, n_spatial in ((1, 4), (2, 2)):
        key = (n_data, n_spatial)
        fwd_procs[key] = [_popen(
            [sys.executable, "-m", "tpu_yolo_torch.rehearsal", "--device", "cpu",
             "--num-processes", "4", "--process-id", str(r), "--init-method",
             f"file://{d / f'fwd{n_data}{n_spatial}'}", "--steps", "0",
             "--n-spatial", str(n_spatial), "--spatial-size", str(SIZE),
             "--dump", str(d / f"dump{n_data}{n_spatial}")]) for r in range(4)]
    out = {"jax": {}}
    try:
        params = jax_yolo.fold_batchnorm(init_params(0, TINY))
        x = jnp.asarray(spatial_images(8, SIZE).astype(np.float32) / 255)
        fwd = jax.jit(lambda p, v: jax_yolo.forward(p, v, JTINY, train=False))
        out["jax"]["unsharded"] = np.asarray(fwd(params, x))
        for n_data, n_spatial in ((1, 4), (2, 2)):
            mesh = jax_make_spatial_mesh(n_data=n_data, n_spatial=n_spatial)
            assert dict(mesh.shape) == {"data": n_data, "spatial": n_spatial}
            xs = jax.device_put(x, jax_spatial_batch_sharding(mesh))
            ps = jax.device_put(params, NamedSharding(mesh, PartitionSpec()))
            out["jax"][(n_data, n_spatial)] = np.asarray(fwd(ps, xs))
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
    out["dump"] = {k: [dict(np.load(d / f"dump{k[0]}{k[1]}" / f"rank{r}.npz"))
                       for r in range(4)] for k in fwd_procs}
    return out


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
    lines, dumps = runs["fwd"][(n_data, n_spatial)], runs["dump"][(n_data, n_spatial)]
    coords = [r["spatial"]["coords"] for r in lines]
    assert coords == [{"data": i // n_spatial, "spatial": i % n_spatial} for i in range(4)]
    for r in lines:
        assert r["spatial"]["rows"] == [8 // n_data, SIZE // n_spatial]
        collectives = r["spatial"]["forwards"]["float32"]["collectives"]
        assert collectives["spatial"]["calls"] > 0 and "data" not in collectives
    for i in range(n_data):
        shard = lines[i * n_spatial:(i + 1) * n_spatial]
        assert len({r["spatial"]["forwards"]["float32"]["sha256"] for r in shard}) == 1
    got = np.concatenate([dumps[i * n_spatial]["spatial/float32"] for i in range(n_data)])
    assert got.shape == (8, 336, 4 + TINY.num_classes)
    for want in (runs["jax"][(n_data, n_spatial)], runs["jax"]["unsharded"]):
        np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def _tiny_folded():
    return YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY)).fold_batchnorm()


def test_spatial_refusals():
    """(c) An image height that is not a multiple of 32·n_spatial (the
    p5 map's rows must split evenly), one that does not split over the
    ranks at all, the training forward, the space-to-depth stem and int8."""
    mesh = Mesh((CPU,), 2, 1, ("spatial", 2))
    model = partition_spatial(_tiny_folded(), mesh)
    with pytest.raises(ValueError, match=r"multiple of 32·2 = 64: this rank holds 48 rows"):
        model(torch.zeros(1, 48, 64, 3))
    with pytest.raises(ValueError, match="does not split over the 2 shards of the 'spatial'"):
        parallel.spatial_batch_sharding(mesh).local(np.zeros((2, 127, 64, 3), np.uint8))
    assert parallel.spatial_batch_sharding(mesh).local(
        np.arange(2 * 4).reshape(2, 4)).tolist() == [[2, 3], [6, 7]]
    with pytest.raises(ValueError, match="for inference"):
        model.train()(torch.zeros(1, 32, 64, 3))
    s2d = partition_spatial(_tiny_folded().fold_stem_space_to_depth(), mesh)
    with pytest.raises(ValueError, match="plain stem"):
        s2d(torch.zeros(1, 32, 64, 3))
    int8 = _tiny_folded()
    int8.net["p2"][0].quantize_(0.1)
    with pytest.raises(ValueError, match="float convs, not int8"):
        partition_spatial(int8, mesh)
    with pytest.raises(ValueError, match="takes a \\(data, spatial\\) mesh"):
        partition_spatial(_tiny_folded(), Mesh((CPU,), 2, 0, ("model", 2)))
