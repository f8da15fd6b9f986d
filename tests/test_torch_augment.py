"""The port's device augmentation against the JAX package's, on the CPU.

  * the six pixel programs of ops/augment_device.py against tpu_yolo's
    on the same staged sources (those of tests/test_augment_device.py)
    and parameters, at S=128: uint8 values bit-equal, rotation and
    shear included; `hsv_jitter_device` alone (compiled on its own by
    XLA, with other contractions): equal on at least 99.9%, mean |diff|
    under 0.01;
  * the host draws, the assembly of parameters and targets, and
    `_plan_batches` of data/device_augment.py under seeded and scripted
    `random.Random`s: bit-equal to tpu_yolo's;
  * `DeviceAugmentLoader` against tpu_yolo's on a tiny tree with the same
    seed (needs the native library, as the JAX loader does), and with the
    cv2 stager;
  * the cv2 staging forms against tpu_yolo's `_fb_raw` / `_fb_scaled`.
"""
import random

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_yolo.data import device_augment as jda
from tpu_yolo.data import native_loader as jax_native
from tpu_yolo.ops import augment_device as jad
from tpu_yolo_torch.data import device_augment as da
from tpu_yolo_torch.data import native_loader
from tpu_yolo_torch.ops import augment_device as ad
from tpu_yolo_torch.ops.letterbox import letterbox_batch

from test_torch_card_decode import use_jax_source_library

torch.set_num_threads(1)
S = 128
DIMS = [(128, 96), (72, 128), (128, 128), (60, 44)]
HYP = {"scale": 0.5, "translate": 0.1, "flip_ud": 0.5, "flip_lr": 0.5,
       "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "mosaic": 1.0, "mix_up": 0.0}
HYP_GENERAL = dict(HYP, degrees=10.0, shear=4.0)


def _sources(rng, dims):
    """Smooth RGB sources at the given (h, w) in (S, S) staging (the JAX
    test's `_sources`)."""
    staged = np.zeros((len(dims), S, S, 3), np.uint8)
    for i, (h, w) in enumerate(dims):
        base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3), np.uint8)
        staged[i, :h, :w] = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    return staged


def _labels(rng):
    out = []
    for _ in DIMS:
        n = int(rng.integers(1, 4))
        cx, cy = rng.uniform(0.3, 0.7, (2, n))
        bw, bh = rng.uniform(0.2, 0.5, (2, n))
        out.append(np.stack([rng.integers(0, 3, n), cx, cy, bw, bh], 1).astype(np.float32))
    return out


def _stack(dicts):
    return {k: (_stack([d[k] for d in dicts]) if isinstance(dicts[0][k], dict)
                else np.stack([np.asarray(d[k]) for d in dicts])) for k in dicts[0]}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v))
            for k, v in tree.items()}


def assert_pixels_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    assert diff.mean() < 0.01, diff.mean()


def _case(mode, general, b=3, seed=0):
    """Staged sources and stacked parameters for `b` samples of one mode,
    drawn by the JAX package's host code."""
    rng = np.random.default_rng(seed)
    staged = _sources(rng, DIMS)
    labels = _labels(rng)
    hyp = HYP_GENERAL if general else HYP
    r, nr = random.Random(seed), np.random.default_rng(seed)
    dims_of, label_of = (lambda i: DIMS[i]), (lambda i: labels[i])
    outs, srcs = [], []
    for k in range(b):
        if mode == "mosaic":
            d = jda.draw_mosaic(r, nr, k % 4, 4, hyp, S)
            outs.append(jda.assemble_mosaic(d, dims_of, label_of, S, general=general))
            srcs.append(staged[d["indices"]])
        elif mode == "mixup":
            d1, d2, alpha = jda.draw_mixup_pair(r, nr, k % 4, 4, hyp, S)
            outs.append(jda.assemble_mixup(d1, d2, alpha, dims_of, label_of, S,
                                           general=general))
            srcs.append(np.stack([staged[d1["indices"]], staged[d2["indices"]]]))
        else:
            d = jda.draw_plain(r, nr, hyp, S)
            outs.append(jda.assemble_plain(d, DIMS[k % 4], labels[k % 4], S,
                                           general=general))
            srcs.append(staged[k % 4])
    params = _stack([o[0] for o in outs])
    hw = np.asarray([DIMS[k % 4] for k in range(b)], np.float32)
    return np.stack(srcs), hw, params


PROGRAMS = {
    ("mosaic", False): ("augment_batch", False),
    ("mixup", False): ("mixup_augment_batch", False),
    ("plain", False): ("plain_augment_batch", True),
    ("mosaic", True): ("augment_batch_general", False),
    ("mixup", True): ("mixup_augment_batch_general", False),
    ("plain", True): ("plain_augment_batch_general", True),
}


def _program_pair(mode, general, seed=0):
    name, takes_hw = PROGRAMS[(mode, general)]
    srcs, hw, params = _case(mode, general, seed=seed)
    if general:
        assert "minv" in params.get("a", params)
    args_j = (jnp.asarray(srcs),) + ((jnp.asarray(hw),) if takes_hw else ())
    args_t = (torch.from_numpy(srcs),) + ((torch.from_numpy(hw),) if takes_hw else ())
    want = getattr(jad, name)(*args_j, _to_jax(params), out_size=S)
    got = getattr(ad, name)(*args_t, _to_torch(params), out_size=S)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("mode,general", list(PROGRAMS), ids=[
    PROGRAMS[k][0] for k in PROGRAMS])
def test_program_matches_jax(mode, general):
    got, want = _program_pair(mode, general)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


@pytest.mark.parametrize("seed", [1, 2, 4])
@pytest.mark.parametrize("mode", ["mosaic", "mixup", "plain"])
def test_general_program_matches_jax_on_more_draws(mode, seed):
    """The rotation/shear programs on other draws: the boundary cases
    where two roundings of a canvas coordinate straddle an integer, or
    the two contraction orders of the gather's sum round apart, are rare
    (a few pixels of 147,456 per draw), so one draw proves little."""
    got, want = _program_pair(mode, True, seed=seed)
    np.testing.assert_array_equal(got, want)


def test_general_sites_depart_when_mirrored_otherwise():
    """The plain rotation/shear program's two roundings of the canvas
    coordinates, shown to matter: on draw 0, one compose with every
    coordinate FMA-contracted (the form the mosaic programs take) gives
    pixels off from JAX's; the hue from the contracted-weights compose
    and the rest from the rounded one give none."""
    srcs, hw, params = _case("plain", True, seed=0)
    t = _to_torch(params)
    boxed, _ = letterbox_batch(torch.from_numpy(srcs), torch.from_numpy(hw),
                               out_size=S, allow_upscale=True)
    z = torch.zeros((len(boxed), 1))
    f = torch.full_like(z, float(S))
    args = (boxed[:, None], t["minv"], z, z, z, f, z, f, S)
    want = np.asarray(jad.plain_augment_batch_general(
        jnp.asarray(srcs), jnp.asarray(hw), _to_jax(params), out_size=S))
    contracted = torch.round(ad._mosaic_affine_general(*args))
    one_form = ad._finish(contracted, t).numpy()
    assert 0 < (one_form != want).sum() < 20
    rounded = torch.round(ad._mosaic_affine_general(
        *args, weights="rounded", corners="rounded"))
    hue = torch.round(ad._mosaic_affine_general(
        *args, weights="contracted", corners="rounded"))
    np.testing.assert_array_equal(ad._finish(rounded, t, hue_imgs=hue).numpy(), want)


def test_flips_and_float_flags():
    """Flips given as 0/1 floats (as the trainer ships them) equal bool
    flips, and flipping both axes equals the unflipped output mirrored."""
    srcs, _, params = _case("mosaic", False, b=2, seed=3)
    t = _to_torch(params)
    on = dict(t, flip_lr=torch.ones(2), flip_ud=torch.ones(2))
    off = dict(t, flip_lr=torch.zeros(2, dtype=torch.bool),
               flip_ud=torch.zeros(2, dtype=torch.bool))
    a = ad.augment_batch(torch.from_numpy(srcs), on, out_size=S)
    b = ad.augment_batch(torch.from_numpy(srcs), off, out_size=S)
    torch.testing.assert_close(a, b.flip(1).flip(2), rtol=0, atol=0)


def test_mosaic_quadrant_compose_matches_jax():
    """One mosaic's raw compose (before rounding, HSV and flips) against
    JAX's _mosaic_affine_one, compiled as the programs compile it: f32
    within 1e-3 (bf16 taps, f32 sums)."""
    srcs, _, params = _case("mosaic", False, b=1, seed=5)
    p = {k: v[0] for k, v in params.items()}
    want = jax.jit(jad._mosaic_affine_one, static_argnames="out_size")(
        jnp.asarray(srcs[0]), jnp.float32(p["inv_scale"]),
        *(jnp.asarray(p[k]) for k in ("off_x", "off_y", "lo_x", "hi_x", "lo_y", "hi_y")),
        out_size=S)
    t = _to_torch(params)
    got = ad._mosaic_affine(torch.from_numpy(srcs), t["inv_scale"], t["off_x"],
                            t["off_y"], t["lo_x"], t["hi_x"], t["lo_y"], t["hi_y"], S)
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(), np.asarray(want),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("gains", [[1.01, 0.8, 1.2], [0.99, 1.3, 0.7], [1.0, 1.0, 1.0]])
def test_hsv_matches_jax(gains):
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (40, 40, 3), np.uint8)
    img = cv2.resize(base, (160, 160), interpolation=cv2.INTER_LINEAR).astype(np.float32)
    img[:8] = 0            # black, grey and saturated rows: the branch edges
    img[8:16] = 128
    img[16:24, :, 0] = 255
    gains = np.float32(gains)
    want = jad.hsv_jitter_device(jnp.asarray(img), jnp.asarray(gains))
    got = ad.hsv_jitter_device(torch.from_numpy(img), torch.from_numpy(gains))
    assert_pixels_match(np.clip(got.numpy(), 0, 255).astype(np.uint8),
                        np.clip(np.asarray(want), 0, 255).astype(np.uint8))
    # batched: (B, H, W, 3) with (B, 3) gains, image by image
    two = np.stack([img, img[::-1]])
    g2 = np.stack([gains, gains[::-1]])
    got2 = ad.hsv_jitter_device(torch.from_numpy(two), torch.from_numpy(g2))
    for i in range(2):
        torch.testing.assert_close(got2[i], ad.hsv_jitter_device(
            torch.from_numpy(two[i]), torch.from_numpy(g2[i])), rtol=0, atol=0)


# -- host draws and assembly: bit-equal ---------------------------------------

def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


class ScriptedRandom(random.Random):
    """Replays a script: uniform/random pop from a list; choices and
    shuffle fixed (the JAX test's scripted RNG)."""

    def __init__(self, uniforms, choices_out):
        super().__init__(0)
        self._u = list(uniforms)
        self._c = list(choices_out)

    def uniform(self, a, b):
        return a + (b - a) * self._u.pop(0)

    def random(self):
        return self._u.pop(0)

    def choices(self, population, k=1):
        return self._c[:k]

    def shuffle(self, x):
        pass


def _draws(mod, seed, general, labels):
    """Every draw and assembly of one module's host code, in one stream."""
    dims_of, label_of = (lambda i: DIMS[i]), (lambda i: labels[i])
    hyp = HYP_GENERAL if general else HYP
    r, nr = random.Random(seed), np.random.default_rng(seed)
    d = mod.draw_mosaic(r, nr, seed % 4, 4, hyp, S)
    out = [d, mod.assemble_mosaic(d, dims_of, label_of, S, general=general),
           mod.assemble_mosaic(d, dims_of, label_of, S, failed=frozenset({1}),
                               general=general)]
    m1, m2, alpha = mod.draw_mixup_pair(r, nr, seed % 4, 4, hyp, S)
    out += [m1, m2, alpha, mod.assemble_mixup(m1, m2, alpha, dims_of, label_of, S,
                                              failed2=frozenset({0, 3}),
                                              general=general)]
    p = mod.draw_plain(r, nr, hyp, S)
    out += [p, mod.assemble_plain(p, DIMS[seed], labels[seed], S, general=general),
            mod.assemble_plain(p, DIMS[seed], labels[seed], S, failed=True,
                               general=general),
            mod.sample_mosaic(r, nr, 1, 4, dims_of, label_of, S, hyp),
            r.random(), nr.random()]
    return out


@pytest.mark.parametrize("general", [False, True])
def test_draws_and_assembly_bit_equal(general):
    labels = _labels(np.random.default_rng(7))
    for seed in range(4):
        _assert_same(_draws(jda, seed, general, labels),
                     _draws(da, seed, general, labels))


def test_scripted_sample_mosaic_bit_equal():
    labels = _labels(np.random.default_rng(8))
    u = [0.42, 0.61, 0.37, 0.52, 0.48, 0.1, 0.9]   # xc, yc, s, tx, ty, flips
    outs = [mod.sample_mosaic(ScriptedRandom(u, [1, 2, 3]), np.random.default_rng(3),
                              0, 4, lambda i: DIMS[i], lambda i: labels[i], S, HYP)
            for mod in (jda, da)]
    assert outs[0][0] == [0, 1, 2, 3]
    _assert_same(outs[0], outs[1])
    box = outs[1][3]
    assert len(box) and (box >= 0).all() and (box <= 1).all()


@pytest.mark.parametrize("mosaic_on", [True, False])
def test_plan_batches_bit_equal(mosaic_on):
    def stub(cls):
        class Stub(cls):
            def __init__(self):
                self.filenames = ["x"] * 67
                self.batch_size = 4
                self.hyp = {"mosaic": 0.6, "mix_up": 0.4}
                self.mosaic = mosaic_on
                self.num_shards, self.shard, self.seed = 1, 0, 0
        return Stub()

    plans = [stub(cls)._plan_batches(list(range(67)), random.Random(5))
             for cls in (jda.DeviceAugmentLoader, da.DeviceAugmentLoader)]
    assert plans[0] == plans[1] and len(plans[1]) == 16
    modes = {m for m, _ in plans[1]}
    assert modes == ({"mosaic", "mixup", "plain"} if mosaic_on else {"plain"})


# -- the loader -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """12 JPEGs of mixed sizes (one longer than S, one with a long side of
    exactly S) with one label each, in the COCO layout."""
    root = tmp_path_factory.mktemp("device_augment_tree")
    img_dir, lbl_dir = root / "images" / "train", root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    rng = np.random.default_rng(31)
    files = []
    for i in range(12):
        h, w = [(70, 90), (100, 140), (128, 96), (200, 150), (60, 44), (90, 70)][i % 6]
        base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3), np.uint8)
        p = str(img_dir / f"im{i}.jpg")
        cv2.imwrite(p, cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC))
        (lbl_dir / f"im{i}.txt").write_text(f"{i % 3} 0.5 0.5 0.4 0.3\n")
        files.append(p)
    return files


def _needs_native():
    if not jax_native.available() or not native_loader.available():
        pytest.skip("native loader not built")


HYPS = {
    "mosaic": dict(HYP, mosaic=1.0, mix_up=0.0),
    "mixed": dict(HYP, mosaic=0.6, mix_up=0.5),
    "plain": dict(HYP, mosaic=0.0),
    "general": dict(HYP_GENERAL, mosaic=0.6, mix_up=0.5),
}


@pytest.mark.parametrize("case", list(HYPS))
def test_loader_matches_jax(tree, case, tmp_path, monkeypatch):
    """The port's loader against tpu_yolo's, the JAX side on its own C++
    source built as the port builds its copy (no -march: the Makefile's
    -march=native lets g++ fuse the float resampler's sums, one level
    off on a few values, tests/test_torch_card_decode.py)."""
    _needs_native()
    use_jax_source_library(monkeypatch)
    hyp = HYPS[case]
    kw = dict(batch_size=2, threads=2, seed=3)
    want = list(jda.DeviceAugmentLoader(tree, S, hyp, cache_path=str(tmp_path / "j"), **kw))
    loader = da.DeviceAugmentLoader(tree, S, hyp, cache_path=str(tmp_path / "t"), **kw)
    assert loader.stager == "native"
    got = list(loader)
    assert len(got) == len(want) == len(loader) == 6
    modes = set()
    for g, w in zip(got, want):
        assert len(g) == len(w)
        modes.add("plain" if len(g) == 4 else f"ndim{g[0].dim()}")
        np.testing.assert_array_equal(g[0].numpy(), w[0])
        if len(g) == 4:
            np.testing.assert_array_equal(g[1].numpy(), w[1])
        _assert_same(g[-2], w[-2])      # params
        _assert_same(g[-1], w[-1])      # targets
    if case == "mixed":
        assert modes == {"plain", "ndim5", "ndim6"}, modes
    if case == "general":
        assert all("minv" in b[-2].get("a", b[-2]) for b in got)


def test_loader_with_the_cv2_stager(tree, tmp_path, monkeypatch):
    """Without the native library the loader stages through cv2: the same
    params and targets as with it (they follow the header scan), pixels
    within the two resamplers' distance, and batches that the programs
    take."""
    hyp = HYPS["mixed"]
    kw = dict(batch_size=2, threads=2, seed=4, interp="bilinear")
    ref = (list(da.DeviceAugmentLoader(tree, S, hyp, cache_path=str(tmp_path / "n"), **kw))
           if native_loader.available() else None)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    loader = da.DeviceAugmentLoader(tree, S, hyp, cache_path=str(tmp_path / "c"), **kw)
    assert loader.stager == "cv2"
    got = list(loader)
    assert len(got) == 6
    for k, batch in enumerate(got):
        params = _to_torch(batch[-2])
        if len(batch) == 4:
            out = ad.plain_augment_batch(batch[0], batch[1], params, out_size=S)
        elif batch[0].dim() == 6:
            out = ad.mixup_augment_batch(batch[0], params, out_size=S)
        else:
            out = ad.augment_batch(batch[0], params, out_size=S)
        assert out.shape == (2, S, S, 3) and (out > 0).any()
        if ref is not None:
            _assert_same(batch[-2], ref[k][-2])
            _assert_same(batch[-1], ref[k][-1])
            diff = np.abs(batch[0].numpy().astype(int) - ref[k][0].numpy())
            assert diff.mean() < 1.5, diff.mean()


def test_cv2_stager_matches_jax_fill_functions(tree):
    """Cv2Pipeline places every image as the JAX package's cv2 forms do,
    bit for bit; a file cv2 cannot read is a failed, zeroed slot."""
    paths = tree[:6] + [tree[0] + ".missing"]
    pipe = native_loader.Cv2Pipeline(threads=3)
    interps = [3, 2, 1, 0, 4, 1, 2]
    for stage, call, fill in (
            (100, pipe.load_batch_raw, jax_native.NativePipeline._fb_raw(None, 100)),
            (S, lambda p, s, out: pipe.load_batch_scaled(p, s, interps, out=out),
             jax_native.NativePipeline._fb_scaled(None, S, interps=interps)),
            (S, pipe.load_batch_scaled, jax_native.NativePipeline._fb_scaled(None, S))):
        out = np.full((len(paths), stage, stage, 3), 7, np.uint8)
        got, dims, nfail = call(paths, stage, out=out)
        assert got is out
        want = np.zeros_like(got)
        want_dims = np.zeros((len(paths), 4), np.float32)
        for i, p in enumerate(paths[:-1]):
            fill(cv2.imread(p), want[i], want_dims[i], i)
        want_dims[-1] = (-1, 0, 0, 0)
        assert nfail == 1
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(dims, want_dims)


def test_staging_buffer_is_checked(tree):
    pipe = native_loader.Cv2Pipeline(threads=1)
    with pytest.raises(ValueError, match="staging buffer"):
        pipe.load_batch_raw(tree[:2], 64, out=np.zeros((2, 64, 32, 3), np.uint8))
