"""The port's own data path on the CPU: its copy of the host C++
pipeline (csrc/image_pipeline.cc), the plain versions of the card's
kernels (ops/image_cuda.py), `CardPipeline`'s fallback for files nvJPEG
does not read, and the choice of pipeline by device and flag.

  * The port's copy against the JAX package's pipeline on the same
    files, all five calls and all five interpolations: bit-equal where
    the JAX side runs its own source built as the port builds its copy
    (no -march, no FMA contraction). The JAX library built by its
    Makefile (-march=native) fuses products into sums on a host with
    FMA; against it the bilinear and nearest paths are bit-equal and the
    float resampler (cubic, area, lanczos4) is off by one level on a
    few values, which its source rebuilt with the Makefile's flags
    reproduces.
  * The plain colour conversion (`ycc_to_rgb_plain`: libjpeg's fancy
    upsampling and YCbCr -> RGB, which the card runs over nvJPEG's planar
    output) over libjpeg's own planar YCbCr equals libjpeg's and cv2's
    RGB decode bit for bit, at 4:4:4, 4:2:2 and 4:2:0, odd sizes and
    chroma two samples wide included.
  * The card's decode with libjpeg's IDCT in nvJPEG's place (libjpeg's
    planes, then the plain colour conversion) and the plain placement
    bit-equal to tpu_yolo's `native_loader` output for all five calls
    and interpolations.
  * `CardPipeline`'s fallback: a PNG through cv2 and the fill function,
    counted, and an unreadable file zeroed, as NativePipeline's.
  * The loader selection: auto/on/off on the CPU, and on a CUDA device
    that cannot build the card library (no nvcc) `on` and `auto` raise
    rather than take cv2.
"""
import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import tempfile

import cv2
import numpy as np
import pytest
import torch

from tpu_yolo.data import native_loader as jax_native
from tpu_yolo_torch.data import native_loader
from tpu_yolo_torch.ops import cuda_build
from tpu_yolo_torch.ops import image_cuda as ic

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_SOURCE = ROOT / "native" / "image_pipeline.cc"
MAKEFILE_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native")
SIZES = [(480, 640), (640, 480), (300, 200), (37, 250), (160, 160), (133, 217),
         (90, 91), (250, 37)]
STAGES = (160, 96)
INTERPS = (ic.NEAREST, ic.LINEAR, ic.CUBIC, ic.AREA, ic.LANCZOS4)


# libjpeg's planar decode (raw_data_out: the IDCT's output at the JPEG's
# own subsampling, before any upsampling), for the oracle of the colour
# conversion; compiled once per test run
PLANES_SOURCE = r"""
#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <jpeglib.h>

struct err { struct jpeg_error_mgr mgr; jmp_buf jb; };
static void on_error(j_common_ptr c) { longjmp(((struct err*)c->err)->jb, 1); }

/* info = [w, h, cw, ch, hs, vs]; with y non-null the planes Y (h, w) and
   Cb, Cr (ch, cw) of a 3-component JPEG (JDCT_ISLOW). -1 on failure. */
int jp_planes(const uint8_t* data, long len, int* info, uint8_t* y,
              uint8_t* cb, uint8_t* cr) {
  static uint8_t buf[3][32][4096];
  struct jpeg_decompress_struct c;
  struct err e;
  c.err = jpeg_std_error(&e.mgr);
  e.mgr.error_exit = on_error;
  if (setjmp(e.jb)) { jpeg_destroy_decompress(&c); return -1; }
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, (unsigned char*)data, (unsigned long)len);
  jpeg_read_header(&c, TRUE);
  if (c.num_components != 3 || c.image_width > 4096) {
    jpeg_destroy_decompress(&c);
    return -1;
  }
  c.raw_data_out = TRUE;
  c.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&c);
  jpeg_component_info* k = c.comp_info;
  info[0] = c.output_width;
  info[1] = c.output_height;
  info[2] = k[1].downsampled_width;
  info[3] = k[1].downsampled_height;
  info[4] = c.max_h_samp_factor / k[1].h_samp_factor;
  info[5] = c.max_v_samp_factor / k[1].v_samp_factor;
  if (y) {
    uint8_t* dst[3] = {y, cb, cr};
    JSAMPROW rows[3][32];
    JSAMPARRAY arr[3];
    for (int ci = 0; ci < 3; ci++) {
      for (int r = 0; r < 32; r++) rows[ci][r] = buf[ci][r];
      arr[ci] = rows[ci];
    }
    for (int base = 0; c.output_scanline < c.output_height; base++) {
      jpeg_read_raw_data(&c, arr, c.max_v_samp_factor * DCTSIZE);
      for (int ci = 0; ci < 3; ci++) {
        int n = k[ci].v_samp_factor * DCTSIZE;
        for (int r = 0; r < n; r++) {
          int row = base * n + r;
          if (row < (int)k[ci].downsampled_height)
            memcpy(dst[ci] + (size_t)row * k[ci].downsampled_width, buf[ci][r],
                   k[ci].downsampled_width);
        }
      }
    }
    jpeg_finish_decompress(&c);
  }
  jpeg_destroy_decompress(&c);
  return 0;
}
"""


@functools.lru_cache(maxsize=None)
def _planes_library():
    if shutil.which("gcc") is None:
        pytest.skip("no gcc here")
    root = tempfile.mkdtemp(prefix="jpeg_planes_")
    src, out = os.path.join(root, "planes.c"), os.path.join(root, "libplanes.so")
    pathlib.Path(src).write_text(PLANES_SOURCE)
    built = subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", out, src, "-ljpeg"],
                           capture_output=True, text=True)
    if built.returncode:
        pytest.skip(f"libjpeg's headers or library are missing: {built.stderr[-300:]}")
    lib = ctypes.CDLL(out)
    lib.jp_planes.argtypes = [ctypes.c_char_p, ctypes.c_long] + [ctypes.c_void_p] * 4
    return lib


def libjpeg_planes(path):
    """libjpeg's planar YCbCr of a colour JPEG: (Y, Cb, Cr) uint8 tensors
    and the chroma subsampling (hs, vs)."""
    lib = _planes_library()
    data = open(path, "rb").read()
    info = (ctypes.c_int * 6)()
    assert lib.jp_planes(data, len(data), info, None, None, None) == 0
    w, h, cw, ch, hs, vs = info
    y, cb, cr = (np.empty(shape, np.uint8) for shape in ((h, w), (ch, cw), (ch, cw)))
    assert lib.jp_planes(data, len(data), info, y.ctypes.data, cb.ctypes.data,
                         cr.ctypes.data) == 0
    return tuple(torch.from_numpy(a) for a in (y, cb, cr)), (hs, vs)


def _need_host():
    if not native_loader.available() or not jax_native.available():
        pytest.skip("the host data libraries cannot be built here")


@functools.lru_cache(maxsize=None)
def jax_source_library(flags=cuda_build.HOST_FLAGS) -> str:
    """The JAX package's native/image_pipeline.cc compiled with `flags`
    (by default the port's host flags: no -march, no FMA contraction)
    into a temporary directory; its path."""
    out = os.path.join(tempfile.mkdtemp(prefix="jax_source_"), "libjaxsource.so")
    subprocess.run(["g++", *flags, "-shared", "-o", out, str(JAX_SOURCE),
                    "-ljpeg", "-lpthread"], check=True, capture_output=True)
    return out


def use_jax_source_library(monkeypatch, flags=cuda_build.HOST_FLAGS):
    """Point tpu_yolo's native loader at its own source built with `flags`
    (the port's by default), for as long as the test runs."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    monkeypatch.setattr(jax_native, "_SO_PATH", jax_source_library(flags))
    monkeypatch.setattr(jax_native, "_lib", None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded JPEGs of mixed sizes: smooth scenes and noise, 4:2:0."""
    root = tmp_path_factory.mktemp("card_decode")
    rng = np.random.default_rng(11)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        if i % 2 == 0:
            img = cv2.GaussianBlur(img, (0, 0), 3)
        paths.append(str(root / f"im{i}.jpg"))
        cv2.imwrite(paths[-1], img)
    return paths


def _calls(pipe, paths, stage):
    """The five calls of a pipeline with numpy batches: name -> (batch,
    rows, n_failures); load_one's row is its meta in load_batch's order."""
    def host(r):
        return (np.asarray(r[0].cpu() if isinstance(r[0], torch.Tensor) else r[0]),
                np.asarray(r[1]), r[2])

    one, meta = pipe.load_one(open(paths[0], "rb").read())
    out = {"load_one": (np.asarray(one.cpu() if isinstance(one, torch.Tensor) else one),
                        np.array([meta[k] for k in ("ratio", "pad_w", "pad_h",
                                                    "orig_w", "orig_h")], np.float32), 0),
           "load_batch": host(pipe.load_batch(paths)),
           "load_batch_eval": host(pipe.load_batch_eval(paths, stage)),
           "load_batch_raw": host(pipe.load_batch_raw(paths, stage))}
    for code in INTERPS:
        for bgr in (False, True):
            out[f"scaled_{code}_{int(bgr)}"] = host(pipe.load_batch_scaled(
                paths, stage, interps=[code] * len(paths), bgr=bgr))
    out["scaled_default"] = host(pipe.load_batch_scaled(paths, stage))
    return out


def _diff(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


@pytest.mark.parametrize("stage", STAGES)
def test_port_copy_equals_jax_source_built_alike(files, stage, monkeypatch):
    """The port's copy and JAX's source built with the same flags: every
    call and interpolation bit-equal, dims and metas equal."""
    _need_host()
    use_jax_source_library(monkeypatch)
    ours = _calls(native_loader.NativePipeline(stage, threads=2), files, stage)
    theirs = _calls(jax_native.NativePipeline(stage, threads=2), files, stage)
    for key in ours:
        for a, b in zip(ours[key], theirs[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_jax_makefile_build_against_the_port_copy(files, monkeypatch):
    """JAX's library as its Makefile builds it (-march=native) against the
    port's copy: bilinear and nearest bit-equal; the float resampler off
    by at most one level, on at most 1e-4 of the values; and JAX's source
    rebuilt with the Makefile's flags gives the library's values bit for
    bit, so the gap is the build's, not the source's."""
    _need_host()
    stage = STAGES[0]
    shipped = _calls(jax_native.NativePipeline(stage, threads=2), files, stage)
    ours = _calls(native_loader.NativePipeline(stage, threads=2), files, stage)
    for key in ours:
        d = _diff(ours[key][0], shipped[key][0])
        np.testing.assert_array_equal(ours[key][1], shipped[key][1], err_msg=key)
        if any(key.startswith(f"scaled_{c}_") for c in (ic.CUBIC, ic.AREA, ic.LANCZOS4)):
            assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (key, d.max(), (d > 0).mean())
        else:
            assert d.max() == 0, key
    use_jax_source_library(monkeypatch, MAKEFILE_FLAGS)
    rebuilt = _calls(jax_native.NativePipeline(stage, threads=2), files, stage)
    for key in shipped:
        np.testing.assert_array_equal(rebuilt[key][0], shipped[key][0], err_msg=key)


def _card_decode_plain(path, bgr=False):
    """The card's decode of `path` with libjpeg's IDCT in nvJPEG's place:
    libjpeg's planes, then the plain colour conversion."""
    planes, (hs, vs) = libjpeg_planes(path)
    return ic.ycc_to_rgb_plain(*planes, hs, vs, bgr)


def _plain_batch(paths, mode, size, interps=None, bgr=False, allow_upscale=False):
    """The plain placement of (a)-(c) over decoded pixels: (batch, rows)."""
    out = torch.empty((len(paths), size, size, 3), dtype=torch.uint8)
    rows = [ic.place_image(_card_decode_plain(p, bgr), out[i], mode,
                           size, ic.LINEAR if interps is None else interps[i],
                           allow_upscale)
            for i, p in enumerate(paths)]
    return out.numpy(), np.stack(rows)


CALLS = (["load_batch", "load_batch_eval", "load_batch_raw"]
         + [f"scaled_{c}_{b}" for c in INTERPS for b in (0, 1)])


@pytest.mark.parametrize("call", CALLS)
def test_plain_placement_equals_jax_native_loader(files, call, monkeypatch):
    """The plain versions of the card's kernels, fed libjpeg's planes,
    give tpu_yolo's native_loader batches and rows bit for bit (JAX's
    source built with the port's flags)."""
    _need_host()
    use_jax_source_library(monkeypatch)
    stage = STAGES[0]
    theirs = jax_native.NativePipeline(stage, threads=2)
    if call == "load_batch":
        got = _plain_batch(files, "letterbox", stage)
        want = theirs.load_batch(files)
    elif call == "load_batch_eval":
        got = _plain_batch(files, ic.EVAL, stage)
        want = theirs.load_batch_eval(files, stage)
    elif call == "load_batch_raw":
        got = _plain_batch(files, ic.RAW, stage)
        want = theirs.load_batch_raw(files, stage)
    else:
        code, bgr = (int(v) for v in call.split("_")[1:])
        interps = [code] * len(files)
        got = _plain_batch(files, ic.SCALED, stage, interps, bool(bgr))
        want = theirs.load_batch_scaled(files, stage, bgr=bool(bgr), interps=interps)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_plain_load_one_equals_jax(files, monkeypatch):
    """load_one's serving letterbox (allow_upscale) by the plain placement
    against tpu_yolo's."""
    _need_host()
    use_jax_source_library(monkeypatch)
    for size in (160, 800):
        theirs = jax_native.NativePipeline(size, threads=1, allow_upscale=True)
        for p in files[:4]:
            want, meta = theirs.load_one(open(p, "rb").read())
            got, row = _plain_batch([p], "letterbox", size, allow_upscale=True)
            np.testing.assert_array_equal(got[0], want)
            assert tuple(row[0]) == tuple(np.float32(meta[k]) for k in (
                "ratio", "pad_w", "pad_h", "orig_w", "orig_h"))


def _card_pipeline_on(device):
    """A CardPipeline's state without its decoders: its fallback and its
    batch checks run on the host."""
    card = object.__new__(native_loader.CardPipeline)
    card.device, card.fallbacks = torch.device(device), 0
    return card


def test_card_pipeline_undecodable_files(files, tmp_path):
    """The files nvJPEG does not read: a PNG goes through cv2 and the fill
    function, counted; a file no decoder reads is zeroed with -1, a
    missing one too; all as NativePipeline's, and into the given batch."""
    _need_host()
    png = str(tmp_path / "x.png")
    cv2.imwrite(png, np.random.default_rng(3).integers(0, 256, (70, 90, 3), np.uint8))
    junk = str(tmp_path / "junk.jpg")
    pathlib.Path(junk).write_bytes(b"\xff\xd8 not a jpeg")
    paths = [png, junk, str(tmp_path / "missing.jpg")]
    card = _card_pipeline_on("cpu")
    native = native_loader.NativePipeline(96, threads=2)
    fills = {"load_batch_raw": native_loader.fb_raw(96),
             "load_batch_eval": native_loader.fb_eval(96),
             "load_batch_scaled": native_loader.fb_scaled(96, None, False),
             "load_batch": native_loader.fb_letterbox(96, False)}
    for call, fill in fills.items():
        out = torch.full((len(paths), 96, 96, 3), 9, dtype=torch.uint8)
        rows = np.zeros((len(paths), 5 if call == "load_batch" else 4), np.float32)
        nfail = card._fallback(paths, [0, 1, 2], out, rows, fill)
        want, wrows, wfail = (getattr(native, call)(paths) if call == "load_batch"
                              else getattr(native, call)(paths, 96))
        assert nfail == wfail == 2
        np.testing.assert_array_equal(out.numpy(), want)
        # a failed slot's row beyond its -1 is unspecified
        np.testing.assert_array_equal(rows[0], wrows[0])
        assert (rows[1:, 0] == -1).all() and (wrows[1:, 0] == -1).all()
    assert card.fallbacks == len(fills)


def test_card_pipeline_checks_its_batch():
    card = _card_pipeline_on("cpu")
    assert card._out(None, 2, 64).shape == (2, 64, 64, 3)
    for bad in (np.zeros((2, 64, 64, 3), np.uint8),
                torch.zeros((2, 64, 64, 3), dtype=torch.float32),
                torch.zeros((3, 64, 64, 3), dtype=torch.uint8),
                torch.zeros((2, 64, 64, 4), dtype=torch.uint8),
                torch.zeros((2, 64, 3, 64), dtype=torch.uint8).transpose(2, 3)):
        with pytest.raises(ValueError, match="contiguous"):
            card._out(bad, 2, 64)
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA device"):
            native_loader.CardPipeline(64, device=device)


# -- the colour conversion ---------------------------------------------------------

SUBSAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize("sampling", SUBSAMPLINGS)
@pytest.mark.parametrize("h,w", [(48, 64), (37, 250), (90, 91), (17, 3), (3, 5)])
def test_ycc_plain_equals_libjpeg(sampling, h, w, tmp_path):
    """ycc_to_rgb_plain over libjpeg's planes is libjpeg's RGB decode (and
    cv2's, which is libjpeg's here), for noise and smooth images, in RGB
    and BGR; and its subsampling is the JPEG's."""
    rng = np.random.default_rng(h * 1000 + w)
    for k, img in enumerate((rng.integers(0, 256, (h, w, 3), np.uint8),
                             cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                                              (0, 0), 2))):
        path = str(tmp_path / f"{sampling}_{k}.jpg")
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SUBSAMPLINGS[sampling]])
        planes, (hs, vs) = libjpeg_planes(path)
        assert (hs, vs) == {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[sampling]
        want = cv2.imread(path)
        np.testing.assert_array_equal(ic.ycc_to_rgb_plain(*planes, hs, vs, True).numpy(),
                                      want)
        np.testing.assert_array_equal(ic.ycc_to_rgb_plain(*planes, hs, vs).numpy(),
                                      want[:, :, ::-1])


def test_ycc_plain_is_not_replication(tmp_path):
    """A control: the same planes upsampled by replication (what nvJPEG's
    own RGB output does) miss libjpeg's decode by levels, not by none."""
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.integers(0, 256, (96, 128, 3), np.uint8), (0, 0), 2)
    path = str(tmp_path / "smooth.jpg")
    cv2.imwrite(path, img)
    (y, cb, cr), (hs, vs) = libjpeg_planes(path)
    assert (hs, vs) == (2, 2)
    rep = [c.repeat_interleave(2, 0).repeat_interleave(2, 1)[:96, :128].contiguous()
           for c in (cb, cr)]
    boxed = ic.ycc_to_rgb_plain(y, *rep, 1, 1).numpy().astype(int)
    want = cv2.imread(path)[:, :, ::-1].astype(int)
    assert np.abs(boxed - want).mean() > 0.5
    assert np.array_equal(ic.ycc_to_rgb_plain(y, cb, cr, hs, vs).numpy(), want)


# -- the wrappers on the CPU ------------------------------------------------------

def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(0, 256, (37, 53, 3), np.uint8))
    before = (ic.ycc_to_rgb.launches, ic.resize_bilinear.launches,
              ic.resize_generic.launches, ic.place.launches)
    y = torch.from_numpy(rng.integers(0, 256, (37, 53), np.uint8))
    cb, cr = (torch.from_numpy(rng.integers(0, 256, (19, 27), np.uint8)) for _ in "ab")
    rgb = torch.empty((37, 53, 3), dtype=torch.uint8)
    assert ic.ycc_to_rgb(y, cb, cr, rgb, 2, 2) is rgb
    assert torch.equal(rgb, ic.ycc_to_rgb_plain(y, cb, cr, 2, 2))
    out = torch.full((64, 64, 3), 5, dtype=torch.uint8)
    ic.resize_bilinear(src, out, 20, 30, 4, 6)
    assert torch.equal(out[4:24, 6:36], ic.resize_bilinear_plain(src, 20, 30))
    ic.resize_generic(src, out, 50, 60, ic.CUBIC, 1, 2)
    assert torch.equal(out[1:51, 2:62], ic.resize_generic_plain(src, 50, 60, ic.CUBIC))
    ic.place(out, 1, 2, 50, 60)
    assert not out[:1].any() and not out[51:].any() and not out[:, :2].any()
    assert not out[:, 62:].any() and torch.equal(
        out[1:51, 2:62], ic.resize_generic_plain(src, 50, 60, ic.CUBIC))
    ic.place(out, 0, 0, 37, 53, src)
    assert torch.equal(out[:37, :53], src) and not out[37:].any()
    assert (ic.ycc_to_rgb.launches, ic.resize_bilinear.launches,
            ic.resize_generic.launches, ic.place.launches) == before
    # counted only where a kernel runs


@pytest.mark.parametrize("call", [
    lambda s, o: ic.resize_bilinear(s, o, 70, 10),            # does not fit
    lambda s, o: ic.resize_bilinear(s.float(), o, 10, 10),    # dtype
    lambda s, o: ic.resize_bilinear(s[:, :, :2].contiguous(), o, 10, 10),
    lambda s, o: ic.resize_generic(s, o, 10, 10, ic.LINEAR),   # bilinear's
    lambda s, o: ic.resize_generic(s, o, 60, 60, ic.AREA),     # area enlarging
    lambda s, o: ic.place(o, 60, 0, 10, 10),
    lambda s, o: ic.place(o, 0, 0, 10, 10, s),                # source size
    lambda s, o: ic.ycc_to_rgb(s[:, :, 0].contiguous(), *[s[:10, :15, 0].contiguous()] * 2,
                               o[:20, :30].contiguous(), 2, 1),   # chroma rows
    lambda s, o: ic.ycc_to_rgb(s[:, :, 0].contiguous(), *[s[:10, :15, 0].contiguous()] * 2,
                               o[:20, :30].contiguous(), 1, 2)])  # no 4:4:0
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    src = torch.zeros((20, 30, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        call(src, torch.zeros((64, 64, 3), dtype=torch.uint8))


@pytest.mark.parametrize("interp", [ic.NEAREST, ic.CUBIC, ic.AREA, ic.LANCZOS4,
                                    ic.LINEAR])
@pytest.mark.parametrize("src,dst", [(640, 160), (97, 300), (300, 97), (5, 5)])
def test_make_taps(interp, src, dst):
    """Taps in range of the clamp, weights summing to one (nearest: one
    tap of weight one) as the C++'s do."""
    first, w = ic.make_taps(interp, src, dst)
    assert first.shape == (dst,) and w.shape[0] == dst and w.dtype == np.float32
    if interp == ic.NEAREST:
        assert w.shape[1] == 1 and (w == 1).all() and first.max() <= src - 1
    else:
        np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-5)


def test_geometry_matches_the_rounding_contract():
    """letterbox_geometry and staged_geometry in the C++'s float32 and
    double arithmetic, on cases where float64 or round-half-even would
    differ."""
    assert ic.letterbox_geometry(640, 480, 640, False)[:4] == (640, 480, 80, 0)
    nw, nh, top, left, r, pw, ph = ic.letterbox_geometry(701, 700, 640, False)
    assert (nw, nh, top, left) == (640, 639, 0, 0) and ph == 0.5
    assert ic.letterbox_geometry(300, 200, 640, True)[:2] == (640, 427)
    assert ic.staged_geometry(640, 532, 640, ic.SCALED)[:2] == (532, 640)
    assert ic.staged_geometry(1920, 1080, 960, ic.RAW)[:2] == (540, 960)
    assert ic.staged_geometry(200, 300, 160, ic.EVAL) == (160, 106, 0, 27, True)
    assert ic.staged_geometry(100, 50, 160, ic.RAW) == (50, 100, 0, 0, False)
    assert [ic._lround(v) for v in (0.5, 1.5, 2.5, -0.5, -0.1, 0.49999997)] == \
        [1, 2, 3, -1, 0, 0]


# -- choosing the pipeline -----------------------------------------------------------

class _Dataset:
    input_size = 64
    filenames = []
    labels = []


def test_pipeline_choice_on_the_cpu(monkeypatch):
    """On the CPU auto and on take the host library where it loads, off
    the Python loader; without it auto falls back and on raises."""
    from tpu_yolo_torch.data.loader import DataLoader, make_val_loader

    ds = _Dataset()
    if native_loader.available():
        for mode in ("auto", "on"):
            loader = make_val_loader(ds, 4, num_workers=1, native=mode, device="cpu")
            assert loader.stager == "native"
        assert native_loader.staging_pipeline(64, 1, device="cpu").stager == "native"
    assert isinstance(make_val_loader(ds, 4, num_workers=1, native="off"), DataLoader)
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "_why", "g++ not found: test")
    assert isinstance(make_val_loader(ds, 4, num_workers=1, native="auto"), DataLoader)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found: test"):
        make_val_loader(ds, 4, native="on")
    assert native_loader.staging_pipeline(64, 1).stager == "cv2"


def _no_card_library(monkeypatch):
    """A CUDA device whose library cannot be built: nvcc made missing."""
    def missing():
        raise RuntimeError("nvcc not found: test")
    monkeypatch.setattr(cuda_build, "_nvcc", missing)
    monkeypatch.setattr(cuda_build, "_loaded", {})


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_a_card_without_its_library_raises(mode, monkeypatch, tmp_path):
    """On a CUDA device auto and on take the card pipeline, and a build
    failure raises with the compiler's reason: no quiet cv2; off keeps
    the Python loader."""
    import argparse

    from tpu_yolo_torch.data.device_augment import DeviceAugmentLoader
    from tpu_yolo_torch.data.loader import DataLoader, make_val_loader
    from tpu_yolo_torch.train import trainer

    _no_card_library(monkeypatch)
    ds = _Dataset()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        make_val_loader(ds, 4, native=mode, device="cuda")
    assert isinstance(make_val_loader(ds, 4, native="off", device="cuda"), DataLoader)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native_loader.staging_pipeline(64, 1, device="cuda:0")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        DeviceAugmentLoader([], 64, {"mosaic": 1.0}, 2, device="cuda")
    args = argparse.Namespace(native_train=mode, input_size=64, workers=1, seed=0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        trainer._native_train_loader(args, {"mosaic": 1.0}, [], None, 2, False,
                                     "host loader", device="cuda")
    args.native_train = "off"
    assert trainer._native_train_loader(args, {}, [], None, 2, False, "host loader",
                                        device="cuda") == ("host loader", "host")


def test_launch_counts_hold_under_threads():
    """The wrappers count from many decode threads at once: no count is
    lost (a short switch interval makes a lost update likely)."""
    import sys
    import threading

    before = ic.place.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [ic._count("place") for _ in range(2000)])
                   for _ in range(16)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert ic.place.launches - before == 16 * 2000
    ic.place.launches = before
