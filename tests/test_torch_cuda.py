"""The port's CUDA kernels against their plain versions, on a card.

This file imports neither JAX nor tpu_yolo, so it also runs where only
PyTorch is installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py

Every test needs a CUDA card and skips without one.
"""
import numpy as np
import pytest
import torch

from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.attention_cuda import (attention_plain, fused_attention,
                                               kernel_form)
from tpu_yolo_torch.ops.nms_cuda import greedy_keep, greedy_keep_plain
from tpu_yolo_torch.ops.topk_cuda import topk_mask, topk_mask_plain
from tpu_yolo_torch.seeded import nms_scene
from tpu_yolo_torch.serve import Detector


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,bh,t,form", [
    (torch.bfloat16, 256, 400, "resident"),   # the serving shape
    (torch.bfloat16, 200, 333, "resident"),   # T not a multiple of 8
    (torch.bfloat16, 140, 560, "resident"),   # the longest resident T
    (torch.bfloat16, 140, 561, "streamed"),
    (torch.bfloat16, 16, 1600, "streamed"),   # the 1280 px shape
    (torch.bfloat16, 2, 400, "streamed"),     # one image: fewer heads than SMs
    (torch.bfloat16, 3, 57, "streamed"),
    (torch.bfloat16, 5, 1, "streamed"),
    (torch.float32, 8, 400, "f32")])
def test_attention_kernel_matches_plain(cuda, dtype, bh, t, form):
    """bf16: within 1e-2 abs + 1e-2 rel (p is rounded to bf16 at another
    point of the online softmax than in the plain version); f32: 1e-5.
    The forms are those of an H100's 132 SMs."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k = (torch.randn(bh, t, 32, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    v = torch.randn(bh, t, 64, device=cuda, generator=gen).to(dtype)
    before = fused_attention.launches
    got = fused_attention(q, k, v, 32 ** -0.5)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    if torch.cuda.get_device_properties(cuda).multi_processor_count == 132:
        assert kernel_form(bh, t, dtype) == form
    want = attention_plain(q, k, v, 32 ** -0.5)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_attention_kernel_with_large_scores(cuda):
    """Scores of some hundreds: the running max keeps exp2 in range, and a
    row dominated by one key returns that key's value."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k = (8 * torch.randn(140, 400, 32, device=cuda, generator=gen).bfloat16()
            for _ in range(2))
    v = torch.randn(140, 400, 64, device=cuda, generator=gen).bfloat16()
    got = fused_attention(q, k, v, 1.0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), attention_plain(q, k, v, 1.0).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("scene,b,k", [
    ("clustered", 128, 1024), ("clustered", 8, 2048), ("clustered", 1, 256),
    ("uniform", 4, 1000), ("clustered", 3, 33), ("uniform", 2, 8192),
    ("disjoint", 4, 1024), ("identical", 4, 1024), ("invalid", 2, 1024),
    ("clustered", 2, 1), ("clustered", 2, 8192), ("identical", 1, 8192)])
@pytest.mark.parametrize("valid_as", ["given", "prefix"])
def test_nms_kernel_equals_plain(cuda, scene, b, k, valid_as):
    """Bit-equal keep masks, with `valid` as the scene gives it (any
    pattern) and as a prefix (what the main path passes)."""
    rng = np.random.default_rng(b * k)
    boxes, cls, valid = nms_scene(rng, scene, b, k)
    if valid_as == "prefix":
        valid = np.arange(k)[None, :] < rng.integers(0, k + 1, (b, 1))
    boxes, cls, valid = (torch.from_numpy(a).to(cuda) for a in (boxes, cls, valid))
    before = greedy_keep.launches
    got = greedy_keep(boxes, cls, valid, 0.65)
    torch.cuda.synchronize()
    assert greedy_keep.launches == before + 1
    assert torch.equal(got, greedy_keep_plain(boxes, cls, valid, 0.65))


@pytest.mark.parametrize("thr", [0.0, 0.3, 0.9, 1.0])
def test_nms_kernel_equals_plain_at_other_thresholds(cuda, thr):
    boxes, cls, valid = (torch.from_numpy(a).to(cuda) for a in
                         nms_scene(np.random.default_rng(7), "clustered", 4, 1024))
    assert torch.equal(greedy_keep(boxes, cls, valid, thr),
                       greedy_keep_plain(boxes, cls, valid, thr))


@pytest.mark.parametrize("shape,ties", [((64, 64, 8400), False),
                                        ((2, 512, 8400), False),
                                        ((3, 7, 57), False),
                                        ((4, 9, 8400), True),
                                        ((1, 8, 25200), False),
                                        ((2, 3, 7), False)])
def test_topk_kernel_equals_plain(cuda, shape, ties):
    """Bit-equal: only comparisons touch the values. The tie case has
    quantized values, signed zeros and all-zero rows (which must select
    anchors 0..k-1); (2, 3, 7) has rows shorter than k."""
    x = np.random.default_rng(shape[1]).random(shape).astype(np.float32)
    if ties:
        x = np.round(x * 4) / 4
        x[:, -2:] = 0.0
        x[:, -1, ::3] *= -1.0                # -0.0 among the +0.0
    x = torch.from_numpy(x).to(cuda)
    before = topk_mask.launches
    got = topk_mask(x, 10)
    torch.cuda.synchronize()
    assert topk_mask.launches == before + 1
    assert torch.equal(got, topk_mask_plain(x, 10))
    assert torch.equal(got.cpu(), topk_mask_plain(x.cpu(), 10))
    if ties:
        assert bool(got[:, -1, :10].all()) and int(got[:, -1].sum()) == 40


def test_topk_kernel_refuses_a_row_beyond_shared_memory(cuda):
    x = torch.zeros(1, 1, 58081, device=cuda)
    with pytest.raises(ValueError, match="58080"):
        topk_mask(x, 10)


def test_detector_runs_both_kernels(cuda):
    cfg = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                      csp=(False, True), num_classes=8)
    params = init_params(0, cfg)
    for level in params["head"]["cls"]:
        level[4]["b"][:] = -1.0
    det = Detector(YOLO.from_state_dict(cfg, from_jax_params(params, cfg)),
                   input_size=128, device="cuda")
    imgs = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3), np.uint8)
    attn, keep = fused_attention.launches, greedy_keep.launches
    res = det.detect_batch(imgs)
    torch.cuda.synchronize()
    assert fused_attention.launches > attn and greedy_keep.launches > keep
    assert int(res["count"].min()) > 0


@pytest.mark.parametrize("staged", [False, True])
def test_saved_program_runs_the_kernels(cuda, tmp_path, staged):
    """A saved serving program on the card: its graph calls the custom
    ops, the loaded Detector launches both kernels, and its detections
    equal the live Detector's bit for bit."""
    cfg = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                      csp=(False, True), num_classes=8)
    params = init_params(0, cfg)
    for level in params["head"]["cls"]:
        level[4]["b"][:] = -1.0
    state = YOLO.from_state_dict(cfg, from_jax_params(params, cfg)).fold_batchnorm().state_dict()
    live = Detector(YOLO.from_state_dict(cfg, state), input_size=128, device="cuda",
                    device_letterbox=staged, stage_size=160)
    path = str(tmp_path / "det.pt2z")
    live.save_compiled(path, batch_size=2)
    loaded = Detector.load_compiled(path, state)
    rng = np.random.default_rng(2)
    if staged:
        args = (torch.from_numpy(rng.integers(0, 256, (2, 160, 160, 3), np.uint8)).to(cuda),
                torch.tensor([[120.0, 160.0], [160.0, 96.0]], device=cuda))
        want = live._predict_staged(*args)
    else:
        args = (rng.integers(0, 256, (2, 128, 128, 3), np.uint8),)
        want = live.detect_batch(*args)
    attn, keep = fused_attention.launches, greedy_keep.launches
    got = (loaded._predict_staged(*args) if staged else loaded.detect_batch(*args))
    torch.cuda.synchronize()
    assert fused_attention.launches == attn + 1 and greedy_keep.launches == keep + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bf16_train_step_runs_the_topk_kernel(cuda):
    """Three bf16 train steps on a narrow model: one top-k launch a step,
    none of the inference attention kernel, finite losses, and BN
    statistics, parameters and EMA that move."""
    from tpu_yolo_torch.seeded import seeded_train_batch
    from tpu_yolo_torch.train.step import init_train_state, train_step

    cfg = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                      csp=(False, True), num_classes=8)
    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg))
    state = init_train_state(model.to(device=cuda, memory_format=torch.channels_last))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    images, gt = (torch.from_numpy(a).to(cuda) for a in seeded_train_batch(
        np.random.default_rng(0), 8, 128, max_boxes=6, num_classes=8))
    topk, attn = topk_mask.launches, fused_attention.launches
    for remat in (False, "stage", "blocks"):
        losses = train_step(state, images, gt, 0.001, [7.5, 0.5, 1.5], 5e-4, 0.937,
                            cfg=cfg, remat=remat)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(losses).all()), (remat, losses)
    assert topk_mask.launches == topk + 3 and fused_attention.launches == attn
    after = model.state_dict()
    for leaf in ("net.p1.0.w", "net.p1.0.gamma", "net.p1.0.mean", "net.p1.0.var"):
        assert not torch.equal(after[leaf], before[leaf]), leaf
    assert not torch.equal(state.ema["net.p1.0.w"], before["net.p1.0.w"])
    assert state.step == 3 and state.ema_updates == 3


def test_stream_on_the_card_equals_detect_one(cuda, tmp_path):
    """stream()'s pinned double buffer and per-result events give what
    detect_one gives, image by image (f32, TF32 off: the two paths run
    at different batch sizes)."""
    cv2 = pytest.importorskip("cv2")
    cfg = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                      csp=(False, True), num_classes=8)
    params = init_params(0, cfg)
    for level in params["head"]["cls"]:
        level[4]["b"][:] = -1.0
    det = Detector(YOLO.from_state_dict(cfg, from_jax_params(params, cfg)),
                   input_size=128, device="cuda", compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(120, 160), (80, 60), (128, 128), (90, 200),
                                (200, 90)]):
        paths.append(str(tmp_path / f"im{i}.jpg"))
        cv2.imwrite(paths[-1], rng.integers(0, 255, (h, w, 3), np.uint8))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        streamed = list(det.stream(paths, batch_size=2))
        singles = [det.detect_one(p) for p in paths]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert [r["path"] for r in streamed] == paths
    for r, one in zip(streamed, singles):
        np.testing.assert_array_equal(r["classes"], one["classes"])
        np.testing.assert_allclose(r["boxes"], one["boxes"], atol=0.05)


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("src_hw,dst_hw", [((480, 640), (240, 320)),
                                           ((1080, 1920), (540, 960)),
                                           ((300, 200), (640, 427)),
                                           ((37, 1000), (23, 640)),
                                           ((640, 640), (640, 640))])
def test_placement_kernels_equal_plain(cuda, interp, src_hw, dst_hw):
    """resize_bilinear / resize_generic (as resize_into dispatches them)
    and place against their plain versions on the card, bit for bit: the
    kernels build with -fmad=false and the plain versions run each
    product and sum as its own operation."""
    from tpu_yolo_torch.ops import image_cuda as ic

    rng = np.random.default_rng(interp)
    src = torch.from_numpy(rng.integers(0, 256, (*src_hw, 3), np.uint8)).to(cuda)
    (sh, sw), (dh, dw) = src_hw, dst_hw
    slot = torch.full((dh + 7, dw + 5, 3), 3, dtype=torch.uint8, device=cuda)
    before = (ic.resize_bilinear.launches, ic.resize_generic.launches)
    ic.resize_into(src, slot, dh, dw, interp, 7, 5)
    bilinear = ic.uses_bilinear(interp, sw, sh, dw, dh)
    want = (ic.resize_bilinear_plain(src, dh, dw) if bilinear
            else ic.resize_generic_plain(src, dh, dw, interp))
    torch.cuda.synchronize()
    assert torch.equal(slot[7:, 5:], want)
    assert (ic.resize_bilinear.launches - before[0],
            ic.resize_generic.launches - before[1]) == ((1, 0) if bilinear else (0, 1))
    got, plain = slot.clone(), slot.clone()
    ic.place(got, 7, 5, dh, dw)
    ic.place_plain(plain, 7, 5, dh, dw)
    big = torch.full((dh + 40, dw + 40, 3), 9, dtype=torch.uint8, device=cuda)
    got2, plain2 = big.clone(), big.clone()
    ic.place(got2, 11, 13, dh, dw, want)
    ic.place_plain(plain2, 11, 13, dh, dw, want)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(got2, plain2)


@pytest.mark.parametrize("hs,vs", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("h,w", [(480, 640), (1080, 1920), (37, 251), (17, 3)])
def test_ycc_kernel_equals_plain(cuda, hs, vs, h, w):
    """ycc_to_rgb against ycc_to_rgb_plain on random planes, RGB and BGR,
    bit for bit: both are libjpeg's integer upsampling and conversion."""
    from tpu_yolo_torch.ops import image_cuda as ic

    rng = np.random.default_rng(h + w + hs + vs)
    y = torch.from_numpy(rng.integers(0, 256, (h, w), np.uint8)).to(cuda)
    cb, cr = (torch.from_numpy(rng.integers(0, 256, (-(-h // vs), -(-w // hs)),
                                            np.uint8)).to(cuda) for _ in range(2))
    for bgr in (False, True):
        out = torch.full((h, w, 3), 7, dtype=torch.uint8, device=cuda)
        before = ic.ycc_to_rgb.launches
        ic.ycc_to_rgb(y, cb, cr, out, hs, vs, bgr)
        want = ic.ycc_to_rgb_plain(y, cb, cr, hs, vs, bgr)
        torch.cuda.synchronize()
        assert ic.ycc_to_rgb.launches == before + 1
        assert torch.equal(out, want)


# nvJPEG's decode (its IDCT, then libjpeg's upsampling and conversion)
# against cv2's (libjpeg's): the mean |difference| per image stays under
# this many levels; the controls (nvJPEG's own RGB with replicated
# chroma, the channels swapped, cv2's pixels moved by +-1) exceed it. On
# an H100 the decode read 0.034-0.039 and the controls 4.4-6.8, 43-49 and
# 0.66 on these JPEGs (0.51 for nvJPEG's own RGB at 4:4:4)
DECODE_GAP_BOUND = 0.2


def _smooth_jpegs(root, rng, sizes, sampling=None):
    """Seeded photo-like JPEGs (noise at 1/8 size, cubic upsampling), at
    cv2's chroma `sampling` factor (4:2:0 by default)."""
    import cv2

    paths = []
    params = [] if sampling is None else [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    for i, (h, w) in enumerate(sizes):
        base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), np.uint8)
        paths.append(str(root / f"im{i}_{sampling}.jpg"))
        cv2.imwrite(paths[-1], cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC),
                    params)
    return paths


def _decodes(card, path):
    """The card pipeline's decode of `path` and nvJPEG's own interleaved
    RGB of it, as host arrays."""
    dec = card._decoders[0]
    n = dec.read(path)
    with torch.cuda.stream(dec.stream):
        ours = dec.decode(n, False)
        own = torch.empty_like(ours)
        assert dec.lib.ic_decode(dec.handle, dec.pinned.ctypes.data, n, 0,
                                 own.data_ptr(), 3 * own.shape[1],
                                 dec.stream.cuda_stream) == 0
        dec.done.record(dec.stream)
    torch.cuda.synchronize()
    return ours.cpu().numpy().astype(int), own.cpu().numpy().astype(int)


def test_card_decode_against_libjpeg(cuda, tmp_path):
    """nvJPEG through the card pipeline against cv2 on 4:2:0, 4:2:2 and
    4:4:4 JPEGs: each image's mean |difference| under DECODE_GAP_BOUND,
    the channel means within 0.05 levels; every control over the bound.
    The readings are printed."""
    import cv2
    from tpu_yolo_torch.data import native_loader as nl

    rng = np.random.default_rng(1)
    sizes = [(480, 640), (640, 480), (1080, 1920), (37, 251)]
    paths = (_smooth_jpegs(tmp_path, rng, sizes)
             + _smooth_jpegs(tmp_path, rng, sizes[:2], cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
             + _smooth_jpegs(tmp_path, rng, sizes[:2], cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444))
    card = nl.CardPipeline(640, threads=1, device="cuda")
    noise = rng.integers(-1, 2, (1080, 1920, 3))
    for p in paths:
        want = cv2.imread(p)[:, :, ::-1].astype(int)
        ours, own = _decodes(card, p)
        h, w = want.shape[:2]
        gaps = {"ours": np.abs(ours - want).mean(),
                "channel_means": np.abs((ours - want).mean((0, 1))).max(),
                "nvjpeg_own_rgb": np.abs(own - want).mean(),
                "swapped": np.abs(ours[:, :, ::-1] - want).mean(),
                "cv2_plus_minus_one": np.abs(np.clip(want + noise[:h, :w], 0, 255)
                                             - want).mean()}
        print(p.rsplit("/", 1)[1], (h, w), {k: round(float(v), 4) for k, v in gaps.items()},
              "max", int(np.abs(ours - want).max()))
        assert gaps["ours"] < DECODE_GAP_BOUND and gaps["channel_means"] < 0.05, p
        assert gaps["swapped"] > DECODE_GAP_BOUND
        assert gaps["cv2_plus_minus_one"] > DECODE_GAP_BOUND
    # the controls that show the upsampling: nvJPEG's own RGB of the
    # subsampled smooth JPEGs misses by more than the bound
    for p in paths[:6]:
        want = cv2.imread(p)[:, :, ::-1].astype(int)
        assert np.abs(_decodes(card, p)[1] - want).mean() > DECODE_GAP_BOUND, p


def test_card_pipeline_against_cv2(cuda, tmp_path):
    """The card pipeline's five calls against Cv2Pipeline and the cv2 fill
    functions: the same shapes, dims and metas (the geometry), pixels
    within DECODE_GAP_BOUND of libjpeg's on smooth JPEGs and zero outside
    every image; a PNG through cv2, counted; batches back to back on the
    side streams equal to one call's."""
    cv2 = pytest.importorskip("cv2")
    from tpu_yolo_torch.data import native_loader as nl

    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(480, 640), (640, 480), (1080, 1920), (300, 200),
                                (37, 1000)]):
        base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), np.uint8)
        paths.append(str(tmp_path / f"im{i}.jpg"))
        cv2.imwrite(paths[-1], cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC))
    paths.append(str(tmp_path / "x.png"))
    cv2.imwrite(paths[-1], rng.integers(0, 256, (90, 70, 3), np.uint8))
    card, ref = nl.CardPipeline(640, threads=3, device="cuda"), nl.Cv2Pipeline(2)
    stage = 960

    def host_fill(fill, size, width):
        out = np.zeros((len(paths), size, size, 3), np.uint8)
        rows = np.zeros((len(paths), width), np.float32)
        for i, p in enumerate(paths):
            fill(cv2.imread(p), out[i], rows[i], i)
        return out, rows

    cases = {
        "raw": (card.load_batch_raw(paths, stage), ref.load_batch_raw(paths, stage)[:2]),
        "scaled": (card.load_batch_scaled(paths, 640, bgr=True),
                   ref.load_batch_scaled(paths, 640, bgr=True)[:2]),
        "eval": (card.load_batch_eval(paths, 640), host_fill(nl.fb_eval(640), 640, 4)),
        "letterbox": (card.load_batch(paths),
                      host_fill(nl.fb_letterbox(640), 640, 5))}
    torch.cuda.synchronize()
    for name, ((got, rows, nfail), (want, wrows)) in cases.items():
        got = got.cpu().numpy()
        assert got.shape == want.shape and nfail == 0, name
        np.testing.assert_allclose(rows, wrows, rtol=1e-6, err_msg=name)
        assert ((got == 0) == (want == 0)).mean() > 0.99, name
        gap = np.abs(got.astype(int) - want).mean()
        print(name, "mean |gap|", round(float(gap), 4))
        assert gap < DECODE_GAP_BOUND, name
    assert card.fallbacks == 4
    first = card.load_batch_raw(paths, stage)[0].clone()
    for _ in range(3):
        again = card.load_batch_raw(paths, stage)[0]
    torch.cuda.synchronize()
    assert torch.equal(first, again)
