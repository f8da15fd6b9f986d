"""PSA attention in the port: the plain version against the Pallas kernel
(interpret mode), a model of the CUDA kernels' schedule against both, the
attention block against the JAX block, and the wrapper's input checks. The CUDA kernel's tests are in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_yolo.models.yolov11 import _init_attention
from tpu_yolo.ops import blocks as jax_blocks
from tpu_yolo.ops.attention_pallas import fused_attention as pallas_attention
from tpu_yolo.ops.nn import Context
from tpu_yolo_torch.io.weights import _tree_items
from tpu_yolo_torch.ops.attention_cuda import attention_plain, fused_attention
from tpu_yolo_torch.ops.blocks import Attention

torch.set_num_threads(1)


def _qkv(rng, bh, t, dk, dh):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((bh, t, dk), (bh, t, dk), (bh, t, dh)))


@pytest.mark.parametrize("t,dk,dh", [(400, 32, 64), (100, 16, 32)])
def test_plain_matches_pallas_interpret(t, dk, dh):
    q, k, v = _qkv(np.random.default_rng(0), 4, t, dk, dh)
    scale = dk ** -0.5
    want = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale, interpret=True)
    got = attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _schedule_model(q, k, v, scale, tile, fold_log2e):
    """The CUDA kernels' schedule in tensor ops: keys in tiles of `tile`
    (ragged at the end), scores in f32, a running max and sum, each tile's
    p rounded to v's dtype before the PV product (unnormalized), PV
    accumulated in f32, one division at the end. The bf16 kernel folds
    scale*log2(e) into the scores and takes exp2 (tile 80); the f32 kernel
    scales and takes exp (tile 64)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    factor = torch.tensor(scale, dtype=torch.float32)
    if fold_log2e:
        factor = factor * torch.tensor(1.4426950408889634, dtype=torch.float32)
    exp = torch.exp2 if fold_log2e else torch.exp
    bh, t, _ = q.shape
    m = torch.full((bh, t), -torch.inf)
    l = torch.zeros(bh, t)
    o = torch.zeros(bh, t, v.shape[-1])
    for k0 in range(0, t, tile):
        s = torch.matmul(qf, kf[:, k0:k0 + tile].transpose(-1, -2)) * factor
        m_new = torch.maximum(m, s.max(-1).values)
        corr = exp(m - m_new)                   # 0 on the first tile
        p = exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.matmul(p.to(v.dtype).float(),
                                               vf[:, k0:k0 + tile])
        m = m_new
    return (o * (1.0 / l)[..., None]).to(v.dtype)


@pytest.mark.parametrize("t", [57, 400, 333, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_schedule_model_matches_plain_and_pallas(dtype, t):
    """The online, tiled form the CUDA kernels compute agrees with the
    plain version and with the Pallas kernel (interpret mode) on the same
    seeded inputs: bf16 within 1e-2 abs + 1e-2 rel (p is rounded to bf16
    before it is normalized, so up to a bf16 ulp apart), f32 within 1e-5."""
    bf16 = dtype == "bfloat16"
    tol = 1e-2 if bf16 else 1e-5
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _qkv(np.random.default_rng(t), 3, t, 32, 64))
    scale = 32 ** -0.5
    got = _schedule_model(q, k, v, scale, tile=80 if bf16 else 64,
                          fold_log2e=bf16).float()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, attention_plain(q, k, v, scale).float(),
                               rtol=tol, atol=tol)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = pallas_attention(*(jnp.asarray(a.float().numpy(), jdt) for a in (q, k, v)),
                            scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_bf16_kernel_within_a_p_step_of_plain_where_v_is_large():
    """Where v is large (here up to 47; v11-x's PSA blocks on phase x's
    eval inputs reach 195 with near one-hot attention), the kernel's
    schedule, which rounds p to bf16 before dividing by the row's sum,
    puts 951 outputs past the bare 1e-2 abs + rel of the plain version
    (4x it at worst). A two-pass form that divides first, as the Pallas
    kernel does, agrees here, but on v11-x's eval inputs it too leaves
    outputs past the bare gate (25 on the H100): where the two sum
    in other orders some p still round to the neighbouring bf16 value.
    Both stay within 1e-2 abs + rel plus 2^-7 (P|V|), one bf16 step of
    every p times its |v| (chip_smoke.py's MS_P_STEP gate): 0.49 and 0.29
    of it here."""
    rng = np.random.default_rng(15)
    q, k, v = _qkv(rng, 8, 400, 32, 64)
    q, k, v = (torch.from_numpy(a * f).bfloat16() for a, f in ((q, 2), (k, 2), (v, 10)))
    scale = 32 ** -0.5
    want = attention_plain(q, k, v, scale).float()
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, -1)
    bare = 1e-2 + 1e-2 * want.abs()
    step = 2.0 ** -7 * torch.matmul(p, v.float().abs())

    # the two-pass form: the rows' maxima and sums, then p / l rounded
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                dtype=torch.float32)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * c
    e = torch.exp2(s - s.max(-1, keepdim=True).values)
    two_pass = torch.matmul((e / e.sum(-1, keepdim=True)).to(v.dtype).float(),
                            v.float()).to(v.dtype)
    kernel = _schedule_model(q, k, v, scale, tile=80, fold_log2e=True).float()
    assert bool(((kernel - want).abs() > bare).any())
    for got in (kernel, two_pass.float()):
        assert bool(((got - want).abs() <= bare + step).all())


def _f32_kernel_model(q, k, v, scale):
    """The f32 CUDA kernel's arithmetic, rounding by rounding: per query
    row a 32-term FMA chain for each score, then keys in tiles of 64: the
    tile's exponentials and p·v summed on their own (64-term chains, FMAs
    emulated in f64 and rounded to f32), folded into the running sums by
    one FMA with the rescale factor, one division at the end."""
    f32 = np.float32

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(f32)

    bh, t, dk = q.shape
    s = np.zeros((bh, t, t), f32)
    for d in range(dk):
        s = fma(q[:, :, None, d], k[:, None, :, d], s)
    s = (s * f32(scale)).astype(f32)
    m = np.full((bh, t), -np.inf, f32)
    l = np.zeros((bh, t), f32)
    acc = np.zeros((bh, t, v.shape[-1]), f32)
    for k0 in range(0, t, 64):
        tile = s[:, :, k0:k0 + 64]
        m_new = np.maximum(m, tile.max(-1))
        corr = np.exp(m - m_new).astype(f32)
        part_l, part = np.zeros_like(l), np.zeros_like(acc)
        for j in range(tile.shape[-1]):
            p = np.exp(tile[:, :, j] - m_new).astype(f32)
            part_l = (part_l + p).astype(f32)
            part = fma(p[..., None], v[:, None, k0 + j], part)
        l, acc, m = fma(l, corr, part_l), fma(acc, corr[..., None], part), m_new
    return (acc * (f32(1) / l)[..., None]).astype(f32)


def test_f32_kernel_arithmetic_at_the_spatial_path_shape():
    """At T = 1600 (the p5 map of a 1280 px image, phase u of
    chip_smoke.py), scores spread as the seeded serving weights spread
    them there (std 1.37) and 8 channels of v offset by 12 (outputs near
    13, as there), the f32 kernel's rounding stays within 1e-5 abs + rel
    of the plain version, the tolerance the card holds it to, and no
    farther from the exact (f64) result than the plain version is. One
    chain of 1,600 FMAs over the row, as the kernel once summed, fails
    the second condition here."""
    rng = np.random.default_rng(1600)
    q, k, v = (a * np.float32(1.17) for a in _qkv(rng, 2, 1600, 32, 64))
    v[:, :, :8] += 12
    scale = 32 ** -0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = attention_plain(tq, tk, tv, scale).numpy()
    exact = (torch.softmax(tq.double() @ tk.double().transpose(-1, -2) * scale, -1)
             @ tv.double()).numpy()
    got = _f32_kernel_model(q, k, v, scale)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(1), 2, 50, 32, 64))
    assert torch.equal(fused_attention(q, k, v, 0.25),
                       attention_plain(q, k, v, 0.25))


def test_attention_block_matches_jax():
    """The port's Attention module (qkv conv, [dk|dk|dh] head split, the
    wrapper, positional branch, projection) equals tpu_yolo's
    blocks.attention on the same weights, NHWC in and out."""
    rng = np.random.default_rng(2)
    ch, heads = 128, 2
    params = _init_attention(lambda: rng, ch, heads)
    for p in params.values():   # non-trivial BatchNorm statistics
        p["mean"] = rng.normal(0, 0.1, p["mean"].shape).astype(np.float32)
        p["var"] = rng.uniform(0.5, 1.5, p["var"].shape).astype(np.float32)
    x = rng.standard_normal((2, 6, 5, ch)).astype(np.float32)
    want = jax_blocks.attention(params, jnp.asarray(x), Context(train=False),
                                "attn", heads)

    block = Attention(ch, heads).eval()
    block.load_state_dict({
        ".".join(path): torch.from_numpy(
            a.transpose(3, 2, 0, 1).copy() if a.ndim == 4 else a)
        for path, a in _tree_items(params)}, strict=True)
    with torch.inference_mode():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["dtype", "mixed", "dk", "dh", "layout"])
def test_wrapper_raises_instead_of_falling_back(case):
    q, k, v = map(torch.from_numpy, _qkv(np.random.default_rng(3), 2, 16, 32, 64))
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        v = v.bfloat16()
    elif case == "dk":
        q, k = q[..., :16].contiguous(), k[..., :16].contiguous()
    elif case == "dh":   # 32 and 64 are the value widths the kernel takes
        v = v[..., :16].contiguous()
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        fused_attention(q, k, v, 32 ** -0.5)
