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
    elif case == "dh":
        v = v[..., :32].contiguous()
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        fused_attention(q, k, v, 32 ** -0.5)
