"""Where the port's f32 forward departs from the JAX package's, stage by
stage, on `seeded.eval_state`'s weights (BatchNorm set from the images,
as the eval tests use them).

Each stage of `forward_raw` (p1..p5 with SPPF and PSA apart, FPN h1..h6,
the three head levels) runs in both packages. A stage's own error is the
port's output, fed JAX's input, against JAX's output: it is the f32
summation-order level (a few 1e-6 of the activations' scale) at every
stage, so no layer departs. The accumulated error, each package fed its
own previous output, grows through the stages to about 1e-3 in the head's
logits, and JAX's own forward grows a one-ulp change of p1's output just
as fast: the network amplifies rounding differences, which is why
tests/test_torch_eval.py holds `evaluate` to 3e-2 px / 3e-4 in score."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.ops import blocks as jb
from tpu_yolo.ops.nn import Context, conv_bn, upsample2x
from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.ops.nn import upsample2x as port_upsample2x
from tpu_yolo_torch.seeded import eval_state, seeded_images

torch.set_num_threads(1)
_TINY = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True),
             num_classes=2)
TINY, JTINY = ModelConfig(**_TINY), JaxConfig(**_TINY)
SIZE = 64


def _identity(z):
    return z


def _stages(params, model):
    """[(name, input names, JAX fn, port fn)] in forward_raw's order;
    the JAX fns take and give NHWC arrays, the port fns NCHW tensors."""
    ctx = Context(train=False)
    net, fpn, head = params["net"], params["fpn"], params["head"]
    c0, c1 = JTINY.csp
    pn, pf = model.net, model.fpn

    def down_csp(p, use):
        return lambda x: jb.csp(p[1], conv_bn(p[0], x, ctx, "c", stride=2, padding=1),
                                ctx, "b", use)

    def jax_level(i):
        box, cls = head["box"][i], head["cls"][i]

        def level(x):
            b = conv_bn(box[0], x, ctx, "h", padding=1)
            b = conv_bn(box[1], b, ctx, "h", padding=1)
            b = conv_bn(box[2], b, ctx, "h", act=_identity)
            c = conv_bn(cls[0], x, ctx, "h", padding=1, groups=x.shape[-1])
            c = conv_bn(cls[1], c, ctx, "h")
            c = conv_bn(cls[2], c, ctx, "h", padding=1, groups=c.shape[-1])
            c = conv_bn(cls[3], c, ctx, "h")
            c = conv_bn(cls[4], c, ctx, "h", act=_identity)
            return jnp.concatenate((b, c), -1)
        return level

    def port_level(i):
        def level(x):
            b, c = x, x
            for conv in model.head["box"][i]:
                b = conv(b)
            for conv in model.head["cls"][i]:
                c = conv(c)
            return torch.cat((b, c), 1)
        return level

    def cat_up(j_p, t_m):
        return (lambda a, b: jb.csp(j_p, jnp.concatenate((upsample2x(a), b), -1),
                                    ctx, "f", c0),
                lambda a, b: t_m(torch.cat((port_upsample2x(a), b), 1)))

    return [
        ("p1", ["x"], lambda x: conv_bn(net["p1"][0], x, ctx, "s", stride=2, padding=1),
         lambda x: pn["p1"][0](x)),
        ("p2", ["p1"], down_csp(net["p2"], c0), lambda x: pn["p2"][1](pn["p2"][0](x))),
        ("p3", ["p2"], down_csp(net["p3"], c0), lambda x: pn["p3"][1](pn["p3"][0](x))),
        ("p4", ["p3"], down_csp(net["p4"], c1), lambda x: pn["p4"][1](pn["p4"][0](x))),
        ("p5", ["p4"], down_csp(net["p5"], c1), lambda x: pn["p5"][1](pn["p5"][0](x))),
        ("sppf", ["p5"], lambda x: jb.sppf(net["p5"][2], x, ctx, "s"), pn["p5"][2]),
        ("psa", ["sppf"], lambda x: jb.psa(net["p5"][3], x, ctx, "a", 1), pn["p5"][3]),
        ("h1", ["psa", "p4"], *cat_up(fpn["h1"], pf["h1"])),
        ("h2", ["h1", "p3"], *cat_up(fpn["h2"], pf["h2"])),
        ("h3", ["h2"], lambda x: conv_bn(fpn["h3"], x, ctx, "d", stride=2, padding=1),
         pf["h3"]),
        ("h4", ["h3", "h1"], lambda a, b: jb.csp(fpn["h4"], jnp.concatenate((a, b), -1),
                                                 ctx, "f", c0),
         lambda a, b: pf["h4"](torch.cat((a, b), 1))),
        ("h5", ["h4"], lambda x: conv_bn(fpn["h5"], x, ctx, "d", stride=2, padding=1),
         pf["h5"]),
        ("h6", ["h5", "psa"], lambda a, b: jb.csp(fpn["h6"], jnp.concatenate((a, b), -1),
                                                  ctx, "f", c1),
         lambda a, b: pf["h6"](torch.cat((a, b), 1))),
        ("head0", ["h2"], jax_level(0), port_level(0)),
        ("head1", ["h4"], jax_level(1), port_level(1)),
        ("head2", ["h6"], jax_level(2), port_level(2)),
    ]


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _rel(mine, ref):
    """Max error relative to max(|ref|, 1), as tests/test_torch_model.py."""
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(mine) - ref) / np.maximum(np.abs(ref), 1.0)))


@pytest.fixture(scope="module")
def gaps():
    images = seeded_images(np.random.default_rng(7), 4, SIZE)
    params = jax_yolo.fold_batchnorm(to_jax_params(eval_state(TINY, 0, images, "cpu")))
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY)).to(
        memory_format=torch.channels_last)
    stages = _stages(params, model)
    x = images.astype(np.float32) / 255
    ref, port, bumped = {"x": jnp.asarray(x)}, {"x": _nchw(x)}, {}
    own, acc, self_gap = {}, {}, {}
    with torch.no_grad():
        for name, ins, jfn, tfn in stages:
            jfn = jax.jit(jfn)
            ref[name] = jfn(*(ref[i] for i in ins))
            port[name] = tfn(*(port[i] for i in ins))
            own[name] = _rel(tfn(*(_nchw(ref[i]) for i in ins)).permute(0, 2, 3, 1),
                             ref[name])
            acc[name] = _rel(port[name].permute(0, 2, 3, 1), ref[name])
            if name == "p1":   # JAX against itself, p1's output one ulp off
                p1 = np.asarray(ref[name])
                up = np.random.default_rng(0).random(p1.shape) < 0.5
                bumped[name] = jnp.asarray(np.nextafter(
                    p1, np.where(up, np.float32(np.inf), np.float32(-np.inf))))
            else:
                bumped[name] = jfn(*(bumped.get(i, ref[i]) for i in ins))
                self_gap[name] = _rel(bumped[name], ref[name])
        full = jax.jit(jax_yolo.forward_raw, static_argnums=2)(params, jnp.asarray(x),
                                                                JTINY)
        raw = model.forward_raw(torch.from_numpy(x))
    return own, acc, self_gap, [_rel(r, f) for r, f in zip(raw, full)]


STAGE_NAMES = ["p1", "p2", "p3", "p4", "p5", "sppf", "psa", "h1", "h2", "h3",
               "h4", "h5", "h6", "head0", "head1", "head2"]


@pytest.mark.parametrize("stage", STAGE_NAMES)
def test_stage_departs_only_by_summation_order(gaps, stage):
    """Fed JAX's input, every stage of the port gives JAX's output within
    1e-5 of max(|out|, 1): a few f32 roundings of sums over up to 1,152
    terms, and no layer that computes something else."""
    own = gaps[0]
    assert own[stage] < 1e-5, own


def test_gap_grows_as_jax_amplifies_its_own_rounding(gaps):
    """The accumulated gap grows through the stages as JAX's own forward
    grows a one-ulp change of p1's output: at the PSA output, where the
    growth is steepest, and at the three head levels, the port's gap is
    within a small factor of JAX's gap against itself, and both grew by
    two orders of magnitude from p2. The gaps of the stage-by-stage chain
    are those of the whole forward_raw."""
    own, acc, self_gap, raw_gap = gaps
    assert self_gap["psa"] > 50 * self_gap["p2"]
    assert acc["psa"] > 50 * acc["p2"]
    for stage in ("psa", "head0", "head1", "head2"):
        assert self_gap[stage] / 4 < acc[stage] < 4 * self_gap[stage], (
            stage, acc[stage], self_gap[stage])
    assert max(own.values()) < acc["head2"] / 50
    np.testing.assert_allclose(raw_gap, [acc["head0"], acc["head1"], acc["head2"]],
                               rtol=0.5)
    assert max(raw_gap) < 5e-3
