"""The assigner's top-k mask: the port's plain version (what its wrapper
runs on the CPU) against the JAX package's Pallas kernel in interpret
mode and its argmax scan. Only comparisons touch the values, so every
check is bit-equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_yolo.ops.topk_pallas import topk_mask as jax_topk_mask
from tpu_yolo.train.loss import _topk_mask_by_argmax
from tpu_yolo_torch.ops.topk_cuda import topk_mask, topk_mask_plain


def _both(x, k):
    """(pallas-interpret mask, scan mask) of the JAX package, as numpy."""
    xj = jnp.asarray(x)
    return (np.asarray(jax_topk_mask(xj, k, interpret=True)),
            np.asarray(_topk_mask_by_argmax(xj, k)))


@pytest.mark.parametrize("b,n,a", [(2, 5, 300), (3, 64, 840), (1, 8, 57)])
def test_matches_jax_random(b, n, a):
    x = np.random.default_rng(0).random((b, n, a)).astype(np.float32)
    pallas, scan = _both(x, 10)
    got = topk_mask_plain(torch.from_numpy(x), 10).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scan)
    assert (got.sum(-1) == 10).all()


def test_matches_jax_with_ties():
    """Quantized values force many exact ties, which go to the lower
    index; all-zero rows (padded GT rows) select anchors 0..k-1, also
    where -0.0 stands among the +0.0."""
    x = np.round(np.random.default_rng(1).random((2, 7, 120)) * 4) / 4
    x[:, -2:] = 0.0
    x = x.astype(np.float32)
    x[:, -1, ::3] *= -1.0
    assert np.signbit(x[0, -1, 0]) and not np.signbit(x[0, -1, 1])
    pallas, scan = _both(x, 10)
    got = topk_mask_plain(torch.from_numpy(x), 10).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scan)
    assert got[:, -2:, :10].all() and got[:, -2:].sum() == 40


@pytest.mark.parametrize("a", [1, 4, 9])
def test_row_shorter_than_k(a):
    """After A rounds everything is taken and further rounds change
    nothing."""
    x = np.random.default_rng(a).random((2, 3, a)).astype(np.float32)
    pallas, scan = _both(x, 10)
    got = topk_mask_plain(torch.from_numpy(x), 10).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scan)
    assert got.all()


def test_wrapper_on_the_cpu_is_the_plain_version_and_counts_nothing():
    x = torch.from_numpy(np.random.default_rng(2).random((2, 4, 64)).astype(np.float32))
    before = topk_mask.launches
    assert torch.equal(topk_mask(x, 10), topk_mask_plain(x, 10))
    assert topk_mask.launches == before


@pytest.mark.parametrize("bad,exc", [
    (lambda: topk_mask(torch.zeros(2, 3, 8, dtype=torch.float64), 2), TypeError),
    (lambda: topk_mask(torch.zeros(3, 8), 2), ValueError),
    (lambda: topk_mask(torch.zeros(2, 8, 3).transpose(1, 2), 2), ValueError),
    (lambda: topk_mask(torch.zeros(2, 3, 8), 0), ValueError),
], ids=["dtype", "dims", "contiguity", "k"])
def test_wrapper_refuses(bad, exc):
    with pytest.raises(exc):
        bad()
