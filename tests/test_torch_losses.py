"""The port's loss zoo (``wt_pse_tpu_torch/ops/losses.py``) against the JAX
package's ``wt_pse_tpu/ops/losses.py`` on the same numpy inputs from a seed.

- ``distance_transform``: its squared passes bitwise equal to the JAX ones
  (exact f32 min-plus passes over integer squared distances), the distance
  within one f32 ulp of JAX's (the libraries' square roots may round apart)
  and within 1e-6 relative of scipy's f64
  ``distance_transform_edt``, inf for an empty item; also across the 512-row
  chunk boundary.
- the Dice losses, the watershed cross-entropy and ``cross_entropy2d``
  (NCHW in the port, NHWC in JAX) at tolerance class ``f32_reduce``.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from wt_pse_tpu.ops import losses as JL
from wt_pse_tpu_torch.ops import losses as L

from torch_port import F32_REDUCE, assert_close, nchw, torch_single_thread  # noqa: F401


def _blobs(r, b, h, w, n=3):
    m = np.zeros((b, h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        for _ in range(n):
            cy, cx, rad = r.randint(0, h), r.randint(0, w), r.randint(1, 6)
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
    return m


@pytest.mark.parametrize("shape", [(3, 40, 40), (3, 180, 40), (2, 17, 61)])
def test_distance_transform_is_exact(shape):
    """(3, 180, 40): the first pass runs 540 lines, over the 512-line chunk."""
    m = _blobs(np.random.RandomState(sum(shape)), *shape)
    m[-1] = False  # an empty item: inf everywhere
    f = np.where(m, 0.0, 1e12).astype(np.float32)
    for axis in (-1, -2):  # the squared passes: exact integers, bitwise equal
        got_sq = L._minplus_parabola(torch.from_numpy(np.swapaxes(f, -1, axis).copy())).numpy()
        want_sq = np.asarray(JL._minplus_parabola(jnp.asarray(np.swapaxes(f, -1, axis))))
        np.testing.assert_array_equal(got_sq, want_sq)
        f = np.swapaxes(got_sq, -1, axis)
    got = L.distance_transform(torch.from_numpy(m)).numpy()
    want = np.asarray(JL.distance_transform(jnp.asarray(m)))
    # the square roots of the two libraries may round 1 ulp apart on the CPU
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert np.isinf(got[-1]).all() and np.isinf(want[-1]).all()
    for i in range(shape[0] - 1):
        np.testing.assert_allclose(got[i], ndi.distance_transform_edt(~m[i]), rtol=1e-6, atol=0)


def test_dice_losses_match_jax():
    r = np.random.RandomState(1)
    logits = r.randn(3, 32, 32, 2).astype(np.float32) * 3
    target = (r.rand(3, 32, 32, 2) > 0.6).astype(np.float32)
    probs = 1 / (1 + np.exp(-logits[..., :1]))
    assert_close(L.dice_loss_flat(nchw(probs), nchw(target[..., :1])).numpy(),
                 JL.dice_loss_flat(jnp.asarray(probs), jnp.asarray(target[..., :1])),
                 F32_REDUCE, "dice_loss_flat")
    assert_close(L.balanced_dice_loss(nchw(logits), nchw(target)).numpy(),
                 JL.balanced_dice_loss(jnp.asarray(logits), jnp.asarray(target)),
                 F32_REDUCE, "balanced_dice_loss")


def test_watershed_cross_entropy_matches_jax():
    r = np.random.RandomState(2)
    logits = r.randn(2, 24, 24, 2).astype(np.float32) * 4
    target = (r.rand(2, 24, 24, 2) > 0.5).astype(np.float32)
    assert_close(L.watershed_cross_entropy(nchw(logits), nchw(target)).numpy(),
                 JL.watershed_cross_entropy(jnp.asarray(logits), jnp.asarray(target)),
                 F32_REDUCE, "watershed_cross_entropy")


@pytest.mark.parametrize("weight,size_average", [(None, False), (None, True),
                                                 ([0.2, 1.0, 3.0], False)])
def test_cross_entropy2d_matches_jax(weight, size_average):
    r = np.random.RandomState(3)
    logits = r.randn(2, 16, 16, 3).astype(np.float32) * 2
    target = r.randint(-1, 3, (2, 16, 16))  # -1: ignored
    got = L.cross_entropy2d(nchw(logits), torch.from_numpy(target), weight, size_average)
    want = JL.cross_entropy2d(jnp.asarray(logits), jnp.asarray(target), weight, size_average)
    assert_close(got.numpy(), want, F32_REDUCE, "cross_entropy2d")
