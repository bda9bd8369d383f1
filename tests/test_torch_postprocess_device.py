"""The port's post-processing on the device (``wt_pse_tpu_torch/ops/
postprocess_device.py``) against the JAX package's and scipy, on the CPU, on
numpy masks from a seed. Every comparison is exact: ids, masks and counts are
integers.

- component ids equal the JAX ids; counts and partitions equal scipy's;
- the largest component and the hole fill equal JAX and scipy;
- a serpentine whose geodesic length exceeds H + W gives the JAX package's
  capped result (not scipy's), for the labelling and for the hole fill;
- checking for convergence every 16 (or 5) iterations gives what a check
  every iteration gives, capped or converged.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from wt_pse_tpu.ops import postprocess_device as JPD
from wt_pse_tpu_torch.ops import postprocess as PP
from wt_pse_tpu_torch.ops import postprocess_device as PD

from torch_port import torch_single_thread  # noqa: F401

EIGHT = np.ones((3, 3), int)


def _blobs(seed, b=3, hw=48, n=4):
    r = np.random.RandomState(seed)
    m = np.zeros((b, hw, hw), bool)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(b):
        for _ in range(n):
            cy, cx = r.randint(5, hw - 5, 2)
            rad = r.randint(2, 8)
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
    m[0, 20:23, 20:23] = False  # a hole, if a blob covers it
    return m


def _serpentine(hw=34):
    """A one-pixel path through the interior, rows joined at alternate ends:
    about hw^2 / 2 pixels long, far over H + W."""
    m = np.zeros((hw, hw), bool)
    for k, y in enumerate(range(1, hw - 1, 2)):
        m[y, 1:hw - 1] = True
        if y + 1 < hw - 1:
            m[y + 1, hw - 2 if k % 2 == 0 else 1] = True
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_label_components_match_jax_and_scipy(seed):
    m = _blobs(seed)
    got = PD.label_components(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JPD.label_components(jnp.asarray(m))))
    for i in range(len(m)):
        lab, n = ndi.label(m[i], structure=EIGHT)
        ids = np.unique(got[i][m[i]])
        assert len(ids) == n and (got[i][~m[i]] == 0).all()
        for d in ids:  # the same partition
            assert len(np.unique(lab[got[i] == d])) == 1


@pytest.mark.parametrize("seed", [2, 3])
def test_largest_component_and_fill_holes_match_jax_and_scipy(seed):
    m = _blobs(seed)
    lcc = PD.largest_component(torch.from_numpy(m))
    np.testing.assert_array_equal(lcc.numpy(), np.asarray(JPD.largest_component(jnp.asarray(m))))
    filled = PD.fill_holes(lcc).numpy()
    np.testing.assert_array_equal(filled, np.asarray(JPD.fill_holes(jnp.asarray(lcc.numpy()))))
    for i in range(len(m)):
        np.testing.assert_array_equal(filled[i], PP.largest_component_fill_holes_scipy(m[i]))
    # equal areas: the lowest id wins, as in JAX
    tie = np.zeros((1, 10, 10), bool)
    tie[0, 1:3, 1:3] = tie[0, 6:8, 6:8] = True
    np.testing.assert_array_equal(PD.largest_component(torch.from_numpy(tie)).numpy(),
                                  np.asarray(JPD.largest_component(jnp.asarray(tie))))


def test_postprocess_logits_device_matches_jax_and_the_host():
    r = np.random.RandomState(4)
    logits = r.randn(2, 40, 40).astype(np.float32) * 3
    yy, xx = np.mgrid[0:40, 0:40]
    logits[0][(yy - 20) ** 2 + (xx - 20) ** 2 < 64] = 8.0
    got = PD.postprocess_logits_device(torch.from_numpy(logits)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(JPD.postprocess_logits_device(jnp.asarray(logits))))
    for i in range(2):
        np.testing.assert_array_equal(got[i], PP.postprocess_logits(logits[i][None], backend="scipy")[0])


def test_a_path_longer_than_the_cap_gives_the_jax_capped_result():
    path = _serpentine()[None]
    got = PD.label_components(torch.from_numpy(path)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JPD.label_components(jnp.asarray(path))))
    assert len(np.unique(got[path])) > 1  # capped: scipy sees one component
    assert ndi.label(path[0], structure=EIGHT)[1] == 1
    # a background corridor from the border along the path: past the cap its
    # far end reads as a hole and is filled, as the JAX flood does
    mask = ~path
    mask[0, 1, 0] = False  # the corridor's mouth on the border
    filled = PD.fill_holes(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(filled, np.asarray(JPD.fill_holes(jnp.asarray(mask))))
    assert filled.sum() > ndi.binary_fill_holes(mask[0]).sum()


@pytest.mark.parametrize("max_iters", [None, 40, 200])
def test_chunked_convergence_check_equals_a_check_every_iteration(max_iters):
    m = torch.from_numpy(np.concatenate([_blobs(5, b=2), _serpentine(48)[None]]))
    every = PD.label_components(m, max_iters=max_iters, check_every=1)
    for k in (5, 16):
        assert torch.equal(PD.label_components(m, max_iters=max_iters, check_every=k), every)


def test_more_than_2_pow_24_pixels_raise():
    with pytest.raises(ValueError, match="2\\^24"):
        PD.label_components(torch.zeros((1, 4097, 4096), dtype=torch.bool))
