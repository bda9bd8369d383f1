"""The port's device augmentation (``wt_pse_tpu_torch/data/augment.py``) against
the JAX package's ``wt_pse_tpu/data/augment.py``, on the CPU.

The two packages draw different random numbers, so the crop draws
``(sh, sw, oy, ox)`` and the sampling indices are injected; the port's own
draws are checked by their statistics. Interpolation matrices within 1e-7 and
nearest indices identical; augmented images at ``f32_reduce``; masks exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.data import augment as A
from wt_pse_tpu_torch.data import augment as P

from torch_port import F32_REDUCE, assert_close, nhwc, torch_single_thread  # noqa: F401

HIGHEST = jax.lax.Precision.HIGHEST
# (scaled, offset) at 256: identity, the extremes, and a spread between
GRID = [(256, 0), (383, 127), (383, 0), (256 + 1, 1), (300, 44), (320, 37), (341, 85),
        (270, 3), (367, 100), (299, 13), (384 - 2, 126), (257, 0)]


def test_axis_matrices_match_jax():
    scaled = torch.tensor([s for s, _ in GRID], dtype=torch.float32)
    offset = torch.tensor([o for _, o in GRID], dtype=torch.float32)
    got_b, got_n = P.axis_matrices(scaled, offset, 256)
    for i, (s, o) in enumerate(GRID):
        want_b, want_n = A._axis_matrices(jnp.asarray(float(s)), jnp.asarray(float(o)), 256)
        np.testing.assert_allclose(got_b[i].numpy(), np.asarray(want_b), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(got_n[i].numpy().argmax(1), np.asarray(want_n).argmax(1))
        np.testing.assert_array_equal(got_n[i].numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_b[0].numpy(), np.eye(256, dtype=np.float32))


def _jax_augment(img_u8, lab_u8, draws, size):
    """The JAX version's ``_augment_one`` and ``normalize_tf`` on given draws."""
    images, od, oc = [], [], []
    for b in range(img_u8.shape[0]):
        sh, sw, oy, ox = (jnp.asarray(float(d[b])) for d in draws)
        mh_b, mh_n = A._axis_matrices(sh, oy, size)
        mw_b, mw_n = A._axis_matrices(sw, ox, size)
        img = jnp.asarray(img_u8[b], jnp.float32)
        lab = jnp.asarray(lab_u8[b], jnp.float32)
        img = jnp.einsum("ph,hwc->pwc", mh_b, img, precision=HIGHEST)
        img = jnp.einsum("qw,pwc->pqc", mw_b, img, precision=HIGHEST)
        lab = jnp.einsum("ph,hw->pw", mh_n, lab, precision=HIGHEST)
        lab = jnp.einsum("qw,pw->pq", mw_n, lab, precision=HIGHEST)
        i, o, c = A.normalize_tf(img, lab)
        images.append(np.asarray(i))
        od.append(np.asarray(o))
        oc.append(np.asarray(c))
    return np.stack(images), np.stack(od), np.stack(oc)


@pytest.mark.parametrize("size", [32, 64])
def test_augment_batch_with_injected_draws_matches_jax(size):
    r = np.random.RandomState(size)
    b = 6
    img = (r.rand(b, size, size, 3) * 255).astype(np.uint8)
    lab = r.choice([0, 128, 255], size=(b, size, size)).astype(np.uint8)
    sh = np.array([size, size + 1, size * 3 // 2 - 1, size + 7, size + 3, size], np.float32)
    sw = np.array([size, size * 3 // 2 - 1, size + 5, size + 2, size + 9, size + 1], np.float32)
    oy = np.floor(r.rand(b) * (sh - size + 1)).astype(np.float32)
    ox = np.floor(r.rand(b) * (sw - size + 1)).astype(np.float32)
    draws = (sh, sw, oy, ox)
    got = P.augment_batch(torch.from_numpy(img), torch.from_numpy(lab),
                          draws=tuple(torch.from_numpy(d) for d in draws))
    want_img, want_od, want_oc = _jax_augment(img, lab, draws, size)
    assert got["image"].shape == (b, 3, size, size)
    assert got["target_od"].shape == got["target_oc"].shape == (b, 1, size, size)
    assert_close(nhwc(got["image"]), want_img, F32_REDUCE, "augmented image")
    np.testing.assert_array_equal(nhwc(got["target_od"]), want_od)
    np.testing.assert_array_equal(nhwc(got["target_oc"]), want_oc)
    # the identity draw leaves the first sample untouched
    np.testing.assert_array_equal(nhwc(got["image"])[0], img[0] / np.float32(127.5) - 1)


def test_normalize_tf_matches_jax():
    lab = np.array([[[0.0, 50.0, 51.0, 128.0, 200.0, 201.0, 255.0]]], np.float32)
    img = np.random.RandomState(0).rand(1, 3, 1, 7).astype(np.float32) * 255
    got = P.normalize_tf(torch.from_numpy(img), torch.from_numpy(lab))
    want = A.normalize_tf(jnp.asarray(nhwc(torch.from_numpy(img))), jnp.asarray(lab))
    np.testing.assert_array_equal(nhwc(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(nhwc(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(nhwc(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].flatten().numpy(), [1, 1, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(got[2].flatten().numpy(), [1, 1, 0, 0, 0, 0, 0])


def test_sample_domain_batch_layout_matches_jax(monkeypatch):
    """The same raw indices through the port and through the JAX function (its
    ``randint`` replaced by those indices): the same domain-contiguous batch."""
    r = np.random.RandomState(3)
    d, nmax, pdb, hw = 3, 5, 4, 8
    images = r.randint(0, 256, size=(d, nmax, hw, hw, 3)).astype(np.uint8)
    labels = r.randint(0, 256, size=(d, nmax, hw, hw)).astype(np.uint8)
    sizes = np.array([5, 2, 3])
    gen = torch.Generator().manual_seed(9)
    raw = torch.randint(0, 2 ** 31 - 1, (d, pdb), generator=torch.Generator().manual_seed(9))
    got_img, got_lab = P.sample_domain_batch(torch.from_numpy(images), torch.from_numpy(labels),
                                             torch.from_numpy(sizes), pdb, gen)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(raw.numpy(), jnp.int32))
    want_img, want_lab = A.sample_domain_batch(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(sizes, jnp.int32), pdb)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    # domain-contiguous: rows [k*pdb, (k+1)*pdb) come from domain k's first sizes[k]
    for k in range(d):
        pool = images[k, :sizes[k]].reshape(sizes[k], -1)
        for row in got_img[k * pdb:(k + 1) * pdb].reshape(pdb, -1).numpy():
            assert (pool == row).all(1).any()


def test_draw_statistics():
    n, size = 4096, 256
    sh, sw, oy, ox = P.sample_params(n, size, torch.Generator().manual_seed(0),
                                     torch.device("cpu"))
    applied = (sh != size) | (sw != size)
    # a draw of exactly 1.0x (U < 1/512) is applied yet keeps the size: rare
    assert abs(float(applied.float().mean()) - 0.5) <= 0.03
    for s, o in ((sh, oy), (sw, ox)):
        assert float(s.min()) >= size and float(s.max()) < 1.5 * size
        assert float(o.min()) >= 0 and bool((o <= s - size).all())
        assert bool((s == torch.floor(s)).all() and (o == torch.floor(o)).all())
    assert bool(((sh == size) == (sw == size))[~applied].all())
    assert float(sh[applied].max()) > 1.45 * size and float(ox[applied].max()) > 100


def test_same_generator_seed_gives_the_same_batch():
    r = np.random.RandomState(1)
    data = {"images": torch.from_numpy(r.randint(0, 256, (3, 4, 32, 32, 3)).astype(np.uint8)),
            "labels": torch.from_numpy(r.choice([0, 128, 255], (3, 4, 32, 32)).astype(np.uint8)),
            "sizes": torch.tensor([4, 3, 2])}
    fn = P.make_device_batch_fn(2, device="cpu")
    a = fn(data, torch.Generator().manual_seed(5))
    b = fn(data, torch.Generator().manual_seed(5))
    c = fn(data, torch.Generator().manual_seed(6))
    assert a["image"].shape == (6, 3, 32, 32)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["image"], c["image"])
