"""The port's transform library (``wt_pse_tpu_torch/data/augment_extras.py``)
against the JAX package's ``wt_pse_tpu/data/augment_extras.py``, on the CPU.

Every random op takes JAX's own draws: the test splits each JAX key as the
JAX function does, reads the raw draws from the pieces and hands them to the
port as ``draws=``. Images compare at ``f32_reduce``, masks, gates, boxes and
labels exactly (the elastic transform's mask is resampled bilinearly, a
float field like an image: ``f32_reduce``); ``adjust_light`` floors a power
curve, and its two libraries' f32 ``pow`` may put a value on either side of
an integer: such pixels are counted, held to 1 in 10^3 and to a difference
of 1. The port's own draws
(``generator=``) are checked by their statistics: the gate rates, the range
of gamma, the eraser's area and the crop's area.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from wt_pse_tpu.data import augment_extras as J
from wt_pse_tpu_torch.data import augment_extras as P

from torch_port import F32_REDUCE, assert_close, torch_single_thread  # noqa: F401

KEYS = range(8)


def _u(key, shape=()):
    return np.array(jax.random.uniform(key, shape))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _img(seed, h, w, c=3, scale=1.0):
    return (np.random.RandomState(seed).rand(h, w, c) * scale).astype(np.float32)


def _mask(seed, h, w):
    return (np.random.RandomState(seed + 50).rand(h, w) > 0.5).astype(np.float32)


@pytest.mark.parametrize("seed", KEYS)
def test_salt_pepper_noise(seed):
    key = jax.random.PRNGKey(seed)
    img = _img(seed, 32, 32, scale=0.5) + 0.25
    kmode, kcoord = jax.random.split(key)
    # amount raised from 0.004 so that a 32x32 image takes salt or pepper
    got = P.salt_pepper_noise(_t(img), 0.1, draws=(_u(kmode), _u(kcoord, (32, 32))))
    want = np.asarray(J.salt_pepper_noise(key, jnp.asarray(img), 0.1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", KEYS)
def test_adjust_light(seed):
    key = jax.random.PRNGKey(seed)
    img = np.floor(_img(seed, 64, 64, scale=256.0))
    kseed, kgamma = jax.random.split(key)
    got = P.adjust_light(_t(img), draws=(_u(kseed), _u(kgamma))).numpy()
    want = np.asarray(J.adjust_light(key, jnp.asarray(img)))
    ties = got != want
    assert ties.mean() <= 1e-3, f"{ties.sum()} pixels on the other side of a floor"
    assert np.abs(got - want).max() <= 1.0


@pytest.mark.parametrize("seed", KEYS)
def test_random_eraser(seed):
    key = jax.random.PRNGKey(seed)
    img = _img(seed, 64, 48, scale=255.0)
    kg, ks, kr, kl, kt, kv = jax.random.split(key, 6)
    draws = (_u(kg), _u(ks), _u(kr), np.array(jax.random.randint(kl, (), 0, 48)),
             np.array(jax.random.randint(kt, (), 0, 64)), _u(kv))
    got = P.random_eraser(_t(img), draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.random_eraser(key, jnp.asarray(img))))


@pytest.mark.parametrize("hw,sigma", [((24, 24), 2.0), ((256, 256), 20.48), ((40, 56), 3.2)])
def test_gaussian_blur(hw, sigma):
    x = np.random.RandomState(1).rand(*hw).astype(np.float32) * 2 - 1
    got = P._gaussian_blur_2d(_t(x), sigma).numpy()
    assert_close(got, np.asarray(J._gaussian_blur_2d(jnp.asarray(x), sigma)), F32_REDUCE, "blur")
    assert_close(got, ndi.gaussian_filter(x.astype(np.float64), sigma, mode="constant"),
                 F32_REDUCE, "blur vs scipy")


@pytest.mark.parametrize("seed", KEYS)
def test_elastic_transform(seed):
    key = jax.random.PRNGKey(seed)
    img, mask = _img(seed, 32, 40), _mask(seed, 32, 40)
    kg, kx, ky = jax.random.split(key, 3)
    draws = (_u(kg), _u(kx, (32, 40)), _u(ky, (32, 40)))
    got_i, got_m = P.elastic_transform(_t(img), _t(mask), draws=draws)
    want_i, want_m = J.elastic_transform(key, jnp.asarray(img), jnp.asarray(mask))
    assert_close(got_i.numpy(), want_i, F32_REDUCE, "elastic image")
    assert_close(got_m.numpy(), want_m, F32_REDUCE, "elastic mask (bilinear)")
    img_only, none = P.elastic_transform(_t(img), None, draws=draws)
    assert none is None
    np.testing.assert_array_equal(img_only.numpy(), got_i.numpy())


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("horizontal", [True, False])
def test_random_flip(seed, horizontal):
    key = jax.random.PRNGKey(seed)
    img, mask = _img(seed, 16, 12), _mask(seed, 16, 12)
    got_i, got_m = P.random_flip(_t(img), _t(mask), horizontal, draws=_u(key))
    want_i, want_m = J.random_flip(key, jnp.asarray(img), jnp.asarray(mask), horizontal)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("seed", KEYS)
def test_random_rotate(seed):
    key = jax.random.PRNGKey(seed)
    img, mask = _img(seed, 32, 24), _mask(seed, 32, 24)
    got_i, got_m = P.random_rotate(_t(img), _t(mask), 30.0, draws=_u(key))
    want_i, want_m = J.random_rotate(key, jnp.asarray(img), jnp.asarray(mask), 30.0)
    assert_close(got_i.numpy(), want_i, F32_REDUCE, "rotated image")
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("seed", KEYS)
def test_random_sized_crop(seed):
    key = jax.random.PRNGKey(seed)
    img, mask = _img(seed, 40, 48), _mask(seed, 40, 48)
    draws = tuple(_u(k) for k in jax.random.split(key, 5))
    got_i, got_m = P.random_sized_crop(_t(img), _t(mask), 32, draws=draws)
    want_i, want_m = J.random_sized_crop(key, jnp.asarray(img), jnp.asarray(mask), 32)
    assert_close(got_i.numpy(), want_i, F32_REDUCE, "cropped image")
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_map_coordinates_taps_rounding_and_modes():
    """The hand-written gather against JAX's ``map_coordinates`` where it is
    decided: sources on exact halves (order 0 rounds half away from zero:
    exact), out-of-range taps (constant: each tap, not the sample), clamping
    (nearest), an integer map (the result rounded). Order 1 sums four
    weighted taps, which XLA may contract into fused multiply-adds: within
    ``f32_reduce``."""
    from jax.scipy.ndimage import map_coordinates

    grid = np.arange(-2.5, 9.0, 0.25, dtype=np.float32)
    ys, xs = np.meshgrid(grid, grid[::-1].copy(), indexing="ij")
    x = np.random.RandomState(3).rand(7, 6).astype(np.float32)
    for order in (0, 1):
        for mode in ("constant", "nearest"):
            got = P._map_coordinates(_t(x), (_t(ys), _t(xs)), order, mode).numpy()
            want = np.asarray(map_coordinates(jnp.asarray(x), [ys, xs], order, mode))
            if order == 0:
                np.testing.assert_array_equal(got, want, err_msg=f"order 0 {mode}")
            else:
                assert_close(got, want, F32_REDUCE, f"order 1 {mode}")
                # a tap out of range takes the fill value, its partner keeps its weight
                edge = (ys > -1) & (ys < 0) & (xs > 0) & (xs < 5)
                np.testing.assert_allclose(got[edge], want[edge], rtol=1e-6)
                assert edge.any() and (got[edge] > 0).all()
    xi = np.arange(42, dtype=np.int32).reshape(7, 6)
    got = P._map_coordinates(_t(xi), (_t(ys), _t(xs)), 1, "nearest")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(map_coordinates(jnp.asarray(xi), [ys, xs], 1, "nearest")))


def test_get_boundary():
    m = np.zeros((40, 40, 2), np.float32)
    m[10:30, 8:28, 1] = 1
    m[15:24, 12:22, 0] = 1
    m[0:6, 30:40, 1] = 1  # touches the border
    got = P.get_boundary(_t(m))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.get_boundary(jnp.asarray(m))))
    np.testing.assert_array_equal(P.get_boundary(_t(m), 2).numpy(),
                                  np.asarray(J.get_boundary(jnp.asarray(m), 2)))


@pytest.mark.parametrize("label", ["OC", "OD", None])
def test_normalize_single_label(label):
    img = _img(0, 8, 8, scale=255.0)
    mask = np.array([[0, 50, 51, 128, 200, 201, 255, 30]] * 8, np.uint8)
    got_i, got_m = P.normalize_single_label(_t(img), _t(mask), label)
    want_i, want_m = J.normalize_single_label(jnp.asarray(img), jnp.asarray(mask), label)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_center_crop_and_host_helpers():
    img = _img(0, 20, 17)
    np.testing.assert_array_equal(P.center_crop(_t(img), 9).numpy(),
                                  np.asarray(J.center_crop(jnp.asarray(img), 9)))
    pre = np.random.RandomState(0).randint(0, 3, (6, 5))
    np.testing.assert_array_equal(P.to_multilabel(pre), J.to_multilabel(pre))
    np.testing.assert_array_equal(P.domain_code_one_hot(2, 4), J.domain_code_one_hot(2, 4))


@pytest.mark.parametrize("seed", KEYS)
def test_soft_label(seed):
    key = jax.random.PRNGKey(seed)
    label = np.eye(4, dtype=np.float32)[seed % 4]
    k1, k2 = jax.random.split(key)
    got = P.soft_label(label, draws=(_u(k1), _u(k2, (4,)))).numpy()
    want = np.asarray(J.soft_label(key, label))
    assert_close(got, want, F32_REDUCE, "soft label")
    assert got[seed % 4] == want[seed % 4] and 0.8 <= got[seed % 4] < 1.0


@pytest.mark.parametrize("hw,size", [((32, 32), 48), ((40, 24), 16), ((16, 16), 16)])
def test_fixed_resize(hw, size):
    img = _img(2, *hw, scale=255.0)
    got = P.fixed_resize(_t(img), size)
    assert got.shape == (size, size, 3)
    assert_close(got.numpy(), J.fixed_resize(jnp.asarray(img), size), F32_REDUCE, "resize")


def test_normalizations():
    img = _img(4, 8, 8, scale=255.0)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_array_equal(P.normalize_mean_std(_t(img), mean, std).numpy(),
                                  np.asarray(J.normalize_mean_std(jnp.asarray(img), mean, std)))
    np.testing.assert_array_equal(P.normalize_cityscapes(_t(img), (10.0, 20.0, 30.0)).numpy(),
                                  np.asarray(J.normalize_cityscapes(jnp.asarray(img),
                                                                    (10.0, 20.0, 30.0))))


RANDOM_OPS = {
    "salt_pepper_noise": lambda img, **kw: P.salt_pepper_noise(img, **kw),
    "adjust_light": lambda img, **kw: P.adjust_light(img, **kw),
    "random_eraser": lambda img, **kw: P.random_eraser(img, **kw),
    "elastic_transform": lambda img, **kw: P.elastic_transform(img, None, **kw),
    "random_flip": lambda img, **kw: P.random_flip(img, **kw),
    "random_rotate": lambda img, **kw: P.random_rotate(img, None, **kw),
    "random_sized_crop": lambda img, **kw: P.random_sized_crop(img, None, 8, **kw),
    "soft_label": lambda img, **kw: P.soft_label([0.0, 1.0, 0.0], **kw),
}


@pytest.mark.parametrize("name", sorted(RANDOM_OPS))
def test_a_random_op_needs_draws_or_a_generator(name):
    img = _t(_img(0, 16, 16))
    with pytest.raises(ValueError, match="draws= or generator="):
        RANDOM_OPS[name](img)
    RANDOM_OPS[name](img, generator=torch.Generator().manual_seed(0))


def _rate_ok(hits: int, n: int, p: float) -> bool:
    return abs(hits - n * p) <= 4 * np.sqrt(n * p * (1 - p))


def test_the_ports_own_draws():
    """Gate rates within 4 standard deviations; gamma, eraser and crop areas
    inside their ranges and spread over them."""
    gen = torch.Generator().manual_seed(0)
    n = 400
    flat = torch.full((16, 16, 3), 0.5)
    modes = [P.salt_pepper_noise(flat, 0.5, generator=gen) for _ in range(n)]
    salt = sum(bool((o == 1.0).any()) for o in modes)
    pepper = sum(bool((o == 0.0).any()) for o in modes)
    assert _rate_ok(salt, n, 0.25) and _rate_ok(pepper, n, 0.25), (salt, pepper)

    gray = torch.full((4, 4, 3), 128.0)
    lit = [float(P.adjust_light(gray, generator=gen)[0, 0, 0]) for _ in range(n)]
    changed = [v for v in lit if v != 128.0]
    assert _rate_ok(len(changed), n, 0.5)
    # floor(255 (128/255)^(1/gamma)) over gamma in [0.5, 3.5]: 64 .. 209
    assert min(changed) >= 64 and max(changed) <= 209
    assert min(changed) < 90 and max(changed) > 190

    blank = torch.full((64, 64, 3), -1.0)
    areas = [float((P.random_eraser(blank, generator=gen) != -1.0).any(-1).float().mean())
             for _ in range(n)]
    erased = [a for a in areas if a > 0]
    assert _rate_ok(len(erased), n, 0.5)
    assert min(erased) >= 0.015 and max(erased) <= 0.06
    assert min(erased) < 0.025 and max(erased) > 0.045

    img = torch.rand((16, 16, 3), generator=torch.Generator().manual_seed(1))
    for name, op, p in (("elastic", lambda: P.elastic_transform(img, None, generator=gen)[0], 0.5),
                        ("flip", lambda: P.random_flip(img, p=0.3, generator=gen)[0], 0.3)):
        hits = sum(not torch.equal(op(), img) for _ in range(n))
        assert _rate_ok(hits, n, p), (name, hits)

    # a map of its own coordinates shows the crop's box: the sources reach
    # both edges of the box, and a bilinear sample of a ramp is the ramp
    h, w = 40, 48
    ramp = torch.stack(torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                       torch.arange(w, dtype=torch.float32), indexing="ij"), -1)
    fractions, inside = [], []
    for _ in range(n):
        out, _ = P.random_sized_crop(ramp, None, 64, generator=gen)
        bh = float(out[..., 0].max() - out[..., 0].min()) + 1
        bw = float(out[..., 1].max() - out[..., 1].min()) + 1
        fractions.append(bh * bw / (h * w))
        if bh < h and bw < w:  # not clamped into the image
            inside.append(fractions[-1])
    assert max(fractions) <= 1.0 and len(inside) > n // 4
    assert min(inside) >= 0.43 and min(inside) < 0.55 and max(inside) > 0.85
