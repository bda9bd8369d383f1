"""The reference's wider transform library on the device (counterpart of
``wt_pse_tpu/data/augment_extras.py``, in the order of that file).

The reference ships more transforms than its active pipeline uses
(``custom_transforms.py``): salt and pepper noise, a gamma ``adjust_light``,
a random eraser, Simard's elastic transform, flips, rotations, sized crops,
resizes, label helpers. Each op here takes one image as JAX's does, an
(H, W, C) float tensor (masks (H, W)), and runs on the tensor's device. The
reference's probability gates are inside the ops.

Every division by a constant divides by an f32 tensor: CUDA divides by a
Python scalar as a product with its reciprocal, which may round otherwise
than the CPU's (and JAX's) division, and a floor or a rounding downstream
would amplify that last bit.

Randomness: a random op takes ``generator=`` (a ``torch.Generator`` on the
tensor's device) or ``draws=``, the raw draws of JAX's version in the order of
its key splits (each op's docstring lists them), and raises if given
neither. A uniform draw is the raw U[0, 1) value, and the op maps it to its
range as ``jax.random.uniform`` does (``max(lo, u * (hi - lo) + lo)`` in
f32), so the same draws give JAX's result.

JAX's ``map_coordinates`` (used by the elastic transform, the rotation and
the sized crop) is written out by hand in :func:`_map_coordinates`: with
``order=1, mode='constant'`` each out-of-range tap, not the whole sample,
takes the fill value; ``order=0`` rounds half away from zero; ``mode=
'nearest'`` clamps the index. ``F.grid_sample`` rounds half to even and moves
the coordinates by normalising them, so it is not used.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from wt_pse_tpu_torch.train.eval import resize_device


def _need(draws, generator, what: str, make):
    """``draws`` if given, else ``make()`` from ``generator``."""
    if draws is not None:
        return draws
    if generator is None:
        raise ValueError(f"{what} needs draws= or generator=")
    return make()


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _between(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A raw U[0, 1) draw mapped to [lo, hi) as ``jax.random.uniform`` maps it."""
    lo_t, hi_t = _f32(lo, u.device), _f32(hi, u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def salt_pepper_noise(img: torch.Tensor, amount: float = 0.004, salt_vs_pepper: float = 0.2,
                      *, generator: torch.Generator | None = None, draws=None) -> torch.Tensor:
    """custom_transforms.py:22-43: with p=0.25 salt (set to 1), p=0.25 pepper
    (set to 0), p=0.5 unchanged. ``img`` is (H, W, C). Draws: the mode's
    uniform, then an (H, W) uniform that picks the pixels."""
    h, w, _ = img.shape
    dev = img.device
    seed, u = _need(draws, generator, "salt_pepper_noise", lambda: (
        torch.rand((), generator=generator, device=dev),
        torch.rand((h, w), generator=generator, device=dev)))
    seed, u = _f32(seed, dev), _f32(u, dev)
    frac_salt = _f32(amount * salt_vs_pepper * 3, dev)  # .size counts channels in the ref
    frac_pepper = _f32(amount * (1 - salt_vs_pepper) * 3, dev)
    salted = torch.where((u < frac_salt)[..., None], 1.0, img)
    peppered = torch.where((u < frac_pepper)[..., None], 0.0, img)
    return torch.where(seed > 0.75, salted, torch.where(seed > 0.5, peppered, img))


def adjust_light(img_255: torch.Tensor, *, generator: torch.Generator | None = None,
                 draws=None) -> torch.Tensor:
    """custom_transforms.py:45-55: with p=0.5 a gamma in [0.5, 3.5] (the
    reference's uint8 lookup table is the power curve, floored). Draws: the
    gate's uniform, then the gamma's."""
    dev = img_255.device
    seed, u = _need(draws, generator, "adjust_light", lambda: (
        torch.rand((), generator=generator, device=dev),
        torch.rand((), generator=generator, device=dev)))
    seed, gamma = _f32(seed, dev), _f32(u, dev) * 3 + 0.5
    out = torch.floor(((img_255 / _f32(255.0, dev)) ** (1.0 / gamma)) * 255.0)
    return torch.where(seed > 0.5, out, img_255)


def random_eraser(img: torch.Tensor, s_l: float = 0.02, s_h: float = 0.06, r_1: float = 0.3,
                  r_2: float = 0.6, v_l: float = 0.0, v_h: float = 255.0, *,
                  generator: torch.Generator | None = None, draws=None) -> torch.Tensor:
    """custom_transforms.py:58-85: with p=0.5 one rectangle of area fraction
    in [s_l, s_h) and aspect in [r_1, r_2) takes a constant in [v_l, v_h).
    The reference rejection-samples until the box fits; JAX clamps the box
    into the image, and so does this. Draws: the gate's, the area's and the
    aspect's uniforms, the left and top integers (in [0, W) and [0, H)), the
    value's uniform."""
    h, w, _ = img.shape
    dev = img.device

    def make():
        u = [torch.rand((), generator=generator, device=dev) for _ in range(3)]
        left = torch.randint(0, w, (), generator=generator, device=dev)
        top = torch.randint(0, h, (), generator=generator, device=dev)
        return (*u, left, top, torch.rand((), generator=generator, device=dev))

    u_g, u_s, u_r, left, top, u_v = _need(draws, generator, "random_eraser", make)
    apply = _f32(u_g, dev) > 0.5
    s = _between(_f32(u_s, dev), s_l, s_h) * h * w
    r = _between(_f32(u_r, dev), r_1, r_2)
    bw = torch.sqrt(s / r).to(torch.int32)  # truncation, as JAX's astype
    bh = torch.sqrt(s * r).to(torch.int32)
    left = torch.minimum(torch.as_tensor(left, dtype=torch.int32, device=dev), w - bw)
    top = torch.minimum(torch.as_tensor(top, dtype=torch.int32, device=dev), h - bh)
    v = _between(_f32(u_v, dev), v_l, v_h)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inside = (yy >= top) & (yy < top + bh) & (xx >= left) & (xx < left + bw)
    out = torch.where(inside[..., None], v, img)
    return torch.where(apply, out, img)


def _gaussian_blur_2d(x: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian filter of an (H, W) map with zero ('constant')
    padding, scipy's ``gaussian_filter``. Each pass is a product with a banded
    (n, n) matrix of the taps: f32 sums (TF32 is off for matmuls unless a
    caller turns it on), where a cuDNN conv would take TF32 by default."""
    radius = int(truncate * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / _f32(sigma, x.device)) ** 2)
    k = k / k.sum()

    def band(n: int) -> torch.Tensor:  # band[i, j] = k[j - i + radius]
        idx = torch.arange(n, device=x.device)
        d = idx[None, :] - idx[:, None] + radius
        return torch.where((d >= 0) & (d <= 2 * radius), k[d.clamp(0, 2 * radius)], 0.0)

    h, w = x.shape
    return torch.matmul(torch.matmul(band(h), x), band(w).T)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, ties away from zero (``lax.round``)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), torch.round(x))


def _map_coordinates(inp: torch.Tensor, coords, order: int, mode: str,
                     cval: float = 0.0) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates`` of an (H, W) or (H, W, C) map at
    ``coords = (ys, xs)`` (each of the output's shape), over the first two
    axes, for ``order`` 0 or 1 and ``mode`` 'constant' or 'nearest': the
    taps, weights, per-tap validity and the sum in JAX's order."""
    nodes = []
    for coord, size in zip(coords, inp.shape[:2]):
        if order == 0:
            taps = [(_round_half_away(coord).to(torch.int64), None)]
        else:
            lower = torch.floor(coord)
            upper_w = coord - lower
            index = lower.to(torch.int64)
            taps = [(index, 1 - upper_w), (index + 1, upper_w)]
        nodes.append([(i.clamp(0, size - 1), (i >= 0) & (i < size) if mode == "constant" else None,
                       wt) for i, wt in taps])
    chan = (lambda t: t[..., None]) if inp.dim() == 3 else (lambda t: t)
    out = None
    for (iy, vy, wy), (ix, vx, wx) in itertools.product(*nodes):
        val = inp[iy, ix]
        if vy is not None:
            val = torch.where(chan(vy & vx), val, torch.as_tensor(cval, dtype=inp.dtype,
                                                                  device=inp.device))
        if wy is not None:
            val = chan(wy * wx) * val
        out = val if out is None else out + val
    if out.dtype.is_floating_point and not inp.dtype.is_floating_point:
        out = _round_half_away(out)
    return out.to(inp.dtype)


def elastic_transform(img: torch.Tensor, mask: torch.Tensor | None,
                      alpha: float | None = None, sigma: float | None = None, *,
                      generator: torch.Generator | None = None, draws=None):
    """Simard 2003 (custom_transforms.py:87-132): with p=0.5 a displacement
    field ``gaussian_filter(U(-1, 1), sigma) * alpha`` (alpha = 2 H, sigma =
    0.08 H), the image resampled bilinearly with zero fill, the mask
    bilinearly with the edge clamped. Returns (image, mask or None). Draws:
    the gate's uniform, then two (H, W) uniforms (rows' displacement, then
    columns')."""
    h, w = img.shape[:2]
    dev = img.device
    alpha = float(2 * h) if alpha is None else alpha
    sigma = float(0.08 * h) if sigma is None else sigma
    u_g, ux, uy = _need(draws, generator, "elastic_transform", lambda: (
        torch.rand((), generator=generator, device=dev),
        torch.rand((h, w), generator=generator, device=dev),
        torch.rand((h, w), generator=generator, device=dev)))
    apply = _f32(u_g, dev) > 0.5
    dx = _gaussian_blur_2d(_f32(ux, dev) * 2 - 1, sigma) * alpha
    dy = _gaussian_blur_2d(_f32(uy, dev) * 2 - 1, sigma) * alpha
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    coords = (yy + dx, xx + dy)  # the reference displaces axis 0 by dx (rand_x)
    out_img = torch.where(apply, _map_coordinates(img, coords, 1, "constant"), img)
    if mask is None:
        return out_img, None
    return out_img, torch.where(apply, _map_coordinates(mask, coords, 1, "nearest"), mask)


def random_flip(img: torch.Tensor, mask: torch.Tensor | None = None, horizontal: bool = True,
                p: float = 0.5, *, generator: torch.Generator | None = None, draws=None):
    """RandomFlip (custom_transforms.py:179-204 family): with probability
    ``p`` flip the columns (``horizontal``) or the rows. Returns (image, mask
    or None). Draws: the gate's uniform."""
    dev = img.device
    u = _need(draws, generator, "random_flip",
              lambda: torch.rand((), generator=generator, device=dev))
    apply = _f32(u, dev) < p
    axis = 1 if horizontal else 0
    flip = lambda a: torch.where(apply, a.flip(axis), a)
    return flip(img), None if mask is None else flip(mask)


def random_rotate(img: torch.Tensor, mask: torch.Tensor | None, degree: float = 15.0, *,
                  generator: torch.Generator | None = None, draws=None):
    """RandomRotate: an angle uniform in [-degree, degree) about the centre,
    the image bilinear and the mask nearest, both with zero fill. Returns
    (image, mask or None). Draws: the angle's uniform."""
    h, w = img.shape[:2]
    dev = img.device
    u = _need(draws, generator, "random_rotate",
              lambda: torch.rand((), generator=generator, device=dev))
    theta = _between(_f32(u, dev), -degree, degree) * np.pi / _f32(180.0, dev)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    cos, sin = torch.cos(theta), torch.sin(theta)
    ys = cy + (yy - cy) * cos - (xx - cx) * sin
    xs = cx + (yy - cy) * sin + (xx - cx) * cos
    out = _map_coordinates(img, (ys, xs), 1, "constant")
    if mask is None:
        return out, None
    return out, _map_coordinates(mask, (ys, xs), 0, "constant")


def random_sized_crop(img: torch.Tensor, mask: torch.Tensor | None, size: int, *,
                      generator: torch.Generator | None = None, draws=None):
    """RandomSizedCrop (custom_transforms.py:267-327): a box of area in
    [0.45, 1) of the image and aspect in [0.5, 2) (sides swapped with p=0.5),
    resized to ``size`` (the image bilinear, the mask nearest, PIL's
    half-pixel sources clamped to the box). The reference rejection-samples
    the box and falls back to a centre crop; JAX rounds the sides, then clamps
    them into the image, and so does this. Returns (image, mask or None).
    Draws: the area's, the aspect's, the swap's, the left's and the top's
    uniforms."""
    h, w = img.shape[:2]
    dev = img.device
    u_a, u_r, u_s, u_x, u_y = (_f32(u, dev) for u in _need(
        draws, generator, "random_sized_crop",
        lambda: [torch.rand((), generator=generator, device=dev) for _ in range(5)]))
    target_area = _between(u_a, 0.45, 1.0) * (h * w)
    aspect = _between(u_r, 0.5, 2.0)
    bw = torch.round(torch.sqrt(target_area * aspect))  # half to even, as jnp.round
    bh = torch.round(torch.sqrt(target_area / aspect))
    swap = u_s < 0.5
    bw, bh = torch.where(swap, bh, bw), torch.where(swap, bw, bh)
    bw = torch.clamp(bw, 1, w)
    bh = torch.clamp(bh, 1, h)
    x1 = torch.floor(u_x * (w - bw + 1))
    y1 = torch.floor(u_y * (h - bh + 1))

    def src(box_len, box_off, in_len):  # clamped to the box, then to the image
        s = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) * (
            box_len / _f32(size, dev)) - 0.5
        s = torch.clamp(s, torch.zeros_like(box_len), box_len - 1.0)
        return torch.clamp(s + box_off, 0.0, in_len - 1.0)

    coords = torch.meshgrid(src(bh, y1, h), src(bw, x1, w), indexing="ij")
    out = _map_coordinates(img, coords, 1, "nearest")
    if mask is None:
        return out, None
    return out, _map_coordinates(mask, coords, 0, "nearest")


def _binary_morph_cross(m: torch.Tensor, iterations: int, dilate: bool) -> torch.Tensor:
    """scipy's binary dilation / erosion with the 4-connected cross, iterated,
    with a zero border."""
    m = m > 0.5
    h, w = m.shape
    for _ in range(iterations):
        pad = torch.zeros((h + 2, w + 2), dtype=torch.bool, device=m.device)
        pad[1:-1, 1:-1] = m
        n = (pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:])
        if dilate:
            m = m | n[0] | n[1] | n[2] | n[3]
        else:
            m = m & n[0] & n[1] & n[2] & n[3]
    return m


def get_boundary(mask_2ch: torch.Tensor, width: int = 5) -> torch.Tensor:
    """GetBoundary (custom_transforms.py:435-452): each class's band,
    dilation XOR erosion ``width`` times, of the (H, W, 2) [cup, disc] mask;
    the union as uint8 (H, W)."""
    bands = []
    for m in (mask_2ch[..., 0], mask_2ch[..., 1]):
        bands.append(_binary_morph_cross(m, width, True) ^ _binary_morph_cross(m, width, False))
    return (bands[0] | bands[1]).to(torch.uint8)


def normalize_single_label(img_255: torch.Tensor, mask_u8, label: str | None = None):
    """Normalize_single_label (custom_transforms.py:501-538): the image / 127.5
    - 1; the mask re-encoded to the 255/128/0 gray levels (> 200 background,
    50 < v < 201 disc, else cup) and binarised by ``label``: OC the cup, OD
    the disc and cup, None the raw values (the reference touches the mask
    only under OC and OD). Returns (image, (H, W, 1) mask)."""
    img = img_255 / _f32(127.5, img_255.device) - 1.0
    m = torch.as_tensor(mask_u8, device=img_255.device)
    enc = torch.where(m > 200, 255, torch.where((m > 50) & (m < 201), 128, 0))
    if label == "OC":
        out = (enc == 0).to(torch.float32)
    elif label == "OD":
        out = (enc < 255).to(torch.float32)
    else:
        out = m.to(torch.float32)
    return img, out[..., None]


def center_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    """CenterCrop (custom_transforms.py:179-204)."""
    h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top:top + size, left:left + size]


def to_multilabel(pre_mask, classes: int = 2) -> np.ndarray:
    """fundus_dataloader.py:10-14: 1 -> [0, 1] (disc only), 2 -> [1, 1] (cup
    and disc). A host helper, as in the JAX package."""
    mask = np.zeros((pre_mask.shape[0], pre_mask.shape[1], classes))
    mask[pre_mask == 1] = [0, 1]
    mask[pre_mask == 2] = [1, 1]
    return mask


def domain_code_one_hot(dc: int, num: int = 3) -> np.ndarray:
    """custom_transforms.ToMultiLabel (559-564). A host helper."""
    out = np.zeros([num])
    out[dc] = 1
    return out


def soft_label(label, *, generator: torch.Generator | None = None,
               draws=None) -> torch.Tensor:
    """custom_transforms.SoftLable (566-579): the one-hot domain code jittered
    into a soft distribution, the hot entry in [0.8, 1.0). Runs where
    ``label`` lies (a list or array: the CPU). Draws: the hot entry's
    uniform, then one uniform an entry."""
    label = torch.as_tensor(label, dtype=torch.float32)
    dev = label.device
    u1, u2 = _need(draws, generator, "soft_label", lambda: (
        torch.rand((), generator=generator, device=dev),
        torch.rand(label.shape, generator=generator, device=dev)))
    hot = torch.argmax(label)
    main = 0.8 + _f32(u1, dev) * 0.2
    rest = _f32(u2, dev) * (label == 0)
    rest = rest / torch.clamp(rest.sum(), min=1e-9) * (1.0 - main)
    rest[hot] = main
    return rest


def fixed_resize(img: torch.Tensor, size: int) -> torch.Tensor:
    """FixedResize / Scale / ResizeImg: a half-pixel bilinear square resize of
    an (H, W, C) image, the port's resize matrices (``train/eval.py``), H then
    W, as JAX's ``resize_bilinear``."""
    return resize_device(img.permute(2, 0, 1), (size, size)).permute(1, 2, 0)


def normalize_mean_std(img: torch.Tensor, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0)):
    """custom_transforms.Normalize (413-432): / 255, - mean, / std."""
    return (img / _f32(255.0, img.device) - _f32(mean, img.device)) / _f32(std, img.device)


def normalize_cityscapes(img: torch.Tensor, mean=(0.0, 0.0, 0.0)):
    """custom_transforms.Normalize_cityscapes (540-557): - mean, / 255."""
    return (img - _f32(mean, img.device)) / _f32(255.0, img.device)
