"""The validation montage (the port's own copy of
``wt_pse_tpu/utils/visualization.py:19-164``): contour overlays and the
4-panel image grid of ``utils.py:330-363`` in the reference, and the
evaluation CLI's per-image pair (``save_per_img``, ``utils.py:371-454``). PIL
is imported only where an image is written.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.ndimage as ndi


def mask_boundary(mask: np.ndarray, width: int = 2) -> np.ndarray:
    """Boundary pixels of a binary mask (mask minus its erosion), thickened."""
    mask = np.asarray(mask) > 0.5
    er = ndi.binary_erosion(mask, iterations=width)
    return mask & ~er


def find_contour_points(arr: np.ndarray, level: float = 0.5) -> np.ndarray:
    """Sub-pixel iso-``level`` contour vertices of a 2-D array: the point set
    of ``skimage.measure.find_contours(arr, level)`` (``utils.py:404-405``).

    Every vertex lies on a grid edge whose two samples fall on either side of
    the level, linearly interpolated along it. The reference only indexes the
    vertices, so the unordered set is all that reaches the output. Returns
    (N, 2) float64 ``(row, col)`` points.
    """
    a = np.asarray(arr, np.float64)
    below = a < level
    pts = []
    cross = below[:, :-1] != below[:, 1:]  # edges between columns: row integral
    if cross.any():
        rr, cc = np.nonzero(cross)
        frac = (level - a[rr, cc]) / (a[rr, cc + 1] - a[rr, cc])
        pts.append(np.stack([rr.astype(np.float64), cc + frac], axis=1))
    cross = below[:-1, :] != below[1:, :]  # edges between rows: column integral
    if cross.any():
        rr, cc = np.nonzero(cross)
        frac = (level - a[rr, cc]) / (a[rr + 1, cc] - a[rr, cc])
        pts.append(np.stack([rr + frac, cc.astype(np.float64)], axis=1))
    if not pts:
        return np.zeros((0, 2), np.float64)
    return np.concatenate(pts, axis=0)


# the reference's 7-tap thickening stencil (utils.py:408-421), int-truncated
_STENCIL = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0),
            (-1.0, 0.0), (-1.0, -1.0), (0.0, -1.0))


def _paint_points(out: np.ndarray, pts: np.ndarray, color) -> None:
    """Paint contour vertices with the stencil. Negative indices wrap to the
    far edge, as numpy indexing does in the reference; taps past the high
    edge are dropped."""
    if not len(pts):
        return
    h, w = out.shape[:2]
    for dr, dc in _STENCIL:
        rr = (pts[:, 0] + dr).astype(int)
        cc = (pts[:, 1] + dc).astype(int)
        keep = (rr < h) & (cc < w) & (rr >= -h) & (cc >= -w)
        out[rr[keep], cc[keep]] = color


def untransform(img: np.ndarray) -> np.ndarray:
    """Invert Normalize_tf on an image (utils.py:30-34): (x + 1) * 127.5."""
    return np.clip((np.asarray(img, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def overlay_contours(image_u8: np.ndarray, pred_2ch: np.ndarray,
                     gt_2ch: np.ndarray) -> np.ndarray:
    """image (H, W, 3) uint8; pred / gt (2, H, W) binary, [0] = cup, [1] = disc.

    As the reference draws it (utils.py:385-450): the prediction maps get a
    zeroed border ring, the disc contour is painted green and the cup contour
    blue, then the GT contours red, through largest CC + fill holes."""
    from wt_pse_tpu_torch.ops.postprocess import largest_component_fill_holes

    out = image_u8.copy()

    def bordered(m):
        m = np.asarray(m, np.float64).copy()
        m[:, 0] = m[:, -1] = 0.0
        m[0, :] = m[-1, :] = 0.0
        return m

    _paint_points(out, find_contour_points(bordered(pred_2ch[1])), [0, 255, 0])
    _paint_points(out, find_contour_points(bordered(pred_2ch[0])), [0, 0, 255])
    for ch in (0, 1):
        gt = largest_component_fill_holes(np.asarray(gt_2ch[ch]) > 0.5)
        _paint_points(out, find_contour_points(gt.astype(np.float64)), [255, 0, 0])
    return out


def joint_val_image(image: np.ndarray, pred_2ch: np.ndarray,
                    mask_2ch: np.ndarray, ratio: float = 0.5) -> np.ndarray:
    """The 4-panel montage ``[image | mask overlay | cup-pred overlay |
    disc-pred overlay]`` (``utils.py:330-351``). ``image`` is (H, W, 3) float
    in [-1, 1]; ``pred_2ch`` / ``mask_2ch`` are (2, H, W) binary with
    [0] = cup, [1] = disc. Returns (H, 4W, 3) float."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    pred = np.asarray(pred_2ch, np.float32)
    mask = np.asarray(mask_2ch, np.float32)
    pred_cup = np.repeat(pred[0][..., None], 3, axis=-1)
    pred_disc = np.repeat(pred[1][..., None], 3, axis=-1)
    mask_rgb = np.zeros((h, w, 3), np.float32)
    mask_rgb[..., 0] = mask[0]
    mask_rgb[..., 1] = mask[1]
    panels = [image,
              ratio * image + (1 - ratio) * mask_rgb,
              ratio * image + (1 - ratio) * pred_cup,
              ratio * image + (1 - ratio) * pred_disc]
    return np.concatenate(panels, axis=1)


def save_val_img(path: str, epoch: int, imgs: list[np.ndarray]) -> str:
    """Stack the per-sample montages into
    ``<path>/visualization/epoch_<N>.png`` (``utils.py:354-363``)."""
    from PIL import Image

    out = os.path.join(path, "visualization")
    os.makedirs(out, exist_ok=True)
    stack = np.concatenate([np.asarray(im, np.float32) for im in imgs], axis=0)
    lo, hi = stack.min(), stack.max()
    u8 = np.zeros_like(stack, np.uint8) if hi <= lo else \
        np.clip((stack - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)
    file = os.path.join(out, f"epoch_{epoch}.png")
    Image.fromarray(u8).save(file)
    return file


def save_per_img(image_u8: np.ndarray, out_dir: str, name: str,
                 pred_2ch: np.ndarray, gt_2ch: np.ndarray, ext: str = "bmp") -> None:
    """Write ``<out_dir>/original_image/<name>.<ext>`` and
    ``<out_dir>/overlay/<name>.<ext>`` (the reference's layout,
    utils.py:371-454): the image, and the image with the contours of
    :func:`overlay_contours`."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "original_image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "overlay"), exist_ok=True)
    Image.fromarray(image_u8).save(os.path.join(out_dir, "original_image", f"{name}.{ext}"))
    Image.fromarray(overlay_contours(image_u8, pred_2ch, gt_2ch)).save(
        os.path.join(out_dir, "overlay", f"{name}.{ext}"))
