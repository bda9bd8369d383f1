"""Segmentation metrics: Dice, ASD, HD95 (the port's own copy of the scipy
path of ``wt_pse_tpu/ops/metrics.py``).

- Dice: smoothed ``(2|A∩B| + 1) / (1 + |A| + |B|)``.
- ASD / HD95: medpy's surface distances on scipy primitives. The surface of a
  mask is ``mask ^ erosion(mask, cross structure)``; a distance is the
  Euclidean distance transform of the complement of the other mask's surface,
  read at the surface voxels. ``asd(a, b)`` is one-directional (the mean over
  a's surface); ``hd95(a, b)`` is the 95th percentile of the *concatenated*
  distances both ways, as medpy aggregates it.

These functions raise on an empty mask, as medpy does; the eval loop applies
the reference's 100.0 sentinel for an empty prediction first.

``backend`` picks the engine of the surface distances, as the JAX package
dispatches (``wt_pse_tpu/ops/metrics.py:41-53``): ``'native'`` (the port's
C++ operators, ``wt_pse_tpu_torch/native``, float32 distances), ``'scipy'``
(the oracle below, float64), or ``'auto'``: native when it builds, else scipy
(``native.scoring_backend``).
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi

from wt_pse_tpu_torch import native


def dice_binary(seg: np.ndarray, gt: np.ndarray) -> float:
    seg = np.asarray(seg, bool)
    gt = np.asarray(gt, bool)
    inter = float(np.logical_and(seg, gt).sum())
    return (2.0 * inter + 1.0) / (1.0 + float(seg.sum()) + float(gt.sum()))


def _surface(mask: np.ndarray, connectivity: int = 1) -> np.ndarray:
    mask = np.asarray(mask, bool)
    structure = ndi.generate_binary_structure(mask.ndim, connectivity)
    eroded = ndi.binary_erosion(mask, structure=structure, iterations=1)
    return mask ^ eroded


def surface_distances(a: np.ndarray, b: np.ndarray, connectivity: int = 1,
                      backend: str = "auto") -> np.ndarray:
    """Distances from each surface voxel of ``a`` to the nearest surface voxel
    of ``b`` (medpy ``__surface_distances``), float64. The native engine
    takes the connectivity-1 surfaces (medpy's default) only."""
    if connectivity == 1 and native.scoring_backend(backend) == "native":
        a = np.asarray(a, bool)
        b = np.asarray(b, bool)
        if not a.any():
            raise ValueError("first mask is empty")
        if not b.any():
            raise ValueError("second mask is empty")
        return native.surface_distances_native(a, b).astype(np.float64)
    return surface_distances_scipy(a, b, connectivity)


def surface_distances_scipy(a: np.ndarray, b: np.ndarray,
                            connectivity: int = 1) -> np.ndarray:
    """The scipy implementation, the oracle of the native one."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    if not a.any():
        raise ValueError("first mask is empty")
    if not b.any():
        raise ValueError("second mask is empty")
    sa = _surface(a, connectivity)
    sb = _surface(b, connectivity)
    dt = ndi.distance_transform_edt(~sb)
    return dt[sa]


def asd(result: np.ndarray, reference: np.ndarray, backend: str = "auto") -> float:
    """Average (one-directional) surface distance, medpy ``binary.asd``."""
    return float(surface_distances(result, reference, backend=backend).mean())


def assd(result: np.ndarray, reference: np.ndarray, backend: str = "auto") -> float:
    """Average symmetric surface distance, medpy ``binary.assd``."""
    d1 = surface_distances(result, reference, backend=backend)
    d2 = surface_distances(reference, result, backend=backend)
    return float(np.concatenate([d1, d2]).mean())


def hd95(result: np.ndarray, reference: np.ndarray, backend: str = "auto") -> float:
    """95th-percentile Hausdorff distance, medpy ``binary.hd95``: the
    percentile of the concatenated distance set, not the larger of the two
    one-way percentiles."""
    d1 = surface_distances(result, reference, backend=backend)
    d2 = surface_distances(reference, result, backend=backend)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def dice_coeff_2label(pred: np.ndarray, target: np.ndarray,
                      label: str | None) -> tuple[float, float]:
    """(cup, disc) Dice for a (C, H, W) prediction/target pair
    (metrics.py:115-149): with ``label`` set, both values come from channel 0."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    if label is None:
        return dice_binary(pred[0], target[0]), dice_binary(pred[1], target[1])
    d = dice_binary(pred[0], target[0])
    return d, d
