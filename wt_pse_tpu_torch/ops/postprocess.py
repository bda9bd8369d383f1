"""Prediction post-processing: sigmoid -> threshold -> largest connected
component -> binary fill-holes (the port's own copy of the scipy path of
``wt_pse_tpu/ops/postprocess.py:35-74``).

Connected components are 8-connected (skimage ``label``, as the reference's
``get_largest_fillhole`` uses); of equal largest areas the first label wins,
as ``np.argmax`` picks it. Inputs are (C, H, W) host arrays: this runs on the
host at eval time only.

``backend`` picks the engine as the JAX package dispatches
(``wt_pse_tpu/ops/postprocess.py:25-31``): ``'native'`` (the port's C++
operators), ``'scipy'`` (the oracle), or ``'auto'`` (native when it builds);
the two give the same mask bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage as ndi

from wt_pse_tpu_torch import native

_EIGHT = np.ones((3, 3), dtype=np.int8)


def largest_component_fill_holes(binary: np.ndarray, backend: str = "auto") -> np.ndarray:
    """Keep the largest 8-connected component, then fill holes
    (utils.py:267-276)."""
    if native.scoring_backend(backend) == "native":
        return native.largest_component_fill_holes_native(binary)
    return largest_component_fill_holes_scipy(binary)


def largest_component_fill_holes_scipy(binary: np.ndarray) -> np.ndarray:
    """The scipy implementation, the oracle of the native one."""
    binary = np.asarray(binary)
    labeled, n = ndi.label(binary, structure=_EIGHT)
    if n > 0:
        areas = np.bincount(labeled.ravel())[1:]  # label order, 1..n
        keep = int(np.argmax(areas)) + 1
        binary = np.where(labeled == keep, binary, 0)
    return ndi.binary_fill_holes(np.asarray(binary).astype(int)).astype(np.uint8)


def postprocess_logits(logits_chw: np.ndarray, threshold: float = 0.75,
                       label: str | None = "OD", backend: str = "auto") -> np.ndarray:
    """sigmoid -> > threshold -> per-channel LCC + fill (utils.py:298-329).

    ``logits_chw``: (C, H, W) float logits. With ``label`` set only channel 0
    is cleaned; with ``label=None`` channels 0 (cup) and 1 (disc) are.
    """
    prob = 1.0 / (1.0 + np.exp(-np.asarray(logits_chw, np.float64)))
    out = (prob > threshold).astype(np.uint8)
    out[0] = largest_component_fill_holes(out[0], backend)
    if label is None:
        out[1] = largest_component_fill_holes(out[1], backend)
    return out


def postprocess_probs_drishti(probs_chw: np.ndarray, backend: str = "auto") -> np.ndarray:
    """The reference's 'D' (Drishti-GS) branch of ``utils.postprocessing``
    (utils.py:279-297): the inputs are already probabilities; the cup is
    channel 0 > 0.1, the disc channel 1 > 0.5, each cleaned by LCC + fill."""
    probs = np.asarray(probs_chw)
    out = np.copy(probs)
    out[0] = largest_component_fill_holes((probs[0] > 0.1).astype(np.uint8), backend)
    out[1] = largest_component_fill_holes((probs[1] > 0.5).astype(np.uint8), backend)
    return out
