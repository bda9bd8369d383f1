"""One-call inference (counterpart of ``wt_pse_tpu/api.py``)::

    from wt_pse_tpu_torch.api import load_predictor
    predict = load_predictor("checkpoint_800.pth.tar")   # on the card
    out = predict(images)        # (B, H, W, 3) uint8, or float in [-1, 1]
    out["od"], out["oc"]         # cleaned binary masks (B, H, W), uint8
    out["od_logits"], ...        # logits (B, C, H, W), float32

``load_predictor`` reads the reference's 4-net ``.pth.tar``
(``Trainer.py:282-288``) or one the port's Trainer wrote, of either algorithm;
the predict is the two-stage eval path (coarse OD -> thresholded ROI -> fine
OC), through the students or, for the joint variant, the nets' own priors.
The port is NCHW, so the logits come back (B, C, H, W) where the JAX package
returns (B, H, W, C); the masks are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from wt_pse_tpu_torch.ops.postprocess import postprocess_logits
from wt_pse_tpu_torch.train.eval import _resize_host


class Predictor:
    """Callable over the port's two-stage predict.

    ``__call__(images, postprocess=True)``:

    - ``images``: (B, H, W, 3) or (H, W, 3), uint8 in [0, 255] (normalised
      here as the reference's ``Normalize_tf``: x / 127.5 - 1) or float in
      [-1, 1]. At any resolution other than the network's, the images are
      LANCZOS-resized to it as the reference's loader does
      (``fundus_dataloader.py:164-197``), float inputs rounded to uint8
      first; the logits are then upsampled back to the input resolution on
      the host in f64 (``Trainer.py:206-209``).
    - returns ``od_logits`` / ``oc_logits`` at the input resolution and, with
      ``postprocess``, the ``od`` / ``oc`` masks (sigmoid > 0.75, largest
      component, hole fill). With ``label=None`` (2-class checkpoints, channel
      order [cup, disc]) the disc mask comes from channel 1; only the kept
      channel of each head is cleaned.
    """

    def __init__(self, predict_fn, label: str | None = "OD", image_size: int = 256,
                 device: str | torch.device = "cuda"):
        self._predict = predict_fn
        self._label = label
        self._size = image_size
        self._device = torch.device(device)

    def __call__(self, images, postprocess: bool = True) -> dict:
        arr = np.asarray(images)
        if arr.ndim == 3:
            arr = arr[None]
        native_hw = arr.shape[1:3]
        resize = native_hw != (self._size, self._size)
        if resize:
            from PIL import Image

            if arr.dtype != np.uint8:  # as the loader decodes: uint8 through PIL
                # round, not truncate: (x / 127.5 - 1 + 1) * 127.5 lands 1 ulp
                # below many integers
                arr = np.clip(np.rint((np.asarray(arr, np.float32) + 1.0) * 127.5),
                              0, 255).astype(np.uint8)
            arr = np.stack([np.asarray(Image.fromarray(im).resize(
                (self._size, self._size), Image.LANCZOS)) for im in arr])
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 127.5 - 1.0
        image = torch.from_numpy(np.ascontiguousarray(
            np.asarray(arr, np.float32).transpose(0, 3, 1, 2))).to(self._device)
        out_od, out_oc = self._predict(image)
        logits = torch.stack([out_od, out_oc]).cpu().numpy()  # one copy
        od_l, oc_l = logits[0], logits[1]
        if resize:
            od_l = _resize_host(od_l, native_hw)
            oc_l = _resize_host(oc_l, native_hw)
        out = {"od_logits": od_l, "oc_logits": oc_l}
        if postprocess:
            if self._label is None:  # [cup, disc]: the disc is channel 1
                od_ch, od_label, oc_label = 1, "OD", "OC"
            else:
                od_ch, od_label, oc_label = 0, self._label, self._label
            out["od"] = np.stack([postprocess_logits(o[od_ch:od_ch + 1], label=od_label)[0]
                                  for o in od_l])
            out["oc"] = np.stack([postprocess_logits(o[0:1], label=oc_label)[0]
                                  for o in oc_l])
        return out


def load_predictor(model_file: str, hparams: dict | None = None,
                   algorithm: str = "WT_PSE", label: str | None = "OD",
                   partial_load: bool = False, image_size: int = 256,
                   device: str | torch.device = "cuda") -> Predictor:
    """A :class:`Predictor` on ``device`` from a ``.pth.tar``.

    ``hparams`` overrides the algorithm's registry defaults (for an
    ablation checkpoint, e.g. ``{"whitening": False}`` with
    ``partial_load=True``: the reference's filtered partial load).
    ``image_size`` is the network resolution the checkpoint was trained at.
    """
    from wt_pse_tpu_torch.cli.test_visualization import build_networks
    from wt_pse_tpu_torch.config import default_hparams
    from wt_pse_tpu_torch.runtime import resolve_device
    from wt_pse_tpu_torch.train.eval import make_predict_fn_for

    dev = resolve_device(device)
    hp = dict(default_hparams(algorithm))
    hp.update(hparams or {})
    n_classes = 1 if label in ("OC", "OD") else 2
    nets = build_networks(model_file, hp, n_classes, algorithm,
                          strict=not partial_load, device=dev)
    return Predictor(make_predict_fn_for(algorithm, nets, device=dev), label, image_size, dev)
