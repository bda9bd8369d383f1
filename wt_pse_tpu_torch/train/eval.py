"""Two-stage prediction: coarse OD -> ROI -> fine OC (counterpart of
``wt_pse_tpu/train/eval.py::make_predict_fn``, lines 37-86):

  out_od   = main_od.predict(student_od, image)
  od_pred  = sigmoid(out_od) > 0.75
  roi      = (image + 1) * od_pred - 1
  out_oc   = main_oc.predict(student_oc, roi) * od_pred

Upsampling to the native label resolution, post-processing and metrics are
not ported yet.
"""

from __future__ import annotations

import torch

from wt_pse_tpu_torch.models.shape_prior import ShapeStudent
from wt_pse_tpu_torch.models.wt_pse import WTPSE
from wt_pse_tpu_torch.runtime import resolve_device


def make_predict_fn(main_od: WTPSE, stud_od: ShapeStudent, main_oc: WTPSE,
                    stud_oc: ShapeStudent, *, device: str | torch.device = "cuda"):
    """``predict(image) -> (od_logits, oc_logits)`` for an NCHW image batch
    (tensor or array, moved to ``device``), with every net in eval mode and no
    gradient. The nets must live on ``device``."""
    dev = resolve_device(device)
    shape_prior = main_od.cfg.shape_prior
    nets = (main_od, stud_od, main_oc, stud_oc)

    def stage(main: WTPSE, stud: ShapeStudent, x: torch.Tensor) -> torch.Tensor:
        if shape_prior:
            return main.predict_with_shape(x, stud.sample_from_image(x))
        return main.predict_no_shape(x)

    @torch.no_grad()
    def predict(image) -> tuple[torch.Tensor, torch.Tensor]:
        for net in nets:
            net.eval()
        image = torch.as_tensor(image, dtype=torch.float32, device=dev)
        out_od = stage(main_od, stud_od, image)
        od_pred = (torch.sigmoid(out_od) > 0.75).to(image.dtype)
        roi = (image + 1.0) * od_pred - 1.0
        return out_od, stage(main_oc, stud_oc, roi) * od_pred

    return predict
